// Kernel B's quad body: the Vanilla static and per-lane entries at band
// radii 8..13, a quad of four threads a lane.
//
// Replaces columba_tpu/search/executor.py make_step.step (:587, with
// _band_row_update, :135) at the BEST ladder's deep rungs: at -I 95 the
// cutoff reaches 8 from 160 bp reads on and 12 at 250 bp (rungs 9 and 12
// of the columba scheme). It computes what band_step.cuh's body computes,
// field for field and in lane order (the next frontier's rows, the in-text
// rows and count, kept children, visits, overflow), and the notes there
// hold for the step's semantics, the look-back and the cell tables.
//
// What bounds it on this card: the lane's chain of dependent reads (its
// state, then two 64 B occ rows) and then the band arithmetic of four
// children, 2kb + 1 cells each, with a serial deletion scan along the row.
// A thread that owns the lane (band_step.cuh) holds four rows of up to 27
// cells, the previous row and its codes at once: at kb >= 8 that body was
// only built with runtime sizes, its arrays in local memory (a stack frame
// of about 1.3 KB), and it ran at under 2 % of its bound. Here thread q of
// the quad holds child q (chars A, C, G, T): its row of 2kb + 1 cells, its
// colMin registers and its rank pair. The quad's four threads read the
// lane's state and occ rows at the same addresses (one request of the
// warp serves all four), count their own char in the two rows and take
// the children's synchronised side from an exclusive scan of the four
// counts over the quad (__shfl_up_sync, width 4). Each prunes its own
// child; the lane's death is an OR over the quad (__shfl_xor_sync on the
// quad's mask). The block scan then counts one child a thread: thread
// 4 * lane + char is the order of the JAX step's compaction, so the
// children land where the plain version puts them, and each thread writes
// its own kept child's row and in-text row, so a lane's stores spread over
// four threads. Every array is sized at compile time (KB, W), so the
// body keeps its state in registers: no stack frame (ptxas -v, checked by
// chip_smoke.py). A block is one tile of 64 lanes (256 threads, kQuadBlock),
// so the tiles, their statuses and the look-back are those of the other
// Vanilla entries.
//
// Instances: every (kb, W) with 8 <= kb <= 13 and W <= quad_max_w(kb), the
// colMin register counts of the shipped schemes' schedules at 160..270 bp
// (search/executor.py QUAD_MAX_W), in band_step_wide.cu (static entry) and
// band_step_wide_lane.cu (per-lane entry, W 1); band_step.cuh's
// launch_static / launch_per_lane send those shapes here unless `generic`
// forces the generic body.
#pragma once

#include "band_step.cuh"

namespace columba_band {

// the most registers of an instance at radius kb (0: none at that radius)
__host__ __device__ constexpr int quad_max_w(int kb) {
  return kb == 8 ? 2 : (kb >= 9 && kb <= 11) ? 3 : (kb == 12 || kb == 13) ? 4
                                                                          : 0;
}

// one of four values by a runtime index, without an indexed array (which
// would sit in local memory)
template <typename T>
__device__ __forceinline__ T sel4(int q, T v0, T v1, T v2, T v3) {
  return q == 0 ? v0 : (q == 1 ? v1 : (q == 2 ? v2 : v3));
}

// occ of char c before in-block offset `off` of fused row `row` ('$'
// counted as A): occ_row's count for one char (common.cuh)
__device__ __forceinline__ uint32_t occ_char(const uint32_t* __restrict__ occ,
                                             long long row, uint32_t off,
                                             int c) {
  const uint4* r = reinterpret_cast<const uint4*>(occ + row * 16);
  const uint4 ck = __ldg(r);
  const uint4 wa = __ldg(r + 1);
  const uint4 wb = __ldg(r + 2);
  const uint32_t w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
  const uint32_t pat = 0x55555555u * static_cast<uint32_t>(c);
  uint32_t n = sel4(c, ck.x, ck.y, ck.z, ck.w);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int r2 = static_cast<int>(off) - 16 * i;
    r2 = r2 < 0 ? 0 : (r2 > 16 ? 16 : r2);
    const uint32_t mask = r2 >= 16 ? 0xFFFFFFFFu : ((1u << (2 * r2)) - 1u);
    const uint32_t nx = ~(w[i] ^ pat);
    n += __popc(nx & (nx >> 1) & 0x55555555u & mask);
  }
  return n;
}

template <int KB, int W, bool DYN>
__device__ __forceinline__ void band_quad(const BandArgs& a) {
  constexpr int BW = 2 * KB + 1;
  constexpr int INF = columba::INF;
  constexpr int kWarps = kQuadBlock / 32;
  extern __shared__ int smeta[];
  __shared__ long long s_tile;
  __shared__ unsigned s_warp[kWarps], s_act[kWarps];
  __shared__ unsigned long long s_base[2];
  if (threadIdx.x == 0)
    s_tile = static_cast<long long>(atomicAdd(a.ctr + 3, 1ull));
  if (!DYN) {
    // the step's scalars and cells (band_step.cuh)
    const int n_meta = a.S * 7, n_cell = a.S * BW;
    const int* cl = a.cells + a.t * n_cell;
    const int step = static_cast<int>(blockDim.x);
    for (int k = threadIdx.x; k < max(n_meta, n_cell); k += 2 * step) {
      const int k2 = k + step;
      const int m1 = k < n_meta ? a.mrow[k] : 0;
      const int c1 = k < n_cell ? cl[k] : 0;
      const int m2 = k2 < n_meta ? a.mrow[k2] : 0;
      const int c2 = k2 < n_cell ? cl[k2] : 0;
      if (k < n_meta) smeta[k] = m1;
      if (k < n_cell) smeta[n_meta + k] = c1;
      if (k2 < n_meta) smeta[k2] = m2;
      if (k2 < n_cell) smeta[n_meta + k2] = c2;
    }
  }
  __syncthreads();
  const long long tile = s_tile;
  const int q = threadIdx.x & 3;                  // this thread's char
  const unsigned qmask = 0xFu << (threadIdx.x & 28);
  const long long i = tile * kThreads + (threadIdx.x >> 2);
  const bool in = i < a.n_live;

  uint32_t par[4] = {0u, 0u, 0u, 0u};
  int ids = 0;
  if (in) {
    const long long* rg = a.ranges + 4 * i;
#pragma unroll
    for (int k = 0; k < 4; ++k) par[k] = static_cast<uint32_t>(rg[k]);
    ids = a.ids[i];
  }
  const bool ghost = ids < 0;
  const int ids_c = ids & kGhostIdMask;
  const int rid = DYN ? 0 : static_cast<int>(__umulhi(ids_c, a.s_recip));
  const int sid = DYN ? 0 : ids_c - rid * a.S;
  const bool alive = par[1] > par[0];
  int mr[7] = {0, 0, 0, 0, 0, 0, 0};
  int cacc = 0, cfro = 0, ub = 0, dbv = 0;
  if (in && DYN) {
    const int word = a.dyn_meta[static_cast<long long>(ids_c) * a.T + a.t];
    const int colo = ((word >> 3) & 63) - 1;
    mr[0] = word;
    mr[1] = colo >= 0 ? (colo | (((word >> 2) & 1) << 6)) : 63;
    mr[4] = 63;
    cacc = colo >= 0 ? 0 : 15;
    ub = (word >> 9) & 255;
    dbv = (word >> 17) & 4095;
  } else if (in) {
    const int* row = smeta + sid * 7;
#pragma unroll
    for (int k = 0; k < 7; ++k) mr[k] = row[k];
    cacc = (mr[0] >> 2) & 15;
    cfro = (mr[0] >> 6) & 15;
    ub = (mr[0] >> 10) & 255;
    dbv = (mr[0] >> 18) & 4095;
  }
  const int meta = mr[0];
  const bool act = (meta & 1) && alive && !ghost;
  const bool is_b = ((meta >> 1) & 1) == 0;
  const signed char* lband = a.band + 2 * i * BW;

  int cm0[W], cm1[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    cm0[w] = in ? a.colmin[(2 * i) * W + w] : 0;
    cm1[w] = in ? a.colmin[(2 * i + 1) * W + w] : 0;
  }

  // child q's interval: the lane's two occ rows, this thread's char
  const bool bwd = is_b;
  const uint32_t a_lo = bwd ? par[0] : par[2], a_hi = bwd ? par[1] : par[3];
  const uint32_t b_lo = bwd ? par[2] : par[0];
  int code[BW];
  uint32_t ol = 0u, oh = 0u;
  if (act) {
    // the step's cells first, so that their reads are in flight beside the
    // occ rows'
    if (DYN) {
      const signed char* pc =
          a.pchars + (static_cast<long long>(ids_c) * a.T + a.t) * BW;
#pragma unroll
      for (int o = 0; o < BW; ++o) code[o] = pc[o];
    } else {
      const int* cl = smeta + 7 * a.S + sid * BW;
      const unsigned char* rd = a.reads + static_cast<long long>(rid) * a.m;
      int ch[BW];
#pragma unroll
      for (int o = 0; o < BW; ++o) ch[o] = __ldg(rd + max(cl[o], 0));
#pragma unroll
      for (int o = 0; o < BW; ++o) code[o] = cl[o] >= 0 ? ch[o] : cl[o];
    }
    const long long base = bwd ? 0 : a.fm.blocks;
    ol = occ_char(a.fm.occ, base + (a_lo >> 7), a_lo & 127u, q);
    oh = occ_char(a.fm.occ, base + (a_hi >> 7), a_hi & 127u, q);
  } else {
#pragma unroll
    for (int o = 0; o < BW; ++o) code[o] = 0;
  }
  const uint32_t drow = bwd ? a.fm.dollar[0] : a.fm.dollar[1];
  const uint32_t dl = drow < a_lo ? 1u : 0u;
  const uint32_t dh = drow < a_hi ? 1u : 0u;
  if (q == 0) {
    ol -= dl;
    oh -= dh;
  }
  // the counts of the chars before q (extend_lane's cumsum), over the quad
  uint32_t sl = ol, sh = oh;
#pragma unroll
  for (int d = 1; d < 4; d <<= 1) {
    const uint32_t ul = __shfl_up_sync(qmask, sl, d, 4);
    const uint32_t uh = __shfl_up_sync(qmask, sh, d, 4);
    if (q >= d) {
      sl += ul;
      sh += uh;
    }
  }
  const uint32_t cnt_q =
      sel4(q, a.fm.counts[0], a.fm.counts[1], a.fm.counts[2], a.fm.counts[3]);
  const uint32_t na_lo = cnt_q + ol, na_hi = cnt_q + oh;
  const uint32_t width = na_hi - na_lo;
  const uint32_t nb_lo = b_lo + ((dh + sh - oh) - (dl + sl - ol));
  const uint32_t child[4] = {bwd ? na_lo : nb_lo, bwd ? na_hi : nb_lo + width,
                             bwd ? nb_lo : na_lo, bwd ? nb_lo + width : na_hi};

  // child q's banded row, registers and prune
  int newD[BW], reg[W];
  bool ok = false;
  if (act) {
    int prev[BW];
#pragma unroll
    for (int o = 0; o < BW; ++o) prev[o] = lband[(is_b ? 0 : BW) + o];
    int d = 0;
#pragma unroll
    for (int o = 0; o < BW; ++o) {
      const int up = (o + 1 < BW ? prev[o + 1] : INF) + 1;
      const int mis = code[o] == q ? 0 : (code[o] >= 0 ? 1 : INF);
      const int nl = min(prev[o] + mis, up);
      d = o == 0 ? nl : min(nl, d + 1);
      newD[o] = code[o] >= -1 ? min(d, INF) : INF;
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int op = (mr[1 + w / 4] >> (7 * (w % 4))) & 127;
      const int ini = (mr[4 + w / 4] >> (7 * (w % 4))) & 127;
      const int cell = op & 63;
      const int cur = is_b ? cm0[w] : cm1[w];
      const int base = (op & 64) ? min(INF, ini) : cur;
      int acc = INF;
#pragma unroll
      for (int o = 0; o < BW; ++o) acc = cell == o ? newD[o] : acc;
      reg[w] = cell < 63 ? min(base, acc) : cur;
    }
    int cm_other = 0, col = INF;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      cm_other = cfro == w ? (is_b ? cm1[w] : cm0[w]) : cm_other;
      col = cacc == w ? reg[w] : col;
    }
    int rowmin = newD[0];
#pragma unroll
    for (int o = 1; o < BW; ++o) rowmin = min(rowmin, newD[o]);
    ok = width > 0 && min(rowmin, col) + cm_other <= ub;
  } else {
#pragma unroll
    for (int o = 0; o < BW; ++o) newD[o] = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) reg[w] = 0;
  }
  const bool nar = a.switchpoint > 0 && ok &&
                   width <= static_cast<uint32_t>(a.switchpoint);
  // the lane dies where none of its four children survives
  int any = ok ? 1 : 0;
  any |= __shfl_xor_sync(qmask, any, 1);
  any |= __shfl_xor_sync(qmask, any, 2);
  const bool died = act && !any;
  const bool keepv = act && any;
  const int new_id = died ? (ids | kGhostBit | (min(dbv, 1023) << 21)) : ids;
  const bool stays = keepv ? (ok && !nar) : (q == 0 && alive);

  // ---- positions: one child a thread, block scan, then the look-back ----
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane_id) - 1u;
  const unsigned mk = __ballot_sync(0xFFFFFFFFu, stays);
  const unsigned mn = __ballot_sync(0xFFFFFFFFu, nar);
  const unsigned ma = __ballot_sync(0xFFFFFFFFu, act);   // 4 per lane
  if (lane_id == 0) {
    s_warp[warp] = __popc(mk) | (__popc(mn) << 16);
    s_act[warp] = __popc(ma);
  }
  __syncthreads();
  unsigned before = 0, total = 0, visits = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? s_warp[w] : 0u;
    total += s_warp[w];
    visits += s_act[w];
  }
  const unsigned excl =
      before + (__popc(mk & below) | (__popc(mn & below) << 16));
  if (warp == 0) {
    const unsigned agg_k = total & 0xFFFFu, agg_n = total >> 16;
    unsigned long long pk = 0, pn = 0;
    if (tile > 0) {
      if (lane_id == 0)
        publish(a.status, tile, kAggregate, a.epoch, agg_k, agg_n);
      look_back(a.status, tile, a.epoch, pk, pn);
    }
    if (lane_id == 0) {
      publish(a.status, tile, kPrefix, a.epoch,
              static_cast<unsigned>(pk + agg_k),
              static_cast<unsigned>(pn + agg_n));
      s_base[0] = pk;
      s_base[1] = pn;
      if (visits) atomicAdd(a.ctr + 1, static_cast<unsigned long long>(visits));
      if (tile == gridDim.x - 1) {        // the last ticket: every block
        const unsigned long long n = pk + agg_k;     // has taken its own
        const long long rows = a.cnt + static_cast<long long>(pn + agg_n);
        a.ctr[0] = n | (static_cast<unsigned long long>(
                            rows < a.M ? rows : a.M) << 32);
        if (static_cast<long long>(n) > a.cap)
          a.ctr[2] += n - static_cast<unsigned long long>(a.cap);
        a.ctr[3] = 0;
      }
    }
  }
  __syncthreads();

  // ---- writes: this thread's child, if it stays, and its in-text row ----
  const long long p = static_cast<long long>(s_base[0]) + (excl & 0xFFFFu);
  if (stays && p < a.cap) {
    long long* cr = a.o_ranges + 4 * p;
#pragma unroll
    for (int k = 0; k < 4; ++k) cr[k] = keepv ? child[k] : par[k];
    a.o_ids[p] = new_id;
    signed char* cb = a.o_band + p * 2 * BW;
    signed char* cc = a.o_colmin + p * 2 * W;
    if (keepv) {
      // the active side's new row and registers, the other side's as read
      const int own = is_b ? 0 : BW, oth = is_b ? BW : 0;
#pragma unroll
      for (int o = 0; o < BW; ++o) {
        cb[own + o] = static_cast<signed char>(newD[o]);
        cb[oth + o] = lband[oth + o];
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        cc[w] = static_cast<signed char>(is_b ? reg[w] : cm0[w]);
        cc[W + w] = static_cast<signed char>(is_b ? cm1[w] : reg[w]);
      }
    } else {
#pragma unroll
      for (int o = 0; o < 2 * BW; ++o) cb[o] = lband[o];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        cc[w] = static_cast<signed char>(cm0[w]);
        cc[W + w] = static_cast<signed char>(cm1[w]);
      }
    }
  }
  const long long r = a.cnt + static_cast<long long>(s_base[1]) + (excl >> 16);
  if (nar && r < a.M) {
    long long* row = a.itv + 4 * r;
    row[0] = child[0];
    row[1] = child[1];
    row[2] = ids_c;
    row[3] = dbv;
  }
}

template <int KB, int W, bool DYN>
__global__ void __launch_bounds__(kQuadBlock, 1)
band_step_quad_kernel(BandArgs a) {
  band_quad<KB, W, DYN>(a);
}

template <int KB, int W, bool DYN>
int launch_quad(const BandArgs& a, cudaStream_t stream) {
  const size_t smem = DYN ? 0 : sizeof(int) * (7 + 2 * KB + 1) * a.S;
  const unsigned tiles =
      static_cast<unsigned>((a.n_live + kThreads - 1) / kThreads);
  band_step_quad_kernel<KB, W, DYN><<<tiles, kQuadBlock, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace columba_band
