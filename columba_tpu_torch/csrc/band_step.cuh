// Kernel B: one band step of the scheme executor, fused with the drain to
// the in-text buffer and the order-keeping compaction of the frontier.
//
// Replaces columba_tpu/search/executor.py make_step.step (:587, with
// _band_row_update, :135): the lane arithmetic, the narrow drain and the
// 4C -> C compaction of one step. For each live frontier lane it
//   1. extends the lane's range pair by all 4 chars (extend_lane),
//   2. updates the active side's banded edit row for each char on int8
//      cells (diag/up, left-to-right deletion scan, saturation at INF),
//   3. updates the W colMin registers from the step's packed 7-bit ops,
//   4. prunes each child by min(row min, fresh window register) + the other
//      side's completed register <= U, splits narrow children (width <=
//      switchpoint, drained to in-text verification) from alive ones,
//   5. marks a lane whose children all die as a ghost (id bit 31, death
//      depth in bits 21-30),
// then places its children where the compaction of the JAX step puts them,
// and writes no other child state:
//   - a child that stays (alive, or a lane's pass-through: a lane that is
//     not kept, inactive or dead as a ghost, passes itself on as child 0)
//     goes to row p of the next frontier, p = the number of children that
//     stay before it in the order 4 * lane + char, if p < cap;
//   - a narrow child's row [lo, hi, id, back depth] goes to in-text row
//     cnt + q, q counted the same way over the narrow children, if < M;
//   - the step's counters: kept children n (the host reads
//     live = min(n, cap) and the overflow n - cap), in-text rows
//     min(cnt + narrow, M), and visits (4 per active lane) as integer
//     atomics, so they are exact.
// The positions come from a scan of each block's counts in shared memory
// (warp shuffles, then one pass over the warps' sums) and a decoupled
// look-back across blocks: a block takes its tile from an atomic ticket,
// not from blockIdx, so it only ever waits on tiles whose blocks are
// already running; it publishes its counts as soon as its lanes are
// computed, before it writes anything, and its first warp walks back over
// the tiles before it, 32 at a time, adding aggregates until it meets an
// inclusive prefix.
// Tile statuses are two words (kept, narrow), each [flag 2 | epoch 30 |
// count 32], stamped with the launch's epoch, so nothing is cleared
// between steps; the block with the last ticket writes the counters and
// resets the ticket for the next launch. Lanes at and past the live count
// are empty and are not read; the grid covers the live lanes only.
//
// The step's per-search scalars (S rows of 7 packed int32 words) sit in
// shared memory; each lane decodes its own row by search id.
//
// Per-lane entry (DYN, dynamic partitioning): every (read, search) has its
// own schedule, so a lane reads its own packed word at dyn_meta[id * T + t]
// (the layout of search/dynschedule.py: creset at bit 2, colo + 1 at bits
// 3-8, ub at bit 9, back depth at bit 17) and derives the ops of its single
// register from it (W = 1: dynamic partitions keep every part longer than
// 2k, so windows never overlap). Same body, no shared memory.
//
// Bound: two random 64 B occ rows per active lane, about 50 B of lane
// state in, the kept children's state (about 50 B each) and 32 B per
// narrow row out; the band and register arithmetic is a few hundred
// integer ops in registers. What bounds it on this card is latency: a
// lane's two occ reads depend on its state read, and its writes on the
// look-back. The design keeps each step one launch with one 8 B read-back
// (no 4C child state to device memory and back, no PyTorch compaction), a
// grid over the live lanes only, and 64-lane blocks, so that a frontier of
// 12,288 lanes spreads over 192 blocks on the 132 SMs; the look-back waits
// only for a predecessor's counts, which it publishes before its own hint
// walks and writes.
//
// Templated on the band radius KB and the register count W so every array
// stays in registers: KB 0..4 x W 1..2 are instantiated (what the builtin
// schemes give at m = 100 and 150 for k <= 4, both metrics; KB = 0 is the
// Hamming band of one cell). Every other shape a schedule can produce
// (KB <= 13, W <= MAX_REGS = 10) runs the same body with runtime sizes and
// arrays sized for the maximum (KB = -1): those arrays live in local memory,
// so that entry is slower, and it is exact.
//
// RLC and textless entries (K18 inside K7, and K20): the same body on the
// RLC index, templated on the lane width RW (Lane<RW> of common.cuh).
// "rlc" takes 8-wide lanes; "textless" takes 12-wide lanes (the toehold is
// updated inside the extension) and 2W colMin slots per side: slot W + w is
// register w's witness, the back depth (mod 64) at which its value last fell
// (columba_tpu/search/executor.py:652-675): a reset restarts it at the
// step's depth, a strict decrease moves it there, a tie keeps it. The
// extension's first phase (two endpoint rows: every child's interval) runs
// before the band arithmetic; the run-hint walks run only for the children
// that stay in the frontier, after the look-back, as they are written (a
// narrow child drains with its interval only; a pruned one is dropped).
// These entries are in band_step_rlc.cu, the Vanilla ones in band_step.cu;
// this header holds the one body.
#pragma once

#include "common.cuh"

namespace columba_band {

constexpr int kGhostBit = -2147483647 - 1;   // bit 31
constexpr int kGhostIdMask = (1 << 21) - 1;
constexpr int kThreads = 64;                 // lanes of a block: one tile
                                             // (executor.BAND_TILE)
constexpr int kWarps = kThreads / 32;

struct BandArgs {
  columba::FmParams fm;
  columba::BmParams bm;
  const long long* ranges;      // (>= n_live, RW) this step's frontier
  const int* ids;               // (>= n_live,)
  const signed char* band;      // (>= n_live, 2, BW)
  const signed char* colmin;    // (>= n_live, 2, Wp): W registers (+ W
                                // witnesses)
  const int* mrow;              // (S, 7) this step's packed scalars
  int S;
  const int* dyn_meta;          // (R*S*T,) per-lane words (per-lane entry)
  const signed char* pchars;    // (R*S*T, BW) per-(lane id, step) cell codes
  int T;
  int t;
  int bw;                       // runtime band width and register count,
  int W;                        // read by the generic entry only
  int switchpoint;
  long long n_live;             // lanes read: [0, n_live)
  long long cap;                // rows of the next frontier
  long long* o_ranges;          // (cap, RW) next frontier
  int* o_ids;                   // (cap,)
  signed char* o_band;          // (cap, 2, BW)
  signed char* o_colmin;        // (cap, 2, Wp)
  long long* itv;               // (M + 1, 4) in-text rows
  long long M;
  long long cnt;                // rows already in itv
  unsigned long long* ctr;      // [0] n | in-text rows << 32, [1] visits,
                                // [2] overflow, [3] block ticket
  unsigned long long* status;   // (tiles, 2) look-back statuses
  unsigned int epoch;           // this launch's stamp, 1 .. 2^30 - 1
};

constexpr int kMaxBW = 2 * 13 + 1;   // ladder cutoff 13 (BEST_CUTOFF)
constexpr int kMaxW = 10;            // search/schedule.py MAX_REGS

constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;

__device__ __forceinline__ unsigned long long stamp(unsigned long long flag,
                                                    unsigned epoch,
                                                    unsigned count) {
  return flag | (static_cast<unsigned long long>(epoch) << 32) | count;
}

__device__ __forceinline__ void publish(unsigned long long* st, long long tile,
                                        unsigned long long flag,
                                        unsigned epoch, unsigned kept,
                                        unsigned narrow) {
  volatile unsigned long long* s = st + 2 * tile;
  s[0] = stamp(flag, epoch, kept);
  s[1] = stamp(flag, epoch, narrow);
}

// Warp 0's look-back: the kept and narrow children of every tile before
// `tile`, 32 tiles a round: lane j reads tile base - j, waiting until both
// its words carry this epoch and the same flag (its block writes them one
// after the other; a tile before tile 0 reads as an empty prefix). The
// round adds the tiles up to the nearest one that holds an inclusive
// prefix, and ends the walk there; without one it adds all 32 and goes on.
__device__ __forceinline__ void look_back(const unsigned long long* st,
                                          long long tile, unsigned epoch,
                                          unsigned long long& kept,
                                          unsigned long long& narrow) {
  const int lane_id = threadIdx.x & 31;
  const volatile unsigned long long* s = st;
  kept = narrow = 0;
  for (long long base = tile - 1;; base -= 32) {
    const long long j = base - lane_id;
    unsigned long long a = kPrefix, b = kPrefix;
    while (j >= 0) {
      a = s[2 * j];
      b = s[2 * j + 1];
      if (((a >> 32) & 0x3FFFFFFFu) == epoch &&
          ((b >> 32) & 0x3FFFFFFFu) == epoch && (a >> 62) != 0 &&
          (a >> 62) == (b >> 62))
        break;
    }
    const unsigned prefixes =
        __ballot_sync(0xFFFFFFFFu, (a >> 62) == 2);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    unsigned long long k = lane_id <= stop ? (a & 0xFFFFFFFFull) : 0;
    unsigned long long n = lane_id <= stop ? (b & 0xFFFFFFFFull) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      k += __shfl_xor_sync(0xFFFFFFFFu, k, d);
      n += __shfl_xor_sync(0xFFFFFFFFu, n, d);
    }
    kept += k;
    narrow += n;
    if (prefixes) return;
  }
}

// KB >= 0: sizes fixed at compile time. KB < 0: the generic entry. RW: lane
// width (4 Vanilla, 8 RLC, 12 textless with witness slots).
template <int KB, int WT, bool DYN, int RW = 4>
__global__ void __launch_bounds__(kThreads)
band_step_kernel(BandArgs a) {
  constexpr bool kGeneric = KB < 0;
  constexpr bool TRACK = RW == 12;
  constexpr int BWMAX = kGeneric ? kMaxBW : 2 * KB + 1;
  constexpr int WMAX = kGeneric ? kMaxW : WT;
  const int BW = kGeneric ? a.bw : BWMAX;
  const int W = kGeneric ? a.W : WMAX;
  const int Wp = TRACK ? 2 * W : W;
  constexpr int INF = columba::INF;
  extern __shared__ int smeta[];
  __shared__ long long s_tile;
  __shared__ unsigned s_warp[kWarps], s_act[kWarps];
  __shared__ unsigned long long s_base[2];
  if (threadIdx.x == 0)
    s_tile = static_cast<long long>(atomicAdd(a.ctr + 3, 1ull));
  if (!DYN) {
    for (int k = threadIdx.x; k < a.S * 7; k += blockDim.x)
      smeta[k] = a.mrow[k];
  }
  __syncthreads();
  const long long tile = s_tile;
  const long long i = tile * kThreads + threadIdx.x;
  const bool in = i < a.n_live;

  uint32_t par[RW];
  int ids = 0;
#pragma unroll
  for (int k = 0; k < RW; ++k) par[k] = 0u;
  if (in) {
    const long long* rg = a.ranges + RW * i;
#pragma unroll
    for (int k = 0; k < RW; ++k) par[k] = static_cast<uint32_t>(rg[k]);
    ids = a.ids[i];
  }
  const bool ghost = ids < 0;
  const int ids_c = ids & kGhostIdMask;
  const bool alive = par[1] > par[0];
  // the step's scalars of this lane: meta word, register ops and inits
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
    const int* row = smeta + (ids_c % a.S) * 7;
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

  int band0[BWMAX], band1[BWMAX], cm0[WMAX], cm1[WMAX];
  int ag0[TRACK ? WMAX : 1], ag1[TRACK ? WMAX : 1];
#pragma unroll
  for (int o = 0; o < BW; ++o) {
    band0[o] = in ? a.band[(2 * i) * BW + o] : 0;
    band1[o] = in ? a.band[(2 * i + 1) * BW + o] : 0;
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    cm0[w] = in ? a.colmin[(2 * i) * Wp + w] : 0;
    cm1[w] = in ? a.colmin[(2 * i + 1) * Wp + w] : 0;
    if (TRACK) {
      ag0[w] = in ? a.colmin[(2 * i) * Wp + W + w] : 0;
      ag1[w] = in ? a.colmin[(2 * i + 1) * Wp + W + w] : 0;
    }
  }

  columba::Lane<RW> lane;
  uint32_t width[4] = {0u, 0u, 0u, 0u};
  int newD[4][BWMAX], reg[4][WMAX], arg[4][TRACK ? WMAX : 1];
  bool calive[4] = {false, false, false, false};
  bool nar[4] = {false, false, false, false};
  bool keepv = false, died = false;
  if (act) {
    lane.init(a.fm, a.bm, par, is_b ? 0 : 1);
#pragma unroll
    for (int c = 0; c < 4; ++c) width[c] = lane.pos(c, 1) - lane.pos(c, 0);
    // banded row update for the 4 chars
    const signed char* pc =
        a.pchars + (static_cast<long long>(ids_c) * a.T + a.t) * BW;
    int prev[BWMAX], code[BWMAX], up[BWMAX];
#pragma unroll
    for (int o = 0; o < BW; ++o) {
      prev[o] = is_b ? band0[o] : band1[o];
      code[o] = pc[o];
    }
#pragma unroll
    for (int o = 0; o < BW; ++o) up[o] = (o + 1 < BW ? prev[o + 1] : INF) + 1;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int d = 0;
#pragma unroll
      for (int o = 0; o < BW; ++o) {
        const int mis = code[o] == c ? 0 : (code[o] >= 0 ? 1 : INF);
        const int nl = min(prev[o] + mis, up[o]);
        d = o == 0 ? nl : min(nl, d + 1);
        newD[c][o] = code[o] >= -1 ? min(d, INF) : INF;
      }
    }
    // colMin registers: 7-bit op per register = cell (63 idle) | reset<<6
    const int dbv_mod = dbv & 63;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int op = (mr[1 + w / 4] >> (7 * (w % 4))) & 127;
      const int ini = (mr[4 + w / 4] >> (7 * (w % 4))) & 127;
      const int cell = op & 63;
      const int cur = is_b ? cm0[w] : cm1[w];
      const int base = (op & 64) ? min(INF, ini) : cur;
      int prev_arg = 0;
      if (TRACK) prev_arg = (op & 64) ? dbv_mod : (is_b ? ag0[w] : ag1[w]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int acc = INF;
#pragma unroll
        for (int o = 0; o < BW; ++o) acc = cell == o ? newD[c][o] : acc;
        reg[c][w] = cell < 63 ? min(base, acc) : cur;
        if (TRACK)
          arg[c][w] = (cell < 63 && acc < base) ? dbv_mod : prev_arg;
      }
    }
    // prune
    int cm_other = 0;
#pragma unroll
    for (int w = 0; w < W; ++w)
      cm_other = cfro == w ? (is_b ? cm1[w] : cm0[w]) : cm_other;
    bool any_surv = false;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int rowmin = newD[c][0];
#pragma unroll
      for (int o = 1; o < BW; ++o) rowmin = min(rowmin, newD[c][o]);
      int col = INF;
#pragma unroll
      for (int w = 0; w < W; ++w) col = cacc == w ? reg[c][w] : col;
      const bool ok = width[c] > 0 && min(rowmin, col) + cm_other <= ub;
      nar[c] = a.switchpoint > 0 && ok &&
               width[c] <= static_cast<uint32_t>(a.switchpoint);
      calive[c] = ok && !nar[c];
      any_surv = any_surv || ok;
    }
    died = !any_surv;
    keepv = !died;
  }
  const int new_id = died ? (ids | kGhostBit | (min(dbv, 1023) << 21)) : ids;
  bool stays[4];
  unsigned kc = 0, nc = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    stays[c] = keepv ? calive[c] : (c == 0 && alive);
    kc += stays[c];
    nc += nar[c];
  }

  // ---- positions: block scan, then the look-back over earlier tiles ----
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned v = kc | (nc << 16);           // at most 4 * kThreads each
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned u = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane_id >= d) v += u;
  }
  const unsigned acts = __popc(__ballot_sync(0xFFFFFFFFu, act));
  if (lane_id == 31) s_warp[warp] = v;
  if (lane_id == 0) s_act[warp] = acts;
  __syncthreads();
  unsigned before = 0, total = 0, act_total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? s_warp[w] : 0u;
    total += s_warp[w];
    act_total += s_act[w];
  }
  const unsigned excl = before + v - (kc | (nc << 16));
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
      if (act_total) atomicAdd(a.ctr + 1, 4ull * act_total);
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

  // ---- writes: the children that stay, then the narrow rows ----
  long long p = static_cast<long long>(s_base[0]) + (excl & 0xFFFFu);
  long long q = a.cnt + static_cast<long long>(s_base[1]) + (excl >> 16);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (stays[c] && p < a.cap) {
      long long* cr = a.o_ranges + RW * p;
      if (keepv) {
        uint32_t chv[RW];
#pragma unroll
        for (int k = 0; k < RW; ++k) chv[k] = k < 4 ? lane.pos(c, k) : 0u;
        if (RW > 4) lane.hints(a.bm, c, chv);
#pragma unroll
        for (int k = 0; k < RW; ++k) cr[k] = chv[k];
      } else {
#pragma unroll
        for (int k = 0; k < RW; ++k) cr[k] = par[k];
      }
      a.o_ids[p] = new_id;
      signed char* cb = a.o_band + p * 2 * BW;
#pragma unroll
      for (int o = 0; o < BW; ++o) {
        cb[o] = (keepv && is_b) ? newD[c][o] : band0[o];
        cb[BW + o] = (keepv && !is_b) ? newD[c][o] : band1[o];
      }
      signed char* cc = a.o_colmin + p * 2 * Wp;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        cc[w] = (keepv && is_b) ? reg[c][w] : cm0[w];
        cc[Wp + w] = (keepv && !is_b) ? reg[c][w] : cm1[w];
        if (TRACK) {
          cc[W + w] = (keepv && is_b) ? arg[c][w] : ag0[w];
          cc[Wp + W + w] = (keepv && !is_b) ? arg[c][w] : ag1[w];
        }
      }
    }
    p += stays[c];
    if (nar[c] && q < a.M) {
      long long* row = a.itv + 4 * q;
      row[0] = lane.pos(c, 0);
      row[1] = lane.pos(c, 1);
      row[2] = ids_c;
      row[3] = dbv;
    }
    q += nar[c];
  }
}

template <int KB, int WT, bool DYN = false, int RW = 4>
int launch(const BandArgs& a, cudaStream_t stream) {
  const size_t smem = DYN ? 0 : sizeof(int) * 7 * a.S;
  band_step_kernel<KB, WT, DYN, RW>
      <<<columba::grid_for(a.n_live, kThreads), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The static-schedule entries of lane width RW: kb 0..4 x W 1..2 templated,
// the rest through the generic entry.
template <int RW>
int launch_static(const BandArgs& a, int kb, int W, cudaStream_t stream) {
  switch (W <= 2 && kb <= 4 ? 2 * kb + W : 0) {
    case 1: return launch<0, 1, false, RW>(a, stream);
    case 2: return launch<0, 2, false, RW>(a, stream);
    case 3: return launch<1, 1, false, RW>(a, stream);
    case 4: return launch<1, 2, false, RW>(a, stream);
    case 5: return launch<2, 1, false, RW>(a, stream);
    case 6: return launch<2, 2, false, RW>(a, stream);
    case 7: return launch<3, 1, false, RW>(a, stream);
    case 8: return launch<3, 2, false, RW>(a, stream);
    case 9: return launch<4, 1, false, RW>(a, stream);
    case 10: return launch<4, 2, false, RW>(a, stream);
    default: return launch<-1, 0, false, RW>(a, stream);
  }
}

// The per-lane entry of lane width RW (per-read schedules): one register,
// kb 0..4 templated, the rest through the generic entry.
template <int RW>
int launch_per_lane(const BandArgs& a, int kb, int W, cudaStream_t stream) {
  if (W != 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (kb) {
    case 0: return launch<0, 1, true, RW>(a, stream);
    case 1: return launch<1, 1, true, RW>(a, stream);
    case 2: return launch<2, 1, true, RW>(a, stream);
    case 3: return launch<3, 1, true, RW>(a, stream);
    case 4: return launch<4, 1, true, RW>(a, stream);
    default: return launch<-1, 0, true, RW>(a, stream);
  }
}

// Fills the arguments every entry shares; returns false on a shape or a
// size no entry takes (no live lane, more tiles than statuses, an epoch
// out of its 30 bits).
inline bool common_args(BandArgs& a, const long long* ranges, const int* ids,
                        const signed char* band, const signed char* colmin,
                        const int* mrow, int S, const signed char* pchars,
                        int T, int t, int kb, int W, int switchpoint,
                        long long n_live, long long cap, long long* o_ranges,
                        int* o_ids, signed char* o_band,
                        signed char* o_colmin, long long* itv, long long M,
                        long long cnt, unsigned long long* ctr,
                        unsigned long long* status, long long tiles,
                        unsigned epoch) {
  a.ranges = ranges;
  a.ids = ids;
  a.band = band;
  a.colmin = colmin;
  a.mrow = mrow;
  a.S = S;
  a.dyn_meta = nullptr;
  a.pchars = pchars;
  a.T = T;
  a.t = t;
  a.bw = 2 * kb + 1;
  a.W = W;
  a.switchpoint = switchpoint;
  a.n_live = n_live;
  a.cap = cap;
  a.o_ranges = o_ranges;
  a.o_ids = o_ids;
  a.o_band = o_band;
  a.o_colmin = o_colmin;
  a.itv = itv;
  a.M = M;
  a.cnt = cnt;
  a.ctr = ctr;
  a.status = status;
  a.epoch = epoch;
  return !(kb < 0 || W < 1 || a.bw > kMaxBW || W > kMaxW || n_live < 1 ||
           (n_live + kThreads - 1) / kThreads > tiles || epoch == 0 ||
           epoch > 0x3FFFFFFFu || cap < 0 || M < 0 || cnt < 0 || cnt > M);
}

}  // namespace columba_band
