// Kernel B: the per-lane arithmetic of one band step of the scheme executor.
//
// Replaces the lane-local part of columba_tpu/search/executor.py
// make_step.step (with _band_row_update): for each frontier lane it
//   1. extends the lane's range pair by all 4 chars (extend_lane),
//   2. updates the active side's banded edit row for each char on int8
//      cells (diag/up, left-to-right deletion scan, saturation at INF),
//   3. updates the W colMin registers from the step's packed 7-bit ops,
//   4. prunes each child by min(row min, fresh window register) + the other
//      side's completed register <= U, splits narrow children (width <=
//      switchpoint, drained to in-text verification) from alive ones,
//   5. marks a lane whose children all die as a ghost (id bit 31, death
//      depth in bits 21-30),
// and writes the 4 children's state. The order-keeping 4C -> C compaction
// and the drain append stay in PyTorch (search/executor.py).
//
// The step's per-search scalars (S rows of 7 packed int32 words) sit in
// shared memory; each lane decodes its own row by search id.
//
// Bound: two random 64 B occ rows per active lane, as kernel A, plus
// ~100 B of lane state in and ~200 B of child state out; the band and
// register arithmetic is a few hundred integer ops in registers. Inactive
// and dead lanes skip the occ reads. Templated on the band radius KB and
// the register count W so every array stays in registers; only the
// slice's KB = 2, W = 2 is instantiated.
#include "common.cuh"

namespace {

constexpr int kGhostBit = -2147483647 - 1;   // bit 31
constexpr int kGhostIdMask = (1 << 21) - 1;

struct BandArgs {
  columba::FmParams fm;
  const long long* ranges;      // (C, 4)
  const int* ids;               // (C,)
  const signed char* band;      // (C, 2, BW)
  const signed char* colmin;    // (C, 2, W)
  const int* mrow;              // (S, 7) this step's packed scalars
  int S;
  const signed char* pchars;    // (R*S*T, BW) per-(lane id, step) cell codes
  int T;
  int t;
  int switchpoint;
  long long* ch_ranges;         // (C, 4, 4)
  int* new_ids;                 // (C,)
  signed char* ch_band;         // (C, 4, 2, BW)
  signed char* ch_colmin;       // (C, 4, 2, W)
  unsigned char* ch_alive;      // (C, 4)
  unsigned char* narrow;        // (C, 4)
  unsigned char* act_out;       // (C,)
  int* dbv_out;                 // (C,)
  long long C;
};

template <int KB, int W>
__global__ void band_step_kernel(BandArgs a) {
  constexpr int BW = 2 * KB + 1;
  constexpr int INF = columba::INF;
  extern __shared__ int smeta[];
  for (int k = threadIdx.x; k < a.S * 7; k += blockDim.x) smeta[k] = a.mrow[k];
  __syncthreads();
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= a.C) return;

  const long long* rg = a.ranges + 4 * i;
  const long long p_lo = rg[0], p_hi = rg[1], p_rlo = rg[2], p_rhi = rg[3];
  const int ids = a.ids[i];
  const bool ghost = ids < 0;
  const int ids_c = ids & kGhostIdMask;
  const int* mr = smeta + (ids_c % a.S) * 7;
  const int meta = mr[0];
  const bool alive = p_hi > p_lo;
  const int cacc = (meta >> 2) & 15, cfro = (meta >> 6) & 15;
  const int ub = (meta >> 10) & 255, dbv = (meta >> 18) & 4095;
  const bool act = (meta & 1) && alive && !ghost;
  const bool is_b = ((meta >> 1) & 1) == 0;

  int band0[BW], band1[BW], cm0[W], cm1[W];
#pragma unroll
  for (int o = 0; o < BW; ++o) {
    band0[o] = a.band[(2 * i) * BW + o];
    band1[o] = a.band[(2 * i + 1) * BW + o];
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    cm0[w] = a.colmin[(2 * i) * W + w];
    cm1[w] = a.colmin[(2 * i + 1) * W + w];
  }

  uint32_t ch[4][4] = {};
  int newD[4][BW], reg[4][W];
  bool calive[4] = {false, false, false, false};
  bool nar[4] = {false, false, false, false};
  bool keepv = false, died = false;
  if (act) {
    columba::extend_lane(a.fm, static_cast<uint32_t>(p_lo),
                         static_cast<uint32_t>(p_hi),
                         static_cast<uint32_t>(p_rlo),
                         static_cast<uint32_t>(p_rhi), is_b ? 0 : 1, ch);
    // banded row update for the 4 chars
    const signed char* pc =
        a.pchars + (static_cast<long long>(ids_c) * a.T + a.t) * BW;
    int prev[BW], code[BW], up[BW];
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
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int op = (mr[1 + w / 4] >> (7 * (w % 4))) & 127;
      const int ini = (mr[4 + w / 4] >> (7 * (w % 4))) & 127;
      const int cell = op & 63;
      const int cur = is_b ? cm0[w] : cm1[w];
      const int base = (op & 64) ? min(INF, ini) : cur;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int acc = INF;
#pragma unroll
        for (int o = 0; o < BW; ++o) acc = cell == o ? newD[c][o] : acc;
        reg[c][w] = cell < 63 ? min(base, acc) : cur;
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
      const uint32_t width = ch[c][1] - ch[c][0];
      int rowmin = newD[c][0];
#pragma unroll
      for (int o = 1; o < BW; ++o) rowmin = min(rowmin, newD[c][o]);
      int col = INF;
#pragma unroll
      for (int w = 0; w < W; ++w) col = cacc == w ? reg[c][w] : col;
      const bool ok = width > 0 && min(rowmin, col) + cm_other <= ub;
      nar[c] = a.switchpoint > 0 && ok &&
               width <= static_cast<uint32_t>(a.switchpoint);
      calive[c] = ok && !nar[c];
      any_surv = any_surv || ok;
    }
    died = !any_surv;
    keepv = !died;
  }

  a.new_ids[i] = died ? (ids | kGhostBit | (min(dbv, 1023) << 21)) : ids;
  a.act_out[i] = act;
  a.dbv_out[i] = dbv;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const long long o4 = 4 * i + c;
    a.ch_alive[o4] = keepv ? calive[c] : (c == 0 && alive);
    a.narrow[o4] = nar[c];
    long long* cr = a.ch_ranges + 4 * o4;
    if (keepv) {
#pragma unroll
      for (int k = 0; k < 4; ++k) cr[k] = ch[c][k];
    } else {
      const bool par = c == 0 && alive;
      cr[0] = par ? p_lo : 0;
      cr[1] = par ? p_hi : 0;
      cr[2] = par ? p_rlo : 0;
      cr[3] = par ? p_rhi : 0;
    }
    signed char* cb = a.ch_band + o4 * 2 * BW;
#pragma unroll
    for (int o = 0; o < BW; ++o) {
      cb[o] = (keepv && is_b) ? newD[c][o] : band0[o];
      cb[BW + o] = (keepv && !is_b) ? newD[c][o] : band1[o];
    }
    signed char* cc = a.ch_colmin + o4 * 2 * W;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      cc[w] = (keepv && is_b) ? reg[c][w] : cm0[w];
      cc[W + w] = (keepv && !is_b) ? reg[c][w] : cm1[w];
    }
  }
}

template <int KB, int W>
int launch(const BandArgs& a, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const size_t smem = sizeof(int) * 7 * a.S;
  band_step_kernel<KB, W>
      <<<columba::grid_for(a.C, kThreads), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int columba_band_step(
    const int* occ, long long blocks, unsigned c0, unsigned c1, unsigned c2,
    unsigned c3, unsigned d0, unsigned d1, const long long* ranges,
    const int* ids, const signed char* band, const signed char* colmin,
    const int* mrow, int S, const signed char* pchars, int T, int t, int kb,
    int W, int switchpoint, long long* ch_ranges, int* new_ids,
    signed char* ch_band, signed char* ch_colmin, unsigned char* ch_alive,
    unsigned char* narrow, unsigned char* act_out, int* dbv_out, long long C,
    cudaStream_t stream) {
  BandArgs a;
  a.fm = columba::fm_params(occ, blocks, c0, c1, c2, c3, d0, d1);
  a.ranges = ranges;
  a.ids = ids;
  a.band = band;
  a.colmin = colmin;
  a.mrow = mrow;
  a.S = S;
  a.pchars = pchars;
  a.T = T;
  a.t = t;
  a.switchpoint = switchpoint;
  a.ch_ranges = ch_ranges;
  a.new_ids = new_ids;
  a.ch_band = ch_band;
  a.ch_colmin = ch_colmin;
  a.ch_alive = ch_alive;
  a.narrow = narrow;
  a.act_out = act_out;
  a.dbv_out = dbv_out;
  a.C = C;
  // only the slice's configuration is instantiated: kuch1 at k = 2
  if (kb == 2 && W == 2) return launch<2, 2>(a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
