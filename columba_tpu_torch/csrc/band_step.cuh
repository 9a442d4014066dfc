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
// Per-lane entry (DYN, dynamic partitioning): every (read, search) has its
// own schedule, so a lane reads its own packed word at dyn_meta[id * T + t]
// (the layout of search/dynschedule.py: creset at bit 2, colo + 1 at bits
// 3-8, ub at bit 9, back depth at bit 17) and derives the ops of its single
// register from it (W = 1: dynamic partitions keep every part longer than
// 2k, so windows never overlap). Same body, no shared memory.
//
// Bound: two random 64 B occ rows per active lane, as kernel A, plus
// ~100 B of lane state in and ~200 B of child state out; the band and
// register arithmetic is a few hundred integer ops in registers. Inactive
// and dead lanes skip the occ reads.
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
// that stay in the frontier, and the other children are written with zero
// hints (a narrow child drains with its interval only; a pruned one is
// dropped). These entries are in band_step_rlc.cu, the Vanilla ones in
// band_step.cu; this header holds the one body.
#pragma once

#include "common.cuh"

namespace columba_band {

constexpr int kGhostBit = -2147483647 - 1;   // bit 31
constexpr int kGhostIdMask = (1 << 21) - 1;

struct BandArgs {
  columba::FmParams fm;
  columba::BmParams bm;
  const long long* ranges;      // (C, RW)
  const int* ids;               // (C,)
  const signed char* band;      // (C, 2, BW)
  const signed char* colmin;    // (C, 2, Wp): W registers (+ W witnesses)
  const int* mrow;              // (S, 7) this step's packed scalars
  int S;
  const int* dyn_meta;          // (R*S*T,) per-lane words (per-lane entry)
  const signed char* pchars;    // (R*S*T, BW) per-(lane id, step) cell codes
  int T;
  int t;
  int bw;                       // runtime band width and register count,
  int W;                        // read by the generic entry only
  int switchpoint;
  long long* ch_ranges;         // (C, 4, RW)
  int* new_ids;                 // (C,)
  signed char* ch_band;         // (C, 4, 2, BW)
  signed char* ch_colmin;       // (C, 4, 2, Wp)
  unsigned char* ch_alive;      // (C, 4)
  unsigned char* narrow;        // (C, 4)
  unsigned char* act_out;       // (C,)
  int* dbv_out;                 // (C,)
  long long C;
};

constexpr int kMaxBW = 2 * 13 + 1;   // ladder cutoff 13 (BEST_CUTOFF)
constexpr int kMaxW = 10;            // search/schedule.py MAX_REGS

// KB >= 0: sizes fixed at compile time. KB < 0: the generic entry. RW: lane
// width (4 Vanilla, 8 RLC, 12 textless with witness slots).
template <int KB, int WT, bool DYN, int RW = 4>
__global__ void band_step_kernel(BandArgs a) {
  constexpr bool kGeneric = KB < 0;
  constexpr bool TRACK = RW == 12;
  constexpr int BWMAX = kGeneric ? kMaxBW : 2 * KB + 1;
  constexpr int WMAX = kGeneric ? kMaxW : WT;
  const int BW = kGeneric ? a.bw : BWMAX;
  const int W = kGeneric ? a.W : WMAX;
  const int Wp = TRACK ? 2 * W : W;
  constexpr int INF = columba::INF;
  extern __shared__ int smeta[];
  if (!DYN) {
    for (int k = threadIdx.x; k < a.S * 7; k += blockDim.x)
      smeta[k] = a.mrow[k];
    __syncthreads();
  }
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= a.C) return;

  const long long* rg = a.ranges + RW * i;
  uint32_t par[RW];
#pragma unroll
  for (int k = 0; k < RW; ++k) par[k] = static_cast<uint32_t>(rg[k]);
  const int ids = a.ids[i];
  const bool ghost = ids < 0;
  const int ids_c = ids & kGhostIdMask;
  // the step's scalars of this lane: meta word, register ops and inits
  int mr[7];
  int cacc, cfro, ub, dbv;
  if (DYN) {
    const int word = a.dyn_meta[static_cast<long long>(ids_c) * a.T + a.t];
    const int colo = ((word >> 3) & 63) - 1;
    mr[0] = word;
    mr[1] = colo >= 0 ? (colo | (((word >> 2) & 1) << 6)) : 63;
    mr[2] = mr[3] = 0;
    mr[4] = 63;
    mr[5] = mr[6] = 0;
    cacc = colo >= 0 ? 0 : 15;
    cfro = 0;
    ub = (word >> 9) & 255;
    dbv = (word >> 17) & 4095;
  } else {
    const int* row = smeta + (ids_c % a.S) * 7;
#pragma unroll
    for (int k = 0; k < 7; ++k) mr[k] = row[k];
    cacc = (mr[0] >> 2) & 15;
    cfro = (mr[0] >> 6) & 15;
    ub = (mr[0] >> 10) & 255;
    dbv = (mr[0] >> 18) & 4095;
  }
  const int meta = mr[0];
  const bool alive = par[1] > par[0];
  const bool act = (meta & 1) && alive && !ghost;
  const bool is_b = ((meta >> 1) & 1) == 0;

  int band0[BWMAX], band1[BWMAX], cm0[WMAX], cm1[WMAX];
  int ag0[TRACK ? WMAX : 1], ag1[TRACK ? WMAX : 1];
#pragma unroll
  for (int o = 0; o < BW; ++o) {
    band0[o] = a.band[(2 * i) * BW + o];
    band1[o] = a.band[(2 * i + 1) * BW + o];
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    cm0[w] = a.colmin[(2 * i) * Wp + w];
    cm1[w] = a.colmin[(2 * i + 1) * Wp + w];
    if (TRACK) {
      ag0[w] = a.colmin[(2 * i) * Wp + W + w];
      ag1[w] = a.colmin[(2 * i + 1) * Wp + W + w];
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

  a.new_ids[i] = died ? (ids | kGhostBit | (min(dbv, 1023) << 21)) : ids;
  a.act_out[i] = act;
  a.dbv_out[i] = dbv;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const long long o4 = 4 * i + c;
    a.ch_alive[o4] = keepv ? calive[c] : (c == 0 && alive);
    a.narrow[o4] = nar[c];
    long long* cr = a.ch_ranges + RW * o4;
    if (keepv) {
      uint32_t chv[RW];
#pragma unroll
      for (int k = 0; k < RW; ++k) chv[k] = k < 4 ? lane.pos(c, k) : 0u;
      if (RW > 4 && calive[c]) lane.hints(a.bm, c, chv);
#pragma unroll
      for (int k = 0; k < RW; ++k) cr[k] = chv[k];
    } else {
      const bool pass = c == 0 && alive;
#pragma unroll
      for (int k = 0; k < RW; ++k) cr[k] = pass ? par[k] : 0u;
    }
    signed char* cb = a.ch_band + o4 * 2 * BW;
#pragma unroll
    for (int o = 0; o < BW; ++o) {
      cb[o] = (keepv && is_b) ? newD[c][o] : band0[o];
      cb[BW + o] = (keepv && !is_b) ? newD[c][o] : band1[o];
    }
    signed char* cc = a.ch_colmin + o4 * 2 * Wp;
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
}

template <int KB, int WT, bool DYN = false, int RW = 4>
int launch(const BandArgs& a, cudaStream_t stream) {
  constexpr int kThreads = 128;
  const size_t smem = DYN ? 0 : sizeof(int) * 7 * a.S;
  band_step_kernel<KB, WT, DYN, RW>
      <<<columba::grid_for(a.C, kThreads), kThreads, smem, stream>>>(a);
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

// Fills the arguments every entry shares; returns false on a shape no
// entry takes.
inline bool common_args(BandArgs& a, const long long* ranges, const int* ids,
                        const signed char* band, const signed char* colmin,
                        const int* mrow, int S, const signed char* pchars,
                        int T, int t, int kb, int W, int switchpoint,
                        long long* ch_ranges, int* new_ids,
                        signed char* ch_band, signed char* ch_colmin,
                        unsigned char* ch_alive, unsigned char* narrow,
                        unsigned char* act_out, int* dbv_out, long long C) {
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
  a.ch_ranges = ch_ranges;
  a.new_ids = new_ids;
  a.ch_band = ch_band;
  a.ch_colmin = ch_colmin;
  a.ch_alive = ch_alive;
  a.narrow = narrow;
  a.act_out = act_out;
  a.dbv_out = dbv_out;
  a.C = C;
  return !(kb < 0 || W < 1 || a.bw > kMaxBW || W > kMaxW);
}

}  // namespace columba_band

