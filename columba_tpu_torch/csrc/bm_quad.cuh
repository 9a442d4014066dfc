// The RLC (b-move) extension step of kernels E and F, four lanes a row.
//
// Computes what columba_tpu/ops/bextend.py extend_char computes (with
// _run_of_pos, _ff_forward and _ff_backward) for one row and one char,
// every column bit-identical, run hints included; an empty child is the
// zero range. Kernels A and B keep BmLane (common.cuh).
//
// What bounds the step is a chain of dependent reads, not bytes. BmLane
// runs it on one thread: the two endpoint rows, then the chosen child's two
// LF-run reads, then four run-hint walks one after another, each a chain of
// 4 B reads 80 B apart (a new sector each) that falls back to a binary
// search of about 23 probes past FF_CAP runs. Here a quad of lanes owns the
// row and the step is three rounds deep in the common case:
//   1. the two endpoint rows, two 16 B words a lane (lane 0: lo row w0 w1,
//      lane 1: hi row w0 w1, lane 2: lo row w2 w4, lane 3: hi row w3 w4),
//      shared with __shfl_sync within the quad;
//   2. lanes 0 and 1 read the LF run of the next / previous c-run, but only
//      where the row read in round 1 is not itself a c-run (its LF run is
//      in word 0); lanes 2 and 3 start their walks at once;
//   3. each lane walks one run hint (a_lo, a_hi - 1, b_lo forward; b_hi - 1
//      backward) on the compact run tables of index/bmove.py run_tables:
//      one 4 B START a run, so a 16 B-aligned read of twelve entries
//      covers the eight runs from the hint (QUAD_WINDOW). Past them the
//      walk reads the run of the position's bucket and walks forward from
//      there, eight runs a read, in place of the binary search; both find
//      the run that holds the position, which is what the capped walk and
//      its binary search return once the hint is behind it.
// So a step's chain is rows -> LF run -> the longest walk, not rows -> LF
// runs -> the sum of four walks.
#pragma once

#include "common.cuh"

namespace columba {

constexpr int QUAD_WINDOW = 8;   // runs one walk read covers (bextend WINDOW)

// kernels E and F's run tables (index/bmove.py run_tables)
struct BmTables {
  const uint32_t* starts;   // fwd runs' START, then rev's at starts_rev;
                            // n + 1 past each sentinel
  const int* run_at;        // fwd run of every 2^shift-th position
  const int* run_at_rev;    // rev run of every 2^shift-th position
  uint32_t starts_rev;      // a multiple of 4: 16 B aligned
  int shift;
};

__host__ __forceinline__ BmTables bm_tables(const unsigned* starts,
                                            unsigned starts_rev,
                                            const int* run_at,
                                            const int* run_at_rev,
                                            int shift) {
  BmTables t;
  t.starts = starts;
  t.run_at = run_at;
  t.run_at_rev = run_at_rev;
  t.starts_rev = starts_rev;
  t.shift = shift;
  return t;
}

// How many of S[lo..hi] (hi - lo < 8) are <= pos: three 16 B loads from the
// aligned index at or below lo. S is sorted, so that count places pos.
__device__ __forceinline__ int starts_le(const uint32_t* __restrict__ s,
                                         int lo, int hi, uint32_t pos) {
  const int a = lo & ~3;
  const uint4* g = reinterpret_cast<const uint4*>(s + a);
  const uint4 g0 = __ldg(g), g1 = __ldg(g + 1), g2 = __ldg(g + 2);
  const uint32_t v[12] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y,
                          g1.z, g1.w, g2.x, g2.y, g2.z, g2.w};
  int n = 0;
#pragma unroll
  for (int k = 0; k < 12; ++k)
    n += (a + k >= lo && a + k <= hi && v[k] <= pos) ? 1 : 0;
  return n;
}

// ff_forward (back false: the first run j >= h with END[j] = START[j + 1]
// > pos) or ff_backward (back true: the last run j <= h with START[j] <=
// pos) on one direction's run tables.
__device__ __forceinline__ int quad_walk(const BmTables& t, bool rev, int h,
                                         uint32_t pos, bool back) {
  const uint32_t* s = t.starts + (rev ? t.starts_rev : 0u);
  const int lo = back ? max(h - (QUAD_WINDOW - 1), 0) : h + 1;
  const int hi = back ? h : h + QUAD_WINDOW;
  const int n = starts_le(s, lo, hi, pos);
  if (back ? n > 0 : n < QUAD_WINDOW) return back ? lo - 1 + n : h + n;
  // the run that holds pos lies beyond the window: from its bucket's run
  int run = __ldg((rev ? t.run_at_rev : t.run_at) + (pos >> t.shift));
  if (!back) run = max(run, h + QUAD_WINDOW);
  for (;;) {
    const int k = starts_le(s, run + 1, run + QUAD_WINDOW, pos);
    if (k < QUAD_WINDOW) return run + k;
    run += QUAD_WINDOW;
  }
}

__device__ __forceinline__ uint32_t quad_get(unsigned mask, uint32_t v,
                                             int lane) {
  return __shfl_sync(mask, v, lane, 4);
}

// One RLC extension of the quad's 8-wide range r (the same in its four
// lanes) by char c (0..3) in direction dir (0 backward, 1 forward): the
// child's 8 columns in o, the same in the four lanes. q: the lane in the
// quad; qmask: the quad's lanes in the warp.
__device__ __forceinline__ void quad_extend(const BmParams& p,
                                            const BmTables& t,
                                            const uint32_t* r, int c,
                                            int dir, int q, unsigned qmask,
                                            uint32_t* o) {
  const bool bwd = dir == 0;
  const long long rev_off = static_cast<long long>(p.r_fwd) + 1;
  const long long off_a = bwd ? 0 : rev_off;
  const uint32_t a_lo = bwd ? r[0] : r[2];
  const uint32_t a_hi = bwd ? r[1] : r[3];
  const uint32_t b_lo = bwd ? r[2] : r[0];
  const int a_run_lo = static_cast<int>(bwd ? r[4] : r[6]);
  const int a_run_hi1 = static_cast<int>(bwd ? r[5] : r[7]);
  const int b_run_lo = static_cast<int>(bwd ? r[6] : r[4]);
  const int b_run_hi1 = static_cast<int>(bwd ? r[7] : r[5]);

  // round 1: words 0 and 1 (START END LF_POS LF_RUN | CHAR ...) of the lo
  // and hi rows on lanes 0 and 1, NEXT and PREV with CUM on lanes 2 and 3
  const long long row = off_a + ((q & 1) ? a_run_hi1 : a_run_lo);
  const uint4 x = bm_word(p, row, q < 2 ? 0 : 2 + (q & 1));
  const uint4 y = bm_word(p, row, q < 2 ? 1 : 4);
  const uint32_t xc = c == 0 ? x.x : c == 1 ? x.y : c == 2 ? x.z : x.w;
  const uint32_t start_lo = quad_get(qmask, x.x, 0);
  const uint32_t lf_lo = quad_get(qmask, x.w, 0);
  const uint32_t char_lo = quad_get(qmask, y.x, 0);
  const uint32_t start_hi = quad_get(qmask, x.x, 1);
  const uint32_t lf_hi = quad_get(qmask, x.w, 1);
  const uint32_t char_hi = quad_get(qmask, y.x, 1);
  const uint32_t next_c = quad_get(qmask, xc, 2);
  const uint32_t prev_c = quad_get(qmask, xc, 3);
  const uint32_t cum_lo[4] = {
      quad_get(qmask, y.x, 2), quad_get(qmask, y.y, 2),
      quad_get(qmask, y.z, 2), quad_get(qmask, y.w, 2)};
  const uint32_t cum_hi[4] = {
      quad_get(qmask, y.x, 3), quad_get(qmask, y.y, 3),
      quad_get(qmask, y.z, 3), quad_get(qmask, y.w, 3)};

  // the child's interval; the other side needs every char's width
  uint32_t w = 0, occ_c = 0, wsum = 0, below = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t ol =
        cum_lo[k] + (char_lo == uint32_t(k) ? a_lo - start_lo : 0u);
    const uint32_t oh =
        cum_hi[k] + (char_hi == uint32_t(k) ? a_hi - start_hi : 0u);
    const uint32_t wk = oh - ol;
    wsum += wk;
    below += k < c ? wk : 0u;
    w = k == c ? wk : w;
    occ_c = k == c ? ol : occ_c;
  }
  if (w == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) o[k] = 0u;
    return;
  }
  uint32_t first = p.first[0];
#pragma unroll
  for (int k = 1; k < 4; ++k) first = k == c ? p.first[k] : first;
  const uint32_t al = first + occ_c;
  const uint32_t bl = b_lo + ((a_hi - a_lo) - wsum) + below;

  // rounds 2-3: one hint a lane. Active side: the LF run of the first
  // (last) c-run the parent touches, the row's own where it is a c-run;
  // PREV = -1 clips to run 0, as the JAX int32 cast does.
  int h;
  if (q < 2) {
    const bool own = q == 0 ? char_lo == uint32_t(c) : char_hi == uint32_t(c);
    const int via = static_cast<int>(q == 0 ? next_c : prev_c);
    h = own ? static_cast<int>(q == 0 ? lf_lo : lf_hi)
            : static_cast<int>(bm_col(p, off_a + max(via, 0), 3));
  } else {
    h = q == 2 ? b_run_lo : b_run_hi1;
  }
  const uint32_t pos = q == 0 ? al : q == 1 ? al + w - 1u
                     : q == 2 ? bl : bl + w - 1u;
  const bool rev = (q < 2) != bwd;    // the active side's table is fwd on
                                      // a backward step
  const uint32_t run =
      static_cast<uint32_t>(quad_walk(t, rev, max(h, 0), pos, q == 3));
  const uint32_t a_rlo = quad_get(qmask, run, 0);
  const uint32_t a_rhi1 = quad_get(qmask, run, 1);
  const uint32_t b_rlo = quad_get(qmask, run, 2);
  const uint32_t b_rhi1 = quad_get(qmask, run, 3);
  o[0] = bwd ? al : bl;
  o[1] = (bwd ? al : bl) + w;
  o[2] = bwd ? bl : al;
  o[3] = (bwd ? bl : al) + w;
  o[4] = bwd ? a_rlo : b_rlo;
  o[5] = bwd ? a_rhi1 : b_rhi1;
  o[6] = bwd ? b_rlo : a_rlo;
  o[7] = bwd ? b_rhi1 : a_rhi1;
}

}  // namespace columba
