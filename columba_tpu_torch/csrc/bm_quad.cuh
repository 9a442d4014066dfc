// The RLC (b-move) extension step, four lanes a child: kernels A (its loop
// and per-step entries), B (its rlc, per_lane_rlc and textless entries), E
// and F.
//
// Computes what columba_tpu/ops/bextend.py extend_char / extend_all compute
// (with _run_of_pos, _ff_forward and _ff_backward) for one child, every
// column bit-identical, run hints and toeholds included; an empty child is
// the zero range.
//
// What bounds the step is a chain of dependent reads, not bytes. A thread
// that owns the child alone reads the two endpoint rows, then the chosen
// child's two LF-run reads, then walks its four run hints one after
// another, each a chain of 4 B reads 80 B apart on the fused rows (a new
// sector each) that falls back to a binary search of about 23 probes past
// FF_CAP runs. Here a quad of lanes owns the child and the step is three rounds
// deep in the common case:
//   1. the two endpoint rows (quad_extend: two 16 B words a lane, lane 0 lo
//      row w0 w1, lane 1 hi row w0 w1, lane 2 lo row w2 w4, lane 3 hi row
//      w3 w4, shared with __shfl_sync within the quad; kernel B: the lane's
//      own thread, which needs every child's width for its band arithmetic,
//      and hands the children it keeps to the quads as QuadChild records);
//   2. lanes 0 and 1 read the LF run of the next / previous c-run, but only
//      where the row read in round 1 is not itself a c-run (its LF run is
//      in word 0); on 12-wide lanes lane 1 reads that run's START, END,
//      SA_LAST and CUM words as well where the toehold resets from its
//      samples; lanes 2 and 3 start their walks at once;
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

// the run tables (index/bmove.py run_tables)
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

__device__ __forceinline__ uint32_t pick4(const uint4& w, int c) {
  return c == 0 ? w.x : c == 1 ? w.y : c == 2 ? w.z : w.w;
}

// One non-empty child's walk work: what lane q of a quad needs to find its
// run hint and, on 12-wide lanes, what lane 1 needs for the toehold.
struct QuadChild {
  uint32_t pos[4];   // the positions the hints must hold: active lo,
                     // active hi - 1, other lo, other hi - 1
  int h[4];          // where the walks start: lanes 0 and 1 the LF run
                     // itself or (flag bits 1, 2) the run whose LF run it
                     // is; lanes 2 and 3 the parent's other-side hints
  uint32_t flags;    // bit 0 backward; bits 1, 2: lane 0, 1 reads the LF
                     // run of run h; bit 3: lane 1 resets the toehold from
                     // run h's samples; bits 4-5 the char
  uint32_t toe[3];   // the child's toehold [value, offset, flag]; with bit
                     // 3, toe[1] is first[c] - a_lo, lane 1 adds the rest
};

// The QuadChild of child c (width w > 0, active lo al, other lo bl) of a
// parent read in round 1: own_lo / own_hi whether the parent's lo / hi row
// is itself a c-run, lf_lo / lf_hi their LF runs, next_c / prev_c the
// next / previous c-run (PREV = -1 clips to run 0 in quad_hint, as the JAX
// int32 cast does). RW 12: r holds the parent's toehold at 8..10, parent_w
// its width, sa_first_hi and cum_hi_c the hi row's SA_FIRST and CUM[c]
// (bextend.py:204-253: the anchor survives when every parent occurrence
// extends by c, start - 1 on prepend, end + 1 on append; otherwise it
// resets from the queried side's samples: the last c-row of the parent is
// hi - 1 itself, its run's FIRST sample, or the previous c-run's LAST row).
template <int RW>
__device__ __forceinline__ void quad_child(
    const BmParams& p, const uint32_t* r, bool bwd, int c, uint32_t w,
    uint32_t al, uint32_t bl, bool own_lo, bool own_hi, uint32_t lf_lo,
    uint32_t lf_hi, uint32_t next_c, uint32_t prev_c, int b_run_lo,
    int b_run_hi1, uint32_t parent_w, uint32_t sa_first_hi,
    uint32_t cum_hi_c, QuadChild& ch) {
  ch.pos[0] = al;
  ch.pos[1] = al + w - 1u;
  ch.pos[2] = bl;
  ch.pos[3] = bl + w - 1u;
  ch.h[0] = static_cast<int>(own_lo ? lf_lo : next_c);
  ch.h[1] = static_cast<int>(own_hi ? lf_hi : prev_c);
  ch.h[2] = b_run_lo;
  ch.h[3] = b_run_hi1;
  ch.flags = (bwd ? 1u : 0u) | (own_lo ? 0u : 2u) | (own_hi ? 0u : 4u) |
             (static_cast<uint32_t>(c) << 4);
  if constexpr (RW >= 12) {
    if (w == parent_w) {
      ch.toe[0] = bwd ? r[8] - (r[10] == 0u ? 1u : 0u)
                      : r[8] + (r[10] == 1u ? 1u : 0u);
      ch.toe[1] = r[9];
      ch.toe[2] = r[10];
    } else {
      uint32_t fc = p.first[0];
#pragma unroll
      for (int s = 1; s < 4; ++s) fc = s == c ? p.first[s] : fc;
      ch.toe[0] = bwd ? sa_first_hi - 1u : p.n - sa_first_hi;
      ch.toe[1] = fc - al + (own_hi ? cum_hi_c : 0u);
      ch.toe[2] = bwd ? 0u : 1u;
      if (!own_hi) ch.flags |= 8u;
    }
  }
}

// Rounds 2 and 3 for lane q of the quad that owns child ch: its run hint
// (the child's column 4 + ((q + (bwd ? 0 : 2)) & 3)); on lane 1 with flag
// bit 3, also the toehold's value and offset into toe. The lane picks its
// fields by selects, not by indexing with q, which would put the record
// in local memory.
template <class T>
__device__ __forceinline__ T sel4(const T (&v)[4], int q) {
  return q == 0 ? v[0] : q == 1 ? v[1] : q == 2 ? v[2] : v[3];
}

template <int RW>
__device__ __forceinline__ uint32_t quad_hint(const BmParams& p,
                                              const BmTables& t,
                                              const QuadChild& ch, int q,
                                              uint32_t toe[3]) {
  const bool bwd = ch.flags & 1u;
  int h = sel4(ch.h, q);
  if (q < 2 && ((ch.flags >> (1 + q)) & 1u)) {
    const long long row =
        (bwd ? 0 : static_cast<long long>(p.r_fwd) + 1) + max(h, 0);
    if (RW >= 12 && q == 1 && (ch.flags & 8u)) {
      const uint4 w0 = bm_word(p, row, 0);
      const uint4 w1 = bm_word(p, row, 1);
      const uint4 w4 = bm_word(p, row, 4);
      h = static_cast<int>(w0.w);
      toe[0] = bwd ? w1.z - 1u : p.n - w1.z;
      toe[1] += pick4(w4, (ch.flags >> 4) & 3) + (w0.y - w0.x - 1u);
    } else {
      h = static_cast<int>(bm_col(p, row, 3));
    }
  }
  const bool rev = (q < 2) != bwd;    // the active side's table is fwd on
                                      // a backward step
  return static_cast<uint32_t>(
      quad_walk(t, rev, max(h, 0), sel4(ch.pos, q), q == 3));
}

// One RLC extension of the quad's RW-wide range r (the same in its four
// lanes) by char c (0..3) in direction dir (0 backward, 1 forward): the
// child's RW columns in o, the same in the four lanes. q: the lane in the
// quad; qmask: the quad's lanes in the warp.
template <int RW = 8>
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

  // round 1: words 0 and 1 (START END LF_POS LF_RUN | CHAR SA_FIRST ...)
  // of the lo and hi rows on lanes 0 and 1, NEXT and PREV with CUM on
  // lanes 2 and 3
  const long long row = off_a + ((q & 1) ? a_run_hi1 : a_run_lo);
  const uint4 x = bm_word(p, row, q < 2 ? 0 : 2 + (q & 1));
  const uint4 y = bm_word(p, row, q < 2 ? 1 : 4);
  const uint32_t xc = pick4(x, c);
  const uint32_t start_lo = quad_get(qmask, x.x, 0);
  const uint32_t lf_lo = quad_get(qmask, x.w, 0);
  const uint32_t char_lo = quad_get(qmask, y.x, 0);
  const uint32_t start_hi = quad_get(qmask, x.x, 1);
  const uint32_t lf_hi = quad_get(qmask, x.w, 1);
  const uint32_t char_hi = quad_get(qmask, y.x, 1);
  const uint32_t sa_first_hi = RW >= 12 ? quad_get(qmask, y.y, 1) : 0u;
  const uint32_t next_c = quad_get(qmask, xc, 2);
  const uint32_t prev_c = quad_get(qmask, xc, 3);
  const uint32_t cum_lo[4] = {
      quad_get(qmask, y.x, 2), quad_get(qmask, y.y, 2),
      quad_get(qmask, y.z, 2), quad_get(qmask, y.w, 2)};
  const uint32_t cum_hi[4] = {
      quad_get(qmask, y.x, 3), quad_get(qmask, y.y, 3),
      quad_get(qmask, y.z, 3), quad_get(qmask, y.w, 3)};

  // the child's interval; the other side needs every char's width
  uint32_t w = 0, occ_c = 0, wsum = 0, below = 0, cum_hi_c = 0;
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
    cum_hi_c = k == c ? cum_hi[k] : cum_hi_c;
  }
  if (w == 0) {
#pragma unroll
    for (int k = 0; k < RW; ++k) o[k] = 0u;
    return;
  }
  uint32_t first = p.first[0];
#pragma unroll
  for (int k = 1; k < 4; ++k) first = k == c ? p.first[k] : first;
  const uint32_t al = first + occ_c;
  const uint32_t bl = b_lo + ((a_hi - a_lo) - wsum) + below;

  QuadChild ch;
  quad_child<RW>(p, r, bwd, c, w, al, bl, char_lo == uint32_t(c),
                 char_hi == uint32_t(c), lf_lo, lf_hi, next_c, prev_c,
                 static_cast<int>(bwd ? r[6] : r[4]),
                 static_cast<int>(bwd ? r[7] : r[5]), a_hi - a_lo,
                 sa_first_hi, cum_hi_c, ch);
  uint32_t toe[3] = {ch.toe[0], ch.toe[1], ch.toe[2]};
  const uint32_t run = quad_hint<RW>(p, t, ch, q, toe);
  o[0] = bwd ? al : bl;
  o[1] = (bwd ? al : bl) + w;
  o[2] = bwd ? bl : al;
  o[3] = (bwd ? bl : al) + w;
  const uint32_t run0 = quad_get(qmask, run, 0);
  const uint32_t run1 = quad_get(qmask, run, 1);
  const uint32_t run2 = quad_get(qmask, run, 2);
  const uint32_t run3 = quad_get(qmask, run, 3);
  o[4] = bwd ? run0 : run2;
  o[5] = bwd ? run1 : run3;
  o[6] = bwd ? run2 : run0;
  o[7] = bwd ? run3 : run1;
  if constexpr (RW >= 12) {
    o[8] = quad_get(qmask, toe[0], 1);
    o[9] = quad_get(qmask, toe[1], 1);
    o[10] = ch.toe[2];
    o[11] = 0u;
  }
}

// Kernel B's RLC lane (K18 inside K7 and K20): its own thread reads the
// two endpoint rows (four of their five words) and gives every child's
// interval, which the band arithmetic needs; stage(c) hands a child that
// stays in the frontier to a quad (QuadChild) for its hint walks. An empty
// child (width 0) is zero.
template <int RW>
struct BmLane {
  bool bwd;
  uint32_t a_lo, a_hi;
  int b_run_lo, b_run_hi1;
  uint32_t char_lo, char_hi, lf_lo, lf_hi, sa_first_hi;
  uint32_t nxt[4], prv[4], cum_hi[4];
  uint32_t na_lo[4], width[4], nb_lo[4];
  uint32_t toe[3];

  __device__ __forceinline__ void init(const FmParams&, const BmParams& p,
                                       const uint32_t* r, int dir) {
    bwd = dir == 0;
    const long long off_a = bwd ? 0 : static_cast<long long>(p.r_fwd) + 1;
    a_lo = bwd ? r[0] : r[2];
    a_hi = bwd ? r[1] : r[3];
    const uint32_t b_lo = bwd ? r[2] : r[0];
    const int a_run_lo = static_cast<int>(bwd ? r[4] : r[6]);
    const int a_run_hi1 = static_cast<int>(bwd ? r[5] : r[7]);
    b_run_lo = static_cast<int>(bwd ? r[6] : r[4]);
    b_run_hi1 = static_cast<int>(bwd ? r[7] : r[5]);
    const uint4 l0 = bm_word(p, off_a + a_run_lo, 0);
    const uint4 l1 = bm_word(p, off_a + a_run_lo, 1);
    const uint4 l2 = bm_word(p, off_a + a_run_lo, 2);
    const uint4 l4 = bm_word(p, off_a + a_run_lo, 4);
    const uint4 h0 = bm_word(p, off_a + a_run_hi1, 0);
    const uint4 h1 = bm_word(p, off_a + a_run_hi1, 1);
    const uint4 h3 = bm_word(p, off_a + a_run_hi1, 3);
    const uint4 h4 = bm_word(p, off_a + a_run_hi1, 4);
    char_lo = l1.x;
    char_hi = h1.x;
    lf_lo = l0.w;
    lf_hi = h0.w;
    sa_first_hi = h1.y;
    const uint32_t cum_lo[4] = {l4.x, l4.y, l4.z, l4.w};
    cum_hi[0] = h4.x;
    cum_hi[1] = h4.y;
    cum_hi[2] = h4.z;
    cum_hi[3] = h4.w;
    nxt[0] = l2.x;
    nxt[1] = l2.y;
    nxt[2] = l2.z;
    nxt[3] = l2.w;
    prv[0] = h3.x;
    prv[1] = h3.y;
    prv[2] = h3.z;
    prv[3] = h3.w;
    uint32_t wsum = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t occ_lo =
          cum_lo[c] + (char_lo == uint32_t(c) ? a_lo - l0.x : 0u);
      const uint32_t occ_hi =
          cum_hi[c] + (char_hi == uint32_t(c) ? a_hi - h0.x : 0u);
      width[c] = occ_hi - occ_lo;
      na_lo[c] = p.first[c] + occ_lo;
      wsum += width[c];
    }
    // other side: '$' count (total - char widths) + smaller chars' widths
    uint32_t cum = b_lo + ((a_hi - a_lo) - wsum);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      nb_lo[c] = cum;
      cum += width[c];
    }
    if constexpr (RW >= 12) {
      toe[0] = r[8];
      toe[1] = r[9];
      toe[2] = r[10];
    }
  }

  // column k (0..3) of child c: [f_lo, f_hi, r_lo, r_hi)
  __device__ __forceinline__ uint32_t pos(int c, int k) const {
    uint32_t w = 0, al = 0, bl = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      w = s == c ? width[s] : w;
      al = s == c ? na_lo[s] : al;
      bl = s == c ? nb_lo[s] : bl;
    }
    if (w == 0) return 0u;
    const uint32_t lo = ((k >> 1) == 0) == bwd ? al : bl;
    return lo + ((k & 1) ? w : 0u);
  }

  // the hint walks of child c (which must have width > 0) for a quad
  __device__ __forceinline__ void stage(const BmParams& p, int c,
                                        QuadChild& ch) const {
    uint32_t w = 0, al = 0, bl = 0, nx = 0, pv = 0, chc = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s == c) {
        w = width[s];
        al = na_lo[s];
        bl = nb_lo[s];
        nx = nxt[s];
        pv = prv[s];
        chc = cum_hi[s];
      }
    }
    // quad_child reads the parent's toehold at r[8..10]
    const uint32_t r[11] = {0, 0, 0, 0, 0, 0, 0, 0, toe[0], toe[1], toe[2]};
    quad_child<RW>(p, r, bwd, c, w, al, bl, char_lo == uint32_t(c),
                   char_hi == uint32_t(c), lf_lo, lf_hi, nx, pv, b_run_lo,
                   b_run_hi1, a_hi - a_lo, sa_first_hi, chc, ch);
  }
};

template <int RW>
using Lane = typename std::conditional<RW == 4, FmLane, BmLane<RW>>::type;

}  // namespace columba
