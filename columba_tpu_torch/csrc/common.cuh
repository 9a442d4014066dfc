// Device functions shared by the port's kernels: rank over one fused 64 B
// occ row, and the bidirectional extension of one lane on the Vanilla
// FM-index (FmLane) and on the RLC move table (BmLane, K18).
//
// Counterparts of columba_tpu/ops/rank.py (occ_all, occ_all_and_char),
// columba_tpu/ops/extend.py (extend_all) and columba_tpu/ops/bextend.py
// (extend_all with _run_of_pos, _ff_forward, _ff_backward). All interval
// arithmetic is uint32, exactly as in the JAX package; the host passes int64
// tensors whose values are uint32. Kernels A and B are templated on the
// lane width RW (4: Vanilla; 8: RLC; 12: RLC with toeholds, textless) and
// take their extension from Lane<RW>, so each kernel body is one copy;
// kernels E and F take FmLane on the Vanilla index and the four-lane RLC
// step of bm_quad.cuh.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace columba {

constexpr int INF = 63;  // band infinity (search/schedule.py INF)

struct FmParams {
  const uint32_t* occ;   // (2*blocks, 16): [4 ckpt | 8 BWT words | 4 pad]
  long long blocks;      // blocks per direction; rev rows start here
  uint32_t counts[4];    // first SA row of A, C, G, T
  uint32_t dollar[2];    // '$' row in the forward / reverse BWT
};

// occ of A,C,G,T before in-block offset `off` of fused row `row` ('$'
// counted as A); optionally the 2-bit code at that offset. One row read:
// three 16 B loads (checkpoints + 8 words; the pad is never read).
__device__ __forceinline__ void occ_row(const uint32_t* __restrict__ occ,
                                        long long row, uint32_t off,
                                        uint32_t occ4[4],
                                        uint32_t* code = nullptr) {
  const uint4* r = reinterpret_cast<const uint4*>(occ + row * 16);
  const uint4 ck = __ldg(r);
  const uint4 wa = __ldg(r + 1);
  const uint4 wb = __ldg(r + 2);
  const uint32_t w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
  occ4[0] = ck.x;
  occ4[1] = ck.y;
  occ4[2] = ck.z;
  occ4[3] = ck.w;
  const uint32_t pat[4] = {0x00000000u, 0x55555555u, 0xAAAAAAAAu,
                           0xFFFFFFFFu};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int r2 = static_cast<int>(off) - 16 * i;
    r2 = r2 < 0 ? 0 : (r2 > 16 ? 16 : r2);
    const uint32_t mask = r2 >= 16 ? 0xFFFFFFFFu : ((1u << (2 * r2)) - 1u);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t nx = ~(w[i] ^ pat[c]);
      occ4[c] += __popc(nx & (nx >> 1) & 0x55555555u & mask);
    }
  }
  if (code != nullptr) {
    uint32_t sel = w[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) sel = ((off >> 4) == uint32_t(i)) ? w[i] : sel;
    *code = (sel >> (2 * (off & 15))) & 3u;
  }
}

// Children of range pair [f_lo, f_hi, r_lo, r_hi) for the 4 chars, extending
// backward (dir 0, forward BWT) or forward (dir 1, reverse BWT). Two row
// reads serve all four children; the synchronized side comes from the '$'
// count plus an exclusive cumsum of the occ differences.
__device__ __forceinline__ void extend_lane(const FmParams& p, uint32_t f_lo,
                                            uint32_t f_hi, uint32_t r_lo,
                                            uint32_t r_hi, int dir,
                                            uint32_t out[4][4]) {
  const bool bwd = dir == 0;
  const uint32_t a_lo = bwd ? f_lo : r_lo;
  const uint32_t a_hi = bwd ? f_hi : r_hi;
  const uint32_t b_lo = bwd ? r_lo : f_lo;
  const long long base = bwd ? 0 : p.blocks;
  const uint32_t drow = bwd ? p.dollar[0] : p.dollar[1];
  uint32_t ol[4], oh[4];
  occ_row(p.occ, base + (a_lo >> 7), a_lo & 127u, ol);
  occ_row(p.occ, base + (a_hi >> 7), a_hi & 127u, oh);
  const uint32_t dl = drow < a_lo ? 1u : 0u;
  const uint32_t dh = drow < a_hi ? 1u : 0u;
  ol[0] -= dl;
  oh[0] -= dh;
  uint32_t cum_lo = dl, cum_hi = dh;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t na_lo = p.counts[c] + ol[c];
    const uint32_t na_hi = p.counts[c] + oh[c];
    const uint32_t width = na_hi - na_lo;
    const uint32_t nb_lo = b_lo + (cum_hi - cum_lo);
    out[c][0] = bwd ? na_lo : nb_lo;
    out[c][1] = bwd ? na_hi : nb_lo + width;
    out[c][2] = bwd ? nb_lo : na_lo;
    out[c][3] = bwd ? nb_lo + width : na_hi;
    cum_lo += ol[c];
    cum_hi += oh[c];
  }
}

__host__ __forceinline__ FmParams fm_params(const int* occ, long long blocks,
                                            unsigned c0, unsigned c1,
                                            unsigned c2, unsigned c3,
                                            unsigned d0, unsigned d1) {
  FmParams p;
  p.occ = reinterpret_cast<const uint32_t*>(occ);
  p.blocks = blocks;
  p.counts[0] = c0;
  p.counts[1] = c1;
  p.counts[2] = c2;
  p.counts[3] = c3;
  p.dollar[0] = d0;
  p.dollar[1] = d1;
  return p;
}

// ---------------------------------------------------------------------------
// RLC (b-move) index: one 80 B fused row per BWT run, five 16 B words:
//   w0 START END LF_POS LF_RUN | w1 CHAR SA_FIRST SA_LAST pad |
//   w2 NEXT[4] | w3 PREV[4] | w4 CUM[4]
// (index/bmove.py). The reverse table's rows start at r_fwd + 1; row R of
// each table is a sentinel [big, big) that ends every forward walk.
// ---------------------------------------------------------------------------

constexpr int BM_NCOLS = 20;
constexpr int BM_FF_CAP = 16;   // ops/bextend.py FF_CAP

struct BmParams {
  const uint32_t* fused;   // (r_fwd + r_rev + 2, 20)
  uint32_t r_fwd, r_rev;
  uint32_t first[4];       // first F-column row of A, C, G, T
  uint32_t n;
};

__host__ __forceinline__ BmParams bm_params(const int* fused, unsigned r_fwd,
                                            unsigned r_rev, unsigned f0,
                                            unsigned f1, unsigned f2,
                                            unsigned f3, unsigned n) {
  BmParams p;
  p.fused = reinterpret_cast<const uint32_t*>(fused);
  p.r_fwd = r_fwd;
  p.r_rev = r_rev;
  p.first[0] = f0;
  p.first[1] = f1;
  p.first[2] = f2;
  p.first[3] = f3;
  p.n = n;
  return p;
}

// One 16 B word of a row, or one 4 B column: a walk step or a search probe
// needs START or END only, not the row.
__device__ __forceinline__ uint4 bm_word(const BmParams& p, long long row,
                                         int w) {
  return __ldg(reinterpret_cast<const uint4*>(p.fused + row * BM_NCOLS) + w);
}
__device__ __forceinline__ uint32_t bm_col(const BmParams& p, long long row,
                                           int col) {
  return __ldg(p.fused + row * BM_NCOLS + col);
}

// Largest run j >= lo of the table at row offset `off` with START[j] <= pos
// (bextend._run_of_pos): the JAX loop runs ceil(log2 r) steps for every
// lane; this one stops when the interval is one run, with the same result.
// The walks are out-of-line calls (static: one copy per source file), so
// each of the four per child stays one body in the kernels that inline the
// lane.
static __device__ __noinline__ int bm_run_of_pos(const BmParams& p,
                                                 long long off, uint32_t pos,
                                                 int lo) {
  const int r_limit = static_cast<int>(off == 0 ? p.r_fwd : p.r_rev);
  lo = max(0, min(lo, r_limit - 1));
  int hi = r_limit - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (bm_col(p, off + mid, 0) <= pos) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Advance a run hint while its run ends at or before pos: at most FF_CAP
// steps, then a binary search from where the walk stopped (_ff_forward).
static __device__ __noinline__ int bm_ff_forward(const BmParams& p,
                                                 long long off, int run,
                                                 uint32_t pos) {
  uint32_t e = bm_col(p, off + run, 1);
  for (int it = 0; it < BM_FF_CAP && e <= pos; ++it)
    e = bm_col(p, off + (++run), 1);
  return e <= pos ? bm_run_of_pos(p, off, pos, run) : run;
}

// Retreat a run hint while its run starts after pos: at most FF_CAP steps,
// then a binary search from run 0 (_ff_backward).
static __device__ __noinline__ int bm_ff_backward(const BmParams& p,
                                                  long long off, int run,
                                                  uint32_t pos) {
  uint32_t s = bm_col(p, off + run, 0);
  for (int it = 0; it < BM_FF_CAP && s > pos; ++it)
    s = bm_col(p, off + (--run), 0);
  return s > pos ? bm_run_of_pos(p, off, pos, 0) : run;
}

// Vanilla lane: extend_lane's four children, ready after init.
struct FmLane {
  uint32_t ch[4][4];
  __device__ __forceinline__ void init(const FmParams& fm, const BmParams&,
                                       const uint32_t* r, int dir) {
    extend_lane(fm, r[0], r[1], r[2], r[3], dir, ch);
  }
  __device__ __forceinline__ uint32_t pos(int c, int k) const {
    uint32_t v = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) v = s == c ? ch[s][k] : v;
    return v;
  }
  __device__ __forceinline__ void hints(const BmParams&, int,
                                        uint32_t*) const {}
};

// RLC lane (K18, bextend.extend_all), in two phases so that a caller walks
// the hints of the children it keeps only. init reads the two endpoint rows
// (four of their five words) and gives every child's interval; hints(c)
// reads the LF run of the first and last c-run the parent touches and
// fast-forwards the four run hints of child c (and, RW 12, updates its
// toehold from rows already read). An empty child (width 0) is zero.
template <int RW>
struct BmLane {
  bool bwd;
  long long off_a, off_b;
  uint32_t a_lo, a_hi;
  int a_run_lo, a_run_hi1, b_run_lo, b_run_hi1;
  uint32_t char_lo, char_hi, sa_first_hi;
  uint32_t nxt[4], prv[4], cum_hi[4];
  uint32_t na_lo[4], width[4], nb_lo[4];
  uint32_t tv, toff, tflag;

  __device__ __forceinline__ void init(const FmParams&, const BmParams& p,
                                       const uint32_t* r, int dir) {
    bwd = dir == 0;
    const long long rev_off = static_cast<long long>(p.r_fwd) + 1;
    off_a = bwd ? 0 : rev_off;
    off_b = bwd ? rev_off : 0;
    a_lo = bwd ? r[0] : r[2];
    a_hi = bwd ? r[1] : r[3];
    const uint32_t b_lo = bwd ? r[2] : r[0];
    a_run_lo = static_cast<int>(bwd ? r[4] : r[6]);
    a_run_hi1 = static_cast<int>(bwd ? r[5] : r[7]);
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
    if (RW >= 12) {
      tv = r[8];
      toff = r[9];
      tflag = r[10];
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

  // columns 4.. of child c (which must have width > 0)
  __device__ void hints(const BmParams& p, int c, uint32_t* out) const {
    uint32_t w = 0, al = 0, bl = 0, nx = 0, pv = 0, ch = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s == c) {
        w = width[s];
        al = na_lo[s];
        bl = nb_lo[s];
        nx = nxt[s];
        pv = prv[s];
        ch = cum_hi[s];
      }
    }
    // PREV = -1 (0xFFFFFFFF) clips to run 0, as the JAX int32 cast does
    const int run_p = max(char_lo == uint32_t(c) ? a_run_lo
                                                 : static_cast<int>(nx), 0);
    const int run_q = max(char_hi == uint32_t(c) ? a_run_hi1
                                                 : static_cast<int>(pv), 0);
    const uint4 q0 = bm_word(p, off_a + run_q, 0);
    const int hint_lo0 = static_cast<int>(bm_col(p, off_a + run_p, 3));
    const int a_rlo = bm_ff_forward(p, off_a, max(hint_lo0, 0), al);
    const int a_rhi1 = bm_ff_forward(p, off_a, max(static_cast<int>(q0.w), 0),
                                     al + w - 1u);
    const int b_rlo = bm_ff_forward(p, off_b, max(b_run_lo, 0), bl);
    const int b_rhi1 = bm_ff_backward(p, off_b, max(b_run_hi1, 0),
                                      bl + w - 1u);
    out[4] = static_cast<uint32_t>(bwd ? a_rlo : b_rlo);
    out[5] = static_cast<uint32_t>(bwd ? a_rhi1 : b_rhi1);
    out[6] = static_cast<uint32_t>(bwd ? b_rlo : a_rlo);
    out[7] = static_cast<uint32_t>(bwd ? b_rhi1 : a_rhi1);
    if (RW >= 12) {
      // textless toehold (bextend.py:204-253): the anchor survives when
      // every parent occurrence extends by c (start - 1 on prepend, end + 1
      // on append); otherwise it resets from the queried side's samples:
      // the last c-row of the parent is hi - 1 itself (its run's FIRST
      // sample) or the previous c-run's LAST row
      if (w == a_hi - a_lo) {
        out[8] = bwd ? tv - (tflag == 0u ? 1u : 0u)
                     : tv + (tflag == 1u ? 1u : 0u);
        out[9] = toff;
        out[10] = tflag;
      } else {
        uint32_t sample_q, lf_rs;
        if (char_hi == uint32_t(c)) {
          sample_q = sa_first_hi;
          lf_rs = ch;
        } else {
          const uint4 q1 = bm_word(p, off_a + run_q, 1);
          const uint4 q4 = bm_word(p, off_a + run_q, 4);
          const uint32_t cq = c == 0 ? q4.x : c == 1 ? q4.y
                            : c == 2 ? q4.z : q4.w;
          sample_q = q1.z;
          lf_rs = cq + (q0.y - q0.x - 1u);
        }
        uint32_t fc = p.first[0];
#pragma unroll
        for (int s = 1; s < 4; ++s) fc = s == c ? p.first[s] : fc;
        out[8] = bwd ? sample_q - 1u : p.n - sample_q;
        out[9] = fc + lf_rs - al;
        out[10] = bwd ? 0u : 1u;
      }
      out[11] = 0u;
    }
  }
};

template <int RW>
using Lane = typename std::conditional<RW == 4, FmLane, BmLane<RW>>::type;

// child c of a lane in full (RW columns) into `o`: the interval, then the
// hints where the child is not empty
template <int RW, class L>
__device__ __forceinline__ void child_of(const L& lane, const BmParams& bm,
                                         int c, uint32_t* o) {
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = lane.pos(c, k);
  if (RW > 4) {
#pragma unroll
    for (int k = 4; k < RW; ++k) o[k] = 0u;
    if (o[1] > o[0]) lane.hints(bm, c, o);
  }
}

inline unsigned grid_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace columba
