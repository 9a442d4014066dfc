// Device functions shared by the port's kernels: rank over one fused 64 B
// occ row, and the bidirectional extension of one lane.
//
// Counterparts of columba_tpu/ops/rank.py (occ_all, occ_all_and_char) and
// columba_tpu/ops/extend.py (extend_all). All interval arithmetic is uint32,
// exactly as in the JAX package; the host passes int64 tensors whose values
// are uint32.
#pragma once

#include <cstdint>
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

inline unsigned grid_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace columba
