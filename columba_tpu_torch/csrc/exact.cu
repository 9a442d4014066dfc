// Kernel E: exact backward match of a read batch (the k = 0 pass).
//
// Replaces columba_tpu/ops/extend.py exact_match as it runs inside
// columba_tpu/search/pipeline.py _exact_device: every row of the (rows, m)
// uint8 batch (forward and reverse-complement strands are separate rows)
// starts from the full range and is extended backward by pattern[m-1],
// pattern[m-2], ... with the arithmetic of extend_char (extend_lane of
// common.cuh, direction 0), synchronized side included.
//
// The JAX function is one lockstep loop of m masked steps over the whole
// batch. Here one thread owns one row and walks it through all its steps
// inside one launch: it reads its chars straight from the uint8 batch (the
// int32 widening of the JAX path folds into the load) and stops at its first
// empty range, or at a code > 3, which never matches. A row that ends empty
// is written as the zero range; a live row holds exactly what m calls of
// extend_char give.
//
// With per-row lengths (the part patterns of part_exact_ranges, padded to the
// longest part) a row reads pattern[length-1], ..., pattern[0] and stops
// after length steps; a null pointer means every row has m chars. A row of
// length 0 keeps the full range.
//
// RLC entry ("rlc", K18 inside K14): the same body on 8-wide RLC lanes
// (Lane<8> of common.cuh) from the RLC full range; a step computes only the
// chosen character's child (the other side needs all four widths, and they
// come from the two endpoint rows anyway) and walks that child's run hints.
// An empty child is zero there, so the row stops at the same step. With
// per-row lengths the wrapper names the launch "rlc_lengths" (K17 on RLC:
// the part ranges of scheme selection, columba_tpu/search/pipeline.py
// part_exact_ranges, 8 wide).
//
// Bound: latency, not bandwidth. A row does up to m dependent steps, each
// two random 48 B row reads (three 16 B loads per fused occ row) whose
// addresses come from the step before, so nothing of one row overlaps; the
// card hides the latency only across rows. Bytes moved: rows x steps walked
// x 2 x 48 B in (plus the m chars of the row), rows x 32 B out. One thread
// per row and small blocks keep all rows of a batch in flight at once.
#include "common.cuh"

namespace {

template <int RW>
__global__ void exact_kernel(columba::FmParams fm, columba::BmParams bm,
                             const uint8_t* __restrict__ patterns,
                             const int* __restrict__ lengths, int m,
                             uint32_t n, long long* __restrict__ out,
                             long long rows) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= rows) return;
  const uint8_t* pat = patterns + i * m;
  uint32_t r[RW];
  r[0] = r[2] = 0u;
  r[1] = r[3] = n + 1u;
  if (RW > 4) {
    r[4] = r[6] = 0u;
    r[5] = bm.r_fwd - 1u;
    r[7] = bm.r_rev - 1u;
  }
  const int len = lengths == nullptr ? m : min(__ldg(lengths + i), m);
  for (int j = len - 1; j >= 0; --j) {
    const int c = __ldg(pat + j);
    if (c > 3) {                      // N never matches
#pragma unroll
      for (int k = 0; k < RW; ++k) r[k] = 0u;
      break;
    }
    columba::Lane<RW> lane;
    lane.init(fm, bm, r, 0);
    columba::child_of<RW>(lane, bm, c, r);
    if (r[1] <= r[0]) {               // empty: later steps cannot revive it
#pragma unroll
      for (int k = 0; k < RW; ++k) r[k] = 0u;
      break;
    }
  }
  long long* o = out + RW * i;
#pragma unroll
  for (int k = 0; k < RW; ++k) o[k] = r[k];
}

template <int RW>
int launch(const columba::FmParams& fm, const columba::BmParams& bm,
           const unsigned char* patterns, const int* lengths, int m,
           uint32_t n, long long* out, long long rows, cudaStream_t stream) {
  constexpr int kThreads = 64;
  exact_kernel<RW><<<columba::grid_for(rows, kThreads), kThreads, 0,
                     stream>>>(fm, bm, patterns, lengths, m, n, out, rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int columba_exact(const int* occ, long long blocks, unsigned c0,
                             unsigned c1, unsigned c2, unsigned c3,
                             unsigned d0, unsigned d1,
                             const unsigned char* patterns,
                             const int* lengths, int m, long long n,
                             long long* out, long long rows,
                             cudaStream_t stream) {
  const columba::FmParams fm =
      columba::fm_params(occ, blocks, c0, c1, c2, c3, d0, d1);
  return launch<4>(fm, columba::BmParams{}, patterns, lengths, m,
                   static_cast<uint32_t>(n), out, rows, stream);
}

extern "C" int columba_exact_rlc(const int* fused, unsigned r_fwd,
                                 unsigned r_rev, unsigned f0, unsigned f1,
                                 unsigned f2, unsigned f3, unsigned n,
                                 const unsigned char* patterns,
                                 const int* lengths, int m, long long* out,
                                 long long rows, cudaStream_t stream) {
  const columba::BmParams bm =
      columba::bm_params(fused, r_fwd, r_rev, f0, f1, f2, f3, n);
  return launch<8>(columba::FmParams{}, bm, patterns, lengths, m, n, out,
                   rows, stream);
}
