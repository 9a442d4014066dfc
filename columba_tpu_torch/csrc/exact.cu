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
// Bound: latency, not bandwidth. A row does up to m dependent steps, each
// two random 48 B row reads (three 16 B loads per fused occ row) whose
// addresses come from the step before, so nothing of one row overlaps; the
// card hides the latency only across rows. Bytes moved: rows x steps walked
// x 2 x 48 B in (plus the m chars of the row), rows x 32 B out. One thread
// per row and small blocks keep all rows of a batch in flight at once.
#include "common.cuh"

namespace {

__global__ void exact_kernel(columba::FmParams p,
                             const uint8_t* __restrict__ patterns,
                             const int* __restrict__ lengths, int m,
                             uint32_t n, long long* __restrict__ out,
                             long long rows) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= rows) return;
  const uint8_t* pat = patterns + i * m;
  uint32_t r[4] = {0u, n + 1u, 0u, n + 1u};
  const int len = lengths == nullptr ? m : min(__ldg(lengths + i), m);
  for (int j = len - 1; j >= 0; --j) {
    const int c = __ldg(pat + j);
    if (c > 3) {                      // N never matches
      r[0] = r[1] = r[2] = r[3] = 0u;
      break;
    }
    uint32_t ch[4][4];
    columba::extend_lane(p, r[0], r[1], r[2], r[3], 0, ch);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s == c) {
#pragma unroll
        for (int k = 0; k < 4; ++k) r[k] = ch[s][k];
      }
    }
    if (r[1] <= r[0]) {               // empty: later steps cannot revive it
      r[0] = r[1] = r[2] = r[3] = 0u;
      break;
    }
  }
  long long* o = out + 4 * i;
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = r[k];
}

}  // namespace

extern "C" int columba_exact(const int* occ, long long blocks, unsigned c0,
                             unsigned c1, unsigned c2, unsigned c3,
                             unsigned d0, unsigned d1,
                             const unsigned char* patterns,
                             const int* lengths, int m, long long n,
                             long long* out, long long rows,
                             cudaStream_t stream) {
  const columba::FmParams p =
      columba::fm_params(occ, blocks, c0, c1, c2, c3, d0, d1);
  constexpr int kThreads = 64;
  exact_kernel<<<columba::grid_for(rows, kThreads), kThreads, 0, stream>>>(
      p, patterns, lengths, m, static_cast<uint32_t>(n), out, rows);
  return static_cast<int>(cudaGetLastError());
}
