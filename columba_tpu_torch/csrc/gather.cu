// Kernel H: row gather, the microbenchmark of the fused 64 B occ row.
//
// Replaces what tools/pgather_bench.py gather_rows and tools/gather_bench.py
// pallas_gather compute: out[i] = table[idx[i]] for a (T, W) table of 32-bit
// words with W = 4, 8 or 16 (rows of 16, 32 or 64 B). Their DMA ring and
// 8-row group copy are not carried over: they exist because the TPU compiler
// cannot slice 16 lanes of a 128-lane tile, and a thread here loads 16 B
// from any 16 B-aligned address.
//
// One thread copies one row with W/4 loads of 16 B, as kernels A, C and E
// read their rows.
// Indices are int64 and are clamped to the table (as the JAX gather clips).
//
// Bound: bytes. N x (8 + 2 x 4W) B (index in, row in, row out); the reads
// are random, so each row costs whole 32 B sectors whatever its width.
// No library module calls this kernel; columba_tpu_torch/tools/gather_bench.py
// does.
#include "common.cuh"

namespace {

template <int CHUNKS>
__global__ void gather_kernel(const uint4* __restrict__ table, long long rows,
                              const long long* __restrict__ idx,
                              uint4* __restrict__ out, long long n) {
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (tid >= n) return;
  const long long r = min(max(__ldg(idx + tid), 0LL), rows - 1);
  uint4 v[CHUNKS];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) v[c] = __ldg(table + r * CHUNKS + c);
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) out[tid * CHUNKS + c] = v[c];
}

template <int CHUNKS>
int launch(const int* table, long long rows, const long long* idx, int* out,
           long long n, cudaStream_t stream) {
  constexpr int kThreads = 256;
  gather_kernel<CHUNKS>
      <<<columba::grid_for(n, kThreads), kThreads, 0, stream>>>(
          reinterpret_cast<const uint4*>(table), rows, idx,
          reinterpret_cast<uint4*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int columba_gather(const int* table, long long rows, int words,
                              const long long* idx, int* out, long long n,
                              cudaStream_t stream) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (words) {
    case 4: return launch<1>(table, rows, idx, out, n, stream);
    case 8: return launch<2>(table, rows, idx, out, n, stream);
    case 16: return launch<4>(table, rows, idx, out, n, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
