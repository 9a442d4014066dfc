// Kernel H: row gather, the microbenchmark of the fused 64 B occ row.
//
// Replaces what tools/pgather_bench.py gather_rows and tools/gather_bench.py
// pallas_gather compute: out[i] = table[idx[i]] for a (T, W) table of 32-bit
// words with W = 4, 8 or 16 (rows of 16, 32 or 64 B). Their DMA ring and
// 8-row group copy are not carried over: they exist because the TPU compiler
// cannot slice 16 lanes of a 128-lane tile, and a thread here loads 16 B
// from any 16 B-aligned address.
//
// Bound: bytes. N x (8 + 2 x 4W) B (index in, row in, row out); the reads
// are random, so each row costs whole 32 B sectors whatever its width.
//
// Design: W/4 threads a row (a quad for 64 B rows), each with one 16 B load
// and one 16 B store, so that one warp-wide store covers 512 contiguous
// bytes of the output. The grid fills the SMs once and strides over the
// rows. Measured on the H100 against variants with 2, 4 and 8 rows in
// flight a thread: one row at a time at full occupancy was fastest, and
// streaming stores (__stcs) gained nothing. Rows of 32 and 64 B load
// without allocating in L1 (ld.global.nc.L1::no_allocate); 16 B rows, one
// thread each, go through __ldg, which was faster there. Indices are int64 and
// are clamped to the table (as the JAX gather clips).
// No library module calls this kernel; columba_tpu_torch/tools/gather_bench.py
// does.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint4 load_once(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

template <int CHUNKS>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const uint4* __restrict__ table, long long rows,
              const long long* __restrict__ idx, uint4* __restrict__ out,
              long long n) {
  const long long tid =
      blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x;
  const int c = static_cast<int>(tid % CHUNKS);
  const long long pass =
      static_cast<long long>(gridDim.x) * kThreads / CHUNKS;  // rows a pass
  for (long long i = tid / CHUNKS; i < n; i += pass) {
    const long long r = min(max(__ldg(idx + i), 0LL), rows - 1);
    const uint4* src = table + r * CHUNKS + c;
    out[i * CHUNKS + c] = CHUNKS > 1 ? load_once(src) : __ldg(src);
  }
}

// Blocks that fill the card once (cached per device).
template <int CHUNKS>
int resident_blocks() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, gather_kernel<CHUNKS>, kThreads, 0) != cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

template <int CHUNKS>
int launch(const int* table, long long rows, const long long* idx, int* out,
           long long n, cudaStream_t stream) {
  const int resident = resident_blocks<CHUNKS>();
  if (resident <= 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidValue);
  }
  const long long want = (n * CHUNKS + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < resident ? want : resident);
  gather_kernel<CHUNKS><<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const uint4*>(table), rows, idx,
      reinterpret_cast<uint4*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int columba_gather(const int* table, long long rows, int words,
                              const long long* idx, int* out, long long n,
                              cudaStream_t stream) {
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n < 1) return 0;
  switch (words) {
    case 4: return launch<1>(table, rows, idx, out, n, stream);
    case 8: return launch<2>(table, rows, idx, out, n, stream);
    case 16: return launch<4>(table, rows, idx, out, n, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
