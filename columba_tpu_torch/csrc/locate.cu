// Kernel C: sparse-suffix-array locate by LF-walk.
//
// Replaces columba_tpu/ops/locate.py locate_rows (sparse path) with lf_step
// and ops/rank.py occ_all_and_char / get_bit / rank_bits. Each thread walks
// one SA row: while the row is not sampled (marker bit clear) it takes one
// LF step, at most f-1 of them; then it ranks the marker bits to find the
// sample and adds the step count.
//
// Bound: a chain of dependent random reads (marker word, then a 64 B occ
// row per LF step, then rank words and the sample): latency, not bandwidth.
// One thread per row keeps many independent chains in flight, and the walk
// stops at the first sampled row instead of running all f-1 masked steps
// as the lockstep JAX loop does.
#include "common.cuh"

namespace {

__global__ void locate_kernel(const uint32_t* __restrict__ occ, uint4 counts,
                              uint32_t dollar, const uint32_t* __restrict__ bits,
                              const uint32_t* __restrict__ bits_rank,
                              const uint32_t* __restrict__ samples, int f,
                              const long long* __restrict__ rows,
                              long long* __restrict__ out, long long N) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= N) return;
  uint32_t cur = static_cast<uint32_t>(rows[i]);
  uint32_t steps = 0;
  for (int s = 0; s < f - 1; ++s) {
    if ((__ldg(bits + (cur >> 5)) >> (cur & 31u)) & 1u) break;  // sampled
    uint32_t occ4[4], c;
    columba::occ_row(occ, cur >> 7, cur & 127u, occ4, &c);
    occ4[0] -= dollar < cur ? 1u : 0u;
    const uint32_t cnt = c == 0 ? counts.x : c == 1 ? counts.y
                       : c == 2 ? counts.z : counts.w;
    const uint32_t oc = c == 0 ? occ4[0] : c == 1 ? occ4[1]
                      : c == 2 ? occ4[2] : occ4[3];
    cur = cur == dollar ? 0u : cnt + oc;
    ++steps;
  }
  const uint32_t blk = cur >> 7, off = cur & 127u;
  uint32_t rk = __ldg(bits_rank + blk);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int r = static_cast<int>(off) - 32 * j;
    r = r < 0 ? 0 : (r > 32 ? 32 : r);
    const uint32_t mask = r >= 32 ? 0xFFFFFFFFu : ((1u << r) - 1u);
    rk += __popc(__ldg(bits + 4 * static_cast<long long>(blk) + j) & mask);
  }
  out[i] = static_cast<uint32_t>(__ldg(samples + rk) + steps);
}

}  // namespace

extern "C" int columba_locate(const int* occ, unsigned c0, unsigned c1,
                              unsigned c2, unsigned c3, unsigned dollar,
                              const int* bits, const int* bits_rank,
                              const int* samples, int f, const long long* rows,
                              long long* out, long long N,
                              cudaStream_t stream) {
  constexpr int kThreads = 256;
  locate_kernel<<<columba::grid_for(N, kThreads), kThreads, 0, stream>>>(
      reinterpret_cast<const uint32_t*>(occ), make_uint4(c0, c1, c2, c3),
      dollar, reinterpret_cast<const uint32_t*>(bits),
      reinterpret_cast<const uint32_t*>(bits_rank),
      reinterpret_cast<const uint32_t*>(samples), f, rows, out, N);
  return static_cast<int>(cudaGetLastError());
}
