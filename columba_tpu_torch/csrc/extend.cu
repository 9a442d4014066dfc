// Kernel A: bidirectional extension of a frontier of range pairs.
//
// Replaces columba_tpu/ops/extend.py extend_all / extend_char (with
// ops/rank.py occ_all): the port runs it for the exact-prefix steps of the
// scheme executor and for the k-mer seed table build.
//
// Bound: two random 64 B occ rows per lane (plus a 32 B range read and a
// 32 or 128 B write), i.e. memory latency, not arithmetic. One thread per
// lane reads its two rows with 16 B loads, so each row costs one 64 B
// transaction, and the four children fall out of those rows with no further
// reads. Making it faster (sorting lanes by row, caching hot top-level rows)
// is left to later work.
#include "common.cuh"

namespace {

__global__ void extend_kernel(columba::FmParams p,
                              const long long* __restrict__ ranges,
                              const int* __restrict__ dirs,
                              const int* __restrict__ chars,
                              long long* __restrict__ out, long long L) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= L) return;
  const long long* r = ranges + 4 * i;
  uint32_t ch[4][4];
  columba::extend_lane(p, static_cast<uint32_t>(r[0]),
                       static_cast<uint32_t>(r[1]),
                       static_cast<uint32_t>(r[2]),
                       static_cast<uint32_t>(r[3]), dirs[i], ch);
  if (chars == nullptr) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < 4; ++k) out[16 * i + 4 * c + k] = ch[c][k];
    return;
  }
  const int c = chars[i];
  long long* o = out + 4 * i;
  if (c > 3) {                       // N never matches: empty range
    o[0] = o[1] = o[2] = o[3] = 0;
    return;
  }
  const int safe = max(c, 0);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (s == safe) {
      o[0] = ch[s][0];
      o[1] = ch[s][1];
      o[2] = ch[s][2];
      o[3] = ch[s][3];
    }
  }
}

}  // namespace

extern "C" int columba_extend(const int* occ, long long blocks, unsigned c0,
                              unsigned c1, unsigned c2, unsigned c3,
                              unsigned d0, unsigned d1,
                              const long long* ranges, const int* dirs,
                              const int* chars, long long* out, long long L,
                              cudaStream_t stream) {
  const columba::FmParams p =
      columba::fm_params(occ, blocks, c0, c1, c2, c3, d0, d1);
  constexpr int kThreads = 256;
  extend_kernel<<<columba::grid_for(L, kThreads), kThreads, 0, stream>>>(
      p, ranges, dirs, chars, out, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* columba_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
