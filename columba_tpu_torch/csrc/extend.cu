// Kernel A: bidirectional extension of a frontier of ranges.
//
// Replaces columba_tpu/ops/extend.py extend_all / extend_char (with
// ops/rank.py occ_all) on the Vanilla index, and (entry "rlc", K18)
// columba_tpu/ops/bextend.py extend_all / extend_char on the RLC index:
// the port runs it for the exact-prefix steps of the scheme executor and for
// the k-mer seed table build. One body, templated on the lane width RW (4
// Vanilla, 8 RLC, 12 RLC with toeholds); the extension is Lane<RW> of
// common.cuh.
//
// Bound: memory latency, not bandwidth or arithmetic. Vanilla: two random
// 64 B occ rows per lane (plus a 32 B range read and a 32 or 128 B write);
// one thread per lane reads its two rows with 16 B loads, so each row costs
// one 64 B transaction, and the four children fall out of those rows. RLC:
// two endpoint rows (four 16 B words each), then per child two 4 B LF-run
// reads and four run-hint walks, each a chain of dependent 4 B reads
// (START or END of the next run; after 16 steps a binary search, about
// log2 r reads). extend_char walks the chosen child only. One thread owns a
// lane and walks alone; the card hides the chains' latency across lanes.
#include "common.cuh"

namespace {

template <int RW>
__global__ void extend_kernel(columba::FmParams fm, columba::BmParams bm,
                              const long long* __restrict__ ranges,
                              const int* __restrict__ dirs,
                              const int* __restrict__ chars,
                              long long* __restrict__ out, long long L) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= L) return;
  uint32_t r[RW];
#pragma unroll
  for (int k = 0; k < RW; ++k) r[k] = static_cast<uint32_t>(ranges[RW * i + k]);
  columba::Lane<RW> lane;
  lane.init(fm, bm, r, dirs[i]);
  uint32_t o[RW];
  if (chars == nullptr) {
    for (int c = 0; c < 4; ++c) {
      columba::child_of<RW>(lane, bm, c, o);
#pragma unroll
      for (int k = 0; k < RW; ++k) out[(4 * i + c) * RW + k] = o[k];
    }
    return;
  }
  const int c = chars[i];
  if (c > 3) {                       // N never matches: empty range
#pragma unroll
    for (int k = 0; k < RW; ++k) out[RW * i + k] = 0;
    return;
  }
  columba::child_of<RW>(lane, bm, max(c, 0), o);
#pragma unroll
  for (int k = 0; k < RW; ++k) out[RW * i + k] = o[k];
}

template <int RW>
int launch(const columba::FmParams& fm, const columba::BmParams& bm,
           const long long* ranges, const int* dirs, const int* chars,
           long long* out, long long L, cudaStream_t stream) {
  constexpr int kThreads = RW == 4 ? 256 : 128;
  extend_kernel<RW><<<columba::grid_for(L, kThreads), kThreads, 0, stream>>>(
      fm, bm, ranges, dirs, chars, out, L);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int columba_extend(const int* occ, long long blocks, unsigned c0,
                              unsigned c1, unsigned c2, unsigned c3,
                              unsigned d0, unsigned d1,
                              const long long* ranges, const int* dirs,
                              const int* chars, long long* out, long long L,
                              cudaStream_t stream) {
  const columba::FmParams fm =
      columba::fm_params(occ, blocks, c0, c1, c2, c3, d0, d1);
  return launch<4>(fm, columba::BmParams{}, ranges, dirs, chars, out, L,
                   stream);
}

extern "C" int columba_extend_rlc(const int* fused, unsigned r_fwd,
                                  unsigned r_rev, unsigned f0, unsigned f1,
                                  unsigned f2, unsigned f3, unsigned n,
                                  const long long* ranges, const int* dirs,
                                  const int* chars, long long* out,
                                  long long L, int rw, cudaStream_t stream) {
  const columba::BmParams bm =
      columba::bm_params(fused, r_fwd, r_rev, f0, f1, f2, f3, n);
  const columba::FmParams fm{};
  if (rw == 8) return launch<8>(fm, bm, ranges, dirs, chars, out, L, stream);
  if (rw == 12) return launch<12>(fm, bm, ranges, dirs, chars, out, L, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* columba_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
