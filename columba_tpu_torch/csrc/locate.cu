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
//
// RLC entry ("rlc", K19): replaces columba_tpu/ops/blocate.py run_of_rows +
// locate_rows. One thread per row walks LF: each step is the run's LF
// position plus the row's offset in the run, and the run hint
// fast-forwards to the run holding the new row; the walk stops at a run
// head, a run tail or a row that is 0 mod the stride (at most stride
// steps), reads that sample and adds the steps, capped at n.
// Bound: about 48 dependent random reads a row on uniform rows, each a
// sector of DRAM unless the L2 holds it: the count of sectors and the L2's
// share of them set the time. So the walk reads the index's compact walk
// table (index/bmove.py locate_tables: START END LF_POS LF_RUN, 16 B a
// run, a fifth of the fused rows' bytes, so the L2 holds a larger share of
// it), one 16 B word a run: a step's word is the one its fast-forward
// landed on, and the fast-forward's next word is the neighbouring 16 B.
// A row's run comes from the bucket table (the run holding every
// 2^shift-th row, about two runs a bucket) and a short forward walk: one
// read of a table that stays in the L2 and one or two neighbouring words,
// in place of a binary search over every run (about log2 r dependent
// reads). The
// fused rows are read once a row, for the run-boundary sample.
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

__global__ void locate_rlc_kernel(columba::BmParams p,
                                  const uint4* __restrict__ walk,
                                  const int* __restrict__ run_at, int shift,
                                  const uint32_t* __restrict__ sa_stride,
                                  int sshift,
                                  const long long* __restrict__ rows,
                                  long long* __restrict__ out, long long N) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= N) return;
  uint32_t pos = static_cast<uint32_t>(rows[i]);
  int run = __ldg(run_at + (pos >> shift));
  uint4 w = __ldg(walk + run);                      // START END LF_POS LF_RUN
  while (w.y <= pos) w = __ldg(walk + (++run));
  const uint32_t smask = (1u << sshift) - 1u;
  uint32_t steps = 0, val;
  while (true) {
    const bool head = pos == w.x;
    if (head || pos == w.y - 1u) {
      val = columba::bm_col(p, run, head ? 5 : 6);  // SA_FIRST / SA_LAST
      break;
    }
    if ((pos & smask) == 0u) {
      val = __ldg(sa_stride + (pos >> sshift));
      break;
    }
    pos = w.z + (pos - w.x);
    run = static_cast<int>(w.w);
    w = __ldg(walk + run);
    while (w.y <= pos) w = __ldg(walk + (++run));
    ++steps;
  }
  val += steps;
  out[i] = val < p.n ? val : p.n;
}

}  // namespace

extern "C" int columba_locate_rlc(const int* fused, unsigned r_fwd,
                                  unsigned r_rev, unsigned f0, unsigned f1,
                                  unsigned f2, unsigned f3, unsigned n,
                                  const int* walk, const int* run_at,
                                  int shift, const int* sa_stride, int stride,
                                  const long long* rows, long long* out,
                                  long long N, cudaStream_t stream) {
  const columba::BmParams p =
      columba::bm_params(fused, r_fwd, r_rev, f0, f1, f2, f3, n);
  int sshift = 0;
  while ((1 << sshift) < stride) ++sshift;
  if ((1 << sshift) != stride || shift < 0 || shift > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 128;
  locate_rlc_kernel<<<columba::grid_for(N, kThreads), kThreads, 0, stream>>>(
      p, reinterpret_cast<const uint4*>(walk), run_at, shift,
      reinterpret_cast<const uint32_t*>(sa_stride), sshift, rows, out, N);
  return static_cast<int>(cudaGetLastError());
}

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
