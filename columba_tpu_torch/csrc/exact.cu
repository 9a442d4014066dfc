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
// batch. Here one thread (RLC: four lanes) owns one row and walks it
// through all its steps inside one launch: it reads its chars straight
// from the uint8 batch (the int32 widening of the JAX path folds into the
// load) and stops at its first empty range, or at a code > 3, which never
// matches. A row that ends empty is written as the zero range; a live row
// holds exactly what m calls of extend_char give.
//
// With per-row lengths (the part patterns of part_exact_ranges, padded to the
// longest part) a row reads pattern[length-1], ..., pattern[0] and stops
// after length steps; a null pointer means every row has m chars. A row of
// length 0 keeps the full range.
//
// RLC entry ("rlc", K18 inside K14; with per-row lengths "rlc_lengths",
// K17 on RLC: the part ranges of scheme selection,
// columba_tpu/search/pipeline.py part_exact_ranges, 8 wide): a quad of
// four lanes owns a row (bm_quad.cuh), from the RLC full range; a step
// extends by the chosen character only and walks that child's four run
// hints at once on the compact run tables (index/bmove.py run_tables). An
// empty child is zero there, so the row stops at the same step. The
// row's next char is read while a step runs.
//
// Bound: latency, not bandwidth. A row does up to m dependent steps whose
// addresses come from the step before, so nothing of one row overlaps; the
// card hides the latency only across rows. Vanilla: two random 48 B row
// reads a step (three 16 B loads per fused occ row), one round. RLC: about
// three rounds a step (rows, an LF run, the longest of four walks) where a
// thread that walks the four hints one after another takes about eight.
// Bytes moved: rows x steps walked x the rows read (plus the m chars of the
// row), rows x RW x 8 B out. Small blocks keep all rows of a batch in
// flight at once.
#include "bm_quad.cuh"

namespace {

constexpr int kThreads = 64;       // Vanilla: a thread a row
constexpr int kQuadThreads = 128;  // RLC: 32 rows a block, four lanes a row

__global__ void exact_kernel(columba::FmParams fm,
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
#pragma unroll
      for (int k = 0; k < 4; ++k) r[k] = 0u;
      break;
    }
    columba::FmLane lane;
    lane.init(fm, columba::BmParams{}, r, 0);
    columba::fm_child(lane, c, r);
    if (r[1] <= r[0]) {               // empty: later steps cannot revive it
#pragma unroll
      for (int k = 0; k < 4; ++k) r[k] = 0u;
      break;
    }
  }
  long long* o = out + 4 * i;
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = r[k];
}

__global__ void __launch_bounds__(kQuadThreads)
exact_rlc_kernel(columba::BmParams bm, columba::BmTables t,
                 const uint8_t* __restrict__ patterns,
                 const int* __restrict__ lengths, int m,
                 long long* __restrict__ out, long long rows) {
  const long long i = (blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x) >> 2;
  if (i >= rows) return;               // a quad leaves together
  const int q = threadIdx.x & 3;
  const unsigned qmask = 0xFu << (threadIdx.x & 28);
  const uint8_t* pat = patterns + i * m;
  uint32_t r[8] = {0u, bm.n + 1u, 0u, bm.n + 1u,
                   0u, bm.r_fwd - 1u, 0u, bm.r_rev - 1u};
  const int len = lengths == nullptr ? m : min(__ldg(lengths + i), m);
  int c = len > 0 ? __ldg(pat + len - 1) : 0;
  for (int j = len - 1; j >= 0; --j) {
    const int next = j > 0 ? __ldg(pat + j - 1) : 0;
    if (c > 3) {                       // N never matches
#pragma unroll
      for (int k = 0; k < 8; ++k) r[k] = 0u;
      break;
    }
    uint32_t o[8];
    columba::quad_extend(bm, t, r, c, 0, q, qmask, o);
#pragma unroll
    for (int k = 0; k < 8; ++k) r[k] = o[k];
    if (r[1] <= r[0]) break;           // empty is zero: it stays so
    c = next;
  }
  // lane q writes columns q and q + 4: the quad's 64 B in one store
  uint32_t lo = r[0], hi = r[4];
#pragma unroll
  for (int k = 1; k < 4; ++k) {
    lo = k == q ? r[k] : lo;
    hi = k == q ? r[k + 4] : hi;
  }
  out[8 * i + q] = lo;
  out[8 * i + q + 4] = hi;
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
  exact_kernel<<<columba::grid_for(rows, kThreads), kThreads, 0, stream>>>(
      fm, patterns, lengths, m, static_cast<uint32_t>(n), out, rows);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int columba_exact_rlc(const int* fused, unsigned r_fwd,
                                 unsigned r_rev, unsigned f0, unsigned f1,
                                 unsigned f2, unsigned f3, unsigned n,
                                 const unsigned* starts, unsigned starts_rev,
                                 const int* run_at, const int* run_at_rev,
                                 int shift, const unsigned char* patterns,
                                 const int* lengths, int m, long long* out,
                                 long long rows, cudaStream_t stream) {
  const columba::BmParams bm =
      columba::bm_params(fused, r_fwd, r_rev, f0, f1, f2, f3, n);
  const columba::BmTables t =
      columba::bm_tables(starts, starts_rev, run_at, run_at_rev, shift);
  exact_rlc_kernel<<<columba::grid_for(4 * rows, kQuadThreads), kQuadThreads,
                     0, stream>>>(bm, t, patterns, lengths, m, out, rows);
  return static_cast<int>(cudaGetLastError());
}
