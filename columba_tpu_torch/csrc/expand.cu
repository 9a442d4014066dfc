// Kernel K: candidates and their expansion into SA rows.
//
// Replaces columba_tpu/search/pipeline.py stage_candidates (:132-166) and
// stage_expand (:169-191) (K9), and the k = 0 pass's expansion of kernel
// E's ranges (:734-740). Entries:
//
//   frontier    one thread a candidate: the C frontier lanes (done lanes'
//               range, else empty) and the M in-text rows (the first
//               itv_count, the rest empty), each with its read row and its
//               estb (the read start's offset from the back-side text
//               depth: per search from the static tables, or per lane
//               under dynamic partitioning).
//   scan        the candidates' widths, clamped at max_locate + 1, and
//               their inclusive prefix sums and total, in one scan across
//               the grid (common.cuh scan_tiles: the sum is 64-bit, its
//               halves travel in the two look-back words).
//   ranges      the same scan on kernel E's (R, rw) ranges, read in place
//               through the row stride (the k = 0 pass).
//   rows        one thread an output row j < max_locate: the candidate
//               whose prefix holds j by a binary search over the prefix
//               sums (searchsorted, clipped to the last candidate, as the
//               plain version), its row lo + (j - base), valid where
//               j < min(total, max_locate); the rest zero.
//
// Bound: bytes. frontier reads a frontier row and an in-text row a
// candidate and writes 32 B; scan reads 16 B and writes 8 B; rows reads
// its candidate's prefix sums and lo and writes 17 B. The binary search's
// log2(C + M) dependent reads stay in L2 (the prefix sums are 8 B a
// candidate).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct CandArgs {
  const bool* done;             // (C,)
  const long long* ranges;      // (C, rw)
  int rw;
  const long long* rid;         // (C,)
  const long long* sid;         // (C,)
  long long C;
  const long long* itv;         // (M, 4)
  const long long* itv_count;   // ()
  long long M;
  int S;
  const long long* t_back64;    // (S,) static tables, or
  const long long* pivot64;
  const int* t_back32;          // (R*S,) per lane
  const int* pivot32;
  long long* c_lo;              // (C + M,) each
  long long* c_hi;
  long long* c_rid;
  long long* c_estb;
};

__global__ void __launch_bounds__(kThreads) frontier_kernel(CandArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= a.C + a.M) return;
  long long lo, hi, rid, estb;
  const bool dyn = a.t_back64 == nullptr;
  if (i < a.C) {
    const bool d = a.done[i];
    lo = d ? a.ranges[i * a.rw] : 0;
    hi = d ? a.ranges[i * a.rw + 1] : 0;
    rid = a.rid[i];
    const long long s = a.sid[i];
    if (dyn) {
      const long long lane = rid * a.S + s;
      estb = static_cast<long long>(a.t_back32[lane] - a.pivot32[lane]);
    } else {
      estb = a.t_back64[s] - a.pivot64[s];
    }
  } else {
    const long long j = i - a.C;
    const bool v = j < *a.itv_count;
    const long long* row = a.itv + 4 * j;
    lo = v ? row[0] : 0;
    hi = v ? row[1] : 0;
    const long long ids = row[2];
    rid = ids / a.S;
    estb = row[3] - (dyn ? static_cast<long long>(a.pivot32[ids])
                         : a.pivot64[ids % a.S]);
  }
  a.c_lo[i] = lo;
  a.c_hi[i] = hi;
  a.c_rid[i] = rid;
  a.c_estb[i] = estb;
}

struct WidthArgs {
  const long long* lo;          // (n,) at `stride`
  const long long* hi;
  long long stride, n, ml;
  long long* offsets;           // (n,) inclusive prefix sums
  long long* total;             // ()
  columba::ScanArgs sa;
};

__global__ void __launch_bounds__(kThreads) scan_kernel(WidthArgs a) {
  const long long tile = columba::take_tile(a.sa);
  const long long i = tile * kThreads + threadIdx.x;
  long long w = 0;
  if (i < a.n) {
    w = a.hi[i * a.stride] - a.lo[i * a.stride];
    w = w < 0 ? 0 : (w > a.ml + 1 ? a.ml + 1 : w);
  }
  unsigned long long end;
  const unsigned long long ex = columba::scan_tiles<kThreads>(
      static_cast<unsigned long long>(w), tile, a.sa, end);
  if (i < a.n) a.offsets[i] = static_cast<long long>(ex) + w;
  if (tile == gridDim.x - 1 && threadIdx.x == 0)
    *a.total = static_cast<long long>(end);
}

struct RowsArgs {
  const long long* lo;          // (n,) at `stride`
  long long stride, n, ml;
  const long long* offsets;
  const long long* total;
  long long* rows;              // (ml,)
  long long* cand;
  bool* valid;
};

__global__ void __launch_bounds__(kThreads) rows_kernel(RowsArgs a) {
  const long long j = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (j >= a.ml) return;
  // the first candidate whose inclusive prefix exceeds j
  long long lo = 0, hi = a.n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (a.offsets[mid] <= j) lo = mid + 1;
    else hi = mid;
  }
  const long long c = lo < a.n ? lo : a.n - 1;
  const long long base = c > 0 ? a.offsets[c - 1] : 0;
  const long long total = *a.total;
  const bool v = j < (total < a.ml ? total : a.ml);
  a.cand[j] = c;
  a.valid[j] = v;
  a.rows[j] = v ? a.lo[c * a.stride] + (j - base) : 0;
}

inline unsigned grid(long long n) {
  return static_cast<unsigned>(n < 1 ? 1 : (n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int columba_expand_frontier(
    const bool* done, const long long* ranges, int rw, const long long* rid,
    const long long* sid, long long C, const long long* itv,
    const long long* itv_count, long long M, int S, const long long* t_back64,
    const long long* pivot64, const int* t_back32, const int* pivot32,
    long long* c_lo, long long* c_hi, long long* c_rid, long long* c_estb,
    cudaStream_t stream) {
  if (rw < 2 || S < 1 || C < 0 || M < 0 ||
      (t_back64 == nullptr) == (t_back32 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (C + M < 1) return 0;
  CandArgs a{done, ranges, rw, rid, sid, C, itv, itv_count, M, S,
             t_back64, pivot64, t_back32, pivot32, c_lo, c_hi, c_rid,
             c_estb};
  frontier_kernel<<<grid(C + M), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int columba_expand_scan(const long long* lo, const long long* hi,
                                   long long stride, long long n,
                                   long long ml, long long* offsets,
                                   long long* total, long long* ticket,
                                   long long* status, long long tiles,
                                   unsigned epoch, cudaStream_t stream) {
  if (n < 1 || stride < 1 || ml < 0 || grid(n) > tiles || epoch == 0 ||
      epoch > 0x3FFFFFFFu)
    return static_cast<int>(cudaErrorInvalidValue);
  WidthArgs a{lo, hi, stride, n, ml, offsets, total,
             columba::ScanArgs{reinterpret_cast<unsigned long long*>(ticket),
                               reinterpret_cast<unsigned long long*>(status),
                               epoch}};
  scan_kernel<<<grid(n), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int columba_expand_rows(const long long* lo, long long stride,
                                   long long n, long long ml,
                                   const long long* offsets,
                                   const long long* total, long long* rows,
                                   long long* cand, bool* valid,
                                   cudaStream_t stream) {
  if (n < 1 || stride < 1 || ml < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (ml < 1) return 0;
  RowsArgs a{lo, stride, n, ml, offsets, total, rows, cand, valid};
  rows_kernel<<<grid(ml), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
