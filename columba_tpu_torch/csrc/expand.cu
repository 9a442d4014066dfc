// Kernel K: candidates and their expansion into SA rows.
//
// Replaces columba_tpu/search/pipeline.py stage_candidates (:132-166) and
// stage_expand (:169-191) (K9), and the k = 0 pass's expansion of kernel
// E's ranges (:734-740). Entries:
//
//   frontier    the candidate list and its prefix sums in one launch: the
//               C frontier lanes (done lanes' range, else empty) and the M
//               in-text rows (the first itv_count, the rest empty), each
//               with its read row and its estb (the read start's offset
//               from the back-side text depth: per search from the static
//               tables, or per lane under dynamic partitioning); then the
//               candidates' widths, clamped at max_locate + 1, scanned
//               into their inclusive prefix sums and total. The widths
//               never go through memory.
//   ranges      the same scan on two strided columns, read in place
//               (kernel E's (R, rw) ranges on the k = 0 pass).
//   rows        output rows j < max_locate: the candidate whose prefix
//               holds j (searchsorted, clipped to the last candidate, as
//               the plain version), its row lo + (j - base), valid where
//               j < min(total, max_locate); the rest zero.
//
// The scans take tiles of 1,024 candidates, blocks of 512 threads of 2
// (common.cuh scan_items: a warp holds 64 consecutive candidates in 2
// rounds of 32; the shape of kernel I's scans, timed there), so that C + M
// = 143,360 candidates make 140 tiles and the look-back waits on at most
// five rounds of 32 tiles (the one-lane tiles of 256: 560). Sums are
// 64-bit (a total can pass 2^32); their halves travel in the look-back's
// two words.
//
// rows merges the rows 0..max_locate-1 with the candidates' prefix sums
// (merge path): a block of 1,024 threads takes 2,048 consecutive items of
// the merged order,
// rows and candidates together, so that its share is bounded however the
// rows fall (most candidates are empty: a run of them holds no row, and a
// block then takes more of them and fewer rows; the rows past the total
// follow every candidate). Its first warp finds where its share starts
// and its second where it ends, each by a 32-way search over the prefix
// sums in global memory (four or five dependent reads, none waiting on
// the total); the block stages the prefix sums and lo of its candidates
// in shared memory, and each row binary-searches there. Timed on the card
// at 256, 512 and 1,024 threads a block (0.0058, 0.0048 and 0.0042 ms at
// the SE ALL sizes): a thread then searches about one row, not four.
//
// Bound: bytes. frontier reads a frontier row and an in-text row a
// candidate and writes 40 B (four columns and the prefix sum); ranges
// reads 16 B and writes 8 B; rows reads each candidate's prefix sum and
// lo once (a block's staging) and writes 17 B a row.
#include "common.cuh"

namespace {

constexpr int kWide = 512;                   // frontier and ranges: blocks
constexpr int kItems = 2;                    // of 512 threads, 2 candidates
constexpr int kTile = kWide * kItems;        // a thread (executor.WIDE_TILE)
constexpr int kRows = 1024;                  // rows: threads a block and
constexpr int kShare = 2048;                 // merged items a block

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
  long long ml;
  long long* c_lo;              // (C + M,) each
  long long* c_hi;
  long long* c_rid;
  long long* c_estb;
  long long* offsets;           // (C + M,) inclusive prefix sums
  long long* total;             // ()
  columba::ScanArgs sa;
};

__device__ __forceinline__ long long clamp_width(long long lo, long long hi,
                                                 long long ml) {
  const long long w = hi - lo;
  return w < 0 ? 0 : (w > ml + 1 ? ml + 1 : w);
}

__global__ void __launch_bounds__(kWide) frontier_kernel(CandArgs a) {
  const long long tile = columba::take_tile(a.sa);
  const long long n = a.C + a.M;
  const long long count = *a.itv_count;
  const bool dyn = a.t_back64 == nullptr;
  unsigned long long w[kItems], ex[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = columba::item_lane<kWide, kItems>(tile, j);
    w[j] = 0;
    if (i >= n) continue;
    long long lo, hi, rid, estb;
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
      const long long k = i - a.C;
      const bool v = k < count;
      const long long* row = a.itv + 4 * k;
      lo = v ? row[0] : 0;
      hi = v ? row[1] : 0;
      // a lane id (< 2^21, the ghost encoding): 32-bit division, inline
      const unsigned ids = static_cast<unsigned>(row[2]);
      rid = ids / static_cast<unsigned>(a.S);
      estb = row[3] - (dyn ? static_cast<long long>(a.pivot32[ids])
                           : a.pivot64[ids % static_cast<unsigned>(a.S)]);
    }
    a.c_lo[i] = lo;
    a.c_hi[i] = hi;
    a.c_rid[i] = rid;
    a.c_estb[i] = estb;
    w[j] = static_cast<unsigned long long>(clamp_width(lo, hi, a.ml));
  }
  unsigned long long end;
  columba::scan_items<kWide, kItems>(w, ex, tile, a.sa, end);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = columba::item_lane<kWide, kItems>(tile, j);
    if (i < n) a.offsets[i] = static_cast<long long>(ex[j] + w[j]);
  }
  if (tile == gridDim.x - 1 && threadIdx.x == 0)
    *a.total = static_cast<long long>(end);
}

struct WidthArgs {
  const long long* lo;          // (n,) at `stride`
  const long long* hi;
  long long stride, n, ml;
  long long* offsets;           // (n,) inclusive prefix sums
  long long* total;             // ()
  columba::ScanArgs sa;
};

__global__ void __launch_bounds__(kWide) scan_kernel(WidthArgs a) {
  const long long tile = columba::take_tile(a.sa);
  unsigned long long w[kItems], ex[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = columba::item_lane<kWide, kItems>(tile, j);
    w[j] = i < a.n ? static_cast<unsigned long long>(clamp_width(
                         a.lo[i * a.stride], a.hi[i * a.stride], a.ml))
                   : 0ull;
  }
  unsigned long long end;
  columba::scan_items<kWide, kItems>(w, ex, tile, a.sa, end);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = columba::item_lane<kWide, kItems>(tile, j);
    if (i < a.n) a.offsets[i] = static_cast<long long>(ex[j] + w[j]);
  }
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

// The merge path's split at diagonal d of the rows 0..ml-1 and the
// candidates' prefix sums off[0..n-1] (candidate c goes before row j where
// off[c] <= j): the number of candidates before it, the first c in
// [max(0, d - ml), min(d, n)) with off[c] >= d - c, else the range's end.
// A warp's 32 lanes probe 32 evenly spaced points of the range a round
// and keep the stretch between the last false and the first true probe.
// Every lane of the warp calls it and gets the result.
__device__ __forceinline__ long long merge_split(const long long* off,
                                                 long long n, long long ml,
                                                 long long d) {
  const int lane = threadIdx.x & 31;
  long long lo = d > ml ? d - ml : 0, hi = d < n ? d : n;
  while (hi - lo > 32) {
    const long long step = (hi - lo + 31) >> 5;
    const long long p = min(lo + (lane + 1) * step - 1, hi - 1);
    const unsigned m = __ballot_sync(0xFFFFFFFFu, off[p] >= d - p);
    const int f = m ? __ffs(m) - 1 : 32;
    const long long before = __shfl_sync(0xFFFFFFFFu, p, f > 0 ? f - 1 : 0);
    const long long at = __shfl_sync(0xFFFFFFFFu, p, f < 32 ? f : 31);
    if (f > 0) lo = before + 1;
    if (f < 32) hi = at;
  }
  const long long x = lo + lane;
  const unsigned m = __ballot_sync(0xFFFFFFFFu, x < hi && off[x] >= d - x);
  return m ? lo + __ffs(m) - 1 : hi;
}

__global__ void __launch_bounds__(kRows) rows_kernel(RowsArgs a) {
  __shared__ long long s_off[kShare + 2];     // off[cs - 1 .. c_last]
  __shared__ long long s_lo[kShare + 1];      // lo[cs .. c_last]
  __shared__ long long s_split[2];
  // read now, used last: the split needs only the prefix sums
  const long long total = *a.total;
  const long long d0 = blockIdx.x * static_cast<long long>(kShare);
  const long long d1 = min(d0 + kShare, a.ml + a.n);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long c = merge_split(a.offsets, a.n, a.ml, warp ? d1 : d0);
    if ((threadIdx.x & 31) == 0) s_split[warp] = c;
  }
  __syncthreads();
  const long long c0 = s_split[0], c1 = s_split[1];
  const long long j0 = d0 - c0, j1 = d1 - c1;       // rows [j0, j1)
  if (j1 <= j0) return;
  // the rows' candidates lie in [c0, c1], c1 = n for the rows past every
  // candidate (the total: clipped to the last candidate, as searchsorted's
  // n is); staged: [cs, c_last], at least the last candidate
  const long long cs = min(c0, a.n - 1), c_last = min(c1, a.n - 1);
  const int cnt = static_cast<int>(c_last - cs + 1);
  for (int k = threadIdx.x; k <= cnt; k += kRows) {
    const long long c = cs - 1 + k;
    s_off[k] = c >= 0 ? a.offsets[c] : 0;
    if (k < cnt) s_lo[k] = a.lo[(cs + k) * a.stride];
  }
  __syncthreads();
  const long long valid_end = total < a.ml ? total : a.ml;
  for (long long j = j0 + threadIdx.x; j < j1; j += kRows) {
    // the first staged candidate whose prefix sum exceeds j (cnt: none)
    int lo = 0, hi = cnt;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_off[mid + 1] > j) hi = mid;
      else lo = mid + 1;
    }
    lo = min(lo, cnt - 1);
    const bool v = j < valid_end;
    a.cand[j] = cs + lo;
    a.valid[j] = v;
    a.rows[j] = v ? s_lo[lo] + (j - s_off[lo]) : 0;
  }
}

inline unsigned tiles_of(long long n, long long tile) {
  return static_cast<unsigned>(n < 1 ? 1 : (n + tile - 1) / tile);
}

inline columba::ScanArgs scan_args(long long* ticket, long long* status,
                                   unsigned epoch) {
  return columba::ScanArgs{reinterpret_cast<unsigned long long*>(ticket),
                           reinterpret_cast<unsigned long long*>(status),
                           epoch};
}

inline bool bad_scan(long long n, long long tiles, unsigned epoch) {
  return n < 1 || tiles_of(n, kTile) > tiles || epoch == 0 ||
         epoch > 0x3FFFFFFFu;
}

}  // namespace

extern "C" int columba_expand_frontier(
    const bool* done, const long long* ranges, int rw, const long long* rid,
    const long long* sid, long long C, const long long* itv,
    const long long* itv_count, long long M, int S, const long long* t_back64,
    const long long* pivot64, const int* t_back32, const int* pivot32,
    long long ml, long long* c_lo, long long* c_hi, long long* c_rid,
    long long* c_estb, long long* offsets, long long* total,
    long long* ticket, long long* status, long long tiles, unsigned epoch,
    cudaStream_t stream) {
  if (rw < 2 || S < 1 || C < 0 || M < 0 || ml < 0 ||
      (t_back64 == nullptr) == (t_back32 == nullptr) ||
      bad_scan(C + M, tiles, epoch))
    return static_cast<int>(cudaErrorInvalidValue);
  CandArgs a{done, ranges, rw, rid, sid, C, itv, itv_count, M, S,
             t_back64, pivot64, t_back32, pivot32, ml, c_lo, c_hi, c_rid,
             c_estb, offsets, total, scan_args(ticket, status, epoch)};
  frontier_kernel<<<tiles_of(C + M, kTile), kWide, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int columba_expand_scan(const long long* lo, const long long* hi,
                                   long long stride, long long n,
                                   long long ml, long long* offsets,
                                   long long* total, long long* ticket,
                                   long long* status, long long tiles,
                                   unsigned epoch, cudaStream_t stream) {
  if (stride < 1 || ml < 0 || bad_scan(n, tiles, epoch))
    return static_cast<int>(cudaErrorInvalidValue);
  WidthArgs a{lo, hi, stride, n, ml, offsets, total,
              scan_args(ticket, status, epoch)};
  scan_kernel<<<tiles_of(n, kTile), kWide, 0, stream>>>(a);
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
  rows_kernel<<<tiles_of(ml + n, kShare), kRows, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

