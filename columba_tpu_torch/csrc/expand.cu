// Kernel K: candidates and their expansion into SA rows.
//
// Replaces columba_tpu/search/pipeline.py stage_candidates (:132-166) and
// stage_expand (:169-191) (K9), and the k = 0 pass's expansion of kernel
// E's ranges (:734-740); with them kernel J's tail
// (columba_tpu/search/executor.py:880-932, K8) on match_device_core's
// path. Entries:
//
//   frontier_tail  kernel J's tail (K8) and the candidate list with its
//               prefix sums in one launch: J's rows of the final frontier
//               (tail.cuh: rows past the live count zeroed after a move,
//               ids decoded, ed_lb, done, arg_b; the ghosts appended to the
//               in-text buffer, its count and the overflow words), then the
//               C frontier lanes (done lanes' range, else empty) and the M
//               in-text rows (the first itv_count, the rest empty), each
//               with its read row and its estb (the read start's offset
//               from the back-side text depth: per search from the static
//               tables, or per lane under dynamic partitioning); then the
//               candidates' widths, clamped at max_locate + 1, scanned
//               into their inclusive prefix sums and total. The widths
//               never go through memory. At SE ALL's shape 0.0077 ms of
//               device time against 0.0097 for J's and K's launches before.
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
// Bound: bytes. frontier_tail reads J's bytes (tools/bounds.py) and an
// in-text row a candidate and writes 40 B (four columns and the prefix
// sum); ranges
// reads 16 B and writes 8 B; rows reads each candidate's prefix sum and
// lo once (a block's staging) and writes 17 B a row.
#include "tail.cuh"

namespace {

constexpr int kWide = 512;                   // frontier and ranges: blocks
constexpr int kItems = 2;                    // of 512 threads, 2 candidates
constexpr int kTile = kWide * kItems;        // a thread (executor.WIDE_TILE)
constexpr int kRows = 1024;                  // rows: threads a block and
constexpr int kShare = 2048;                 // merged items a block

struct CandArgs {
  columba::TailRows t;          // kernel J's rows: the final frontier
  long long C;
  long long* itv;               // (M + 1, 4) the in-text buffer
  long long M;
  long long* words;             // (8,) the run's counter words
  long long shrink;             // the overflow of the two-stage shrink
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
  columba::ScanArgs sa;         // the widths' statuses, then the ghosts'
  unsigned long long* ghost_status;  // and their written marks
};

__device__ __forceinline__ long long clamp_width(long long lo, long long hi,
                                                 long long ml) {
  const long long w = hi - lo;
  return w < 0 ? 0 : (w > ml + 1 ? ml + 1 : w);
}

// In-tile exclusive counts of one flag an item (bit j of `f`: item j), in
// lane order, and the tile's total.
__device__ __forceinline__ unsigned tile_flags(unsigned f,
                                               unsigned (&ex)[kItems]) {
  constexpr int kWarps = kWide / 32;
  __shared__ unsigned s_w[kWarps];
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  const int warp = threadIdx.x >> 5;
  unsigned run = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const unsigned m = __ballot_sync(0xFFFFFFFFu, (f >> j) & 1u);
    ex[j] = run + __popc(m & below);
    run += __popc(m);
  }
  if ((threadIdx.x & 31) == 0) s_w[warp] = run;
  __syncthreads();
  unsigned before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? s_w[w] : 0u;
    total += s_w[w];
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) ex[j] += before;
  return total;
}

// The in-text buffer's row k as two 16 B loads, through L1 or (fresh)
// from L2.
__device__ __forceinline__ void load_row(const long long* itv, long long k,
                                         bool fresh, long long (&r)[4]) {
  const longlong2* p = reinterpret_cast<const longlong2*>(itv + 4 * k);
  const longlong2 x = fresh ? __ldcg(p) : p[0];
  const longlong2 y = fresh ? __ldcg(p + 1) : p[1];
  r[0] = x.x;
  r[1] = x.y;
  r[2] = y.x;
  r[3] = y.y;
}

// Warp 0 waits until the status word of each tile b in [b0, F) (words
// `stride` apart) carries this launch's epoch and an inclusive prefix;
// returns the count of tile F - 1's word to every lane of warp 0.
__device__ __forceinline__ unsigned long long wait_prefixes(
    const unsigned long long* st, long long b0, long long F, int stride,
    unsigned epoch) {
  const volatile unsigned long long* s = st;
  unsigned long long w = 0;
  for (long long b = b0 + threadIdx.x; b < F; b += 32) {
    do {
      w = s[stride * b];
    } while (((w >> 32) & 0x3FFFFFFFu) != epoch || (w >> 62) != 2);
  }
  __threadfence();
  __syncwarp();
  return F > 0 ? s[stride * (F - 1)] & 0xFFFFFFFFull : 0;
}

// A frontier tile's ghosts into the in-text buffer after `cnt` rows and
// the `base` ghosts of the earlier tiles (clamped at M), then the tile's
// written mark: the block's barrier, then one thread's fence and store
// (the pattern of a grid-wide barrier; every thread's fence timed 0.3-0.8
// us slower on the card).
__device__ __forceinline__ void write_ghosts(
    const CandArgs& a, long long tile, long long cnt, unsigned long long base,
    unsigned f, const unsigned (&gx)[kItems],
    const columba::TailRow (&g)[kItems], unsigned long long* written) {
  const long long q0 = cnt + static_cast<long long>(base);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long q = q0 + gx[j];
    if (((f >> j) & 1u) && q < a.M) columba::ghost_row(a.itv, q, g[j]);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    static_cast<volatile unsigned long long*>(written)[tile] =
        columba::stamp(columba::kPrefix, a.sa.epoch, 0u);
  }
}

// The candidates of a frontier whose tail run_scheme left to this launch.
// The frontier's tiles do kernel J's rows (tail.cuh) and append the
// ghosts, in lane order, after the in-text buffer's words[0] >> 32 rows.
// The ghosts go first, from their ids and range ends alone: a scan of their
// flags over the tiles that hold frontier lanes, its inclusive prefixes
// published as soon as known, then the tile's ghost rows written and
// marked written in a status word of their own; then J's other reads, and
// its writes only after the widths' scan. A tile that holds in-text lanes
// loads its rows first; where they reach past that count it waits for the
// last frontier tile's ghost prefix (the ghosts' total: the in-text
// count), and only where they reach into the ghosts' rows for every
// frontier tile's written mark, and loads those rows again from L2 (a line
// of them may have come into L1 before they were written). The frontier's
// tiles come first in ticket order, so a waiting tile waits only on
// running blocks. Timed on the card (PERF.md, PR 16): with the ghosts'
// rows or J's writes before the widths' scan, every later tile's
// look-back waited on them, and the launch took longer than J's and K's
// two launches.
__global__ void __launch_bounds__(kWide) frontier_kernel(CandArgs a) {
  __shared__ long long s_count;
  __shared__ unsigned long long s_gbase;
  const long long tile = columba::take_tile(a.sa);
  const long long n = a.C + a.M;
  const long long first = tile * kTile;
  const long long last = min(first + kTile, n) - 1;
  const bool dyn = a.t_back64 == nullptr;
  const unsigned S = static_cast<unsigned>(a.t.S);
  // the ghost scan's statuses (two words a tile), then the written marks
  unsigned long long* const gst = a.ghost_status;
  unsigned long long* const written = a.ghost_status + 2 * gridDim.x;
  const long long cnt = static_cast<long long>(
      static_cast<unsigned long long>(a.words[0]) >> 32);
  long long lo[kItems], hi[kItems], rid[kItems], estb[kItems];
  unsigned long long w[kItems], ex[kItems];
  // the frontier lanes
  if (first < a.C) {
    // the ghosts first, from their ids and range ends alone (a row past
    // the live count after a move is none): their scan, its prefixes out
    // at once (the in-text count waits on them), their rows written and
    // marked, and only then the rest of J's rows
    columba::TailRow gh[kItems];
    unsigned gx[kItems], fg = 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = columba::item_lane<kWide, kItems>(tile, j);
      gh[j] = columba::TailRow{0, 0, 0, 0, 0u, -1, false, false};
      if (i >= a.C || (a.t.moved && i >= a.t.live)) continue;
      gh[j].id = a.t.ids[i];
      if (gh[j].id >= 0) continue;
      gh[j].lo = a.t.ranges[i * a.t.rw];
      gh[j].hi = a.t.ranges[i * a.t.rw + 1];
      gh[j].lane = static_cast<unsigned>(gh[j].id & columba::kGhostIdMask);
      fg |= 1u << j;
    }
    const unsigned total = tile_flags(fg, gx);
    if (threadIdx.x < 32) {
      const unsigned long long base = columba::tile_base(
          total, tile, columba::ScanArgs{a.sa.ticket, gst, a.sa.epoch});
      if (threadIdx.x == 0) {
        s_gbase = base;
        if (first + kTile >= a.C) {            // the last frontier tile
          a.words[6] = min(cnt + static_cast<long long>(base + total), a.M);
          a.words[7] = a.words[2] + a.shrink;
        }
      }
    }
    __syncthreads();
    write_ghosts(a, tile, cnt, s_gbase, fg, gx, gh, written);
    // J's rows: both rows read first (their loads in flight together),
    // then J's outputs written; the rows past the live count are zeroed
    // after the widths' scan, off the look-back's path
    columba::TailRow g[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = columba::item_lane<kWide, kItems>(tile, j);
      g[j] = columba::TailRow{0, 0, 0, 0, 0u, -1, false, false};
      if (i < a.C) g[j] = columba::tail_read(a.t, i);
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = columba::item_lane<kWide, kItems>(tile, j);
      if (i >= a.C) continue;
      columba::tail_write(a.t, i, g[j], false);
      lo[j] = g[j].done ? g[j].lo : 0;
      hi[j] = g[j].done ? g[j].hi : 0;
      rid[j] = g[j].lane / S;
      estb[j] = dyn ? static_cast<long long>(a.t_back32[g[j].lane] -
                                             a.pivot32[g[j].lane])
                    : a.t_back64[g[j].lane % S] - a.pivot64[g[j].lane % S];
    }
  }
  // the in-text lanes
  if (last >= a.C) {
    long long r[kItems][4];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = columba::item_lane<kWide, kItems>(tile, j);
      if (i >= a.C && i < n) load_row(a.itv, i - a.C, false, r[j]);
    }
    long long count = cnt;           // enough for rows below cnt
    if (last - a.C >= cnt) {
      // rows from cnt on: the in-text count needs the ghosts' total
      const long long F = (a.C + kTile - 1) / kTile;
      if (threadIdx.x < 32) {
        const long long G = static_cast<long long>(
            wait_prefixes(gst, F - 1, F, 2, a.sa.epoch));
        const long long c = min(cnt + G, a.M);
        // rows of this tile among the ghosts' [cnt, c): wait until they
        // are written
        if (c > cnt && first - a.C < c)
          wait_prefixes(written, 0, F, 1, a.sa.epoch);
        if (threadIdx.x == 0) s_count = c;
      }
      __syncthreads();
      count = s_count;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const long long i = columba::item_lane<kWide, kItems>(tile, j);
        const long long k = i - a.C;
        if (i >= a.C && i < n && k >= cnt && k < count)
          load_row(a.itv, k, true, r[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long i = columba::item_lane<kWide, kItems>(tile, j);
      if (i < a.C || i >= n) continue;
      const bool v = i - a.C < count;
      lo[j] = v ? r[j][0] : 0;
      hi[j] = v ? r[j][1] : 0;
      // a lane id (< 2^21, the ghost encoding): 32-bit division, inline
      const unsigned ids = static_cast<unsigned>(r[j][2]);
      rid[j] = ids / S;
      estb[j] = r[j][3] - (dyn ? static_cast<long long>(a.pivot32[ids])
                               : a.pivot64[ids % S]);
    }
  }
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = columba::item_lane<kWide, kItems>(tile, j);
    w[j] = 0;
    if (i >= n) continue;
    a.c_lo[i] = lo[j];
    a.c_hi[i] = hi[j];
    a.c_rid[i] = rid[j];
    a.c_estb[i] = estb[j];
    w[j] = static_cast<unsigned long long>(clamp_width(lo[j], hi[j], a.ml));
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
  if (first < a.C) {
    // the rows past the live count zeroed by the frontier tiles together
    const long long F = (a.C + kTile - 1) / kTile;
    columba::zero_past_live(a.t, a.C, tile * kWide + threadIdx.x,
                            F * kWide);
  }
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

// kernel J's tail and the candidates in one launch: the final frontier's
// fields (C rows, written in place after a move), J's outputs, the
// in-text buffer itv (M + 1 rows), the run's counter words; the statuses
// hold two scans and the written marks (3 x the tiles' two words).
extern "C" int columba_expand_frontier_tail(
    long long* ranges, int* ids, signed char* band, signed char* colmin,
    long long C, long long live, int moved, int rw, int bw, int W, int Wp,
    int track, int S, const long long* final_reg, const long long* u_last64,
    const int* u_last32, long long* itv, long long M, long long* words,
    long long shrink, long long* rid, long long* sid, long long* ed_lb,
    bool* done, signed char* arg_b, const long long* t_back64,
    const long long* pivot64, const int* t_back32, const int* pivot32,
    long long ml, long long* c_lo, long long* c_hi, long long* c_rid,
    long long* c_estb, long long* offsets, long long* total,
    long long* ticket, long long* status, long long tiles, unsigned epoch,
    cudaStream_t stream) {
  const unsigned grid = tiles_of(C + M, kTile);
  if (rw < 2 || S < 1 || C < 1 || M < 0 || ml < 0 || W < 1 || Wp < W ||
      (t_back64 == nullptr) == (t_back32 == nullptr) ||
      (u_last64 == nullptr) == (u_last32 == nullptr) ||
      bad_scan(C + M, tiles, epoch) || 3 * static_cast<long long>(grid) > tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  CandArgs a{columba::TailRows{ranges, ids, band, colmin, live, moved, rw,
                               bw, W, Wp, track, S, final_reg, u_last64,
                               u_last32, rid, sid, ed_lb, done, arg_b},
             C, itv, M, words, shrink, t_back64, pivot64, t_back32, pivot32,
             ml, c_lo, c_hi, c_rid, c_estb, offsets, total,
             scan_args(ticket, status, epoch),
             reinterpret_cast<unsigned long long*>(status) + 2 * grid};
  frontier_kernel<<<grid, kWide, 0, stream>>>(a);
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

