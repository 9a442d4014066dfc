// Kernel L: the (read, window) pairs before verification, deduplicated.
//
// Replaces columba_tpu/search/pipeline.py stage_dedup (:194-228) (K11),
// its lexsort (:210) included, and the window starts match_device_core
// hands it (:262-266). The sort is a stable LSD radix sort of (key, row)
// records, 8-bit digits, over the valid rows only. Entries:
//
//   windows   one thread an expanded row: its read row c_rid[cand] and its
//             window start pos + estb[cand] - kb (signed: may be < 0).
//   keys      the valid rows' records in row order, key (rid << 32) | (win
//             mod 2^32) (the window's low 32 bits unsigned, as the
//             reference orders them: a window below 0 sorts near 2^32),
//             row its 4 B index; with the row count's scalar (`total`)
//             the valid rows are the prefix [0, min(total, L)) and tiles
//             past it do nothing, else an order-keeping compaction of the
//             mask (common.cuh scan_flags). A rid outside [0, bound) traps.
//             In the same launch every pass's digit histogram: block
//             counts in shared memory, added into a per-stream table that
//             is zero between launches; the block that finishes last
//             turns it into each digit's start and zeroes it again.
//             Beside it the max_verify output slots cleared (the
//             compaction writes only the slots it fills).
//   pass      one launch a digit: a tile of 1,024 records ranked by digit
//             in shared memory (a warp's 32 lanes a round, __match_any_sync
//             and per-warp digit counts: stable), a decoupled look-back
//             over the earlier tiles' per-digit counts (one status word a
//             tile and digit, 4 tiles a round, stamped with the launch's
//             epoch), then the tile's records grouped by digit in shared
//             memory and written out, a digit's run contiguous.
//   compact   the first record of each key run, compacted in order into
//             max_verify slots (scan_flags), with its rid (from the key) and
//             its full window start (from the row); n_unique is the
//             unclamped count.
//
// Passes cover only the key bits that can vary: the window's 32 and
// ceil(log2(R)) rid bits, R the batch's rows (6 passes at R = 32,768).
// Shapes timed on the card at SE ALL's sizes (45,000 valid of 131,072
// rows; PERF.md, PR 16): pass tiles of 1,024 records and look-back rounds
// of 4 tiles beat 2,048 or 512 records and rounds of 1, 2, 8 or 16 (six
// passes 0.036 ms against 0.043 for 2,048 and 8); keys tiles of 1,024
// rows (512 x 2) beat 2,048 (512 x 4) and 256 x 4.
//
// Bound: bytes. windows reads 32 B and writes 16 B a row (two gathers by
// cand); keys reads 16 B (17 with a mask) and writes a 12 B record a valid
// row, and clears 17 B a verify slot; a pass reads and writes 12 B a valid
// row; compact reads a record and its predecessor's key a valid row and
// writes 17 B a kept row. The look-backs and the histogram's last block
// are latency.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;                      // windows
constexpr int kKeyThreads = 512, kKeyItems = 2;    // keys: 1,024 rows a
constexpr int kKeyTile = kKeyThreads * kKeyItems;  // tile (WIDE_TILE)
constexpr int kSortThreads = 256, kSortItems = 4;  // pass: 1,024 records
                                                   // a tile (SORT_TILE)
constexpr int kSortTile = kSortThreads * kSortItems;
constexpr int kSortWarps = kSortThreads / 32;
constexpr int kDigits = 256;                       // 8-bit digits
constexpr int kMaxPasses = 8;                      // 32 + 30 rid bits
constexpr int kRound = 4;                          // look-back tiles a round
constexpr int kCompactThreads = 512, kCompactItems = 2;
constexpr int kCompactTile = kCompactThreads * kCompactItems;
constexpr long long kBig = 1LL << 30;
constexpr int kDone = kMaxPasses * kDigits;        // hist's block counter

__global__ void __launch_bounds__(kThreads)
windows_kernel(const long long* pos, const long long* c_rid,
               const long long* c_estb, const long long* cand, long long L,
               long long kb, long long* rid, long long* win) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= L) return;
  const long long c = cand[i];
  rid[i] = c_rid[c];
  win[i] = pos[i] + c_estb[c] - kb;
}

// The block's tile from the ticket; the block with the last ticket resets
// it at once (a tile may return before any scan, where scan_tiles would
// reset it).
__device__ __forceinline__ long long claim_tile(const columba::ScanArgs& sa) {
  __shared__ long long s_tile;
  if (threadIdx.x == 0) {
    const unsigned long long t = atomicAdd(sa.ticket, 1ull);
    if (t == gridDim.x - 1) *sa.ticket = 0;
    s_tile = static_cast<long long>(t);
  }
  __syncthreads();
  return s_tile;
}

// Exclusive prefix of one value a thread over a group of 256 consecutive
// threads (8 warps); `s` holds 8 words for each group of the block.
__device__ __forceinline__ unsigned scan256(unsigned v, unsigned* s) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 7;
  unsigned* sw = s + 8 * (threadIdx.x >> 8);
  unsigned x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned u = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x += u;
  }
  if (lane == 31) sw[warp] = x;
  __syncthreads();
  unsigned before = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) before += w < warp ? sw[w] : 0u;
  __syncthreads();
  return before + x - v;
}

struct KeyArgs {
  const long long* rid;         // (L,)
  const long long* win;         // (L,)
  const bool* valid;            // (L,)
  const long long* total;       // () or null: the valid rows, a prefix
  long long L, bound;
  int passes;
  unsigned long long* key;      // (L,) records
  int* row;
  long long* n;                 // () records written
  unsigned* starts;             // (passes, 256) each digit's first record
  unsigned* hist;               // (kDone + 1,) zero between launches
  long long* rid_v;             // (mv,) cleared
  long long* win_v;
  bool* vlive;
  long long mv;
  columba::ScanArgs sa;         // the mask's compaction
};

__global__ void __launch_bounds__(kKeyThreads) keys_kernel(KeyArgs a) {
  __shared__ unsigned s_cnt[kMaxPasses * kDigits];
  __shared__ unsigned s_scan[16];
  __shared__ bool s_last;
  const long long stride = static_cast<long long>(gridDim.x) * kKeyThreads;
  for (long long j = blockIdx.x * static_cast<long long>(kKeyThreads) +
                     threadIdx.x; j < a.mv; j += stride) {
    a.rid_v[j] = 0;
    a.win_v[j] = 0;
    a.vlive[j] = false;
  }
  for (int k = threadIdx.x; k < a.passes * kDigits; k += kKeyThreads)
    s_cnt[k] = 0;
  __syncthreads();
  const bool prefix = a.total != nullptr;
  long long tile, n_valid = 0;
  unsigned fv = 0;
  unsigned long long ex[kKeyItems];
  if (prefix) {
    tile = blockIdx.x;
    const long long t = *a.total;
    n_valid = t < 0 ? 0 : (t < a.L ? t : a.L);
#pragma unroll
    for (int j = 0; j < kKeyItems; ++j) {
      const long long i = columba::item_lane<kKeyThreads, kKeyItems>(tile, j);
      fv |= (i < n_valid ? 1u : 0u) << j;
      ex[j] = static_cast<unsigned long long>(i);
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) *a.n = n_valid;
  } else {
    tile = columba::take_tile(a.sa);
#pragma unroll
    for (int j = 0; j < kKeyItems; ++j) {
      const long long i = columba::item_lane<kKeyThreads, kKeyItems>(tile, j);
      fv |= (i < a.L && a.valid[i] ? 1u : 0u) << j;
    }
    unsigned long long end;
    columba::scan_flags<kKeyThreads, kKeyItems>(fv, 0u, ex, tile, a.sa, end);
    if (tile == gridDim.x - 1 && threadIdx.x == 0)
      *a.n = static_cast<long long>(end & 0xFFFFFFFFull);
  }
  unsigned long long k[kKeyItems];
#pragma unroll
  for (int j = 0; j < kKeyItems; ++j) {
    k[j] = 0;
    if (!((fv >> j) & 1u)) continue;
    const long long i = columba::item_lane<kKeyThreads, kKeyItems>(tile, j);
    const long long r = a.rid[i];
    if (r < 0 || r >= a.bound) __trap();
    k[j] = (static_cast<unsigned long long>(r) << 32) |
           (static_cast<unsigned long long>(a.win[i]) & 0xFFFFFFFFull);
    const long long d = static_cast<long long>(ex[j] & 0xFFFFFFFFull);
    a.key[d] = k[j];
    a.row[d] = static_cast<int>(i);
  }
  for (int p = 0; p < a.passes; ++p) {
#pragma unroll
    for (int j = 0; j < kKeyItems; ++j)
      if ((fv >> j) & 1u)
        atomicAdd(&s_cnt[p * kDigits + ((k[j] >> (8 * p)) & 255u)], 1u);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < a.passes * kDigits; k += kKeyThreads)
    if (s_cnt[k]) atomicAdd(&a.hist[k], s_cnt[k]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&a.hist[kDone], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  // the last block: every block's counts are in; each pass's exclusive
  // digit starts (all counts loaded at once, then scanned), and the table
  // zeroed for the next launch
  __threadfence();
  constexpr int kPer = kMaxPasses * kDigits / kKeyThreads;
  unsigned v[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int c = q * kKeyThreads + threadIdx.x;
    v[q] = c < a.passes * kDigits ? __ldcg(&a.hist[c]) : 0u;
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int c = q * kKeyThreads + threadIdx.x;
    const unsigned st = scan256(v[q], s_scan);
    if (c < a.passes * kDigits) {
      a.starts[c] = st;
      a.hist[c] = 0;
    }
  }
  if (threadIdx.x == 0) a.hist[kDone] = 0;
}

struct PassArgs {
  const unsigned long long* key_in;
  const int* row_in;
  unsigned long long* key_out;
  int* row_out;
  const long long* n;           // () records
  const unsigned* starts;       // (256,) this pass's digit starts
  int shift;
  columba::ScanArgs sa;         // status: 256 words a tile
};

__device__ __forceinline__ bool stamped(unsigned long long w,
                                        unsigned epoch) {
  return ((w >> 32) & 0x3FFFFFFFu) == epoch && (w >> 62) != 0;
}

__global__ void __launch_bounds__(kSortThreads) pass_kernel(PassArgs a) {
  __shared__ unsigned long long s_key[kSortTile];
  __shared__ int s_row[kSortTile];
  __shared__ unsigned s_warp[kSortWarps][kDigits];   // counts, then offsets
  __shared__ unsigned s_local[kDigits];              // tile digit starts
  __shared__ int s_out[kDigits];                     // out pos - local pos
  __shared__ unsigned s_scan[8];
  const long long n = *a.n;
  for (int k = threadIdx.x; k < kSortWarps * kDigits; k += kSortThreads)
    (&s_warp[0][0])[k] = 0;
  const long long tile = claim_tile(a.sa);
  const long long first = tile * kSortTile;
  if (first >= n) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const unsigned start = a.starts[threadIdx.x];     // digit threadIdx.x's
  unsigned long long k[kSortItems];
  int r[kSortItems];
  unsigned d[kSortItems], rank[kSortItems];
  // item j of lane l of warp w: record first + (w * kSortItems + j) * 32 + l
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const long long i = first + (warp * kSortItems + j) * 32 + lane;
    const bool v = i < n;
    k[j] = v ? a.key_in[i] : 0ull;
    r[j] = v ? a.row_in[i] : 0;
    d[j] = v ? static_cast<unsigned>((k[j] >> a.shift) & 255u) : kDigits;
  }
  // stable ranks: the warp's rounds in order, a round's equal digits
  // counted by __match_any_sync, the warp's running count a digit
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const unsigned peers = __match_any_sync(0xFFFFFFFFu, d[j]);
    const int leader = __ffs(peers) - 1;
    unsigned before = 0;
    if (lane == leader && d[j] < kDigits) {
      before = s_warp[warp][d[j]];
      s_warp[warp][d[j]] = before + __popc(peers);
    }
    before = __shfl_sync(0xFFFFFFFFu, before, leader);
    rank[j] = before + __popc(peers & below);
    __syncwarp();
  }
  __syncthreads();
  // thread t owns digit t: the warps' offsets, the tile's count and its
  // local start, then the look-back for the digit over the earlier tiles
  const int dg = threadIdx.x;
  unsigned cnt = 0;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    const unsigned u = s_warp[w][dg];
    s_warp[w][dg] = cnt;
    cnt += u;
  }
  const unsigned local = scan256(cnt, s_scan);
  s_local[dg] = local;
  volatile unsigned long long* st = a.sa.status;
  const unsigned epoch = a.sa.epoch;
  if (tile > 0) st[tile * kDigits + dg] = columba::stamp(columba::kAggregate,
                                                         epoch, cnt);
  unsigned long long before = 0;
  for (long long base = tile - 1; base >= 0; base -= kRound) {
    unsigned long long w[kRound];
#pragma unroll
    for (int q = 0; q < kRound; ++q)
      w[q] = base - q >= 0 ? st[(base - q) * kDigits + dg]
                           : columba::stamp(columba::kPrefix, epoch, 0u);
    // add the tiles up to the nearest inclusive prefix
    bool stop = false;
#pragma unroll
    for (int q = 0; q < kRound; ++q) {
      if (!stop) {
        while (!stamped(w[q], epoch)) w[q] = st[(base - q) * kDigits + dg];
        before += w[q] & 0xFFFFFFFFull;
        stop = (w[q] >> 62) == 2;
      }
    }
    if (stop) break;
  }
  st[tile * kDigits + dg] = columba::stamp(
      columba::kPrefix, epoch, static_cast<unsigned>(before + cnt));
  s_out[dg] = static_cast<int>(start + before) - static_cast<int>(local);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    if (d[j] >= kDigits) continue;
    const unsigned p = s_local[d[j]] + s_warp[warp][d[j]] + rank[j];
    s_key[p] = k[j];
    s_row[p] = r[j];
  }
  __syncthreads();
  const int here = static_cast<int>(min(static_cast<long long>(kSortTile),
                                        n - first));
  for (int q = threadIdx.x; q < here; q += kSortThreads) {
    const unsigned long long kk = s_key[q];
    const long long o = s_out[(kk >> a.shift) & 255u] + q;
    a.key_out[o] = kk;
    a.row_out[o] = s_row[q];
  }
}

struct CompactArgs {
  const unsigned long long* key_s;  // (n,) sorted records
  const int* row_s;
  const long long* n;               // ()
  const long long* win;             // (L,) window starts, by row
  long long mv;
  long long* rid_v;                 // (mv,)
  long long* win_v;
  bool* vlive;
  long long* n_unique;              // ()
  columba::ScanArgs sa;
};

__global__ void __launch_bounds__(kCompactThreads)
compact_kernel(CompactArgs a) {
  const long long n = *a.n;
  const long long tile = claim_tile(a.sa);
  const long long tiles = (n + kCompactTile - 1) / kCompactTile;
  if (tile >= tiles) {
    if (n == 0 && tile == 0 && threadIdx.x == 0) *a.n_unique = 0;
    return;
  }
  unsigned fu = 0;
  unsigned long long k[kCompactItems];
#pragma unroll
  for (int j = 0; j < kCompactItems; ++j) {
    const long long i =
        columba::item_lane<kCompactThreads, kCompactItems>(tile, j);
    k[j] = 0;
    if (i >= n) continue;
    k[j] = a.key_s[i];
    fu |= (i == 0 || k[j] != a.key_s[i - 1] ? 1u : 0u) << j;
  }
  unsigned long long ex[kCompactItems], end;
  columba::scan_flags<kCompactThreads, kCompactItems>(fu, 0u, ex, tile, a.sa,
                                                      end);
#pragma unroll
  for (int j = 0; j < kCompactItems; ++j) {
    const long long p = static_cast<long long>(ex[j] & 0xFFFFFFFFull);
    if (!((fu >> j) & 1u) || p >= a.mv) continue;
    const long long i =
        columba::item_lane<kCompactThreads, kCompactItems>(tile, j);
    a.rid_v[p] = static_cast<long long>(k[j] >> 32);
    a.win_v[p] = a.win[a.row_s[i]];
    a.vlive[p] = true;
  }
  if (tile == tiles - 1 && threadIdx.x == 0)
    *a.n_unique = static_cast<long long>(end & 0xFFFFFFFFull);
}

inline unsigned grid(long long n, int tile) {
  return static_cast<unsigned>(n < 1 ? 1 : (n + tile - 1) / tile);
}

inline bool bad_epoch(unsigned epoch) {
  return epoch == 0 || epoch > 0x3FFFFFFFu;
}

inline columba::ScanArgs scan_args(long long* ticket, long long* status,
                                   unsigned epoch) {
  return columba::ScanArgs{reinterpret_cast<unsigned long long*>(ticket),
                           reinterpret_cast<unsigned long long*>(status),
                           epoch};
}

}  // namespace

extern "C" int columba_dedup_windows(const long long* pos,
                                     const long long* c_rid,
                                     const long long* c_estb,
                                     const long long* cand, long long L,
                                     long long kb, long long* rid,
                                     long long* win, cudaStream_t stream) {
  if (L < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return 0;
  windows_kernel<<<grid(L, kThreads), kThreads, 0, stream>>>(
      pos, c_rid, c_estb, cand, L, kb, rid, win);
  return static_cast<int>(cudaGetLastError());
}

// total: null with a mask (valid), else the valid rows are the prefix
// [0, min(*total, L)). hist: (8 * 256 + 1) uint32, zero between launches.
extern "C" int columba_dedup_keys(
    const long long* rid, const long long* win, const bool* valid,
    const long long* total, long long L, long long bound, int passes,
    long long* key, int* row, long long* n, int* starts, int* hist,
    long long* rid_v, long long* win_v, bool* vlive, long long mv,
    long long* ticket, long long* status, long long tiles, unsigned epoch,
    cudaStream_t stream) {
  const unsigned blocks = grid(L, kKeyTile);
  if (L < 1 || L >= (1LL << 31) || mv < 0 || bound < 1 || bound > kBig ||
      passes < 1 || passes > kMaxPasses ||
      (total == nullptr && (blocks > tiles || bad_epoch(epoch))))
    return static_cast<int>(cudaErrorInvalidValue);
  KeyArgs a{rid, win, valid, total, L, bound, passes,
            reinterpret_cast<unsigned long long*>(key), row, n,
            reinterpret_cast<unsigned*>(starts),
            reinterpret_cast<unsigned*>(hist), rid_v, win_v, vlive, mv,
            scan_args(ticket, status, epoch)};
  keys_kernel<<<blocks, kKeyThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// One pass over digit shift / 8 of the records [0, *n) of L slots; the
// statuses hold 256 words (128 two-word tiles of the pool) a tile.
extern "C" int columba_dedup_pass(const long long* key_in, const int* row_in,
                                  long long* key_out, int* row_out,
                                  const long long* n, const int* starts,
                                  int shift, long long L, long long* ticket,
                                  long long* status, long long tiles,
                                  unsigned epoch, cudaStream_t stream) {
  const unsigned blocks = grid(L, kSortTile);
  if (L < 1 || L >= (1LL << 31) || shift < 0 || shift > 56 || shift % 8 ||
      static_cast<long long>(blocks) * (kDigits / 2) > tiles ||
      bad_epoch(epoch))
    return static_cast<int>(cudaErrorInvalidValue);
  PassArgs a{reinterpret_cast<const unsigned long long*>(key_in), row_in,
             reinterpret_cast<unsigned long long*>(key_out), row_out, n,
             reinterpret_cast<const unsigned*>(starts), shift,
             scan_args(ticket, status, epoch)};
  pass_kernel<<<blocks, kSortThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int columba_dedup_compact(
    const long long* key_s, const int* row_s, const long long* n,
    const long long* win, long long L, long long mv, long long* rid_v,
    long long* win_v, bool* vlive, long long* n_unique, long long* ticket,
    long long* status, long long tiles, unsigned epoch, cudaStream_t stream) {
  const unsigned blocks = grid(L, kCompactTile);
  if (L < 1 || L >= (1LL << 31) || mv < 0 || blocks > tiles ||
      bad_epoch(epoch))
    return static_cast<int>(cudaErrorInvalidValue);
  CompactArgs a{reinterpret_cast<const unsigned long long*>(key_s), row_s, n,
                win, mv, rid_v, win_v, vlive, n_unique,
                scan_args(ticket, status, epoch)};
  compact_kernel<<<blocks, kCompactThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
