// Kernels I and J: the scheme executor's frontier outside the band steps.
//
// Kernel I replaces the work of columba_tpu/search/executor.py run_scheme
// from the read upload to the first band step: the k-mer seed lookup
// (columba_tpu/index/kmer.py:91 lookup, K4, executor.py:310-326), the
// exact loop's drain appends and the frontier init (K6, executor.py:349-363
// and :514-568), and the two-stage exact loop's compaction and scatter back
// (:468-510). Kernel J replaces its tail (K8, executor.py:880-932). Entries:
//
//   seed        one thread a (read, search) lane: the K chars at the
//               search's k-mer start packed and looked up in the seed table
//               (a window with an N, or a search without a start, takes
//               the empty or the full range), the search mask, empty ranges
//               zeroed; beside it the run's buffers cleared or filled (the
//               in-text buffer, the run's counter words, the frontier's
//               fill of 0 / INF, the second exact stage's lanes). It writes
//               no cell codes: kernel B reads a lane's band cells from the
//               read and the schedule's tables at the step that uses them
//               (band_step.cuh), where the JAX package gathers an
//               (R * S * T, BW) array of them up front
//               (columba_tpu/search/executor.py:576-583).
//               kmer.lookup's entry on the card is this one with one search
//               starting at 0 and no zeroing of empty ranges.
//   drain       the exact loop's drain rows appended to the in-text buffer
//               in lane order (clamped at M).
//   init        the lanes with 0 < width <= switchpoint appended after the
//               drain rows, in lane order, and zeroed; then the live lanes
//               compacted in order into C frontier slots with their band
//               and colMin inits (the (S, ...) tables tiled rid-major, or
//               per lane); n_alive0, the overflow and kernel B's first word
//               go to the run's counter words. The drain rows' total must be
//               known before the narrow lanes' positions: drain is a launch
//               of its own, and init reads its count.
//   ex_compact  the lanes live after the first exact stage compacted in
//               order into ex_cap lanes (range, lane id, and each lane's
//               slot), the overflow counted.
//   ex_back     the second stage's lanes scattered back to their lanes
//               (gathered by each lane from its slot).
//   tail        (kernel J) one launch after the band loop: rows past the
//               live count zeroed after a move, the ghosts appended in order
//               to the in-text buffer with their decoded id and death depth,
//               ids decoded into rid and sid, the final colMin registers
//               (arg_b under track_arg), ed_lb and done against u_last, the
//               final in-text count and overflow (tail.cuh). Launched where
//               no candidates' launch follows (the textless pass,
//               run_scheme's direct callers); match_device_core's path does
//               the same work in kernel K's frontier_tail launch.
//
// The order-keeping appends and compactions are one scan across the grid
// (a block scan, then the decoupled look-back over ticketed tiles that
// kernel B uses), in lane order, so every array equals the plain version's
// (executor.py *_plain), row for row. drain, init and ex_compact scan tiles
// of 1,024 lanes, blocks of 512 threads of 2 lanes (common.cuh scan_flags:
// a warp holds 64 consecutive lanes in 2 rounds of 32, each round's flags
// counted by ballots), so that L = 98,304 lanes make 96 tiles, one block
// an SM in one wave, whose look-back waits on at most three rounds of 32
// tiles where 256-lane tiles (384) waited on up to 12. Timed on the card
// against 8 lanes a thread (48 tiles: the threads' serial work on 48 SMs
// cost more than the look-back saved), 256 x 2, 256 x 4, 512 x 1 and
// 1024 x 1 or 2, this shape was the fastest or within 5 % on every entry.
// The tail keeps one lane a thread (scan_tiles, 256-lane tiles: it runs on
// the 1,024 rows after the shrink).
//
// The run's counter words (int64): [0] kernel B's step word (kept | in-text
// rows << 32), [1] visits, [2] overflow, [3] kernel B's ticket, [4] in-text
// rows after the drain, [5] searches started (n_alive0), [6] in-text rows
// after the tail, [7] overflow after the tail. A launch never reads a word
// its own last block writes.
//
// Bound: bytes. The seed reads K chars and one 32 B table row a lane,
// writes the lane and clears the run's buffers (the in-text buffer, M x
// 32 B, is most of them); init and the tail read and write a frontier row
// a lane. The scans' look-back is latency, one wait a tile.
#include "tail.cuh"

namespace {

constexpr int kThreads = 256;                // seed, ex_back, tail
constexpr int kWide = 512;                   // drain, init, ex_compact: a
constexpr int kItems = 2;                    // block of 512 threads, 2 lanes
constexpr int kTile = kWide * kItems;        // a thread (executor.WIDE_TILE)
constexpr int kMaxRW = 12;
constexpr int kMaxClears = 8;

struct Clear {
  void* p;
  long long n;
  int v;
};

struct SeedArgs {
  const unsigned char* reads;   // (R, m)
  long long L;                  // R * S lanes
  int m, S, K;                  // K = 0: no seed table
  const long long* table;       // (4^K, 4)
  const int* kstart;            // (S,) k-mer start (< 0: full range); null: 0
  const bool* mask;             // (R, S) or null
  long long full[kMaxRW];
  int rw;
  int zero_empty;
  long long* ranges;            // (L, rw)
  Clear clears[kMaxClears];
  int n_clears;
};

__global__ void __launch_bounds__(kThreads) seed_kernel(SeedArgs a) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long t0 = blockIdx.x * static_cast<long long>(kThreads) +
                       threadIdx.x;
  for (long long i = t0; i < a.L; i += stride) {
    const long long r = i / a.S;
    const int s = static_cast<int>(i - r * a.S);
    const int ks = a.kstart != nullptr ? a.kstart[s] : 0;
    long long out[kMaxRW];
#pragma unroll
    for (int k = 0; k < kMaxRW; ++k) out[k] = k < a.rw ? a.full[k] : 0;
    if (a.K > 0 && ks >= 0) {
      const unsigned char* c = a.reads + r * a.m + ks;
      long long code = 0;
      bool bad = false;
      for (int j = 0; j < a.K; ++j) {
        const unsigned ch = c[j];
        bad |= ch > 3;
        code = code * 4 + (ch > 3 ? 3 : ch);
      }
      const long long* row = a.table + 4 * code;
#pragma unroll
      for (int k = 0; k < 4; ++k) out[k] = bad ? 0 : row[k];
    }
    bool zero = a.mask != nullptr && !a.mask[i];
    zero |= a.zero_empty && !(out[1] > out[0]);
    long long* o = a.ranges + i * a.rw;
#pragma unroll
    for (int k = 0; k < kMaxRW; ++k)
      if (k < a.rw) o[k] = zero ? 0 : out[k];
  }
  for (int c = 0; c < a.n_clears; ++c)
    columba::fill_bytes(a.clears[c].p, a.clears[c].n, a.clears[c].v);
}

struct DrainArgs {
  const long long* drows;       // (L, 4)
  long long L;
  long long* itv;               // (M + 1, 4)
  long long M;
  long long* words;
  columba::ScanArgs sa;
};

__global__ void __launch_bounds__(kWide) drain_kernel(DrainArgs a) {
  const long long tile = columba::take_tile(a.sa);
  unsigned keep = 0;                  // bit j: item j drains
  unsigned long long q[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = columba::item_lane<kWide, kItems>(tile, j);
    if (i < a.L && a.drows[4 * i + 1] > a.drows[4 * i]) keep |= 1u << j;
  }
  unsigned long long end;
  columba::scan_flags<kWide, kItems>(keep, 0u, q, tile, a.sa, end);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = columba::item_lane<kWide, kItems>(tile, j);
    if (((keep >> j) & 1u) && static_cast<long long>(q[j]) < a.M) {
#pragma unroll
      for (int k = 0; k < 4; ++k) a.itv[4 * q[j] + k] = a.drows[4 * i + k];
    }
  }
  if (tile == gridDim.x - 1 && threadIdx.x == 0)
    a.words[4] = min(static_cast<long long>(end), a.M);
}

struct InitArgs {
  const long long* ranges0;     // (L, rw)
  long long L;
  int rw, S, switchpoint;
  const int* db_exact;          // (S,) or per lane (L,)
  const signed char* band_init;   // (S, 2, bw) or per lane (L, 2, bw)
  const signed char* colmin_init; // (S, 2, W) or per lane (L, 2), W = 1
  int per_lane, bw, W, Wp;
  long long C;
  long long* o_ranges;          // (C, rw)
  int* o_ids;                   // (C,)
  signed char* o_band;          // (C, 2, bw)
  signed char* o_colmin;        // (C, 2, Wp)
  long long* itv;
  long long M;
  long long* words;
  columba::ScanArgs sa;
};

__global__ void __launch_bounds__(kWide) init_kernel(InitArgs a) {
  const long long cnt = a.words[4];
  const long long tile = columba::take_tile(a.sa);
  // bit j of live / nar: item j is live / narrow (masks, not per-item
  // booleans: see scan_flags)
  unsigned live = 0, nar = 0;
  unsigned long long ex[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = columba::item_lane<kWide, kItems>(tile, j);
    if (i < a.L) {
      const long long* r = a.ranges0 + i * a.rw;
      const long long lo = r[0], hi = r[1];
      const long long w = hi - lo;
      const bool n = a.switchpoint > 0 && w > 0 && w <= a.switchpoint;
      if (n) nar |= 1u << j;
      else if (hi > lo) live |= 1u << j;
    }
  }
  unsigned long long end;
  columba::scan_flags<kWide, kItems>(live, nar, ex, tile, a.sa, end);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = columba::item_lane<kWide, kItems>(tile, j);
    const long long p = static_cast<long long>(ex[j] & 0xFFFFFFFFull);
    const long long q = cnt + static_cast<long long>(ex[j] >> 32);
    // L < 2^32 (the entry checks it): a 32-bit remainder, inline
    const long long src =
        a.per_lane ? i
                   : static_cast<long long>(static_cast<unsigned>(i) %
                                            static_cast<unsigned>(a.S));
    if (((nar >> j) & 1u) && q < a.M) {
      const long long* r = a.ranges0 + i * a.rw;
      long long* row = a.itv + 4 * q;
      row[0] = r[0];
      row[1] = r[1];
      row[2] = i;
      row[3] = a.db_exact[src];
    }
    if (((live >> j) & 1u) && p < a.C) {
      const long long* r = a.ranges0 + i * a.rw;
      for (int k = 0; k < a.rw; ++k) a.o_ranges[p * a.rw + k] = r[k];
      a.o_ids[p] = static_cast<int>(i);
      const signed char* b = a.band_init + src * 2 * a.bw;
      for (int k = 0; k < 2 * a.bw; ++k) a.o_band[p * 2 * a.bw + k] = b[k];
      signed char* cm = a.o_colmin + p * 2 * a.Wp;
      for (int sd = 0; sd < 2; ++sd)
        for (int k = 0; k < a.Wp; ++k)
          cm[sd * a.Wp + k] =
              k < a.W ? a.colmin_init[(src * 2 + sd) * a.W + k] : 0;
    }
  }
  if (tile == gridDim.x - 1 && threadIdx.x == 0) {
    const long long n = static_cast<long long>(end & 0xFFFFFFFFull);
    const long long rows = cnt + static_cast<long long>(end >> 32);
    a.words[0] = min(n, a.C) | (min(rows, a.M) << 32);
    a.words[2] += n > a.C ? n - a.C : 0;
    a.words[5] = n;
  }
}

struct ExArgs {
  long long* ranges0;           // (L, rw)
  long long L;
  int rw;
  long long EC;
  long long* r2;                // (EC, rw): ex_compact's out, ex_back's in
  int* src;                     // (EC,)
  int* slot;                    // (L,) a lane's slot, or -1
  long long* drows0;            // (L, 4) (ex_back)
  const long long* dr2;         // (EC, 4) (ex_back)
  long long* words;
  columba::ScanArgs sa;
};

__global__ void __launch_bounds__(kWide) ex_compact_kernel(ExArgs a) {
  const long long tile = columba::take_tile(a.sa);
  unsigned keep = 0;                  // bit j: item j is live
  unsigned long long p[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = columba::item_lane<kWide, kItems>(tile, j);
    if (i < a.L && a.ranges0[i * a.rw + 1] > a.ranges0[i * a.rw])
      keep |= 1u << j;
  }
  unsigned long long end;
  columba::scan_flags<kWide, kItems>(keep, 0u, p, tile, a.sa, end);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = columba::item_lane<kWide, kItems>(tile, j);
    if (i >= a.L) continue;
    const long long q = static_cast<long long>(p[j]);
    const bool in = ((keep >> j) & 1u) && q < a.EC;
    a.slot[i] = in ? static_cast<int>(q) : -1;
    if (in) {
      for (int k = 0; k < a.rw; ++k)
        a.r2[q * a.rw + k] = a.ranges0[i * a.rw + k];
      a.src[q] = static_cast<int>(i);
    }
  }
  if (tile == gridDim.x - 1 && threadIdx.x == 0) {
    const long long n = static_cast<long long>(end);
    a.words[2] += n > a.EC ? n - a.EC : 0;
  }
}

__global__ void __launch_bounds__(kThreads) ex_back_kernel(ExArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= a.L) return;
  const int s = a.slot[i];
  long long* o = a.ranges0 + i * a.rw;
  for (int k = 0; k < a.rw; ++k) o[k] = s >= 0 ? a.r2[s * a.rw + k] : 0;
  if (s >= 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) a.drows0[4 * i + k] = a.dr2[4 * s + k];
  }
}

struct TailArgs {
  columba::TailRows t;          // the frontier's rows and J's outputs
  long long cap;
  long long* itv;
  long long M;
  long long* words;
  long long shrink;
  columba::ScanArgs sa;
};

__global__ void __launch_bounds__(kThreads) tail_kernel(TailArgs a) {
  const long long cnt = static_cast<long long>(
      static_cast<unsigned long long>(a.words[0]) >> 32);
  const long long tile = columba::take_tile(a.sa);
  const long long i = tile * kThreads + threadIdx.x;
  columba::TailRow r{0, 0, 0, 0, 0u, -1, false, false};
  if (i < a.cap) {
    r = columba::tail_read(a.t, i);
    columba::tail_write(a.t, i, r);
  }
  const bool ghost = r.id < 0;
  unsigned long long end;
  const long long q = cnt + static_cast<long long>(columba::scan_tiles<
      kThreads>(ghost ? 1ull : 0ull, tile, a.sa, end));
  if (ghost && q < a.M) columba::ghost_row(a.itv, q, r);
  if (tile == gridDim.x - 1 && threadIdx.x == 0) {
    a.words[6] = min(cnt + static_cast<long long>(end), a.M);
    a.words[7] = a.words[2] + a.shrink;
  }
}

// tiles of `tile` lanes over n lanes (at least one)
inline unsigned tiles_of(long long n, long long tile) {
  return static_cast<unsigned>(n < 1 ? 1 : (n + tile - 1) / tile);
}

inline unsigned grid_of(long long n) { return tiles_of(n, kThreads); }

inline columba::ScanArgs scan_args(long long* ticket, long long* status,
                                   unsigned epoch) {
  return columba::ScanArgs{reinterpret_cast<unsigned long long*>(ticket),
                           reinterpret_cast<unsigned long long*>(status),
                           epoch};
}

inline int launched() { return static_cast<int>(cudaGetLastError()); }

inline bool bad_scan(long long n, long long tile, long long tiles,
                     unsigned epoch) {
  return tiles_of(n, tile) > tiles || epoch == 0 || epoch > 0x3FFFFFFFu;
}

}  // namespace

// clears: n_clears rows of (device pointer, bytes, byte value) in host
// memory; full: the rw values of the full range in host memory.
extern "C" int columba_frontier_seed(
    const unsigned char* reads, long long R, int m, int S, int K,
    const long long* table, const int* kstart, const bool* mask,
    const long long* full, int rw, int zero_empty, long long* ranges,
    const long long* clears, int n_clears, cudaStream_t stream) {
  if (rw < 1 || rw > kMaxRW || n_clears < 0 || n_clears > kMaxClears ||
      S < 1 || (K > 0 && table == nullptr) || K > 15)
    return static_cast<int>(cudaErrorInvalidValue);
  SeedArgs a;
  a.reads = reads;
  a.L = R * S;
  a.m = m;
  a.S = S;
  a.K = K;
  a.table = table;
  a.kstart = kstart;
  a.mask = mask;
  for (int k = 0; k < kMaxRW; ++k) a.full[k] = k < rw ? full[k] : 0;
  a.rw = rw;
  a.zero_empty = zero_empty;
  a.ranges = ranges;
  a.n_clears = n_clears;
  long long most = a.L;
  for (int c = 0; c < n_clears; ++c) {
    a.clears[c].p = reinterpret_cast<void*>(clears[3 * c]);
    a.clears[c].n = clears[3 * c + 1];
    a.clears[c].v = static_cast<int>(clears[3 * c + 2]);
    if (a.clears[c].n / 16 > most) most = a.clears[c].n / 16;
  }
  long long blocks = (most + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  if (blocks < 1) return 0;
  seed_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(a);
  return launched();
}

extern "C" int columba_frontier_drain(const long long* drows, long long L,
                                      long long* itv, long long M,
                                      long long* words, long long* ticket,
                                      long long* status, long long tiles,
                                      unsigned epoch, cudaStream_t stream) {
  if (bad_scan(L, kTile, tiles, epoch) || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DrainArgs a{drows, L, itv, M, words, scan_args(ticket, status, epoch)};
  drain_kernel<<<tiles_of(L, kTile), kWide, 0, stream>>>(a);
  return launched();
}

extern "C" int columba_frontier_init(
    const long long* ranges0, long long L, int rw, int S, int switchpoint,
    const int* db_exact, const signed char* band_init,
    const signed char* colmin_init, int per_lane, int bw, int W, int Wp,
    long long C, long long* o_ranges, int* o_ids, signed char* o_band,
    signed char* o_colmin, long long* itv, long long M, long long* words,
    long long* ticket, long long* status, long long tiles, unsigned epoch,
    cudaStream_t stream) {
  if (bad_scan(L, kTile, tiles, epoch) || rw < 1 || S < 1 || M < 0 ||
      W < 1 || Wp < W || L >= (1LL << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  InitArgs a{ranges0, L, rw, S, switchpoint, db_exact, band_init,
             colmin_init, per_lane, bw, W, Wp, C, o_ranges, o_ids, o_band,
             o_colmin, itv, M, words, scan_args(ticket, status, epoch)};
  init_kernel<<<tiles_of(L, kTile), kWide, 0, stream>>>(a);
  return launched();
}

extern "C" int columba_frontier_ex_compact(
    long long* ranges0, long long L, int rw, long long EC, long long* r2,
    int* src, int* slot, long long* words, long long* ticket,
    long long* status, long long tiles, unsigned epoch, cudaStream_t stream) {
  if (bad_scan(L, kTile, tiles, epoch) || rw < 2 || EC < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  ExArgs a{ranges0, L, rw, EC, r2, src, slot, nullptr, nullptr, words,
           scan_args(ticket, status, epoch)};
  ex_compact_kernel<<<tiles_of(L, kTile), kWide, 0, stream>>>(a);
  return launched();
}

extern "C" int columba_frontier_ex_back(long long* ranges0, long long L,
                                        int rw, const long long* r2,
                                        const int* slot, long long* drows0,
                                        const long long* dr2,
                                        cudaStream_t stream) {
  if (rw < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (L < 1) return 0;
  ExArgs a{ranges0, L, rw, 0, const_cast<long long*>(r2), nullptr,
           const_cast<int*>(slot), drows0, dr2, nullptr,
           columba::ScanArgs{nullptr, nullptr, 0}};
  ex_back_kernel<<<grid_of(L), kThreads, 0, stream>>>(a);
  return launched();
}

extern "C" int columba_frontier_tail(
    long long* ranges, int* ids, signed char* band, signed char* colmin,
    long long cap, long long live, int moved, int rw, int bw, int W, int Wp,
    int track, int S, const long long* final_reg, const long long* u_last64,
    const int* u_last32, long long* itv, long long M, long long* words,
    long long shrink, long long* rid, long long* sid, long long* ed_lb,
    bool* done, signed char* arg_b, long long* ticket, long long* status,
    long long tiles, unsigned epoch, cudaStream_t stream) {
  if (bad_scan(cap, kThreads, tiles, epoch) || rw < 2 || S < 1 || M < 0 ||
      W < 1 || Wp < W || (u_last64 == nullptr) == (u_last32 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  TailArgs a{columba::TailRows{ranges, ids, band, colmin, live, moved, rw,
                               bw, W, Wp, track, S, final_reg, u_last64,
                               u_last32, rid, sid, ed_lb, done, arg_b},
             cap, itv, M, words, shrink, scan_args(ticket, status, epoch)};
  tail_kernel<<<grid_of(cap), kThreads, 0, stream>>>(a);
  return launched();
}
