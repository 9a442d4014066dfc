// Device functions shared by the port's kernels: rank over one fused 64 B
// occ row, the bidirectional extension of one lane on the Vanilla FM-index
// (FmLane), and the RLC move table's parameters and row reads.
//
// Counterparts of columba_tpu/ops/rank.py (occ_all, occ_all_and_char) and
// columba_tpu/ops/extend.py (extend_all). All interval arithmetic is
// uint32, exactly as in the JAX package; the host passes int64 tensors
// whose values are uint32. Kernels A and B are templated on the lane width
// RW (4: Vanilla; 8: RLC; 12: RLC with toeholds, textless); every kernel
// takes FmLane on the Vanilla index and the four-lane RLC step of
// bm_quad.cuh (columba_tpu/ops/bextend.py) on the RLC index.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace columba {

constexpr int INF = 63;  // band infinity (search/schedule.py INF)

struct FmParams {
  const uint32_t* occ;   // (2*blocks, 16): [4 ckpt | 8 BWT words | 4 pad]
  long long blocks;      // blocks per direction; rev rows start here
  uint32_t counts[4];    // first SA row of A, C, G, T
  uint32_t dollar[2];    // '$' row in the forward / reverse BWT
};

// occ of A,C,G,T before in-block offset `off` of fused row `row` ('$'
// counted as A); optionally the 2-bit code at that offset. One row read:
// three 16 B loads (checkpoints + 8 words; the pad is never read).
__device__ __forceinline__ void occ_row(const uint32_t* __restrict__ occ,
                                        long long row, uint32_t off,
                                        uint32_t occ4[4],
                                        uint32_t* code = nullptr) {
  const uint4* r = reinterpret_cast<const uint4*>(occ + row * 16);
  const uint4 ck = __ldg(r);
  const uint4 wa = __ldg(r + 1);
  const uint4 wb = __ldg(r + 2);
  const uint32_t w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
  occ4[0] = ck.x;
  occ4[1] = ck.y;
  occ4[2] = ck.z;
  occ4[3] = ck.w;
  const uint32_t pat[4] = {0x00000000u, 0x55555555u, 0xAAAAAAAAu,
                           0xFFFFFFFFu};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int r2 = static_cast<int>(off) - 16 * i;
    r2 = r2 < 0 ? 0 : (r2 > 16 ? 16 : r2);
    const uint32_t mask = r2 >= 16 ? 0xFFFFFFFFu : ((1u << (2 * r2)) - 1u);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t nx = ~(w[i] ^ pat[c]);
      occ4[c] += __popc(nx & (nx >> 1) & 0x55555555u & mask);
    }
  }
  if (code != nullptr) {
    uint32_t sel = w[0];
#pragma unroll
    for (int i = 1; i < 8; ++i) sel = ((off >> 4) == uint32_t(i)) ? w[i] : sel;
    *code = (sel >> (2 * (off & 15))) & 3u;
  }
}

// Children of range pair [f_lo, f_hi, r_lo, r_hi) for the 4 chars, extending
// backward (dir 0, forward BWT) or forward (dir 1, reverse BWT). Two row
// reads serve all four children; the synchronized side comes from the '$'
// count plus an exclusive cumsum of the occ differences.
__device__ __forceinline__ void extend_lane(const FmParams& p, uint32_t f_lo,
                                            uint32_t f_hi, uint32_t r_lo,
                                            uint32_t r_hi, int dir,
                                            uint32_t out[4][4]) {
  const bool bwd = dir == 0;
  const uint32_t a_lo = bwd ? f_lo : r_lo;
  const uint32_t a_hi = bwd ? f_hi : r_hi;
  const uint32_t b_lo = bwd ? r_lo : f_lo;
  const long long base = bwd ? 0 : p.blocks;
  const uint32_t drow = bwd ? p.dollar[0] : p.dollar[1];
  uint32_t ol[4], oh[4];
  occ_row(p.occ, base + (a_lo >> 7), a_lo & 127u, ol);
  occ_row(p.occ, base + (a_hi >> 7), a_hi & 127u, oh);
  const uint32_t dl = drow < a_lo ? 1u : 0u;
  const uint32_t dh = drow < a_hi ? 1u : 0u;
  ol[0] -= dl;
  oh[0] -= dh;
  uint32_t cum_lo = dl, cum_hi = dh;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t na_lo = p.counts[c] + ol[c];
    const uint32_t na_hi = p.counts[c] + oh[c];
    const uint32_t width = na_hi - na_lo;
    const uint32_t nb_lo = b_lo + (cum_hi - cum_lo);
    out[c][0] = bwd ? na_lo : nb_lo;
    out[c][1] = bwd ? na_hi : nb_lo + width;
    out[c][2] = bwd ? nb_lo : na_lo;
    out[c][3] = bwd ? nb_lo + width : na_hi;
    cum_lo += ol[c];
    cum_hi += oh[c];
  }
}

__host__ __forceinline__ FmParams fm_params(const int* occ, long long blocks,
                                            unsigned c0, unsigned c1,
                                            unsigned c2, unsigned c3,
                                            unsigned d0, unsigned d1) {
  FmParams p;
  p.occ = reinterpret_cast<const uint32_t*>(occ);
  p.blocks = blocks;
  p.counts[0] = c0;
  p.counts[1] = c1;
  p.counts[2] = c2;
  p.counts[3] = c3;
  p.dollar[0] = d0;
  p.dollar[1] = d1;
  return p;
}

// ---------------------------------------------------------------------------
// RLC (b-move) index: one 80 B fused row per BWT run, five 16 B words:
//   w0 START END LF_POS LF_RUN | w1 CHAR SA_FIRST SA_LAST pad |
//   w2 NEXT[4] | w3 PREV[4] | w4 CUM[4]
// (index/bmove.py). The reverse table's rows start at r_fwd + 1; row R of
// each table is a sentinel [big, big).
// ---------------------------------------------------------------------------

constexpr int BM_NCOLS = 20;

struct BmParams {
  const uint32_t* fused;   // (r_fwd + r_rev + 2, 20)
  uint32_t r_fwd, r_rev;
  uint32_t first[4];       // first F-column row of A, C, G, T
  uint32_t n;
};

__host__ __forceinline__ BmParams bm_params(const int* fused, unsigned r_fwd,
                                            unsigned r_rev, unsigned f0,
                                            unsigned f1, unsigned f2,
                                            unsigned f3, unsigned n) {
  BmParams p;
  p.fused = reinterpret_cast<const uint32_t*>(fused);
  p.r_fwd = r_fwd;
  p.r_rev = r_rev;
  p.first[0] = f0;
  p.first[1] = f1;
  p.first[2] = f2;
  p.first[3] = f3;
  p.n = n;
  return p;
}

// One 16 B word of a row, or one 4 B column (an LF-run read needs LF_RUN
// only, not the row).
__device__ __forceinline__ uint4 bm_word(const BmParams& p, long long row,
                                         int w) {
  return __ldg(reinterpret_cast<const uint4*>(p.fused + row * BM_NCOLS) + w);
}
__device__ __forceinline__ uint32_t bm_col(const BmParams& p, long long row,
                                           int col) {
  return __ldg(p.fused + row * BM_NCOLS + col);
}

// Vanilla lane: extend_lane's four children, ready after init.
struct FmLane {
  uint32_t ch[4][4];
  __device__ __forceinline__ void init(const FmParams& fm, const BmParams&,
                                       const uint32_t* r, int dir) {
    extend_lane(fm, r[0], r[1], r[2], r[3], dir, ch);
  }
  __device__ __forceinline__ uint32_t pos(int c, int k) const {
    uint32_t v = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) v = s == c ? ch[s][k] : v;
    return v;
  }
};

// child c of a Vanilla lane into `o`: its interval
__device__ __forceinline__ void fm_child(const FmLane& lane, int c,
                                         uint32_t* o) {
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = lane.pos(c, k);
}

// ---------------------------------------------------------------------------
// Order-keeping compaction across blocks: a block scan of each block's
// values, then a decoupled look-back over tiles (kernel B and kernels I-L).
// A block takes its tile from an atomic ticket, not from blockIdx, so it
// only ever waits on tiles whose blocks are already running. A tile's
// status is two words, [flag 2 | epoch 30 | count 32] each, stamped with
// the launch's epoch (1 .. 2^30 - 1), so nothing is cleared between
// launches; the block with the last ticket resets the ticket. The two
// words carry two 32-bit counts (kernel B: kept children and narrow rows;
// kernel I: live lanes and narrow lanes) or the low and high halves of one
// 64-bit sum (kernel K's widths): each is added up on its own, and the
// halves recombine exactly.
// ---------------------------------------------------------------------------

constexpr unsigned long long kAggregate = 1ull << 62;
constexpr unsigned long long kPrefix = 2ull << 62;

__device__ __forceinline__ unsigned long long stamp(unsigned long long flag,
                                                    unsigned epoch,
                                                    unsigned count) {
  return flag | (static_cast<unsigned long long>(epoch) << 32) | count;
}

__device__ __forceinline__ void publish(unsigned long long* st, long long tile,
                                        unsigned long long flag,
                                        unsigned epoch, unsigned kept,
                                        unsigned narrow) {
  volatile unsigned long long* s = st + 2 * tile;
  s[0] = stamp(flag, epoch, kept);
  s[1] = stamp(flag, epoch, narrow);
}

// Warp 0's look-back: the two counts of every tile before `tile`, 32 tiles
// a round: lane j reads tile base - j, waiting until both its words carry
// this epoch and the same flag (its block writes them one after the
// other; a tile before tile 0 reads as an empty prefix). The round adds
// the tiles up to the nearest one that holds an inclusive prefix, and ends
// the walk there; without one it adds all 32 and goes on.
__device__ __forceinline__ void look_back(const unsigned long long* st,
                                          long long tile, unsigned epoch,
                                          unsigned long long& kept,
                                          unsigned long long& narrow) {
  const int lane_id = threadIdx.x & 31;
  const volatile unsigned long long* s = st;
  kept = narrow = 0;
  for (long long base = tile - 1;; base -= 32) {
    const long long j = base - lane_id;
    unsigned long long a = kPrefix, b = kPrefix;
    while (j >= 0) {
      a = s[2 * j];
      b = s[2 * j + 1];
      if (((a >> 32) & 0x3FFFFFFFu) == epoch &&
          ((b >> 32) & 0x3FFFFFFFu) == epoch && (a >> 62) != 0 &&
          (a >> 62) == (b >> 62))
        break;
    }
    const unsigned prefixes =
        __ballot_sync(0xFFFFFFFFu, (a >> 62) == 2);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    unsigned long long k = lane_id <= stop ? (a & 0xFFFFFFFFull) : 0;
    unsigned long long n = lane_id <= stop ? (b & 0xFFFFFFFFull) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      k += __shfl_xor_sync(0xFFFFFFFFu, k, d);
      n += __shfl_xor_sync(0xFFFFFFFFu, n, d);
    }
    kept += k;
    narrow += n;
    if (prefixes) return;
  }
}

// What a scanning launch of kernels I-L shares: the ticket word, the tile
// statuses (two words a tile) and the launch's epoch.
struct ScanArgs {
  unsigned long long* ticket;
  unsigned long long* status;
  unsigned epoch;
};

// The block's tile, from the ticket (every thread of the block gets it).
__device__ __forceinline__ long long take_tile(const ScanArgs& sa) {
  __shared__ long long s_tile;
  if (threadIdx.x == 0)
    s_tile = static_cast<long long>(atomicAdd(sa.ticket, 1ull));
  __syncthreads();
  return s_tile;
}

// Warp 0's part of a tile's scan: the tile's `total` published, the
// look-back over the earlier tiles, and the tile's inclusive prefix
// published; returns the sum of the earlier tiles to every lane of warp 0.
// The block with the last ticket resets the ticket (after its return every
// block has taken one).
__device__ __forceinline__ unsigned long long tile_base(
    unsigned long long total, long long tile, const ScanArgs& sa) {
  const int lane_id = threadIdx.x & 31;
  unsigned long long lo = 0, hi = 0;
  if (tile > 0) {
    if (lane_id == 0)
      publish(sa.status, tile, kAggregate, sa.epoch,
              static_cast<unsigned>(total),
              static_cast<unsigned>(total >> 32));
    look_back(sa.status, tile, sa.epoch, lo, hi);
  }
  const unsigned long long base = lo + (hi << 32);
  if (lane_id == 0) {
    const unsigned long long inc = base + total;
    publish(sa.status, tile, kPrefix, sa.epoch, static_cast<unsigned>(inc),
            static_cast<unsigned>(inc >> 32));
    if (tile == gridDim.x - 1) *sa.ticket = 0;
  }
  return base;
}

// Every thread's exclusive prefix of `v` over the whole grid, in tile
// order then thread order: a warp scan, one pass over the warps' sums,
// then warp 0's look-back over the earlier tiles. Sums are 64-bit; a value
// made of two 32-bit counts (x | y << 32) scans both at once as long as
// the x total stays below 2^32. `end` is the inclusive prefix at the
// tile's end: the grand total in the block with the last ticket. One lane
// a thread (kernel J's tail). Call once a launch, with every thread of the
// block.
template <int kThreads>
__device__ __forceinline__ unsigned long long scan_tiles(
    unsigned long long v, long long tile, const ScanArgs& sa,
    unsigned long long& end) {
  constexpr int kWarps = kThreads / 32;
  __shared__ unsigned long long s_warp[kWarps];
  __shared__ unsigned long long s_base, s_total;
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long u = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane_id >= d) x += u;
  }
  if (lane_id == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned long long total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_warp[w];
    const unsigned long long base = tile_base(total, tile, sa);
    if (lane_id == 0) {
      s_base = base;
      s_total = total;
    }
  }
  __syncthreads();
  unsigned long long before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? s_warp[w] : 0ull;
  end = s_base + s_total;
  return s_base + before + x - v;
}

// ---------------------------------------------------------------------------
// The multi-lane form (kernels I and K): a tile of kThreads * kItems lanes
// (512 x 2 there), so that a launch over about 100,000 lanes has about a
// hundred tiles, one block an SM in one wave, and its look-back waits on
// at most a few rounds of 32 tiles (the one-lane form of 256: up to 12).
// More lanes a thread make fewer tiles but a longer serial chain on each
// thread, on fewer SMs: 8 lanes a thread (48 tiles) timed slower than one
// (kernel I's notes). Warp w of the block
// holds the tile's lanes [w * 32 * kItems, (w + 1) * 32 * kItems) in
// kItems rounds of 32 consecutive lanes (item j of lane l is lane
// j * 32 + l of the warp's run), so that every load and store of a round
// is one coalesced access of the warp. Lane order is kept: the prefix of
// an item is the tile's base, the warps before, the rounds before and the
// lanes before in its round.
// ---------------------------------------------------------------------------

// Lane index of the thread's item j in tile `tile`.
template <int kThreads, int kItems>
__device__ __forceinline__ long long item_lane(long long tile, int j) {
  return (tile * kThreads + (threadIdx.x & ~31)) * kItems + j * 32 +
         (threadIdx.x & 31);
}

// The block's part after the warps' runs: the warp sums `run` (lane 0's
// counts) combined across the block and with the earlier tiles; returns
// the sum before the thread's warp and sets `end` as scan_tiles does.
template <int kThreads>
__device__ __forceinline__ unsigned long long warp_runs_base(
    unsigned long long run, long long tile, const ScanArgs& sa,
    unsigned long long& end) {
  constexpr int kWarps = kThreads / 32;
  __shared__ unsigned long long s_warp[kWarps];
  __shared__ unsigned long long s_base, s_total;
  const int lane_id = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane_id == 0) s_warp[warp] = run;
  __syncthreads();
  if (warp == 0) {
    unsigned long long total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_warp[w];
    const unsigned long long base = tile_base(total, tile, sa);
    if (lane_id == 0) {
      s_base = base;
      s_total = total;
    }
  }
  __syncthreads();
  unsigned long long before = s_base;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? s_warp[w] : 0ull;
  end = s_base + s_total;
  return before;
}

// Exclusive prefixes of 64-bit values `v` (item j: lane item_lane(tile, j))
// over the whole grid, into `ex`; `end` as in scan_tiles. A warp scan a
// round (kernel K's widths). Call once a launch, with every thread.
template <int kThreads, int kItems>
__device__ __forceinline__ void scan_items(
    const unsigned long long (&v)[kItems], unsigned long long (&ex)[kItems],
    long long tile, const ScanArgs& sa, unsigned long long& end) {
  const int lane_id = threadIdx.x & 31;
  unsigned long long run = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    unsigned long long x = v[j];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long u = __shfl_up_sync(0xFFFFFFFFu, x, d);
      if (lane_id >= d) x += u;
    }
    ex[j] = run + x - v[j];
    run += __shfl_sync(0xFFFFFFFFu, x, 31);
  }
  const unsigned long long before = warp_runs_base<kThreads>(run, tile, sa,
                                                             end);
#pragma unroll
  for (int j = 0; j < kItems; ++j) ex[j] += before;
}

// The same for two 0/1 flags an item, given as bit masks (bit j of `fx`
// and of `fy`: item j's flags) and counted apart by ballots: `ex` holds
// each item's two exclusive counts as x | y << 32, `end` the totals so
// (kernel I's and L's compactions; the x total must stay below 2^32). Masks, not
// per-item booleans, carry the flags across the look-back: ptxas keeps
// them in one register each, where per-item predicates spilled to local
// memory (seen at 8 items a thread).
template <int kThreads, int kItems>
__device__ __forceinline__ void scan_flags(
    unsigned fx, unsigned fy, unsigned long long (&ex)[kItems],
    long long tile, const ScanArgs& sa, unsigned long long& end) {
  const unsigned below = (1u << (threadIdx.x & 31)) - 1u;
  unsigned rx = 0, ry = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const unsigned mx = __ballot_sync(0xFFFFFFFFu, (fx >> j) & 1u);
    const unsigned my = __ballot_sync(0xFFFFFFFFu, (fy >> j) & 1u);
    ex[j] = (rx + __popc(mx & below)) |
            (static_cast<unsigned long long>(ry + __popc(my & below)) << 32);
    rx += __popc(mx);
    ry += __popc(my);
  }
  const unsigned long long before = warp_runs_base<kThreads>(
      rx | (static_cast<unsigned long long>(ry) << 32), tile, sa, end);
#pragma unroll
  for (int j = 0; j < kItems; ++j) ex[j] += before;
}

// Zero-fills (or fills with one byte value) a device region, 16 B stores
// where the region allows, thread t of `stride` threads.
__device__ __forceinline__ void fill_bytes(void* p, long long n, int v,
                                           long long t, long long stride) {
  unsigned char* b = static_cast<unsigned char*>(p);
  const unsigned w = 0x01010101u * static_cast<unsigned char>(v);
  const long long head =
      min(n, static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(b) &
                                           15)) & 15));
  for (long long i = t; i < head; i += stride) b[i] = static_cast<unsigned char>(v);
  uint4* q = reinterpret_cast<uint4*>(b + head);
  const long long n16 = (n - head) >> 4;
  for (long long i = t; i < n16; i += stride) q[i] = make_uint4(w, w, w, w);
  for (long long i = head + (n16 << 4) + t; i < n; i += stride)
    b[i] = static_cast<unsigned char>(v);
}

// The same over the whole grid.
__device__ __forceinline__ void fill_bytes(void* p, long long n, int v) {
  fill_bytes(p, n, v,
             blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x,
             static_cast<long long>(gridDim.x) * blockDim.x);
}

inline unsigned grid_for(long long n, int threads) {
  return static_cast<unsigned>((n + threads - 1) / threads);
}

}  // namespace columba
