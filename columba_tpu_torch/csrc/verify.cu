// Kernel D: fused text-window fetch + banded semi-global verification.
//
// Replaces columba_tpu/ops/verify.py gather_window + verify_window. Each
// thread verifies one candidate: it aligns its whole read against the text
// window [start, start + m + 3kb + 1) with a band of 4kb+1 cells (free start
// over the first 2kb+1 columns, free end) and writes the final row, every
// cell clamped at INF = 63, bit-identical to ops/verify.py's plain version.
//
// Bound: per row, the scalar recurrence costs about 8 integer operations a
// cell (bounds.verify counts them), so a scalar body is bound by arithmetic
// that grows with the band, and from kb 5 up it kept the band in local
// memory. This body is one for every kb 0..13: the band is one machine
// word (32 bits up to kb 7, 64 above; template NW, the band's 32-bit
// words, 0 for kb 0), and a row costs a fixed ~25 word operations
// whatever kb is.
//
// Design.
// - Bit-vector band (Myers, J. ACM 46(3), 1999, in the banded, diagonal
//   layout): cell a of row j is window column j + a - kb, so the band needs
//   no shift from row to row. A row keeps the horizontal deltas
//   D[a] - D[a-1] in {-1, 0, +1} as two masks (hp, hn) and the value d0 of
//   cell kb. The diagonal delta g[a] = D_new[a] - D_old[a] is 0 or 1, and
//   g[a] = 0 iff the text matches, or hn[a+1], or (g[a-1] = 0 and
//   hp[a]): a carry chain, solved by one add.
// - Exactness at the edges. Every cell is clamped at 63 after every row in
//   the scalar recurrence; min-plus with non-negative steps commutes with
//   that clamp, so the final row is min(unclamped DP, 63). Row 0 is set
//   directly: cells kb..3kb hold their mismatch, the cells right of them
//   rise by one a cell (the scalar recurrence's horizontal step out of
//   the INF starts), the INF cells left of them become a ramp kb - a.
//   Paths from the ramp cost strictly more than the vertical path from
//   the free start at column -1, so they change no reachable cell; a cell
//   no free start reaches (column < -1 in the final row, only when m <
//   kb) is written as INF. The right edge's INF "up" input is never below
//   the band's own paths once clamped, so it is left out.
// - The window is read once: every 32 rows a thread loads the packed text
//   words it spans (2NW + 3 of them, L1 hits after the first) and splits
//   their 2-bit codes into a low-bit, a high-bit and a valid plane (a
//   position outside [0, n) or in the kb padding before the window is
//   code 4 and matches nothing), and the read's 32 bytes, 4 B at a time.
//   A row's match mask is three funnel shifts of the planes against the
//   read's char; a read N (any byte above 3) matches nothing. (A byte load
//   a row instead tripled the time once the output tile took the L1's
//   share.)
// - kb = 0 (every k = 0 scheme pass and every Hamming run) is the
//   mismatch count along one diagonal: 32 rows at once, the read packed
//   into the same planes four bytes at a time, one popcount.
// - The final row is rebuilt from d0 and the delta masks.
// - Dead slots: the dedup pads its output to capacity with (read 0, window
//   0), and on the paths 54-92 % of the slots are such padding; they copy
//   one row per block (verify_kernel).
// - Output: rows are staged in shared memory and the block's span of the
//   output is written coalesced (a thread's own 4kb+1 cells are 116-212 B
//   apart from its neighbours' at kb 7-13).
#include "common.cuh"

namespace {

constexpr int kMaxKB = 13;   // ladder cutoff 13 (BEST_CUTOFF)

// bits 0, 2, .., 30 of x to bits 0..15
__device__ __forceinline__ uint32_t even_bits(uint32_t x) {
  x &= 0x55555555u;
  x = (x | (x >> 1)) & 0x33333333u;
  x = (x | (x >> 2)) & 0x0F0F0F0Fu;
  x = (x | (x >> 4)) & 0x00FF00FFu;
  return (x | (x >> 8)) & 0x0000FFFFu;
}

// bits 0, 8, 16, 24 of x to bits 0..3
__device__ __forceinline__ uint32_t byte_bits(uint32_t x) {
  x &= 0x01010101u;
  x |= x >> 7;
  x |= x >> 14;
  return x & 0xFu;
}

// bits [lo, hi) of a 32-bit word, both clamped to [0, 32]
__device__ __forceinline__ uint32_t span32(long long lo, long long hi) {
  lo = lo < 0 ? 0 : (lo > 32 ? 32 : lo);
  hi = hi < 0 ? 0 : (hi > 32 ? 32 : hi);
  if (hi <= lo) return 0u;
  const uint32_t below_hi = hi >= 32 ? 0xFFFFFFFFu : ((1u << hi) - 1u);
  return below_hi & ~((1u << lo) - 1u);
}

// NP words of the window's planes: bit t of word p is text position
// q0 + 32p + t, band bit bit0 + 32p + t (valid from band bit kb on).
template <int NP>
struct Planes {
  uint32_t lo[NP], hi[NP], ok[NP];

  __device__ __forceinline__ void load(const uint32_t* __restrict__ text,
                                       long long nwords, long long n,
                                       long long q0, int bit0, int kb) {
    const long long k0 = q0 >> 4;                     // floor
    const uint32_t sh = 2u * static_cast<uint32_t>(q0 & 15);
    uint32_t w[2 * NP + 1];
#pragma unroll
    for (int i = 0; i < 2 * NP + 1; ++i) {
      long long k = k0 + i;
      k = k < 0 ? 0 : (k >= nwords ? nwords - 1 : k);
      w[i] = __ldg(text + k);
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const uint32_t c0 = __funnelshift_r(w[2 * p], w[2 * p + 1], sh);
      const uint32_t c1 = __funnelshift_r(w[2 * p + 1], w[2 * p + 2], sh);
      lo[p] = even_bits(c0) | (even_bits(c1) << 16);
      hi[p] = even_bits(c0 >> 1) | (even_bits(c1 >> 1) << 16);
      const long long q = q0 + 32 * p;
      const long long pad = static_cast<long long>(kb) - (bit0 + 32 * p);
      ok[p] = span32(pad > -q ? pad : -q, n - q);
    }
  }
};

// the word-wide field at bit offset s (0..31) of a plane
template <typename T, int NP>
__device__ __forceinline__ T field(const uint32_t (&x)[NP], int s) {
  if constexpr (sizeof(T) == 4) {
    return __funnelshift_r(x[0], x[1], s);
  } else {
    return static_cast<T>(__funnelshift_r(x[0], x[1], s)) |
           (static_cast<T>(__funnelshift_r(x[1], x[2], s)) << 32);
  }
}

// bytes j0 .. j0 + 31 of a read, four to a word (4 B loads where aligned);
// a byte past the read's end reads as 4
__device__ __forceinline__ void read_words(const uint8_t* __restrict__ pat,
                                           int j0, int m, uint32_t (&rw)[8]) {
  const bool aligned = (reinterpret_cast<uintptr_t>(pat) & 3u) == 0;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const int j = j0 + 4 * g;
    if (aligned && j + 4 <= m) {
      rw[g] = __ldg(reinterpret_cast<const uint32_t*>(pat + j));
    } else {
      uint32_t w = 0u;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        w |= (j + t < m ? static_cast<uint32_t>(__ldg(pat + j + t)) : 4u)
             << (8 * t);
      rw[g] = w;
    }
  }
}

// rows j0 .. j0 + 31 of a read as planes; rv: the row exists and its byte
// is a base (0..3)
__device__ __forceinline__ void read_planes(const uint8_t* __restrict__ pat,
                                            int j0, int m, uint32_t& rl,
                                            uint32_t& rh, uint32_t& rv) {
  rl = rh = rv = 0u;
  uint32_t rw[8];
  read_words(pat, j0, m, rw);
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const uint32_t w = rw[g];
    const uint32_t y = w & 0xFCFCFCFCu;            // nonzero: not a base
    const uint32_t nz = ((y & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | y;
    rl |= byte_bits(w) << (4 * g);
    rh |= byte_bits(w >> 1) << (4 * g);
    rv |= (~byte_bits(nz >> 7) & 0xFu) << (4 * g);
  }
}

// Candidate i's final row into o. T: the band word, uint32_t for kb <= 7,
// unsigned long long for kb 8..13.
template <typename T>
__device__ __forceinline__ void verify_one(
    const uint32_t* __restrict__ text, long long nwords, long long n,
    const uint8_t* __restrict__ patterns, int m,
    const long long* __restrict__ rid, const long long* __restrict__ win_start,
    int kb, long long i, int* __restrict__ o) {
  constexpr int NP = static_cast<int>(sizeof(T) / 4) + 1;
  const int BW = 4 * kb + 1;
  if (m == 0) {                       // the initial row
    for (int a = 0; a < BW; ++a)
      o[a] = (a >= kb && a <= 3 * kb) ? 0 : columba::INF;
    return;
  }
  const uint8_t* pat = patterns + rid[i] * m;
  const long long base = win_start[i] - kb;   // text position of band bit 0

  if (kb == 0) {
    int matches = 0;
    for (int j0 = 0; j0 < m; j0 += 32) {
      Planes<NP> w;
      w.load(text, nwords, n, base + j0, j0, 0);
      uint32_t rl, rh, rv;
      read_planes(pat, j0, m, rl, rh, rv);
      matches += __popc(w.ok[0] & rv & ~(w.lo[0] ^ rl) & ~(w.hi[0] ^ rh));
    }
    o[0] = min(m - matches, columba::INF);
    return;
  }

  const T one = 1;
  const T band = (one << BW) - 1;
  const T to3kb = (one << (3 * kb + 1)) - 1;            // bits 0..3kb
  T hp = 0, hn = 0;
  int d0 = 0;                                           // D[kb]
  for (int j0 = 0; j0 < m; j0 += 32) {
    Planes<NP> w;
    w.load(text, nwords, n, base + j0, j0, kb);
    uint32_t rw[8];
    read_words(pat, j0, m, rw);
#pragma unroll
    for (int s = 0; s < 32; ++s) {
      const int j = j0 + s;
      if (j >= m) break;
      const uint32_t pc = (rw[s >> 2] >> (8 * (s & 3))) & 0xFFu;
      const T pl = (pc & 1u) ? ~T(0) : T(0);
      const T ph = (pc & 2u) ? ~T(0) : T(0);
      T eq = field<T, NP>(w.ok, s) & ~(field<T, NP>(w.lo, s) ^ pl) &
             ~(field<T, NP>(w.hi, s) ^ ph) & band;
      if (pc > 3u) eq = 0;
      if (j == 0) {
        const T em = eq & to3kb & ~((one << kb) - 1);   // bits kb..3kb
        const T mid = to3kb & ~((one << (kb + 1)) - 1); // bits kb+1..3kb
        hp = ((em << 1) & ~em & mid) | (band & ~to3kb);
        hn = (~(em << 1) & em & mid) | (em & (one << kb)) |
             (((one << kb) - 1) & ~one);
        d0 = 1 - static_cast<int>((eq >> kb) & 1);
      } else {
        const T x = eq | (hn >> 1);
        const T p = hp >> 1;
        const T g = ~(x | (((x & p) + p) ^ p)) & band;   // diagonal +1
        const T gs = (g << 1) & band;
        const T up = g & ~gs, dn = gs & ~g;
        const T h0 = ~(hp | hn);
        hp = (hp & ~dn) | (h0 & up);
        hn = (hn & ~up) | (h0 & dn);
        d0 += static_cast<int>((g >> kb) & 1);
      }
    }
  }
  int d = d0;
  for (int a = kb; a < BW; ++a) {
    if (a > kb)
      d += static_cast<int>((hp >> a) & 1) - static_cast<int>((hn >> a) & 1);
    o[a] = min(d, columba::INF);
  }
  d = d0;
  for (int a = kb - 1; a >= 0; --a) {
    d -= static_cast<int>((hp >> (a + 1)) & 1) -
         static_cast<int>((hn >> (a + 1)) & 1);
    o[a] = a < kb - m ? columba::INF : min(d, columba::INF);
  }
}

constexpr int kThreads = 128;

// Slots at or past *live (the dedup's unique count; B without it) hold
// (read 0, window 0) by the caller's contract: a block verifies its first
// such slot once and copies that row to the others, so a dead slot costs
// a copy and not a DP. Every slot's row stays the plain version's. The
// rows go through shared memory (odd stride 4kb+1: no bank conflicts), so
// the block's output, one contiguous span, is written coalesced. NW: the
// band's 32-bit words; NW = 0 is kb 0, an instance of its own so that its
// one-cell tile leaves the L1 its size (the shared-memory carveout follows
// the tile).
template <int NW>
__global__ void __launch_bounds__(kThreads) verify_kernel(
    const uint32_t* __restrict__ text, long long nwords, long long n,
    const uint8_t* __restrict__ patterns, int m,
    const long long* __restrict__ rid, const long long* __restrict__ win_start,
    int kb, const long long* __restrict__ live_ptr, int* __restrict__ out,
    long long B) {
  using T = std::conditional_t<NW == 2, unsigned long long, uint32_t>;
  constexpr int BWMAX = NW == 0 ? 1 : NW == 1 ? 29 : 4 * kMaxKB + 1;
  __shared__ int tile[kThreads * BWMAX];
  const int BW = 4 * kb + 1;
  const long long block0 = blockIdx.x * static_cast<long long>(kThreads);
  const long long i = block0 + threadIdx.x;
  long long live = live_ptr == nullptr ? B : __ldg(live_ptr);
  live = live < 0 ? 0 : (live > B ? B : live);
  const long long dead0 = live > block0 ? live : block0;
  if (i < B && i <= dead0)
    verify_one<T>(text, nwords, n, patterns, m, rid, win_start, kb, i,
                  tile + threadIdx.x * BW);
  __syncthreads();
  const long long left = B - block0;
  const int rows = left < kThreads ? static_cast<int>(left) : kThreads;
  const long long dt = dead0 - block0;                 // first dead thread
  const int dead_t = dt < kThreads ? static_cast<int>(dt) : kThreads;
  int* dst = out + block0 * BW;
  const int q = kThreads / BW, r = kThreads % BW;
  int t = threadIdx.x / BW, a = threadIdx.x % BW;
  for (int e = threadIdx.x; e < rows * BW; e += kThreads) {
    dst[e] = tile[(t > dead_t ? dead_t : t) * BW + a];
    t += q;
    a += r;
    if (a >= BW) {
      a -= BW;
      ++t;
    }
  }
}

}  // namespace

extern "C" int columba_verify(const int* text_words, long long nwords,
                              long long n, const unsigned char* patterns,
                              int m, const long long* rid,
                              const long long* ws, int kb,
                              const long long* live, int* out, long long B,
                              cudaStream_t stream) {
  const auto* text = reinterpret_cast<const uint32_t*>(text_words);
  if (kb < 0 || kb > kMaxKB || nwords < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = columba::grid_for(B, kThreads);
  if (kb == 0)
    verify_kernel<0><<<grid, kThreads, 0, stream>>>(
        text, nwords, n, patterns, m, rid, ws, kb, live, out, B);
  else if (4 * kb + 1 <= 32)
    verify_kernel<1><<<grid, kThreads, 0, stream>>>(
        text, nwords, n, patterns, m, rid, ws, kb, live, out, B);
  else
    verify_kernel<2><<<grid, kThreads, 0, stream>>>(
        text, nwords, n, patterns, m, rid, ws, kb, live, out, B);
  return static_cast<int>(cudaGetLastError());
}
