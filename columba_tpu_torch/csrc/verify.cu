// Kernel D: fused text-window fetch + banded semi-global verification.
//
// Replaces columba_tpu/ops/verify.py gather_window + verify_window. Each
// thread verifies one candidate: it aligns its whole read against the text
// window [start, start + m + 3kb + 1) with the band of 4kb+1 cells held in
// registers, free start over the first 2kb+1 columns, and writes the final
// row. kb is a template parameter for kb 0..4 (kb = 0, a band of one cell,
// is what every k = 0 scheme pass and every Hamming run verifies with); any
// larger kb up to 13 runs the same body with a runtime kb and arrays sized
// for the maximum (KB = -1), which live in local memory: slower, and exact.
// Window codes come straight from the flat packed text words; a position
// outside [0, n) reads as 4 (mismatches all), and starts below 0 are plain
// negative int64.
//
// Bound: m rows x (4kb+1) cells of integer min-plus per candidate, i.e.
// arithmetic in registers; the text words and read bytes it reads are a few
// hundred bytes per candidate and stay in L1. The window codes slide through
// a register buffer, so each row fetches one new text char.
#include "common.cuh"

namespace {

__device__ __forceinline__ int text_code(const uint32_t* __restrict__ text,
                                         long long n, long long pos) {
  if (pos < 0 || pos >= n) return 4;
  return static_cast<int>((__ldg(text + (pos >> 4)) >> (2 * (pos & 15))) &
                          3u);
}

constexpr int kMaxKB = 13;   // ladder cutoff 13 (BEST_CUTOFF)

// KBT >= 0: band radius fixed at compile time. KBT < 0: the generic entry.
template <int KBT>
__global__ void verify_kernel(const uint32_t* __restrict__ text, long long n,
                              const uint8_t* __restrict__ patterns, int m,
                              const long long* __restrict__ rid,
                              const long long* __restrict__ win_start,
                              int kb, int* __restrict__ out, long long B) {
  constexpr bool kGeneric = KBT < 0;
  constexpr int BWMAX = 4 * (kGeneric ? kMaxKB : KBT) + 1;
  const int KB = kGeneric ? kb : KBT;
  const int BW = 4 * KB + 1;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= B) return;
  const uint8_t* pat = patterns + rid[i] * m;
  const long long start = win_start[i];
  // wc[a] = window column (j + a - KB) of row j; columns < 0 are the kb
  // padding cells in front of the window (code 4)
  int wc[BWMAX], D[BWMAX];
#pragma unroll
  for (int a = 0; a < BW; ++a) {
    wc[a] = a < KB ? 4 : text_code(text, n, start + a - KB);
    D[a] = (a >= KB && a <= 3 * KB) ? 0 : columba::INF;
  }
  for (int j = 0; j < m; ++j) {
    const int pc = __ldg(pat + j);
    int nl[BWMAX];
#pragma unroll
    for (int a = 0; a < BW; ++a) {
      const int mis = (wc[a] != pc || wc[a] > 3 || pc > 3) ? 1 : 0;
      const int up = (a + 1 < BW ? D[a + 1] : columba::INF) + 1;
      nl[a] = min(D[a] + mis, up);
    }
    int d = nl[0];
    D[0] = min(d, columba::INF);
#pragma unroll
    for (int a = 1; a < BW; ++a) {
      d = min(nl[a], d + 1);
      D[a] = min(d, columba::INF);
    }
#pragma unroll
    for (int a = 0; a + 1 < BW; ++a) wc[a] = wc[a + 1];
    const int col = j + BW - KB;   // window column entering at row j + 1
    wc[BW - 1] = col < 0 ? 4 : text_code(text, n, start + col);
  }
#pragma unroll
  for (int a = 0; a < BW; ++a) out[i * BW + a] = D[a];
}

template <int KBT>
void launch(const uint32_t* text, long long n, const uint8_t* patterns, int m,
            const long long* rid, const long long* ws, int kb, int* out,
            long long B, cudaStream_t stream) {
  constexpr int kThreads = 128;
  verify_kernel<KBT><<<columba::grid_for(B, kThreads), kThreads, 0, stream>>>(
      text, n, patterns, m, rid, ws, kb, out, B);
}

}  // namespace

extern "C" int columba_verify(const int* text_words, long long n,
                              const unsigned char* patterns, int m,
                              const long long* rid, const long long* ws,
                              int kb, int* out, long long B,
                              cudaStream_t stream) {
  const auto* text = reinterpret_cast<const uint32_t*>(text_words);
  if (kb < 0 || kb > kMaxKB) return static_cast<int>(cudaErrorInvalidValue);
  switch (kb) {
    case 0: launch<0>(text, n, patterns, m, rid, ws, kb, out, B, stream); break;
    case 1: launch<1>(text, n, patterns, m, rid, ws, kb, out, B, stream); break;
    case 2: launch<2>(text, n, patterns, m, rid, ws, kb, out, B, stream); break;
    case 3: launch<3>(text, n, patterns, m, rid, ws, kb, out, B, stream); break;
    case 4: launch<4>(text, n, patterns, m, rid, ws, kb, out, B, stream); break;
    default:
      launch<-1>(text, n, patterns, m, rid, ws, kb, out, B, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
