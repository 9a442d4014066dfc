// Kernel F: greedy dynamic partitioning of a read batch.
//
// Replaces columba_tpu/search/dynschedule.py dynamic_partition: every read
// gets its own part boundaries pts (p + 1 of them). Each of the p parts is
// seeded with the SA range of a short window (a row of the k-mer table, or
// one backward extension of the full range by a single character), and then,
// m - p*K times, the part with the largest weighted range is extended by one
// character, toward its narrower neighbour when both sides are open.
//
// The JAX function is a lockstep scan of m - p*K steps over the batch with
// one-hot selects over all parts. Here one thread owns one read: begins, ends
// and the p ranges live in the thread's own arrays, and it walks all its
// steps inside one launch with extend_lane of common.cuh.
//
// Places where the arithmetic has to agree with the JAX package bit for bit:
//   * widths are uint32 differences clamped to 2^30, and the weighted width
//     is their 32-bit product with the weight, which wraps (a width above
//     2^31 / weight turns negative): taken here in uint32 and reinterpreted;
//   * a part that cannot grow weighs -1; the first maximum wins; when no part
//     can grow nothing changes;
//   * the tie direction compares the neighbours' widths with 2^30 sentinels
//     at both ends of the read;
//   * an empty range stays a candidate with width 0 and is still extended, so
//     a thread does not stop early (unlike kernel E): only pts leave the
//     kernel, but every later choice depends on every range's width.
//
// Bound: latency, as kernel E. A read does m - p*K dependent steps of two
// random 48 B occ-row reads each; the card hides that only across reads.
// Bytes moved: rows x steps x 2 x 48 B, the m chars of each row, the p seed
// rows of the table, and 4(p + 1) B out.
#include "common.cuh"

namespace {

constexpr int kMaxParts = 16;
constexpr uint32_t kWidthCap = 1u << 30;

struct PartArgs {
  columba::FmParams fm;
  const uint8_t* reads;       // (rows, m)
  int m;
  uint32_t n;
  const long long* table;     // (4^K, 4) uint32 values in int64, or null
  int K;
  int p;
  int seeds[kMaxParts];
  int weights[kMaxParts];
  int* pts;                   // (rows, p + 1)
  long long rows;
};

__global__ void dynpart_kernel(PartArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= a.rows) return;
  const uint8_t* rd = a.reads + i * a.m;
  const int p = a.p, m = a.m, K = a.K;
  int begins[kMaxParts], ends[kMaxParts];
  uint32_t rg[kMaxParts][4];

  for (int q = 0; q < p; ++q) {
    begins[q] = a.seeds[q];
    ends[q] = begins[q] + K;
    if (a.table != nullptr) {
      long long code = 0;
      bool bad = false;
      for (int j = 0; j < K; ++j) {
        const int pos = min(max(begins[q] + j, 0), m - 1);
        const int c = __ldg(rd + pos);
        bad = bad || c > 3;
        code = code * 4 + min(c, 3);
      }
      const long long* row = a.table + 4 * code;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        rg[q][k] = bad ? 0u : static_cast<uint32_t>(__ldg(row + k));
    } else {
      const int c = __ldg(rd + min(max(begins[q], 0), m - 1));
      uint32_t ch[4][4];
      columba::extend_lane(a.fm, 0u, a.n + 1u, 0u, a.n + 1u, 0, ch);
#pragma unroll
      for (int k = 0; k < 4; ++k) rg[q][k] = c > 3 ? 0u : ch[c & 3][k];
    }
  }

  const int steps = m - p * K;
  for (int s = 0; s < steps; ++s) {
    int best = 0, best_w = 0;
    bool best_ext = false, best_cl = false, best_cr = false;
    for (int q = 0; q < p; ++q) {
      const uint32_t width = min(rg[q][1] - rg[q][0], kWidthCap);
      const bool cl = begins[q] > (q > 0 ? ends[q - 1] : 0);
      const bool cr = ends[q] < (q + 1 < p ? begins[q + 1] : m);
      const int w = (cl || cr)
          ? static_cast<int>(width * static_cast<uint32_t>(a.weights[q]))
          : -1;
      if (q == 0 || w > best_w) {          // strict: the first maximum
        best = q;
        best_w = w;
        best_ext = cl || cr;
        best_cl = cl;
        best_cr = cr;
      }
    }
    if (!best_ext) continue;               // no part can grow: no change
    const uint32_t wl = best > 0
        ? min(rg[best - 1][1] - rg[best - 1][0], kWidthCap) : kWidthCap;
    const uint32_t wr = best + 1 < p
        ? min(rg[best + 1][1] - rg[best + 1][0], kWidthCap) : kWidthCap;
    const bool go_back = best_cl && (!best_cr || wl < wr);
    const int newpos = go_back ? begins[best] - 1 : ends[best];
    const int c = __ldg(rd + min(max(newpos, 0), m - 1));
    uint32_t ch[4][4];
    columba::extend_lane(a.fm, rg[best][0], rg[best][1], rg[best][2],
                         rg[best][3], go_back ? 0 : 1, ch);
#pragma unroll
    for (int k = 0; k < 4; ++k) rg[best][k] = c > 3 ? 0u : ch[c & 3][k];
    if (go_back) {
      begins[best] -= 1;
    } else {
      ends[best] += 1;
    }
  }

  // boundaries: each part begins where it grew to; gaps close to the right
  int* o = a.pts + i * (p + 1);
  o[0] = 0;
  for (int q = 1; q < p; ++q) o[q] = begins[q];
  o[p] = m;
}

}  // namespace

// seeds and weights are host arrays of p ints; they travel in the kernel's
// argument block.
extern "C" int columba_dynpart(const int* occ, long long blocks, unsigned c0,
                               unsigned c1, unsigned c2, unsigned c3,
                               unsigned d0, unsigned d1,
                               const unsigned char* reads, int m, long long n,
                               const long long* table, int K,
                               const int* seeds, const int* weights, int p,
                               int* pts, long long rows,
                               cudaStream_t stream) {
  if (p < 1 || p > kMaxParts || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  PartArgs a;
  a.fm = columba::fm_params(occ, blocks, c0, c1, c2, c3, d0, d1);
  a.reads = reads;
  a.m = m;
  a.n = static_cast<uint32_t>(n);
  a.table = table;
  a.K = K;
  a.p = p;
  for (int q = 0; q < kMaxParts; ++q) {
    a.seeds[q] = q < p ? seeds[q] : 0;
    a.weights[q] = q < p ? weights[q] : 0;
  }
  a.pts = pts;
  a.rows = rows;
  constexpr int kThreads = 64;
  dynpart_kernel<<<columba::grid_for(rows, kThreads), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
