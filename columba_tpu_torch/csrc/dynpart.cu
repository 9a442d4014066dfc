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
// steps inside one launch with Lane<RW> of common.cuh (RW 4 on the Vanilla
// index).
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
// RLC entry ("rlc", K15 on the RLC index with K18 inside it): the same body
// on 8-wide lanes (Lane<8> of common.cuh). Each part's range carries its run
// hints from one step to the next, and a step walks the hints of the chosen
// character's child only (bextend.extend_char). An empty child is the zero
// range, and extending zero gives zero, so an empty part stays width 0, as
// on the Vanilla index. Without a seed table (the CLI builds none on RLC)
// each seed is one backward extension of the RLC full range; with one, the
// seed is its (4^K, 8) row.
//
// Optional output: each read's final p part ranges (rows, p, RW), for the
// tests that hold every column, run hints included, to the JAX function.
//
// Bound: latency, as kernel E. A read does m - p*K dependent steps of two
// random 48 B occ-row reads each (RLC: two endpoint rows of four 16 B words,
// then the chosen child's LF-run reads and run-hint walks, chains of
// dependent 4 B reads); the card hides that only across reads. Bytes
// moved: rows x steps x 2 rows, the m chars of each row, the p seed rows of
// the table, and 4(p + 1) B out. RLC keeps p x 8 words of range state per
// thread (up to 512 B at 16 parts), which spills to local memory at the
// larger part counts; each step reads one part's state and scans p widths.
#include "common.cuh"

namespace {

constexpr int kMaxParts = 16;
constexpr uint32_t kWidthCap = 1u << 30;

struct PartArgs {
  columba::FmParams fm;
  columba::BmParams bm;
  const uint8_t* reads;       // (rows, m)
  int m;
  uint32_t n;
  const long long* table;     // (4^K, RW) uint32 values in int64, or null
  int K;
  int p;
  int seeds[kMaxParts];
  int weights[kMaxParts];
  int* pts;                   // (rows, p + 1)
  long long* ranges_out;      // (rows, p, RW) final part ranges, or null
  long long rows;
};

__device__ __forceinline__ uint32_t width_of(const uint32_t* r) {
  return min(r[1] - r[0], kWidthCap);
}

template <int RW>
__global__ void dynpart_kernel(PartArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= a.rows) return;
  const uint8_t* rd = a.reads + i * a.m;
  const int p = a.p, m = a.m, K = a.K;
  int begins[kMaxParts], ends[kMaxParts];
  uint32_t rg[kMaxParts][RW];

  // the full range (RLC: with the run hints of the first and last runs)
  uint32_t full[RW];
  full[0] = full[2] = 0u;
  full[1] = full[3] = a.n + 1u;
  if (RW > 4) {
    full[4] = full[6] = 0u;
    full[5] = a.bm.r_fwd - 1u;
    full[7] = a.bm.r_rev - 1u;
  }
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
      const long long* row = a.table + RW * code;
#pragma unroll
      for (int k = 0; k < RW; ++k)
        rg[q][k] = bad ? 0u : static_cast<uint32_t>(__ldg(row + k));
    } else {
      const int c = __ldg(rd + min(max(begins[q], 0), m - 1));
      if (c > 3) {                         // N never matches
#pragma unroll
        for (int k = 0; k < RW; ++k) rg[q][k] = 0u;
      } else {
        columba::Lane<RW> lane;
        lane.init(a.fm, a.bm, full, 0);
        columba::child_of<RW>(lane, a.bm, c, rg[q]);
      }
    }
  }

  const int steps = m - p * K;
  for (int s = 0; s < steps; ++s) {
    int best = 0, best_w = 0;
    bool best_ext = false, best_cl = false, best_cr = false;
    for (int q = 0; q < p; ++q) {
      const uint32_t width = width_of(rg[q]);
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
    const uint32_t wl = best > 0 ? width_of(rg[best - 1]) : kWidthCap;
    const uint32_t wr = best + 1 < p ? width_of(rg[best + 1]) : kWidthCap;
    const bool go_back = best_cl && (!best_cr || wl < wr);
    const int newpos = go_back ? begins[best] - 1 : ends[best];
    const int c = __ldg(rd + min(max(newpos, 0), m - 1));
    if (c > 3) {                           // N never matches
#pragma unroll
      for (int k = 0; k < RW; ++k) rg[best][k] = 0u;
    } else {
      columba::Lane<RW> lane;
      lane.init(a.fm, a.bm, rg[best], go_back ? 0 : 1);
      uint32_t o[RW];
      columba::child_of<RW>(lane, a.bm, c, o);
#pragma unroll
      for (int k = 0; k < RW; ++k) rg[best][k] = o[k];
    }
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
  if (a.ranges_out != nullptr) {
    long long* ro = a.ranges_out + i * p * RW;
    for (int q = 0; q < p; ++q) {
#pragma unroll
      for (int k = 0; k < RW; ++k) ro[q * RW + k] = rg[q][k];
    }
  }
}

template <int RW>
int launch(const PartArgs& a, cudaStream_t stream) {
  constexpr int kThreads = 64;
  dynpart_kernel<RW><<<columba::grid_for(a.rows, kThreads), kThreads, 0,
                       stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

bool fill_args(PartArgs& a, const unsigned char* reads, int m, long long n,
               const long long* table, int K, const int* seeds,
               const int* weights, int p, int* pts, long long* ranges_out,
               long long rows) {
  if (p < 1 || p > kMaxParts || K < 1) return false;
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
  a.ranges_out = ranges_out;
  a.rows = rows;
  return true;
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
                               int* pts, long long* ranges_out,
                               long long rows, cudaStream_t stream) {
  PartArgs a{};
  a.fm = columba::fm_params(occ, blocks, c0, c1, c2, c3, d0, d1);
  if (!fill_args(a, reads, m, n, table, K, seeds, weights, p, pts,
                 ranges_out, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<4>(a, stream);
}

extern "C" int columba_dynpart_rlc(const int* fused, unsigned r_fwd,
                                   unsigned r_rev, unsigned f0, unsigned f1,
                                   unsigned f2, unsigned f3, unsigned n,
                                   const unsigned char* reads, int m,
                                   const long long* table, int K,
                                   const int* seeds, const int* weights,
                                   int p, int* pts, long long* ranges_out,
                                   long long rows, cudaStream_t stream) {
  PartArgs a{};
  a.bm = columba::bm_params(fused, r_fwd, r_rev, f0, f1, f2, f3, n);
  if (!fill_args(a, reads, m, n, table, K, seeds, weights, p, pts,
                 ranges_out, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<8>(a, stream);
}
