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
// one-hot selects over all parts. Here each read walks all its steps inside
// one launch, with no per-thread array indexed at run time (such arrays go
// to local memory):
//   * Vanilla index: one thread a read; the part count p is a template
//     argument (1..16), so begins, ends and the p ranges are registers and
//     every select over the parts is unrolled. A step's chain is the scan,
//     the char, and two occ-row reads in one round.
//   * RLC index ("rlc"): four lanes a read (bm_quad.cuh); begins, ends,
//     capped widths and the p ranges live in the read's slice of shared
//     memory, the scan over the parts is split across the quad (lane q
//     takes parts q, q + 4, ...; a two-step shuffle keeps the first
//     maximum), and the chosen part's extension is the quad's cooperative
//     step.
//
// Places where the arithmetic has to agree with the JAX package bit for bit:
//   * widths are uint32 differences clamped to 2^30, and the weighted width
//     is their 32-bit product with the weight, which wraps (a width above
//     2^31 / weight turns negative): taken here in uint32 and reinterpreted;
//   * a part that cannot grow weighs -1; the first maximum wins; when no part
//     can grow nothing changes (then nothing ever will: the loop ends);
//   * the tie direction compares the neighbours' widths with 2^30 sentinels
//     at both ends of the read;
//   * an empty range stays a candidate with width 0 and is still extended, so
//     a read does not stop early (unlike kernel E): only pts leave the
//     kernel, but every later choice depends on every range's width.
//
// RLC entry ("rlc", K15 on the RLC index with K18 inside it): each part's
// range carries its run hints from one step to the next, and a step walks
// the hints of the chosen character's child only (bextend.extend_char), on
// the compact run tables (index/bmove.py run_tables). An empty child is the
// zero range, and extending zero gives zero, so an empty part stays width
// 0, as on the Vanilla index. Without a seed table (the CLI builds none on
// RLC) each seed is one backward extension of the RLC full range; with
// one, the seed is its (4^K, 8) row.
//
// Optional output: each read's final p part ranges (rows, p, RW), for the
// tests that hold every column, run hints included, to the JAX function.
//
// Bound: latency, as kernel E. A read does m - p*K dependent steps; each is
// a scan of p parts (registers; RLC: shared memory), then two random 48 B
// occ-row reads (RLC: the rows, an LF run and the longest of four walks,
// bm_quad.cuh); the card hides that only across reads. Bytes moved: rows x steps x the
// rows read, the m chars of each row, the p seed rows of the table, and
// 4(p + 1) B out.
#include "bm_quad.cuh"

namespace {

constexpr int kMaxParts = 16;
constexpr uint32_t kWidthCap = 1u << 30;
constexpr int kThreads = 64;       // Vanilla: a thread a read
constexpr int kQuadThreads = 128;  // RLC: 32 reads a block, four lanes a read

struct PartArgs {
  columba::FmParams fm;
  columba::BmParams bm;
  columba::BmTables tables;
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

// the seed table's row of the K-mer at read position b (zero if it holds
// an N)
template <int RW>
__device__ __forceinline__ void table_seed(const PartArgs& a,
                                           const uint8_t* rd, int b,
                                           uint32_t* o) {
  long long code = 0;
  bool bad = false;
  for (int j = 0; j < a.K; ++j) {
    const int c = __ldg(rd + min(max(b + j, 0), a.m - 1));
    bad = bad || c > 3;
    code = code * 4 + min(c, 3);
  }
  const long long* row = a.table + RW * code;
#pragma unroll
  for (int k = 0; k < RW; ++k)
    o[k] = bad ? 0u : static_cast<uint32_t>(__ldg(row + k));
}

// child c of the Vanilla range r in direction dir (an N gives zero)
__device__ __forceinline__ void fm_step(const PartArgs& a, const uint32_t* r,
                                        int c, int dir, uint32_t* o) {
  if (c > 3) {                        // N never matches
#pragma unroll
    for (int k = 0; k < 4; ++k) o[k] = 0u;
    return;
  }
  columba::FmLane lane;
  lane.init(a.fm, a.bm, r, dir);
  columba::fm_child(lane, c, o);
}

// a register budget for each part count (blocks of kThreads an SM): left
// to itself, ptxas keeps P = 3 at 63 registers with an 8 B spill; 64
// registers up to P = 3 and 128 up to P = 14 keep every part in registers
__host__ __device__ constexpr int min_blocks(int p) {
  return p <= 3 ? 16 : p <= 14 ? 8 : 1;
}

template <int P>
__global__ void __launch_bounds__(kThreads, min_blocks(P))
dynpart_kernel(PartArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= a.rows) return;
  const uint8_t* rd = a.reads + i * a.m;
  const int m = a.m, K = a.K;
  uint32_t rg[P][4];
  int beg[P], end[P];
  const uint32_t full[4] = {0u, a.n + 1u, 0u, a.n + 1u};
#pragma unroll
  for (int k = 0; k < P; ++k) {
    beg[k] = a.seeds[k];
    end[k] = beg[k] + K;
    if (a.table != nullptr)
      table_seed<4>(a, rd, beg[k], rg[k]);
    else
      fm_step(a, full, __ldg(rd + min(max(beg[k], 0), m - 1)), 0, rg[k]);
  }

  const int steps = m - P * K;
  for (int s = 0; s < steps; ++s) {
    uint32_t wd[P];
    int best = 0, best_w = 0;
    bool bcl = false, bcr = false;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      wd[k] = min(rg[k][1] - rg[k][0], kWidthCap);
      const bool cl = beg[k] > (k > 0 ? end[k - 1] : 0);
      const bool cr = end[k] < (k + 1 < P ? beg[k + 1] : m);
      const int w = (cl || cr)
          ? static_cast<int>(wd[k] * static_cast<uint32_t>(a.weights[k]))
          : -1;
      if (k == 0 || w > best_w) {     // strict: the first maximum
        best = k;
        best_w = w;
        bcl = cl;
        bcr = cr;
      }
    }
    if (!(bcl || bcr)) break;         // no part can grow: none ever will
    uint32_t wl = kWidthCap, wr = kWidthCap, cur[4] = {0u, 0u, 0u, 0u};
    int b = 0, e = 0;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (k == best) {
        b = beg[k];
        e = end[k];
#pragma unroll
        for (int j = 0; j < 4; ++j) cur[j] = rg[k][j];
      }
      if (k + 1 == best) wl = wd[k];
      if (k == best + 1) wr = wd[k];
    }
    const bool go_back = bcl && (!bcr || wl < wr);
    uint32_t o[4];
    fm_step(a, cur, __ldg(rd + min(max(go_back ? b - 1 : e, 0), m - 1)),
            go_back ? 0 : 1, o);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (k == best) {
#pragma unroll
        for (int j = 0; j < 4; ++j) rg[k][j] = o[j];
        beg[k] -= go_back ? 1 : 0;
        end[k] += go_back ? 0 : 1;
      }
    }
  }

  // boundaries: each part begins where it grew to; gaps close to the right
  int* op = a.pts + i * (P + 1);
  op[0] = 0;
#pragma unroll
  for (int k = 1; k < P; ++k) op[k] = beg[k];
  op[P] = m;
  if (a.ranges_out != nullptr) {
    long long* ro = a.ranges_out + i * P * 4;
#pragma unroll
    for (int k = 0; k < P; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) ro[k * 4 + j] = rg[k][j];
    }
  }
}

// 32-bit words of shared memory an RLC read keeps: ranges (p, 8), capped
// widths, begins, ends; odd, so that the quads of a warp spread over banks
__host__ __device__ inline int read_words(int p) { return (p * 11) | 1; }

// v[k] for a runtime k with constant indices only (the argument block is
// never indexed at run time, which would copy it to local memory)
__device__ __forceinline__ int pick(const int (&v)[kMaxParts], int k) {
  int out = v[0];
#pragma unroll
  for (int s = 1; s < kMaxParts; ++s) out = s == k ? v[s] : out;
  return out;
}

__global__ void __launch_bounds__(kQuadThreads)
dynpart_rlc_kernel(PartArgs a) {
  extern __shared__ uint32_t smem[];
  const long long i = (blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x) >> 2;
  if (i >= a.rows) return;              // a quad leaves together
  const int q = threadIdx.x & 3;
  const unsigned qmask = 0xFu << (threadIdx.x & 28);
  const uint8_t* rd = a.reads + i * a.m;
  const int p = a.p, m = a.m, K = a.K;
  uint32_t* rg = smem + (threadIdx.x >> 2) * read_words(p);
  uint32_t* wid = rg + p * 8;
  int* beg = reinterpret_cast<int*>(wid + p);
  int* end = beg + p;
  int wts[kMaxParts / 4];               // lane q's parts q, q + 4, ...
#pragma unroll
  for (int s = 0; s < kMaxParts / 4; ++s) wts[s] = pick(a.weights, q + 4 * s);

  // p seed steps, then m - p*K greedy steps, through one copy of the
  // extension. A seed is a table row, or one backward extension of the
  // full range with the run hints of the first and last runs.
  const uint32_t full[8] = {0u, a.n + 1u, 0u, a.n + 1u,
                            0u, a.bm.r_fwd - 1u, 0u, a.bm.r_rev - 1u};
  const int steps = m - p * K;
  for (int s = -p; s < steps; ++s) {
    int k, b, e = 0, c;
    bool go_back = true;
    uint32_t cur[8], o[8];
    if (s < 0) {                        // the seed of part s + p
      k = s + p;
      b = pick(a.seeds, k);
      c = __ldg(rd + min(max(b, 0), m - 1));
#pragma unroll
      for (int k2 = 0; k2 < 8; ++k2) cur[k2] = full[k2];
    } else {
      // lane q scans its parts; the quad keeps the first maximum
      int best = p, best_w = 0;
#pragma unroll
      for (int t = 0; t < kMaxParts / 4; ++t) {
        const int kk = q + 4 * t;
        if (kk < p) {
          const bool cl = beg[kk] > (kk > 0 ? end[kk - 1] : 0);
          const bool cr = end[kk] < (kk + 1 < p ? beg[kk + 1] : m);
          const int w = (cl || cr)
              ? static_cast<int>(wid[kk] * static_cast<uint32_t>(wts[t]))
              : -1;
          if (best == p || w > best_w) {
            best = kk;
            best_w = w;
          }
        }
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        const int ob = __shfl_xor_sync(qmask, best, x, 4);
        const int ow = __shfl_xor_sync(qmask, best_w, x, 4);
        if (ob != p && (best == p || ow > best_w ||
                        (ow == best_w && ob < best))) {
          best = ob;
          best_w = ow;
        }
      }
      k = best;
      b = beg[k];
      e = end[k];
      const bool cl = b > (k > 0 ? end[k - 1] : 0);
      const bool cr = e < (k + 1 < p ? beg[k + 1] : m);
      if (!(cl || cr)) break;           // no part can grow: none ever will
      const uint32_t wl = k > 0 ? wid[k - 1] : kWidthCap;
      const uint32_t wr = k + 1 < p ? wid[k + 1] : kWidthCap;
      go_back = cl && (!cr || wl < wr);
      c = __ldg(rd + min(max(go_back ? b - 1 : e, 0), m - 1));
#pragma unroll
      for (int k2 = 0; k2 < 8; ++k2) cur[k2] = rg[k * 8 + k2];
    }
    if (s < 0 && a.table != nullptr) {
      table_seed<8>(a, rd, b, o);
    } else if (c > 3) {                 // N never matches
#pragma unroll
      for (int k2 = 0; k2 < 8; ++k2) o[k2] = 0u;
    } else {
      columba::quad_extend(a.bm, a.tables, cur, c, go_back ? 0 : 1, q,
                           qmask, o);
    }
    __syncwarp(qmask);                  // every lane has read the state
#pragma unroll
    for (int k2 = 0; k2 < 8; ++k2)
      if ((k2 & 3) == q) rg[k * 8 + k2] = o[k2];
    if (q == 0) {
      wid[k] = min(o[1] - o[0], kWidthCap);
      if (s < 0) {
        beg[k] = b;
        end[k] = b + K;
      } else if (go_back) {
        beg[k] = b - 1;
      } else {
        end[k] = e + 1;
      }
    }
    __syncwarp(qmask);
  }

  // boundaries: each part begins where it grew to; gaps close to the right
  int* op = a.pts + i * (p + 1);
  for (int k = q; k <= p; k += 4) op[k] = k == 0 ? 0 : k == p ? m : beg[k];
  if (a.ranges_out != nullptr) {
    long long* ro = a.ranges_out + i * p * 8;
    for (int k = q; k < p * 8; k += 4) ro[k] = rg[k];
  }
}

// the Vanilla kernel for the part count a.p (1..kMaxParts)
template <int P>
int launch_fm(const PartArgs& a, cudaStream_t stream) {
  if (a.p != P) {
    if constexpr (P < kMaxParts) return launch_fm<P + 1>(a, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dynpart_kernel<P><<<columba::grid_for(a.rows, kThreads), kThreads, 0,
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
  return launch_fm<1>(a, stream);
}

extern "C" int columba_dynpart_rlc(const int* fused, unsigned r_fwd,
                                   unsigned r_rev, unsigned f0, unsigned f1,
                                   unsigned f2, unsigned f3, unsigned n,
                                   const unsigned* starts,
                                   unsigned starts_rev, const int* run_at,
                                   const int* run_at_rev, int shift,
                                   const unsigned char* reads, int m,
                                   const long long* table, int K,
                                   const int* seeds, const int* weights,
                                   int p, int* pts, long long* ranges_out,
                                   long long rows, cudaStream_t stream) {
  PartArgs a{};
  a.bm = columba::bm_params(fused, r_fwd, r_rev, f0, f1, f2, f3, n);
  a.tables = columba::bm_tables(starts, starts_rev, run_at, run_at_rev,
                                shift);
  if (!fill_args(a, reads, m, n, table, K, seeds, weights, p, pts,
                 ranges_out, rows))
    return static_cast<int>(cudaErrorInvalidValue);
  dynpart_rlc_kernel<<<columba::grid_for(4 * rows, kQuadThreads),
                       kQuadThreads, kQuadThreads / 4 * read_words(p) * 4,
                       stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
