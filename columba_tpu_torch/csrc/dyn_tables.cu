// Kernel G: the per-(read, search) schedule tables of dynamic partitioning.
//
// Replaces columba_tpu/search/dynschedule.py build_tables (with
// clamp_partition folded in): from a read's part boundaries pts and the
// scheme's static structure it computes, for every search of every read, the
// T = m + 2*kb packed band-step words (meta), the band-cell codes of every
// step (pchars), the E = m exact-prefix positions, directions and back
// depths, the initial band rows, and the back depth, pivot and exact extent
// that candidate staging reads.
//
// The JAX function is array arithmetic over (R, S, p, T) tensors with
// take_along_axis gathers. Here one block owns one (read, search): thread 0
// runs the p-phase prologue (p <= 16) into shared memory, the block copies
// its read there too, and then the threads stride over the steps, so that
// neighbouring threads write neighbouring words of meta, ex_* and pchars.
//
// Layout details that have to agree with the JAX package:
//   * schedules are end-aligned: step g of T is local step g - (T - t_len),
//     and a search idles (active bit 0) before its first step;
//   * the meta word is active | side<<1 | creset<<2 | (colo+1)<<3 | ub<<9 |
//     min(max(db, 0), 4095)<<17 (ub at bit 9, not 10 as in the static layout);
//   * pchars holds -2 for a cell outside the pattern, -1 for a cell without
//     a diagonal transition, else the read's char;
//   * ex_dir is written for idle steps too (the phase the step count falls
//     in), ex_pos is -1 there.
//
// Bound: bytes. Everything is index arithmetic and one byte gather from the
// read per band cell; the block reads 4(p+1) + m B and writes 4T + T*bw +
// 12E + 2*bw + 14 B.
#include "common.cuh"

namespace {

constexpr int kMaxParts = 16;

struct TablesArgs {
  const int* pts;             // (R, p + 1)
  const uint8_t* reads;       // (R, m)
  const int* phases;          // (S, 2 + 5p): pi0, pivot_left, then per phase
                              // side, upper, lo, hi, is_exact
  long long R;
  int S, p, m, kb;
  int* meta;                  // (L, T)
  signed char* pchars;        // (L * T, bw)
  int* ex_pos;                // (L, E)
  int* ex_dir;                // (L, E)
  int* db_ex_steps;           // (L, E)
  signed char* band_init;     // (L, 2, bw)
  signed char* colmin_init;   // (L, 2)
  int* t_back;                // (L,)
  int* pivot;                 // (L,)
  int* db_exact;              // (L,)
};

struct Phases {
  int side[kMaxParts], upper[kMaxParts], tgt[kMaxParts];
  int prev_depth[kMaxParts], db_before[kMaxParts];
  int band_cum[kMaxParts], ex_cum[kMaxParts];   // inclusive running sums
  int pivot, t_len, e_len;
};

// clamp_partition: every part at least 2*kb+1 long, sweeping forward from
// the left edge and then backward from the right edge.
__device__ void clamp_pts(int* pts, int p, int m, int kb) {
  if (kb == 0) return;
  const int minlen = 2 * kb + 1;
  pts[0] = 0;
  for (int i = 1; i < p; ++i) pts[i] = max(pts[i], pts[i - 1] + minlen);
  pts[p] = m;
  for (int i = p - 1; i > 0; --i) pts[i] = min(pts[i], pts[i + 1] - minlen);
}

__global__ void dyn_tables_kernel(TablesArgs a) {
  extern __shared__ uint8_t s_read[];
  __shared__ Phases ph;
  const long long lane = blockIdx.x;
  const long long r = lane / a.S;
  const int s = static_cast<int>(lane % a.S);
  const int p = a.p, m = a.m, kb = a.kb;
  const int bw = 2 * kb + 1;
  const int T = m + 2 * kb, E = m;
  constexpr int INF = columba::INF;

  for (int j = threadIdx.x; j < m; j += blockDim.x)
    s_read[j] = a.reads[r * m + j];

  if (threadIdx.x == 0) {
    int pts[kMaxParts + 1];
    for (int i = 0; i <= p; ++i) pts[i] = a.pts[r * (p + 1) + i];
    clamp_pts(pts, p, m, kb);
    const int* row = a.phases + s * (2 + 5 * p);
    const int pivot = row[1] ? pts[row[0]] : pts[row[0] + 1];
    int db = 0, df = 0, ex_sum = 0, band_sum = 0, ext_b = 0, ext_f = 0;
    for (int i = 0; i < p; ++i) {
      const int* q = row + 2 + 5 * i;
      const int side = q[0], lo = q[2], hi = q[3];
      const bool is_ex = q[4] != 0;
      const int tgt = side == 0 ? pivot - pts[lo] : pts[hi + 1] - pivot;
      const int new_depth = is_ex ? tgt : tgt + kb;
      const int cur = side == 0 ? db : df;
      const int step = max(new_depth - cur, 0);
      ph.side[i] = side;
      ph.upper[i] = q[1];
      ph.tgt[i] = tgt;
      ph.prev_depth[i] = cur;
      ph.db_before[i] = db;
      if (side == 0) {
        db = max(db, new_depth);
      } else {
        df = max(df, new_depth);
      }
      if (is_ex) {
        ex_sum += step;
        if (side == 0) {
          ext_b = max(ext_b, tgt);
        } else {
          ext_f = max(ext_f, tgt);
        }
      } else {
        band_sum += step;
      }
      ph.ex_cum[i] = ex_sum;
      ph.band_cum[i] = band_sum;
    }
    ph.pivot = pivot;
    ph.t_len = band_sum;
    ph.e_len = ex_sum;
    a.t_back[lane] = db;
    a.pivot[lane] = pivot;
    a.db_exact[lane] = ext_b;
    a.colmin_init[2 * lane] = 0;
    a.colmin_init[2 * lane + 1] = 0;
    // initial band rows: |jj - t0| inside the side's pattern, INF outside
    for (int sd = 0; sd < 2; ++sd) {
      const int t0 = sd == 0 ? ext_b : ext_f;
      const int side_len = sd == 0 ? pivot : m - pivot;
      for (int o = 0; o < bw; ++o) {
        const int jj = t0 - kb + o;
        a.band_init[(2 * lane + sd) * bw + o] = static_cast<signed char>(
            (jj >= 0 && jj <= side_len) ? abs(jj - t0) : INF);
      }
    }
  }
  __syncthreads();

  const int pivot = ph.pivot;
  // ---------------- band steps ----------------
  for (int g = threadIdx.x; g < T; g += blockDim.x) {
    const int t_loc = g - (T - ph.t_len);
    const bool active = t_loc >= 0;
    const int tb = max(t_loc, 0);
    int phase = 0;
    for (int i = 0; i < p; ++i) phase += ph.band_cum[i] <= tb ? 1 : 0;
    phase = min(phase, p - 1);
    const int side = ph.side[phase], tgt = ph.tgt[phase];
    const int prev = ph.prev_depth[phase];
    const int cum_prev = phase > 0 ? ph.band_cum[phase - 1] : 0;
    const int t_new = prev + (tb - cum_prev) + 1;
    const bool in_window = t_new >= tgt - kb;
    const int o_acc = tgt - t_new + kb;
    const bool creset =
        active && in_window && t_new == max(prev + 1, tgt - kb);
    const int colo =
        (active && in_window && o_acc >= 0 && o_acc < bw) ? o_acc : -1;
    const int db_t = side == 0 ? t_new : ph.db_before[phase];
    a.meta[lane * T + g] = (active ? 1 : 0) | (side << 1) |
                           ((creset ? 1 : 0) << 2) | ((colo + 1) << 3) |
                           (ph.upper[phase] << 9) |
                           (min(max(db_t, 0), 4095) << 17);
    const int sl = side == 0 ? pivot : m - pivot;
    signed char* pc = a.pchars + (lane * T + g) * bw;
    for (int o = 0; o < bw; ++o) {
      const int j = t_new - kb + o;
      const int pos = side == 0 ? pivot - j : pivot + j - 1;
      const bool cvalid = j >= 0 && j <= sl;
      const bool mvalid = j >= 1 && j <= sl;
      pc[o] = !cvalid ? -2
                      : (!mvalid ? -1
                                 : static_cast<signed char>(
                                       s_read[min(max(pos, 0), m - 1)]));
    }
  }
  // ---------------- exact prefix ----------------
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    int phase = 0;
    for (int i = 0; i < p; ++i) phase += ph.ex_cum[i] <= e ? 1 : 0;
    phase = min(phase, p - 1);
    const int side = ph.side[phase];
    const int cum_prev = phase > 0 ? ph.ex_cum[phase - 1] : 0;
    const int ej = ph.prev_depth[phase] + (e - cum_prev) + 1;
    const bool act = e < ph.e_len;
    a.ex_pos[lane * E + e] =
        act ? (side == 0 ? pivot - ej : pivot + ej - 1) : -1;
    a.ex_dir[lane * E + e] = side;
    // backward exact steps among steps 0..e: each backward exact phase i
    // covers steps [ex_cum[i-1], ex_cum[i])
    int back = 0;
    for (int i = 0; i < p; ++i) {
      const int lo = i > 0 ? ph.ex_cum[i - 1] : 0;
      if (ph.side[i] == 0) back += max(min(e + 1, ph.ex_cum[i]) - lo, 0);
    }
    a.db_ex_steps[lane * E + e] = back;
  }
}

}  // namespace

extern "C" int columba_dyn_tables(
    const int* pts, const unsigned char* reads, const int* phases,
    long long R, int S, int p, int m, int kb, int* meta,
    signed char* pchars, int* ex_pos, int* ex_dir, int* db_ex_steps,
    signed char* band_init, signed char* colmin_init, int* t_back, int* pivot,
    int* db_exact, cudaStream_t stream) {
  if (p < 1 || p > kMaxParts || S < 1 || m < 1 || kb < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  TablesArgs a;
  a.pts = pts;
  a.reads = reads;
  a.phases = phases;
  a.R = R;
  a.S = S;
  a.p = p;
  a.m = m;
  a.kb = kb;
  a.meta = meta;
  a.pchars = pchars;
  a.ex_pos = ex_pos;
  a.ex_dir = ex_dir;
  a.db_ex_steps = db_ex_steps;
  a.band_init = band_init;
  a.colmin_init = colmin_init;
  a.t_back = t_back;
  a.pivot = pivot;
  a.db_exact = db_exact;
  constexpr int kThreads = 128;
  const long long lanes = R * S;
  dyn_tables_kernel<<<static_cast<unsigned>(lanes), kThreads,
                      static_cast<size_t>(m), stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
