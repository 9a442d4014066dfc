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
// Bound: bytes. Everything is index arithmetic and one byte gather from the
// read per band cell; a (read, search) reads 4(p+1) + m B and writes 4T +
// T*bw + 12E + 2*bw + 14 B, about 2.2 KB at m = 100, kb = 2. Written
// plainly the kernel issues more instructions than the bytes allow for, so
// the design cuts the instructions a lane:
//
//   * Segmented prologue. A warp owns G = 32 / SW consecutive (read,
//     search) lanes, SW the least power of two > p; thread i of a lane's
//     segment holds boundary i and phase i. The clamp is a prefix max and
//     a suffix min over the boundaries, and the side depths, step counts
//     and exact extents are scans and reductions within the segment
//     (__shfl_*_sync with width SW), so a warp's prologue serves G lanes.
//     It leaves per-phase constants in shared memory (t_new = tb + toff,
//     ex_pos = epos -/+ e, ...), one int a thread and a field.
//   * Then the whole warp writes each of its lanes in turn, with coalesced
//     4 B stores, 128 steps at a time (32 in the generic body): meta and
//     the exact tables one word a thread in one step loop, each thread's
//     phase found by a pointer that only moves forward, and pchars from
//     the chunk's cells. A step's bw cells are a window of the read,
//     copied with the band radius a template argument (kb 0..6, unrolled;
//     a generic body above), into the warp's staging buffer. The buffer
//     keeps the byte offset the lane's pchars run has in memory (T*bw is
//     odd when m is), so it goes out as aligned words; the bytes of the
//     word that straddles two chunks are carried to the next chunk, and
//     only the run's first and last partial words are written as bytes
//     (they share their words with the neighbouring lanes).
//   * The block stages the scheme's phase table and the reads of its lanes
//     in shared memory once (the S searches of a read share its copy);
//     reads too long for that are read from global memory.
//   * No thread-local arrays: nothing lives in local memory.
//
// Measured on the H100 (32,768 reads x 3 searches, T = 104, kb 2): 0.125
// ms, where one block a lane took 0.228. Registers decide more than
// instructions here: at 48 the body runs five blocks an SM, and leaner
// variants that ptxas took to 64 registers (four blocks) were slower.
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
#include "common.cuh"

namespace {

constexpr int kMaxParts = 16;
constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kMaxUnrolledKb = 6;    // template bodies; a generic one above

// band steps a warp stages at a time: 128 in the template bodies (one
// chunk at m = 100), 32 in the generic one
__host__ __device__ constexpr int chunk_steps(int kb) {
  return kb <= kMaxUnrolledKb ? 128 : 32;
}

// per-phase constants, one int a thread (segment thread i = phase i)
enum Field {
  kBandCum,     // inclusive running sum of band steps
  kToff,        // t_new = tb + toff
  kTgKb,        // tgt + kb: the band cell of the target, o_acc = tgkb - t_new
  kCreset,      // the depth whose step resets colMin
  kHi,          // the meta word's phase bits: side << 1 | upper << 9, and
                // on the forward side the back depth << 17
  kExCum,       // inclusive running sum of exact steps
  kEpos,        // ex_pos = epos - e (backward) or epos + e (forward)
  kEback,       // back depth = eback + e (backward) or eback (forward)
  kFields
};

struct TablesArgs {
  const int* pts;             // (R, p + 1)
  const uint8_t* reads;       // (R, m)
  const int* phases;          // (S, 2 + 5p): pi0, pivot_left, then per phase
                              // side, upper, lo, hi, is_exact
  long long R;
  int S, p, m, kb;
  int seg;                    // SW: threads a lane in the prologue
  int staged;                 // 1: the block's reads in shared memory
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

__device__ __forceinline__ int seg_scan_add(int v, int sl, int sw) {
  for (int d = 1; d < sw; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d, sw);
    if (sl >= d) v += u;
  }
  return v;
}

// (a lane whose source falls before its segment gets its own value back,
// which a max or a min leaves as it is)
__device__ __forceinline__ int seg_scan_max(int v, int sw) {
  for (int d = 1; d < sw; d <<= 1)
    v = max(v, __shfl_up_sync(kFull, v, d, sw));
  return v;
}

__device__ __forceinline__ int seg_suffix_min(int v, int sw) {
  for (int d = 1; d < sw; d <<= 1)
    v = min(v, __shfl_down_sync(kFull, v, d, sw));
  return v;
}

__device__ __forceinline__ int seg_max(int v, int sw) {
  for (int d = 1; d < sw; d <<= 1)
    v = max(v, __shfl_xor_sync(kFull, v, d, sw));
  return v;
}

// Shared memory of a block, per warp: the fields and the pchars staging
// buffer (its run's byte offset in the word, then a chunk of steps' cells).
__host__ __device__ __forceinline__ int stage_bytes(int kb) {
  return (4 + chunk_steps(kb) * (2 * kb + 1) + 3) & ~3;
}

__host__ __device__ __forceinline__ long long reads_spanned(long long lanes,
                                                            int S) {
  const long long most = (lanes + S - 1) / S + 1;
  return most < lanes ? most : lanes;
}

__host__ __device__ __forceinline__ size_t fixed_smem(int S, int p,
                                                      int kb) {
  return sizeof(int) * (static_cast<size_t>(S) * (2 + 5 * p) +
                        static_cast<size_t>(kWarps) * kFields * 32) +
         static_cast<size_t>(kWarps) * stage_bytes(kb);
}

template <int KB>
__device__ __forceinline__ void tables_body(const TablesArgs& a) {
  extern __shared__ int smem[];
  const int S = a.S, p = a.p, m = a.m;
  const int kb = KB >= 0 ? KB : a.kb;
  const int bw = 2 * kb + 1;
  const int T = m + 2 * kb, E = m;
  const int row_len = 2 + 5 * p;
  const int sw = a.seg, lanes_w = 32 / sw;
  const int w = threadIdx.x >> 5, ln = threadIdx.x & 31;
  constexpr int INF = columba::INF;

  int* s_tab = smem;                                    // S * row_len
  int* f = s_tab + S * row_len + w * kFields * 32;      // this warp's fields
  uint8_t* buf = reinterpret_cast<uint8_t*>(
                     s_tab + S * row_len + kWarps * kFields * 32) +
                 w * stage_bytes(kb);
  const uint8_t* s_reads = reinterpret_cast<const uint8_t*>(
                               s_tab + S * row_len + kWarps * kFields * 32) +
                           kWarps * stage_bytes(kb);

  const long long L = a.R * S;
  const long long block0 =
      static_cast<long long>(blockIdx.x) * kWarps * lanes_w;
  const long long r0 = block0 / S;
  for (int i = threadIdx.x; i < S * row_len; i += blockDim.x)
    s_tab[i] = __ldg(a.phases + i);
  if (a.staged) {
    const long long last = min(block0 + kWarps * lanes_w, L) - 1;
    const long long n = (last / S - r0 + 1) * m;
    const uint8_t* src = a.reads + r0 * m;
    uint8_t* dst = const_cast<uint8_t*>(s_reads);
    for (long long i = threadIdx.x; i < n; i += blockDim.x)
      dst[i] = __ldg(src + i);
  }
  __syncthreads();

  const long long warp0 = block0 + static_cast<long long>(w) * lanes_w;
  if (warp0 >= L) return;                 // whole warps leave together

  // ---- prologue: segment g is lane warp0 + g, its thread i phase i ----
  const int sl = ln & (sw - 1), g_mine = ln / sw;
  const long long lane_m = min(warp0 + g_mine, L - 1);
  const long long r_m = lane_m / S;
  const int* row = s_tab + static_cast<int>(lane_m - r_m * S) * row_len;
  int pt = sl <= p ? __ldg(a.pts + r_m * (p + 1) + sl) : 0;
  if (kb > 0) {
    // forward sweep: pts[i] = max over j <= i of pts[j] + (i - j) * bw,
    // pts[0] = 0; then pts[p] = m and the backward sweep: pts[i] = min over
    // j >= i of pts[j] - (j - i) * bw, for 0 < i < p
    const int fw = seg_scan_max((sl == 0 ? 0 : pt) - sl * bw, sw) + sl * bw;
    const int gv = sl == p ? m : fw;
    const int bk =
        seg_suffix_min(sl <= p ? gv - sl * bw : 1 << 29, sw) + sl * bw;
    pt = sl == 0 ? 0 : (sl >= p ? gv : bk);
  }
  const int pivot =
      __shfl_sync(kFull, pt, row[1] ? row[0] : row[0] + 1, sw);
  const bool act = sl < p;
  const int* q = row + 2 + 5 * (act ? sl : 0);
  const int side = act ? q[0] : 0;
  const int lo = act ? q[2] : 0, hi = act ? q[3] : 0;
  const bool is_ex = act && q[4] != 0;
  const int pt_lo = __shfl_sync(kFull, pt, lo, sw);
  const int pt_hi = __shfl_sync(kFull, pt, hi + 1, sw);
  const int tgt = side == 0 ? pivot - pt_lo : pt_hi - pivot;
  const int new_depth = is_ex ? tgt : tgt + kb;
  // each side's depth after the phases up to this one (both start at 0)
  const int db_after =
      seg_scan_max(act && side == 0 ? max(new_depth, 0) : 0, sw);
  const int df_after =
      seg_scan_max(act && side == 1 ? max(new_depth, 0) : 0, sw);
  int db_before = __shfl_up_sync(kFull, db_after, 1, sw);
  int df_before = __shfl_up_sync(kFull, df_after, 1, sw);
  if (sl == 0) db_before = df_before = 0;
  const int prev = side == 0 ? db_before : df_before;
  const int step = act ? max(new_depth - prev, 0) : 0;
  const int ex_step = is_ex ? step : 0;
  const int back = side == 0 ? ex_step : 0;
  const int ex_cum = seg_scan_add(ex_step, sl, sw);
  const int band_cum = seg_scan_add(act && !is_ex ? step : 0, sl, sw);
  const int back_cum = seg_scan_add(back, sl, sw);
  const int ext_b = seg_max(is_ex && side == 0 ? tgt : 0, sw);
  const int ext_f = seg_max(is_ex && side == 1 ? tgt : 0, sw);
  // the lane's scalars, on every thread of its segment
  const int t_len = __shfl_sync(kFull, band_cum, p - 1, sw);
  const int e_len = __shfl_sync(kFull, ex_cum, p - 1, sw);
  const int t_back = __shfl_sync(kFull, db_after, p - 1, sw);
  const int side_last = __shfl_sync(kFull, side, p - 1, sw);
  const int back_total = __shfl_sync(kFull, back_cum, p - 1, sw);
  if (act) {
    const int band_prev = band_cum - (is_ex ? 0 : step);
    const int ex_prev = ex_cum - ex_step;
    f[kBandCum * 32 + ln] = band_cum;
    f[kToff * 32 + ln] = prev - band_prev + 1;
    f[kTgKb * 32 + ln] = tgt + kb;
    f[kCreset * 32 + ln] = max(prev + 1, tgt - kb);
    f[kHi * 32 + ln] = (side << 1) | (q[1] << 9) |
                       (side == 0 ? 0 : min(db_before, 4095) << 17);
    f[kExCum * 32 + ln] = ex_cum;
    f[kEpos * 32 + ln] = side == 0 ? pivot - prev + ex_prev - 1
                                   : pivot + prev - ex_prev;
    f[kEback * 32 + ln] = back_cum - back + (side == 0 ? 1 - ex_prev : 0);
  }
  const bool mine = warp0 + g_mine < L;
  if (sl == 0 && mine) {
    a.t_back[lane_m] = t_back;
    a.pivot[lane_m] = pivot;
    a.db_exact[lane_m] = ext_b;
    a.colmin_init[2 * lane_m] = 0;
    a.colmin_init[2 * lane_m + 1] = 0;
  }
  // initial band rows of the warp's lanes (contiguous): |jj - t0| inside
  // the side's pattern, INF outside
  for (int c0 = 0; c0 < lanes_w * 2 * bw; c0 += 32) {
    const int c = c0 + ln, g = min(c / (2 * bw), lanes_w - 1);
    const int src = g * sw;
    const int pv = __shfl_sync(kFull, pivot, src);
    const int eb = __shfl_sync(kFull, ext_b, src);
    const int ef = __shfl_sync(kFull, ext_f, src);
    const int cc = c - g * 2 * bw;
    const int sd = cc >= bw ? 1 : 0, o = cc - sd * bw;
    const int t0 = sd == 0 ? eb : ef;
    const int side_len = sd == 0 ? pv : m - pv;
    const int jj = t0 - kb + o;
    if (c < lanes_w * 2 * bw && warp0 + g < L)
      a.band_init[2 * (warp0 + g) * bw + cc] = static_cast<signed char>(
          (jj >= 0 && jj <= side_len) ? abs(jj - t0) : INF);
  }
  __syncwarp();

  // ---- the warp's lanes in turn ----
  constexpr int kChunk = chunk_steps(KB >= 0 ? KB : kMaxUnrolledKb + 1);
  for (int g = 0; g < lanes_w; ++g) {
    const long long lane = warp0 + g;
    if (lane >= L) break;
    const int fb = g * sw;
    const int l_pivot = __shfl_sync(kFull, pivot, fb);
    const int l_tlen = __shfl_sync(kFull, t_len, fb);
    const int l_elen = __shfl_sync(kFull, e_len, fb);
    const int l_side_last = __shfl_sync(kFull, side_last, fb);
    const int l_back_total = __shfl_sync(kFull, back_total, fb);
    const long long r = lane / S;
    const uint8_t* rd = a.staged ? s_reads + (r - r0) * m : a.reads + r * m;
    int* meta = a.meta + lane * T;
    int* ex_pos = a.ex_pos + lane * E;
    int* ex_dir = a.ex_dir + lane * E;
    int* db_ex = a.db_ex_steps + lane * E;
    const long long base = lane * static_cast<long long>(T) * bw;
    const int mis = static_cast<int>(base & 3);
    signed char* out = a.pchars + (base - mis);   // 4 B aligned
    const int t_start = T - l_tlen;
    int bph = 0, eph = 0;   // the phase of this thread's step, band / exact

    for (int g0 = 0; g0 < T; g0 += kChunk) {
      // a chunk of steps: meta, the exact tables (E <= T), and the cells
      // into the buffer
#pragma unroll
      for (int jj = 0; jj < kChunk / 32; ++jj) {
        const int st = g0 + jj * 32 + ln;
        if (st < T) {
          const int tb = max(st - t_start, 0);
          while (bph < p - 1 && f[kBandCum * 32 + fb + bph] <= tb) ++bph;
          const int fi = fb + bph;
          const int t_new = tb + f[kToff * 32 + fi];
          const int o_acc = f[kTgKb * 32 + fi] - t_new;
          const int hi = f[kHi * 32 + fi];
          const bool active = st >= t_start;
          const bool fwd = (hi >> 1) & 1;
          // in the window: t_new >= tgt - kb, i.e. o_acc < bw
          const bool creset = active && o_acc < bw &&
                              t_new == f[kCreset * 32 + fi];
          const int colo =
              (active && static_cast<unsigned>(o_acc) < unsigned(bw))
                  ? o_acc
                  : -1;
          meta[st] = hi | (active ? 1 : 0) | ((creset ? 1 : 0) << 2) |
                     ((colo + 1) << 3) |
                     (fwd ? 0 : min(max(t_new, 0), 4095) << 17);
          // cells o = 0..bw-1: pattern depth j = t_new - kb + o
          const int side_len = fwd ? m - l_pivot : l_pivot;
          const int j0 = t_new - kb;
          uint8_t* cells = buf + mis + (st - g0) * bw;
          if (j0 >= 1 && j0 + bw - 1 <= side_len && l_pivot >= 0 &&
              l_pivot <= m) {
            // every cell inside the pattern and the read
            const uint8_t* c0 =
                rd + (fwd ? l_pivot + j0 - 1 : l_pivot - j0);
            const int dir = fwd ? 1 : -1;
            if constexpr (KB >= 0) {
#pragma unroll
              for (int o = 0; o < 2 * KB + 1; ++o) cells[o] = c0[dir * o];
            } else {
#pragma unroll 1
              for (int o = 0; o < bw; ++o) cells[o] = c0[dir * o];
            }
          } else {
#pragma unroll 1
            for (int o = 0; o < bw; ++o) {
              const int j = j0 + o;
              const int pos = fwd ? l_pivot + j - 1 : l_pivot - j;
              cells[o] = (j < 0 || j > side_len)
                             ? 0xFEu
                             : (j == 0 ? 0xFFu : rd[min(max(pos, 0), m - 1)]);
            }
          }
        }
        if (st < E) {
          int pos = -1, dir = l_side_last, back = l_back_total;
          if (st < l_elen) {
            while (f[kExCum * 32 + fb + eph] <= st) ++eph;
            const int fi = fb + eph;
            dir = (f[kHi * 32 + fi] >> 1) & 1;
            pos = f[kEpos * 32 + fi] + (dir ? st : -st);
            back = f[kEback * 32 + fi] + (dir ? 0 : st);
          }
          ex_pos[st] = pos;
          ex_dir[st] = dir;
          db_ex[st] = back;
        }
      }
      __syncwarp();
      // buffer word k is the aligned word at out + g0*bw + 4k; bytes
      // before lo_valid belong to the lane before
      const bool last = g0 + kChunk >= T;
      const int end = mis + min(kChunk, T - g0) * bw;
      const int lo_valid = g0 == 0 ? mis : 0;
      const int k_lo = (lo_valid + 3) >> 2, k_hi = end >> 2;
      unsigned* dst = reinterpret_cast<unsigned*>(out + g0 * bw);
      const unsigned* sbuf = reinterpret_cast<const unsigned*>(buf);
      for (int k = k_lo + ln; k < k_hi; k += 32) dst[k] = sbuf[k];
      if (ln < 4) {
        // the run's first partial word, and its last
        const int x = lo_valid + ln;
        if (x < min(4 * k_lo, end))
          out[g0 * bw + x] = static_cast<signed char>(buf[x]);
        const int y = 4 * k_hi + ln;
        if (last && k_hi >= k_lo && y < end)
          out[g0 * bw + y] = static_cast<signed char>(buf[y]);
      }
      // the word that straddles this chunk and the next (mis bytes) moves
      // to the front of the buffer
      const uint8_t carry = ln < mis ? buf[4 * k_hi + ln] : 0;
      __syncwarp();
      if (!last && ln < mis) buf[ln] = carry;
    }
  }
}

template <int KB>
__global__ void __launch_bounds__(kWarps * 32)
dyn_tables_kernel(TablesArgs a) {
  tables_body<KB>(a);
}

// kb 0 (the Hamming metric): left to itself, ptxas keeps this body at 40
// registers and spills 8 B to local memory; a floor of 4 blocks an SM
// (64 registers) keeps it out at the same speed. The same floor on the
// other bodies makes ptxas take 80 registers and slows them.
__global__ void __launch_bounds__(kWarps * 32, 4)
dyn_tables_narrow_kernel(TablesArgs a) {
  tables_body<0>(a);
}

template <int KB>
int launch(const TablesArgs& a, int blocks, size_t smem,
           cudaStream_t stream) {
  void (*kernel)(TablesArgs) = nullptr;
  if constexpr (KB == 0) {
    kernel = dyn_tables_narrow_kernel;
  } else {
    kernel = dyn_tables_kernel<KB>;
  }
  if (smem > kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, kWarps * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int KB>
int dispatch(const TablesArgs& a, int blocks, size_t smem,
             cudaStream_t stream) {
  if constexpr (KB > kMaxUnrolledKb) {
    return launch<-1>(a, blocks, smem, stream);
  } else {
    return a.kb == KB ? launch<KB>(a, blocks, smem, stream)
                      : dispatch<KB + 1>(a, blocks, smem, stream);
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
  a.seg = 2;
  while (a.seg < p + 1) a.seg <<= 1;
  const long long lanes_b = static_cast<long long>(kWarps) * (32 / a.seg);
  size_t smem = fixed_smem(S, p, kb);
  const size_t reads_b = static_cast<size_t>(reads_spanned(lanes_b, S)) * m;
  a.staged = smem + reads_b <= kSmemDefault ? 1 : 0;
  if (a.staged) smem += reads_b;
  const long long blocks = (R * S + lanes_b - 1) / lanes_b;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<0>(a, static_cast<int>(blocks), smem, stream);
}
