// Kernel A: bidirectional extension of a frontier of ranges, and the exact
// prefix of the scheme executor in one launch.
//
// The main entry replaces columba_tpu/ops/extend.py extend_all /
// extend_char (with ops/rank.py occ_all) on the Vanilla index; the port
// runs it for the k-mer seed table build (index/kmer.py). Entry "rlc" (K18)
// replaces columba_tpu/ops/bextend.py extend_all (:103) / extend_char
// (:259) on the RLC index, on 8-wide lanes or 12-wide lanes with toehold:
// ops/extend.py takes it for RLC CUDA tensors, as the JAX package
// dispatches every extension to bextend on any device. extend_char walks
// the chosen child's run hints only, extend_all the hints of every child
// that is not empty.
//
// Entries "loop" (Vanilla) and "loop_rlc" (RLC, K18: 8-wide lanes, or 12
// wide with toeholds on the textless index) replace the exact-prefix loop
// of columba_tpu/search/executor.py run_scheme (make_ex: ex_cond / ex_body,
// a lockstep while-loop of extend_char over all lanes, ops/extend.py:97 and
// ops/bextend.py:259). Lanes do not interact in the exact prefix, so one
// lane is walked through steps t_lo..t_hi inside one launch, with
// ex_body's rules: a step whose ex_pos < 0 keeps the range; otherwise the
// lane extends by the read's code at ex_pos (a code > 3 empties it) in
// direction ex_dir, and an empty result is the zero range; with a
// switchpoint, a live range of width <= switchpoint at a step t >= gate_t
// drains: its drain row is [lo, hi, id, db_ex[t]] (that step's db_ex, so a
// lane narrow before the gate drains at the gate step) and the lane is
// zero. The lane stops at its first empty or drained range; later steps
// cannot revive it. It reads the schedule's (E, S) tables at [t, id % S]
// (per-read schedules: its own (R*S, E) rows at [id, t]) and its read's
// code straight from the (R, m) uint8 batch, so the (E, L) step tables of
// the JAX loop are never made. The JAX loop stops when no lane is live; a
// lane here stops alone, with the same result. One body, templated on the
// lane width RW: on the Vanilla index a thread owns a lane (FmLane of
// common.cuh); on the RLC index a quad of four threads owns it and a step
// is the four-lane step of bm_quad.cuh (the chosen child, its four run-hint
// walks at once on the run tables, and on 12-wide lanes its toehold), as
// in kernel E. The per-step entry "rlc" takes a quad a lane too, and one
// four-lane step a child (extend_all: four, the rows read again from the
// L1).
//
// Entries "table" (Vanilla) and "table_rlc" (RLC, 8 or 12 wide) build the
// k-mer seed table (index/kmer.py build_kmer_table; replaces the K
// lockstep extend_char calls of columba_tpu/index/kmer.py
// build_kmer_table, :48) in one launch: a thread (RLC: a quad) a k-mer walks
// its K backward steps from the full range, the step's char from the
// code's digits in registers (step s consumes digit s, the last char
// first), so no per-step char tensor is made. Thread t takes the code
// whose digits are t's in reverse order, so step s's char is digit K-1-s
// of t: the threads of a warp (or the quads of one) share t's high digits,
// so they walk the same range, and read the same rows, through every step
// but their last two or three, and part only there. Each step is
// extend_char's arithmetic, so the table is bit for bit what K calls of
// it leave, ranges that empty included: on the Vanilla index an empty
// range keeps stepping (extend_char zeroes only N), so a k-mer's lane runs
// all K steps; on the RLC index extend_char turns an empty range into the
// zero range, which every later step keeps, so the quad stops there.
//
// Bound: memory latency, not bandwidth or arithmetic. Vanilla: two random
// 64 B occ rows per lane and step; one thread reads its two rows with 16 B
// loads, so each row costs one 64 B transaction, and the four children fall
// out of those rows. RLC: about three dependent rounds a step (the two
// endpoint rows, an LF run where the rows are not c-runs, the longest of
// the four walks: 16 B reads of eight 4 B STARTs, a bucket read past them),
// where one thread walking the four hints in turn took about eight. A
// lane's steps depend on each other, so the loop's launch lasts as long as
// its longest lane; the card hides the chains' latency across lanes only:
// small blocks (64 threads, or 32 quads) spread the lanes over every SM,
// and a lane that stops early frees its slot.
#include "bm_quad.cuh"

namespace {

constexpr int kQuadThreads = 128;    // RLC: 32 lanes a block, a quad each

__global__ void extend_kernel(columba::FmParams fm,
                              const long long* __restrict__ ranges,
                              const int* __restrict__ dirs,
                              const int* __restrict__ chars,
                              long long* __restrict__ out, long long L) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= L) return;
  uint32_t r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) r[k] = static_cast<uint32_t>(ranges[4 * i + k]);
  const int c = chars == nullptr ? 0 : chars[i];
  if (c > 3) {                         // N never matches
#pragma unroll
    for (int k = 0; k < 4; ++k) out[4 * i + k] = 0;
    return;
  }
  columba::FmLane lane;
  lane.init(fm, columba::BmParams{}, r, dirs[i]);
  uint32_t o[4];
  if (chars == nullptr) {
    for (int c4 = 0; c4 < 4; ++c4) {
      columba::fm_child(lane, c4, o);
#pragma unroll
      for (int k = 0; k < 4; ++k) out[(4 * i + c4) * 4 + k] = o[k];
    }
    return;
  }
  columba::fm_child(lane, max(c, 0), o);
#pragma unroll
  for (int k = 0; k < 4; ++k) out[4 * i + k] = o[k];
}

// lane q of a quad writes columns q, q + 4 (and q + 8) of an RW-wide row
template <int RW>
__device__ __forceinline__ void quad_store(long long* __restrict__ row,
                                           const uint32_t* o, int q) {
#pragma unroll
  for (int b = 0; b < RW; b += 4) {
    uint32_t v = o[b];
#pragma unroll
    for (int k = 1; k < 4; ++k) v = k == q ? o[b + k] : v;
    row[b + q] = v;
  }
}

template <int RW>
__global__ void __launch_bounds__(kQuadThreads)
extend_rlc_kernel(columba::BmParams bm, columba::BmTables bt,
                  const long long* __restrict__ ranges,
                  const int* __restrict__ dirs,
                  const int* __restrict__ chars,
                  long long* __restrict__ out, long long L) {
  const long long i = (blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x) >> 2;
  if (i >= L) return;                  // a quad leaves together
  const int q = threadIdx.x & 3;
  const unsigned qmask = 0xFu << (threadIdx.x & 28);
  uint32_t r[RW];
#pragma unroll
  for (int k = 0; k < RW; ++k)
    r[k] = static_cast<uint32_t>(ranges[RW * i + k]);
  const int c = chars == nullptr ? 0 : chars[i];
  const int dir = dirs[i];
  // Neither an N (it never matches) nor an empty lane (its children are
  // all zero, hints included) needs a row: both write zeros.
  const bool zero = c > 3 || r[1] <= r[0];
  uint32_t o[RW];
  for (int c4 = 0; c4 < (chars == nullptr ? 4 : 1); ++c4) {
    if (zero) {
#pragma unroll
      for (int k = 0; k < RW; ++k) o[k] = 0u;
    } else {
      columba::quad_extend<RW>(bm, bt, r, chars == nullptr ? c4 : max(c, 0),
                               dir, q, qmask, o);
    }
    quad_store<RW>(out + (chars == nullptr ? 4 * i + c4 : i) * RW, o, q);
  }
}

int launch_rlc(const columba::BmParams& bm, const columba::BmTables& bt,
               const long long* ranges, const int* dirs, const int* chars,
               long long* out, long long L, int rw, cudaStream_t stream) {
  const unsigned grid = columba::grid_for(4 * L, kQuadThreads);
  if (rw == 8)
    extend_rlc_kernel<8><<<grid, kQuadThreads, 0, stream>>>(
        bm, bt, ranges, dirs, chars, out, L);
  else if (rw == 12)
    extend_rlc_kernel<12><<<grid, kQuadThreads, 0, stream>>>(
        bm, bt, ranges, dirs, chars, out, L);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kTableThreads = 128;   // Vanilla: a thread a k-mer

// the K 2-bit digits of t in reverse order: a table thread's k-mer code
__device__ __forceinline__ long long reverse_digits(uint32_t t, int K) {
  uint32_t code = 0;
  for (int s = 0; s < K; ++s) code = (code << 2) | ((t >> (2 * s)) & 3u);
  return code;
}

__global__ void __launch_bounds__(kTableThreads)
table_kernel(columba::FmParams fm, const long long* __restrict__ full, int K,
             long long* __restrict__ out, long long n) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= n) return;
  uint32_t r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) r[k] = static_cast<uint32_t>(__ldg(full + k));
  const uint32_t t = static_cast<uint32_t>(i);
  for (int s = 0; s < K; ++s) {
    columba::FmLane lane;
    lane.init(fm, columba::BmParams{}, r, 0);
    uint32_t o[4];
    columba::fm_child(lane, static_cast<int>((t >> (2 * (K - 1 - s))) & 3u),
                      o);
#pragma unroll
    for (int k = 0; k < 4; ++k) r[k] = o[k];
  }
  const long long code = reverse_digits(t, K);
#pragma unroll
  for (int k = 0; k < 4; ++k) out[4 * code + k] = r[k];
}

template <int RW>
__global__ void __launch_bounds__(kQuadThreads)
table_rlc_kernel(columba::BmParams bm, columba::BmTables bt,
                 const long long* __restrict__ full, int K,
                 long long* __restrict__ out, long long n) {
  const long long i = (blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x) >> 2;
  if (i >= n) return;                  // a quad leaves together
  const int q = threadIdx.x & 3;
  const unsigned qmask = 0xFu << (threadIdx.x & 28);
  uint32_t r[RW];
#pragma unroll
  for (int k = 0; k < RW; ++k) r[k] = static_cast<uint32_t>(__ldg(full + k));
  const uint32_t t = static_cast<uint32_t>(i);
  for (int s = 0; s < K; ++s) {
    if (r[1] <= r[0]) {                // empty: zero from here on
#pragma unroll
      for (int k = 0; k < RW; ++k) r[k] = 0u;
      break;
    }
    uint32_t o[RW];
    columba::quad_extend<RW>(
        bm, bt, r, static_cast<int>((t >> (2 * (K - 1 - s))) & 3u), 0, q,
        qmask, o);
#pragma unroll
    for (int k = 0; k < RW; ++k) r[k] = o[k];
  }
  quad_store<RW>(out + RW * reverse_digits(t, K), r, q);
}

struct LoopArgs {
  const long long* ranges;   // (L, RW) dead lanes all zero
  const int* ids;            // (L,) lane ids, or null: the lane's index
  long long L;
  const uint8_t* reads;      // (R, m)
  int m, S;
  const int* pos;            // exact-prefix tables: (E, S), or per lane
  const int* dirs;           //   (R*S, E) rows of `stride`
  const int* db;
  long long stride;
  int t_lo, t_hi, gate_t, switchpoint;
  long long* out;            // (L, RW)
  long long* drows;          // (L, 4)
};

// One body: a thread a lane on the Vanilla index (RW 4), a quad a lane on
// the RLC index; every lane of a quad holds the same range, so a quad
// leaves the loop together.
template <int RW>
__global__ void __launch_bounds__(RW == 4 ? 64 : kQuadThreads)
extend_loop_kernel(columba::FmParams fm, columba::BmParams bm,
                   columba::BmTables bt, LoopArgs a) {
  constexpr bool kQuad = RW > 4;
  const long long tid = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  const long long i = kQuad ? tid >> 2 : tid;
  if (i >= a.L) return;
  const int q = threadIdx.x & 3;
  const unsigned qmask = 0xFu << (threadIdx.x & 28);
  uint32_t r[RW];
#pragma unroll
  for (int k = 0; k < RW; ++k)
    r[k] = static_cast<uint32_t>(a.ranges[RW * i + k]);
  const int id = a.ids == nullptr ? static_cast<int>(i) : a.ids[i];
  const uint8_t* read = a.reads + static_cast<long long>(id / a.S) * a.m;
  const int sid = id % a.S;
  long long drow[4] = {0, 0, 0, 0};
  bool alive = r[1] > r[0];
  for (int t = a.t_lo; alive && t < a.t_hi; ++t) {
    const long long tix = a.stride ? static_cast<long long>(id) * a.stride + t
                                   : static_cast<long long>(t) * a.S + sid;
    const int pos = __ldg(a.pos + tix);
    if (pos >= 0) {
      const int c = __ldg(read + pos);
      if (c > 3) {                     // N never matches
        alive = false;
        break;
      }
      const int dir = __ldg(a.dirs + tix);
      uint32_t o[RW];
      if constexpr (kQuad) {
        columba::quad_extend<RW>(bm, bt, r, c, dir, q, qmask, o);
      } else {
        columba::FmLane lane;
        lane.init(fm, bm, r, dir);
        columba::fm_child(lane, c, o);
      }
#pragma unroll
      for (int k = 0; k < RW; ++k) r[k] = o[k];
      alive = r[1] > r[0];
    }
    if (alive && a.switchpoint > 0 && t >= a.gate_t &&
        r[1] - r[0] <= static_cast<uint32_t>(a.switchpoint)) {
      drow[0] = r[0];
      drow[1] = r[1];
      drow[2] = id;
      drow[3] = __ldg(a.db + tix);
      alive = false;
    }
  }
#pragma unroll
  for (int k = 0; k < RW; ++k) r[k] = alive ? r[k] : 0u;
  if constexpr (kQuad) {
    quad_store<RW>(a.out + RW * i, r, q);
    long long d = drow[0];
#pragma unroll
    for (int k = 1; k < 4; ++k) d = k == q ? drow[k] : d;
    a.drows[4 * i + q] = d;
  } else {
#pragma unroll
    for (int k = 0; k < RW; ++k) a.out[RW * i + k] = r[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) a.drows[4 * i + k] = drow[k];
  }
}

template <int RW>
int launch_loop(const columba::FmParams& fm, const columba::BmParams& bm,
                const columba::BmTables& bt, const LoopArgs& a,
                cudaStream_t stream) {
  constexpr int kThreads = RW == 4 ? 64 : kQuadThreads;
  const long long threads = RW == 4 ? a.L : 4 * a.L;
  extend_loop_kernel<RW><<<columba::grid_for(threads, kThreads), kThreads,
                           0, stream>>>(fm, bm, bt, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int columba_extend(const int* occ, long long blocks, unsigned c0,
                              unsigned c1, unsigned c2, unsigned c3,
                              unsigned d0, unsigned d1,
                              const long long* ranges, const int* dirs,
                              const int* chars, long long* out, long long L,
                              cudaStream_t stream) {
  constexpr int kThreads = 256;
  extend_kernel<<<columba::grid_for(L, kThreads), kThreads, 0, stream>>>(
      columba::fm_params(occ, blocks, c0, c1, c2, c3, d0, d1), ranges, dirs,
      chars, out, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int columba_extend_rlc(
    const int* fused, unsigned r_fwd, unsigned r_rev, unsigned f0,
    unsigned f1, unsigned f2, unsigned f3, unsigned n, const unsigned* starts,
    unsigned starts_rev, const int* run_at, const int* run_at_rev, int shift,
    const long long* ranges, const int* dirs, const int* chars,
    long long* out, long long L, int rw, cudaStream_t stream) {
  return launch_rlc(
      columba::bm_params(fused, r_fwd, r_rev, f0, f1, f2, f3, n),
      columba::bm_tables(starts, starts_rev, run_at, run_at_rev, shift),
      ranges, dirs, chars, out, L, rw, stream);
}

extern "C" int columba_extend_loop(
    const int* occ, long long blocks, unsigned c0, unsigned c1, unsigned c2,
    unsigned c3, unsigned d0, unsigned d1, const long long* ranges,
    const int* ids, long long L, const unsigned char* reads, int m, int S,
    const int* pos, const int* dirs, const int* db, long long stride,
    int t_lo, int t_hi, int gate_t, int switchpoint, long long* out,
    long long* drows, cudaStream_t stream) {
  if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const LoopArgs a{ranges, ids, L, reads, m, S, pos, dirs, db, stride,
                   t_lo, t_hi, gate_t, switchpoint, out, drows};
  return launch_loop<4>(
      columba::fm_params(occ, blocks, c0, c1, c2, c3, d0, d1),
      columba::BmParams{}, columba::BmTables{}, a, stream);
}

extern "C" int columba_extend_loop_rlc(
    const int* fused, unsigned r_fwd, unsigned r_rev, unsigned f0,
    unsigned f1, unsigned f2, unsigned f3, unsigned n, const unsigned* starts,
    unsigned starts_rev, const int* run_at, const int* run_at_rev, int shift,
    const long long* ranges, const int* ids, long long L,
    const unsigned char* reads, int m, int S, const int* pos,
    const int* dirs, const int* db, long long stride, int t_lo, int t_hi,
    int gate_t, int switchpoint, long long* out, long long* drows, int rw,
    cudaStream_t stream) {
  if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const columba::BmParams bm =
      columba::bm_params(fused, r_fwd, r_rev, f0, f1, f2, f3, n);
  const columba::BmTables bt =
      columba::bm_tables(starts, starts_rev, run_at, run_at_rev, shift);
  const LoopArgs a{ranges, ids, L, reads, m, S, pos, dirs, db, stride,
                   t_lo, t_hi, gate_t, switchpoint, out, drows};
  if (rw == 8) return launch_loop<8>(columba::FmParams{}, bm, bt, a, stream);
  if (rw == 12)
    return launch_loop<12>(columba::FmParams{}, bm, bt, a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// the k-mer seed table: 4^K rows from the full range `full` (one row)
extern "C" int columba_extend_table(const int* occ, long long blocks,
                                    unsigned c0, unsigned c1, unsigned c2,
                                    unsigned c3, unsigned d0, unsigned d1,
                                    const long long* full, int K,
                                    long long* out, cudaStream_t stream) {
  if (K < 1 || K > 15) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = 1LL << (2 * K);
  table_kernel<<<columba::grid_for(n, kTableThreads), kTableThreads, 0,
                 stream>>>(
      columba::fm_params(occ, blocks, c0, c1, c2, c3, d0, d1), full, K, out,
      n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int columba_extend_table_rlc(
    const int* fused, unsigned r_fwd, unsigned r_rev, unsigned f0,
    unsigned f1, unsigned f2, unsigned f3, unsigned n, const unsigned* starts,
    unsigned starts_rev, const int* run_at, const int* run_at_rev, int shift,
    const long long* full, int K, long long* out, int rw,
    cudaStream_t stream) {
  if (K < 1 || K > 15) return static_cast<int>(cudaErrorInvalidValue);
  const columba::BmParams bm =
      columba::bm_params(fused, r_fwd, r_rev, f0, f1, f2, f3, n);
  const columba::BmTables bt =
      columba::bm_tables(starts, starts_rev, run_at, run_at_rev, shift);
  const long long rows = 1LL << (2 * K);
  const unsigned grid = columba::grid_for(4 * rows, kQuadThreads);
  if (rw == 8)
    table_rlc_kernel<8><<<grid, kQuadThreads, 0, stream>>>(bm, bt, full, K,
                                                          out, rows);
  else if (rw == 12)
    table_rlc_kernel<12><<<grid, kQuadThreads, 0, stream>>>(bm, bt, full, K,
                                                           out, rows);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* columba_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
