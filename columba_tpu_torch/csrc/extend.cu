// Kernel A: bidirectional extension of a frontier of ranges, and the exact
// prefix of the scheme executor in one launch.
//
// The main entry replaces columba_tpu/ops/extend.py extend_all /
// extend_char (with ops/rank.py occ_all) on the Vanilla index; the port
// runs it for the k-mer seed table build (index/kmer.py). Entry "rlc" (K18)
// replaces columba_tpu/ops/bextend.py extend_all (:103) / extend_char
// (:259) on the RLC index, on 8-wide lanes or 12-wide lanes with toeholds:
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
// thread walks its lane through steps t_lo..t_hi inside one launch, with
// ex_body's rules: a step whose ex_pos < 0 keeps the range; otherwise the
// lane extends by the read's code at ex_pos (a code > 3 empties it) in
// direction ex_dir, and an empty result is the zero range; with a
// switchpoint, a live range of width <= switchpoint at a step t >= gate_t
// drains: its drain row is [lo, hi, id, db_ex[t]] (that step's db_ex, so a
// lane narrow before the gate drains at the gate step) and the lane is
// zero. The thread stops at its first empty or drained range; later steps
// cannot revive it. It reads the schedule's (E, S) tables at [t, id % S]
// (per-read schedules: its own (R*S, E) rows at [id, t]) and its read's
// code straight from the (R, m) uint8 batch, so the (E, L) step tables of
// the JAX loop are never made. The JAX loop stops when no lane is live; a
// lane here stops alone, with the same result. One body, templated on the
// lane width RW; the extension is Lane<RW> of common.cuh, and on the RLC
// index a step walks the chosen child's run hints (and toehold) only.
//
// Bound: memory latency, not bandwidth or arithmetic. Vanilla: two random
// 64 B occ rows per lane and step; one thread reads its two rows with 16 B
// loads, so each row costs one 64 B transaction, and the four children fall
// out of those rows. RLC: two endpoint rows (four 16 B words each), then two
// 4 B LF-run reads and four run-hint walks per child walked, each a chain
// of dependent 4 B reads (START or END of the next run; after 16 steps a
// binary search, about log2 r reads). A lane's steps depend on each other,
// so the loop's launch lasts as long as its longest lane; the card hides
// the chains' latency across lanes only: 64-thread blocks spread the lanes
// over every SM, and a lane that stops early frees its slot.
#include "common.cuh"

namespace {

template <int RW>
__global__ void extend_kernel(columba::FmParams fm, columba::BmParams bm,
                              const long long* __restrict__ ranges,
                              const int* __restrict__ dirs,
                              const int* __restrict__ chars,
                              long long* __restrict__ out, long long L) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= L) return;
  uint32_t r[RW];
#pragma unroll
  for (int k = 0; k < RW; ++k)
    r[k] = static_cast<uint32_t>(ranges[RW * i + k]);
  const int c = chars == nullptr ? 0 : chars[i];
  // Neither an N (it never matches) nor, on the RLC index, an empty lane
  // (its children are all zero, hints included) needs a row: both write
  // zeros. The Vanilla children of an empty range keep their positions.
  if (c > 3 || (RW != 4 && r[1] <= r[0])) {
    const int w = chars == nullptr ? 4 * RW : RW;
    for (int k = 0; k < w; ++k) out[w * i + k] = 0;
    return;
  }
  columba::Lane<RW> lane;
  lane.init(fm, bm, r, dirs[i]);
  uint32_t o[RW];
  if (chars == nullptr) {
    for (int c4 = 0; c4 < 4; ++c4) {
      columba::child_of<RW>(lane, bm, c4, o);
#pragma unroll
      for (int k = 0; k < RW; ++k) out[(4 * i + c4) * RW + k] = o[k];
    }
    return;
  }
  columba::child_of<RW>(lane, bm, max(c, 0), o);
#pragma unroll
  for (int k = 0; k < RW; ++k) out[RW * i + k] = o[k];
}

template <int RW>
int launch(const columba::FmParams& fm, const columba::BmParams& bm,
           const long long* ranges, const int* dirs, const int* chars,
           long long* out, long long L, cudaStream_t stream) {
  constexpr int kThreads = RW == 4 ? 256 : 64;
  extend_kernel<RW><<<columba::grid_for(L, kThreads), kThreads, 0, stream>>>(
      fm, bm, ranges, dirs, chars, out, L);
  return static_cast<int>(cudaGetLastError());
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

template <int RW>
__global__ void extend_loop_kernel(columba::FmParams fm,
                                   columba::BmParams bm, LoopArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (i >= a.L) return;
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
      columba::Lane<RW> lane;
      lane.init(fm, bm, r, __ldg(a.dirs + tix));
      uint32_t o[RW];
      columba::child_of<RW>(lane, bm, c, o);
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
  for (int k = 0; k < RW; ++k) a.out[RW * i + k] = alive ? r[k] : 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) a.drows[4 * i + k] = drow[k];
}

template <int RW>
int launch_loop(const columba::FmParams& fm, const columba::BmParams& bm,
                const LoopArgs& a, cudaStream_t stream) {
  constexpr int kThreads = 64;
  extend_loop_kernel<RW><<<columba::grid_for(a.L, kThreads), kThreads, 0,
                           stream>>>(fm, bm, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int columba_extend(const int* occ, long long blocks, unsigned c0,
                              unsigned c1, unsigned c2, unsigned c3,
                              unsigned d0, unsigned d1,
                              const long long* ranges, const int* dirs,
                              const int* chars, long long* out, long long L,
                              cudaStream_t stream) {
  return launch<4>(columba::fm_params(occ, blocks, c0, c1, c2, c3, d0, d1),
                   columba::BmParams{}, ranges, dirs, chars, out, L, stream);
}

extern "C" int columba_extend_rlc(const int* fused, unsigned r_fwd,
                                  unsigned r_rev, unsigned f0, unsigned f1,
                                  unsigned f2, unsigned f3, unsigned n,
                                  const long long* ranges, const int* dirs,
                                  const int* chars, long long* out,
                                  long long L, int rw, cudaStream_t stream) {
  const columba::BmParams bm =
      columba::bm_params(fused, r_fwd, r_rev, f0, f1, f2, f3, n);
  const columba::FmParams fm{};
  if (rw == 8) return launch<8>(fm, bm, ranges, dirs, chars, out, L, stream);
  if (rw == 12) return launch<12>(fm, bm, ranges, dirs, chars, out, L, stream);
  return static_cast<int>(cudaErrorInvalidValue);
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
      columba::BmParams{}, a, stream);
}

extern "C" int columba_extend_loop_rlc(
    const int* fused, unsigned r_fwd, unsigned r_rev, unsigned f0,
    unsigned f1, unsigned f2, unsigned f3, unsigned n,
    const long long* ranges, const int* ids, long long L,
    const unsigned char* reads, int m, int S, const int* pos,
    const int* dirs, const int* db, long long stride, int t_lo, int t_hi,
    int gate_t, int switchpoint, long long* out, long long* drows, int rw,
    cudaStream_t stream) {
  if (S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const columba::BmParams bm =
      columba::bm_params(fused, r_fwd, r_rev, f0, f1, f2, f3, n);
  const LoopArgs a{ranges, ids, L, reads, m, S, pos, dirs, db, stride,
                   t_lo, t_hi, gate_t, switchpoint, out, drows};
  if (rw == 8) return launch_loop<8>(columba::FmParams{}, bm, a, stream);
  if (rw == 12) return launch_loop<12>(columba::FmParams{}, bm, a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* columba_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
