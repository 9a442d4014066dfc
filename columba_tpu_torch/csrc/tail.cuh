// Kernel J's work on one row of the final frontier, shared by its own
// entry (frontier.cu tail) and by kernel K's frontier_tail entry
// (expand.cu), which does it in the launch that makes the candidates.
//
// Replaces columba_tpu/search/executor.py:880-932 (K8): after a move the
// rows past the live count are zeroed in place; the lane id is decoded into
// rid and sid (a ghost, id < 0, keeps its lane id in bits 0-20 and its
// death depth in bits 21-30); the final colMin register of each side (one
// register on both sides under per-lane schedules; the back register's
// witness is arg_b where colMin has 2W slots) gives ed_lb, and done is a
// live, non-ghost lane with ed_lb <= u_last[sid].
#pragma once

#include "common.cuh"

namespace columba {

constexpr int kGhostIdMask = (1 << 21) - 1;

struct TailRows {
  long long* ranges;            // (cap, rw) the final frontier (in place)
  int* ids;                     // (cap,)
  signed char* band;            // (cap, 2, bw)
  signed char* colmin;          // (cap, 2, Wp)
  long long live;
  int moved, rw, bw, W, Wp, track, S;
  const long long* final_reg;   // (S, 2), or null: per lane, register 0
  const long long* u_last64;    // (S,) int64, or
  const int* u_last32;          // (S,) int32 (per-lane schedules)
  long long* rid;               // (cap,) out
  long long* sid;
  long long* ed_lb;
  bool* done;
  signed char* arg_b;
};

// Row i of the final frontier as the tail leaves it: its range's ends, its
// raw id (ghost where < 0), its decoded lane id, ed_lb, arg_b and done;
// `zero` where the row is zeroed (past the live count after a move: read
// as all zeros).
struct TailRow {
  long long lo, hi, ed;
  int id;
  unsigned lane;
  signed char arg;
  bool done, zero;
};

// Reads row i (loads only, so that a thread's rows overlap their reads).
__device__ __forceinline__ TailRow tail_read(const TailRows& a, long long i) {
  TailRow o{0, 0, 0, 0, 0u, -1, false, a.moved && i >= a.live};
  if (!o.zero) {
    const long long* r = a.ranges + i * a.rw;
    o.lo = r[0];
    o.hi = r[1];
    o.id = a.ids[i];
  }
  // a lane id is below 2^21: 32-bit division
  o.lane = static_cast<unsigned>(o.id & kGhostIdMask);
  const unsigned s = o.lane % static_cast<unsigned>(a.S);
  const signed char* cm = a.colmin + i * 2 * a.Wp;
  long long cm_b = 0, cm_f = 0;
  if (a.final_reg == nullptr) {
    cm_b = o.zero ? 0 : cm[0];
    cm_f = o.zero ? 0 : cm[a.Wp];
  } else {
    const long long f0 = a.final_reg[2 * s], f1 = a.final_reg[2 * s + 1];
    for (int w = 0; w < a.W; ++w) {
      if (f0 == w) {
        cm_b = o.zero ? 0 : cm[w];
        if (a.track) o.arg = o.zero ? 0 : cm[a.W + w];
      }
      if (f1 == w) cm_f = o.zero ? 0 : cm[a.Wp + w];
    }
  }
  o.ed = cm_b + cm_f;
  const long long ub = a.u_last64 != nullptr ? a.u_last64[s]
                                             : a.u_last32[s];
  o.done = o.hi > o.lo && o.id >= 0 && o.ed <= ub;
  return o;
}

// Writes row i: zeroed where it is past the live count after a move
// (unless `zero` is false: zero_past_live does it), and J's outputs.
__device__ __forceinline__ void tail_write(const TailRows& a, long long i,
                                           const TailRow& o,
                                           bool zero = true) {
  if (zero && o.zero) {
    long long* r = a.ranges + i * a.rw;
    for (int k = 0; k < a.rw; ++k) r[k] = 0;
    a.ids[i] = 0;
    for (int k = 0; k < 2 * a.bw; ++k) a.band[i * 2 * a.bw + k] = 0;
    for (int k = 0; k < 2 * a.Wp; ++k) a.colmin[i * 2 * a.Wp + k] = 0;
  }
  const unsigned S = static_cast<unsigned>(a.S);
  a.rid[i] = o.lane / S;
  a.sid[i] = o.lane % S;
  a.ed_lb[i] = o.ed;
  a.done[i] = o.done;
  a.arg_b[i] = o.arg;
}

// The rows [live, cap) of the frontier's fields zeroed after a move, each
// field's rows one contiguous span (16 B stores), by thread t of `stride`.
__device__ __forceinline__ void zero_past_live(const TailRows& a,
                                               long long cap, long long t,
                                               long long stride) {
  if (!a.moved || a.live >= cap) return;
  const long long r = cap - a.live;
  fill_bytes(a.ranges + a.live * a.rw, r * a.rw * 8, 0, t, stride);
  fill_bytes(a.ids + a.live, r * 4, 0, t, stride);
  fill_bytes(a.band + a.live * 2 * a.bw, r * 2 * a.bw, 0, t, stride);
  fill_bytes(a.colmin + a.live * 2 * a.Wp, r * 2 * a.Wp, 0, t, stride);
}

// A ghost's row of the in-text buffer: [lo, hi, lane id, death depth].
__device__ __forceinline__ void ghost_row(long long* itv, long long q,
                                          const TailRow& g) {
  long long* row = itv + 4 * q;
  row[0] = g.lo;
  row[1] = g.hi;
  row[2] = g.lane;
  row[3] = (g.id >> 21) & 1023;
}

}  // namespace columba
