// Kernel B, RLC entries on 8-wide lanes: "rlc" (K18 inside K7) and
// "per_lane_rlc" under per-read schedules (K7 per-lane on RLC: dynamic
// partitioning on the RLC index; one register). Both are templated at
// kb 0..7 (W 1..2, per-lane W 1), with the generic entry above, which
// `generic` forces. The body and its notes are in band_step.cuh; this file
// only instantiates it for 8-wide lanes, and band_step_textless.cu for the
// textless index's 12-wide lanes (kept apart from band_step.cu and from
// each other so that the three compile in parallel).
//
// Bound: as the Vanilla entries, the two endpoint rows per active lane (four
// 16 B words each) and then, per child that stays in the frontier, the
// chain of its run-hint walks on the run tables, a quad of threads a child
// (bm_quad.cuh): latency, not bytes. The walks run after the block has
// published its counts, so no later block waits on them.
#include "band_step_rlc.cuh"

extern "C" int columba_band_step_rlc(COLUMBA_BAND_RLC_PARAMS) {
  columba_band::BandArgs a{};
  if (!columba_band::rlc_args(a, COLUMBA_BAND_RLC_ARGS))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rw != 8) return static_cast<int>(cudaErrorInvalidValue);
  if (dyn_meta != nullptr)       // per-lane entry
    return columba_band::launch_per_lane<8>(a, kb, W, stream, generic != 0);
  return columba_band::launch_static<8>(a, kb, W, stream, generic != 0);
}
