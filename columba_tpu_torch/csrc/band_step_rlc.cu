// Kernel B, RLC entries: "rlc" on 8-wide lanes (K18 inside K7),
// "textless" on 12-wide lanes with the colMin witness slots (K20,
// columba_tpu/search/pipeline.py _textless_device: run_scheme with
// track_arg), and "per_lane_rlc" on 8-wide lanes under per-read schedules
// (K7 per-lane on RLC: dynamic partitioning on the RLC index; one register,
// kb 0..4 templated, the generic entry above). The body and its notes are
// in band_step.cuh; this file only instantiates it for the RLC lane widths
// (kept apart from band_step.cu so that the two compile in parallel).
//
// Bound: as the Vanilla entries, the two endpoint rows per active lane (four
// 16 B words each) and then, per child that stays in the frontier, the
// chains of dependent 4 B reads of its run-hint walks: latency, not bytes.
// The walks run after the block has published its counts, so no later
// block waits on them.
#include "band_step.cuh"

extern "C" int columba_band_step_rlc(
    const int* fused, unsigned r_fwd, unsigned r_rev, unsigned f0,
    unsigned f1, unsigned f2, unsigned f3, unsigned n,
    const long long* ranges, const int* ids, const signed char* band,
    const signed char* colmin, const int* mrow, int S, const int* dyn_meta,
    const signed char* pchars, int T, int t, int kb, int W, int switchpoint,
    long long n_live, long long cap, long long* o_ranges, int* o_ids,
    signed char* o_band, signed char* o_colmin, long long* itv, long long M,
    long long cnt, unsigned long long* ctr, unsigned long long* status,
    long long tiles, unsigned epoch, int rw, cudaStream_t stream) {
  columba_band::BandArgs a{};
  a.bm = columba::bm_params(fused, r_fwd, r_rev, f0, f1, f2, f3, n);
  if (!columba_band::common_args(a, ranges, ids, band, colmin, mrow, S,
                                 pchars, T, t, kb, W, switchpoint, n_live,
                                 cap, o_ranges, o_ids, o_band, o_colmin, itv,
                                 M, cnt, ctr, status, tiles, epoch))
    return static_cast<int>(cudaErrorInvalidValue);
  a.dyn_meta = dyn_meta;
  if (dyn_meta != nullptr)       // per-lane entry: 8-wide lanes only
    return rw == 8 ? columba_band::launch_per_lane<8>(a, kb, W, stream)
                   : static_cast<int>(cudaErrorInvalidValue);
  if (rw == 8) return columba_band::launch_static<8>(a, kb, W, stream);
  if (rw == 12) return columba_band::launch_static<12>(a, kb, W, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
