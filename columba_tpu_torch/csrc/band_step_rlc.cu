// Kernel B, RLC entries: "rlc" on 8-wide lanes (K18 inside K7) and
// "textless" on 12-wide lanes with the colMin witness slots (K20,
// columba_tpu/search/pipeline.py _textless_device: run_scheme with
// track_arg). The body and its notes are in band_step.cuh; this file only
// instantiates it for the RLC lane widths (kept apart from band_step.cu so
// that the two compile in parallel).
//
// Bound: as the Vanilla entry, the two endpoint rows per active lane (four
// 16 B words each) and then, per child that stays in the frontier, the
// chains of dependent 4 B reads of its run-hint walks: latency, not bytes.
#include "band_step.cuh"

extern "C" int columba_band_step_rlc(
    const int* fused, unsigned r_fwd, unsigned r_rev, unsigned f0,
    unsigned f1, unsigned f2, unsigned f3, unsigned n,
    const long long* ranges, const int* ids, const signed char* band,
    const signed char* colmin, const int* mrow, int S,
    const signed char* pchars, int T, int t, int kb, int W, int switchpoint,
    long long* ch_ranges, int* new_ids, signed char* ch_band,
    signed char* ch_colmin, unsigned char* ch_alive, unsigned char* narrow,
    unsigned char* act_out, int* dbv_out, long long C, int rw,
    cudaStream_t stream) {
  columba_band::BandArgs a{};
  a.bm = columba::bm_params(fused, r_fwd, r_rev, f0, f1, f2, f3, n);
  if (!columba_band::common_args(a, ranges, ids, band, colmin, mrow, S,
                                 pchars, T, t, kb, W, switchpoint, ch_ranges,
                                 new_ids, ch_band, ch_colmin, ch_alive,
                                 narrow, act_out, dbv_out, C))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rw == 8) return columba_band::launch_static<8>(a, kb, W, stream);
  if (rw == 12) return columba_band::launch_static<12>(a, kb, W, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
