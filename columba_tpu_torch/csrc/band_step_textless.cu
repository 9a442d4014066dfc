// Kernel B, textless entry (K20, columba_tpu/search/pipeline.py
// _textless_device: run_scheme with track_arg): 12-wide lanes with the
// colMin witness slots, templated at kb 0..7 x W 1..2, with the generic
// entry above, which `generic` forces. The body and its notes are in
// band_step.cuh, the bound in band_step_rlc.cu; this file instantiates the
// body for 12-wide lanes (a source of its own so that it compiles beside
// band_step_rlc.cu).
#include "band_step_rlc.cuh"

extern "C" int columba_band_step_textless(COLUMBA_BAND_RLC_PARAMS) {
  columba_band::BandArgs a{};
  if (!columba_band::rlc_args(a, COLUMBA_BAND_RLC_ARGS) || rw != 12 ||
      dyn_meta != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return columba_band::launch_static<12>(a, kb, W, stream, generic != 0);
}
