// Kernel B's quad body (band_step_wide.cuh), Vanilla per-lane entry
// (dynamic partitioning, one register): kb 8..13. A source of its own, so
// that nvcc compiles it beside band_step.cu and band_step_wide.cu.
#include "band_step_wide.cuh"

namespace columba_band {

int launch_quad_per_lane(const BandArgs& a, int kb, cudaStream_t stream) {
  switch (kb) {
    case 8: return launch_quad<8, 1, true>(a, stream);
    case 9: return launch_quad<9, 1, true>(a, stream);
    case 10: return launch_quad<10, 1, true>(a, stream);
    case 11: return launch_quad<11, 1, true>(a, stream);
    case 12: return launch_quad<12, 1, true>(a, stream);
    case 13: return launch_quad<13, 1, true>(a, stream);
    default: return kNoQuad;
  }
}

}  // namespace columba_band
