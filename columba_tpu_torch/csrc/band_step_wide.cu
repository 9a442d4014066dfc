// Kernel B's quad body (band_step_wide.cuh), Vanilla static entry: every
// kb 8..13 with W up to quad_max_w(kb). A source of its own, so that nvcc
// compiles it beside band_step.cu, whose launch_static calls it.
#include "band_step_wide.cuh"

namespace columba_band {

int launch_quad_static(const BandArgs& a, int kb, int W, cudaStream_t stream) {
  if (kb < 8 || kb > 13 || W < 1 || W > quad_max_w(kb)) return kNoQuad;
  switch (8 * kb + W) {
    case 8 * 8 + 1: return launch_quad<8, 1, false>(a, stream);
    case 8 * 8 + 2: return launch_quad<8, 2, false>(a, stream);
    case 8 * 9 + 1: return launch_quad<9, 1, false>(a, stream);
    case 8 * 9 + 2: return launch_quad<9, 2, false>(a, stream);
    case 8 * 9 + 3: return launch_quad<9, 3, false>(a, stream);
    case 8 * 10 + 1: return launch_quad<10, 1, false>(a, stream);
    case 8 * 10 + 2: return launch_quad<10, 2, false>(a, stream);
    case 8 * 10 + 3: return launch_quad<10, 3, false>(a, stream);
    case 8 * 11 + 1: return launch_quad<11, 1, false>(a, stream);
    case 8 * 11 + 2: return launch_quad<11, 2, false>(a, stream);
    case 8 * 11 + 3: return launch_quad<11, 3, false>(a, stream);
    case 8 * 12 + 1: return launch_quad<12, 1, false>(a, stream);
    case 8 * 12 + 2: return launch_quad<12, 2, false>(a, stream);
    case 8 * 12 + 3: return launch_quad<12, 3, false>(a, stream);
    case 8 * 12 + 4: return launch_quad<12, 4, false>(a, stream);
    case 8 * 13 + 1: return launch_quad<13, 1, false>(a, stream);
    case 8 * 13 + 2: return launch_quad<13, 2, false>(a, stream);
    case 8 * 13 + 3: return launch_quad<13, 3, false>(a, stream);
    case 8 * 13 + 4: return launch_quad<13, 4, false>(a, stream);
    default: return kNoQuad;
  }
}

}  // namespace columba_band
