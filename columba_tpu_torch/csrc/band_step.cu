// Kernel B, Vanilla entries: the static-schedule entries (kb 0..4 x W 1..2
// templated, a generic entry above) and the per-lane entry of dynamic
// partitioning. The body and its notes are in band_step.cuh.
#include "band_step.cuh"

using columba_band::BandArgs;

extern "C" int columba_band_step(
    const int* occ, long long blocks, unsigned c0, unsigned c1, unsigned c2,
    unsigned c3, unsigned d0, unsigned d1, const long long* ranges,
    const int* ids, const signed char* band, const signed char* colmin,
    const int* mrow, int S, const int* dyn_meta, const signed char* pchars,
    int T, int t, int kb, int W, int switchpoint, long long n_live,
    long long cap, long long* o_ranges, int* o_ids, signed char* o_band,
    signed char* o_colmin, long long* itv, long long M, long long cnt,
    unsigned long long* ctr, unsigned long long* status, long long tiles,
    unsigned epoch, cudaStream_t stream) {
  BandArgs a{};
  a.fm = columba::fm_params(occ, blocks, c0, c1, c2, c3, d0, d1);
  if (!columba_band::common_args(a, ranges, ids, band, colmin, mrow, S,
                                 pchars, T, t, kb, W, switchpoint, n_live,
                                 cap, o_ranges, o_ids, o_band, o_colmin, itv,
                                 M, cnt, ctr, status, tiles, epoch))
    return static_cast<int>(cudaErrorInvalidValue);
  a.dyn_meta = dyn_meta;
  if (dyn_meta != nullptr)       // per-lane entry
    return columba_band::launch_per_lane<4>(a, kb, W, stream);
  return columba_band::launch_static<4>(a, kb, W, stream);
}
