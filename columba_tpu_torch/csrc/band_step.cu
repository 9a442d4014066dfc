// Kernel B, Vanilla entries: the static-schedule entries (kb 0..7 x W 1..2
// templated; they take the reads and the schedule's cell table, `pchars`
// null) and the per-lane entry of dynamic partitioning (kb 0..7 templated;
// kernel G's `pchars`, the others null), each with the quad body at kb
// 8..13 (band_step_wide.cu, band_step_wide_lane.cu) and a generic entry
// above, which `generic` forces. The body and its notes are in
// band_step.cuh, the quad body's in band_step_wide.cuh.
#include "band_step.cuh"

using columba_band::BandArgs;

extern "C" int columba_band_step(
    const int* occ, long long blocks, unsigned c0, unsigned c1, unsigned c2,
    unsigned c3, unsigned d0, unsigned d1, const long long* ranges,
    const int* ids, const signed char* band, const signed char* colmin,
    const int* mrow, int S, const int* dyn_meta, const signed char* pchars,
    const unsigned char* reads, long long m, const int* cells, int T, int t,
    int kb, int W, int switchpoint,
    long long n_live,
    long long cap, long long* o_ranges, int* o_ids, signed char* o_band,
    signed char* o_colmin, long long* itv, long long M, long long cnt,
    unsigned long long* ctr, unsigned long long* status, long long tiles,
    unsigned epoch, int generic, cudaStream_t stream) {
  BandArgs a{};
  a.fm = columba::fm_params(occ, blocks, c0, c1, c2, c3, d0, d1);
  if (!columba_band::common_args(a, ranges, ids, band, colmin, mrow, S,
                                 pchars, reads, m, cells, T, t, kb, W,
                                 switchpoint, n_live,
                                 cap, o_ranges, o_ids, o_band, o_colmin, itv,
                                 M, cnt, ctr, status, tiles, epoch))
    return static_cast<int>(cudaErrorInvalidValue);
  a.dyn_meta = dyn_meta;
  if (dyn_meta != nullptr)       // per-lane entry
    return columba_band::launch_per_lane<4>(a, kb, W, stream,
                                            generic != 0);
  return columba_band::launch_static<4>(a, kb, W, stream, generic != 0);
}
