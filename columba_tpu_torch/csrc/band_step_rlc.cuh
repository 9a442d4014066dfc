// Kernel B's RLC entries' shared C signature and argument fill (the b-move
// index's arrays and run tables, then the arguments of every entry), for
// band_step_rlc.cu and band_step_textless.cu.
#pragma once

#include "band_step.cuh"

#define COLUMBA_BAND_RLC_PARAMS                                              \
  const int *fused, unsigned r_fwd, unsigned r_rev, unsigned f0,             \
      unsigned f1, unsigned f2, unsigned f3, unsigned n,                     \
      const unsigned *starts, unsigned starts_rev, const int *run_at,        \
      const int *run_at_rev, int shift, const long long *ranges,             \
      const int *ids, const signed char *band, const signed char *colmin,    \
      const int *mrow, int S, const int *dyn_meta,                           \
      const signed char *pchars, const unsigned char *reads, long long m,    \
      const int *cells, int T, int t, int kb, int W, int switchpoint,        \
      long long n_live, long long cap, long long *o_ranges, int *o_ids,      \
      signed char *o_band, signed char *o_colmin, long long *itv,            \
      long long M, long long cnt, unsigned long long *ctr,                   \
      unsigned long long *status, long long tiles, unsigned epoch, int rw,   \
      int block, int generic, cudaStream_t stream

#define COLUMBA_BAND_RLC_ARGS                                                \
  fused, r_fwd, r_rev, f0, f1, f2, f3, n, starts, starts_rev, run_at,        \
      run_at_rev, shift, ranges, ids, band, colmin, mrow, S, dyn_meta,       \
      pchars, reads, m, cells, T, t, kb, W, switchpoint, n_live, cap,        \
      o_ranges, o_ids, o_band, o_colmin, itv, M, cnt, ctr, status, tiles,    \
      epoch, block

namespace columba_band {

inline bool rlc_args(
    BandArgs& a, const int* fused, unsigned r_fwd, unsigned r_rev,
    unsigned f0, unsigned f1, unsigned f2, unsigned f3, unsigned n,
    const unsigned* starts, unsigned starts_rev, const int* run_at,
    const int* run_at_rev, int shift, const long long* ranges, const int* ids,
    const signed char* band, const signed char* colmin, const int* mrow,
    int S, const int* dyn_meta, const signed char* pchars,
    const unsigned char* reads, long long m, const int* cells, int T, int t,
    int kb, int W, int switchpoint, long long n_live, long long cap,
    long long* o_ranges, int* o_ids, signed char* o_band,
    signed char* o_colmin, long long* itv, long long M, long long cnt,
    unsigned long long* ctr, unsigned long long* status, long long tiles,
    unsigned epoch, int block) {
  a.block = block;
  a.bm = columba::bm_params(fused, r_fwd, r_rev, f0, f1, f2, f3, n);
  a.bt = columba::bm_tables(starts, starts_rev, run_at, run_at_rev, shift);
  if (!common_args(a, ranges, ids, band, colmin, mrow, S, pchars, reads, m,
                   cells, T, t, kb, W, switchpoint, n_live, cap, o_ranges,
                   o_ids, o_band, o_colmin, itv, M, cnt, ctr, status, tiles,
                   epoch))
    return false;
  a.dyn_meta = dyn_meta;
  return true;
}

}  // namespace columba_band
