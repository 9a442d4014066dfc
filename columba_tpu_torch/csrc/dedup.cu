// Kernel L: the (read, window) pairs before verification, deduplicated.
//
// Replaces columba_tpu/search/pipeline.py stage_dedup (:194-228) (K11) and
// the window starts match_device_core hands it (:262-266), around one sort
// that stays torch.sort(stable=True) (the JAX package leaves its
// jnp.lexsort to XLA, outside any kernel). Entries:
//
//   windows   one thread an expanded row: its read row c_rid[cand] and its
//             window start pos + estb[cand] - kb (signed: may be < 0).
//   keys      one thread a row: the sort key (rid_m << 32) | (win mod
//             2^32), rid_m = 2^30 on invalid rows (they sort last), the
//             window's low 32 bits unsigned as the reference orders them,
//             past 2^31 too; beside it the max_verify output slots cleared
//             (the compaction writes only the slots it fills).
//   compact   one thread a sorted row: the first row of each (rid, win)
//             run with a valid rid, compacted in order into max_verify
//             slots (common.cuh scan_tiles), with its rid (from the key)
//             and its full window start (from the row the sort's order
//             names); n_unique is the unclamped count.
//
// Bound: bytes. windows reads 32 B and writes 16 B a row (two gathers by
// cand); keys reads 17 B and writes 8 B; compact reads the sorted key, its
// predecessor and the order (24 B) and writes 17 B a kept row.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kBig = 1LL << 30;

__global__ void __launch_bounds__(kThreads)
windows_kernel(const long long* pos, const long long* c_rid,
               const long long* c_estb, const long long* cand, long long L,
               long long kb, long long* rid, long long* win) {
  const long long i = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  if (i >= L) return;
  const long long c = cand[i];
  rid[i] = c_rid[c];
  win[i] = pos[i] + c_estb[c] - kb;
}

__global__ void __launch_bounds__(kThreads)
keys_kernel(const long long* rid, const long long* win, const bool* valid,
            long long L, long long* key, long long* rid_v, long long* win_v,
            bool* vlive, long long mv) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long t = blockIdx.x * static_cast<long long>(kThreads) +
                      threadIdx.x;
  for (long long i = t; i < L; i += stride) {
    const bool v = valid[i];
    const unsigned long long rid_m = v ? rid[i] : kBig;
    const unsigned long long win_m =
        v ? static_cast<unsigned long long>(win[i]) & 0xFFFFFFFFull
          : 0xFFFFFFFFull;
    key[i] = static_cast<long long>((rid_m << 32) | win_m);
  }
  for (long long j = t; j < mv; j += stride) {
    rid_v[j] = 0;
    win_v[j] = 0;
    vlive[j] = false;
  }
}

struct CompactArgs {
  const long long* key_s;       // (L,) sorted keys
  const long long* order;       // (L,) the sort's permutation
  const long long* win;         // (L,) window starts, unsorted
  long long L, mv;
  long long* rid_v;             // (mv,)
  long long* win_v;
  bool* vlive;
  long long* n_unique;          // ()
  columba::ScanArgs sa;
};

__global__ void __launch_bounds__(kThreads) compact_kernel(CompactArgs a) {
  const long long tile = columba::take_tile(a.sa);
  const long long i = tile * kThreads + threadIdx.x;
  bool uniq = false;
  long long k = 0;
  if (i < a.L) {
    k = a.key_s[i];
    uniq = (i == 0 || k != a.key_s[i - 1]) && (k >> 32) < kBig;
  }
  unsigned long long end;
  const long long p = static_cast<long long>(
      columba::scan_tiles<kThreads>(uniq ? 1ull : 0ull, tile, a.sa, end));
  if (uniq && p < a.mv) {
    a.rid_v[p] = k >> 32;
    a.win_v[p] = a.win[a.order[i]];
    a.vlive[p] = true;
  }
  if (tile == gridDim.x - 1 && threadIdx.x == 0)
    *a.n_unique = static_cast<long long>(end);
}

inline unsigned grid(long long n) {
  return static_cast<unsigned>(n < 1 ? 1 : (n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int columba_dedup_windows(const long long* pos,
                                     const long long* c_rid,
                                     const long long* c_estb,
                                     const long long* cand, long long L,
                                     long long kb, long long* rid,
                                     long long* win, cudaStream_t stream) {
  if (L < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0) return 0;
  windows_kernel<<<grid(L), kThreads, 0, stream>>>(pos, c_rid, c_estb, cand,
                                                   L, kb, rid, win);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int columba_dedup_keys(const long long* rid, const long long* win,
                                  const bool* valid, long long L,
                                  long long* key, long long* rid_v,
                                  long long* win_v, bool* vlive, long long mv,
                                  cudaStream_t stream) {
  if (L < 0 || mv < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long most = L > mv ? L : mv;
  if (most == 0) return 0;
  const long long blocks = (most + kThreads - 1) / kThreads;
  keys_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                kThreads, 0, stream>>>(rid, win, valid, L, key, rid_v, win_v,
                                       vlive, mv);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int columba_dedup_compact(
    const long long* key_s, const long long* order, const long long* win,
    long long L, long long mv, long long* rid_v, long long* win_v,
    bool* vlive, long long* n_unique, long long* ticket, long long* status,
    long long tiles, unsigned epoch, cudaStream_t stream) {
  if (L < 1 || mv < 0 || grid(L) > tiles || epoch == 0 ||
      epoch > 0x3FFFFFFFu)
    return static_cast<int>(cudaErrorInvalidValue);
  CompactArgs a{key_s, order, win, L, mv, rid_v, win_v, vlive, n_unique,
                columba::ScanArgs{reinterpret_cast<unsigned long long*>(ticket),
                                  reinterpret_cast<unsigned long long*>(status),
                                  epoch}};
  compact_kernel<<<grid(L), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
