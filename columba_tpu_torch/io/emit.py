"""Native (C++) single-end SAM emission.

The counterpart of the single-end part of ``columba_tpu/io/emit.py``: the
traceback DP, CIGAR and line formatting of a whole batch run in C++
(``columba_tpu/native/emit.cpp``, built by ``columba_tpu_torch.native``,
internally threaded, GIL released), with the occurrence bookkeeping done as
vectorized numpy on :class:`~columba_tpu_torch.search.pipeline.OccArray`.
"""

from __future__ import annotations

import ctypes

import numpy as np

from columba_tpu_torch import native

_LIB = None
_LIB_TRIED = False


def _lib():
    global _LIB, _LIB_TRIED
    if not _LIB_TRIED:
        _LIB_TRIED = True
        lib = native.load("emit", ["emit.cpp"])
        if lib is not None:
            lib.emit_sam_se.restype = ctypes.c_int64
            lib.emit_sam_se.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,  # codes
                ctypes.c_void_p, ctypes.c_void_p,                 # names
                ctypes.c_void_p, ctypes.c_void_p,                 # quals
                ctypes.c_void_p, ctypes.c_void_p,                 # occ off/end
                ctypes.c_void_p, ctypes.c_void_p,                 # dist/strand
                ctypes.c_void_p,                                  # nbest_pre
                ctypes.c_void_p, ctypes.c_int64,                  # text
                ctypes.c_void_p, ctypes.c_int32,                  # seq_starts
                ctypes.c_void_p, ctypes.c_void_p,                 # seqnames
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32,                                   # kb/xa/unm/cig
                ctypes.c_int32,                                   # n_threads
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,  # out
            ]
        _LIB = lib
    return _LIB


def available() -> bool:
    return _lib() is not None


def pack_strings(strings, encode: bool = True):
    """list of str/bytes -> (joined bytes, int64 offsets)."""
    bs = [s.encode() if encode and isinstance(s, str) else s
          for s in strings]
    offs = np.zeros(len(bs) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in bs], out=offs[1:])
    return b"".join(bs), offs


class SeqNameCache:
    """Per-index cached seqname buffer + offsets for the native call."""

    def __init__(self, arrays):
        self.buf, self.offs = pack_strings(arrays.seq_names)
        self.starts = np.ascontiguousarray(arrays.seq_starts,
                                           dtype=np.int64)
        self.n_seqs = len(arrays.seq_names)


_SEQNAME_CACHE: dict = {}


def seqname_cache(arrays) -> SeqNameCache:
    key = id(arrays)
    ent = _SEQNAME_CACHE.get(key)
    if ent is None or ent[0] is not arrays:
        ent = (arrays, SeqNameCache(arrays))
        _SEQNAME_CACHE[key] = ent
    return ent[1]


def occ_groups(occs, n_reads: int):
    """Sort occurrences into emission order and group per read.

    Emission order within a read mirrors strategy.emit_sam's
    ``sorted(mr.occs, key=(distance, begin, strand))``. Returns
    (occ_off (R+1,) int64, end, dist, strand, nbest_pre (R,) int32).
    """
    order = np.lexsort((occs.strand, occs.begin, occs.distance,
                        occs.read_id))
    rid = occs.read_id[order]
    end = np.ascontiguousarray(occs.end[order], dtype=np.int64)
    dist = np.ascontiguousarray(occs.distance[order], dtype=np.int32)
    strand = np.ascontiguousarray(occs.strand[order], dtype=np.uint8)
    occ_off = np.searchsorted(rid, np.arange(n_reads + 1),
                              side="left").astype(np.int64)
    sizes = np.diff(occ_off)
    nbest = np.zeros(n_reads, dtype=np.int32)
    nz = sizes > 0
    if nz.any():
        best_per_read = np.zeros(n_reads, dtype=np.int64)
        best_per_read[nz] = dist[occ_off[:-1][nz]]
        is_best = dist == best_per_read[rid]
        nbest = np.bincount(rid[is_best],
                            minlength=n_reads).astype(np.int32)
    return occ_off, end, dist, strand, nbest


def emit_sam_native(
    codes: np.ndarray,
    names_buf: bytes, name_offs: np.ndarray,
    quals_buf: bytes, qual_offs: np.ndarray,
    occs,
    arrays,
    genome: np.ndarray,
    kb: int,
    xa_tag: bool = False,
    unmapped_records: bool = True,
    with_cigar: bool = True,
    n_threads: int = 3,
    counters=None,
) -> bytes | None:
    """Emit one batch of SE SAM records natively; None if lib unavailable.

    codes: (R, m) uint8 contiguous forward-strand reads; occs: OccArray
    with read_id in [0, R).
    """
    lib = _lib()
    if lib is None:
        return None
    R, m = codes.shape
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    sn = seqname_cache(arrays)
    occ_off, end, dist, strand, nbest = occ_groups(occs, R)
    name_offs = np.ascontiguousarray(name_offs, dtype=np.int64)
    qual_offs = np.ascontiguousarray(qual_offs, dtype=np.int64)

    n_occ = len(end)
    name_bytes_per_occ = int(
        (name_offs[1:] - name_offs[:-1])[occs.read_id].sum()) if n_occ else 0
    cap = (len(names_buf) + len(quals_buf) + R * (m + 64)
           + name_bytes_per_occ + n_occ * (2 * m + 4 * (2 * m + kb) + 128)
           + 1024)
    stats = np.zeros(4, dtype=np.int64)
    for _ in range(2):
        out = ctypes.create_string_buffer(cap)
        n = lib.emit_sam_se(
            codes.ctypes.data, R, m,
            names_buf, name_offs.ctypes.data,
            quals_buf, qual_offs.ctypes.data,
            occ_off.ctypes.data, end.ctypes.data,
            dist.ctypes.data, strand.ctypes.data,
            nbest.ctypes.data,
            genome.ctypes.data, genome.shape[0],
            sn.starts.ctypes.data, sn.n_seqs,
            sn.buf, sn.offs.ctypes.data,
            int(kb), int(bool(xa_tag)), int(bool(unmapped_records)),
            int(bool(with_cigar)), int(n_threads),
            out, cap, stats.ctypes.data,
        )
        if n >= 0:
            if counters is not None:
                counters.cigars_computed += int(stats[0])
            return out.raw[:n]
        cap = -n + 1024
    raise RuntimeError("emit_sam_se: buffer sizing failed twice")

