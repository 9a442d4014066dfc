"""Suffix-array construction (host side).

Three implementations:
  - a native parallel bucket sort (``csrc/host/bucket_sa.cpp``), first: on
    every core, for texts whose repeats are shorter than ``BUCKET_DEPTH``
    bases (it gives up on a deeper one);
  - native C++ SA-IS (``csrc/host/sais.cpp``), one thread, any text — the
    role libsais/divsufsort play in the reference build
    (reference: src/buildindex.cpp:479-538);
  - a numpy prefix-doubling fallback (O(n log^2 n), vectorized).
All three give the same array: a suffix array is unique.

All operate on the *sentinel-free* text; a virtual smallest sentinel at
position n is assumed (i.e. shorter suffixes sort before longer ones on ties),
matching the semantics of a text terminated by a unique smallest ``$``.
The caller appends the explicit ``$`` row itself (see index.build).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from columba_tpu_torch import native

BUCKET_DEPTH = 1024  # shared prefix past which the bucket sort gives up


def suffix_array(text_codes: np.ndarray, method: str = "auto",
                 threads: int | None = None) -> np.ndarray:
    """Suffix array (n entries) of text_codes (uint8, no sentinel), the
    bucket sort on ``threads`` threads (default: a core each).

    Returned dtype is uint32 when the native kernel handled it (n < 2^32-1)
    and int64 otherwise — callers treat values as non-negative row indices.
    """
    text_codes = np.ascontiguousarray(text_codes, dtype=np.uint8)
    n = len(text_codes)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if method in ("auto", "native"):
        sa = _sais_native(text_codes, threads or _threads())
        if sa is not None:
            return sa
        if method == "native":
            raise RuntimeError("native sais unavailable")
    return _prefix_doubling(text_codes)


def _threads() -> int:
    return len(os.sched_getaffinity(0))


def bwt_rows(text_codes: np.ndarray, sa: np.ndarray,
             threads: int | None = None) -> tuple[np.ndarray, int]:
    """BWT of text + '$' in rows (n + 1, the '$' row first) from the suffix
    array, with the '$' slot stored as code 0; returns (codes, '$' row).
    One native gather on ``threads`` threads (default: a core each) for a
    uint32 SA, numpy chunks otherwise."""
    n = len(text_codes)
    out = np.empty(n + 1, dtype=np.uint8)
    lib = native.load("sais_tpu", ["sais.cpp", "bucket_sa.cpp"])
    if lib is not None and sa.dtype == np.uint32 and n > 0:
        fn = lib.bwt_u32
        fn.restype = ctypes.c_int64
        row = fn(text_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                 ctypes.c_int64(n),
                 sa.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                 ctypes.c_int(threads or _threads()))
        if row < 0:
            raise RuntimeError(f"bwt_u32 failed ({row})")
        return out, int(row)
    row = int(np.nonzero(sa == 0)[0][0]) + 1  # +1: '$' row first
    out[0] = text_codes[n - 1]
    CH = 1 << 26
    for lo in range(0, n, CH):
        hi = min(lo + CH, n)
        seg = sa[lo:hi]
        # seg may be uint32: guard the 0-1 wrap instead of clamping
        idx = np.where(seg == 0, seg, seg - 1)
        out[lo + 1:hi + 1] = text_codes[idx]
    out[row] = 0
    return out, row


def _sais_native(text_codes: np.ndarray, threads: int) -> np.ndarray | None:
    lib = native.load("sais_tpu", ["sais.cpp", "bucket_sa.cpp"])
    if lib is None:
        return None
    n = len(text_codes)
    if n < 2**32 - 1:
        sa = np.empty(n, dtype=np.uint32)
        fn = lib.bucket_sa_u32
        fn.restype = ctypes.c_int
        rc = fn(text_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.c_int64(n),
                sa.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                ctypes.c_int(threads),
                ctypes.c_int64(BUCKET_DEPTH))
        if rc == 0:
            return sa
        del sa           # a repeat deeper than BUCKET_DEPTH: SA-IS below
    if n < 2**32 - 1 and hasattr(lib, "sais_u8_u32"):
        sa = np.empty(n, dtype=np.uint32)
        fn = lib.sais_u8_u32
        ptr = sa.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    else:
        sa = np.empty(n, dtype=np.int64)
        fn = lib.sais_u8
        ptr = sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    fn.restype = ctypes.c_int
    rc = fn(
        text_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n),
        ptr,
    )
    if rc != 0:
        return None
    return sa


def _prefix_doubling(text_codes: np.ndarray) -> np.ndarray:
    """Manber-Myers prefix doubling with numpy lexsort."""
    n = len(text_codes)
    rank = text_codes.astype(np.int64)
    sa = np.argsort(rank, kind="stable")
    rank = _rerank(rank[sa], sa, n)
    h = 1
    while h < n:
        # key = (rank[i], rank[i+h]) with rank[i+h] = -1 past the end
        rank2 = np.full(n, -1, dtype=np.int64)
        rank2[: n - h] = rank[h:]
        order = np.lexsort((rank2, rank))
        sa = order
        combined = rank[sa] * (n + 1) + (rank2[sa] + 1)
        rank = _rerank(combined, sa, n)
        if rank[sa[-1]] == n - 1:
            break
        h *= 2
    return sa


def _rerank(sorted_keys: np.ndarray, sa: np.ndarray, n: int) -> np.ndarray:
    new_rank_sorted = np.zeros(n, dtype=np.int64)
    np.cumsum(sorted_keys[1:] != sorted_keys[:-1], out=new_rank_sorted[1:])
    rank = np.empty(n, dtype=np.int64)
    rank[sa] = new_rank_sorted
    return rank
