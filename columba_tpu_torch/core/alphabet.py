"""DNA alphabet handling.

The index alphabet is sigma=5: ``$ A C G T`` with ``$`` the sentinel
(smallest).  Device-side everything uses 2-bit codes 0..3 for A,C,G,T; the
single ``$`` occupies one BWT/text slot whose position is carried separately
(see ``index.build``), mirroring the reference's treatment where ``$`` is not
encoded in the occ bitvectors (reference: src/fmindex/bwtrepr.h:56-72).

Char conventions in host code:
  - code 0..3  = A,C,G,T
  - code 4     = N / invalid (only in raw reads; replaced or mismatching)
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N = 0, 1, 2, 3, 4
SIGMA = 4  # encoded alphabet (without $)

# ASCII -> code lookup (uppercase + lowercase), everything else -> 4 (N).
_LUT = np.full(256, 4, dtype=np.uint8)
for _i, _ch in enumerate("ACGT"):
    _LUT[ord(_ch)] = _i
    _LUT[ord(_ch.lower())] = _i

_COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)  # A<->T, C<->G, N->N

_CODE2CHAR = np.frombuffer(b"ACGTN", dtype=np.uint8)


def encode(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 codes (0..3, 4 for non-ACGT)."""
    if isinstance(seq, str):
        seq = seq.encode()
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else seq
    return _LUT[arr]


def decode(codes: np.ndarray) -> str:
    return _CODE2CHAR[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def revcomp(codes: np.ndarray, axis: int = -1) -> np.ndarray:
    """Reverse complement of a code array (N maps to N)."""
    return np.flip(_COMP[codes], axis=axis)


def comp(codes: np.ndarray) -> np.ndarray:
    return _COMP[codes]
