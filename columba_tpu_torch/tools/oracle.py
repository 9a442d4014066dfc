"""Brute-force oracles of approximate matching, independent of the index.

The port's copies of the JAX package's test oracles (``brute_hamming`` and
``brute_edit_ends`` of its pipeline tests, ``make_genome`` of its test
configuration), in numpy only, so that the conformance fuzz
(``tools/fuzz_conformance.py``) runs where there is no JAX, on the card:

- :func:`brute_hamming`: every (begin, distance <= k) of a read against the
  genome, one strand;
- :func:`brute_edit_ends`: every (end, distance <= k) where the best
  semi-global edit distance of a read ending at that text position is a
  local minimum (the leftmost of a run of equal values), the occurrence
  semantics ``pipeline.match_all`` reports in edit mode.
"""

from __future__ import annotations

import numpy as np


def make_genome(rng, n: int) -> np.ndarray:
    """A uniform random genome of ``n`` codes 0..3."""
    return rng.integers(0, 4, size=n).astype(np.uint8)


def brute_hamming(genome: np.ndarray, read: np.ndarray, k: int) -> set:
    """All (begin, dist <= k) of read against genome (one strand)."""
    m = len(read)
    win = np.lib.stride_tricks.sliding_window_view(genome, m)
    dists = (win != read).sum(axis=1)
    hits = np.nonzero(dists <= k)[0]
    return {(int(p), int(dists[p])) for p in hits}


def brute_edit_ends(genome: np.ndarray, read: np.ndarray, k: int) -> set:
    """(end, dist) pairs: the best semi-global edit distance of read ending
    at each text position (end exclusive), local minima only."""
    m = len(read)
    n = len(genome)
    cols = np.arange(1, n + 1)
    prev = np.zeros(n + 1, dtype=np.int32)   # D[0][*] = 0: a free start
    for j in range(1, m + 1):
        cur = np.empty(n + 1, dtype=np.int32)
        cur[0] = j
        mis = (genome != read[j - 1]).astype(np.int32)
        # diagonal and up, then the left-to-right scan of the row (insertions
        # into the text) as a running minimum of best - column
        best = np.minimum(prev[:-1] + mis, prev[1:] + 1)
        tmp = best - cols
        np.minimum.accumulate(tmp, out=tmp)
        cur[1:] = np.minimum(best, tmp + cols)
        cur[1:] = np.minimum(cur[1:], j)      # the all-deletions start column
        prev = cur
    final = prev[1:]                          # distance of an end at c + 1
    out = set()
    for c in np.nonzero(final <= k)[0]:
        v = final[c]
        left = final[c - 1] if c > 0 else 127
        right = final[c + 1] if c < n - 1 else 127
        if v > left or v > right or (c > 0 and v == left):
            continue
        out.add((int(c) + 1, int(v)))
    return out
