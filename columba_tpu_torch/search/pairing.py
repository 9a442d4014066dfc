"""Array-native paired-end pairing: window joins over sorted OccArrays.

The counterpart of ``columba_tpu/search/pairing.py`` (pure numpy, copied
with its imports changed): for each orientation combination the
downstream side is keyed by (read, end) and every upstream occurrence's
insert window [begin+min_insert, begin+max_insert] becomes a searchsorted
range, so the whole batch pairs in a handful of vectorized passes,
mirroring the reference's per-read ``pairOccurrences`` window scan
(reference: src/searchstrategy.cpp:1281-1343: fragment = downstream.end -
upstream.begin in [min, max], same sequence, orientation combos
src/searchstrategy.h:790-861 processCombFR/FF/RF).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from columba_tpu_torch.search.pipeline import OccArray


@dataclass
class PairRows:
    """Candidate/kept pairs as struct-of-arrays (one row per pair)."""

    pair_id: np.ndarray     # (P,) pair (read) index
    up_is_1: np.ndarray     # (P,) bool: upstream occurrence is read1's
    u_begin: np.ndarray
    u_end: np.ndarray
    u_dist: np.ndarray
    u_strand: np.ndarray
    d_begin: np.ndarray
    d_end: np.ndarray
    d_dist: np.ndarray
    d_strand: np.ndarray

    @property
    def total(self) -> np.ndarray:
        return self.u_dist + self.d_dist

    def __len__(self) -> int:
        return self.pair_id.shape[0]

    def take(self, idx) -> "PairRows":
        return PairRows(*(getattr(self, f)[idx] for f in (
            "pair_id", "up_is_1", "u_begin", "u_end", "u_dist", "u_strand",
            "d_begin", "d_end", "d_dist", "d_strand")))

    @staticmethod
    def empty() -> "PairRows":
        z = np.zeros(0, dtype=np.int64)
        return PairRows(z, z.astype(bool), z, z, z, z, z, z, z, z)

    @staticmethod
    def concat(parts: list) -> "PairRows":
        parts = [p for p in parts if len(p)]
        if not parts:
            return PairRows.empty()
        return PairRows(*(np.concatenate([getattr(p, f) for p in parts])
                          for f in ("pair_id", "up_is_1", "u_begin",
                                    "u_end", "u_dist", "u_strand",
                                    "d_begin", "d_end", "d_dist",
                                    "d_strand")))


def _strand_split(occ: OccArray):
    """occ -> (fwd subset, rc subset); occ must be read-sorted already."""
    return occ.take(occ.strand == 0), occ.take(occ.strand == 1)


def _window_join(up: OccArray, down: OccArray, min_f: int, max_f: int,
                 seq_starts: np.ndarray, up_is_1: bool) -> PairRows:
    """All (u, d) with d.end - u.begin in [min_f, max_f], same read, same
    sequence. Vectorized: down keyed by rid*K + end (sorted), every up
    contributes one searchsorted window."""
    if not len(up) or not len(down):
        return PairRows.empty()
    # K must exceed any end value so (rid, end) order is the key order
    K = int(max(down.end.max(), up.begin.max() + max_f)) + 2
    key_dn = down.read_id * K + down.end
    o = np.argsort(key_dn, kind="stable")
    key_dn = key_dn[o]
    dn = down.take(o)
    lo = np.searchsorted(key_dn, up.read_id * K + (up.begin + min_f),
                         side="left")
    hi = np.searchsorted(key_dn, up.read_id * K + (up.begin + max_f),
                         side="right")
    counts = hi - lo
    total = int(counts.sum())
    if total == 0:
        return PairRows.empty()
    ui = np.repeat(np.arange(len(up)), counts)
    offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    di = lo[ui] + offs
    u = up.take(ui)
    d = dn.take(di)
    # same-sequence filter (reference pairs never cross a sequence)
    su = np.searchsorted(seq_starts, u.begin, side="right")
    sd = np.searchsorted(seq_starts, d.begin, side="right")
    keep = su == sd
    u, d = u.take(keep), d.take(keep)
    return PairRows(
        pair_id=u.read_id,
        up_is_1=np.full(len(u), up_is_1, dtype=bool),
        u_begin=u.begin, u_end=u.end, u_dist=u.distance,
        u_strand=u.strand,
        d_begin=d.begin, d_end=d.end, d_dist=d.distance,
        d_strand=d.strand,
    )


def concordant_pairs(occ1: OccArray, occ2: OccArray, orientation: str,
                     min_f: int, max_f: int,
                     seq_starts: np.ndarray) -> PairRows:
    """All concordant pairs of a batch under one orientation
    (reference processCombFR/FF/RF, src/searchstrategy.h:790-861)."""
    f1, rc1 = _strand_split(occ1)
    f2, rc2 = _strand_split(occ2)
    if orientation == "fr":
        combos = [(f1, rc2, True), (f2, rc1, False)]
    elif orientation == "rf":
        combos = [(rc1, f2, True), (rc2, f1, False)]
    else:  # ff
        combos = [(f1, f2, True), (rc2, rc1, False)]
    return PairRows.concat([
        _window_join(up, down, min_f, max_f, seq_starts, up_is_1)
        for up, down, up_is_1 in combos
    ])


def best_filter(pairs: PairRows, n_pairs: int, tot_cut: int, x: int):
    """Keep each read's pairs with total distance in [best, best+x]
    (reference stratified BEST semantics, src/searchstrategy.cpp:1091-1179:
    the single-pass union filtered to the best stratum ladder's output).

    Returns (kept PairRows sorted by (pair_id, total, u_begin, input
    order), per-read best totals)."""
    best = np.full(n_pairs, tot_cut + 1, dtype=np.int64)
    if len(pairs):
        tot = pairs.total
        ok = tot <= tot_cut
        np.minimum.at(best, pairs.pair_id[ok], tot[ok])
        rb = best[pairs.pair_id]
        keep = (rb <= tot_cut) & (tot >= rb) & (
            tot <= np.minimum(rb + x, tot_cut))
        pairs = pairs.take(keep)
    if len(pairs):
        order = np.lexsort((np.arange(len(pairs)), pairs.u_begin,
                            pairs.total, pairs.pair_id))
        pairs = pairs.take(order)
    return pairs, best


def sort_pairs(pairs: PairRows) -> PairRows:
    """(pair_id, total, u_begin, stable) emission order — matches the
    per-read ``sorted(key=(total_distance, up.begin))`` of the emitter."""
    if not len(pairs):
        return pairs
    order = np.lexsort((np.arange(len(pairs)), pairs.u_begin, pairs.total,
                        pairs.pair_id))
    return pairs.take(order)
