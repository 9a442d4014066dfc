"""Paired-end mapping: orientation handling, pairing, inference.

The counterpart of ``columba_tpu/search/paired.py`` without its Python SAM
emitter (the port emits through the native emitter, ``io/emit.py``).
Host-side orchestration over the batched device pipeline, mirroring the
reference's PE logic:
  - orientation combinations (reference: src/searchstrategy.h:790-861
    processCombFR/FF/RF): FR pairs (read1 fwd upstream, read2-RC downstream)
    and (read2 fwd upstream, read1-RC downstream); FF/RF analogous.
  - pairing by fragment-size window over begin/end positions
    (reference: src/searchstrategy.cpp:1281-1343 ``pairOccurrences``:
    fragment = downstream.end - upstream.begin in [min, max], same sequence).
  - discordant fallback and one/both-unmapped records
    (reference: src/searchstrategy.cpp:1518-1645).
  - insert-size/orientation inference from the first unambiguously mapped
    pairs: median/MAD outlier removal then mean +/- 6 sigma
    (reference: src/parallel.cpp:402-465).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from columba_tpu_torch.search import pairing, pipeline, strategy
from columba_tpu_torch.search.scheme import get_scheme

INFERENCE_PAIRS = 750   # reference: src/definitions.h:57
INFERENCE_MAX_READS = 10000


@dataclass
class PairedConfig:
    orientation: str = "fr"      # fr | ff | rf
    min_insert: int = 0
    max_insert: int = 500
    infer: bool = True
    # discordant pairing requires the -D flag, matching the reference
    # (src/parameters/alignparameters.cpp:691-716, default disallowed)
    discordant: bool = False
    max_discordant: int = 100000


@dataclass
class PairedOcc:
    up: pipeline.Occurrence
    down: pipeline.Occurrence
    up_is_read1: bool

    @property
    def total_distance(self):
        return self.up.distance + self.down.distance

    @property
    def fragment(self):
        return self.down.end - self.up.begin


@dataclass
class MappedPair:
    pairs: list = field(default_factory=list)       # concordant PairedOccs
    discordant: list = field(default_factory=list)  # discordant PairedOccs
    unpaired1: list = field(default_factory=list)   # Occurrences of read1
    unpaired2: list = field(default_factory=list)


def pair_occurrences(
    up: list[pipeline.Occurrence],
    down: list[pipeline.Occurrence],
    min_frag: int,
    max_frag: int,
    up_is_read1: bool,
    seq_starts: np.ndarray,
) -> list[PairedOcc]:
    """Window pairing of sorted occurrence lists (reference pairOccurrences)."""
    if not up or not down:
        return []
    down_sorted = sorted(down, key=lambda o: o.end)
    ends = [o.end for o in down_sorted]
    out = []
    for u in up:
        import bisect

        i = bisect.bisect_left(ends, u.begin)
        for d in down_sorted[i:]:
            frag = d.end - u.begin
            if frag > max_frag:
                break
            if frag < min_frag:
                continue
            su = np.searchsorted(seq_starts, u.begin, side="right")
            sd = np.searchsorted(seq_starts, d.begin, side="right")
            if su != sd:
                continue
            out.append(PairedOcc(u, d, up_is_read1))
    return out


def map_pairs_all_start(
    index,
    reads1: np.ndarray,
    reads2: np.ndarray,
    scheme_name: str,
    k: int,
    metric: str,
    kmer_table=None,
):
    """Dispatch ALL-mode paired mapping (both sides' device passes)."""
    scheme = get_scheme(scheme_name, k)
    ctx1 = pipeline.match_all_start(index, reads1, scheme, metric=metric,
                                    kmer_table=kmer_table)
    ctx2 = pipeline.match_all_start(index, reads2, scheme, metric=metric,
                                    kmer_table=kmer_table)
    return dict(ctx1=ctx1, ctx2=ctx2, reads1=reads1, reads2=reads2, k=k,
                metric=metric)


def map_pairs_all_finish(
    handle,
    pcfg: PairedConfig,
    seq_starts: np.ndarray,
    arrays=None,
    counters=None,
) -> list[MappedPair]:
    """Fetch + array-pair an ALL-mode PE batch (window joins, no per-read
    Python pairing loops)."""
    k, metric = handle["k"], handle["metric"]
    occs = []
    for ctx, reads in ((handle["ctx1"], handle["reads1"]),
                       (handle["ctx2"], handle["reads2"])):
        occ, stats = pipeline.match_all_finish(ctx)
        if counters is not None:
            counters.add_device_stats(stats)
        if arrays is not None:
            kb = k if metric == "edit" else 0
            occ = pipeline.apply_boundary_trim(occ, reads, arrays, kb, k)
        occs.append(occ)
    occ1, occ2 = occs
    R = len(handle["reads1"])
    cand = pairing.sort_pairs(pairing.concordant_pairs(
        occ1, occ2, pcfg.orientation, pcfg.min_insert, pcfg.max_insert,
        seq_starts))
    # every concordant pair is kept in ALL mode; pairless reads fall back
    best = np.full(R, np.iinfo(np.int64).max - 1, dtype=np.int64)
    if len(cand):
        np.minimum.at(best, cand.pair_id, cand.total)
    out = _rows_to_mapped_all(cand, best, occ1, occ2, R, pcfg)
    return out


def _rows_to_mapped_all(rows, best, occ1, occ2, R,
                        pcfg: PairedConfig) -> list[MappedPair]:
    big = np.iinfo(np.int64).max - 1
    out = [MappedPair() for _ in range(R)]
    if len(rows):
        bounds = np.searchsorted(rows.pair_id, np.arange(R + 1))
        for i in range(R):
            b0, b1 = int(bounds[i]), int(bounds[i + 1])
            prs = out[i].pairs
            for j in range(b0, b1):
                prs.append(PairedOcc(
                    pipeline.Occurrence(i, int(rows.u_strand[j]),
                                        int(rows.u_begin[j]),
                                        int(rows.u_end[j]),
                                        int(rows.u_dist[j])),
                    pipeline.Occurrence(i, int(rows.d_strand[j]),
                                        int(rows.d_begin[j]),
                                        int(rows.d_end[j]),
                                        int(rows.d_dist[j])),
                    bool(rows.up_is_1[j])))
    pairless = np.nonzero(best >= big)[0]
    if len(pairless):
        sel = np.zeros(R, dtype=bool)
        sel[pairless] = True
        sub1 = occ1.take(sel[occ1.read_id])
        sub2 = occ2.take(sel[occ2.read_id])
        per1 = {int(i): [[], []] for i in pairless}
        per2 = {int(i): [[], []] for i in pairless}
        for o in sub1:
            per1[o.read_id][o.strand].append(o)
        for o in sub2:
            per2[o.read_id][o.strand].append(o)
        for i in (int(v) for v in pairless):
            mp = out[i]
            if pcfg.discordant:
                mp.discordant = _pair_discordantly(per1[i], per2[i],
                                                   pcfg.max_discordant)
            if not mp.discordant:
                mp.unpaired1 = per1[i][0] + per1[i][1]
                mp.unpaired2 = per2[i][0] + per2[i][1]
    return out


def map_pairs_all(
    index,
    reads1: np.ndarray,
    reads2: np.ndarray,
    scheme_name: str,
    k: int,
    metric: str,
    pcfg: PairedConfig,
    seq_starts: np.ndarray,
    kmer_table=None,
    arrays=None,
) -> list[MappedPair]:
    """ALL-mode paired mapping of a batch of pairs (synchronous)."""
    handle = map_pairs_all_start(index, reads1, reads2, scheme_name, k,
                                 metric, kmer_table)
    return map_pairs_all_finish(handle, pcfg, seq_starts, arrays=arrays)


def map_pairs_best_start(
    index,
    reads1: np.ndarray,
    reads2: np.ndarray,
    cfg: strategy.MappingConfig,
    pcfg: PairedConfig,
    seq_starts: np.ndarray,
    kmer_table=None,
    counters=None,
):
    """Dispatch PE BEST(+x): escalating array-paired rungs.

    The union of the reference's total-distance strata IS the set of pairs
    with per-side distances <= (cut1, cut2); filtering that union to
    [best_total, best_total + x] per read reproduces the stratified
    ladder's output (same argument as SE single-pass BEST,
    strategy.map_batch_best_start). But one pass at the full cutoffs pays
    cutoff-grade device work for every pair when almost all pairs resolve
    at distance <= 2, so the pass escalates: rung cuts (0,0) -> (2,2) ->
    (cut1,cut2), each
    rung re-dispatching only the reads whose best window is not yet
    complete. A read is final after a rung with side cuts (c1,c2) iff
    best_total + x < min(c1,c2) + 1: any pair the rung missed has a side
    > c (so total >= min(c1,c2)+1), mirroring the stratum early-exit of
    the reference (src/searchstrategy.cpp:1091-1179). Deep cutoffs (> 6)
    keep the per-stratum budget ladder via map_pairs_best."""
    R, m1 = reads1.shape
    _, m2 = reads2.shape
    cut1 = strategy.best_cutoff_for(cfg, m1)
    cut2 = strategy.best_cutoff_for(cfg, m2)
    if max(cut1, cut2) > 6:
        return dict(mode="ladder",
                    mapped=map_pairs_best(index, reads1, reads2, cfg, pcfg,
                                          seq_starts, kmer_table, counters))
    rungs = [(min(c, cut1), min(c, cut2)) for c in (0, 2)
             if c < min(cut1, cut2)]
    rungs.append((cut1, cut2))
    c1, c2 = rungs[0]
    ctx1 = _dispatch_side(index, reads1, c1, cfg, kmer_table)
    ctx2 = _dispatch_side(index, reads2, c2, cfg, kmer_table)
    return dict(mode="single", ctx1=ctx1, ctx2=ctx2, cut1=cut1, cut2=cut2,
                rungs=rungs, reads1=reads1, reads2=reads2,
                kmer_table=kmer_table, index=index)


def _dispatch_side(index, reads, cut, cfg, kmer_table):
    return pipeline.match_all_start(
        index, reads, strategy._scheme_for(cfg, cut), metric=cfg.metric,
        capacity=cfg.capacity, max_locate=cfg.max_locate,
        kmer_table=kmer_table, partitioning=cfg.partitioning,
        switchpoint=cfg.switchpoint)


@dataclass
class PERowsBest:
    """Array-native PE BEST result of one batch: concordant kept rows
    (emission-sorted per read) + per-read unpaired fallbacks. The fast
    emission path (emit.pe_soa_from_rows -> native emit_sam_pe) consumes
    this directly — no per-pair Python objects anywhere."""

    n: int
    rows: object                 # pairing.PairRows, sorted (pair_id, total, u_begin)
    u_end1: np.ndarray           # (n,) int64, -1 = no unpaired occ (unmapped)
    u_st1: np.ndarray
    u_mq1: np.ndarray
    u_end2: np.ndarray
    u_st2: np.ndarray
    u_mq2: np.ndarray


def _mapq_vec(nb: np.ndarray) -> np.ndarray:
    """Vectorized sam.mapq (round-half-even like Python round())."""
    mq = np.full(nb.shape, 60, dtype=np.int32)
    mask = nb > 1
    if mask.any():
        v = -10.0 * np.log10(1.0 - 1.0 / nb[mask])
        mq[mask] = np.minimum(60, np.round(v)).astype(np.int32)
    return mq


def _best_unpaired_arrays(occ, n: int):
    """Per-read best unpaired occurrence (min by (distance, begin), ties
    keep array order) + MAPQ over the best-distance count — vectorized
    mirror of the emitter's unpaired fallback."""
    u_end = np.full(n, -1, dtype=np.int64)
    u_st = np.zeros(n, dtype=np.uint8)
    u_mq = np.zeros(n, dtype=np.int32)
    if len(occ):
        order = np.lexsort((occ.begin, occ.distance, occ.read_id))
        rid = occ.read_id[order]
        first = np.searchsorted(rid, np.arange(n), side="left")
        safe = np.minimum(first, len(rid) - 1)
        has = (first < len(rid)) & (rid[safe] == np.arange(n))
        bi = order[safe]
        bd = np.zeros(n, dtype=np.int64)
        bd[has] = occ.distance[bi][has]
        nb = np.bincount(occ.read_id[occ.distance == bd[occ.read_id]],
                         minlength=n)
        u_end[has] = occ.end[bi][has]
        u_st[has] = occ.strand[bi][has].astype(np.uint8)
        u_mq[has] = _mapq_vec(nb[has])
    return u_end, u_st, u_mq


def map_pairs_best_finish(
    handle,
    cfg: strategy.MappingConfig,
    pcfg: PairedConfig,
    seq_starts: np.ndarray,
    counters=None,
    as_rows: bool = False,
):
    """Fetch + array-pair a dispatched PE BEST batch, escalating
    unresolved reads through the remaining rungs.

    Returns a MappedPair list, or (``as_rows=True``) a PERowsBest with no
    per-pair Python objects — None in rows mode when the batch needs the
    object path (deep-cutoff ladder, discordant pairing)."""
    if handle["mode"] == "ladder":
        return None if as_rows else handle["mapped"]
    if as_rows and pcfg.discordant:
        return None
    reads1, reads2 = handle["reads1"], handle["reads2"]
    cut1, cut2 = handle["cut1"], handle["cut2"]
    rungs = handle["rungs"]
    R = len(reads1)
    x = int(cfg.best_plus_x)
    tot_cut = cut1 + cut2
    sub_ids = np.arange(R)
    padded1, padded2 = reads1, reads2     # dispatched (possibly padded) reads
    ctx1, ctx2 = handle["ctx1"], handle["ctx2"]
    out = None if as_rows else [MappedPair() for _ in range(R)]
    rows_res: PERowsBest | None = None
    final_rows: list = []
    for ri, (c1, c2) in enumerate(rungs):
        occs = []
        # boundary trim runs at EVERY rung (incl. (0,0): kb=0 trim drops
        # junction-crossing exact hits, mirroring the reference's no-trim
        # rule src/indexinterface.cpp:829-832) and always with the FULL
        # per-side cutoff, not the rung cut: trim's eligibility window and
        # re-verify budget scale with k, so rung-invariant parameters make
        # per-side trim results identical across rungs — the rung-finality
        # proof (missed pair total >= min(c1,c2)+1) needs that invariance
        for ctx, reads, full_cut in ((ctx1, padded1, cut1),
                                     (ctx2, padded2, cut2)):
            occ, stats = pipeline.match_all_finish(ctx)
            if counters is not None:
                counters.add_device_stats(stats)
            if strategy._trims(cfg):
                kbs = full_cut if cfg.metric == "edit" else 0
                occ = pipeline.apply_boundary_trim(occ, reads, cfg.arrays,
                                                   kbs, full_cut)
            if len(reads) > len(sub_ids):     # drop pad-lane occurrences
                occ = occ.take(occ.read_id < len(sub_ids))
            occs.append(occ)
        occ1, occ2 = occs
        cand = pairing.concordant_pairs(occ1, occ2, pcfg.orientation,
                                        pcfg.min_insert, pcfg.max_insert,
                                        seq_starts)
        kept, best = pairing.best_filter(cand, len(sub_ids), tot_cut, x)
        last = ri == len(rungs) - 1
        if last:
            final = np.ones(len(sub_ids), dtype=bool)
        else:
            final = (best + x) < min(c1, c2) + 1
        if len(kept):
            rows = kept.take(final[kept.pair_id])
            rows.pair_id = sub_ids[rows.pair_id]
            final_rows.append(rows)
        if last:
            if as_rows:
                rows_res = _pairless_rows(R, sub_ids, best, occ1, occ2,
                                          tot_cut, x)
            else:
                _fill_pairless(out, sub_ids, best, occ1, occ2, tot_cut,
                               x, pcfg)
            break
        esc = np.nonzero(~final)[0]
        if not len(esc):
            break
        sub_ids = sub_ids[esc]
        c1n, c2n = rungs[ri + 1]
        # pad to a power-of-two lane count, as the JAX package does (there
        # each distinct batch shape is a separate compile); the port keeps
        # its lane counts so that intermediate results compare
        padded1 = _pad_pow2(reads1[sub_ids])
        padded2 = _pad_pow2(reads2[sub_ids])
        ctx1 = _dispatch_side(handle["index"], padded1, c1n, cfg,
                              handle["kmer_table"])
        ctx2 = _dispatch_side(handle["index"], padded2, c2n, cfg,
                              handle["kmer_table"])
    kept_all = pairing.sort_pairs(pairing.PairRows.concat(final_rows))
    if as_rows:
        if rows_res is None:          # every read finalized pre-last-rung
            rows_res = _pairless_rows(R, np.zeros(0, np.int64),
                                      np.zeros(0, np.int64),
                                      pipeline.OccArray.empty(),
                                      pipeline.OccArray.empty(),
                                      tot_cut, x)
        rows_res.rows = kept_all
        return rows_res
    _fill_paired(out, kept_all, R)
    return out


def _pairless_rows(R: int, sub_ids: np.ndarray, best: np.ndarray,
                   occ1, occ2, tot_cut: int, x: int) -> PERowsBest:
    """Vectorized unpaired fallbacks (see _fill_pairless; discordant is
    handled by the object path only). occ1/occ2 carry subset-local ids."""
    res = PERowsBest(
        n=R, rows=pairing.PairRows.empty(),
        u_end1=np.full(R, -1, np.int64), u_st1=np.zeros(R, np.uint8),
        u_mq1=np.zeros(R, np.int32),
        u_end2=np.full(R, -1, np.int64), u_st2=np.zeros(R, np.uint8),
        u_mq2=np.zeros(R, np.int32))
    pairless = np.nonzero(best > tot_cut)[0]
    if not len(pairless):
        return res
    nsub = len(sub_ids)
    sel = np.zeros(nsub, dtype=bool)
    sel[pairless] = True
    gids = sub_ids[pairless]          # global read ids of pairless reads
    for occ, ue, us, um in ((occ1, res.u_end1, res.u_st1, res.u_mq1),
                            (occ2, res.u_end2, res.u_st2, res.u_mq2)):
        sub = occ.take(sel[occ.read_id])
        e, s, q = _best_unpaired_arrays(sub, nsub)
        ue[gids] = e[pairless]
        us[gids] = s[pairless]
        um[gids] = q[pairless]
    return res


_pad_pow2 = strategy._pad_pow2


def _fill_paired(out: list, kept, R: int) -> None:
    """Write kept PairRows (sorted by pair_id) into out[...].pairs."""
    if not len(kept):
        return
    bounds = np.searchsorted(kept.pair_id, np.arange(R + 1))
    for i in range(R):
        b0, b1 = int(bounds[i]), int(bounds[i + 1])
        if b0 == b1:
            continue
        prs = out[i].pairs
        for j in range(b0, b1):
            prs.append(PairedOcc(
                pipeline.Occurrence(i, int(kept.u_strand[j]),
                                    int(kept.u_begin[j]),
                                    int(kept.u_end[j]),
                                    int(kept.u_dist[j])),
                pipeline.Occurrence(i, int(kept.d_strand[j]),
                                    int(kept.d_begin[j]),
                                    int(kept.d_end[j]),
                                    int(kept.d_dist[j])),
                bool(kept.up_is_1[j])))


def _fill_pairless(out: list, sub_ids: np.ndarray, best: np.ndarray,
                   occ1, occ2, tot_cut: int, x: int,
                   pcfg: PairedConfig) -> None:
    """Discordant/unpaired fallbacks for reads with no concordant pair,
    mirroring the ladder path. occ1/occ2 carry subset-local read ids
    (rows of sub_ids); the sides are already mapped to their full cutoffs
    when this runs (last rung)."""
    pairless = np.nonzero(best > tot_cut)[0]
    if not len(pairless):
        return
    nsub = len(sub_ids)
    sel = np.zeros(nsub, dtype=bool)
    sel[pairless] = True
    sub1 = occ1.take(sel[occ1.read_id])
    sub2 = occ2.take(sel[occ2.read_id])
    per1 = {int(i): [[], []] for i in pairless}
    per2 = {int(i): [[], []] for i in pairless}
    for o in sub1:
        per1[o.read_id][o.strand].append(o)
    for o in sub2:
        per2[o.read_id][o.strand].append(o)
    for i in (int(v) for v in pairless):
        mp = out[int(sub_ids[i])]
        if pcfg.discordant:
            mp.discordant = _pair_discordantly_best(
                per1[i], per2[i], x, pcfg.max_discordant)
        if not mp.discordant:
            for occs_i, dst in ((per1[i][0] + per1[i][1], "unpaired1"),
                                (per2[i][0] + per2[i][1], "unpaired2")):
                if occs_i:
                    b = min(o.distance for o in occs_i)
                    setattr(mp, dst,
                            [o for o in occs_i if o.distance <= b + x])


def map_pairs_best(
    index,
    reads1: np.ndarray,
    reads2: np.ndarray,
    cfg: strategy.MappingConfig,
    pcfg: PairedConfig,
    seq_starts: np.ndarray,
    kmer_table=None,
    counters=None,
) -> list[MappedPair]:
    """Stratified BEST(+x) paired mapping of a batch of pairs.

    Batched equivalent of the reference's total-distance stratum loop
    (src/searchstrategy.cpp:1091-1179 ``matchApproxPairedEndBestPlusX``,
    :834-915 ``processComb``): walk total-distance budgets with the
    reference's stratum jumps, split each budget over the two sides using
    the other side's known minimum distance (processComb's maxUp/maxDown),
    early-exit per pair once its best stratum (+x) is fully explored, and
    emit only pairs with total distance in [best, best + x]. Falls back to
    discordant-best pairing (src/searchstrategy.cpp:1664-1741) and then to
    best-only unpaired occurrences.

    Device work is compacted: each stratum maps only the (side, read)
    rows whose needed budget exceeds what has been explored, grouped by
    budget so every pipeline launch is one fixed-shape batch.
    """
    R, m1 = reads1.shape
    _, m2 = reads2.shape
    sup1 = strategy.max_supported_k(cfg.scheme_name, m1, cfg.metric)
    sup2 = strategy.max_supported_k(cfg.scheme_name, m2, cfg.metric)
    cut1 = strategy.get_max_ed(cfg.min_identity, m1, max(sup1, 1))
    cut2 = strategy.get_max_ed(cfg.min_identity, m2, max(sup2, 1))
    x = int(cfg.best_plus_x)
    tot_cut = cut1 + cut2

    # per-(side, read) occurrence stores, deduped by (strand, end) at the
    # lowest distance (higher-k reruns rediscover lower-distance occs)
    occs1: list[dict] = [dict() for _ in range(R)]
    occs2: list[dict] = [dict() for _ in range(R)]
    explored1 = np.full(R, -1, dtype=np.int64)  # side mapped to <= this k
    explored2 = np.full(R, -1, dtype=np.int64)
    best = np.full(R, tot_cut + 1, dtype=np.int64)
    resolved = np.zeros(R, dtype=bool)
    pair_sets: list[dict] = [dict() for _ in range(R)]

    def min_lb(store, explored_i, cutoff):
        """Lower bound on any (known or future) distance of one side."""
        known = min((o.distance for o in store.values()), default=None)
        floor = min(explored_i + 1, cutoff + 1)
        return min(known, floor) if known is not None else floor

    def run_side(reads, stores, explored, need_k):
        """Map rows whose budget need_k[i] exceeds explored[i], grouped by
        budget value so each launch is one fixed-shape compacted batch."""
        by_k: dict[int, list[int]] = {}
        for i in np.nonzero(need_k > explored)[0]:
            by_k.setdefault(int(need_k[i]), []).append(int(i))
        for k, idxs in sorted(by_k.items()):
            scheme = strategy._scheme_for(cfg, k)
            occs, stats = pipeline.match_all(
                index, reads[idxs], scheme, metric=cfg.metric,
                capacity=cfg.capacity, max_locate=cfg.max_locate,
                kmer_table=kmer_table, partitioning=cfg.partitioning,
                switchpoint=cfg.switchpoint)
            if counters is not None:
                counters.add_device_stats(stats)
            if cfg.arrays is not None:
                kbs = k if cfg.metric == "edit" else 0
                occs = pipeline.apply_boundary_trim(
                    occs, reads[idxs], cfg.arrays, kbs, k)
            for o in occs:
                gi = idxs[o.read_id]
                o.read_id = gi
                key = (o.strand, o.end)
                prev = stores[gi].get(key)
                if prev is None or o.distance < prev.distance:
                    stores[gi][key] = o
            for i in idxs:
                explored[i] = k

    def pair_one(i, tmax):
        """All concordant pairs of read i with total distance <= tmax."""
        p1 = ([o for o in occs1[i].values() if o.strand == 0],
              [o for o in occs1[i].values() if o.strand == 1])
        p2 = ([o for o in occs2[i].values() if o.strand == 0],
              [o for o in occs2[i].values() if o.strand == 1])
        found = []
        for up, down, up_is_1 in _orientation_combos(pcfg.orientation, p1, p2):
            for p in pair_occurrences(up, down, pcfg.min_insert,
                                      pcfg.max_insert, up_is_1, seq_starts):
                if p.total_distance <= tmax:
                    found.append(p)
        return found

    def explore(t, active):
        """One stratum: map both sides up to the per-read total budget
        (capped at best+x once a best is known) split using the other
        side's minimum-distance lower bound (processComb's maxUp/maxDown);
        side 1 first, then side 2 with side 1's refreshed bound."""
        tcap = np.where(best <= tot_cut,
                        np.minimum(best + x, tot_cut), t)
        tcap = np.minimum(tcap, t)
        lb2 = np.array([min_lb(occs2[i], explored2[i], cut2)
                        for i in range(R)])
        k1 = np.minimum(cut1, tcap - lb2)
        k1 = np.where(active, k1, -1)
        run_side(reads1, occs1, explored1, np.maximum(k1, -1))
        lb1 = np.array([min_lb(occs1[i], explored1[i], cut1)
                        for i in range(R)])
        k2 = np.minimum(cut2, tcap - lb1)
        k2 = np.where(active, k2, -1)
        run_side(reads2, occs2, explored2, np.maximum(k2, -1))

    def collect(i):
        """Record newly discoverable pairs of read i up to its explored
        total budget; update best."""
        tmax = min(int(explored1[i] + explored2[i]), tot_cut)
        if tmax < 0:
            return
        for p in pair_one(i, tmax):
            key = (p.up.strand, p.up.end, p.down.strand, p.down.end,
                   p.up_is_read1)
            prev = pair_sets[i].get(key)
            if prev is None or p.total_distance < prev.total_distance:
                pair_sets[i][key] = p
            if p.total_distance < best[i]:
                best[i] = p.total_distance

    t = 0
    while True:
        active = ~resolved
        if not active.any():
            break
        explore(t, active)
        for i in np.nonzero(active)[0]:
            collect(int(i))
            if best[i] <= tot_cut:
                target = min(int(best[i]) + x, tot_cut)
                # resolved once every pair with total distance <= target is
                # discoverable: both sides explored to their target budget
                lb1 = min_lb(occs1[i], explored1[i], cut1)
                lb2 = min_lb(occs2[i], explored2[i], cut2)
                if (explored1[i] >= min(cut1, target - lb2)
                        and explored2[i] >= min(cut2, target - lb1)):
                    resolved[i] = True
        if t >= tot_cut:
            break
        # reference stratum jumps (searchstrategy.cpp:1155-1160); reads with
        # a found best still need their +x target level -> jump there
        unresolved_best = best[~resolved & (best <= tot_cut)] if (
            (~resolved) & (best <= tot_cut)).any() else None
        step = 2 if t < 6 else 4
        t_next = min(t + x + step, tot_cut) if t > 0 else max(x, 1)
        if unresolved_best is not None:
            t_next = min(t_next,
                         int(min(unresolved_best.max() + x, tot_cut)))
        t = max(t_next, t + 1)

    # reads with no concordant pair fall back to discordant/unpaired
    # handling, which needs each side fully mapped to its own cutoff
    # (the reference's pairDiscordantlyBest walks mapStratum to the end,
    # src/searchstrategy.cpp:1682-1694); the budget-split loop may have
    # stopped short when the other side had no occurrences
    fallback = best > tot_cut
    if fallback.any():
        run_side(reads1, occs1, explored1,
                 np.where(fallback, cut1, -1))
        run_side(reads2, occs2, explored2,
                 np.where(fallback, cut2, -1))

    out = []
    for i in range(R):
        mp = MappedPair()
        if best[i] <= tot_cut:
            hi = min(int(best[i]) + x, tot_cut)
            mp.pairs = sorted(
                (p for p in pair_sets[i].values()
                 if best[i] <= p.total_distance <= hi),
                key=lambda p: (p.total_distance, p.up.begin))
            out.append(mp)
            continue
        p1 = ([o for o in occs1[i].values() if o.strand == 0],
              [o for o in occs1[i].values() if o.strand == 1])
        p2 = ([o for o in occs2[i].values() if o.strand == 0],
              [o for o in occs2[i].values() if o.strand == 1])
        if pcfg.discordant:
            mp.discordant = _pair_discordantly_best(
                p1, p2, x, pcfg.max_discordant)
        if not mp.discordant:
            # best-only unpaired occurrences per side (reference
            # findBestMapping with +x strata)
            for occs, dst in ((p1[0] + p1[1], "unpaired1"),
                              (p2[0] + p2[1], "unpaired2")):
                if occs:
                    b = min(o.distance for o in occs)
                    setattr(mp, dst,
                            [o for o in occs if o.distance <= b + x])
        out.append(mp)
    return out


def _pair_discordantly_best(p1, p2, x, cap):
    """Stratified discordant pairing: first total stratum i = e1 + e2 with
    occurrences on both sides wins; collect strata [i, i+x], capped
    (reference: src/searchstrategy.cpp:1664-1741 + addDiscPairs)."""
    occs1 = p1[0] + p1[1]
    occs2 = p2[0] + p2[1]
    if not occs1 or not occs2:
        return []
    by1: dict[int, list] = {}
    by2: dict[int, list] = {}
    for o in occs1:
        by1.setdefault(o.distance, []).append(o)
    for o in occs2:
        by2.setdefault(o.distance, []).append(o)
    best = min(by1) + min(by2)
    out = []
    for tot in range(best, best + x + 1):
        for e1 in sorted(by1):
            e2 = tot - e1
            if e2 not in by2:
                continue
            for u in by1[e1]:
                for d in by2[e2]:
                    if len(out) >= cap:
                        return out
                    out.append(PairedOcc(u, d, True))
    return out


def _orientation_combos(orientation, p1, p2):
    """(upstream occs, downstream occs, up_is_read1) per orientation
    (reference processCombFR/FF/RF)."""
    f1, rc1 = p1
    f2, rc2 = p2
    if orientation == "fr":
        return [(f1, rc2, True), (f2, rc1, False)]
    if orientation == "rf":
        return [(rc1, f2, True), (rc2, f1, False)]
    # ff
    return [(f1, f2, True), (rc2, rc1, False)]


def _pair_discordantly(p1, p2, cap):
    """Best-distance cross product, capped (reference pairDiscordantly)."""
    occs1 = p1[0] + p1[1]
    occs2 = p2[0] + p2[1]
    if not occs1 or not occs2:
        return []
    b1 = min(o.distance for o in occs1)
    b2 = min(o.distance for o in occs2)
    best1 = [o for o in occs1 if o.distance == b1]
    best2 = [o for o in occs2 if o.distance == b2]
    out = []
    for u in best1:
        for d in best2:
            if len(out) >= cap:
                return out
            out.append(PairedOcc(u, d, True))
    return out


def infer_parameters(
    index,
    reads1: np.ndarray,
    reads2: np.ndarray,
    cfg: strategy.MappingConfig,
    seq_starts: np.ndarray,
    kmer_table=None,
    pcfg_in: "PairedConfig | None" = None,
) -> PairedConfig:
    """Infer orientation + insert-size window from unambiguous pairs
    (reference: src/parallel.cpp:402-465). Non-inferred settings
    (discordant policy) carry over from ``pcfg_in``."""
    n = min(len(reads1), INFERENCE_MAX_READS)
    m1 = strategy.map_batch_best(index, reads1[:n], cfg)
    m2 = strategy.map_batch_best(index, reads2[:n], cfg)
    frags, oris = [], []
    for a, b in zip(m1, m2):
        if len(a.occs) != 1 or len(b.occs) != 1:
            continue
        oa, ob = a.occs[0], b.occs[0]
        sa = np.searchsorted(seq_starts, oa.begin, side="right")
        sb = np.searchsorted(seq_starts, ob.begin, side="right")
        if sa != sb:
            continue
        lo, hi = (oa, ob) if oa.begin <= ob.begin else (ob, oa)
        frags.append(hi.end - lo.begin)
        if oa.strand == ob.strand:
            oris.append("ff")
        elif lo.strand == 0:
            oris.append("fr")
        else:
            oris.append("rf")
        if len(frags) >= INFERENCE_PAIRS:
            break
    if len(frags) < 20:
        return replace(pcfg_in, infer=False) if pcfg_in else PairedConfig()
    frags = np.array(frags, dtype=np.float64)
    med = np.median(frags)
    mad = np.median(np.abs(frags - med)) or 1.0
    keep = frags[np.abs(frags - med) <= 3 * 1.4826 * mad]
    mean, std = keep.mean(), keep.std() or 1.0
    ori = max(set(oris), key=oris.count)
    return PairedConfig(
        orientation=ori,
        min_insert=max(0, int(mean - 6 * std)),
        max_insert=int(mean + 6 * std),
        infer=False,
        discordant=pcfg_in.discordant if pcfg_in else False,
        max_discordant=pcfg_in.max_discordant if pcfg_in else 100000,
    )
