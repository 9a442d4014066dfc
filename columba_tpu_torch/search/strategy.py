"""Mapping strategies: single-end ALL and BEST(+x) modes over read batches.

The counterpart of ``columba_tpu/search/strategy.py`` (its Python SAM
emitter only for the textless RLC index, :func:`emit_sam_textless`): ALL mode
reports every occurrence with ed <= k; BEST mode finds each read's best
distance stratum up to a cutoff derived from the minimum identity, then
reports occurrences within [best, best + x]. Cutoffs <= 6 run one ALL pass
at the cutoff and filter; deeper cutoffs walk distance strata (the
reference's stratum jumps: step 2 below distance 5, else 4) on the reads
still unresolved. The textless RLC index has no text: its occurrences are
not trimmed at sequence boundaries.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from columba_tpu_torch.core import alphabet
from columba_tpu_torch.index.fmindex import FMIndex
from columba_tpu_torch.io import sam
from columba_tpu_torch.search import pipeline
from columba_tpu_torch.search.scheme import get_multi_scheme, get_scheme

BEST_CUTOFF = 13  # reference BEST_CUTOFF_COLUMBA (src/definitions.h)


def get_max_ed(min_identity: int, seq_size: int, max_supported: int = 4) -> int:
    """reference: src/searchstrategy.h:1797-1806."""
    cutoff = (seq_size * (100 - min_identity)) // 100
    return min(BEST_CUTOFF, max_supported, cutoff)


_PARTS_PER_K = {
    "kuch1": lambda k: k + 1, "kuch2": lambda k: k + 2,
    "pigeon": lambda k: k + 1, "kianfar": lambda k: k + 1,
    "01*0": lambda k: k + 2, "minU": lambda k: k + 1,
    "columba": lambda k: k + 1, "naive": lambda k: 1,
}


def max_supported_k(scheme_name: str, m: int, metric: str = "edit") -> int:
    """Largest k whose schedule compiles for reads of length m: the family
    must define schemes for k and parts must be non-empty with the colMin
    register budget (schedule.MAX_REGS) respected; short parts use rotating
    registers (search/schedule.py), so the old part > 2k limit is gone."""
    from columba_tpu_torch.search.schedule import MAX_REGS

    family_max = {"kuch1": 4, "kuch2": 4, "pigeon": 12, "kianfar": 4,
                  "01*0": 4, "minU": 7, "columba": 13, "naive": 20}
    parts = _PARTS_PER_K.get(scheme_name, lambda k: k + 1)
    best = 0
    for k in range(1, family_max.get(scheme_name, 4) + 1):
        p = parts(k)
        min_part = m // p
        if min_part < 1:
            break
        if metric == "edit":
            # window length 2k+1 rows + lifetime ~ one part; worst-case
            # simultaneous registers ~ ceil((2k+1+min_part)/min_part)
            regs = -(-(2 * k + 1 + min_part) // min_part)
            if regs > MAX_REGS:
                break
        best = k
    return best


@dataclass
class MappingConfig:
    scheme_name: str = "kuch1"
    metric: str = "edit"
    mode: str = "best"        # "all" | "best"
    max_distance: int = 2     # ALL mode k (reference -e)
    best_plus_x: int = 0      # BEST +x strata
    min_identity: int = 95
    dynamic_selection: bool = False  # per-read scheme choice (-c/-d)
    probe_selection: bool = False    # force the probe for builtin 'columba'
    partitioning: str = "uniform"    # "uniform" | "static" | "dynamic"
    switchpoint: int = 4      # in-text crossover (reference -i, default 4)
    capacity: int | None = None
    max_locate: int | None = None  # None: scale with batch + spill retry
    kmer_table: object = None  # optional device seed table
    arrays: object = None      # host IndexArrays / BMoveArrays; enables
                               # cross-boundary occurrence trimming on
                               # multi-sequence texts (and holds the
                               # textless index's phi tables)


@dataclass
class MappedRead:
    """Final mapping result of one read."""

    occs: list = field(default_factory=list)  # list[pipeline.Occurrence]
    best: int | None = None
    n_best: int = 0


def _scheme_for(cfg: MappingConfig, k: int):
    """The scheme of one pass at cut k, or the list of schemes that
    per-read selection picks from.

    The builtin 'columba' selection set collapses to its base scheme unless
    probe selection is forced: in a lockstep batch the masked combined pass
    costs the union of all schemes' searches, so the per-read choice saves
    nothing, and the occurrence set is identical either way (every scheme
    of the set is lossless at k). Scheme folders (-d, -c) keep the probe."""
    if k == 0:
        return get_scheme(cfg.scheme_name, 0)
    if cfg.scheme_name == "columba":
        if cfg.probe_selection:
            return get_multi_scheme("columba", k)
        return get_scheme("columba", k)
    if cfg.dynamic_selection:
        return get_multi_scheme(cfg.scheme_name, k)
    return get_scheme(cfg.scheme_name, k)


def _match_kwargs(cfg: MappingConfig) -> dict:
    return dict(metric=cfg.metric, capacity=cfg.capacity,
                max_locate=cfg.max_locate, kmer_table=cfg.kmer_table,
                partitioning=cfg.partitioning, switchpoint=cfg.switchpoint,
                host_arrays=cfg.arrays)


def _trims(cfg: MappingConfig) -> bool:
    """Whether occurrences are trimmed at sequence boundaries: needs the
    host arrays with text (not the textless RLC index)."""
    return cfg.arrays is not None and not getattr(cfg.arrays, "textless",
                                                  False)


def map_batch_all_start(index: FMIndex, reads: np.ndarray,
                        cfg: MappingConfig) -> dict:
    """Dispatch ALL-mode matching of a batch; the handle goes to
    :func:`map_batch_all_finish` (possibly on another thread)."""
    return pipeline.match_all_start(
        index, reads, _scheme_for(cfg, cfg.max_distance),
        **_match_kwargs(cfg))


def map_batch_all_finish(ctx, index: FMIndex, reads: np.ndarray,
                         cfg: MappingConfig, counters=None):
    """Fetch + post-process a dispatched batch -> (OccArray, stats)."""
    occs, stats = pipeline.match_all_finish(ctx)
    if counters is not None:
        counters.add_device_stats(stats)
    if _trims(cfg):
        kb = cfg.max_distance if cfg.metric == "edit" else 0
        occs = pipeline.apply_boundary_trim(occs, reads, cfg.arrays, kb,
                                            cfg.max_distance)
    return occs, stats


def _group_mapped(occs, n_reads: int) -> list[MappedRead]:
    """OccArray -> per-read MappedRead lists (compat representation for
    the paired-end path and tests; the fast SE path never builds these)."""
    out = [MappedRead() for _ in range(n_reads)]
    for o in occs:
        out[o.read_id].occs.append(o)
    for mr in out:
        if mr.occs:
            mr.best = min(o.distance for o in mr.occs)
            mr.n_best = sum(1 for o in mr.occs if o.distance == mr.best)
    return out


def map_batch_all(
    index: FMIndex, reads: np.ndarray, cfg: MappingConfig, counters=None
) -> list[MappedRead]:
    ctx = map_batch_all_start(index, reads, cfg)
    occs, _ = map_batch_all_finish(ctx, index, reads, cfg, counters)
    return _group_mapped(occs, len(reads))


def best_cutoff_for(cfg: MappingConfig, m: int) -> int:
    supported = max_supported_k(cfg.scheme_name, m, cfg.metric)
    return get_max_ed(cfg.min_identity, m, max(supported, 1))


def map_batch_best_start(index: FMIndex, reads: np.ndarray,
                         cfg: MappingConfig, counters=None):
    """Dispatch BEST(+x) matching; the handle goes to
    :func:`map_batch_best_finish`: the same start/finish split as ALL mode,
    so the CLI's emitter thread overlaps fetch and post-processing with the
    next batch's device work.

    Cutoffs <= 6 dispatch one ALL pass at the cutoff here and filter it to
    [best, best + x] in finish. Single-end has no rungs before the cutoff
    in the port (the JAX package's default; its rung loop runs once), so
    nothing escalates from the finish side; the paired-end rungs are in
    ``paired.map_pairs_best_start``. The deep stratum ladder is iterative
    (each stratum depends on the previous round's per-read best), so it
    runs to completion inside start and finish passes it through."""
    cutoff = best_cutoff_for(cfg, reads.shape[1])
    if cutoff <= 6:
        return dict(mode="single", cutoff=cutoff,
                    ctx=_dispatch_best(index, reads, cutoff, cfg))
    return dict(mode="ladder",
                occs=map_batch_best_arr(index, reads, cfg, counters))


def _dispatch_best(index, reads, cut, cfg):
    return pipeline.match_all_start(index, reads, _scheme_for(cfg, cut),
                                    **_match_kwargs(cfg))


def _pad_pow2(reads: np.ndarray, floor: int = 512) -> np.ndarray:
    """Pad a read sub-batch to a power-of-two row count (>= floor) by
    repeating row 0; pad-lane results are dropped by read_id filter. Used by
    the paired-end rungs. The port compiles nothing per shape; the padding
    keeps the JAX package's lane counts, so that intermediate results
    compare."""
    n = len(reads)
    P = max(floor, 1 << (n - 1).bit_length())
    if P == n:
        return reads
    return np.concatenate([reads, np.repeat(reads[:1], P - n, axis=0)])


def _trim_full(occs, reads, cfg, cutoff):
    """Boundary trim with rung-invariant parameters (always the FULL
    cutoff): trim's eligibility windows and re-verify budget scale with
    kb, so pinning kb to the cutoff makes per-read trim results identical
    across rungs — the rung-finality argument needs that invariance."""
    if not _trims(cfg):
        return occs
    kbs = cutoff if cfg.metric == "edit" else 0
    return pipeline.apply_boundary_trim(occs, reads, cfg.arrays, kbs,
                                        cutoff)


def map_batch_best_finish(handle, index: FMIndex, reads: np.ndarray,
                          cfg: MappingConfig, counters=None):
    """Fetch + filter a dispatched BEST batch -> OccArray, sorted by
    (read, strand, end, begin)."""
    if handle["mode"] == "ladder":
        return handle["occs"]
    cutoff = handle["cutoff"]
    occs, stats = pipeline.match_all_finish(handle["ctx"])
    if counters is not None:
        counters.add_device_stats(stats)
    occs = _trim_full(occs, reads, cfg, cutoff)
    if not len(occs):
        return occs
    best = np.full(len(reads), cutoff + 1, dtype=np.int64)
    np.minimum.at(best, occs.read_id, occs.distance)
    rb = best[occs.read_id]
    occs = occs.take(
        occs.distance <= np.minimum(rb + cfg.best_plus_x, cutoff))
    o2 = np.lexsort((occs.begin, occs.end, occs.strand, occs.read_id))
    return occs.take(o2)


def map_batch_best_arr(
    index: FMIndex, reads: np.ndarray, cfg: MappingConfig, counters=None
):
    """BEST(+x) mapping -> the best(+x)-filtered OccArray (read ids global
    to ``reads``). Cutoffs <= 6 take the single pass of
    :func:`map_batch_best_start`: one ALL run at the cutoff, filtered to
    [best, best + x], which is the same output set as the stratum ladder
    (the union of the explored strata is the <= cutoff set). Deep cutoffs
    keep the ladder: one k = 13 pass over every read would do the
    search-space explosion the ladder avoids."""
    cutoff = best_cutoff_for(cfg, reads.shape[1])
    if cutoff <= 6:
        handle = map_batch_best_start(index, reads, cfg, counters)
        return map_batch_best_finish(handle, index, reads, cfg, counters)
    return _ladder_best_arr(index, reads, cfg, cutoff, counters)


def _ladder_best_arr(index: FMIndex, reads: np.ndarray, cfg: MappingConfig,
                     cutoff: int, counters=None):
    """The stratum ladder with per-read compaction: each stratum runs only
    the reads that still need it (resolved reads drop out, the batched
    substitute for the reference's per-read early exit), padded to
    power-of-two sizes as the JAX package pads them."""
    R = reads.shape[0]
    x = cfg.best_plus_x
    best = np.full(R, cutoff + 1, dtype=np.int64)
    explored = np.full(R, -1, dtype=np.int64)
    parts: list = []

    def run_stratum(k: int, idxs: np.ndarray):
        n_live = len(idxs)
        size = min(R, max(64, 1 << (n_live - 1).bit_length()))
        sub = np.concatenate(
            [idxs, np.full(size - n_live, idxs[0], dtype=idxs.dtype)])
        scheme = _scheme_for(cfg, k)
        occs, stats = pipeline.match_all(index, reads[sub], scheme,
                                         **_match_kwargs(cfg))
        if counters is not None:
            counters.add_device_stats(stats)
        if _trims(cfg):
            kbs = k if cfg.metric == "edit" else 0
            occs = pipeline.apply_boundary_trim(occs, reads[sub],
                                                cfg.arrays, kbs, k)
        occs = occs.take(occs.read_id < n_live)  # drop padding lanes
        occs.read_id = idxs[occs.read_id]        # remap to global ids
        parts.append(occs)
        if len(occs):
            np.minimum.at(best, occs.read_id, occs.distance)
        explored[idxs] = np.maximum(explored[idxs], k)

    run_stratum(0, np.arange(R))
    while True:
        # per-read next stratum: reads with a best need their +x target,
        # others follow the reference ladder (searchstrategy.cpp:676-709:
        # k += x + (2 if k < 5 else 4)); resolved reads drop out
        has_best = best <= cutoff
        target = np.minimum(best + x, cutoff)
        step = np.where(explored < 5, 2, 4)
        ladder = np.where(explored == 0, max(x, 1),
                          np.minimum(explored + x + step, cutoff))
        nk = np.where(has_best, target, ladder)
        need = ((explored < cutoff)
                & np.where(has_best, explored < target, True))
        if not need.any():
            break
        for k in np.unique(nk[need]):
            run_stratum(int(k), np.nonzero(need & (nk == k))[0])

    allo = pipeline.OccArray.concat(parts)
    if not len(allo):
        return allo
    rb = best[allo.read_id]
    hi = np.minimum(rb + x, cutoff)
    allo = allo.take((rb <= cutoff) & (allo.distance >= rb)
                     & (allo.distance <= hi))
    if not len(allo):
        return allo
    # dedup across strata by (read, strand, end): min distance wins, first
    # collected wins ties (higher-k reruns rediscover lower-distance occs)
    ordidx = np.arange(len(allo))
    o = np.lexsort((ordidx, allo.distance, allo.end, allo.strand,
                    allo.read_id))
    first = np.empty(o.size, bool)
    first[0] = True
    rid_s, str_s, end_s = (allo.read_id[o], allo.strand[o], allo.end[o])
    first[1:] = ((rid_s[1:] != rid_s[:-1]) | (str_s[1:] != str_s[:-1])
                 | (end_s[1:] != end_s[:-1]))
    allo = allo.take(o[first])
    # final order (read, strand, end, begin)
    o2 = np.lexsort((allo.begin, allo.end, allo.strand, allo.read_id))
    return allo.take(o2)


def map_batch_best(
    index: FMIndex, reads: np.ndarray, cfg: MappingConfig, counters=None
) -> list[MappedRead]:
    occs = map_batch_best_arr(index, reads, cfg, counters)
    return _group_mapped(occs, len(reads))


def emit_sam_textless(batch, occs, arrays,
                      unmapped_records: bool = True) -> str:
    """SAM records of one read batch (``io.fastq.RecordBatch``) without
    genome text: '*' CIGARs, begins straight from the phi locate, distances
    from the search; per read the occurrences by (distance, begin, strand),
    the first primary (the textless RLC reporting mode of
    ``columba_tpu/search/strategy.py:566-603``; the reference's RLC flavor
    likewise defaults to no CIGAR, src/parameters/alignparameters.cpp:
    131-160)."""
    starts = arrays.seq_starts
    names = batch.names_buf.decode()
    quals = batch.quals_buf.decode()
    per_read: dict = {}
    for i in range(len(occs)):
        per_read.setdefault(int(occs.read_id[i]), []).append(occs[i])
    lines = []
    for r in range(batch.n_valid):
        name = names[batch.name_offs[r]:batch.name_offs[r + 1]]
        qual = quals[batch.qual_offs[r]:batch.qual_offs[r + 1]]
        codes = batch.codes[r]
        found = per_read.get(r)
        if not found:
            if unmapped_records:
                lines.append(sam.unmapped_record(name, codes, qual))
            continue
        found.sort(key=lambda o: (o.distance, o.begin, o.strand))
        best_ed = found[0].distance
        mq = sam.mapq(max(sum(1 for o in found if o.distance == best_ed), 1))
        for rank_i, o in enumerate(found):
            seq_codes = codes if o.strand == 0 else alphabet.revcomp(codes)
            sidx = int(np.searchsorted(starts, o.begin, side="right") - 1)
            sidx = max(0, min(sidx, len(arrays.seq_names) - 1))
            flag = (16 if o.strand else 0) | (256 if rank_i > 0 else 0)
            lines.append(sam.record(
                name, flag, arrays.seq_names[sidx],
                o.begin - int(starts[sidx]) + 1,
                mq if o.distance == best_ed else 0, "*", seq_codes,
                qual if o.strand == 0 else qual[::-1], o.distance))
    return "".join(lines)
