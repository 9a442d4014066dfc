"""End-to-end matching pipeline: executor -> locate -> verify -> occurrences.

The counterpart of ``columba_tpu/search/pipeline.py`` for ALL mode with a
static schedule: run the compiled scheme over the frontier, expand the
candidate SA ranges to rows (count, then gather), locate them, dedup the
(read, window) pairs, verify in text, and post-process on the host (cluster
centres, dedup, redundancy filter) into occurrences.

The device part returns fixed-shape tensors; ``match_all_finish`` copies
them to the host in one pass (pinned buffers, one synchronisation) and
re-runs with 4x capacities while a frontier overflowed or the locate/verify
capacity spilled, which keeps the search lossless.
"""

from __future__ import annotations

import numpy as np
import torch

from columba_tpu_torch.core import alphabet
from columba_tpu_torch.index.fmindex import FMIndex
from columba_tpu_torch.ops import locate, verify
from columba_tpu_torch.search import executor, schedule
from columba_tpu_torch.search.scheme import SearchScheme


class OccArray:
    """Occurrences as struct-of-arrays (numpy, int64)."""

    __slots__ = ("read_id", "strand", "begin", "end", "distance")

    def __init__(self, read_id, strand, begin, end, distance):
        self.read_id = np.asarray(read_id, dtype=np.int64)
        self.strand = np.asarray(strand, dtype=np.int64)
        self.begin = np.asarray(begin, dtype=np.int64)
        self.end = np.asarray(end, dtype=np.int64)
        self.distance = np.asarray(distance, dtype=np.int64)

    @staticmethod
    def empty() -> "OccArray":
        z = np.zeros(0, dtype=np.int64)
        return OccArray(z, z, z, z, z)

    def take(self, idx) -> "OccArray":
        return OccArray(*(getattr(self, f)[idx] for f in OccArray.__slots__))

    def __len__(self):
        return self.read_id.shape[0]


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------

def crossover_caps(capacity: int, max_locate: int, switchpoint: int):
    """Derived in-text crossover sizing (itv_cap, split_step, capacity2)."""
    if switchpoint > 0:
        return int(max_locate), 2, max(1024, int(capacity) // 16)
    return 0, 0, 0


def stage_candidates(res: executor.FrontierResult, tables: dict):
    """Completed frontier lanes + in-text rows [f_lo, f_hi, ids, depth] ->
    one candidate list (c_lo, c_hi, c_rid, c_estb); estb is the read
    start's offset from the back-side text depth."""
    S = tables["pivot"].shape[0]
    fr_lo = torch.where(res.done, res.ranges[:, 0], 0)
    fr_hi = torch.where(res.done, res.ranges[:, 1], 0)
    fr_estb = tables["t_back"][res.sid] - tables["pivot"][res.sid]
    itv = res.itv
    iv_valid = torch.arange(itv.shape[0], device=itv.device) < res.itv_count
    iv_lo = torch.where(iv_valid, itv[:, 0], 0)
    iv_hi = torch.where(iv_valid, itv[:, 1], 0)
    iv_ids = itv[:, 2]
    iv_estb = itv[:, 3] - tables["pivot"][iv_ids % S]
    return (torch.cat([fr_lo, iv_lo]), torch.cat([fr_hi, iv_hi]),
            torch.cat([res.rid, iv_ids // S]), torch.cat([fr_estb, iv_estb]))


def stage_expand(c_lo, c_hi, max_locate: int):
    """Candidate ranges -> at most ``max_locate`` flat SA rows.

    Widths are clamped at max_locate + 1 (rows past the cap are dropped
    anyway, and a clamped candidate still forces total > max_locate).
    Returns (rows, cand, valid, total)."""
    widths = torch.clamp(c_hi - c_lo, min=0).clamp(max=max_locate + 1)
    offsets = widths.cumsum(0)
    total = offsets[-1]
    j = torch.arange(max_locate, dtype=torch.int64, device=c_lo.device)
    cand = torch.searchsorted(offsets, j, right=True).clamp(
        0, widths.shape[0] - 1)
    base = offsets[cand] - widths[cand]
    valid = j < torch.clamp(total, max=max_locate)
    rows = torch.where(valid, c_lo[cand] + (j - base), 0)
    return rows, cand, valid, total


def stage_dedup(rid, win_start, valid, max_verify: int):
    """Dedup (read, window start) pairs before verification, keeping sort
    order (rid, start as uint32, the reference's order) and compacting the
    first of each pair to ``max_verify`` slots. Returns (rid_v, win_v,
    vlive, n_unique)."""
    L = rid.shape[0]
    big = 1 << 30
    rid_m = torch.where(valid, rid, big)
    win_m = torch.where(valid, win_start & 0xFFFFFFFF, 0xFFFFFFFF)
    key = (rid_m << 32) | win_m
    key_s, order = torch.sort(key, stable=True)
    first = torch.ones(L, dtype=torch.bool, device=rid.device)
    first[1:] = key_s[1:] != key_s[:-1]
    uniq = first & ((key_s >> 32) < big)
    (src,), n_uniq = executor._compact(
        uniq, max_verify, [torch.arange(L, device=rid.device)], [L])
    vlive = src < L
    srcc = order[torch.where(vlive, src, 0)]
    rid_v = torch.where(vlive, rid_m[srcc], 0)
    win_v = torch.where(vlive, win_start[srcc], 0)
    return rid_v, win_v, vlive, n_uniq


def match_device_core(index: FMIndex, reads: torch.Tensor,
                      sched: schedule.Schedule, capacity: int,
                      max_locate: int, kb: int, kmer_table=None,
                      switchpoint: int = 0, itv_cap: int = 0,
                      split_step: int = 0, capacity2: int = 0,
                      max_verify: int | None = None, itv_min_depth: int = 16,
                      ex_split: int = 0, ex_cap: int = 0) -> dict:
    """Device-side match step: reads (R, m) uint8 on the index's device."""
    if max_verify is None:
        max_verify = max_locate
    tables = executor.device_tables(sched, reads.device)
    res = executor.run_scheme(
        index, reads, sched, capacity, kmer_table, switchpoint, itv_cap,
        split_step, capacity2, itv_min_depth=itv_min_depth, tables=tables,
        ex_split=ex_split, ex_cap=ex_cap)
    c_lo, c_hi, c_rid, c_estb = stage_candidates(res, tables)
    rows, cand, valid, total = stage_expand(c_lo, c_hi, max_locate)
    pos = locate.locate_rows(index, rows)
    win_start = pos + c_estb[cand] - kb          # signed: may be < 0
    rid_v, win_v, vlive, n_uniq = stage_dedup(c_rid[cand], win_start, valid,
                                              max_verify)
    final_rows = verify.verify_window(index, reads, rid_v, win_v, kb)
    return dict(
        rid=rid_v, win_start=win_v, final_rows=final_rows, valid=vlive,
        total=total, n_unique=n_uniq, overflow=res.overflow,
        nodes_visited=res.nodes_visited, itv_started=res.itv_count,
        searches_started=res.searches_started)


# ---------------------------------------------------------------------------
# Host side
# ---------------------------------------------------------------------------

_SCHED_CACHE: dict = {}


def compile_cached(scheme: SearchScheme, m: int, metric: str,
                   kmer_k: int = 0) -> schedule.Schedule:
    key = (scheme, m, metric, kmer_k)
    if key not in _SCHED_CACHE:
        _SCHED_CACHE[key] = schedule.compile_schedule(
            scheme, m, metric=metric, kmer_k=kmer_k)
    return _SCHED_CACHE[key]


def match_all(*args, **kwargs) -> tuple[OccArray, dict]:
    """ALL-mode matching (synchronous): dispatch + fetch + post-process."""
    return match_all_finish(match_all_start(*args, **kwargs))


# Locate-cap warm start: batches in auto mode start at the largest cap an
# earlier batch of the same index grew to (speed only; lossless either
# way). Keyed by the index's id(), with the index kept alive by the entry.
_ML_HINT: dict = {}


def _ml_hint_get(index) -> int:
    ent = _ML_HINT.get(id(index))
    return ent[1] if ent is not None and ent[0] is index else 0


def _ml_hint_bump(index, ml: int) -> None:
    _ML_HINT[id(index)] = (index, max(_ml_hint_get(index), ml))


def match_all_start(
    index: FMIndex,
    reads_codes: np.ndarray,
    scheme: SearchScheme,
    metric: str = "edit",
    capacity: int | None = None,
    max_locate: int | None = None,
    both_strands: bool = True,
    redundancy_filter: bool = True,
    kmer_table=None,
    switchpoint: int = 0,
    ex_split: int = 0,
    ex_cap: int = 0,
) -> dict:
    """Dispatch ALL-mode matching of a read batch (every occurrence with
    ed <= k); returns the context for :func:`match_all_finish`.

    reads_codes: (R, m) uint8 codes. k = 0 runs through the scheme
    executor, as in the JAX package, when a seed table and the in-text
    crossover are on; the dedicated exact pass for the other k = 0 cases,
    and dynamic partitioning and selection, are not ported yet (ROADMAP).
    """
    from columba_tpu_torch.index.kmer import table_k

    R, m = reads_codes.shape
    k = scheme.k
    if k == 0 and (kmer_table is None or switchpoint <= 0):
        raise NotImplementedError(
            "k = 0 without seed table and crossover takes the exact pass, "
            "which is not ported yet (ROADMAP queue 2, K14)")
    kb = k if metric == "edit" else 0
    batch = reads_codes.astype(np.uint8)
    if both_strands:
        batch = np.concatenate([batch, alphabet.revcomp(batch, axis=-1)])
    dev = index.device
    batch_dev = torch.from_numpy(np.ascontiguousarray(batch))
    if dev.type == "cuda":
        batch_dev = batch_dev.pin_memory().to(dev, non_blocking=True)

    auto_locate = max_locate is None
    if auto_locate:
        max_locate = max(1 << 16, 4 * batch.shape[0], _ml_hint_get(index))
    sched = compile_cached(scheme, m, metric,
                           kmer_k=(table_k(kmer_table)
                                   if kmer_table is not None else 0))
    auto_capacity = capacity is None
    if auto_capacity:
        # seeded exact prefixes kill most (read, search) lanes before the
        # band phase; with the crossover off survivors stay to the end
        div = 2 if switchpoint == 0 else 8
        capacity = max(1024, batch.shape[0] * sched.num_searches // div)
    if (switchpoint == 0 and ex_split == 0 and kmer_table is not None
            and sched.kmer_k > 0 and sched.e_max > 8):
        ex_split, ex_cap = 8, capacity

    def run(cap, ecap, ml):
        itv_cap, split_step, cap2 = crossover_caps(cap, ml, switchpoint)
        out = match_device_core(
            index, batch_dev, sched, int(cap), int(ml), kb, kmer_table,
            int(switchpoint), itv_cap, split_step, cap2,
            ex_split=int(ex_split), ex_cap=int(ecap))
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return out, event

    out, event = run(capacity, ex_cap, max_locate)
    return dict(out=out, event=event, run=run, capacity=capacity,
                ex_cap=ex_cap, auto_capacity=auto_capacity,
                auto_locate=auto_locate, R=R, m=m, k=k, kb=kb, index=index,
                redundancy_filter=redundancy_filter, max_locate=max_locate)


def fetch_tree(out: dict, event=None) -> dict:
    """Device result dict -> numpy, in one pass: every tensor is copied
    into a pinned host buffer on a side stream that waits for ``event``
    (the dispatch that produced them), then one synchronisation. The
    copies do not queue behind work dispatched after ``event``."""
    first = next(iter(out.values()))
    if not first.is_cuda:
        return {k: v.numpy() for k, v in out.items()}
    stream = torch.cuda.Stream(device=first.device)
    if event is not None:
        stream.wait_event(event)
    else:
        stream.wait_stream(torch.cuda.current_stream(first.device))
    host = {}
    with torch.cuda.stream(stream):
        for k, v in out.items():
            h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            h.copy_(v, non_blocking=True)
            host[k] = h
    stream.synchronize()
    return {k: v.numpy() for k, v in host.items()}


def match_all_finish(ctx) -> tuple[OccArray, dict]:
    """Fetch + post-process a match_all_start dispatch (may run on an
    emission thread while the main thread dispatches the next batch)."""
    out = fetch_tree(ctx["out"], ctx["event"])
    cap, ecap, ml = ctx["capacity"], ctx["ex_cap"], ctx["max_locate"]
    n_retries = 0
    for _ in range(3):
        # lossless retries: frontier/compaction overflow -> 4x capacities;
        # locate/verify spill -> 4x max_locate. Only auto-sized knobs grow.
        grow_cap = ctx["auto_capacity"] and int(out["overflow"]) > 0
        grow_ml = ctx["auto_locate"] and (
            int(out["total"]) > ml or int(out["n_unique"]) > ml)
        if not (grow_cap or grow_ml):
            break
        if grow_cap:
            cap, ecap = cap * 4, ecap * 4
        if grow_ml:
            ml *= 4
            _ml_hint_bump(ctx["index"], ml)
        n_retries += 1
        out = fetch_tree(*ctx["run"](cap, ecap, ml))
    R, m, k, kb = ctx["R"], ctx["m"], ctx["k"], ctx["kb"]
    aborted = int((out["valid"] & (out["final_rows"].min(axis=1) > k)).sum())
    stats = dict(
        total_candidates=int(out["total"]),
        overflow=int(out["overflow"]),
        nodes_visited=int(out["nodes_visited"]),
        itv_started=int(out["itv_started"]),
        searches_started=int(out["searches_started"]),
        aborted_in_text=aborted,
        retries=n_retries,
        locate_truncated=bool(out["total"] > ml)
        or bool(out["n_unique"] > ml),
    )
    occs = _extract_occurrences(out, R, m, k, kb, ctx["redundancy_filter"])
    return occs, stats


def _extract_occurrences(out, R, m, k, kb, redundancy_filter=True) -> OccArray:
    """Final-row cluster centres -> dedup'd occurrences (host numpy)."""
    valid = np.asarray(out["valid"])
    rows = np.asarray(out["final_rows"])
    pad = np.full((rows.shape[0], 1), 127, rows.dtype)
    left = np.concatenate([pad, rows[:, :-1]], axis=1)
    right = np.concatenate([rows[:, 1:], pad], axis=1)
    is_min = (rows <= k) & (rows <= left) & (rows <= right)
    is_min[:, 1:] &= rows[:, 1:] != left[:, 1:]   # plateau: keep leftmost
    is_min &= valid[:, None]
    ii, aa = np.nonzero(is_min)
    if not ii.size:
        return OccArray.empty()
    rid_all = np.asarray(out["rid"])[ii].astype(np.int64)
    end_all = np.asarray(out["win_start"])[ii].astype(np.int64) + m + (aa - kb)
    ed_all = rows[ii, aa].astype(np.int64)
    # min distance per (rid, end)
    order = np.lexsort((ed_all, end_all, rid_all))
    rid_s, end_s, ed_s = rid_all[order], end_all[order], ed_all[order]
    first = np.empty(order.size, bool)
    first[0] = True
    first[1:] = (rid_s[1:] != rid_s[:-1]) | (end_s[1:] != end_s[:-1])
    rid2, end2, ed2 = rid_s[first], end_s[first], ed_s[first]
    if redundancy_filter:
        rid2, end2, ed2 = _redundancy_filter_arr(rid2, end2, ed2, k)
    read_id, strand = rid2 % R, rid2 // R
    o2 = np.lexsort((end2, strand, read_id))
    return OccArray(read_id[o2], strand[o2], end2[o2] - m, end2[o2],
                    ed2[o2])


def apply_boundary_trim(occs: OccArray, reads_codes: np.ndarray, arrays,
                        kb: int, k: int) -> OccArray:
    """Cross-boundary occurrence trimming + re-verification: an alignment
    that straddles two sequences of the concatenated text is trimmed to the
    side within k of the boundary and re-verified there, or dropped
    (Hamming/exact spans are dropped)."""
    starts = arrays.seq_starts
    if len(starts) <= 2 or not len(occs):
        return occs
    from columba_tpu_torch.index.build import unpack_window
    from columba_tpu_torch.io import sam

    m = reads_codes.shape[1]
    ends = occs.end
    w_lo = np.maximum(ends - m - kb, 0)
    i_lo = np.searchsorted(starts, w_lo, side="right")
    i_hi = np.searchsorted(starts, ends - 1, side="right")
    suspect = i_lo != i_hi
    if not suspect.any():
        return occs
    keep = ~suspect
    nb = occs.begin.copy()
    ne = occs.end.copy()
    nd = occs.distance.copy()
    for j in np.nonzero(suspect)[0]:
        o_rid, o_str = int(occs.read_id[j]), int(occs.strand[j])
        o_end = int(occs.end[j])
        pat = (reads_codes[o_rid] if o_str == 0
               else alphabet.revcomp(reads_codes[o_rid]))
        lo0 = int(w_lo[j])
        window = unpack_window(arrays.text, lo0, o_end)
        begin_rel, _, _ = sam.traceback(pat, window, o_end - lo0, kb)
        begin = lo0 + begin_rel
        idx = int(np.searchsorted(starts, begin, side="right") - 1)
        if o_end <= starts[idx + 1]:
            keep[j] = True  # the window crossed, the alignment did not
            continue
        if kb == 0:
            continue  # hamming/exact: no trimming allowed -> drop
        if starts[idx + 1] - begin <= k:
            idx += 1
            lo, hi = int(starts[idx]), int(min(o_end, starts[idx + 1]))
        elif o_end - starts[idx + 1] <= k:
            lo, hi = begin, int(starts[idx + 1])
        else:
            continue
        res = sam.best_in_window(pat, unpack_window(arrays.text, lo, hi), k)
        if res is None:
            continue
        b, e, ed, _ = res
        keep[j] = True
        nb[j], ne[j], nd[j] = lo + b, lo + e, ed
    return OccArray(occs.read_id[keep], occs.strand[keep], nb[keep],
                    ne[keep], nd[keep])


def _redundancy_filter_arr(rid, end, ed, k: int):
    """Among occurrences of the same read/strand with nearby ends (window
    max(1, 2k) - 1, chained), keep the best by (distance, end). Inputs are
    sorted by (rid, end, ed); rid encodes (read, strand)."""
    n = rid.shape[0]
    if n == 0:
        return rid, end, ed
    thresh = max(1, 2 * k) - 1
    new = np.empty(n, bool)
    new[0] = True
    new[1:] = (rid[1:] != rid[:-1]) | ((end[1:] - end[:-1]) > thresh)
    cid = np.cumsum(new) - 1
    order = np.lexsort((end, ed, cid))
    firstc = np.empty(order.size, bool)
    firstc[0] = True
    firstc[1:] = cid[order][1:] != cid[order][:-1]
    keep = np.sort(order[firstc])
    return rid[keep], end[keep], ed[keep]
