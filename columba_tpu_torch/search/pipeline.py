"""End-to-end matching pipeline: executor -> locate -> verify -> occurrences.

The counterpart of ``columba_tpu/search/pipeline.py`` for ALL mode: pick the
schedule (uniform or static partition, compiled once; or dynamic
partitioning, whose per-read tables kernels F and G make on the device
before every run; a list of schemes adds the per-read scheme selection
probe), run the scheme over the frontier, expand the
candidate SA ranges to rows (count, then gather), locate them, dedup the
(read, window) pairs, verify in text, and post-process on the host (cluster
centres, dedup, redundancy filter) into occurrences. k = 0 without a seed
table or without the in-text crossover takes the exact pass instead: one
backward match per strand (kernel E), expand, locate.

The device part returns fixed-shape tensors; ``match_all_finish`` copies
them to the host in one pass (pinned buffers, one synchronisation) and
re-runs with 4x capacities while a frontier overflowed or the locate/verify
capacity spilled, which keeps the search lossless. The re-runs have no cap
on their count: the JAX package stops after three, and on a repeat-rich
genome (a pan-genome's 20-fold loci, where the frontier's second stage of
capacity / 16 and the locate cap both spill) it then drops occurrences
with a warning (ROADMAP queue 3).

The RLC index (``index/bmove.py``) takes the same path with 8-wide lanes
and no seed table. The textless RLC index has no text and no SA samples:
its pass is the frontier alone (kernel B's textless entry), and the done
lanes' toehold samples are expanded into text positions on the host with
the phi tables (:func:`_match_textless`, numpy).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from columba_tpu_torch.core import alphabet
from columba_tpu_torch.index.bmove import BMoveIndex
from columba_tpu_torch.index.fmindex import FMIndex
from columba_tpu_torch.ops import extend, locate, verify
from columba_tpu_torch.search import dynschedule, executor, schedule
from columba_tpu_torch.search.scheme import SearchScheme


@dataclass
class Occurrence:
    """One verified text occurrence of a read."""

    read_id: int
    strand: int          # 0 fwd, 1 revcomp
    begin: int           # text start
    end: int             # text end (exclusive)
    distance: int


class OccArray:
    """Occurrences as struct-of-arrays (numpy, int64). Iteration and integer
    indexing yield :class:`Occurrence` views for the list-based callers
    (the paired-end object path, tests)."""

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

    @staticmethod
    def concat(parts: list) -> "OccArray":
        parts = [p for p in parts if len(p)]
        if not parts:
            return OccArray.empty()
        return OccArray(*(np.concatenate([getattr(p, f) for p in parts])
                          for f in OccArray.__slots__))

    def take(self, idx) -> "OccArray":
        return OccArray(*(getattr(self, f)[idx] for f in OccArray.__slots__))

    def __len__(self):
        return self.read_id.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            return Occurrence(int(self.read_id[i]), int(self.strand[i]),
                              int(self.begin[i]), int(self.end[i]),
                              int(self.distance[i]))
        return self.take(i)


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------

def crossover_caps(capacity: int, max_locate: int, switchpoint: int):
    """Derived in-text crossover sizing (itv_cap, split_step, capacity2)."""
    if switchpoint > 0:
        return int(max_locate), 2, max(1024, int(capacity) // 16)
    return 0, 0, 0


def stage_candidates(res: executor.FrontierResult, tables: dict, S: int,
                     dyn: dict | None = None):
    """Completed frontier lanes + in-text rows [f_lo, f_hi, ids, depth] ->
    one candidate list (c_lo, c_hi, c_rid, c_estb); estb is the read
    start's offset from the back-side text depth. The back depth and pivot
    are per search (``tables``) or, under dynamic partitioning, per (read,
    search) lane (``dyn``)."""
    fr_lo = torch.where(res.done, res.ranges[:, 0], 0)
    fr_hi = torch.where(res.done, res.ranges[:, 1], 0)
    itv = res.itv
    iv_valid = torch.arange(itv.shape[0], device=itv.device) < res.itv_count
    iv_lo = torch.where(iv_valid, itv[:, 0], 0)
    iv_hi = torch.where(iv_valid, itv[:, 1], 0)
    iv_ids = itv[:, 2]
    if dyn is not None:
        lane_fr = res.rid * S + res.sid
        fr_estb = (dyn["t_back"][lane_fr] - dyn["pivot"][lane_fr]).long()
        iv_estb = itv[:, 3] - dyn["pivot"][iv_ids].long()
    else:
        fr_estb = tables["t_back"][res.sid] - tables["pivot"][res.sid]
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
                      ex_split: int = 0, ex_cap: int = 0, search_mask=None,
                      dyn: dict | None = None) -> dict:
    """Device-side match step: reads (R, m) uint8 on the index's device."""
    if max_verify is None:
        max_verify = max_locate
    tables = (executor.device_tables(sched, reads.device) if dyn is None
              else None)
    res = executor.run_scheme(
        index, reads, sched, capacity, kmer_table, switchpoint, itv_cap,
        split_step, capacity2, itv_min_depth=itv_min_depth, tables=tables,
        ex_split=ex_split, ex_cap=ex_cap, search_mask=search_mask, dyn=dyn)
    c_lo, c_hi, c_rid, c_estb = stage_candidates(res, tables,
                                                 sched.num_searches, dyn)
    rows, cand, valid, total = stage_expand(c_lo, c_hi, max_locate)
    pos = locate.locate_rows(index, rows)
    win_start = pos + c_estb[cand] - kb          # signed: may be < 0
    rid_v, win_v, vlive, n_uniq = stage_dedup(c_rid[cand], win_start, valid,
                                              max_verify)
    final_rows = verify.verify_window(index, reads, rid_v, win_v, kb,
                                      live=n_uniq)
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
                   kmer_k: int = 0,
                   partitioning: str = "uniform") -> schedule.Schedule:
    key = (scheme, m, metric, kmer_k, partitioning)
    if key not in _SCHED_CACHE:
        partition = None
        if partitioning == "static" and scheme.static_fracs:
            partition = schedule.static_partition(m, scheme.static_fracs)
        _SCHED_CACHE[key] = schedule.compile_schedule(
            scheme, m, partition=partition, metric=metric, kmer_k=kmer_k)
    return _SCHED_CACHE[key]


_SCHEME_STATIC_CACHE: dict = {}


def _scheme_static_cached(scheme: SearchScheme, m: int, metric: str):
    key = (scheme, m, metric)
    if key not in _SCHEME_STATIC_CACHE:
        _SCHEME_STATIC_CACHE[key] = dynschedule.scheme_static(scheme, m,
                                                              metric)
    return _SCHEME_STATIC_CACHE[key]


def part_exact_ranges(index: FMIndex, reads: torch.Tensor,
                      pts) -> torch.Tensor:
    """Exact-match ranges of every partition part, batched (kernel E with
    per-row lengths on the card).

    reads: (R, m) uint8; pts: part boundaries (p+1,). Returns (R, p, rw)
    int64 (rw = 4, or 8 with run hints on the RLC index, kernel E's
    ``rlc_lengths`` entry); a part without a match has the zero range. The
    analogue of the reference's calculateExactMatchRanges
    (src/searchstrategy.cpp:158-190); feeds dynamic scheme selection.
    """
    R, m = reads.shape
    pl = [int(x) for x in pts]
    p = len(pl) - 1
    lens = [pl[i + 1] - pl[i] for i in range(p)]
    maxlen = max(lens)
    # patterns (R*p, maxlen): part i of read r, padded with 5
    pos = np.full((p, maxlen), -1, dtype=np.int64)
    for i in range(p):
        pos[i, :lens[i]] = np.arange(pl[i], pl[i + 1])
    pos = torch.from_numpy(pos).to(reads.device)
    chars = torch.where((pos >= 0)[None], reads[:, pos.clamp(0, m - 1)], 5)
    lengths = torch.tensor(lens, dtype=torch.int32, device=reads.device)
    flat = chars.reshape(R * p, maxlen).to(torch.uint8).contiguous()
    rng = extend.exact_match(index, flat, lengths.repeat(R))
    return rng.reshape(R, p, -1)


def select_schemes(index: FMIndex, batch: torch.Tensor,
                   schemes: list[SearchScheme]):
    """Dynamic per-read scheme selection.

    Returns (combined scheme, search_mask (R, S_total) bool, choice (R,)),
    the last two as numpy arrays: the exact ranges of the uniform parts
    come to the host (one synchronisation) and the choice is made there.
    The rule mirrors the reference (src/searchstrategy.h:2505-2537): pick
    the scheme whose critical search starts at the part with the fewest
    exact matches; scheme 0 when the total exact count is <= #parts.
    """
    k = schemes[0].k
    p = schemes[0].num_parts
    m = batch.shape[1]
    pts = schedule.uniform_partition(m, p)
    ranges = part_exact_ranges(index, batch, pts)[..., :2].cpu().numpy()
    widths = ranges[:, :, 1] - ranges[:, :, 0]           # (R, p) int64
    crit = np.array([sc.critical_part_index for sc in schemes])
    crit_w = widths[:, crit]                             # (R, n_schemes)
    choice = np.argmin(crit_w, axis=1)
    choice = np.where(widths.sum(axis=1) <= p, 0, choice)

    all_searches = tuple(s for sc in schemes for s in sc.searches)
    combined = SearchScheme(all_searches, k=k,
                            name="+".join(sc.name for sc in schemes))
    scheme_of = np.concatenate([
        np.full(len(sc.searches), i) for i, sc in enumerate(schemes)
    ])
    mask = scheme_of[None, :] == choice[:, None]         # (R, S_total)
    return combined, mask, choice


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
    partitioning: str = "uniform",
    partition_pts=None,
    switchpoint: int = 0,
    ex_split: int = 0,
    ex_cap: int = 0,
    host_arrays=None,
) -> dict:
    """Dispatch ALL-mode matching of a read batch (every occurrence with
    ed <= k); returns the context for :func:`match_all_finish`.

    reads_codes: (R, m) uint8 codes. k = 0 runs through the scheme
    executor, as in the JAX package, when a seed table and the in-text
    crossover are on, and takes the exact pass otherwise. ``scheme`` may be
    a list of schemes with one part count: each read then runs the one
    :func:`select_schemes` picks for it. ``partitioning``: "uniform",
    "static" (the scheme's own fractions) or "dynamic" (per-read greedy
    boundaries, kernels F and G); ``partition_pts`` (rows, p+1) gives the
    boundaries of every row (both strands) directly. ``host_arrays``: the
    textless index's host arrays (its phi tables locate on the host).
    """
    from columba_tpu_torch.index.kmer import table_k

    R, m = reads_codes.shape
    k = scheme[0].k if isinstance(scheme, (list, tuple)) else scheme.k
    kb = k if metric == "edit" else 0
    batch = reads_codes.astype(np.uint8)
    if both_strands:
        batch = np.concatenate([batch, alphabet.revcomp(batch, axis=-1)])
    dev = index.device
    batch_dev = torch.from_numpy(np.ascontiguousarray(batch))
    if dev.type == "cuda":
        batch_dev = batch_dev.pin_memory().to(dev, non_blocking=True)

    if getattr(index, "textless", False):
        if isinstance(scheme, (list, tuple)):
            # per-read selection only saves work (every scheme of a
            # collection is lossless at k): the textless pass runs the
            # collection's first scheme
            scheme = scheme[0]
            k = scheme.k
        # k = 0 runs the exact scheme through the same frontier-only pass
        if host_arrays is None or getattr(host_arrays, "phi_fwd",
                                          None) is None:
            raise ValueError("textless RLC matching needs host_arrays "
                             "with phi tables")
        sched = compile_cached(scheme, m, metric, kmer_k=0,
                               partitioning="uniform")
        if capacity is None:
            capacity = max(1024, batch.shape[0] * sched.num_searches // 2)
        return dict(result=_match_textless(index, host_arrays, batch_dev, R,
                                           k, kb, sched, capacity,
                                           auto_capacity=True))
    auto_locate = max_locate is None
    if auto_locate:
        max_locate = max(1 << 16, 4 * batch.shape[0], _ml_hint_get(index))
    if k == 0 and (kmer_table is None or switchpoint <= 0):
        out, event = _exact_device(index, batch_dev, int(max_locate))
        return dict(exact=dict(out=out, event=event, batch=batch_dev, R=R,
                               max_locate=max_locate,
                               auto_locate=auto_locate, index=index))
    search_mask = mask_np = None
    if isinstance(scheme, (list, tuple)):
        scheme, mask_np, _ = select_schemes(index, batch_dev, list(scheme))
        search_mask = torch.from_numpy(mask_np).to(dev)

    if (partitioning == "dynamic" and partition_pts is None
            and m < scheme.num_parts * (2 * kb + 1)):
        # per-read schedules need every part >= 2*kb+1 (the overshoot
        # construction); a read too short for that takes the static
        # compiler's short-part path (rotating colMin registers)
        partitioning = "uniform"
    make_dyn = None
    if partitioning == "dynamic" or partition_pts is not None:
        st = _scheme_static_cached(scheme, m, metric)
        # the boundaries do not depend on the capacities: one partition a
        # dispatch, kept for its lossless re-runs
        pts = (torch.from_numpy(np.ascontiguousarray(
                   partition_pts, dtype=np.int32)).to(dev)
               if partition_pts is not None else
               dynschedule.dynamic_partition(index, batch_dev, scheme,
                                             kmer_table))

        def make_dyn():
            # tables and match run one after another on the stream; the
            # tables live only as long as the run that reads them (a
            # re-run makes them again from the same boundaries)
            return dynschedule.build_tables(st, pts, batch_dev)

    sched = compile_cached(scheme, m, metric,
                           kmer_k=(table_k(kmer_table)
                                   if kmer_table is not None
                                   and make_dyn is None else 0),
                           partitioning="uniform" if make_dyn is not None
                           else partitioning)
    auto_capacity = capacity is None
    if auto_capacity:
        # seeded exact prefixes kill most (read, search) lanes before the
        # band phase; with the crossover off survivors stay to the end.
        # Under scheme selection only one scheme's searches live per read.
        live_s = sched.num_searches
        if mask_np is not None:
            live_s = int(mask_np.sum(axis=1).max())
        div = 2 if switchpoint == 0 else 8
        capacity = max(1024, batch.shape[0] * live_s // div)
    if (switchpoint == 0 and ex_split == 0 and kmer_table is not None
            and make_dyn is None and sched.kmer_k > 0 and sched.e_max > 8):
        ex_split, ex_cap = 8, capacity

    def run(cap, ecap, ml):
        itv_cap, split_step, cap2 = crossover_caps(cap, ml, switchpoint)
        out = match_device_core(
            index, batch_dev, sched, int(cap), int(ml), kb, kmer_table,
            int(switchpoint), itv_cap, split_step, cap2,
            ex_split=int(ex_split), ex_cap=int(ecap),
            search_mask=search_mask,
            dyn=make_dyn() if make_dyn is not None else None)
        return out, _record_event(dev)

    out, event = run(capacity, ex_cap, max_locate)
    return dict(out=out, event=event, run=run, capacity=capacity,
                ex_cap=ex_cap, auto_capacity=auto_capacity,
                auto_locate=auto_locate, R=R, m=m, k=k, kb=kb, index=index,
                redundancy_filter=redundancy_filter, max_locate=max_locate)


def _record_event(dev):
    """A CUDA event after the work dispatched so far on this thread's
    current stream (None on the CPU): what the fetch of that work waits on."""
    if dev.type != "cuda":
        return None
    event = torch.cuda.Event()
    event.record()
    return event


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
    if "result" in ctx:
        return ctx["result"]
    if "exact" in ctx:
        return _match_exact_finish(ctx["exact"])
    out = fetch_tree(ctx["out"], ctx["event"])
    cap, ecap, ml = ctx["capacity"], ctx["ex_cap"], ctx["max_locate"]
    n_retries = 0
    while True:
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


def _exact_device(index: FMIndex, batch: torch.Tensor, max_locate: int):
    """k = 0 device step: exact backward match (kernel E on the card), then
    the two-phase expand and locate of the scheme path. Returns the result
    tensors and the CUDA event recorded after them."""
    ranges = extend.exact_match(index, batch)
    rows, cand, valid, total = stage_expand(ranges[:, 0], ranges[:, 1],
                                            max_locate)
    pos = locate.locate_rows(index, rows)
    return (dict(pos=pos, cand=cand, valid=valid, total=total),
            _record_event(batch.device))


def _match_exact_finish(ec) -> tuple[OccArray, dict]:
    """Fetch + retry + host-side assembly of a dispatched k = 0 pass: 4x
    max_locate while the expansion spilled, then occurrences in (read,
    strand, position) order."""
    index, batch, R = ec["index"], ec["batch"], ec["R"]
    ml = ec["max_locate"]
    m = batch.shape[1]
    out = fetch_tree(ec["out"], ec["event"])
    tries = 0
    while ec["auto_locate"] and int(out["total"]) > ml:
        ml *= 4
        _ml_hint_bump(index, ml)
        out = fetch_tree(*_exact_device(index, batch, int(ml)))
        tries += 1
    total = int(out["total"])
    pos_v = out["pos"][out["valid"]].astype(np.int64)
    cand_v = out["cand"][out["valid"]].astype(np.int64)
    read_id, strand = cand_v % R, cand_v // R
    order = np.lexsort((pos_v, strand, read_id))
    occs = OccArray(read_id[order], strand[order], pos_v[order],
                    pos_v[order] + m, np.zeros(order.size, np.int64))
    stats = dict(total_candidates=total, overflow=0, nodes_visited=0,
                 locate_truncated=total > ml, retries=tries)
    return occs, stats


def _textless_device(index: BMoveIndex, batch: torch.Tensor, sched,
                     capacity: int):
    """Textless RLC device step: the scheme run only, no locate or verify
    (both need O(n) structures); done lanes carry toehold samples in their
    range vectors, and ``track_arg`` keeps the matched-length witness so
    edit begins come out exact. Returns the result tensors and the CUDA
    event recorded after them."""
    tables = executor.device_tables(sched, batch.device)
    res = executor.run_scheme(index, batch, sched, int(capacity), None, 0,
                              0, 0, 0, tables=tables, track_arg=True)
    return (dict(ranges=res.ranges, rid=res.rid, sid=res.sid,
                 ed_lb=res.ed_lb, done=res.done, overflow=res.overflow,
                 nodes=res.nodes_visited, harvest=res.itv_count,
                 searches=res.searches_started, arg_b=res.arg_b),
            _record_event(batch.device))


def _phi_eval(vals: np.ndarray, xs: np.ndarray, ys: np.ndarray):
    j = np.searchsorted(xs, vals, side="right") - 1
    return ys[j] + (vals - xs[j])


def _phi_enumerate(seed, offs, widths, phi: np.ndarray):
    """Enumerate every row of each candidate interval from one in-range
    sample (value ``seed``, 0-based interval offset ``offs``, interval width
    ``widths``): phi walks up (rows offs-1..0), phi-inverse walks down (rows
    offs+1..w-1), vectorized across candidates; the pass count is the
    longest chain. Returns flat (candidate index, value) arrays. The
    analogue of the reference's toehold + phi enumeration
    (src/bmove/bmove.cpp:503-547, plcp.h:59-130): the known width and
    offset replace its PLCP stop condition."""
    xs, ys, xsi, ysi = (phi[:, 0].astype(np.int64),
                        phi[:, 1].astype(np.int64),
                        phi[:, 2].astype(np.int64),
                        phi[:, 3].astype(np.int64))
    n_c = len(seed)
    out_idx = [np.arange(n_c)]
    out_val = [seed.astype(np.int64)]
    for steps, txs, tys in ((offs, xs, ys), (widths - 1 - offs, xsi, ysi)):
        live = np.nonzero(steps > 0)[0]
        vals = seed[live].astype(np.int64)
        rem = steps[live].copy()
        while live.size:
            vals = _phi_eval(vals, txs, tys)
            out_idx.append(live.copy())
            out_val.append(vals.copy())
            rem -= 1
            keep = rem > 0
            live, vals, rem = live[keep], vals[keep], rem[keep]
    return np.concatenate(out_idx), np.concatenate(out_val)


def _match_textless(index: BMoveIndex, host_arrays, batch_dev, R: int,
                    k: int, kb: int, sched, capacity: int,
                    auto_capacity: bool = True):
    """Textless RLC matching: the frontier-only device pass, then locate
    by phi on the host (numpy). Distances are the searches' extent
    distances (``ed_lb`` of done lanes); begins are extent starts plus the
    back overshoot the lane consumed, recovered from its matched-length
    witness (``arg_b``); occurrences of one (read, strand) within
    max(2kb, 1) - 1 of each other collapse to the first. This is the
    reference's RLC no-CIGAR reporting mode and the JAX package's rule
    (``columba_tpu/search/pipeline.py:832-933``), kept as it is."""
    cap = int(capacity)
    out = fetch_tree(*_textless_device(index, batch_dev, sched, cap))
    retries = 0
    while auto_capacity and int(out["overflow"]) > 0:
        cap *= 4
        retries += 1
        out = fetch_tree(*_textless_device(index, batch_dev, sched, cap))

    sel = out["done"]
    ranges = out["ranges"][sel]
    rid = out["rid"][sel].astype(np.int64)
    sid = out["sid"][sel].astype(np.int64)
    ed = out["ed_lb"][sel].astype(np.int64)
    arg_b = out["arg_b"][sel].astype(np.int64)
    stats = dict(
        total_candidates=0, overflow=int(out["overflow"]),
        nodes_visited=int(out["nodes"]),
        itv_started=0, searches_started=int(out["searches"]),
        # harvest rows carry no toehold; without text they cannot be
        # located (text-boundary deaths only): counted, not reported
        aborted_in_text=int(out["harvest"]),
        locate_truncated=False, retries=retries,
    )
    if not sel.any():
        return OccArray.empty(), stats

    n = index.n
    flag = ranges[:, 10]
    lo = np.where(flag == 0, ranges[:, 0], ranges[:, 2])
    hi = np.where(flag == 0, ranges[:, 1], ranges[:, 3])
    w = hi - lo
    tv = ranges[:, 8]
    toff = ranges[:, 9]
    # the extent's text length is the search's extension count; the begin
    # correction is the back overshoot the lane actually consumed (0 where
    # the back side is exact only, arg_b = -1)
    active = np.asarray(sched.active)
    ex_pos = np.asarray(sched.ex_pos)
    t_total = (ex_pos >= 0).sum(axis=1) + active.sum(axis=1)   # (S,)
    t_back_s = np.asarray(sched.t_back, dtype=np.int64)

    # enumerate each side's interval with its own phi tables
    parts = []
    for f, phi in ((0, host_arrays.phi_fwd), (1, host_arrays.phi_rev)):
        m_ = flag == f
        if not m_.any():
            continue
        seed = tv[m_] if f == 0 else (n - 1 - tv[m_])
        ci, vals = _phi_enumerate(seed, toff[m_], w[m_], phi)
        src = np.nonzero(m_)[0][ci]
        if f == 1:
            # rev SA value -> fwd extent start
            ends = n - 1 - vals
            vals = ends - (t_total[sid[src]] - 1)
        parts.append((src, vals))
    src = np.concatenate([p[0] for p in parts])
    starts = np.concatenate([p[1] for p in parts])
    stats["total_candidates"] = int(len(src))

    corr = (t_back_s[sid[src]] - arg_b[src]) & 63
    corr = np.where(arg_b[src] < 0, 0, corr)
    begin = np.clip(starts + corr, 0, n - 1)
    read = rid[src] % R
    strand = rid[src] // R
    dist = ed[src]
    m_read = int(batch_dev.shape[1])
    # dedup + redundancy collapse: same (read, strand) within +-kb keeps
    # the lowest distance
    order = np.lexsort((dist, begin, strand, read))
    read, strand, begin, dist = (read[order], strand[order], begin[order],
                                 dist[order])
    keep = np.ones(len(read), dtype=bool)
    if len(read) > 1:
        same = (read[1:] == read[:-1]) & (strand[1:] == strand[:-1])
        near = begin[1:] - begin[:-1] <= max(2 * kb, 1) - 1
        # a chain of near rows collapses to its first (lowest begin, then
        # lowest distance)
        keep[1:] = ~(same & near)
    read, strand, begin, dist = (read[keep], strand[keep], begin[keep],
                                 dist[keep])
    return OccArray(read, strand, begin, begin + m_read, dist), stats


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
