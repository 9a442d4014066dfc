"""Kernels A (its RLC loop), B (its RLC entries), C, D, E, F and G on the
inputs an align gives them: capture and timing.

``capture(align)`` runs one ``align()`` with wrappers around
``locate.locate_rows``, ``verify.verify_window``, ``extend.exact_match``,
``dynschedule.dynamic_partition``, ``dynschedule.build_tables``,
``pipeline.expand_rows``, ``pipeline.stage_dedup``,
``executor.band_step_compact`` and ``executor.exact_loop`` (module
attributes; nothing in the library is hooked) and keeps each locate,
verify, exact-match, partition and schedule-table launch's inputs, with
the live counts beside the capacity (``total`` of the expansion,
``n_unique`` of the dedup) for C and D, and of kernel B's static
(``band_step``) and RLC entries and kernel A's ``loop_rlc`` the launch
with the most live lanes of each entry (an align makes hundreds of band
steps). ``time_inputs`` holds
every captured launch to its plain version and times it through the
wrapper with two clocks: CUDA events over back-to-back launches, and the
kernel's own device time from ``torch.profiler``; each with a warm L2 and
with the L2 flushed before each launch by a 64 MB write, since a batch of
the path finds the index cold. Beside each time it prints the counts the
plain versions make (kernels E and F on the RLC index: their
dependent-read rounds a row, and those of a thread that walks the four
run hints one after another) and ``tools/bounds.py``'s bound on that
input.

Used by ``chip_smoke.py`` and ``tools/kernel_bench.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FLUSH_BYTES = 64 << 20     # above the 50 MB L2
# a part of the kernel's name in the profiler's trace, in every tree
KERNEL_NAME = {"verify": "verify", "locate": "locate_kernel",
               "locate.rlc": "locate_rlc", "exact": "exact_",
               "exact.lengths": "exact_", "exact.rlc": "exact_",
               "exact.rlc_lengths": "exact_", "dynpart": "dynpart_kernel",
               "dynpart.rlc": "dynpart_kernel", "dyn_tables": "dyn_tables",
               # the RLC entries have a kernel of their own since the
               # quad walks; earlier trees launched band_step_kernel
               "band_step.rlc": ("band_step_rlc_kernel", "band_step_kernel"),
               "band_step.per_lane_rlc": ("band_step_rlc_kernel",
                                          "band_step_kernel"),
               "band_step.textless": ("band_step_rlc_kernel",
                                      "band_step_kernel"),
               "extend.loop_rlc": "extend_loop_kernel",
               # kb 8..13 on the Vanilla index: the quad body's kernel
               "band_step": ("band_step_kernel", "band_step_quad_kernel"),
               "band_step.per_lane": ("band_step_kernel",
                                      "band_step_quad_kernel")}
BAND_KINDS = ("band_step", "band_step.per_lane", "band_step.rlc",
              "band_step.per_lane_rlc", "band_step.textless")


def log(msg: str) -> None:
    print(msg, flush=True)


def band_args(index, sched, batch, ranges, rng, switchpoint, div=8,
              C=None):
    """One band step's inputs at the shapes ``match_all`` gives a batch:
    capacity C = rows x searches / div (8 with the in-text crossover, 2
    without) unless given, real ranges, the schedule's own step tables and
    cells (the batch and the cell tables, read at use), random band and
    register state."""
    from columba_tpu_torch.search import executor

    dev = index.device
    R, S = batch.shape[0], sched.num_searches
    C = max(1024, R * S // div) if C is None else C
    tables = executor.device_tables(sched, dev)
    t = sched.t_max // 2
    ids = torch.from_numpy(rng.integers(0, R * S, C).astype(np.int32)).to(dev)
    band = torch.from_numpy(rng.integers(0, 4, (C, 2, sched.bw)).astype(
        np.int8)).to(dev)
    colmin = torch.from_numpy(rng.integers(0, 3, (C, 2, sched.W)).astype(
        np.int8)).to(dev)
    cells = executor.StaticCells(batch, tables["cells"])
    return (index, ranges[:C].contiguous(), ids, band, colmin,
            tables["mrow"][t], cells, sched.t_max, t, switchpoint)


def random_band_args(index, batch, ranges, rng, kb, W, S, T, switchpoint):
    """A band step of radius kb with W registers over S searches and T
    steps on random step tables, in :func:`band_args`' form (one lane a
    row of ``ranges``): random meta words (half the searches active),
    register ops and initial values in the layout of
    ``executor.host_tables``, and random cell tables over ``batch``'s
    reads; for shapes whose schedule is slow to compile on the host."""
    from columba_tpu_torch.search import executor

    dev = index.device
    R, m = batch.shape
    C, bw = ranges.shape[0], 2 * kb + 1
    meta = (rng.integers(0, 2, S) | (rng.integers(0, 2, S) << 1)
            | (rng.choice([*range(W), 15], S) << 2)
            | (rng.choice([*range(W), 15], S) << 6)
            | (rng.integers(0, 8, S) << 10) | (rng.integers(0, 2000, S) << 18))
    words = np.zeros((S, 6), np.int64)
    for w in range(W):
        op = rng.choice([*range(bw), 63], S) | (rng.integers(0, 2, S) << 6)
        words[:, w // 4] |= op << (7 * (w % 4))
        words[:, 3 + w // 4] |= rng.integers(0, 128, S) << (7 * (w % 4))
    mrow = np.concatenate([meta[:, None], words], axis=1).astype(np.int32)
    code = rng.choice([0, 0, 0, 0, 0, -1, -2], (S, T, bw)).astype(np.int8)
    cells = executor.StaticCells(batch, torch.from_numpy(executor.cell_table(
        rng.integers(0, m, (S, T, bw)), code)).to(dev))
    ids = torch.from_numpy(rng.integers(0, R * S, C).astype(np.int32)).to(dev)
    band = torch.from_numpy(rng.integers(0, 4, (C, 2, bw)).astype(
        np.int8)).to(dev)
    colmin = torch.from_numpy(rng.integers(0, 3, (C, 2, W)).astype(
        np.int8)).to(dev)
    return (index, ranges.contiguous(), ids, band, colmin,
            torch.from_numpy(mrow).to(dev), cells, T, T // 2, switchpoint)


def rlc_lane_states(index, batch, rng, L, max_len=24):
    """Valid lane states of an RLC index at the exact prefix's shapes: each
    lane matches a random stretch (0 to ``max_len`` chars) of a read of
    ``batch`` by extensions in random directions from the full range,
    through the plain extension; a lane whose stretch does not occur ends
    all zero."""
    from columba_tpu_torch.ops import extend

    dev = index.device
    R, m = batch.shape
    row = torch.from_numpy(rng.integers(0, R, L)).to(dev)
    lo = torch.from_numpy(rng.integers(max_len, m - max_len, L)).to(dev)
    hi = lo.clone()
    length = torch.from_numpy(rng.integers(0, max_len + 1, L)).to(dev)
    ranges = index.full_range((L,))
    for step in range(max_len):
        fwd = torch.from_numpy(rng.integers(0, 2, L).astype(bool)).to(dev)
        chars = batch[row, torch.where(fwd, hi, lo - 1)].int()
        new = extend.extend_char_plain(index, ranges, chars, fwd.int())
        act = step < length
        ranges = torch.where(act[:, None], new, ranges)
        lo = torch.where(act & ~fwd, lo - 1, lo)
        hi = torch.where(act & fwd, hi + 1, hi)
    return ranges.contiguous()


def band_input(kind: str, args, track: bool = False, dyn_meta=None,
               M: int | None = None) -> dict:
    """A band step of :func:`band_args` (or its per-lane form: ``args``'s
    step row None and ``dyn_meta`` the lanes' words) as a captured input:
    room for every child and ``M`` in-text rows (4 C, at least 65,536)."""
    index, ranges, ids, band, colmin, mrow_t, cells, T, t, sp = args
    C = ranges.shape[0]
    return dict(kind=kind, index=index, state=[ranges, ids, band, colmin],
                cap=C, M=max(1 << 16, 4 * C) if M is None else M, cnt=0,
                mrow_t=mrow_t, cells=cells, T=T, t=t, switchpoint=sp,
                dyn_meta=dyn_meta, track_arg=track)


class Clocks:
    """Events and profiler times of one launch function, warm and cold."""

    def __init__(self, reps: int):
        self.reps = reps
        self.scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                                   device="cuda")

    def flush(self) -> None:
        self.scratch.fill_(1)

    def events(self, fn, cold: bool) -> float:
        fn()
        torch.cuda.synchronize()
        if not cold:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(self.reps):
                fn()
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b) / self.reps
        pairs = []
        for _ in range(self.reps):
            self.flush()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / self.reps

    def profiled(self, fn, name, cold: bool):
        """Mean device ms a launch of the kernels whose name holds ``name``
        (or one of a tuple of names), from ``torch.profiler``; None if it
        records no device time."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(self.reps):
                if cold:
                    self.flush()
                fn()
            torch.cuda.synchronize()
        names = (name,) if isinstance(name, str) else name
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if any(n in ev.key for n in names):
                t = getattr(ev, "device_time_total", None)
                if t is None:
                    t = getattr(ev, "cuda_time_total", 0.0)
                total += t
                count += ev.count
        if count == 0:
            return None
        return total / 1000.0 / count      # per launch the trace recorded

    def device_ms(self, fn, cold: bool = False):
        """Mean device ms of everything one ``fn()`` runs on the card (its
        kernels, memsets and copies: a library call's), from
        ``torch.profiler``'s device events; None if it records none."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(self.reps):
                if cold:
                    self.flush()
                fn()
            torch.cuda.synchronize()
        flush = "fill" if cold else None
        total = 0.0
        seen = False
        for ev in prof.events():
            if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
                continue
            if flush is not None and flush in ev.name.lower():
                continue
            total += ev.time_range.end - ev.time_range.start
            seen = True
        return total / 1000.0 / self.reps if seen else None

    def all(self, fn, name: str) -> dict:
        return dict(events_warm=self.events(fn, False),
                    events_cold=self.events(fn, True),
                    prof_warm=self.profiled(fn, name, False),
                    prof_cold=self.profiled(fn, name, True))


def _clone(t):
    return None if t is None else t.clone()


def capture(align) -> list:
    """The locate, verify, exact-match, partition and schedule-table
    launches of one ``align()`` call, each with its inputs (cloned) and, for
    locate and verify, the live counts around it; of each of kernel B's
    entries (at each band radius) and of kernel A's ``loop_rlc`` the launch
    with the most lanes."""
    from columba_tpu_torch.index.bmove import BMoveIndex
    from columba_tpu_torch.ops import extend, locate, verify
    from columba_tpu_torch.search import dynschedule, executor, pipeline

    calls, pending, widest = [], {}, {}
    saved = (locate.locate_rows, verify.verify_window, pipeline.expand_rows,
             pipeline.stage_dedup, extend.exact_match,
             dynschedule.dynamic_partition, dynschedule.build_tables,
             executor.band_step_compact, executor.exact_loop)

    def keep_widest(kind, lanes, make, kb=None):
        key = (kind, kb)
        if key not in widest or lanes > widest[key]["lanes"]:
            widest[key] = dict(make(), kind=kind, lanes=lanes)

    def band(index, state, n_live, out, itv, cnt, scratch, mrow_t, cells,
             T, t, switchpoint, dyn_meta=None, track_arg=False):
        kind = None
        if isinstance(index, BMoveIndex):
            kind = ("band_step.per_lane_rlc" if dyn_meta is not None else
                    "band_step.textless" if index.textless
                    else "band_step.rlc")
        else:
            kind = "band_step" if dyn_meta is None else "band_step.per_lane"
        if kind is not None:
            kb = (state[2].shape[-1] - 1) // 2
            keep_widest(kind, n_live, lambda: dict(
                index=index, state=[f[:n_live].clone() for f in state],
                cap=out[0].shape[0], M=itv.shape[0] - 1, cnt=cnt,
                mrow_t=_clone(mrow_t), cells=_deep(cells, torch.clone),
                T=T, t=t, switchpoint=switchpoint,
                dyn_meta=_clone(dyn_meta), track_arg=track_arg, kb=kb), kb)
        return saved[7](index, state, n_live, out, itv, cnt, scratch,
                        mrow_t, cells, T, t, switchpoint, dyn_meta,
                        track_arg)

    def loop(index, ranges, ids, t_lo, t_hi, reads, tabs, per_lane, gate_t,
             switchpoint):
        if isinstance(index, BMoveIndex):
            keep_widest("extend.loop_rlc", ranges.shape[0], lambda: dict(
                index=index, ranges=ranges.clone(), ids=_clone(ids),
                t_lo=t_lo, t_hi=t_hi, reads=reads.clone(),
                tabs=tuple(x.clone() for x in tabs), per_lane=per_lane,
                gate_t=gate_t, switchpoint=switchpoint))
        return saved[8](index, ranges, ids, t_lo, t_hi, reads, tabs,
                        per_lane, gate_t, switchpoint)

    def expand(c_lo, offsets, total, max_locate):
        pending["total"] = int(total)
        return saved[2](c_lo, offsets, total, max_locate)

    def dedup(*args, **kwargs):
        out = saved[3](*args, **kwargs)
        pending["n_unique"] = int(out[3])
        return out

    def loc(index, rows):
        rlc = isinstance(index, BMoveIndex)
        if not rlc and index.sa_sparseness == 1:
            return saved[0](index, rows)
        kind = "locate.rlc" if rlc else "locate"
        calls.append(dict(kind=kind, index=index, rows=rows.clone(),
                          live=min(pending.pop("total", rows.numel()),
                                   rows.numel()),
                          capacity=rows.numel()))
        return saved[0](index, rows)

    def ver(index, patterns, rid, window_start, kb, **kw):
        calls.append(dict(kind="verify", index=index, reads=patterns.clone(),
                          rid=rid.clone(), ws=window_start.clone(), kb=kb,
                          live=pending.pop("n_unique", rid.numel()),
                          capacity=rid.numel()))
        return saved[1](index, patterns, rid, window_start, kb, **kw)

    def exact(index, patterns, lengths=None):
        kind = "exact" + (".rlc" if isinstance(index, BMoveIndex) else "")
        if lengths is not None:
            kind += "_lengths" if kind.endswith("rlc") else ".lengths"
        calls.append(dict(kind=kind, index=index, pats=patterns.clone(),
                          lengths=None if lengths is None
                          else lengths.clone()))
        return saved[4](index, patterns, lengths)

    def part(index, reads, scheme, kmer_table=None, ranges_out=None):
        calls.append(dict(kind="dynpart" + (".rlc" if isinstance(
            index, BMoveIndex) else ""), index=index, reads=reads.clone(),
            scheme=scheme, table=kmer_table))
        return saved[5](index, reads, scheme, kmer_table, ranges_out)

    def tables(st, pts, reads):
        calls.append(dict(kind="dyn_tables", index=None, st=st,
                          pts=pts.clone(), reads=reads.clone()))
        return saved[6](st, pts, reads)

    locate.locate_rows, verify.verify_window = loc, ver
    pipeline.expand_rows, pipeline.stage_dedup = expand, dedup
    extend.exact_match, dynschedule.dynamic_partition = exact, part
    dynschedule.build_tables = tables
    executor.band_step_compact, executor.exact_loop = band, loop
    try:
        align()
    finally:
        (locate.locate_rows, verify.verify_window, pipeline.expand_rows,
         pipeline.stage_dedup, extend.exact_match,
         dynschedule.dynamic_partition, dynschedule.build_tables,
         executor.band_step_compact, executor.exact_loop) = saved
    return calls + list(widest.values())


def equal(got, want) -> bool:
    """Exact equality of two tensors, or of two dicts of tensors on every
    key."""
    if isinstance(want, dict):
        return set(got) == set(want) and all(
            torch.equal(got[k], want[k]) for k in want)
    return torch.equal(got, want)


def live_tensor(inp: dict) -> torch.Tensor:
    """The live count as the device scalar the path passes."""
    if "live_t" not in inp:
        inp["live_t"] = torch.tensor(inp["live"], dtype=torch.int64,
                                     device=inp["rid"].device)
    return inp["live_t"]


def static_pchars(cells) -> torch.Tensor:
    """A static step's cells as the (R * S * T, BW) int8 array that trees
    before the cells were read at use took (kernel I's seed wrote it):
    the read's char at each position where the code is 0, else the
    code."""
    reads, table = cells
    v = table.transpose(0, 1).long()                       # (S, T, BW)
    pchars = reads[:, v.clamp(min=0)].to(torch.int8)       # (R, S, T, BW)
    pchars = torch.where(v[None] >= 0, pchars, v[None].to(torch.int8))
    return pchars.reshape(-1, v.shape[-1]).contiguous()


def tree_cells(executor, inp: dict):
    """The cells argument of ``inp``'s band step for a tree's executor:
    as captured (in the tree's own ``StaticCells`` where it has one), or
    for a tree whose static entries take a per-lane code array (no
    ``StaticCells``), that array, made once."""
    cells = inp["cells"]
    if isinstance(cells, torch.Tensor):
        return cells
    if hasattr(executor, "StaticCells"):
        return executor.StaticCells(*cells)
    if "pchars" not in inp:
        inp["pchars"] = static_pchars(cells)
    return inp["pchars"]


def band_call(executor, index, inp: dict, who: str):
    """One band step of ``inp`` through ``executor.band_step_compact`` (a
    tree's kernel B, or this tree's ``band_step_compact_plain``) on
    outputs kept in ``inp`` for ``who`` and reused by every call; returns
    the next frontier's live rows, the in-text rows and the counters (a
    ``who`` named "plain..." runs the plain version). The counters add up
    the visits and overflow of every call, so only a ``who``'s first call
    is held to the plain version."""
    state = inp["state"]
    n_live, dev = state[0].shape[0], state[0].device
    key = "bufs_" + who
    if key not in inp:
        inp[key] = (
            [torch.full((inp["cap"], *f.shape[1:]), 3, dtype=f.dtype,
                        device=dev) for f in state],
            torch.full((inp["M"] + 1, 4), -1, dtype=torch.int64, device=dev),
            executor.StepScratch(n_live, dev))
    out, itv, sc = inp[key]
    fn = (executor.band_step_compact_plain if who.startswith("plain")
          else executor.band_step_compact)
    fn(index, state, n_live, out, itv, inp["cnt"], sc, inp["mrow_t"],
       tree_cells(executor, inp), inp["T"], inp["t"], inp["switchpoint"],
       inp["dyn_meta"], inp["track_arg"])
    return dict(ranges=out[0], ids=out[1], band=out[2], colmin=out[3],
                itv=itv[:inp["M"]], ctr=sc.ctr[:3])


def loop_call(executor, index, inp: dict, plain: bool = False,
              stats: dict | None = None):
    """Kernel A's loop (or, ``plain``, ``exact_loop_plain``) on ``inp``."""
    args = (index, inp["ranges"], inp["ids"], inp["t_lo"], inp["t_hi"],
            inp["reads"], inp["tabs"], inp["per_lane"], inp["gate_t"],
            inp["switchpoint"])
    out = (executor.exact_loop_plain(*args, stats=stats) if plain
           else executor.exact_loop(*args))
    return dict(ranges=out[0], drows=out[1])


def equal_band(got: dict, want: dict) -> bool:
    """Two band steps' outputs agree: the counters, then the next
    frontier's live rows (the rows past them are not written) and the
    in-text rows."""
    if not torch.equal(got["ctr"], want["ctr"]):
        return False
    live = int(want["ctr"][0]) & 0xFFFFFFFF
    live = min(live, want["ranges"].shape[0])
    return all(torch.equal(got[k][:live], want[k][:live])
               for k in ("ranges", "ids", "band", "colmin")) and \
        torch.equal(got["itv"], want["itv"])


def kernel_call(kind: str, index, inp: dict):
    """One launch through this tree's wrapper (verify with the live count
    the path passes)."""
    from columba_tpu_torch.ops import extend, locate, verify
    from columba_tpu_torch.search import dynschedule, executor

    if kind in BAND_KINDS:
        return band_call(executor, index, inp, "tree")
    if kind == "extend.loop_rlc":
        return loop_call(executor, index, inp)
    if kind == "verify":
        return verify.verify_window(index, inp["reads"], inp["rid"],
                                    inp["ws"], inp["kb"],
                                    live=live_tensor(inp))
    if kind.startswith("exact"):
        return extend.exact_match(index, inp["pats"], inp["lengths"])
    if kind.startswith("dynpart"):
        return dynschedule.dynamic_partition(index, inp["reads"],
                                             inp["scheme"], inp["table"])
    if kind == "dyn_tables":
        return dynschedule.build_tables(inp["st"], inp["pts"], inp["reads"])
    return locate.locate_rows(index, inp["rows"])


def plain_call(kind: str, index, inp: dict):
    from columba_tpu_torch.ops import blocate, extend, locate, verify
    from columba_tpu_torch.search import dynschedule, executor

    if kind in BAND_KINDS:
        return band_call(executor, index, inp, "plain")
    if kind == "extend.loop_rlc":
        return loop_call(executor, index, inp, plain=True)
    if kind == "verify":
        return verify.verify_window_plain(index, inp["reads"], inp["rid"],
                                          inp["ws"], inp["kb"])
    if kind.startswith("exact"):
        return extend.zero_empty(extend.exact_match_plain(
            index, inp["pats"], inp["lengths"]))
    if kind.startswith("dynpart"):
        return dynschedule.dynamic_partition_plain(
            index, inp["reads"], inp["scheme"], inp["table"])
    if kind == "dyn_tables":
        return dynschedule.build_tables_plain(inp["st"], inp["pts"],
                                              inp["reads"])
    if kind == "locate.rlc":
        return blocate.locate_rows_plain(index, inp["rows"])
    return locate.locate_rows_plain(index, inp["rows"])


def _exact_part_counts(inp: dict, want) -> dict:
    """Kernels E and F: steps and the bound and, on the RLC index, the
    dependent-read rounds a row on the run tables and on the fused rows."""
    from columba_tpu_torch.search import dynschedule
    from columba_tpu_torch.tools import bounds

    index, kind = inp["index"], inp["kind"]
    rlc = kind.endswith("rlc") or kind.endswith("rlc_lengths")
    runs = {}
    for tables in ((True, False) if rlc else (True,)):
        stats = {}
        if kind.startswith("exact"):
            pats = inp["pats"]
            rows = pats.shape[0]
            steps = bounds.exact_steps(index, pats, inp["lengths"], stats,
                                       tables)
        else:
            reads = inp["reads"]
            rows, m = reads.shape
            K, tab, _, _ = dynschedule.partition_setup(inp["scheme"], m,
                                                       inp["table"])
            dynschedule.dynamic_partition_plain(
                index, reads, inp["scheme"], inp["table"], None, stats,
                tables)
            steps = stats.get("steps", 0)
        runs[tables] = (steps, stats)
    steps, stats = runs[True]
    out = dict(steps_per_row=steps / max(rows, 1))
    if kind.startswith("exact"):
        out["bound"] = (bounds.exact_rlc(steps, stats, want) if rlc
                        else bounds.exact(steps, rows, want))
    else:
        p = inp["scheme"].num_parts
        out["bound"] = (
            bounds.dynpart_rlc(reads, p, K, tab is not None, stats, want)
            if rlc else bounds.dynpart(reads, p, K, tab is not None, want))
    if rlc:
        out["rounds_per_row"] = bounds.rlc_rounds(steps, stats, rows)
        out["lane_rounds_per_row"] = bounds.lane_rounds(*runs[False], rows)
        out.update({f"{k}_per_row": v / rows for k, v in stats.items()
                    if k != "steps"})
    return out


def _band_counts(inp: dict) -> dict:
    """Kernel B: kept children and the bound; on the RLC entries also the
    walks of the children written on the run tables (a quad's
    dependent-read rounds a child: its LF-run read where needed and its
    longest walk)."""
    from columba_tpu_torch.index.bmove import BMoveIndex
    from columba_tpu_torch.search import executor
    from columba_tpu_torch.tools import bounds

    index, state = inp["index"], inp["state"]
    o = executor.band_step_plain(index, *state, inp["mrow_t"],
                                 inp["cells"], inp["T"], inp["t"],
                                 inp["switchpoint"], inp["dyn_meta"],
                                 inp["track_arg"])
    stats = (bounds.rlc_band_stats(index, state, inp["mrow_t"], o,
                                   inp["cap"], inp["dyn_meta"], inp["T"],
                                   inp["t"])
             if isinstance(index, BMoveIndex) else None)
    if stats is None:
        return dict(kept=int(o["ch_alive"].sum()),
                    bound=bounds.band_step(state, inp["mrow_t"], o,
                                           inp["cap"], inp["M"], inp["cnt"]))
    kids = max(stats.get("children", 0), 1)
    return dict(kept=int(o["ch_alive"].sum()),
                walked_children=stats.get("children", 0),
                rounds_per_child=stats.get("walk_rounds", 0) / kids,
                **{f"{k}_per_child": v / kids for k, v in stats.items()
                   if k not in ("children", "walk_rounds")},
                bound=bounds.band_step(state, inp["mrow_t"], o, inp["cap"],
                                       inp["M"], inp["cnt"], stats))


def _loop_counts(inp: dict, want: dict) -> dict:
    """Kernel A's RLC loop: extensions and their walks on the run tables
    (dependent-read rounds a lane: a step's rows, then its LF-run read
    where needed and the longest walk) and the bound."""
    from columba_tpu_torch.search import executor
    from columba_tpu_torch.tools import bounds

    index, L = inp["index"], inp["ranges"].shape[0]
    stats: dict = {}
    loop_call(executor, index, inp, plain=True, stats=stats)
    steps = stats.get("steps", 0)
    return dict(steps_per_lane=steps / max(L, 1),
                rounds_per_lane=bounds.rlc_rounds(steps, stats, L),
                bound=bounds.exact_loop(inp["ranges"], inp["ids"],
                                        inp["tabs"], inp["per_lane"], stats,
                                        want["ranges"], want["drows"]))


def hand_counts(inp: dict) -> dict:
    """Loads the plain versions count for one input, and the bound."""
    from columba_tpu_torch.ops import blocate, locate
    from columba_tpu_torch.tools import bounds

    index, kind = inp["index"], inp["kind"]
    if kind in BAND_KINDS:
        return _band_counts(inp)
    if kind == "extend.loop_rlc":
        return _loop_counts(inp, plain_call(kind, index, inp))
    if kind.startswith(("exact", "dynpart")):
        return _exact_part_counts(inp, plain_call(kind, index, inp))
    if kind == "dyn_tables":
        from columba_tpu_torch.search import dynschedule

        phases = dynschedule._static_on(inp["st"], inp["pts"].device)
        return dict(bound=bounds.dyn_tables(
            inp["pts"], inp["reads"], phases["phases"],
            plain_call(kind, index, inp)))
    if kind == "verify":
        b = bounds.verify(inp["reads"], inp["rid"], inp["ws"], inp["kb"],
                          torch.empty((inp["rid"].numel(), 4 * inp["kb"] + 1),
                                      dtype=torch.int32), live=inp["live"])
        return dict(bound=b)
    rows, live = inp["rows"], inp["live"]
    if kind == "locate":
        out, steps = locate.locate_rows_plain(index, rows, return_steps=True)
        return dict(steps_per_row=float(steps.float().mean()),
                    steps_per_live_row=float(steps[:live].float().mean())
                    if live else 0.0,
                    bound=bounds.locate(rows, steps, out))
    stats, lstats = {}, {}
    out = blocate.locate_rows_plain(index, rows, stats)
    blocate.locate_rows_plain(index, rows[:live], lstats)
    N = rows.numel()
    per = {f"{k}_per_row": v / N for k, v in stats.items()}
    per.update({f"{k}_per_live_row": v / max(live, 1)
                for k, v in lstats.items()})
    return dict(**per, distinct_runs_of_live_rows=int(torch.unique(
                    blocate.run_of_rows(index, rows[:live])).numel()),
                bound=bounds.locate_rlc(rows, stats, out))


def describe(inp: dict) -> str:
    if inp["kind"] in BAND_KINDS:
        ranges, _, band, colmin = inp["state"]
        W = colmin.shape[-1] // (2 if inp["track_arg"] else 1)
        return (f"{ranges.shape[0]} lanes x {ranges.shape[1]}, kb "
                f"{(band.shape[-1] - 1) // 2}, W {W}, step {inp['t']} of "
                f"{inp['T']}, cap {inp['cap']}")
    if inp["kind"] == "extend.loop_rlc":
        ranges = inp["ranges"]
        return (f"{ranges.shape[0]} lanes x {ranges.shape[1]}, steps "
                f"{inp['t_lo']}..{inp['t_hi']}"
                + (", per-read tables" if inp["per_lane"] else "")
                + (", second stage" if inp["ids"] is not None else ""))
    if inp["kind"].startswith("exact"):
        B, m = inp["pats"].shape
        lens = inp["lengths"]
        return (f"{B} patterns of {m} chars" if lens is None else
                f"{B} patterns of {int(lens.min())}-{int(lens.max())} chars")
    if inp["kind"].startswith("dynpart"):
        R, m = inp["reads"].shape
        return (f"{R} reads x {m} bp, {inp['scheme'].name} k="
                f"{inp['scheme'].k}, p={inp['scheme'].num_parts}"
                + (", seed table" if inp["table"] is not None else ""))
    if inp["kind"] == "dyn_tables":
        st = inp["st"]
        return (f"{inp['reads'].shape[0]} reads x {st.m} bp, "
                f"{st.num_searches} searches, p={st.p}, T={st.t_max}, "
                f"kb={st.kb}")
    if inp["kind"] == "verify":
        return (f"{inp['rid'].numel()} candidates (live {inp['live']}), m "
                f"{inp['reads'].shape[1]}, kb {inp['kb']}")
    return f"{inp['rows'].numel()} rows (live {inp['live']})"


def time_inputs(label: str, inputs: list, clocks: Clocks, smi: str,
                results: list, parent=None, variants=None) -> None:
    """Checks and times every input on this tree's kernel and, where
    ``parent(kind, inp)`` launches an earlier tree's, on both in turns
    (parent, this tree, this tree, parent). ``variants(kind)``: more
    launchers of this tree's kernel by name (``fn(kind, inp)``), timed
    between the turns of this tree and back (parent, tree, a, b, b, a,
    tree, parent)."""
    for inp in inputs:
        kind, index = inp["kind"], inp["index"]
        want = plain_call(kind, index, inp)
        fns = {"tree": lambda: kernel_call(kind, index, inp)}
        if parent is not None:
            fns["parent"] = lambda: parent(kind, inp)
        more = (variants(kind) if variants is not None else None) or {}
        for who, fn in more.items():
            fns[who] = (lambda fn=fn: fn(kind, inp))
        same = equal_band if kind in BAND_KINDS else equal
        for who, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            if not same(got, want):
                raise AssertionError(f"{label} {kind}: the {who} kernel "
                                     f"differs from the plain version")
        order = ["tree", *more, *reversed(list(more)), "tree"]
        if parent is not None:
            order = ["parent", *order, "parent"]
        runs = {k: [] for k in fns}
        for who in order:
            runs[who].append(clocks.all(fns[who], KERNEL_NAME[kind]))
        hc = hand_counts(inp)
        b = hc.pop("bound")
        rec = dict(label=label, kind=kind, what=describe(inp),
                   kb=inp.get("kb"), live=inp.get("live"),
                   capacity=inp.get("capacity"), bound_ms=b["bound_ms"],
                   bound_by=b["bound_by"], bound_bytes=b["bytes"],
                   bound_operations=b["operations"], **hc, runs=runs)
        results.append(rec)
        for who, rs in runs.items():
            for i, r in enumerate(rs):
                log(f"{smi}: {label} {kind} [{rec['what']}] {who} run {i}: "
                    f"events warm {r['events_warm']:.4f} ms, cold "
                    f"{r['events_cold']:.4f}; profiler warm "
                    f"{_ms(r['prof_warm'])}, cold {_ms(r['prof_cold'])}; "
                    f"bound {b['bound_ms']:.5f} ms by {b['bound_by']}")
        log(f"  hand counts: {hc}")


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


# -- kernels I-L: every entry's first call of a run, and its replay ---------

# an entry's kernel in the profiler's trace
ENTRY_KERNEL = {
    "frontier.seed": "seed_kernel", "frontier.lookup": "seed_kernel",
    "frontier.drain": "drain_kernel", "frontier.init": "init_kernel",
    "frontier.ex_compact": "ex_compact_kernel",
    "frontier.ex_back": "ex_back_kernel", "frontier.tail": "tail_kernel",
    "expand.frontier_tail": "frontier_kernel",
    "expand.ranges": "scan_kernel", "expand.rows": "rows_kernel",
    "dedup.windows": "windows_kernel", "dedup.keys": "keys_kernel",
    "dedup.pass": "pass_kernel", "dedup.compact": "compact_kernel",
}
# the in-text buffer among an entry's arguments, whose last row is
# scratch: the plain version writes its dropped rows there, the kernel
# nothing
ITV_ARG = {"frontier.drain": lambda a: a["itv"],
           "frontier.init": lambda a: a["itv"],
           "frontier.tail": lambda a: a["itv"],
           "expand.frontier_tail": lambda a: a["res"].tail["itv"]}


def entry_table() -> dict:
    """(module, attribute, plain version) of every dispatching function of
    kernels I-L, by the entry it launches."""
    from columba_tpu_torch.index import kmer
    from columba_tpu_torch.search import executor as ex, pipeline as pl

    return {
        "frontier.seed": (ex, "frontier_seed", ex.frontier_seed_plain),
        "frontier.lookup": (kmer, "lookup", kmer.lookup_plain),
        "frontier.drain": (ex, "frontier_drain", ex.frontier_drain_plain),
        "frontier.init": (ex, "frontier_init", ex.frontier_init_plain),
        "frontier.ex_compact": (ex, "frontier_ex_compact",
                                ex.frontier_ex_compact_plain),
        "frontier.ex_back": (ex, "frontier_ex_back",
                             ex.frontier_ex_back_plain),
        "frontier.tail": (ex, "frontier_tail", ex.frontier_tail_plain),
        "expand.frontier_tail": (pl, "stage_tail_candidates",
                                 pl.stage_tail_candidates_plain),
        "expand.ranges": (pl, "expand_scan", pl.expand_scan_plain),
        "expand.rows": (pl, "expand_rows", pl.expand_rows_plain),
        "dedup.windows": (pl, "stage_windows", pl.stage_windows_plain),
        "dedup.keys": (pl, "dedup_keys", pl.dedup_keys_plain),
        "dedup.pass": (pl, "dedup_pass", pl.dedup_pass_plain),
        "dedup.compact": (pl, "dedup_compact", pl.dedup_compact_plain),
    }


def plain_entries():
    """Swap every dispatching function of kernels I-L for its plain version
    (module attributes the library calls through); returns the undo."""
    saved = []
    for mod, attr, plain in entry_table().values():
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, plain)

    def restore():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return restore


def _deep(x, f):
    """``x`` with every tensor replaced by ``f(tensor)``: through lists,
    tuples, dicts and FrontierResults (not through an index)."""
    from columba_tpu_torch.search.executor import FrontierResult

    if isinstance(x, torch.Tensor):
        return f(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):      # NamedTuple
        return type(x)(*(_deep(v, f) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_deep(v, f) for v in x)
    if isinstance(x, dict):
        return {k: _deep(v, f) for k, v in x.items()}
    if isinstance(x, FrontierResult):
        return dataclasses.replace(x, **{
            fl.name: _deep(getattr(x, fl.name), f)
            for fl in dataclasses.fields(x)})
    return x


def copies(x):
    """``x`` with every tensor copied (through what :func:`_deep` walks),
    the same strides (kernel K reads kernel E's ranges in place through
    their row stride), and tensors that share memory sharing it in the
    copy: each storage is copied once and the views are rebuilt on it (a
    deferred tail's result holds views of the run's buffers)."""
    memo: dict = {}

    def one(t):
        st = t.untyped_storage()
        new = memo.get(st.data_ptr())
        if new is None:
            whole = torch.empty(0, dtype=torch.uint8, device=t.device)
            new = memo[st.data_ptr()] = whole.set_(st).clone(
                ).untyped_storage()
        return torch.empty(0, dtype=t.dtype, device=t.device).set_(
            new, t.storage_offset(), t.shape, t.stride())
    return _deep(x, one)


def _tensors(x) -> list:
    out = []
    _deep(x, lambda t: out.append(t) or t)
    return out


def capture_entries(fn) -> dict:
    """Runs ``fn()`` with every dispatching function of kernels I-L
    wrapped, and keeps each entry's first call: its arguments by name
    before the call (copies), after it, and what it returned."""
    import inspect

    table = entry_table()
    calls: dict = {}
    saved = []

    def wrap(name, real):
        sig = inspect.signature(real)

        def spy(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            if name in calls:
                return real(*args, **kwargs)
            before = copies(dict(bound.arguments))
            out = real(*args, **kwargs)
            calls[name] = dict(name=name, real=real, plain=table[name][2],
                              args=before,
                              after=copies(dict(bound.arguments)),
                              out=copies(out))
            return out
        return spy

    for name, (mod, attr, plain) in table.items():
        real = getattr(mod, attr)
        saved.append((mod, attr, real))
        setattr(mod, attr, wrap(name, real))
    try:
        fn()
    finally:
        for mod, attr, real in saved:
            setattr(mod, attr, real)
    return calls


def _max_err(got, want) -> int:
    g, w = _tensors(got), _tensors(want)
    if len(g) != len(w):
        raise AssertionError("different outputs")
    err = 0
    for a, b in zip(g, w):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"shape/dtype {tuple(a.shape)} {a.dtype} "
                                 f"vs {tuple(b.shape)} {b.dtype}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def replay_plain(call: dict) -> int:
    """The captured call again through its plain version on copies of its
    arguments: the max abs difference from the kernel's result and from
    the arguments it left (the in-text buffer's scratch row aside)."""
    args = copies(call["args"])
    out = call["plain"](**args)
    itv = ITV_ARG.get(call["name"])
    if itv is not None:
        itv(args)[-1] = itv(call["after"])[-1]
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return max(_max_err(out, call["out"]), _max_err(args, call["after"]))


def time_entry(call: dict, clocks: Clocks) -> dict:
    """The entry's kernel and its plain version on copies of the captured
    arguments: CUDA events and the profiler's device time of the kernel,
    warm and with the L2 flushed; events of the plain version, warm."""
    kargs = copies(call["args"])
    pargs = copies(call["args"])
    t = clocks.all(lambda: call["real"](**kargs), ENTRY_KERNEL[call["name"]])
    t["plain_ms"] = clocks.events(lambda: call["plain"](**pargs), False)
    return t


def library(call: dict):
    """One PyTorch call that computes the same function as the entry on
    its captured inputs, as a function of no arguments, or None where no
    call does: kernel K's ``ranges`` (the clamped widths' prefix sums:
    ``torch.cumsum`` on the widths) and ``rows`` (each row's candidate:
    ``torch.searchsorted`` of the rows in the prefix sums, right). The
    port calls neither; they are yardsticks."""
    a = call["args"]
    if call["name"] == "expand.ranges":
        w = torch.clamp(a["c_hi"] - a["c_lo"], min=0).clamp(
            max=a["max_locate"] + 1)
        return lambda: torch.cumsum(w, 0)
    if call["name"] == "expand.rows":
        off = a["offsets"]
        j = torch.arange(a["max_locate"], dtype=off.dtype, device=off.device)
        return lambda: torch.searchsorted(off, j, right=True)
    return None


def frontier_widths_cumsum(call: dict):
    """``torch.cumsum`` of the candidates' clamped widths, the scan part of
    kernel K's fused ``frontier`` entry (a yardstick of that part, not of
    the entry: no one call makes the candidate list)."""
    c_lo, c_hi = call["out"][0], call["out"][1]
    w = torch.clamp(c_hi - c_lo, min=0).clamp(
        max=call["args"]["max_locate"] + 1)
    return lambda: torch.cumsum(w, 0)


def sort_ms(call: dict, clocks: Clocks) -> float:
    """The library's sort (``torch.sort``, stable) of every row's key of a
    captured ``dedup.keys`` call, invalid rows last (rid 2^30, window
    2^32 - 1: ``pipeline.stage_dedup_plain``'s keys), by the profiler's
    device time (its launches and memsets): kernel L's yardstick, as the
    port ran it before kernel L sorted on the card."""
    a = call["args"]
    key = torch.where(a["valid"], (a["rid"] << 32)
                      | (a["win_start"] & 0xFFFFFFFF), (1 << 62) | 0xFFFFFFFF)
    return clocks.device_ms(lambda: torch.sort(key, stable=True))


# the record_function scopes that launch_census books device work to
SCOPE_WORD, SCOPE_SORT = "census.step_word", "census.sort"


def _device_events(fn, scopes=()) -> tuple[dict, dict, dict, dict]:
    """What the card ran in one profiled ``fn()``: kernel launches, memsets
    and copies, counted by name (``torch.profiler``), their device ms by
    name, and how many of them were issued inside each ``record_function``
    scope named in ``scopes`` and their device ms (the profiler links each
    device event to the op that issued it; the scope is that op or one of
    its parents). The scopes' own spans on the device timeline are not
    counted."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    ms: dict = {}
    within = dict.fromkeys(scopes, 0)
    within_ms = dict.fromkeys(scopes, 0.0)
    for ev in prof.events():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            if ev.name not in within:
                by_name[ev.name] = by_name.get(ev.name, 0) + 1
                ms[ev.name] = ms.get(ev.name, 0.0) + (
                    ev.time_range.end - ev.time_range.start) / 1000.0
        elif ev.kernels:
            up = ev
            while up is not None and up.name not in within:
                up = up.cpu_parent
            if up is not None:
                within[up.name] += len(ev.kernels)
                within_ms[up.name] += sum(k.duration
                                          for k in ev.kernels) / 1000.0
    return by_name, ms, within, within_ms


def launch_census(fn, ex=None) -> dict:
    """What the card ran in one ``fn()`` (a ``match_device_core`` or
    ``run_scheme`` call) outside kernel B's band steps and the sort, from
    ``torch.profiler``. ``fn`` runs once unprofiled first. Kernel B's
    launches are counted by name; the copies of its step words and the
    sort's launches and memsets by their own record: during the profiled
    call ``ex.StepScratch.word`` (``ex``: the tree's executor module, this
    tree's by default) and ``torch.sort`` run inside scopes of their own,
    and every device event issued inside one is booked to it. Each step
    word is one copy, so the word scope must hold one event a call. Returns
    {"by_name": every launch, memset and copy of the call by name, "band":
    kernel B's launches and its word copies, "sort", "outside", "total",
    "ms_by_name": their device ms by name, "band_ms": kernel B's launches'
    device ms, "sort_ms": the library sort's device ms, "ms": the call's
    device ms in all}. Kernel L's own sort (its keys and passes, since it
    replaced ``torch.sort``) counts among the launches outside."""
    from torch.profiler import record_function

    if ex is None:
        from columba_tpu_torch.search import executor as ex
    word, sort = ex.StepScratch.word, torch.sort
    calls = dict.fromkeys((SCOPE_WORD, SCOPE_SORT), 0)

    def scoped(name, real):
        def run(*args, **kwargs):
            calls[name] += 1
            with record_function(name):
                return real(*args, **kwargs)
        return run

    fn()
    ex.StepScratch.word = scoped(SCOPE_WORD, word)
    torch.sort = scoped(SCOPE_SORT, sort)
    try:
        by_name, ms, within, within_ms = _device_events(fn, calls)
    finally:
        ex.StepScratch.word, torch.sort = word, sort
    if within[SCOPE_WORD] != calls[SCOPE_WORD] or (
            calls[SCOPE_SORT] and not within[SCOPE_SORT]):
        raise RuntimeError(f"the profiler booked {within} to {calls} calls")
    steps = sum(n for k, n in by_name.items() if "band_step" in k)
    band = steps + within[SCOPE_WORD]
    sort = within[SCOPE_SORT]
    total = sum(by_name.values())
    return dict(by_name=by_name, band=band, sort=sort,
                outside=total - band - sort, total=total, ms_by_name=ms,
                band_ms=sum(t for k, t in ms.items() if "band_step" in k),
                sort_ms=within_ms[SCOPE_SORT], ms=sum(ms.values()))
