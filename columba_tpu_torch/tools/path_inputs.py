"""Kernels C, D, E and F on the inputs an align gives them: capture and
timing.

``capture(align)`` runs one ``align()`` with wrappers around
``locate.locate_rows``, ``verify.verify_window``, ``extend.exact_match``,
``dynschedule.dynamic_partition``, ``pipeline.stage_expand`` and
``pipeline.stage_dedup`` (module attributes; nothing in the library is
hooked) and keeps each locate, verify, exact-match and partition launch's
inputs, with the live counts beside the capacity (``total`` of the
expansion, ``n_unique`` of the dedup) for C and D. ``time_inputs`` holds
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

import torch

FLUSH_BYTES = 64 << 20     # above the 50 MB L2
# a part of the kernel's name in the profiler's trace, in every tree
KERNEL_NAME = {"verify": "verify", "locate": "locate_kernel",
               "locate.rlc": "locate_rlc", "exact": "exact_",
               "exact.lengths": "exact_", "exact.rlc": "exact_",
               "exact.rlc_lengths": "exact_", "dynpart": "dynpart_kernel",
               "dynpart.rlc": "dynpart_kernel"}


def log(msg: str) -> None:
    print(msg, flush=True)


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

    def profiled(self, fn, name: str, cold: bool):
        """Mean device ms a launch of the kernels whose name holds ``name``,
        from ``torch.profiler``; None if it records no device time."""
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
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if name in ev.key:
                t = getattr(ev, "device_time_total", None)
                if t is None:
                    t = getattr(ev, "cuda_time_total", 0.0)
                total += t
                count += ev.count
        if count == 0:
            return None
        return total / 1000.0 / count      # per launch the trace recorded

    def all(self, fn, name: str) -> dict:
        return dict(events_warm=self.events(fn, False),
                    events_cold=self.events(fn, True),
                    prof_warm=self.profiled(fn, name, False),
                    prof_cold=self.profiled(fn, name, True))


def capture(align) -> list:
    """The locate, verify, exact-match and partition launches of one
    ``align()`` call, each with its inputs (cloned) and, for locate and
    verify, the live counts around it."""
    from columba_tpu_torch.index.bmove import BMoveIndex
    from columba_tpu_torch.ops import extend, locate, verify
    from columba_tpu_torch.search import dynschedule, pipeline

    calls, pending = [], {}
    saved = (locate.locate_rows, verify.verify_window, pipeline.stage_expand,
             pipeline.stage_dedup, extend.exact_match,
             dynschedule.dynamic_partition)

    def expand(c_lo, c_hi, max_locate):
        out = saved[2](c_lo, c_hi, max_locate)
        pending["total"] = int(out[3])
        return out

    def dedup(rid, win_start, valid, max_verify):
        out = saved[3](rid, win_start, valid, max_verify)
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

    locate.locate_rows, verify.verify_window = loc, ver
    pipeline.stage_expand, pipeline.stage_dedup = expand, dedup
    extend.exact_match, dynschedule.dynamic_partition = exact, part
    try:
        align()
    finally:
        (locate.locate_rows, verify.verify_window, pipeline.stage_expand,
         pipeline.stage_dedup, extend.exact_match,
         dynschedule.dynamic_partition) = saved
    return calls


def live_tensor(inp: dict) -> torch.Tensor:
    """The live count as the device scalar the path passes."""
    if "live_t" not in inp:
        inp["live_t"] = torch.tensor(inp["live"], dtype=torch.int64,
                                     device=inp["rid"].device)
    return inp["live_t"]


def kernel_call(kind: str, index, inp: dict):
    """One launch through this tree's wrapper (verify with the live count
    the path passes)."""
    from columba_tpu_torch.ops import extend, locate, verify
    from columba_tpu_torch.search import dynschedule

    if kind == "verify":
        return verify.verify_window(index, inp["reads"], inp["rid"],
                                    inp["ws"], inp["kb"],
                                    live=live_tensor(inp))
    if kind.startswith("exact"):
        return extend.exact_match(index, inp["pats"], inp["lengths"])
    if kind.startswith("dynpart"):
        return dynschedule.dynamic_partition(index, inp["reads"],
                                             inp["scheme"], inp["table"])
    return locate.locate_rows(index, inp["rows"])


def plain_call(kind: str, index, inp: dict):
    from columba_tpu_torch.ops import blocate, extend, locate, verify
    from columba_tpu_torch.search import dynschedule

    if kind == "verify":
        return verify.verify_window_plain(index, inp["reads"], inp["rid"],
                                          inp["ws"], inp["kb"])
    if kind.startswith("exact"):
        return extend.zero_empty(extend.exact_match_plain(
            index, inp["pats"], inp["lengths"]))
    if kind.startswith("dynpart"):
        return dynschedule.dynamic_partition_plain(
            index, inp["reads"], inp["scheme"], inp["table"])
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


def hand_counts(inp: dict) -> dict:
    """Loads the plain versions count for one input, and the bound."""
    from columba_tpu_torch.ops import blocate, locate
    from columba_tpu_torch.tools import bounds

    index, kind = inp["index"], inp["kind"]
    if kind.startswith(("exact", "dynpart")):
        return _exact_part_counts(inp, plain_call(kind, index, inp))
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
    if inp["kind"] == "verify":
        return (f"{inp['rid'].numel()} candidates (live {inp['live']}), m "
                f"{inp['reads'].shape[1]}, kb {inp['kb']}")
    return f"{inp['rows'].numel()} rows (live {inp['live']})"


def time_inputs(label: str, inputs: list, clocks: Clocks, smi: str,
                results: list, parent=None) -> None:
    """Checks and times every input on this tree's kernel and, where
    ``parent(kind, inp)`` launches an earlier tree's, on both in turns
    (parent, this tree, this tree, parent)."""
    for inp in inputs:
        kind, index = inp["kind"], inp["index"]
        want = plain_call(kind, index, inp)
        fns = {"tree": lambda: kernel_call(kind, index, inp)}
        if parent is not None:
            fns["parent"] = lambda: parent(kind, inp)
        for who, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{label} {kind}: the {who} kernel "
                                     f"differs from the plain version")
        order = (["parent", "tree", "tree", "parent"] if parent is not None
                 else ["tree", "tree"])
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
