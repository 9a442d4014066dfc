"""Kernels A (its RLC loop, ``extend.loop_rlc``), B (its RLC entries:
``band_step.rlc``, ``band_step.per_lane_rlc``, ``band_step.textless``), C
(locate, both entries), D (verify), E (exact match: Vanilla, RLC, RLC with
lengths), F (dynamic partition, both entries), G (the dynamic-partition
tables) and H (the row gather) on the inputs the paths give them, on one
CUDA device.

Run from the repository root on a machine with a CUDA device:

    python -m columba_tpu_torch.tools.kernel_bench [--out DIR]
        [--parent TREE] [--reps N] [--only KINDS]

It times kernel H first, on the gather bench's 2,000,000-row table at
8,192, 49,152 and 262,144 lanes and 64, 32 and 16 B rows, beside
``torch.index_select``, each launch on the next of 16 index sets. Then it
builds the smoke's two workloads (``tools/workload.py``: the random
128 Mbp genome with its Vanilla index at SA sparseness 4, and the 128 Mbp
pan-genome of 20 haplotypes with its ``--rlc`` index and, where kernel A
or B is timed, its ``--rlc --textless`` index, built at once), and:

1. captures the paths' own inputs (``tools/path_inputs.py``): one ``cli
   align`` batch (16,384 reads or pairs) of ``se_all`` (``-a all -e 2``),
   ``pe_best`` (``-a best -F``), ``se_all_dynamic`` (``-a all -e 2 -p
   dynamic``: kernel G's tables), ``rlc_se_all`` (``-a all -e 2 -nD``),
   ``rlc_se_all_dynamic`` (the same with ``-p dynamic``: kernel F's RLC
   entry and kernel G), ``rlc_pe_best`` (``-a best -F``, pairs of 250-450
   bp fragments: its exact rung is kernel E's RLC entry),
   ``rlc_se_best_d`` (``-a best -d`` with kuch1 and its mirror per k: the
   selection probe, kernel E's RLC entry with lengths) and ``tl_se_all``
   (``-a all -e 2 -nD`` on the textless index); each launch keeps its
   inputs, and C and D's the live counts beside the capacity; of kernel
   B's RLC entries and kernel A's ``loop_rlc`` the launch with the most
   lanes on each path;
2. makes the smoke's synthetic inputs beside them: uniformly random SA
   rows, and candidates near random loci with random read ids, at kb 0,
   2, 4, 5, 7 and 13; 32,768 rows x 100 bp (a batch of 16,384 reads, both
   strands) for E, F and G (F: kuch1 k = 2, with the 10-mer seed table on
   the Vanilla index, single-character seeds on RLC; G: the tables of F's
   boundaries at k = 2 and 4) and their 163,840 part patterns of scheme
   selection for E with lengths; and the RLC smoke's band steps and
   exact prefixes (``chip_smoke.py`` ``rlc_kernel_checks`` /
   ``rlc_select_checks``: C = 12,288 lanes x 8 at kb 2, 49,152 x 12 on
   the textless index, the per-lane entry on kernel G's tables of F's
   boundaries; kernel A's loop over R x S lanes from the full range, 8 and
   12 wide, and on those per-read tables);
3. times every kernel entry on every input through its wrapper, by CUDA
   events and by ``torch.profiler``'s device time, warm and with a
   flushed L2, and prints the plain versions' counts (E and F on RLC:
   dependent-read rounds a row) and ``tools/bounds.py``'s bound beside
   each time;
4. times kernel E on one row that matches all its 100 chars against one
   that stops at its first: the difference over 99 is the latency of one
   step's chain of dependent reads, and that times a batch's longest row
   is the batch's latency floor;
5. times every entry of kernels I-L (the frontier around kernels A and B,
   the candidates' expansion, the dedup) on one ``match_device_core``
   call at the SE ALL path's sizes (and the band-only call and the k = 0
   pass beside it), by events and the profiler, warm and cold, beside the
   plain chain, the one PyTorch call of the same function where there is
   one (kernel K's ``ranges``: ``torch.cumsum`` of the clamped widths;
   ``rows``: ``torch.searchsorted``), the library sort (``torch.sort`` of
   every row's key, the profiler's device time) beside kernel L and the
   bound; with ``--parent`` the earlier tree's entries, captured from the
   same calls through its own pipeline, in turns with this tree's; and
   counts the call's launches outside kernel B's band steps, an earlier
   tree's ``torch.sort`` booked apart (``torch.profiler``), on both trees
   with ``--parent``. ``--only
   frontier,expand,dedup`` times these alone (about two minutes with the
   Vanilla build); ``--only frontier,expand,band_step`` adds kernel B's
   static Vanilla entry (a synthetic step at SE ALL's shape and the
   captured paths' widest steps) and its RLC entries;
6. with ``--only columba150`` alone: kernel B's static Vanilla entry at the
   columba scheme's radii on 150 bp reads (``columba_inputs``: the widest
   step at each radius of one ``-a best -S columba`` batch, and C = 12,288
   lanes at kb 5, 6, 7 and 13), each step through the instance its launch
   picks and through the generic entry (``executor.BAND_GENERIC``) in
   turns: tree, generic, generic, tree;
7. with ``--only columba250`` alone: kernel B's quad body
   (``csrc/band_step_wide.cuh``) on 250 bp reads (``columba250_inputs``):
   the widest static step at kb 9 and 12 of one ``-a best -S columba``
   batch (``chip_smoke.py``'s ``col250_se_best`` reads) and the widest
   steps of its ``-p dynamic`` twin (per-lane at kb 9, static at kb 12),
   C = 12,288 lanes at kb 8-13 on the columba scheme's step tables at 250
   and 270 bp (static entry) and at kb 8-10 on kernel G's tables of 250 bp
   reads (per-lane entry), each through the quad body and the forced
   generic entry in turns, with the plain version: tree, generic, plain,
   plain, generic, tree, and with ``--parent`` the earlier tree's kernel
   around them (about 13 minutes with the build, much of it the host
   loading the columba scheme at k = 11-13 and the plain versions);
8. with ``--only default_run`` alone: the reference's default run (BEST,
   ``-S columba``, 150 bp, with and without ``-p dynamic``) on both
   workloads (``default_run``): kernel A's table entry against the
   K-launch build it replaced, and kernel B's kb 5-7 instances of its
   per-lane, RLC, per-lane RLC and textless entries against the generic
   entry and the plain version in turns, on the paths' widest steps and at
   C = 12,288 (about ten minutes with both builds).

With ``--parent TREE`` (an earlier commit's ``columba_tpu_torch/``,
unpacked by ``git archive COMMIT columba_tpu_torch | tar -x -C TREE``) it
also imports that tree's own ``ops/locate.py``, ``ops/verify.py``,
``ops/extend.py``, ``search/dynschedule.py``, ``search/executor.py`` and
``tools/gather_bench.py`` and times their kernels on the same inputs
through those wrappers, in
turns: parent, this tree, this tree, parent. Each is checked against the
plain version first. ``--only dyn_tables,gather`` times those kinds alone
(an align path is still captured where its inputs are needed). The card's
name and power limit head the output; ``--out`` gets the JSON of every
number. It needs no JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import inspect
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from columba_tpu_torch.tools.path_inputs import (
    BAND_KINDS, Clocks, band_args, band_call, band_input, capture,
    capture_entries, describe, launch_census, live_tensor, log, loop_call,
    random_band_args, replay_plain, rlc_lane_states, sort_ms, time_entry,
    time_inputs,
)

SEED = 20260817
BATCH = 16384
READ_LEN = 100
K = 2
BEST_CUT = 4             # BEST cutoff of kuch1 at 100 bp (the smoke's)
SYNTH_KB = (0, 2, 4, 5, 7, 13)
# kernel B at the columba scheme's radii on 150 bp reads (--only columba150)
COL_LEN = 150
COL_RUN_READS = 16       # reads at each run of N, with COL_RUN_ERR
COL_RUN_ERR = 0.03       # substitutions: most reach the ladder's rung 5
COL_C = 12_288           # lanes of the synthetic steps
COL_KB = (5, 6, 7)       # the columba scheme at 150 bp: W 2
COL_WIDE = (13, 4, 14)   # kb, W and searches of columba k = 13 at 150 bp
COL_PAN_HARD = 1024      # --only default_run: pan-genome reads at 3 %
COL_TABLE_READS = 4096   # reads whose kernel G tables feed the synthetic
                         # per-lane steps (8,192 rows)
# kernel B's quad body on 250 bp reads (--only columba250): the reads of
# chip_smoke.py's col250 paths
COL250_LEN = 250
COL250_HARD = 1024       # the first reads, at COL250_ERR substitutions
COL250_RUN_READS = 8     # of those, at each run of N
COL250_ERR = 0.04
COL250_KB = (8, 9, 10, 11, 12, 13)
COL250_LENS = (250, 270)  # the step tables of the synthetic static steps
COL250_LANE_KB = (8, 9, 10)  # per-read schedules at 250 bp (k + 1 parts of
                             # 2k + 1 at least: kb <= 10)
PKG = "columba_tpu_torch"
TREE_MODULES = ("native", "ops.locate", "ops.verify", "ops.extend",
                "search.dynschedule", "search.executor", "index.bmove",
                "index.fmindex", "tools.gather_bench", "search.pipeline",
                "tools.path_inputs", "tools.bounds")
GATHER_SETS = 16         # index sets a gather timing cycles through


# -- an earlier tree's kernels, through its own wrappers ----------------------

_SCOPES: dict = {}       # a tree's root -> its modules, kept between scopes


@contextlib.contextmanager
def tree_scope(root: str):
    """``sys.modules`` and ``sys.path`` as the tree at ``root`` has them,
    inside: every import, a lazy one inside a call included, takes that
    tree's module. This tree's modules are set aside and put back after.
    An earlier tree needs it: its ``run_scheme`` imports ``index.kmer``
    inside the call, which would otherwise be this tree's module and
    launch this tree's kernel I."""
    theirs = _SCOPES.setdefault(root, {})
    mine = {k: v for k, v in sys.modules.items()
            if k == PKG or k.startswith(PKG + ".")}
    for k in mine:
        del sys.modules[k]
    sys.modules.update(theirs)
    sys.path.insert(0, root)
    try:
        yield
    finally:
        sys.path.remove(root)
        for k in [k for k in sys.modules
                  if k == PKG or k.startswith(PKG + ".")]:
            theirs[k] = sys.modules.pop(k)
        sys.modules.update(mine)


def load_tree(tree: str) -> dict:
    """The tree's own ``native``, kernel wrappers and index classes,
    imported in :func:`tree_scope`, so each tree's wrappers call their own
    C entries with their own arguments; the tree's kernels build into its
    own ``_build``."""
    root = os.path.abspath(tree)
    with tree_scope(root):
        mods = {m: importlib.import_module(f"{PKG}.{m}")
                for m in TREE_MODULES}
    for m in mods.values():
        if not os.path.abspath(m.__file__).startswith(root + os.sep):
            raise RuntimeError(f"{m.__name__} did not load from {tree}")
    return mods


def tree_launcher(mods: dict):
    """``launch(kind, inp)``: one launch of the tree's kernel through its
    wrapper, on a copy of the input's index in the tree's own index class
    (the same device tensors), with the live count where its
    ``verify_window`` takes one."""
    from columba_tpu_torch.index.bmove import BMoveIndex

    takes_live = "live" in inspect.signature(
        mods["ops.verify"].verify_window).parameters
    copies = {}

    def index_of(index):
        if id(index) not in copies:
            cls = (mods["index.bmove"].BMoveIndex
                   if isinstance(index, BMoveIndex)
                   else mods["index.fmindex"].FMIndex)
            copies[id(index)] = (index, cls(**{
                f.name: getattr(index, f.name)
                for f in dataclasses.fields(cls) if f.init}))
        return copies[id(index)][1]

    def launch(kind: str, inp: dict):
        if kind in BAND_KINDS:
            return band_call(mods["search.executor"],
                             index_of(inp["index"]), inp, "parent")
        if kind == "extend.loop_rlc":
            return loop_call(mods["search.executor"],
                             index_of(inp["index"]), inp)
        if kind == "dyn_tables":
            return mods["search.dynschedule"].build_tables(
                inp["st"], inp["pts"], inp["reads"])
        index = index_of(inp["index"])
        if kind == "verify":
            kw = {"live": live_tensor(inp)} if takes_live else {}
            return mods["ops.verify"].verify_window(
                index, inp["reads"], inp["rid"], inp["ws"], inp["kb"], **kw)
        if kind.startswith("exact"):
            return mods["ops.extend"].exact_match(index, inp["pats"],
                                                  inp["lengths"])
        if kind.startswith("dynpart"):
            return mods["search.dynschedule"].dynamic_partition(
                index, inp["reads"], inp["scheme"], inp["table"])
        return mods["ops.locate"].locate_rows(index, inp["rows"])

    return launch


def synthetic(index, text: np.ndarray, rng, R: int, kinds) -> list:
    """The smoke's synthetic inputs: max(65,536, 4R) random SA rows and as
    many candidates near random loci with random read ids."""
    dev = torch.device("cuda")
    ml = max(1 << 16, 4 * R)
    out = []
    for kind in kinds:
        if kind != "verify":
            rows = torch.from_numpy(rng.integers(0, index.n + 1, ml)).to(dev)
            out.append(dict(kind=kind, index=index, rows=rows, live=ml,
                            capacity=ml))
            continue
        true_pos = rng.integers(0, index.n - READ_LEN, R)
        pats = torch.from_numpy(np.ascontiguousarray(
            text[true_pos[:, None] + np.arange(READ_LEN)])).to(dev)
        rid_np = rng.integers(0, R, ml)
        for kb in SYNTH_KB:
            ws = torch.from_numpy(true_pos[rid_np] - kb
                                  + rng.integers(-2, 3, ml)).to(dev)
            out.append(dict(kind="verify", index=index, reads=pats,
                            rid=torch.from_numpy(rid_np).to(dev), ws=ws,
                            kb=kb, live=ml, capacity=ml))
    return out


def exact_part_inputs(index, batch: torch.Tensor, table) -> list:
    """Synthetic inputs of kernels E and F at the smoke's shapes: the exact
    match of the batch's rows, the partition of its reads (kuch1 k = 2)
    and, with lengths, its R x 5 part patterns of scheme selection at the
    BEST cutoff (kuch1 k = 4, uniform parts, padded with 5)."""
    from columba_tpu_torch.index.bmove import BMoveIndex
    from columba_tpu_torch.search import schedule
    from columba_tpu_torch.search.scheme import get_scheme

    rlc = ".rlc" if isinstance(index, BMoveIndex) else ""
    R = batch.shape[0]
    p = get_scheme("kuch1", BEST_CUT).num_parts
    cuts = schedule.uniform_partition(READ_LEN, p)
    lens = np.diff(cuts)
    pos = np.full((p, lens.max()), -1, np.int64)
    for i in range(p):
        pos[i, :lens[i]] = np.arange(cuts[i], cuts[i + 1])
    pos = torch.from_numpy(pos).to(batch.device)
    pats = torch.where((pos >= 0)[None], batch[:, pos.clamp(min=0)], 5)
    lengths = torch.from_numpy(lens.astype(np.int32)).to(
        batch.device).repeat(R)
    return [dict(kind="exact" + rlc, index=index, pats=batch, lengths=None),
            dict(kind="dynpart" + rlc, index=index, reads=batch,
                 scheme=get_scheme("kuch1", K), table=table),
            dict(kind="exact.rlc_lengths" if rlc else "exact.lengths",
                 index=index, pats=pats.reshape(R * p, -1).contiguous(),
                 lengths=lengths)]


def vanilla_band_input(index, batch: torch.Tensor, table) -> dict:
    """Kernel B's static Vanilla entry at the SE ALL path's shape: C = R x
    S / 8 lanes (12,288 at 32,768 rows) from the batch's live 10-mer seed
    ranges, kb 2, W 2, the schedule's own step tables and the batch's
    cells read at use, switchpoint 4 (``path_inputs.band_args``)."""
    from columba_tpu_torch.index.kmer import lookup
    from columba_tpu_torch.search import pipeline
    from columba_tpu_torch.search.scheme import get_scheme

    sched = pipeline.compile_cached(get_scheme("kuch1", K), READ_LEN, "edit",
                                    kmer_k=10)
    seeds = lookup(table, batch[:, 20:30])
    seeds = seeds[seeds[:, 1] > seeds[:, 0]]
    return band_input("band_step", band_args(
        index, sched, batch, seeds, np.random.default_rng(SEED + 5), 4))


def band_loop_inputs(bm, tl, batch: torch.Tensor, rng) -> list:
    """Synthetic inputs of kernel B's RLC entries and kernel A's RLC loop
    at the RLC smoke's shapes, the batch's R rows (both strands) under
    kuch1 k = 2: a band step of C = R x S / 8 valid lanes x 8 with the
    crossover, one of R x S / 2 lanes x 12 on the textless index (2W
    colMin slots), the per-lane entry on 12,288 lanes with kernel G's
    tables of kernel F's boundaries (kb 2, step T - m / 3); kernel A's
    loop over the R x S lanes from the full range, 8 wide with the
    crossover and 12 wide without, and on those per-read tables."""
    from columba_tpu_torch.search import dynschedule, executor, pipeline
    from columba_tpu_torch.search.scheme import get_scheme

    dev = batch.device
    R = batch.shape[0]
    sched = pipeline.compile_cached(get_scheme("kuch1", K), READ_LEN, "edit")
    S = sched.num_searches
    L = R * S
    states = rlc_lane_states(bm, batch, rng, max(1024, L // 8))
    out = [band_input("band_step.rlc",
                      band_args(bm, sched, batch, states, rng, 4))]
    C = max(1024, L // 2)
    tb = list(band_args(tl, sched, batch, rlc_lane_states(tl, batch, rng, C),
                        rng, 0, div=2))
    tb[4] = torch.from_numpy(rng.integers(0, 3, (C, 2, 2 * sched.W)).astype(
        np.int8)).to(dev)
    out.append(band_input("band_step.textless", tb, track=True))
    tables = executor.device_tables(sched, dev)
    tabs = (tables["ex_pos"], tables["ex_dir"], tables["db_ex"])
    for index, sp in ((bm, 4), (tl, 0)):
        out.append(dict(kind="extend.loop_rlc", index=index,
                        ranges=index.full_range((L,)), ids=None, t_lo=0,
                        t_hi=sched.e_max, reads=batch, tabs=tabs,
                        per_lane=False, gate_t=19, switchpoint=sp))
    scheme = get_scheme("kuch1", K)
    st = dynschedule.scheme_static(scheme, READ_LEN, "edit")
    dyn = dynschedule.build_tables(
        st, dynschedule.dynamic_partition(bm, batch, scheme), batch)
    Sk, T, bw = st.num_searches, st.t_max, 2 * st.kb + 1
    C = min(12_288, states.shape[0])
    lanes = (bm, states[:C].contiguous(),
             torch.from_numpy(rng.integers(0, R * Sk, C).astype(
                 np.int32)).to(dev),
             torch.from_numpy(rng.integers(0, 4, (C, 2, bw)).astype(
                 np.int8)).to(dev),
             torch.from_numpy(rng.integers(0, 3, (C, 2, 1)).astype(
                 np.int8)).to(dev),
             None, dyn["pchars"], T, T - READ_LEN // 3, 4)
    out.append(band_input("band_step.per_lane_rlc", lanes,
                          dyn_meta=dyn["meta"].reshape(-1)))
    out.append(dict(kind="extend.loop_rlc", index=bm,
                    ranges=bm.full_range((R * Sk,)), ids=None, t_lo=0,
                    t_hi=dyn["ex_pos"].shape[1], reads=batch,
                    tabs=(dyn["ex_pos"], dyn["ex_dir"], dyn["db_ex_steps"]),
                    per_lane=True, gate_t=19, switchpoint=4))
    return out


def tables_inputs(index, batch: torch.Tensor, table) -> list:
    """Kernel G at the smoke's shapes: the tables of kernel F's boundaries
    of the batch's rows, for kuch1 at k = 2 (3 searches, T = 104) and at
    the BEST cutoff 4 (kb 4)."""
    from columba_tpu_torch.search import dynschedule
    from columba_tpu_torch.search.scheme import get_scheme

    out = []
    for k in (K, BEST_CUT):
        sc = get_scheme("kuch1", k)
        out.append(dict(kind="dyn_tables", index=None,
                        st=dynschedule.scheme_static(sc, READ_LEN, "edit"),
                        pts=dynschedule.dynamic_partition(index, batch, sc,
                                                          table),
                        reads=batch))
    return out


def time_gather(clocks: Clocks, smi: str, results: list,
                parent=None) -> None:
    """Kernel H on the gather bench's table (2,000,000 rows) at its three
    lane counts and three row widths, beside ``torch.index_select`` and,
    where ``parent`` is an earlier tree's ``gather_rows``, that kernel, in
    turns (parent, this tree, index_select, index_select, this tree,
    parent). Each timing cycles through GATHER_SETS index sets, so that a
    launch finds few of its rows in the L2 (16 x 262,144 x 64 B = 268 MB);
    cold, the L2 is flushed before each launch as well."""
    from columba_tpu_torch.tools import bounds, gather_bench

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 5)
    full = torch.from_numpy(rng.integers(
        0, 2 ** 31, (gather_bench.ROWS, 16)).astype(np.int32)).to(dev)
    impls = {"tree": gather_bench.gather_rows,
             "index_select": lambda t, i: torch.index_select(t, 0, i)}
    names = {"tree": "gather_kernel", "parent": "gather_kernel",
             # torch's kernel for index_select on a contiguous table
             "index_select": ("vectorized_gather", "indexSelect")}
    order = ["tree", "index_select", "index_select", "tree"]
    if parent is not None:
        impls["parent"] = parent
        order = ["parent"] + order + ["parent"]
    for words in gather_bench.ROW_WORDS:
        table = full[:, :words].contiguous()
        for n in gather_bench.LANES:
            sets = [torch.from_numpy(rng.integers(
                0, gather_bench.ROWS, n)).to(dev)
                for _ in range(GATHER_SETS)]
            want = gather_bench.gather_rows_plain(table, sets[0])
            for who, fn in impls.items():
                got = fn(table, sets[0])
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"gather {who} differs from "
                                         f"table[idx] at {words * 4} B "
                                         f"rows, {n} lanes")

            def cycling(fn):
                state = [0]

                def call():
                    state[0] += 1
                    return fn(table, sets[state[0] % GATHER_SETS])
                return call

            runs = {k: [] for k in impls}
            for who in order:
                runs[who].append(clocks.all(cycling(impls[who]), names[who]))
            b = bounds.gather(table, sets[0], want)
            what = f"{n} lanes, {words * 4} B rows of {gather_bench.ROWS}"
            results.append(dict(label="gather_bench", kind="gather",
                                what=what, bound_ms=b["bound_ms"],
                                bound_by=b["bound_by"],
                                bound_bytes=b["bytes"],
                                bound_operations=b["operations"],
                                runs=runs))
            for who, rs in runs.items():
                for i, r in enumerate(rs):
                    log(f"{smi}: gather [{what}] {who} run {i}: events warm "
                        f"{r['events_warm']:.4f} ms, cold "
                        f"{r['events_cold']:.4f}; profiler warm "
                        f"{_fmt(r['prof_warm'])}, cold "
                        f"{_fmt(r['prof_cold'])}; bound "
                        f"{b['bound_ms']:.5f} ms by {b['bound_by']}")
            del sets, want


def chain_floor(label: str, index, text: np.ndarray, clocks: Clocks,
                smi: str, results: list, parent=None) -> None:
    """Kernel E's latency floor: one row that matches all its READ_LEN
    chars against the same row with an N last (it stops at its first
    char), each alone in a launch, by the profiler's device time, warm and
    cold; the difference over READ_LEN - 1 is one step's chain of
    dependent reads."""
    from columba_tpu_torch.index.bmove import BMoveIndex
    from columba_tpu_torch.tools.path_inputs import kernel_call

    kind = "exact.rlc" if isinstance(index, BMoveIndex) else "exact"
    row = np.ascontiguousarray(text[1000:1000 + READ_LEN])[None]
    stop = row.copy()
    stop[0, -1] = 4
    rec = dict(label=label, kind=kind + " chain", runs={})
    for who in (["parent", "tree", "tree", "parent"] if parent else
                ["tree", "tree"]):
        t = {}
        for name, pats in (("full", row), ("stop", stop)):
            inp = dict(kind=kind, index=index, lengths=None,
                       pats=torch.from_numpy(pats).cuda())
            if who == "parent":
                fn = lambda: parent(kind, inp)             # noqa: E731
            else:
                fn = lambda: kernel_call(kind, index, inp)  # noqa: E731
            t[name] = [clocks.profiled(fn, "exact_", cold)
                       for cold in (False, True)]
        step = [None if a is None or b is None else (a - b) / (READ_LEN - 1)
                for a, b in zip(t["full"], t["stop"])]
        rec["runs"].setdefault(who, []).append(dict(t, step_ms=step))
        log(f"{smi}: {label} {kind} one row of {READ_LEN} steps, {who}: "
            f"profiler warm {_fmt(t['full'][0])} ms (stopping at once "
            f"{_fmt(t['stop'][0])}), cold {_fmt(t['full'][1])} "
            f"({_fmt(t['stop'][1])}); a step's chain warm "
            f"{_fmt(step[0])} ms, cold {_fmt(step[1])}")
    results.append(rec)


def il_entries(index, batch, table, clocks: Clocks, smi: str,
               results: list, mods=None, parent_root=None) -> None:
    """Kernels I-L at the SE ALL path's sizes (``batch``: 32,768 rows; C =
    12,288, max_locate = M = 131,072): every entry of one
    ``match_device_core`` call (10-mer seeds, switchpoint 4), of the
    band-only call (switchpoint 0, the two-stage exact loop) and of the
    k = 0 pass, held to its plain version, then timed by CUDA events and
    the profiler, warm and with a flushed L2, beside the plain chain's time
    (events, warm), the library yardstick where one PyTorch call computes
    the same function (``path_inputs.library``: kernel K's ``ranges`` and
    ``rows``; beside ``frontier`` the cumsum of its scan part), the sort
    for kernel L, and the entry's bound. With an earlier tree's modules
    ``mods`` (loaded from ``parent_root``), that tree's entries are
    captured from the same calls through its own pipeline and its own
    ``tools/path_inputs.py`` (inside its :func:`tree_scope`), held to its
    plain versions, and timed in turns with this tree's (parent, this
    tree, this tree, parent); an entry only one tree has is timed alone.
    Then the launch census of the first call and of its ``run_scheme``
    (``path_inputs.launch_census``), on both trees in turns."""
    from columba_tpu_torch.search import pipeline
    from columba_tpu_torch.search.scheme import get_scheme
    from columba_tpu_torch.tools import bounds, path_inputs

    R = batch.shape[0]
    sched = pipeline.compile_cached(get_scheme("kuch1", K), READ_LEN, "edit",
                                    kmer_k=10)
    S = sched.num_searches
    C, ml = pipeline.batch_capacity(R, S, 4), pipeline.batch_max_locate(R)
    C0 = pipeline.batch_capacity(R, S, 0)

    def core(pl, idx, sc):
        return lambda: pl.match_device_core(idx, batch, sc, C, ml, K, table,
                                            4, *pl.crossover_caps(C, ml, 4))

    def captured(cap, pl, idx, sc):
        calls = cap(core(pl, idx, sc))
        for fn in (lambda: pl.match_device_core(
                       idx, batch, sc, C0, ml, K, table, 0, 0, 0, 0,
                       ex_split=8, ex_cap=C0),
                   lambda: pl._exact_device(idx, batch, ml)):
            calls.update({k: v for k, v in cap(fn).items()
                          if k not in calls})
        return calls

    def scoped(fn):
        def run():
            with tree_scope(parent_root):
                return fn()
        return run

    trees = {"tree": (captured(capture_entries, pipeline, index, sched),
                      path_inputs, bounds, lambda fn: fn)}
    if mods is not None:
        pl, ppi = mods["search.pipeline"], mods["tools.path_inputs"]
        cls = mods["index.fmindex"].FMIndex
        pidx = cls(**{f.name: getattr(index, f.name)
                      for f in dataclasses.fields(cls) if f.init})
        # this tree's scheme: the tree's own looks for schemes/ beside it
        psched = pl.compile_cached(get_scheme("kuch1", K), READ_LEN, "edit",
                                   kmer_k=10)
        pcalls = scoped(lambda: captured(ppi.capture_entries, pl, pidx,
                                         psched))()
        trees["parent"] = (pcalls, ppi, mods["tools.bounds"], scoped)
    ours = trees["tree"][0]
    sort = sort_ms(ours["dedup.keys"], clocks)
    names = sorted({n for calls, *_ in trees.values() for n in calls})
    for name in names:
        have = {who: t for who, t in trees.items() if name in t[0]}
        for who, (calls, pi, _, scope) in have.items():
            if scope(lambda: pi.replay_plain(calls[name]))() != 0:
                raise AssertionError(f"kernel {name} ({who}) differs from "
                                     "its plain version")
        order = [w for w in ("parent", "tree", "tree", "parent")
                 if w in have]
        runs: dict = {}
        fns = {}
        for who, (calls, pi, _, scope) in have.items():
            c = calls[name]
            kargs = _copies(pi, c["args"])
            fns[who] = scope(lambda c=c, kargs=kargs: c["real"](**kargs))
        for who in order:
            kernel = trees[who][1].ENTRY_KERNEL[name]
            runs.setdefault(who, []).append(clocks.all(fns[who], kernel))
        calls, pi, bd, scope = have.get("tree", have.get("parent"))
        c = calls[name]
        b = scope(lambda: bd.entry(name, c["args"], c["after"], c["out"]))()
        pargs = _copies(pi, c["args"])
        plain_ms = clocks.events(scope(lambda: c["plain"](**pargs)), False)
        lib_fn = path_inputs.library(c) if "tree" in have else None
        lib = clocks.device_ms(lib_fn) if lib_fn is not None else None
        scan_lib = (clocks.device_ms(path_inputs.frontier_widths_cumsum(c))
                    if name.startswith("expand.frontier") and "tree" in have
                    else None)
        results.append(dict(
            label="se_all_sizes", kind=name, bound_ms=b["bound_ms"],
            bound_by=b["bound_by"], bound_bytes=b["bytes"],
            bound_operations=b["operations"], plain_ms=plain_ms,
            library_ms=lib, scan_cumsum_ms=scan_lib,
            sort_ms=sort if name.startswith("dedup.") else None,
            bound_tree="tree" if "tree" in have else "parent", runs=runs))
        for who, rs in runs.items():
            for i, t in enumerate(rs):
                log(f"{smi}: se_all_sizes {name} {who} run {i}: events warm "
                    f"{t['events_warm']:.4f} ms, cold "
                    f"{t['events_cold']:.4f}; profiler warm "
                    f"{_fmt(t['prof_warm'])}, cold {_fmt(t['prof_cold'])}")
        log(f"{smi}: se_all_sizes {name}: plain {plain_ms:.4f} ms"
            + (f"; library {lib:.5f} ms" if lib is not None else
               "; library none")
            + (f"; cumsum of its widths {scan_lib:.5f} ms"
               if scan_lib is not None else "")
            + (f"; sort {sort:.4f} ms" if name.startswith("dedup.") else "")
            + f"; bound {b['bound_ms']:.5f} ms by {b['bound_by']} "
            f"({b['bytes']} bytes)")

    def scheme(pl, idx, sc):
        ex = pl.executor
        return lambda: ex.run_scheme(
            idx, batch, sc, C, table, 4, *pl.crossover_caps(C, ml, 4),
            itv_min_depth=16, tables=ex.device_tables(sc, batch.device))

    fns = {"tree": (core(pipeline, index, sched),
                    scheme(pipeline, index, sched), pipeline.executor)}
    order = ["tree", "tree"]
    if mods is not None:
        fns["parent"] = (scoped(core(pl, pidx, psched)),
                         scoped(scheme(pl, pidx, psched)), pl.executor)
        order = ["parent", *order, "parent"]
    census = {}
    for who in order:
        core_fn, scheme_fn, ex = fns[who]
        for what, fn in (("match_device_core", core_fn),
                         ("run_scheme", scheme_fn)):
            c = launch_census(fn, ex)
            census.setdefault(f"{who} {what}", []).append(c)
            own = sum(t for k, t in c["ms_by_name"].items()
                      if "keys_kernel" in k or "pass_kernel" in k)
            log(f"{smi}: launch census ({who}), one SE ALL {what} call "
                f"({R} rows, C = {C}, max_locate = {ml}): {c['outside']} "
                f"outside kernel B's band steps ({c['band']}) and a library "
                f"sort ({c['sort']}), {c['total']} in all; device time "
                f"{c['ms']:.4f} ms in all, kernel B's steps "
                f"{c['band_ms']:.4f}, the library sort {c['sort_ms']:.4f}, "
                f"kernel L's keys and passes {own:.4f}; by name "
                f"{json.dumps(c['by_name'], sort_keys=True)}; device ms by "
                "name " + json.dumps({k: round(t, 5) for k, t in
                                      c['ms_by_name'].items()},
                                     sort_keys=True))
    results.append(dict(label="se_all_sizes", kind="launch_census",
                        runs=census))


def columba_inputs(index, codes: np.ndarray, text: np.ndarray,
                   starts: np.ndarray, table, rng, align, wd: str) -> list:
    """Kernel B's static Vanilla entry at the columba scheme's radii on 150
    bp reads: the widest step at each radius of one ``cli align -a best -S
    columba`` batch (``chip_smoke.py``'s ``col150_se_best`` reads: 16 at
    each run of N with 3 % substitutions, the rest uniform; the BEST
    ladder's rungs 1, 3, 5 and 7), then synthetic steps of C = 12,288 lanes
    from the reads' 10-mer seed ranges at kb 5, 6 and 7 (the schedule's own
    tables, W 2) and at kb 13 with W 4 over 14 searches (columba k = 13 at
    150 bp, whose schedule takes about two minutes to compile on the host:
    random step tables)."""
    from columba_tpu_torch.index.kmer import lookup
    from columba_tpu_torch.search import pipeline
    from columba_tpu_torch.search.scheme import get_scheme
    from columba_tpu_torch.tools import workload

    lo, hi = workload.runs_of_n(codes)
    runs = workload.reads_at_runs(text, starts, lo, hi, COL_RUN_READS, rng,
                                  COL_LEN, COL_RUN_ERR)[0]
    uni = workload.sample_reads(text, starts, BATCH - len(runs), rng,
                                COL_LEN)[0]
    reads = np.concatenate([runs, uni])
    fq = os.path.join(wd, "col150.fq")
    workload.write_fastq(fq, reads, "r")
    calls = [c for c in capture(align(["-a", "best", "-S", "columba"],
                                      [fq]))
             if c["kind"] == "band_step"]
    batch = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [reads, reads[:, ::-1] ^ 3]))).cuda()
    seeds = lookup(table, batch[:, 30:40])
    seeds = seeds[seeds[:, 1] > seeds[:, 0]]
    seeds = seeds[torch.from_numpy(rng.integers(0, seeds.shape[0], COL_C)
                                   ).cuda()]
    for kb in COL_KB:
        sched = pipeline.compile_cached(get_scheme("columba", kb), COL_LEN,
                                        "edit", kmer_k=10)
        calls.append(band_input("band_step", band_args(
            index, sched, batch, seeds, rng, 4, C=COL_C)))
    kb, W, S = COL_WIDE
    calls.append(band_input("band_step", random_band_args(
        index, batch, seeds, rng, kb, W, S, COL_LEN + 16, 4)))
    return calls


def generic_variant(kind: str):
    """Kernel B's steps, of every entry, also through its generic entry
    (``executor.BAND_GENERIC``), beside the instance the launch picks."""
    from columba_tpu_torch.search import executor

    if kind not in BAND_KINDS:
        return None

    def launch(kind, inp):
        executor.BAND_GENERIC = True
        try:
            return band_call(executor, inp["index"], inp, "generic")
        finally:
            executor.BAND_GENERIC = False
    return {"generic": launch}


def generic_and_plain(kind: str):
    """:func:`generic_variant`, and the plain version on outputs of its own
    (its events' time: it launches no kernel B for the profiler)."""
    from columba_tpu_torch.search import executor

    more = generic_variant(kind)
    if more is not None:
        more["plain_timed"] = lambda kind, inp: band_call(
            executor, inp["index"], inp, "plain_timed")
    return more


def time_tables(label: str, index, Ks, clocks: Clocks, smi: str,
                results: list) -> None:
    """Kernel A's table entry (``kmer.build_kmer_table``: the k-mer seed
    table in one launch) against the K-launch build it replaced
    (``build_kmer_table_plain``: K ``extend_char`` calls through kernel A's
    per-step entry) at each K, held equal first, then in turns (table,
    steps, steps, table): events, and the profiler's device time of all a
    build runs on the card (the K-launch build's elementwise ops and
    copies included), warm and with the L2 flushed; with the bound."""
    from columba_tpu_torch.index import kmer
    from columba_tpu_torch.tools import bounds

    for K in Ks:
        fns = {"table": lambda K=K: kmer.build_kmer_table(index, K),
               "steps": lambda K=K: kmer.build_kmer_table_plain(index, K)}
        got, want = fns["table"](), fns["steps"]()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{label}: the table entry differs from "
                                 f"the K-launch build at K = {K}")
        b = bounds.kmer_table(K, got)
        what = (f"K={K}, {4 ** K} k-mers x {got.shape[1]}, "
                f"{int((got[:, 1] > got[:, 0]).sum())} occur")
        del got, want
        runs = {k: [] for k in fns}
        for who in ("table", "steps", "steps", "table"):
            fn = fns[who]
            runs[who].append(dict(events_warm=clocks.events(fn, False),
                                  device_warm=clocks.device_ms(fn),
                                  device_cold=clocks.device_ms(fn, True)))
            r = runs[who][-1]
            log(f"{smi}: {label} extend.table [{what}] {who}: events warm "
                f"{r['events_warm']:.4f} ms; profiler device warm "
                f"{_fmt(r['device_warm'])}, cold {_fmt(r['device_cold'])}; "
                f"bound {b['bound_ms']:.5f} ms by {b['bound_by']}")
        results.append(dict(label=label, kind="extend.table", what=what,
                            bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                            bound_bytes=b["bytes"],
                            bound_operations=b["operations"], runs=runs))


def _both_strands(codes: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [codes, codes[:, ::-1] ^ 3]))).cuda()


def _widest_deep(calls: list, kind: str) -> list:
    """The captured widest steps of one kernel B entry at kb 5 and 7."""
    return [c for c in calls if c["kind"] == kind and c.get("kb") in (5, 7)]


def per_lane_inputs(kind: str, index, batch, ranges, table, rng,
                    kbs=COL_KB) -> list:
    """Kernel B's per-lane entry at C = 12,288 lanes of ``ranges`` at the
    columba scheme's radii ``kbs`` (default kb 5, 6 and 7: 150 bp reads;
    one register) on ``batch``'s reads: kernel G's tables of kernel F's
    boundaries of ``batch`` (the seed table ``table`` where given), step
    T - m / 3, random band state."""
    from columba_tpu_torch.search import dynschedule
    from columba_tpu_torch.search.scheme import get_scheme

    dev = batch.device
    R, m = batch.shape
    out = []
    for kb in kbs:
        scheme = get_scheme("columba", kb)
        st = dynschedule.scheme_static(scheme, m, "edit")
        dyn = dynschedule.build_tables(st, dynschedule.dynamic_partition(
            index, batch, scheme, table), batch)
        S, T, bw = st.num_searches, st.t_max, 2 * st.kb + 1
        lanes = (index, ranges[:COL_C].contiguous(),
                 torch.from_numpy(rng.integers(0, R * S, COL_C).astype(
                     np.int32)).to(dev),
                 torch.from_numpy(rng.integers(0, 4, (COL_C, 2, bw)).astype(
                     np.int8)).to(dev),
                 torch.from_numpy(rng.integers(0, 3, (COL_C, 2, 1)).astype(
                     np.int8)).to(dev),
                 None, dyn["pchars"], T, T - m // 3, 4)
        out.append(band_input(kind, lanes, dyn_meta=dyn["meta"].reshape(-1)))
    return out


def columba250_inputs(index, codes: np.ndarray, text: np.ndarray,
                      starts: np.ndarray, table, rng, align,
                      wd: str) -> list:
    """Kernel B's Vanilla entries at kb 8-13, where the quad body takes
    them: the widest static step at kb 9 and 12 of one ``cli align -a best
    -S columba`` batch of 250 bp reads (cutoff 12, the ladder's rungs 0,
    1, 3, 5, 9 and 12; ``chip_smoke.py``'s ``col250`` reads: the first
    1,024 at 4 % substitutions, 8 at each run of N, the rest at 1 %), the
    widest steps of its ``-p dynamic`` twin (the per-lane entry at kb 9;
    at kb 12 the static one, since 13 parts of 25 do not fit in 250 bp);
    synthetic steps of C = 12,288 lanes from the reads' 10-mer seed ranges
    at kb 8-13 on the columba scheme's own step tables at 250 and 270 bp
    (random band state), and the per-lane entry at kb 8-10 on kernel G's
    tables of 4,096 of the reads."""
    from columba_tpu_torch.index.kmer import lookup
    from columba_tpu_torch.search import pipeline
    from columba_tpu_torch.search.scheme import get_scheme
    from columba_tpu_torch.tools import workload

    reads = workload.ladder_reads(
        text, starts, workload.runs_of_n(codes), BATCH, COL250_HARD,
        COL250_RUN_READS, COL250_ERR, rng, COL250_LEN)[0]
    fq = os.path.join(wd, "col250.fq")
    workload.write_fastq(fq, reads, "r")
    best = ["-a", "best", "-S", "columba"]
    calls = [c for c in capture(align(best, [fq]))
             if c["kind"] == "band_step" and c["kb"] in (9, 12)]
    calls += [c for c in capture(align(best + ["-p", "dynamic"], [fq]))
              if c["kind"] in ("band_step", "band_step.per_lane")
              and c["kb"] in (9, 12)]
    batch = _both_strands(reads)
    seeds = lookup(table, batch[:, 30:40])
    seeds = seeds[seeds[:, 1] > seeds[:, 0]]
    seeds = seeds[torch.from_numpy(rng.integers(0, seeds.shape[0], COL_C)
                                   ).cuda()]
    for m in COL250_LENS:
        mb = batch if m <= COL250_LEN else torch.cat(
            [batch, batch[:, :m - COL250_LEN]], dim=1).contiguous()
        for kb in COL250_KB:
            sched = pipeline.compile_cached(get_scheme("columba", kb), m,
                                            "edit", kmer_k=10)
            calls.append(band_input("band_step", band_args(
                index, sched, mb, seeds, rng, 4, C=COL_C)))
    calls += per_lane_inputs("band_step.per_lane", index,
                             batch[:COL_TABLE_READS].contiguous(), seeds,
                             table, rng, COL250_LANE_KB)
    return calls


def default_run(wd: str, idx: str, codes: np.ndarray, text: np.ndarray,
                starts: np.ndarray, align, clocks: Clocks, smi: str,
                results: list) -> None:
    """``--only default_run``: the reference's default run (BEST, ``-S
    columba``, 150 bp; with and without ``-p dynamic``) on the Vanilla and
    b-move indexes. Kernel A's table entry against the K-launch build
    (Vanilla K = 10 and 12, RLC K = 10); kernel B's kb 5-7 instances of
    the per-lane, RLC, per-lane RLC and textless entries, each against its
    generic entry in turns, on the widest step at kb 5 and at kb 7 of one
    ``cli align`` batch of each path (``chip_smoke.py``'s reads: the
    ``col150`` reads on the Vanilla index, 16 at each run of N with 3 %
    substitutions; on the pan-genome the first 1,024 at 3 %, the rest at
    1 %) and at C = 12,288 synthetic lanes (RLC 8 wide, textless 12 wide
    with 2W colMin slots; the per-lane entries on kernel G's tables of
    kernel F's boundaries); the plain version in the same turns."""
    from columba_tpu_torch.index.bmove import BMoveIndex, load_bmove
    from columba_tpu_torch.index.build import load_index
    from columba_tpu_torch.index.fmindex import FMIndex
    from columba_tpu_torch.index.kmer import build_kmer_table, lookup
    from columba_tpu_torch.search import pipeline
    from columba_tpu_torch.search.scheme import get_scheme
    from columba_tpu_torch.tools import workload

    rng = np.random.default_rng(SEED + 6)
    best = ["-a", "best", "-S", "columba"]
    dyn = best + ["-p", "dynamic"]
    index = FMIndex.from_arrays(load_index(idx), "cuda")
    time_tables("vanilla", index, (10, 12), clocks, smi, results)
    table = build_kmer_table(index, 10)
    lo, hi = workload.runs_of_n(codes)
    runs = workload.reads_at_runs(text, starts, lo, hi, COL_RUN_READS, rng,
                                  COL_LEN, COL_RUN_ERR)[0]
    uni = workload.sample_reads(text, starts, BATCH - len(runs), rng,
                                COL_LEN)[0]
    reads = np.concatenate([runs, uni])
    fq = os.path.join(wd, "col150.fq")
    workload.write_fastq(fq, reads, "r")
    calls = _widest_deep(capture(align(idx, dyn, [fq])),
                         "band_step.per_lane")
    batch = _both_strands(reads[:COL_TABLE_READS])
    seeds = lookup(table, batch[:, 30:40])
    seeds = seeds[seeds[:, 1] > seeds[:, 0]]
    seeds = seeds[torch.from_numpy(rng.integers(0, seeds.shape[0], COL_C)
                                   ).cuda()]
    calls += per_lane_inputs("band_step.per_lane", index, batch, seeds,
                             table, rng)
    time_inputs("default_run", calls, clocks, smi, results, None,
                generic_and_plain)
    del index, table, calls, batch, seeds
    torch.cuda.empty_cache()

    pan = workload.pan_genome()
    fa = os.path.join(wd, "pan.fa")
    workload.write_fasta(fa, pan, "pan")
    ridx, tidx = os.path.join(wd, "rlc.cidx"), os.path.join(wd, "tl.cidx")
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-m", f"{PKG}.cli", "build",
                               "-r", out, "-f", fa, *flags])
             for out, flags in ((ridx, ["--rlc"]),
                                (tidx, ["--rlc", "--textless"]))]
    assert all(p.wait() == 0 for p in procs)
    log(f"cli build --rlc and --rlc --textless, at once: "
        f"{time.time() - t0:.1f} s")
    bm = BMoveIndex.from_arrays(load_bmove(ridx), "cuda")
    tl = BMoveIndex.from_arrays(load_bmove(tidx), "cuda")
    time_tables("rlc", bm, (10,), clocks, smi, results)
    span = np.array([0, len(pan)], np.int64)
    hard = workload.sample_reads(pan, span, COL_PAN_HARD, rng, COL_LEN,
                                 COL_RUN_ERR)[0]
    rest = workload.sample_reads(pan, span, BATCH - COL_PAN_HARD, rng,
                                 COL_LEN)[0]
    preads = np.concatenate([hard, rest])
    workload.write_fastq(fq, preads, "r")
    calls = []
    for argv, at, kind in ((best, ridx, "band_step.rlc"),
                           (dyn, ridx, "band_step.per_lane_rlc"),
                           (best, tidx, "band_step.textless")):
        calls += _widest_deep(capture(align(at, argv, [fq])), kind)
    batch = _both_strands(preads[:COL_TABLE_READS])
    states = rlc_lane_states(bm, batch, rng, COL_C)
    tl_states = rlc_lane_states(tl, batch, rng, COL_C)
    for kb in COL_KB:
        sched = pipeline.compile_cached(get_scheme("columba", kb), COL_LEN,
                                        "edit")
        calls.append(band_input("band_step.rlc", band_args(
            bm, sched, batch, states, rng, 4, C=COL_C)))
        tb = list(band_args(tl, sched, batch, tl_states, rng, 0, C=COL_C))
        tb[4] = torch.from_numpy(rng.integers(
            0, 3, (COL_C, 2, 2 * sched.W)).astype(np.int8)).cuda()
        calls.append(band_input("band_step.textless", tb, track=True))
    calls += per_lane_inputs("band_step.per_lane_rlc", bm, batch, states,
                             None, rng)
    time_inputs("default_run_rlc", calls, clocks, smi, results, None,
                generic_and_plain)


def _copies(pi, x):
    """Copies of a captured call's arguments through a tree's own
    ``path_inputs`` (an earlier tree's has no aliasing ``copies``)."""
    if hasattr(pi, "copies"):
        return pi.copies(x)
    return pi._deep(x, pi._copy)


def _fmt(v) -> str:
    return "not measured" if v is None else f"{v:.5f}"


def block_variants(kind: str):
    """Kernel B's RLC entries at each block size the launch may choose
    (``executor.BAND_QUAD_BLOCK``: 64, 128 and 256 threads a tile of 64
    lanes), beside the launch's own choice ("tree")."""
    from columba_tpu_torch.search import executor

    if kind not in BAND_KINDS:
        return None

    def at(threads):
        def launch(kind, inp):
            executor.BAND_QUAD_BLOCK = threads
            try:
                # outputs of its own: the counters accumulate visits over
                # the timed launches
                return band_call(executor, inp["index"], inp,
                                 f"block{threads}")
            finally:
                executor.BAND_QUAD_BLOCK = 0
        return launch
    return {f"block{b}": at(b) for b in (64, 128, 256)}


def _first_of_each(calls: list) -> list:
    """The first launch of each kernel entry (and band radius)."""
    seen, out = set(), []
    for c in calls:
        key = (c["kind"], c.get("kb"))
        if key not in seen:
            seen.add(key)
            out.append(c)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the JSON of every number to "
                         "DIR/kernel_bench.json")
    ap.add_argument("--parent", default=None,
                    help="the root of an earlier commit's unpacked "
                         "columba_tpu_torch/, timed beside this tree")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default=None,
                    help="comma-separated kernel kinds to time (locate, "
                         "verify, exact, dynpart, dyn_tables, gather, "
                         "band_step, extend, frontier, expand, dedup; an "
                         "entry such as exact.rlc names one; columba150: "
                         "kernel B's static entry at kb 5-7 and 13, its "
                         "instances beside its generic entry; default_run: "
                         "kernel A's table entry and kernel B's per-lane, "
                         "RLC and textless entries at kb 5-7 on the "
                         "reference's default run; columba250: kernel B's "
                         "quad body at kb 8-13 on 250 bp reads beside its "
                         "generic entry); all by default")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None

    def wanted(kind: str) -> bool:
        return only is None or kind in only or kind.split(".")[0] in only

    def picked(calls: list) -> list:
        return [c for c in calls if wanted(c["kind"])]
    torch.cuda.init()        # raises where there is no CUDA device

    from columba_tpu_torch import cli, native
    from columba_tpu_torch.index.bmove import BMoveIndex, load_bmove
    from columba_tpu_torch.index.build import decoded_text, load_index
    from columba_tpu_torch.index.fmindex import FMIndex
    from columba_tpu_torch.index.kmer import build_kmer_table
    from columba_tpu_torch.search.scheme import get_scheme
    from columba_tpu_torch.tools import workload

    def ours(line):
        return any(k in line for k in ("locate", "verify", "exact",
                                       "dynpart", "dyn_tables", "gather",
                                       "band_step", "extend", "seed_",
                                       "drain_", "init_", "ex_", "tail_",
                                       "frontier_", "scan_", "rows_",
                                       "windows_", "keys_", "compact_"))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}")
    native.load_kernels()
    for ln in native.ptxas_report(native.build_log.get("kernels", "")):
        if ours(ln):
            log(f"ptxas (this tree) {ln}")
    parent = None
    if args.parent:
        mods = load_tree(args.parent)
        mods["native"].load_kernels()
        for ln in native.ptxas_report(
                mods["native"].build_log.get("kernels", "")):
            if ours(ln):
                log(f"ptxas (parent) {ln}")
        parent = tree_launcher(mods)
    clocks = Clocks(args.reps)
    results = []
    if wanted("gather"):
        time_gather(clocks, smi, results,
                    mods["tools.gather_bench"].gather_rows if parent
                    else None)
    if only is not None and not only - {"gather"}:
        return _write(args.out, smi, results)

    with tempfile.TemporaryDirectory(prefix="columba_kb_") as wd:
        def align(idx, argv, fq):
            def run():
                err = io.StringIO()
                with contextlib.redirect_stderr(err):
                    assert cli.main(["align", "-r", idx, "-S", "kuch1", "-b",
                                     str(BATCH), "-f", fq[0], "-o",
                                     os.path.join(wd, "o.sam"), *argv]
                                    + (["-F", fq[1]] if len(fq) > 1
                                       else [])) == 0
            return run

        def both_strands(codes):
            return torch.from_numpy(np.ascontiguousarray(np.concatenate(
                [codes, codes[:, ::-1] ^ 3]))).cuda()

        rng = np.random.default_rng(SEED)
        fa, idx = os.path.join(wd, "genome.fa"), os.path.join(wd, "g.cidx")
        codes, _ = workload.write_genome(fa, rng)
        t0 = time.time()
        assert cli.main(["build", "-r", idx, "-f", fa]) == 0
        log(f"cli build (-s 4): {time.time() - t0:.1f} s")
        arrays = load_index(idx)
        text = decoded_text(arrays)
        reads = workload.sample_reads(text, arrays.seq_starts, BATCH, rng,
                                      READ_LEN)[0]
        m1, m2 = workload.sample_pairs(text, arrays.seq_starts, BATCH, rng,
                                       READ_LEN)[:2]
        if only == {"default_run"}:
            default_run(wd, idx, codes, text, arrays.seq_starts,
                        lambda at, argv, fq: align(at, argv, fq), clocks,
                        smi, results)
            return _write(args.out, smi, results)
        if only == {"columba250"}:
            index = FMIndex.from_arrays(arrays, "cuda")
            time_inputs("columba250", columba250_inputs(
                index, codes, text, arrays.seq_starts,
                build_kmer_table(index, 10), np.random.default_rng(SEED + 9),
                lambda argv, fq: align(idx, argv, fq), wd),
                clocks, smi, results, parent, generic_and_plain)
            return _write(args.out, smi, results)
        if only == {"columba150"}:
            index = FMIndex.from_arrays(arrays, "cuda")
            time_inputs("columba150", columba_inputs(
                index, codes, text, arrays.seq_starts,
                build_kmer_table(index, 10), np.random.default_rng(SEED + 6),
                lambda argv, fq: align(idx, argv, fq), wd),
                clocks, smi, results, None, generic_variant)
            return _write(args.out, smi, results)
        del codes
        fq = {}
        for tag, codes in (("se", reads), ("p1", m1), ("p2", m2)):
            fq[tag] = os.path.join(wd, tag + ".fq")
            workload.write_fastq(fq[tag], codes, "r")
        all_k = ["-a", "all", "-e", str(K)]
        captured = {
            "se_all": capture(align(idx, all_k, [fq["se"]])),
            "pe_best": capture(align(idx, ["-a", "best"],
                                     [fq["p1"], fq["p2"]])),
            # kernel G's own inputs: the tables of each (re-)run
            "se_all_dynamic": [c for c in capture(align(
                idx, all_k + ["-p", "dynamic"], [fq["se"]]))
                if c["kind"] == "dyn_tables"],
        }
        index = captured["se_all"][0]["index"]
        synth = synthetic(index, text, np.random.default_rng(SEED + 1),
                          2 * BATCH, ("locate", "verify"))
        batch, table = both_strands(reads), build_kmer_table(index, 10)
        if any(wanted(k) for k in ("frontier", "expand", "dedup")):
            il_entries(index, batch, table, clocks, smi, results,
                       mods if parent else None,
                       os.path.abspath(args.parent) if parent else None)
        if wanted("band_step"):
            synth.append(vanilla_band_input(index, batch, table))
        synth += exact_part_inputs(index, batch, table)
        synth += tables_inputs(index, batch, table)
        del arrays
        for path, calls in captured.items():
            log(f"captured {path}: " + "; ".join(
                f"{c['kind']} {describe(c)}" for c in calls))
        time_inputs("synthetic", picked(synth), clocks, smi, results, parent)
        if wanted("exact"):
            chain_floor("synthetic", index, text, clocks, smi, results,
                        parent)
        for path, calls in captured.items():
            time_inputs(path, picked(_first_of_each(calls)), clocks, smi,
                        results, parent)
        del captured, synth, index, text
        torch.cuda.empty_cache()
        if only is not None and only <= {"frontier", "expand", "dedup",
                                         "gather"}:
            return _write(args.out, smi, results)

        pan = workload.pan_genome()
        workload.write_fasta(fa, pan, "pan")
        ridx = os.path.join(wd, "rlc.cidx")
        tidx = os.path.join(wd, "tl.cidx")
        steps = wanted("band_step") or wanted("extend")
        t0 = time.time()
        builds = [(ridx, ["--rlc"])] + ([(tidx, ["--rlc", "--textless"])]
                                        if steps else [])
        procs = [subprocess.Popen([sys.executable, "-m", f"{PKG}.cli",
                                   "build", "-r", out, "-f", fa, *flags])
                 for out, flags in builds]
        assert all(p.wait() == 0 for p in procs)
        log(f"cli build --rlc (and --rlc --textless, at once): "
            f"{time.time() - t0:.1f} s")
        span = np.array([0, len(pan)], np.int64)
        prs = workload.sample_reads(pan, span, BATCH, rng, READ_LEN)[0]
        p1, p2 = workload.sample_pairs(pan, span, BATCH, rng, READ_LEN,
                                       frag_min=250, frag_max=450)[:2]
        for tag, codes in (("se", prs), ("p1", p1), ("p2", p2)):
            workload.write_fastq(fq[tag], codes, "r")
        # the -d collection: kuch1 and its mirror per k
        multi = os.path.join(wd, "collection")
        for k in range(1, BEST_CUT + 1):
            os.makedirs(os.path.join(multi, str(k)))
            base = get_scheme("kuch1", k)
            for x, sc in enumerate((base, base.mirrored()), 1):
                with open(os.path.join(multi, str(k), f"scheme{x}.txt"),
                          "w") as f:
                    f.write(str(sc) + "\n")
        all_k = ["-a", "all", "-e", str(K), "-nD"]
        paths = {
            "rlc_se_all": (all_k, [fq["se"]]),
            "rlc_se_all_dynamic": (all_k + ["-p", "dynamic"], [fq["se"]]),
            "rlc_pe_best": (["-a", "best"], [fq["p1"], fq["p2"]]),
            "rlc_se_best_d": (["-a", "best", "-d", multi], [fq["se"]]),
            "tl_se_all": (all_k, [fq["se"]]),
        }
        want = {"rlc_se_all": ("locate.rlc", "verify", "band_step.rlc",
                               "extend.loop_rlc"),
                "rlc_se_all_dynamic": ("dynpart.rlc", "dyn_tables",
                                       "band_step.per_lane_rlc",
                                       "extend.loop_rlc"),
                "rlc_pe_best": ("exact.rlc",),
                "rlc_se_best_d": ("exact.rlc_lengths",),
                "tl_se_all": ("band_step.textless", "extend.loop_rlc")}
        captured = {}
        for path, (argv, files) in paths.items():
            if not any(wanted(k) for k in want[path]):
                continue
            calls = capture(align(tidx if path.startswith("tl") else ridx,
                                  argv, files))
            captured[path] = [c for c in _first_of_each(calls)
                              if c["kind"] in want[path]]
            log(f"captured {path}: " + "; ".join(
                f"{c['kind']} {describe(c)}" for c in calls))
        bm = next(c["index"] for calls in captured.values() for c in calls
                  if isinstance(c["index"], BMoveIndex)
                  and not c["index"].textless)
        log(f"RLC index: r_fwd {bm.r_fwd}, r_rev {bm.r_rev}, fused "
            f"{bm.fused.numel() * 4} bytes, run tables "
            f"{bm.starts.numel() * 4} + {bm.run_at_rev.numel() * 4} bytes "
            f"(the forward bucket table is kernel C's, "
            f"{bm.run_at.numel() * 4} bytes)")
        synth = synthetic(bm, pan, np.random.default_rng(SEED + 3),
                          2 * BATCH, ("locate.rlc", "verify"))
        synth = ([s for s in synth if s["kind"] == "locate.rlc"]
                 + [s for s in synth if s.get("kb") == K]
                 + exact_part_inputs(bm, both_strands(prs), None))
        if steps:
            tl = BMoveIndex.from_arrays(load_bmove(tidx), "cuda")
            log(f"textless RLC index: run tables {tl.starts.numel() * 4} + "
                f"{tl.run_at.numel() * 4} + {tl.run_at_rev.numel() * 4} "
                f"bytes on the card (fused rows {tl.fused.numel() * 4})")
            synth += band_loop_inputs(bm, tl, both_strands(prs),
                                      np.random.default_rng(SEED + 4))
        time_inputs("synthetic_rlc", picked(synth), clocks, smi, results,
                    parent, block_variants)
        if wanted("exact.rlc"):
            chain_floor("synthetic_rlc", bm, pan, clocks, smi, results,
                        parent)
        for path, calls in captured.items():
            time_inputs(path, picked(calls), clocks, smi, results, parent,
                        block_variants)
    return _write(args.out, smi, results)


def _write(out, smi: str, results: list) -> int:
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "kernel_bench.json"), "w") as f:
            json.dump(dict(card=smi, results=results), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
