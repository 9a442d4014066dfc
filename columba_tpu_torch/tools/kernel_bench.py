"""Kernels C (locate, both entries), D (verify), E (exact match: Vanilla,
RLC, RLC with lengths) and F (dynamic partition, both entries) on the
inputs the paths give them, on one CUDA device.

Run from the repository root on a machine with a CUDA device:

    python -m columba_tpu_torch.tools.kernel_bench [--out DIR]
        [--parent TREE] [--reps N]

It builds the smoke's two workloads (``tools/workload.py``: the random
128 Mbp genome with its Vanilla index at SA sparseness 4, and the 128 Mbp
pan-genome of 20 haplotypes with its ``--rlc`` index), then:

1. captures the paths' own inputs (``tools/path_inputs.py``): one ``cli
   align`` batch (16,384 reads or pairs) of ``se_all`` (``-a all -e 2``),
   ``pe_best`` (``-a best -F``), ``rlc_se_all`` (``-a all -e 2 -nD``),
   ``rlc_se_all_dynamic`` (the same with ``-p dynamic``: kernel F's RLC
   entry), ``rlc_pe_best`` (``-a best -F``, pairs of 250-450 bp
   fragments: its exact rung is kernel E's RLC entry) and
   ``rlc_se_best_d`` (``-a best -d`` with kuch1 and its mirror per k: the
   selection probe, kernel E's RLC entry with lengths); each launch keeps
   its inputs, and C and D's the live counts beside the capacity;
2. makes the smoke's synthetic inputs beside them: uniformly random SA
   rows, and candidates near random loci with random read ids, at kb 0,
   2, 4, 5, 7 and 13; 32,768 rows x 100 bp (a batch of 16,384 reads, both
   strands) for E and F (F: kuch1 k = 2, with the 10-mer seed table on
   the Vanilla index, single-character seeds on RLC) and their 163,840
   part patterns of scheme selection for E with lengths;
3. times every kernel entry on every input through its wrapper, by CUDA
   events and by ``torch.profiler``'s device time, warm and with a
   flushed L2, and prints the plain versions' counts (E and F on RLC:
   dependent-read rounds a row) and ``tools/bounds.py``'s bound beside
   each time;
4. times kernel E on one row that matches all its 100 chars against one
   that stops at its first: the difference over 99 is the latency of one
   step's chain of dependent reads, and that times a batch's longest row
   is the batch's latency floor.

With ``--parent TREE`` (an earlier commit's ``columba_tpu_torch/``,
unpacked by ``git archive COMMIT columba_tpu_torch | tar -x -C TREE``) it
also imports that tree's own ``ops/locate.py``, ``ops/verify.py``,
``ops/extend.py`` and ``search/dynschedule.py`` and times their kernels
on the same inputs through those wrappers, in turns: parent, this tree,
this tree, parent. Each is checked against the plain version first. The
card's name and power limit head the output; ``--out`` gets the JSON of
every number. It needs no JAX.
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
    Clocks, capture, describe, live_tensor, log, time_inputs,
)

SEED = 20260817
BATCH = 16384
READ_LEN = 100
K = 2
BEST_CUT = 4             # BEST cutoff of kuch1 at 100 bp (the smoke's)
SYNTH_KB = (0, 2, 4, 5, 7, 13)
PKG = "columba_tpu_torch"
TREE_MODULES = ("native", "ops.locate", "ops.verify", "ops.extend",
                "search.dynschedule", "index.bmove", "index.fmindex")


# -- an earlier tree's kernels, through its own wrappers ----------------------

def load_tree(tree: str) -> dict:
    """The tree's own ``native``, kernel wrappers and index classes. This tree's modules are set aside in ``sys.modules`` while the
    tree's import and put back after, so each tree's wrappers call their
    own C entries with their own arguments; the tree's kernels build into
    its own ``_build``."""
    mine = {k: v for k, v in sys.modules.items()
            if k == PKG or k.startswith(PKG + ".")}
    root = os.path.abspath(tree)
    for k in mine:
        del sys.modules[k]
    sys.path.insert(0, root)
    try:
        mods = {m: importlib.import_module(f"{PKG}.{m}")
                for m in TREE_MODULES}
    finally:
        sys.path.remove(root)
        for k in [k for k in sys.modules
                  if k == PKG or k.startswith(PKG + ".")]:
            del sys.modules[k]
        sys.modules.update(mine)
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


def _fmt(v) -> str:
    return "not measured" if v is None else f"{v:.5f}"


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
    args = ap.parse_args(argv)
    torch.cuda.init()        # raises where there is no CUDA device

    from columba_tpu_torch import cli, native
    from columba_tpu_torch.index.bmove import BMoveIndex
    from columba_tpu_torch.index.build import decoded_text, load_index
    from columba_tpu_torch.index.kmer import build_kmer_table
    from columba_tpu_torch.search.scheme import get_scheme
    from columba_tpu_torch.tools import workload

    def ours(line):
        return any(k in line for k in ("locate", "verify", "exact",
                                       "dynpart"))

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
        workload.write_genome(fa, rng)
        t0 = time.time()
        assert cli.main(["build", "-r", idx, "-f", fa]) == 0
        log(f"cli build (-s 4): {time.time() - t0:.1f} s")
        arrays = load_index(idx)
        text = decoded_text(arrays)
        reads = workload.sample_reads(text, arrays.seq_starts, BATCH, rng,
                                      READ_LEN)[0]
        m1, m2 = workload.sample_pairs(text, arrays.seq_starts, BATCH, rng,
                                       READ_LEN)[:2]
        fq = {}
        for tag, codes in (("se", reads), ("p1", m1), ("p2", m2)):
            fq[tag] = os.path.join(wd, tag + ".fq")
            workload.write_fastq(fq[tag], codes, "r")
        captured = {
            "se_all": capture(align(idx, ["-a", "all", "-e", str(K)],
                                    [fq["se"]])),
            "pe_best": capture(align(idx, ["-a", "best"],
                                     [fq["p1"], fq["p2"]])),
        }
        index = captured["se_all"][0]["index"]
        synth = synthetic(index, text, np.random.default_rng(SEED + 1),
                          2 * BATCH, ("locate", "verify"))
        synth += exact_part_inputs(index, both_strands(reads),
                                   build_kmer_table(index, 10))
        del arrays
        for path, calls in captured.items():
            log(f"captured {path}: " + "; ".join(
                f"{c['kind']} {describe(c)}" for c in calls))
        time_inputs("synthetic", synth, clocks, smi, results, parent)
        chain_floor("synthetic", index, text, clocks, smi, results, parent)
        for path, calls in captured.items():
            time_inputs(path, _first_of_each(calls), clocks, smi, results,
                        parent)
        del captured, synth, index, text
        torch.cuda.empty_cache()

        pan = workload.pan_genome()
        workload.write_fasta(fa, pan, "pan")
        ridx = os.path.join(wd, "rlc.cidx")
        t0 = time.time()
        assert cli.main(["build", "-r", ridx, "-f", fa, "--rlc"]) == 0
        log(f"cli build --rlc: {time.time() - t0:.1f} s")
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
        }
        want = {"rlc_se_all": ("locate.rlc", "verify"),
                "rlc_se_all_dynamic": ("dynpart.rlc",),
                "rlc_pe_best": ("exact.rlc",),
                "rlc_se_best_d": ("exact.rlc_lengths",)}
        captured = {}
        for path, (argv, files) in paths.items():
            calls = capture(align(ridx, argv, files))
            captured[path] = [c for c in _first_of_each(calls)
                              if c["kind"] in want[path]]
            log(f"captured {path}: " + "; ".join(
                f"{c['kind']} {describe(c)}" for c in calls))
        bm = captured["rlc_se_all"][0]["index"]
        assert isinstance(bm, BMoveIndex)
        log(f"RLC index: r_fwd {bm.r_fwd}, r_rev {bm.r_rev}, fused "
            f"{bm.fused.numel() * 4} bytes, run tables "
            f"{bm.starts.numel() * 4} + {bm.run_at_rev.numel() * 4} bytes "
            f"(the forward bucket table is kernel C's, "
            f"{bm.run_at.numel() * 4} bytes)")
        synth = synthetic(bm, pan, np.random.default_rng(SEED + 3),
                          2 * BATCH, ("locate.rlc", "verify"))
        time_inputs("synthetic_rlc", [s for s in synth
                                      if s["kind"] == "locate.rlc"]
                    + [s for s in synth if s.get("kb") == K]
                    + exact_part_inputs(bm, both_strands(prs), None),
                    clocks, smi, results, parent)
        chain_floor("synthetic_rlc", bm, pan, clocks, smi, results, parent)
        for path, calls in captured.items():
            time_inputs(path, calls, clocks, smi, results, parent)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "kernel_bench.json"), "w") as f:
            json.dump(dict(card=smi, results=results), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
