"""Kernels C (locate, both entries) and D (verify) on the inputs the paths
give them, on one CUDA device.

Run from the repository root on a machine with a CUDA device:

    python -m columba_tpu_torch.tools.locate_verify_bench [--out DIR]
        [--parent TREE] [--reps N]

It builds the smoke's two workloads (``tools/workload.py``: the random
128 Mbp genome with its Vanilla index at SA sparseness 4, and the 128 Mbp
pan-genome of 20 haplotypes with its ``--rlc`` index), then:

1. captures the paths' own inputs (``tools/path_inputs.py``): one ``cli
   align`` batch (16,384 reads or pairs) of ``se_all`` (``-a all -e 2``),
   ``pe_best`` (``-a best -F``) and ``rlc_se_all`` (``-a all -e 2 -nD``);
   each launch keeps its rows, or its (reads, read ids, window starts,
   kb), and the live counts beside the capacity;
2. makes the smoke's synthetic inputs beside them: uniformly random SA
   rows, and candidates near random loci with random read ids, at kb 0,
   2, 4, 5, 7 and 13;
3. times every kernel entry on every input through the ops wrappers,
   by CUDA events and by ``torch.profiler``'s device time, warm and with
   a flushed L2, and prints the plain versions' counts and
   ``tools/bounds.py``'s bound beside each time.

With ``--parent TREE`` (an earlier commit's ``columba_tpu_torch/``,
unpacked by ``git archive COMMIT columba_tpu_torch | tar -x -C TREE``) it
also imports that tree's own ``ops/locate.py`` and ``ops/verify.py`` and
times their kernels on the same inputs through those wrappers, in turns:
parent, this tree, this tree, parent. Each is checked against the plain
version first. The card's name and power limit head the output; ``--out``
gets the JSON of every number. It needs no JAX.
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
SYNTH_KB = (0, 2, 4, 5, 7, 13)
PKG = "columba_tpu_torch"
TREE_MODULES = ("native", "ops.locate", "ops.verify", "index.bmove",
                "index.fmindex")


# -- an earlier tree's kernels, through its own wrappers ----------------------

def load_tree(tree: str) -> dict:
    """The tree's own ``native``, ``ops.locate``, ``ops.verify`` and index
    classes. This tree's modules are set aside in ``sys.modules`` while the
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the JSON of every number to "
                         "DIR/locate_verify.json")
    ap.add_argument("--parent", default=None,
                    help="the root of an earlier commit's unpacked "
                         "columba_tpu_torch/, timed beside this tree")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    torch.cuda.init()        # raises where there is no CUDA device

    from columba_tpu_torch import cli, native
    from columba_tpu_torch.index.bmove import BMoveIndex
    from columba_tpu_torch.index.build import decoded_text, load_index
    from columba_tpu_torch.tools import workload

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}")
    native.load_kernels()
    for ln in native.ptxas_report(native.build_log.get("kernels", "")):
        if "locate" in ln or "verify" in ln:
            log(f"ptxas (this tree) {ln}")
    parent = None
    if args.parent:
        mods = load_tree(args.parent)
        mods["native"].load_kernels()
        for ln in native.ptxas_report(
                mods["native"].build_log.get("kernels", "")):
            if "locate" in ln or "verify" in ln:
                log(f"ptxas (parent) {ln}")
        parent = tree_launcher(mods)
    clocks = Clocks(args.reps)
    results = []

    with tempfile.TemporaryDirectory(prefix="columba_cd_") as wd:
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
        del arrays
        for path, calls in captured.items():
            log(f"captured {path}: " + "; ".join(
                f"{c['kind']} {describe(c)}" for c in calls))
        time_inputs("synthetic", synth, clocks, smi, results, parent)
        for path, calls in captured.items():
            time_inputs(path, calls, clocks, smi, results, parent)
        del captured, synth, index, text
        torch.cuda.empty_cache()

        pan = workload.pan_genome()
        workload.write_fasta(fa, pan, "pan")
        ridx = os.path.join(wd, "rlc.cidx")
        t0 = time.time()
        assert cli.main(["build", "-r", ridx, "-f", fa, "--rlc"]) == 0
        log(f"cli build --rlc: {time.time() - t0:.1f} s")
        prs = workload.sample_reads(pan, np.array([0, len(pan)], np.int64),
                                    BATCH, rng, READ_LEN)[0]
        workload.write_fastq(fq["se"], prs, "r")
        calls = capture(align(ridx, ["-a", "all", "-e", str(K), "-nD"],
                              [fq["se"]]))
        bm = calls[0]["index"]
        assert isinstance(bm, BMoveIndex)
        log(f"RLC index: r_fwd {bm.r_fwd}, r_rev {bm.r_rev}, fused "
            f"{bm.fused.numel() * 4} bytes")
        log("captured rlc_se_all: " + "; ".join(
            f"{c['kind']} {describe(c)}" for c in calls))
        synth = synthetic(bm, pan, np.random.default_rng(SEED + 3),
                          2 * BATCH, ("locate.rlc", "verify"))
        time_inputs("synthetic_rlc", [s for s in synth
                                      if s["kind"] == "locate.rlc"]
                    + [s for s in synth if s.get("kb") == K],
                    clocks, smi, results, parent)
        time_inputs("rlc_se_all", calls, clocks, smi, results, parent)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "locate_verify.json"), "w") as f:
            json.dump(dict(card=smi, results=results), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
