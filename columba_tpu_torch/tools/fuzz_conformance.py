"""Conformance fuzz of ``pipeline.match_all`` against brute-force oracles.

The port of the JAX package's ``tools/fuzz_conformance.py``: the same seeds
(``1000 + seed``), the same draws in the same order and the same trials. Each
seed builds the index of a random genome of 5,000-40,000 bp and its 6-mer
seed table; each of its two trials draws a scheme (kuch1, kuch2, kianfar,
pigeon, 01*0), k = 1..3, the metric (edit or Hamming), a read length m of
40-109, the switchpoint (0 or 4), the partitioning (uniform, dynamic or
static) and whether the seed table is used, and six reads with up to k
errors (substitutions, and on edit distance insertions and deletions), the
first at the text's start and the second at its end. ``match_all``'s
(read, strand, end or begin, distance) set must equal the oracle's
(``tools/oracle.py``: every edit-distance end that is a local minimum, or
every Hamming begin, within k, on both strands). A trial whose run reports
an overflow is counted and not compared, as in the JAX tool.

It runs on the card unless ``--device cpu`` is given (the plain versions).
``main`` returns (trials, failures, crashes); the command exits 1 on any
failure or crash.

Run:  python -m columba_tpu_torch.tools.fuzz_conformance [--device cpu]
          [--seeds N]
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback

import numpy as np

from columba_tpu_torch import native
from columba_tpu_torch.core import alphabet
from columba_tpu_torch.index.build import build_index_from_codes
from columba_tpu_torch.index.fmindex import FMIndex
from columba_tpu_torch.index.kmer import build_kmer_table
from columba_tpu_torch.search import pipeline
from columba_tpu_torch.search.scheme import get_scheme
from columba_tpu_torch.tools.oracle import (brute_edit_ends, brute_hamming,
                                            make_genome)

SEEDS = 40
TRIALS = 2               # trials a seed
READS = 6                # reads a trial
SCHEMES = ["kuch1", "kuch2", "kianfar", "pigeon", "01*0"]


def draw_trial(rng, g: np.ndarray) -> dict:
    """One trial's draws from ``rng``, in the JAX tool's order."""
    n = len(g)
    name = SCHEMES[int(rng.integers(0, 5))]
    k = int(rng.integers(1, 4))
    metric = ["edit", "hamming"][int(rng.integers(0, 2))]
    m = int(rng.integers(40, 110))
    sw = int(rng.choice([0, 4]))
    part = ["uniform", "dynamic", "static"][int(rng.integers(0, 3))]
    use_kt = bool(rng.integers(0, 2))
    reads = np.zeros((READS, m), np.uint8)
    for i in range(READS):
        # reads at the text's edges (occurrences at the genome start were
        # once lost in verify)
        if i == 0:
            s = int(rng.integers(0, 3))
        elif i == 1:
            s = n - m - 1
        else:
            s = int(rng.integers(0, n - m - 4))
        r = g[s:s + m].astype(np.int64).copy()
        for _ in range(int(rng.integers(0, k + 1))):
            j = int(rng.integers(0, len(r)))
            op = rng.random()
            if metric == "hamming" or op < 0.5:
                r[j] = (r[j] + 1 + int(rng.integers(0, 3))) % 4
            elif op < 0.75 and len(r) > 1:
                r = np.delete(r, j)
            else:
                r = np.insert(r, j, int(rng.integers(0, 4)))
        r = r[:m]
        if len(r) < m:
            r = np.concatenate([r, g[s + len(r):s + m]])
        reads[i] = r.astype(np.uint8)
    return dict(name=name, k=k, metric=metric, m=m, sw=sw, part=part,
                use_kt=use_kt, reads=reads)


def expected(g: np.ndarray, reads: np.ndarray, k: int, metric: str) -> set:
    """The oracle's (read, strand, end or begin, distance) set."""
    out = set()
    for i, r in enumerate(reads):
        for strand, rr in ((0, r), (1, alphabet.revcomp(r))):
            brute = brute_edit_ends if metric == "edit" else brute_hamming
            out |= {(i, strand, p, d) for p, d in brute(g, rr, k)}
    return out


def main(argv=None) -> tuple[int, int, int]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (the plain "
                         "versions)")
    ap.add_argument("--seeds", type=int, default=SEEDS,
                    help=f"seeds 0..N-1, {TRIALS} trials each "
                         f"(default {SEEDS})")
    args = ap.parse_args(argv)
    device = native.usable_device(args.device)
    t0 = time.time()
    trials = fails = crashes = 0
    for seed in range(args.seeds):
        rng = np.random.default_rng(1000 + seed)
        n = int(rng.integers(5000, 40000))
        g = make_genome(rng, n)
        index = FMIndex.from_arrays(build_index_from_codes(g), device)
        kt = build_kmer_table(index, 6)
        for _ in range(TRIALS):
            tr = draw_trial(rng, g)
            what = (f"seed={seed} {tr['name']} k={tr['k']} {tr['metric']} "
                    f"m={tr['m']} sw={tr['sw']} {tr['part']} "
                    f"kt={tr['use_kt']}")
            try:
                occs, stats = pipeline.match_all(
                    index, tr["reads"], get_scheme(tr["name"], tr["k"]),
                    metric=tr["metric"], redundancy_filter=False,
                    switchpoint=tr["sw"], partitioning=tr["part"],
                    kmer_table=kt if tr["use_kt"] else None)
            except Exception as e:          # noqa: BLE001 - counted, exit 1
                print(f"CRASH {what}: {e!r}")
                traceback.print_exc()
                crashes += 1
                continue
            trials += 1
            if stats["overflow"]:
                continue
            pos = occs.end if tr["metric"] == "edit" else occs.begin
            got = set(zip(occs.read_id.tolist(), occs.strand.tolist(),
                          pos.tolist(), occs.distance.tolist()))
            want = expected(g, tr["reads"], tr["k"], tr["metric"])
            if got != want:
                fails += 1
                print(f"MISMATCH {what}: missing={len(want - got)} "
                      f"spurious={len(got - want)}")
                for x in sorted(want - got)[:3]:
                    print("   missing", x)
                for x in sorted(got - want)[:3]:
                    print("   spurious", x)
    print(f"fuzz done on {device.type}: {trials} trials, {fails} failures, "
          f"{crashes} crashes in {time.time() - t0:.1f} s", flush=True)
    return trials, fails, crashes


if __name__ == "__main__":
    _, f, c = main()
    sys.exit(1 if f or c else 0)
