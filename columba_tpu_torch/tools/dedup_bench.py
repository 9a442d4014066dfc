"""Kernel L's sort and kernel K's frontier_tail entry on synthetic inputs at
SE ALL's sizes, on one CUDA device.

Run from the repository root on a machine with a CUDA device:

    python -m columba_tpu_torch.tools.dedup_bench [--reps N]

It prints the card's name and power limit, then ``torch.profiler``'s device
time (warm, the mean of ``--reps`` launches) of:

1. kernel L on ``tools/edges.py``'s "se_all" case (131,072 rows, 45,000
   valid, 32,768 read rows: 6 passes): ``dedup.keys``, each ``dedup.pass``,
   ``dedup.compact``, the whole ``stage_dedup`` and, beside it,
   ``torch.sort`` (stable) of every row's key, the library's sort the port
   ran before kernel L's passes;
2. kernel K's ``frontier_tail`` entry (``stage_tail_candidates``) on
   ``edges.tail_frontier``'s deferred final frontiers of C rows and M
   in-text rows, beside kernel J's own ``frontier.tail`` launch on the same
   frontier (what the fold saves is that launch, less what J's rows add to
   K's).

A tile shape is compared by running this on a copy of
``columba_tpu_torch/`` whose ``csrc`` constant was edited (e.g.
``kSortItems`` or ``kRound`` in ``csrc/dedup.cu``, with ``SORT_TILE`` in
``search/pipeline.py``), with ``PYTHONPATH`` set to the copy's parent, in
one call beside this tree. It needs no JAX.
"""

from __future__ import annotations

import argparse
import subprocess

import numpy as np
import torch

# (C, M) of the final frontiers: SE ALL after the shrink (C = 1,024, M =
# 131,072), a tile that holds frontier and in-text lanes, and wider ones
TAIL_SHAPES = ((1024, 131_072), (1500, 4096), (2048, 131_072),
               (4096, 131_072), (12_288, 131_072), (12_288, 4096),
               (49_152, 4096), (98_304, 4096))


def main(argv=None) -> int:
    from columba_tpu_torch.search import executor, pipeline
    from columba_tpu_torch.tools import edges, path_inputs

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    torch.cuda.init()        # raises where there is no CUDA device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    clocks = path_inputs.Clocks(args.reps)

    rid, win, valid, mv, rows, total = edges.dedup_case("se_all")
    g = [x.cuda() for x in (rid, win, valid)]
    tot = total.cuda()
    L = rid.shape[0]
    key = [torch.empty(L, dtype=torch.int64, device="cuda")
           for _ in range(2)]
    row = [torch.empty(L, dtype=torch.int32, device="cuda")
           for _ in range(2)]

    def keys():
        return pipeline.dedup_keys(*g, mv, key[0], row[0], rows, tot)

    n, starts, outs = keys()
    P = starts.shape[0]
    passes = [lambda p=p: pipeline.dedup_pass(
        key[p % 2], row[p % 2], n, starts, p, key[1 - p % 2],
        row[1 - p % 2]) for p in range(P)]
    for f in passes:
        f()

    def compact():
        return pipeline.dedup_compact(key[P % 2], row[P % 2], n, g[1], outs)

    every = torch.where(g[2], (g[0] << 32) | (g[1] & 0xFFFFFFFF),
                        (1 << 62) | 0xFFFFFFFF)
    pt = [clocks.profiled(f, "pass_kernel", False) for f in passes]
    print(f"{smi}: kernel L, {L} rows, {int(valid.sum())} valid, {rows} "
          f"read rows, {P} passes: keys "
          f"{clocks.profiled(keys, 'keys_kernel', False):.5f} ms; passes "
          + " ".join(f"{t:.5f}" for t in pt) + f" (sum {sum(pt):.5f}); "
          f"compact {clocks.profiled(compact, 'compact_kernel', False):.5f};"
          f" stage_dedup "
          f"{clocks.device_ms(lambda: pipeline.stage_dedup(*g, mv, rows, tot)):.5f};"
          f" torch.sort of every row's key "
          f"{clocks.device_ms(lambda: torch.sort(every, stable=True)):.5f}",
          flush=True)

    R, S = 32_768, 3
    for C, M in TAIL_SHAPES:
        rng = np.random.default_rng(C + M)
        res, tables = edges.tail_frontier(rng, C, M, True, R, S, "cuda")
        fused, own = path_inputs.copies(res), path_inputs.copies(res)

        def fold():
            return pipeline.stage_tail_candidates(fused, tables, S, 131_072)

        def tail():
            return executor.frontier_tail(**own.tail)

        fold()
        tail()
        ghosts = int(own.tail["words"][6]) - (int(own.tail["words"][0]) >> 32)
        print(f"{smi}: C = {C}, M = {M}, {ghosts} ghosts: frontier_tail "
              f"{clocks.profiled(fold, 'frontier_kernel', False):.5f} ms; "
              f"J's own tail {clocks.profiled(tail, 'tail_kernel', False):.5f}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
