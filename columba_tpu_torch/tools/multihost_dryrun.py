"""Two-rank dryrun of the port's data parallelism (``dist/multihost.py``).

The counterpart of ``tools/multihost_dryrun.py`` on ``torch.distributed``:

1. the orchestrator (no ``--proc``) picks a free loopback port and starts
   two rank processes; on the card it first builds (or loads) the CUDA
   kernels, so that the ranks never build them at once;
2. every rank joins the gloo process group, and builds the same small
   index from a seed or loads the persisted one of ``--index`` (as two
   hosts loading one index would), with its seed table: 6-mers on the
   built index, 10-mers (``cli align``'s default ``-K``) on a loaded one,
   rank 0 first, which writes the table's cache beside the index;
3. every rank takes its own reads: sampled with its own seed, or its slice
   of ``--reads`` (``--reads-per-rank`` each, in rank order), forward and
   reverse-complement rows as ``match_all`` feeds them;
4. ``sharded_match`` runs over the 2-rank mesh (seed table, in-text
   crossover at switchpoint 4, capacities sized as ``match_all_start``
   sizes them for the rank's rows), once to warm up and once timed, with
   the launch counts reset before; the counters are all-reduced;
5. each rank checks recall on its sampled reads (a read is found where a
   row of it has a valid window at its locus, within k), and rank 0
   gathers every rank's rows, occurrences and counters, leaves the group,
   runs the whole batch through a 2-shard ``make_data_mesh`` in its own
   process and requires the same (rid, window start) set, the same six
   counters and overflow 0.

Rank 0 prints one JSON line: ``ok``, ``ranks``, ``recalls`` (null for reads
from a file, whose loci are unknown), ``mapped`` (each rank's share of
reads with a valid window), ``total``, ``overflow``, each rank's reads/s
(the ranks share the machine, and on one card its time: not a chip rate),
peak device memory, index bytes, and launches of kernels A-D and I-L (by
kernel and by entry). ``--out FILE`` saves the occurrence set as an (N, 2) int64
``.npy``. Any rank's failure, or a wait past ``TIMEOUT`` seconds, exits
non-zero.

Run:  python -m columba_tpu_torch.tools.multihost_dryrun [--device cpu]
          [--index DIR --reads FASTQ] [--reads-per-rank N]
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

RANKS = 2
GENOME_BP = 200_000
GENOME_SEED = 777
READ_LEN = 80
K = 2
SWITCHPOINT = 4
KMER_BUILT = 6           # seed table k on the index built from GENOME_SEED
KMER_LOADED = 10         # on an --index: cli align's -K, cached beside it
# kernels A-D and I-L
KERNELS = ("extend", "band_step", "locate", "verify", "frontier", "expand",
           "dedup")
TIMEOUT = 600            # seconds the orchestrator waits for the ranks


def occurrences(res: dict) -> np.ndarray:
    """Sorted distinct (rid, window start) pairs of the valid slots."""
    v = res["valid"]
    return np.unique(np.stack([res["rid"][v], res["win_start"][v]], 1)
                     .astype(np.int64), axis=0).reshape(-1, 2)


def _local_reads(args, rank: int, genome):
    """This rank's forward reads and their sampled begins (None for reads
    from a file)."""
    if args.reads:
        from columba_tpu_torch.io.fastq import parse_reads

        lo, hi = rank * args.reads_per_rank, (rank + 1) * args.reads_per_rank
        codes = [r.codes for i, r in zip(range(hi), parse_reads(args.reads))
                 if i >= lo]
        if len(codes) != args.reads_per_rank:
            raise ValueError(f"{args.reads} holds fewer than {hi} reads")
        return np.stack(codes).astype(np.uint8), None
    rng = np.random.default_rng(1000 + rank)
    starts = rng.integers(0, len(genome) - READ_LEN, size=args.reads_per_rank)
    fwd = genome[starts[:, None] + np.arange(READ_LEN)].copy()
    for r in fwd:                      # up to K substitutions a read
        at = rng.choice(READ_LEN, int(rng.integers(0, K + 1)), replace=False)
        r[at] = (r[at] + 1) % 4
    return fwd, starts


def _hits(res: dict, base: int, R: int):
    """(read, window start) of the valid slots with at most K edits; read
    i of the rank has rows base + i and base + R + i."""
    v = res["valid"] & (res["final_rows"].min(axis=-1) <= K)
    return (res["rid"][v] - base) % R, res["win_start"][v]


def _recall(read, win, starts: np.ndarray) -> float:
    """Share of the sampled reads with a hit at their locus (the window
    begins K before the read, within K)."""
    near = np.abs(win + K - starts[read]) <= K
    return len(np.unique(read[near])) / len(starts)


def worker(args) -> int:
    from columba_tpu_torch import native
    from columba_tpu_torch.core import alphabet
    from columba_tpu_torch.dist import mesh as dmesh, multihost
    from columba_tpu_torch.index import kmer
    from columba_tpu_torch.index.build import (build_index_from_codes,
                                               load_index)
    from columba_tpu_torch.search import pipeline
    from columba_tpu_torch.search.scheme import get_scheme

    import torch.distributed as dist

    torch.set_num_threads(1)
    rank = args.proc
    multihost.initialize(args.init_method, RANKS, rank)
    mesh = multihost.global_mesh(args.device)
    dev = mesh.device
    genome = None
    if args.index:
        arrays = load_index(args.index)
    else:   # every rank builds the same index, as if it loaded one
        genome = np.random.default_rng(GENOME_SEED).integers(
            0, 4, GENOME_BP).astype(np.uint8)
        arrays = build_index_from_codes(genome)
    index = multihost.replicate(mesh, arrays)

    def table():
        if args.index:
            return kmer.build_kmer_table_cached(index, KMER_LOADED,
                                                args.index)
        return kmer.build_kmer_table(index, KMER_BUILT)

    # rank 0 first: it writes the cache that the other ranks then read
    kt = table() if rank == 0 else None
    dist.barrier()
    if kt is None:
        kt = table()

    fwd, starts = _local_reads(args, rank, genome)
    rows = np.concatenate([fwd, alphabet.revcomp(fwd, axis=-1)])
    m = rows.shape[1]
    sched = pipeline.compile_cached(get_scheme("kuch1", K), m, "edit",
                                    kmer_k=kmer.table_k(kt))
    cap = pipeline.batch_capacity(rows.shape[0], sched.num_searches,
                                  SWITCHPOINT)
    ml = pipeline.batch_max_locate(rows.shape[0], index)
    batch = multihost.shard_batch(mesh, rows)

    def run(mesh_, batch_):
        return multihost.local_out(dmesh.sharded_match(
            mesh_, index, batch_, sched, cap, ml, K, kmer_table=kt,
            switchpoint=SWITCHPOINT))

    run(mesh, batch)                   # warm-up: first launches, allocator
    for k in native.KERNELS.values():
        k.reset()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    dist.barrier()                     # both ranks start together
    t0 = time.perf_counter()
    res = run(mesh, batch)             # local_out waits for the device
    dt = time.perf_counter() - t0
    read, win = _hits(res, rank * rows.shape[0], len(fwd))
    mine = dict(
        rank=rank, rows=rows, occ=occurrences(res),
        counters={k: res[k] for k in dmesh.COUNTERS},
        recall=None if starts is None else _recall(read, win, starts),
        mapped=len(np.unique(read)) / len(fwd),
        reads_per_s=len(fwd) / dt,
        launches={k: native.KERNELS[k].launches for k in KERNELS},
        entries={f"{k}.{e}": n for k in KERNELS
                 for e, n in native.KERNELS[k].by_entry.items()},
        peak_bytes=(torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else None),
        index_bytes=index.nbytes() + kt.nbytes)
    gathered = [None] * RANKS
    dist.all_gather_object(gathered, mine)
    dist.destroy_process_group()
    if rank != 0:
        return 0

    # the whole batch through a 2-shard mesh in this process (no group)
    whole = np.concatenate([g["rows"] for g in gathered])
    ref = run(dmesh.make_data_mesh(RANKS, dev),
              torch.from_numpy(whole).to(dev))
    occ = np.concatenate([g["occ"] for g in gathered])
    same_occ = np.array_equal(occ, occurrences(ref))
    same_counts = all(g["counters"] == {k: ref[k] for k in dmesh.COUNTERS}
                      for g in gathered)
    recalls = [g["recall"] for g in gathered]
    ok = (same_occ and same_counts and ref["overflow"] == 0
          and all(r is None or r == 1.0 for r in recalls))
    if args.out:
        np.save(args.out, occ)
    print(json.dumps(dict(
        ok=bool(ok), ranks=RANKS, device=str(dev),
        kind=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu"),
        reads_per_rank=len(fwd), read_len=m, recalls=recalls,
        mapped=[g["mapped"] for g in gathered], total=ref["total"],
        overflow=ref["overflow"], occurrences=len(occ),
        same_occurrences=bool(same_occ), same_counters=bool(same_counts),
        capacity_per_shard=cap, max_locate_per_shard=ml,
        reads_per_s=[g["reads_per_s"] for g in gathered],
        peak_bytes=[g["peak_bytes"] for g in gathered],
        index_bytes=[g["index_bytes"] for g in gathered],
        launches=[g["launches"] for g in gathered],
        entries=[g["entries"] for g in gathered])), flush=True)
    return 0 if ok else 1


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def orchestrate(args, argv) -> int:
    if torch.device(args.device).type == "cuda":
        from columba_tpu_torch import native

        native.usable_device(args.device)
        native.load_kernels()
    init = f"tcp://127.0.0.1:{_free_port()}"
    cmd = [sys.executable, "-m", "columba_tpu_torch.tools.multihost_dryrun",
           *argv, "--init-method", init]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    procs = [subprocess.Popen(cmd + ["--proc", str(r)], cwd=root)
             for r in range(RANKS)]
    deadline = time.monotonic() + TIMEOUT
    try:
        while time.monotonic() < deadline:
            rcs = [p.poll() for p in procs]
            if any(rc not in (None, 0) for rc in rcs):
                break                  # one rank failed: stop the others
            if all(rc == 0 for rc in rcs):
                return 0
            time.sleep(0.1)
        print(f"multihost_dryrun: ranks exited {rcs} (None: still running "
              f"after a failure or past {TIMEOUT} s)", file=sys.stderr)
        return 1
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; card rank %% device count) or "
                         "cpu, the kernels' plain versions")
    ap.add_argument("--index", help="a persisted Vanilla index to load "
                    "(default: build one from a seed)")
    ap.add_argument("--reads", help="FASTQ or FASTA whose first "
                    "ranks x reads-per-rank reads the ranks take in order "
                    "(default: sample them from the index's genome)")
    ap.add_argument("--reads-per-rank", type=int, default=64)
    ap.add_argument("--out", help="save the occurrence set here (.npy)")
    ap.add_argument("--proc", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--init-method", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if bool(args.index) != bool(args.reads):
        ap.error("--index and --reads go together")
    if args.proc is not None:
        return worker(args)
    return orchestrate(args, argv)


if __name__ == "__main__":
    sys.exit(main())
