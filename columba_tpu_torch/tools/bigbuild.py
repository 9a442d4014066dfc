"""Build and align a GRCh38-scale (>= 3 Gbp) synthetic genome end to end.

The port's counterpart of the JAX package's ``tools/bigbuild.py``: it proves
the uint32 index path above 2^31 bases on the card. It makes a genome of
``--gbp`` billion random bases in sequences of 2^27 bp (``synth_genome``,
seed 20260819), indexes it (native SA-IS, chunked packing), puts the index
on the device, maps sampled reads (seed 7) at k = 2 edit with
``pipeline.match_all`` and checks that at least 99 % of them are found
within k of their sampled begin. ``--blocks`` builds a block-partitioned
index instead (``index/blocked.py``) and aligns through the blocked CLI
path: the regime past one index's 4.29 Gbp uint32 ceiling.

Usage (the card is the default device; ``--device cpu`` runs the kernels'
plain versions):

  python -m columba_tpu_torch.tools.bigbuild [--gbp 3.1] [--reads 2000]
  python -m columba_tpu_torch.tools.bigbuild --gbp 0.0004 --reads 64 \\
      --device cpu                                  # a small run on the CPU
  python -m columba_tpu_torch.tools.bigbuild --gbp 6.0 --blocks

The genome's index persists under ``--cache`` (default
``columba_tpu_torch/_build/bigidx``, which git ignores); a second run loads
it and only aligns. The last line of stdout is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

CHROMO = 1 << 27  # bases per synthetic sequence ("chromosome")
GENOME_SEED = 20260819
READ_SEED = 7
MIN_RECALL = 0.99


def default_cache() -> str:
    from columba_tpu_torch import native

    return os.path.join(native.BUILD_DIR, "bigidx")


def synth_genome(n_total: int, seed: int = GENOME_SEED
                 ) -> tuple[np.ndarray, list, np.ndarray]:
    """Random genome of ``n_total`` bases in sequences of ``CHROMO`` bases
    (the last one shorter), drawn a sequence at a time. Returns (uint8 codes,
    names ``chr1``.., int64 starts with the end appended)."""
    rng = np.random.default_rng(seed)
    codes = np.empty(n_total, dtype=np.uint8)
    for lo in range(0, n_total, CHROMO):
        hi = min(lo + CHROMO, n_total)
        codes[lo:hi] = rng.integers(0, 4, size=hi - lo, dtype=np.int64)
    starts = list(range(0, n_total, CHROMO)) + [n_total]
    names = [f"chr{i + 1}" for i in range(len(starts) - 1)]
    return codes, names, np.asarray(starts, dtype=np.int64)


def sample_begins(n: int, R: int, m: int, rng) -> np.ndarray:
    """``R`` read begins in [0, n - m - 8), none within m + 8 of a sequence
    end (sequences start at multiples of ``CHROMO``)."""
    begins = rng.integers(0, n - m - 8, size=R)
    bad = (begins % CHROMO) > (CHROMO - m - 8)
    begins[bad] -= m + 8
    return begins


def mutate(seq: np.ndarray, m: int, k: int, rng) -> np.ndarray:
    """About 1 % substitutions (at most k), then the reverse complement half
    of the time: the draws of the JAX tool, in its order."""
    from columba_tpu_torch.core import alphabet

    nerr = int(rng.poisson(0.01 * m))
    for _ in range(min(nerr, k)):
        j = int(rng.integers(0, m))
        seq[j] = (seq[j] + 1 + rng.integers(0, 3)) % 4
    if rng.random() < 0.5:
        seq = np.asarray(alphabet.revcomp(seq))
    return seq


def sample_reads(words: np.ndarray, n: int, R: int, m: int, k: int,
                 seed: int = READ_SEED) -> tuple[np.ndarray, np.ndarray]:
    """(R, m) uint8 reads from the packed text ``words`` of ``n`` bases and
    their sampled begins."""
    from columba_tpu_torch.index.build import unpack_2bit

    rng = np.random.default_rng(seed)
    begins = sample_begins(n, R, m, rng)
    reads = np.empty((R, m), dtype=np.uint8)
    for i, s in enumerate(begins):
        w0 = int(s) // 16
        chunk = unpack_2bit(words[w0:w0 + m // 16 + 2], m + 16)
        reads[i] = mutate(chunk[int(s) % 16:int(s) % 16 + m].copy(), m, k,
                          rng)
    return reads, begins


def recall_at_truth(read_id, begin, begins: np.ndarray, k: int) -> float:
    """Share of reads with an occurrence that begins within k of the
    sampled begin."""
    read_id = np.asarray(read_id, np.int64)
    near = np.abs(np.asarray(begin, np.int64) - begins[read_id]) <= k
    found = np.zeros(len(begins), dtype=bool)
    found[read_id[near]] = True
    return float(found.mean())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m columba_tpu_torch.tools.bigbuild",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--gbp", type=float, default=3.1)
    ap.add_argument("--reads", type=int, default=2000)
    ap.add_argument("--read-len", type=int, default=100)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--cache", default=None,
                    help="index directory's parent (default: "
                         "columba_tpu_torch/_build/bigidx)")
    ap.add_argument("--sa-sparseness", type=int, default=16)
    ap.add_argument("--skip-align", action="store_true")
    ap.add_argument("--blocks", action="store_true",
                    help="block-partitioned index: the path past the 4.29 "
                         "Gbp uint32 ceiling (use with --gbp > 4.3)")
    ap.add_argument("--block-bp", type=int, default=None,
                    help="max bp per block (default: the uint32 MAX_N)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    args.cache = args.cache or default_cache()
    if args.blocks:
        return main_blocks(args)

    from columba_tpu_torch.index.build import (
        build_index_from_codes, load_index, save_index,
    )

    n_total = int(args.gbp * 1e9)
    os.makedirs(args.cache, exist_ok=True)
    idx_dir = os.path.join(args.cache, f"idx_{n_total}.cidx")
    if os.path.exists(os.path.join(idx_dir, "meta.json")):
        print(f"[bigbuild] loading cached index {idx_dir}", file=sys.stderr)
        arrays = load_index(idx_dir)
    else:
        print(f"[bigbuild] generating {n_total / 1e9:.2f} Gbp genome",
              file=sys.stderr)
        codes, names, starts = synth_genome(n_total)
        t1 = time.time()
        print(f"[bigbuild] building index (n={n_total}, "
              f"s={args.sa_sparseness})", file=sys.stderr)
        arrays = build_index_from_codes(
            codes, names, starts, sa_sparseness=args.sa_sparseness)
        del codes
        build_s = time.time() - t1
        print(f"[bigbuild] index built in {build_s:.1f} s "
              f"({n_total / build_s / 1e6:.2f} Mbp/s)", file=sys.stderr)
        save_index(arrays, idx_dir)
        print(f"[bigbuild] saved -> {idx_dir}", file=sys.stderr)
    if args.skip_align:
        return 0

    reads, begins = sample_reads(arrays.text, arrays.n, args.reads,
                                 args.read_len, args.k)

    from columba_tpu_torch import native
    from columba_tpu_torch.index.fmindex import FMIndex
    from columba_tpu_torch.search import pipeline
    from columba_tpu_torch.search.scheme import get_scheme

    device = native.usable_device(args.device)
    t2 = time.time()
    index = FMIndex.from_arrays(arrays, device)
    print(f"[bigbuild] index on {device}: {index.nbytes()} bytes (put in "
          f"{time.time() - t2:.1f} s)", file=sys.stderr)
    scheme = get_scheme("kuch1", args.k)
    t3 = time.time()
    occs, stats = pipeline.match_all(
        index, reads, scheme, metric="edit", switchpoint=4)
    dt = time.time() - t3
    recall = recall_at_truth(occs.read_id, occs.begin, begins, args.k)
    print(f"[bigbuild] aligned {args.reads} reads in {dt:.1f} s "
          f"(first call: kernel loads included): recall={recall:.4f} "
          f"occs={len(occs)} stats={stats}", file=sys.stderr)
    print(json.dumps({
        "n": int(arrays.n), "reads": args.reads, "k": args.k,
        "recall_at_truth": recall,
        "total_candidates": stats["total_candidates"],
        "overflow": stats["overflow"],
    }))
    if recall < MIN_RECALL:
        raise AssertionError(f"recall {recall} below {MIN_RECALL}: the "
                             "uint32 path is broken")
    print("[bigbuild] PASS", file=sys.stderr)
    return 0


def main_blocks(args) -> int:
    """Build and align past the 4.29 Gbp single-index ceiling: a blocked
    index and the streamed blocked CLI align, recall checked against the
    sampled truth."""
    from columba_tpu_torch import cli
    from columba_tpu_torch.index import blocked
    from columba_tpu_torch.index.build import MAX_N

    n_total = int(args.gbp * 1e9)
    os.makedirs(args.cache, exist_ok=True)
    idx_dir = os.path.join(args.cache, f"blk_{n_total}")
    build_s = None
    if not os.path.exists(os.path.join(idx_dir, "meta.json")):
        print(f"[bigbuild] generating {n_total / 1e9:.2f} Gbp genome",
              file=sys.stderr)
        codes, names, starts = synth_genome(n_total)
        t1 = time.time()
        block_bp = args.block_bp or MAX_N
        print(f"[bigbuild] building blocked index (n={n_total}, "
              f"block_bp={block_bp}, s={args.sa_sparseness})",
              file=sys.stderr)
        meta = blocked.build_blocked_from_codes(
            codes, names, starts, idx_dir, max_block_bp=block_bp,
            sa_sparseness=args.sa_sparseness)
        build_s = time.time() - t1
        print(f"[bigbuild] blocked index built in {build_s:.1f} s "
              f"({n_total / build_s / 1e6:.2f} Mbp/s), "
              f"{len(meta['blocks'])} blocks", file=sys.stderr)
        del codes
    meta = blocked.load_blocked_meta(idx_dir)
    if meta["n"] != n_total:
        raise ValueError(f"cached index holds {meta['n']} bases, not "
                         f"{n_total}")
    past_ceiling = n_total > MAX_N
    print(f"[bigbuild] n={n_total} "
          f"({'PAST' if past_ceiling else 'below'} the 4.29 Gbp ceiling), "
          f"{len(meta['blocks'])} blocks", file=sys.stderr)
    if args.skip_align:
        return 0

    # reads with their truth from the memory-mapped packed block texts
    rng = np.random.default_rng(READ_SEED)
    m, R = args.read_len, args.reads
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    text = blocked.LazyBlockText(idx_dir, meta)
    begins = sample_begins(n_total, R, m, rng)
    fq = os.path.join(args.cache, f"blk_{n_total}_reads.fq")
    with open(fq, "w") as f:
        for i, s in enumerate(begins):
            seq = mutate(np.array(text[int(s):int(s) + m]), m, args.k, rng)
            f.write(f"@r{i}\n{lut[seq].tobytes().decode()}\n+\n{'I' * m}\n")

    out = os.path.join(args.cache, f"blk_{n_total}_out.sam")
    t3 = time.time()
    rc = cli.main(["align", "-r", idx_dir, "-f", fq, "-o", out,
                   "-e", str(args.k), "-a", "all", "-m", "edit",
                   "-S", "kuch1", "-b", "4096", "-v",
                   "--device", args.device])
    dt = time.time() - t3
    if rc != 0:
        raise AssertionError(f"cli align returned {rc}")

    # recall: a record within k of the sampled begin
    view = blocked.make_view(idx_dir, meta)
    seq_off = {name: int(off) for name, off in
               zip(view.seq_names, view.seq_starts[:-1])}
    rid, gpos = [], []
    with open(out) as f:
        for line in f:
            if line.startswith("@"):
                continue
            fld = line.split("\t", 4)
            if fld[2] == "*":
                continue
            rid.append(int(fld[0][1:]))
            gpos.append(seq_off[fld[2]] + int(fld[3]) - 1)
    recall = recall_at_truth(rid, gpos, begins, args.k)
    res = {
        "n": n_total, "blocks": len(meta["blocks"]),
        "past_uint32_ceiling": bool(past_ceiling),
        "reads": R, "k": args.k, "recall_at_truth": recall,
        "align_secs": round(dt, 1),
        "align_reads_per_sec": round(R / dt, 1),
    }
    if build_s is not None:
        res["build_secs"] = round(build_s, 1)
    print(json.dumps(res))
    if recall < MIN_RECALL:
        raise AssertionError(f"recall {recall} below {MIN_RECALL}: the "
                             "blocked path is broken")
    print("[bigbuild] PASS (blocked)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
