"""Where the time of ``cli align`` goes, on one CUDA device.

Run from the repository root on a machine with a CUDA device:

    python -m columba_tpu_torch.tools.profile_align [--out DIR]

It builds the smoke's workload (``tools/workload.py``: a random 128 Mbp
genome, Vanilla index with SA sparseness 4, 100 bp reads with 1 %
substitutions) and then measures, on ``align -a all -e 2 -S kuch1 -b 16384``
(the CLI's defaults: 10-mer seed table, in-text switchpoint 4):

1. end to end: ``cli align`` of 1,048,576 reads, twice, FASTQ in and SAM
   written, in reads/s;
2. a stage breakdown over 131,072 reads (the smoke's count): every stage of the CLI path
   run alone, one batch at a time, with the device synchronised around it,
   so each figure is that stage's serial cost (the CLI overlaps parse,
   dispatch and the emitter thread);
3. ``torch.profiler`` over one ``cli align`` of the 131,072 reads: device
   busy time is the sum of the device-side events, i.e. the rows with
   device time and no host time (kernels, copies, memsets). The ``aten::``
   rows are host ops whose device time is already in the kernels they
   launch, so they are left out; copies on the fetch stream that overlap
   compute count twice, so busy is an upper bound. The idle share is
   1 - busy / wall of the profiled align. The full table goes to
   ``--out/profile_table.txt``;
4. the peak device memory of one align of the 131,072 reads.

The heading line of each measurement names the card and its power limit.
It needs no JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 20260817
BATCH = 16384
K = 2
KMER_K = 10          # the CLI's default -K
SWITCHPOINT = 4      # the CLI's default -i
READS = 131_072      # breakdown, profile and memory
E2E_READS = 1_048_576
REPS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def stage_breakdown(fq: str, arrays, index, table) -> dict:
    """Serial ms of each stage of the CLI path over the reads of ``fq``.
    Capacities are sized as ``match_all_start`` sizes them; a batch that
    would need a lossless retry raises, since the CLI path would then run
    twice."""
    from columba_tpu_torch.core import alphabet
    from columba_tpu_torch.index.build import decoded_text
    from columba_tpu_torch.io import emit, fastq
    from columba_tpu_torch.ops import locate, verify
    from columba_tpu_torch.search import executor, pipeline
    from columba_tpu_torch.search.scheme import get_scheme

    dev = index.device
    sync = torch.cuda.synchronize
    ms = dict.fromkeys(
        ["parse (native FASTQ)", "search: exact prefix + band steps",
         "candidates + expand", "locate", "dedup", "verify",
         "fetch (device -> host)", "extract occurrences + boundary trim",
         "emit SAM (native, 3 threads)"], 0.0)
    names = list(ms)
    genome = decoded_text(arrays)

    t0 = time.perf_counter()
    batches = list(fastq.batches_native(fq, BATCH))
    ms[names[0]] = (time.perf_counter() - t0) * 1e3

    sched = pipeline.compile_cached(get_scheme("kuch1", K), 100, "edit",
                                    kmer_k=KMER_K)
    tables = executor.device_tables(sched, dev)
    n_occ = 0
    for b in batches:
        R = 2 * b.codes.shape[0]
        cap = max(1024, R * sched.num_searches // 8)
        ml = max(1 << 16, 4 * R)
        itv_cap, split, cap2 = pipeline.crossover_caps(cap, ml, SWITCHPOINT)
        codes = np.concatenate([b.codes, alphabet.revcomp(b.codes, axis=-1)])
        reads = torch.from_numpy(np.ascontiguousarray(codes)).to(dev)
        lap = [time.perf_counter()]

        def mark(i):
            sync()
            lap.append(time.perf_counter())
            ms[names[i]] += (lap[-1] - lap[-2]) * 1e3

        sync()
        lap[0] = time.perf_counter()
        res = executor.run_scheme(index, reads, sched, cap, table,
                                  SWITCHPOINT, itv_cap, split, cap2,
                                  itv_min_depth=16, tables=tables)
        mark(1)
        c_lo, c_hi, c_rid, c_estb = pipeline.stage_candidates(res, tables)
        rows, cand, valid, total = pipeline.stage_expand(c_lo, c_hi, ml)
        mark(2)
        pos = locate.locate_rows(index, rows)
        mark(3)
        rid_v, win_v, vlive, n_uniq = pipeline.stage_dedup(
            c_rid[cand], pos + c_estb[cand] - K, valid, ml)
        mark(4)
        final_rows = verify.verify_window(index, reads, rid_v, win_v, K)
        mark(5)
        out = pipeline.fetch_tree(dict(
            rid=rid_v, win_start=win_v, final_rows=final_rows, valid=vlive,
            total=total, n_unique=n_uniq, overflow=res.overflow))
        mark(6)
        if int(out["overflow"]) or int(out["total"]) > ml \
                or int(out["n_unique"]) > ml:
            raise RuntimeError("a batch needs a lossless retry; the "
                               "breakdown covers the path without one")
        occs = pipeline._extract_occurrences(out, b.codes.shape[0], 100, K, K)
        occs = pipeline.apply_boundary_trim(occs, b.codes, arrays, K, K)
        mark(7)
        nv = b.n_valid
        occs = occs.take(occs.read_id < nv)
        emit.emit_sam_native(b.codes[:nv], b.names_buf, b.name_offs,
                             b.quals_buf, b.qual_offs, occs, arrays, genome,
                             K, n_threads=3)
        mark(8)
        n_occ += len(occs)
    return dict(ms=ms, batches=len(batches), occurrences=n_occ)


def device_busy(prof) -> tuple[float, list]:
    """(device busy ms, [(ms, calls, name)] of the device-side events,
    largest first) from a finished ``torch.profiler`` run."""
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.self_cpu_time_total == 0]
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/profile",
                    help="directory for the profiler table")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_align: no CUDA device")

    from columba_tpu_torch import cli, native
    from columba_tpu_torch.index.build import decoded_text, load_index
    from columba_tpu_torch.index.fmindex import FMIndex
    from columba_tpu_torch.index.kmer import build_kmer_table_cached
    from columba_tpu_torch.tools import workload

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}")
    native.load_kernels()
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda:0")

    with tempfile.TemporaryDirectory(prefix="columba_profile_") as wd:
        rng = np.random.default_rng(SEED)
        fa, idx = os.path.join(wd, "genome.fa"), os.path.join(wd, "g.cidx")
        workload.write_genome(fa, rng)
        t0 = time.perf_counter()
        assert cli.main(["build", "-r", idx, "-f", fa]) == 0
        log(f"cli build of {workload.GENOME_N} bp: "
            f"{time.perf_counter() - t0:.3f} s")
        arrays = load_index(idx)
        reads = workload.sample_reads(decoded_text(arrays), arrays.seq_starts,
                                      E2E_READS, rng)[0]
        fq, fq_e = os.path.join(wd, "reads.fq"), os.path.join(wd, "e2e.fq")
        workload.write_fastq(fq, reads[:READS], "r")
        workload.write_fastq(fq_e, reads, "r")
        argv_al = ["align", "-r", idx, "-a", "all", "-e", str(K), "-S",
                   "kuch1", "-b", str(BATCH)]
        sam = os.path.join(wd, "out.sam")

        def align(path: str) -> float:
            torch.cuda.synchronize()
            t = time.perf_counter()
            assert cli.main(argv_al + ["-f", path, "-o", sam]) == 0
            torch.cuda.synchronize()
            return time.perf_counter() - t

        log(f"warm-up align: {align(fq):.4f} s")

        # 1. end to end
        for rep in range(REPS):
            dt = align(fq_e)
            log(f"{smi}: e2e {E2E_READS} reads in {dt:.4f} s = "
                f"{E2E_READS / dt:.1f} reads/s, "
                f"{os.path.getsize(sam)} SAM bytes (rep {rep})")

        # 2. stage breakdown
        index = FMIndex.from_arrays(arrays, dev)
        table = build_kmer_table_cached(index, KMER_K, idx)
        bd = stage_breakdown(fq, arrays, index, table)
        log(f"{smi}: stage breakdown over {READS} reads, "
            f"{bd['batches']} batches of {BATCH}, synchronous, "
            f"{bd['occurrences']} occurrences")
        for name, v in bd["ms"].items():
            log(f"  {name}: {v:.2f} ms")
        log(f"  sum: {sum(bd['ms'].values()):.2f} ms")

        # 3. profiled align
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = align(fq)
        busy, rows = device_busy(prof)
        log(f"{smi}: profiled align of {READS} reads: wall {wall:.4f} s; "
            f"device busy {busy:.3f} ms (sum of device-side events), busy "
            f"share {busy / 1e3 / wall:.4f}, idle share "
            f"{1 - busy / 1e3 / wall:.4f}")
        for t, cnt, name in rows[:20]:
            log(f"  {t:9.3f} ms x {cnt:5d}  {name[:90]}")
        with open(os.path.join(args.out, "profile_table.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=80,
                max_name_column_width=100))

        # 4. peak device memory of one align
        torch.cuda.reset_peak_memory_stats()
        align(fq)
        log(f"{smi}: peak device memory allocated during one align of "
            f"{READS} reads: {torch.cuda.max_memory_allocated()} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
