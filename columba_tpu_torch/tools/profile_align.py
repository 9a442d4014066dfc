"""Where the time of ``cli align`` goes, on one CUDA device.

Run from the repository root on a machine with a CUDA device:

    python -m columba_tpu_torch.tools.profile_align [--out DIR]
        [--mode all|best] [--paired] [--partitioning uniform|static|dynamic]
        [--flavor vanilla|rlc|textless]

It builds the smoke's workload (``tools/workload.py``: a random 128 Mbp
genome, Vanilla index with SA sparseness 4, 100 bp reads with 1 %
substitutions; with ``--paired``, ``fr`` pairs of such mates; with
``--flavor rlc`` or ``textless`` the 128 Mbp pan-genome of 20 haplotypes
and its ``--rlc`` or ``--rlc --textless`` index, aligned with ``-nD`` as
the JAX package's RLC bench does) and then
measures, on ``align -a all -e 2 -S kuch1 -b 16384`` or, with ``--mode
best``, ``align -a best -S kuch1 -b 16384`` (the CLI's defaults: 10-mer
seed table, in-text switchpoint 4, 95 % identity; paired-end with insert
inference on; ``--partitioning`` passes ``-p``, and under ``dynamic`` the
stage breakdown shows the partition and table stage, kernels F and G,
beside search):

1. end to end: ``cli align`` of 1,048,576 reads, or of 524,288 pairs
   (RLC: 262,144 reads or 131,072 pairs, textless 131,072 reads: the
   pan-genome's ~18 records a read, and the textless path's Python
   emitter, make each read cost more), twice, FASTQ in and SAM written, in
   reads/s or pairs/s;
2. a stage breakdown over 131,072 reads or pairs (the smoke's count). The
   stages differ from batch to batch (rungs, escalations, pairing), so one
   ``cli align`` runs with every stage function wrapped in a timer that
   synchronises the device before and after: the figures are each stage's
   serial cost inside that align (the CLI overlaps parse, dispatch and the
   emitter thread), and the wrapped align's wall time is printed beside
   them (the synchronisation removes the overlap, so it is slower than the
   plain align);
3. ``torch.profiler`` over one ``cli align`` of the 131,072 reads: device
   busy time is the sum of the device-side events, i.e. the rows with
   device time and no host time (kernels, copies, memsets). The ``aten::``
   rows are host ops whose device time is already in the kernels they
   launch, so they are left out; copies on the fetch stream that overlap
   compute count twice, so busy is an upper bound. The idle share is
   1 - busy / wall of the profiled align. The full table goes to
   ``--out/profile_table.txt``. The same run counts the CUDA runtime calls
   the host makes inside ``executor.run_scheme`` (launches, copies,
   synchronisations) and kernels A's and B's launches, and prints the
   calls per band step;
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
READS = 131_072      # breakdown, profile and memory
E2E_READS = {"vanilla": 1_048_576, "rlc": 262_144, "textless": 131_072}
E2E_PAIRS = {"vanilla": 524_288, "rlc": 131_072}    # textless is SE only
REPS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


# (module path, attribute, stage name) of every stage function of the CLI
# paths; a name may cover several functions
STAGES = [
    ("columba_tpu_torch.io.fastq", "_parse_chunk", "parse (native FASTQ)"),
    ("columba_tpu_torch.search.dynschedule", "dynamic_partition",
     "partition + tables (kernels F, G)"),
    ("columba_tpu_torch.search.dynschedule", "build_tables",
     "partition + tables (kernels F, G)"),
    ("columba_tpu_torch.search.pipeline", "select_schemes",
     "scheme selection probe (kernel E with lengths)"),
    ("columba_tpu_torch.search.executor", "run_scheme",
     "search: exact prefix + band steps"),
    ("columba_tpu_torch.ops.extend", "exact_match", "exact pass (kernel E)"),
    ("columba_tpu_torch.search.pipeline", "stage_tail_candidates",
     "candidates + expand"),
    ("columba_tpu_torch.search.pipeline", "expand_scan",
     "candidates + expand"),
    ("columba_tpu_torch.search.pipeline", "expand_rows",
     "candidates + expand"),
    ("columba_tpu_torch.ops.locate", "locate_rows", "locate"),
    ("columba_tpu_torch.search.pipeline", "stage_dedup", "dedup"),
    ("columba_tpu_torch.ops.verify", "verify_window", "verify"),
    ("columba_tpu_torch.search.pipeline", "fetch_tree",
     "fetch (device -> host)"),
    ("columba_tpu_torch.search.pipeline", "_extract_occurrences",
     "extract occurrences + boundary trim"),
    ("columba_tpu_torch.search.pipeline", "apply_boundary_trim",
     "extract occurrences + boundary trim"),
    ("columba_tpu_torch.search.pairing", "concordant_pairs",
     "pairing (window join + best filter)"),
    ("columba_tpu_torch.search.pairing", "best_filter",
     "pairing (window join + best filter)"),
    ("columba_tpu_torch.io.emit", "emit_sam_native",
     "emit SAM (native, 3 threads)"),
    ("columba_tpu_torch.io.emit", "emit_sam_pe_soa",
     "emit SAM (native, 3 threads)"),
    ("columba_tpu_torch.search.pipeline", "_phi_enumerate",
     "phi locate (textless, host numpy)"),
    ("columba_tpu_torch.search.strategy", "emit_sam_textless",
     "emit SAM (textless, Python)"),
]


def wrapped_breakdown(run_align) -> dict:
    """Serial ms of each stage inside one ``cli align``: every stage
    function is swapped for a wrapper that synchronises the device, times
    the call, and synchronises again. Returns the per-stage sums, the call
    counts and the wrapped align's wall time."""
    import importlib
    import threading

    ms: dict = {}
    calls: dict = {}
    lock = threading.Lock()
    undo = []

    def wrap(fn, stage):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t) * 1e3
            with lock:
                ms[stage] = ms.get(stage, 0.0) + dt
                calls[stage] = calls.get(stage, 0) + 1
            return out
        return timed

    for mod_name, attr, stage in STAGES:
        mod = importlib.import_module(mod_name)
        undo.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, wrap(getattr(mod, attr), stage))
    try:
        wall = run_align()
    finally:
        for mod, attr, fn in undo:
            setattr(mod, attr, fn)
    return dict(ms=ms, calls=calls, wall=wall)


def device_busy(prof) -> tuple[float, list]:
    """(device busy ms, [(ms, calls, name)] of the device-side events,
    largest first) from a finished ``torch.profiler`` run. The device span
    of the ``run_scheme`` records (a label over the kernels it covers, not
    work of its own) is left out."""
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.self_cpu_time_total == 0
            and e.key != "run_scheme"]
    rows.sort(reverse=True)
    return sum(r[0] for r in rows), rows


def search_calls(prof) -> dict:
    """CUDA runtime calls the host made inside ``run_scheme`` (the host
    ranges of the ``run_scheme`` profiler records), by name, from a
    finished ``torch.profiler`` run: kernel launches (ATen's and, where the
    tracer sees them, the port's), copies, memsets and synchronisations."""
    import bisect

    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == "run_scheme")
    starts = [s for s, _ in spans]
    calls: dict = {}
    for e in events:
        if not e.name.startswith("cu"):
            continue
        t = e.time_range.start
        j = bisect.bisect_right(starts, t) - 1
        if j >= 0 and t < spans[j][1]:
            calls[e.name] = calls.get(e.name, 0) + 1
    return calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/profile",
                    help="directory for the profiler table")
    ap.add_argument("--mode", choices=["all", "best"], default="all")
    ap.add_argument("--paired", action="store_true",
                    help="paired-end: fr pairs of 100 bp mates")
    ap.add_argument("--partitioning", default="uniform",
                    choices=["uniform", "static", "dynamic"],
                    help="the align's -p")
    ap.add_argument("--flavor", default="vanilla",
                    choices=["vanilla", "rlc", "textless"],
                    help="the index: Vanilla on the random genome, or RLC / "
                         "textless RLC on the pan-genome")
    args = ap.parse_args(argv)
    if args.paired and args.flavor not in E2E_PAIRS:
        ap.error(f"--paired does not run on a {args.flavor} index")
    torch.cuda.init()        # raises where there is no CUDA device

    from columba_tpu_torch import cli, native
    from columba_tpu_torch.index.build import decoded_text, load_index
    from columba_tpu_torch.tools import workload

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}")
    native.load_kernels()
    os.makedirs(args.out, exist_ok=True)

    with tempfile.TemporaryDirectory(prefix="columba_profile_") as wd:
        rng = np.random.default_rng(SEED)
        fa, idx = os.path.join(wd, "genome.fa"), os.path.join(wd, "g.cidx")
        if args.flavor == "vanilla":
            workload.write_genome(fa, rng)
            build = []
        else:
            pan = workload.pan_genome()
            workload.write_fasta(fa, pan, "pan")
            build = ["--rlc"] + (["--textless"] if args.flavor == "textless"
                                 else [])
        t0 = time.perf_counter()
        assert cli.main(["build", "-r", idx, "-f", fa] + build) == 0
        log(f"cli build {' '.join(build)} of {workload.GENOME_N} bp: "
            f"{time.perf_counter() - t0:.3f} s")
        if args.flavor == "vanilla":
            arrays = load_index(idx)
            text, starts = decoded_text(arrays), arrays.seq_starts
        else:
            text, starts = pan, np.array([0, len(pan)], np.int64)
        n_e2e = (E2E_PAIRS if args.paired else E2E_READS)[args.flavor]
        unit = "pairs" if args.paired else "reads"
        what = (f"{args.flavor} {'PE' if args.paired else 'SE'} "
                f"{'ALL k=' + str(K) if args.mode == 'all' else 'BEST'}"
                f" -p {args.partitioning}")
        sampler = workload.sample_pairs if args.paired \
            else workload.sample_reads
        sample = sampler(text, starts, n_e2e, rng)
        mates = sample[:2] if args.paired else sample[:1]
        fq, fq_e = [], []
        for i, codes in enumerate(mates):
            fq.append(os.path.join(wd, f"reads{i}.fq"))
            fq_e.append(os.path.join(wd, f"e2e{i}.fq"))
            workload.write_fastq(fq[-1], codes[:READS], "r")
            workload.write_fastq(fq_e[-1], codes, "r")
        argv_al = ["align", "-r", idx, "-S", "kuch1", "-b", str(BATCH)] + (
            ["-a", "all", "-e", str(K)] if args.mode == "all"
            else ["-a", "best"]) + ["-p", args.partitioning] + (
            ["-nD"] if args.flavor != "vanilla" else [])
        sam = os.path.join(wd, "out.sam")

        def align(paths: list) -> float:
            torch.cuda.synchronize()
            t = time.perf_counter()
            assert cli.main(argv_al + ["-f", paths[0], "-o", sam] + (
                ["-F", paths[1]] if args.paired else [])) == 0
            torch.cuda.synchronize()
            return time.perf_counter() - t

        log(f"warm-up align: {align(fq):.4f} s")

        # 1. end to end
        for rep in range(REPS):
            dt = align(fq_e)
            log(f"{smi}: {what} e2e {n_e2e} {unit} in {dt:.4f} s = "
                f"{n_e2e / dt:.1f} {unit}/s, "
                f"{os.path.getsize(sam)} SAM bytes (rep {rep})")

        # 2. stage breakdown
        wb = wrapped_breakdown(lambda: align(fq))
        log(f"{smi}: {what} stage breakdown inside one align of {READS} "
            f"{unit} (every stage call synchronised and timed; wall "
            f"{wb['wall']:.4f} s)")
        for name, v in sorted(wb["ms"].items(), key=lambda kv: -kv[1]):
            log(f"  {name}: {v:.2f} ms in {wb['calls'][name]} calls")
        log(f"  sum: {sum(wb['ms'].values()):.2f} ms")

        # 3. profiled align; run_scheme's host time ranges are kept, to
        # count the runtime calls of the search stage per band step
        from torch.profiler import ProfilerActivity, profile

        from columba_tpu_torch.search import executor

        run_scheme = executor.run_scheme
        n_runs = [0]

        def spanned(*a, **kw):
            n_runs[0] += 1
            with torch.profiler.record_function("run_scheme"):
                return run_scheme(*a, **kw)

        for k in native.KERNELS.values():
            k.reset()
        executor.run_scheme = spanned
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall = align(fq)
        finally:
            executor.run_scheme = run_scheme
        busy, rows = device_busy(prof)
        log(f"{smi}: {what} profiled align of {READS} {unit}: wall "
            f"{wall:.4f} s; "
            f"device busy {busy:.3f} ms (sum of device-side events), busy "
            f"share {busy / 1e3 / wall:.4f}, idle share "
            f"{1 - busy / 1e3 / wall:.4f}")
        for t, cnt, name in rows[:20]:
            log(f"  {t:9.3f} ms x {cnt:5d}  {name[:90]}")
        calls = search_calls(prof)
        band = native.KERNELS["band_step"].launches
        ours = sum(k.launches for k in native.KERNELS.values())
        kernel_a = native.KERNELS["extend"]
        log(f"{smi}: {what} search stage of the profiled align: "
            f"{n_runs[0]} run_scheme calls, kernel B {band} launches "
            f"(band steps), kernel A {kernel_a.launches} "
            f"({kernel_a.by_entry}), all the port's kernels {ours}; CUDA "
            f"runtime calls inside run_scheme: {calls}")
        if band:
            def per_step(word):
                return sum(n for name, n in calls.items()
                           if word in name) / band
            log(f"  per band step: {per_step('Launch'):.2f} kernel launches,"
                f" {per_step('Memcpy'):.2f} copies, "
                f"{per_step('Synchronize'):.2f} synchronisations")
        with open(os.path.join(args.out, "profile_table.txt"), "w") as f:
            f.write(prof.key_averages().table(
                sort_by="self_cuda_time_total", row_limit=80,
                max_name_column_width=100))

        # 4. peak device memory of one align
        torch.cuda.reset_peak_memory_stats()
        align(fq)
        log(f"{smi}: {what} peak device memory allocated during one align "
            f"of {READS} {unit}: {torch.cuda.max_memory_allocated()} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
