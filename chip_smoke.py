"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py`` on a machine with
a CUDA device. It

1. prints the card (torch name, and nvidia-smi's name and power limit);
2. builds the four CUDA kernels from ``columba_tpu_torch/csrc`` into
   ``columba_tpu_torch/_build``;
3. generates a random genome from a fixed seed (128 Mbp in 4 sequences, with
   runs of N), writes it as FASTA and builds the index with the port's
   ``cli build`` (default SA sparseness 4, so locate walks LF);
4. runs each kernel on the card at the main path's shapes and holds it
   against its plain PyTorch version on the same tensors (exact equality:
   all the arithmetic is integer), timing both with CUDA events;
5. drives the main path, ``cli align -a all -e 2 -S kuch1 -b 16384``, on
   131,072 sampled 100 bp reads (1% substitutions, half reverse-complemented),
   with every kernel's launch count reset just before;
6. checks that every read sampled with <= 2 substitutions is reported at its
   true locus, that all four kernels launched on the main path, and that one
   batch run through the plain versions on the card gives the same
   occurrences as the kernels.

The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failure raises, so the exit code is
non-zero and that line is not printed. It needs no network and no JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 20260817
N_READS = 131_072
READ_LEN = 100
K = 2
BATCH = 16384
WARMUP_READS = 16384


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` on the current stream (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_checks(index, arrays, reads, table) -> dict:
    """Each kernel vs its plain version on the card, at the main path's
    shapes (batch of 16384 reads, both strands, kuch1 k=2)."""
    from columba_tpu_torch.index import kmer
    from columba_tpu_torch.index.build import decoded_text
    from columba_tpu_torch.ops import extend, locate, verify
    from columba_tpu_torch.search import executor, pipeline
    from columba_tpu_torch.search.scheme import get_scheme

    dev = index.device
    rng = np.random.default_rng(SEED + 1)
    R = 2 * BATCH
    sched = pipeline.compile_cached(get_scheme("kuch1", K), READ_LEN, "edit",
                                    kmer_k=10)
    S = sched.num_searches
    C = max(1024, R * S // 8)                       # match_all's auto cap
    ml = max(1 << 16, 4 * R)                        # auto max_locate
    batch = torch.from_numpy(np.concatenate(
        [reads[:BATCH], reads[:BATCH, ::-1] ^ 3])).to(dev)
    # kernel A: real ranges (10-mer seeds of read windows), random
    # directions and chars (N included)
    row = torch.from_numpy(rng.integers(0, R, 2 * C)).to(dev)
    off = torch.from_numpy(rng.integers(0, READ_LEN - 10, 2 * C)).to(dev)
    ranges = kmer.lookup(table, batch[row[:, None],
                                      off[:, None] + torch.arange(10,
                                                                  device=dev)])
    dirs = torch.from_numpy(rng.integers(0, 2, 2 * C).astype(np.int32)).to(dev)
    chars = torch.from_numpy(rng.integers(0, 5, 2 * C).astype(np.int32)).to(dev)

    tables = executor.device_tables(sched, dev)
    t = sched.t_max // 2
    live = ranges[:C]
    ids = torch.from_numpy(rng.integers(0, R * S, C).astype(np.int32)).to(dev)
    band = torch.from_numpy(rng.integers(0, 4, (C, 2, sched.bw)).astype(
        np.int8)).to(dev)
    colmin = torch.from_numpy(rng.integers(0, 3, (C, 2, sched.W)).astype(
        np.int8)).to(dev)
    pchars = batch[:, tables["posw"]].to(torch.int8)
    pchars = torch.where(tables["code"][None] == 0, pchars,
                         tables["code"][None]).reshape(-1, sched.bw)
    band_args = (index, live, ids, band, colmin, tables["mrow"][t], pchars,
                 sched.t_max, t, 4)

    # kernel C: max_locate random SA rows
    rows = torch.from_numpy(rng.integers(0, index.n + 1, ml)).to(dev)
    # kernel D: max_locate candidates, each near its read's true locus
    text = decoded_text(arrays)
    true_pos = rng.integers(0, index.n - READ_LEN, R)
    pats = torch.from_numpy(np.ascontiguousarray(
        text[true_pos[:, None] + np.arange(READ_LEN)])).to(dev)
    rid_np = rng.integers(0, R, ml)
    rid = torch.from_numpy(rid_np).to(dev)
    ws = torch.from_numpy(true_pos[rid_np] - K + rng.integers(-2, 3, ml)
                          ).to(dev)

    cases = {
        "extend": (lambda: extend.extend_char(index, ranges, chars, dirs),
                   lambda: extend.extend_char_plain(index, ranges, chars,
                                                    dirs)),
        "band_step": (lambda: executor.band_step(*band_args),
                      lambda: executor.band_step_plain(*band_args)),
        "locate": (lambda: locate.locate_rows(index, rows),
                   lambda: locate.locate_rows_plain(index, rows)),
        "verify": (lambda: verify.verify_window(index, pats, rid, ws, K),
                   lambda: verify.verify_window_plain(index, pats, rid, ws,
                                                      K)),
    }
    shapes = {"extend": f"{2 * C} lanes", "band_step": f"C={C} lanes",
              "locate": f"{ml} rows", "verify": f"{ml} candidates, m=100"}
    report = {}
    for name, (kern, plain) in cases.items():
        a, b = kern(), plain()
        torch.cuda.synchronize()
        if isinstance(a, dict):
            diff = max(_max_abs(a[k], b[k]) for k in a)
        else:
            diff = _max_abs(a, b)
        if diff != 0:
            raise AssertionError(f"kernel {name} differs from its plain "
                                 f"version: max abs error {diff}")
        ms = cuda_time(kern, 20)
        plain_ms = cuda_time(plain, 5)
        log(f"kernel {name} ({shapes[name]}): equal to plain; "
            f"{ms:.4f} ms vs plain {plain_ms:.4f} ms")
        report[name] = dict(max_abs_err=diff, ms=ms, plain_ms=plain_ms)
    return report


def _max_abs(a, b) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def parse_sam(path: str):
    """(qname index, rname, pos1, flag) of every mapped record."""
    q, rn, p, fl = [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            c = line.split("\t", 4)
            if c[2] == "*":
                continue
            q.append(int(c[0][1:]))
            rn.append(int(c[2][3:]))
            p.append(int(c[3]))
            fl.append(int(c[1]))
    return (np.array(q, np.int64), np.array(rn, np.int64),
            np.array(p, np.int64), np.array(fl, np.int64))


def plain_patch():
    """Swap every kernel wrapper of the main path for its plain version
    (module attributes the pipeline calls through); returns the undo."""
    from columba_tpu_torch.ops import extend, locate, rank, verify
    from columba_tpu_torch.search import executor

    def locate_plain(index, rows):
        if index.sa_sparseness == 1:
            return rank.u32(index.sa_samples[rows])
        return locate.locate_rows_plain(index, rows)

    saved = [(extend, "extend_char", extend.extend_char_plain),
             (executor, "band_step", executor.band_step_plain),
             (locate, "locate_rows", locate_plain),
             (verify, "verify_window", verify.verify_window_plain)]
    undo = [(mod, name, getattr(mod, name)) for mod, name, _ in saved]
    for mod, name, fn in saved:
        setattr(mod, name, fn)

    def restore():
        for mod, name, fn in undo:
            setattr(mod, name, fn)
    return restore


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available"
                         "() is false); this script runs only on the card")
    from columba_tpu_torch import cli, native
    from columba_tpu_torch.index.build import decoded_text, load_index
    from columba_tpu_torch.index.fmindex import FMIndex
    from columba_tpu_torch.index.kmer import build_kmer_table_cached
    from columba_tpu_torch.search import pipeline
    from columba_tpu_torch.search.scheme import get_scheme
    from columba_tpu_torch.tools import workload

    t_all = time.time()
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(smi)

    t0 = time.time()
    native.load_kernels()
    log(f"kernels built in {time.time() - t0:.1f} s "
        f"(nvcc {native.build_seconds.get('kernels', 0.0):.1f} s)")
    for ln in native.build_log.get("kernels", "").splitlines():
        if "registers" in ln or "spill" in ln:
            log(f"  ptxas: {ln.strip()}")

    with tempfile.TemporaryDirectory(prefix="columba_smoke_") as wd:
        rng = np.random.default_rng(SEED)
        fa, idx = os.path.join(wd, "genome.fa"), os.path.join(wd, "g.cidx")
        t0 = time.time()
        workload.write_genome(fa, rng)
        log(f"genome: {workload.GENOME_N} bp in {workload.N_SEQS} sequences "
            f"with N runs (seed {SEED}), FASTA in {time.time() - t0:.1f} s")
        t0 = time.time()
        assert cli.main(["build", "-r", idx, "-f", fa]) == 0
        log(f"cli build (-s 4) in {time.time() - t0:.1f} s")

        arrays = load_index(idx)
        text = decoded_text(arrays)
        starts = arrays.seq_starts
        reads, pos, nsub, flip = workload.sample_reads(text, starts, N_READS,
                                                       rng, READ_LEN)
        fq, fq_w = os.path.join(wd, "reads.fq"), os.path.join(wd, "warm.fq")
        workload.write_fastq(fq, reads, "r")
        workload.write_fastq(fq_w, reads[:WARMUP_READS], "w")

        index = FMIndex.from_arrays(arrays, dev)
        table = build_kmer_table_cached(index, 10, idx)
        log(f"index on device: {index.nbytes()} bytes + k-mer table "
            f"{table.nbytes} bytes")
        report = kernel_checks(index, arrays, reads, table)

        argv = ["align", "-r", idx, "-a", "all", "-e", str(K), "-S",
                "kuch1", "-b", str(BATCH)]
        t0 = time.time()
        assert cli.main(argv + ["-f", fq_w, "-o",
                                os.path.join(wd, "warm.sam")]) == 0
        log(f"warm-up align ({WARMUP_READS} reads) in "
            f"{time.time() - t0:.1f} s")

        for k in native.KERNELS.values():
            k.launches = 0
        sam_path, log_path = os.path.join(wd, "out.sam"), \
            os.path.join(wd, "align.log")
        torch.cuda.synchronize()
        t0 = time.time()
        assert cli.main(argv + ["-f", fq, "-o", sam_path, "-v",
                                "-l", log_path]) == 0
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches = {k: v.launches for k, v in native.KERNELS.items()}
        with open(log_path) as f:
            retries = int(re.search(r"Lossless spill retries[^:]*: (\d+)",
                                    f.read()).group(1))
        log(f"main path: {N_READS} reads x {READ_LEN} bp in {dt:.3f} s = "
            f"{N_READS / dt:.1f} reads/s (FASTQ -> SAM, genome "
            f"{workload.GENOME_N} bp, {smi}); lossless retries {retries}; "
            f"kernel launches {launches}")

        # -- checks --
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"kernels not launched on the main path: "
                                 f"{missing}")
        q, rn, p1, fl = parse_sam(sam_path)
        seq_of = np.searchsorted(starts, pos, side="right") - 1
        want_p1 = pos - starts[seq_of] + 1
        key = q * 8 + (rn - 1) * 2 + (fl & 16 > 0)
        order = np.argsort(key, kind="stable")
        want = np.nonzero(nsub <= K)[0]
        wkey = want * 8 + seq_of[want] * 2 + flip[want]
        lo = np.searchsorted(key[order], wkey, side="left")
        hi = np.searchsorted(key[order], wkey, side="right")
        ps = p1[order]
        exact = near = 0
        lost = []
        for i, a, b in zip(want, lo, hi):
            d = np.abs(ps[a:b] - want_p1[i])
            if b > a and d.min() == 0:
                exact += 1
            elif b > a and d.min() <= K:
                # an error at a read end has equal-cost alignments that
                # begin up to k bases away; the traceback may pick one
                near += 1
            else:
                lost.append(int(i))
        log(f"lossless check: {len(want)} reads with <= {K} substitutions; "
            f"{exact} at their exact begin, {near} within {K} (end "
            f"errors), {len(lost)} missing")
        if lost:
            raise AssertionError(f"reads not found at their locus: "
                                 f"{lost[:10]}")

        # one batch again through the plain versions on the card
        scheme = get_scheme("kuch1", K)
        occ_k, _ = pipeline.match_all(index, reads[:BATCH], scheme,
                                      kmer_table=table, switchpoint=4)
        restore = plain_patch()
        try:
            occ_p, _ = pipeline.match_all(index, reads[:BATCH], scheme,
                                          kmer_table=table, switchpoint=4)
        finally:
            restore()
        for f in ("read_id", "strand", "begin", "end", "distance"):
            if not np.array_equal(getattr(occ_k, f), getattr(occ_p, f)):
                raise AssertionError(f"plain-path OccArray differs in {f}")
        log(f"plain versions on the card: identical OccArray for one batch "
            f"({len(occ_k)} occurrences)")

    kernels = []
    for k in native.KERNELS.values():
        r = report[k.name]
        kernels.append(dict(name=k.name, route="cuda", source=k.source,
                            replaces=k.replaces, launches=launches[k.name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"]))
    log(f"total smoke time {time.time() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
