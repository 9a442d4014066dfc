"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py`` on a machine with
a CUDA device. It

1. prints the card (torch name, and nvidia-smi's name and power limit);
2. builds the five CUDA kernels from ``columba_tpu_torch/csrc`` into
   ``columba_tpu_torch/_build`` (one nvcc per source, started together) and
   prints ptxas's registers and spills per entry;
3. generates a random genome from a fixed seed (128 Mbp in 4 sequences, with
   runs of N), writes it as FASTA and builds the index with the port's
   ``cli build`` (default SA sparseness 4, so locate walks LF);
4. runs each kernel on the card at the paths' shapes and holds it against
   its plain PyTorch version on the same tensors (exact equality: all the
   arithmetic is integer), timing both with CUDA events, and works out the
   least time the card could take for the same call
   (``columba_tpu_torch/tools/bounds.py``). Kernels B and D are also held
   against their plain versions at the other band radii the paths reach and
   through their generic entries;
5. drives five paths through ``cli align``, each with every kernel's launch
   count reset just before and read just after, with its peak device memory:

   - SE ALL: ``-a all -e 2 -S kuch1 -b 16384`` on 65,536 sampled 100 bp reads
     (1% substitutions, half reverse-complemented);
   - SE BEST: ``-a best -S kuch1 -b 16384`` (the cutoff is 4) on 131,072 reads;
   - PE BEST: ``-a best -F ...`` with default flags (insert inference on,
     rungs (0,0) -> (2,2) -> (4,4)) on 131,072 ``fr`` pairs of 100 bp mates;
   - PE ALL at ``-e 0`` on the pairs sampled without a substitution, which
     takes the exact pass (kernel E) on both sides;
   - PE ALL at ``-e 2`` on the first 32,768 pairs: the band-only path (no
     in-text crossover, half-size frontier, two-stage exact loop);
6. checks each path's output against the sampled loci (nothing with few
   enough substitutions may be missing), that every kernel launched on the
   paths that should reach it, and that one batch run through the plain
   versions on the card gives the same occurrences as the kernels.

The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failure raises, so the exit code is
non-zero and that line is not printed. It needs no network and no JAX.
"""

from __future__ import annotations

import contextlib
import io
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
N_READS_ALL = 65_536     # the SE ALL path's share of the reads
N_PAIRS_E2 = 32_768      # the PE ALL -e 2 path's share of the pairs
READ_LEN = 100
K = 2
BEST_CUT = 4             # BEST cutoff of kuch1 at 100 bp and 95 % identity
BATCH = 16384
WARMUP_READS = 16384

# the kernels each path must launch at least once
PATH_KERNELS = {
    "se_all": ("extend", "band_step", "locate", "verify"),
    "se_best": ("extend", "band_step", "locate", "verify"),
    "pe_best": ("extend", "band_step", "locate", "verify"),
    "pe_all_e0": ("exact", "locate"),
    "pe_all_e2": ("extend", "band_step", "locate", "verify"),
}


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


def _max_abs(a, b) -> int:
    if isinstance(a, dict):
        return max(_max_abs(a[k], b[k]) for k in a)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def _band_args(index, sched, batch, ranges, rng, switchpoint):
    """One band step's inputs at the shapes ``match_all`` gives a batch:
    capacity C = rows x searches / 8, real ranges, the schedule's own step
    tables and cell codes, random band and register state."""
    from columba_tpu_torch.search import executor

    dev = index.device
    R, S = batch.shape[0], sched.num_searches
    C = max(1024, R * S // 8)
    tables = executor.device_tables(sched, dev)
    t = sched.t_max // 2
    ids = torch.from_numpy(rng.integers(0, R * S, C).astype(np.int32)).to(dev)
    band = torch.from_numpy(rng.integers(0, 4, (C, 2, sched.bw)).astype(
        np.int8)).to(dev)
    colmin = torch.from_numpy(rng.integers(0, 3, (C, 2, sched.W)).astype(
        np.int8)).to(dev)
    pchars = batch[:, tables["posw"]].to(torch.int8)
    pchars = torch.where(tables["code"][None] == 0, pchars,
                         tables["code"][None]).reshape(-1, sched.bw)
    return (index, ranges[:C].contiguous(), ids, band, colmin,
            tables["mrow"][t], pchars, sched.t_max, t, switchpoint)


def kernel_checks(index, arrays, reads, table) -> dict:
    """Each kernel vs its plain version on the card, at the paths' shapes
    (a batch of 16384 reads, both strands), with its bound."""
    from columba_tpu_torch.index import kmer
    from columba_tpu_torch.index.build import decoded_text
    from columba_tpu_torch.ops import extend, locate, verify
    from columba_tpu_torch.search import executor, pipeline
    from columba_tpu_torch.search.scheme import get_scheme
    from columba_tpu_torch.tools import bounds

    dev = index.device
    rng = np.random.default_rng(SEED + 1)
    R = 2 * BATCH
    sched = pipeline.compile_cached(get_scheme("kuch1", K), READ_LEN, "edit",
                                    kmer_k=10)
    C = max(1024, R * sched.num_searches // 8)      # match_all's auto cap
    ml = max(1 << 16, 4 * R)                        # auto max_locate
    batch = torch.from_numpy(np.concatenate(
        [reads[:BATCH], reads[:BATCH, ::-1] ^ 3])).to(dev)
    # kernel A: real ranges (10-mer seeds of read windows), random
    # directions and chars (N included)
    n_rng = 2 * R                                   # enough for k = 4 too
    row = torch.from_numpy(rng.integers(0, R, n_rng)).to(dev)
    off = torch.from_numpy(rng.integers(0, READ_LEN - 10, n_rng)).to(dev)
    all_ranges = kmer.lookup(table, batch[
        row[:, None], off[:, None] + torch.arange(10, device=dev)])
    ranges = all_ranges[:2 * C].contiguous()
    dirs = torch.from_numpy(rng.integers(0, 2, 2 * C).astype(np.int32)).to(dev)
    chars = torch.from_numpy(rng.integers(0, 5, 2 * C).astype(np.int32)).to(dev)
    band_args = _band_args(index, sched, batch, all_ranges, rng, 4)

    # kernel C: max_locate random SA rows; the dense suffix array, made by
    # kernel C itself, serves the one-gather library call
    rows = torch.from_numpy(rng.integers(0, index.n + 1, ml)).to(dev)
    # kernel D: max_locate candidates, each near its read's true locus
    text = decoded_text(arrays)
    true_pos = rng.integers(0, index.n - READ_LEN, R)
    pats = torch.from_numpy(np.ascontiguousarray(
        text[true_pos[:, None] + np.arange(READ_LEN)])).to(dev)
    rid_np = rng.integers(0, R, ml)
    rid = torch.from_numpy(rid_np).to(dev)

    def win_starts(kb):
        return torch.from_numpy(true_pos[rid_np] - kb
                                + rng.integers(-2, 3, ml)).to(dev)

    ws = win_starts(K)
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
        "exact": (lambda: extend.exact_match(index, batch),
                  lambda: extend.zero_empty(
                      extend.exact_match_plain(index, batch))),
    }
    shapes = {"extend": f"{2 * C} lanes", "band_step": f"C={C} lanes, "
              f"kb={K}, W={sched.W}", "locate": f"{ml} rows",
              "verify": f"{ml} candidates, m={READ_LEN}, kb={K}",
              "exact": f"{R} rows x {READ_LEN} bp"}

    def check(name, kern, plain, reps=20, plain_reps=5):
        a, b = kern(), plain()
        torch.cuda.synchronize()
        diff = _max_abs(a, b)
        if diff != 0:
            raise AssertionError(f"kernel {name} differs from its plain "
                                 f"version: max abs error {diff}")
        return a, dict(max_abs_err=diff, ms=cuda_time(kern, reps),
                       plain_ms=cuda_time(plain, plain_reps))

    report = {}
    for name, (kern, plain) in cases.items():
        out, rep = check(name, kern, plain,
                         plain_reps=2 if name == "exact" else 5)
        if name == "extend":
            b = bounds.extend(ranges, dirs, chars, out)
        elif name == "band_step":
            b = bounds.band_step(*band_args[1:6], out)
        elif name == "locate":
            _, steps = locate.locate_rows_plain(index, rows,
                                                return_steps=True)
            b = bounds.locate(rows, steps, out)
        elif name == "verify":
            b = bounds.verify(pats, rid, ws, K, out)
        else:
            b = bounds.exact(bounds.exact_steps(index, batch), R, out)
        rep.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                   bound_bytes=b["bytes"], bound_operations=b["operations"],
                   library_ms=None)
        report[name] = rep
        log(f"kernel {name} ({shapes[name]}): equal to plain; "
            f"{rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} ms; bound "
            f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({b['bytes']} bytes, "
            f"{b['operations']} operations), share "
            f"{b['bound_ms'] / rep['ms']:.4f}")

    # the library call of kernel C's function: with a dense suffix array,
    # SA[row] is one gather. The dense array comes from kernel C itself.
    dense = locate.locate_rows(
        index, torch.arange(index.n + 1, dtype=torch.int64, device=dev)
    ).to(torch.int32)
    want = locate.locate_rows(index, rows)
    if not torch.equal(dense[rows].long() & 0xFFFFFFFF, want):
        raise AssertionError("dense-SA gather differs from kernel C")
    report["locate"]["library_ms"] = cuda_time(lambda: dense[rows], 20)
    log(f"library call for locate (one gather from the dense SA, "
        f"{dense.numel()} entries): {report['locate']['library_ms']:.4f} ms")
    del dense

    # kernels B and D at the other shapes the paths reach, and through
    # their generic entries (runtime sizes)
    for scheme, k, metric, what in (
            ("kuch1", BEST_CUT, "edit", "BEST cutoff, templated"),
            ("kuch1", K, "hamming", "Hamming band, templated"),
            ("columba", 5, "edit", "generic entry")):
        sc = pipeline.compile_cached(get_scheme(scheme, k), READ_LEN, metric,
                                     kmer_k=10)
        args = _band_args(index, sc, batch, all_ranges, rng,
                          4 if metric == "edit" else 0)
        _, rep = check("band_step", lambda: executor.band_step(*args),
                       lambda: executor.band_step_plain(*args), plain_reps=3)
        log(f"kernel band_step at kb={(sc.bw - 1) // 2}, W={sc.W} ({what}; "
            f"{scheme} k={k} {metric}, C={args[1].shape[0]}): equal to "
            f"plain; {rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} ms")
    for kb, what in ((0, "templated"), (BEST_CUT, "templated"),
                     (5, "generic entry")):
        wsk = win_starts(kb)
        _, rep = check(
            "verify", lambda: verify.verify_window(index, pats, rid, wsk, kb),
            lambda: verify.verify_window_plain(index, pats, rid, wsk, kb),
            plain_reps=2)
        log(f"kernel verify at kb={kb} ({what}; {ml} candidates): equal to "
            f"plain; {rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} ms")
    return report


def ptxas_report(build_log: str) -> list:
    """One line per kernel entry of nvcc's ``-Xptxas -v`` output: the entry
    (template arguments in <>, -1 = the generic entry), its registers, and
    its stack frame and spills where there are any."""
    out, entry, frame = [], "", ""
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"\d([a-z_]+_kernel)(?:ILi(n?\d+)E(?:Li(n?\d+)E)?)?",
                          ln)
            args = [a.replace("n", "-") for a in m.groups()[1:] if a]
            entry = m.group(1) + (f"<{', '.join(args)}>" if args else "")
        elif "bytes stack frame" in ln:
            frame = "" if ln.strip().startswith("0 bytes stack frame, 0 bytes "
                                                "spill stores, 0 bytes spill "
                                                "loads") else ln.strip()
        elif "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{entry}: {regs} registers"
                       + (f"; {frame}" if frame else ", no spills"))
    return out


def parse_sam(path: str):
    """(qname index, rname index, pos1, flag, NM) of every mapped record."""
    q, rn, p, fl, nm = [], [], [], [], []
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
            nm.append(int(line[line.index("NM:i:") + 5:].split("\t", 1)[0]))
    return tuple(np.array(v, np.int64) for v in (q, rn, p, fl, nm))


def nearest(recs, want_key, want_p1):
    """For each wanted (key, pos) the smallest |pos - record pos| over the
    records with that key (a large number where there is none), and the
    smallest NM of those records. ``recs`` = (key, pos1, nm) arrays."""
    key, p1, nm = recs
    order = np.lexsort((p1, key))
    key, p1, nm = key[order], p1[order], nm[order]
    lo = np.searchsorted(key, want_key, side="left")
    hi = np.searchsorted(key, want_key, side="right")
    dist = np.full(len(want_key), 1 << 40, np.int64)
    best_nm = np.full(len(want_key), 1 << 40, np.int64)
    for i, (a, b) in enumerate(zip(lo, hi)):
        if b > a:
            dist[i] = np.abs(p1[a:b] - want_p1[i]).min()
            best_nm[i] = nm[a:b].min()
    return dist, best_nm


def plain_patch():
    """Swap every kernel wrapper of the paths for its plain version (module
    attributes the pipeline calls through); returns the undo."""
    from columba_tpu_torch.ops import extend, locate, rank, verify
    from columba_tpu_torch.search import executor

    def locate_plain(index, rows):
        if index.sa_sparseness == 1:
            return rank.u32(index.sa_samples[rows])
        return locate.locate_rows_plain(index, rows)

    def exact_plain(index, patterns):
        return extend.zero_empty(extend.exact_match_plain(index, patterns))

    saved = [(extend, "extend_char", extend.extend_char_plain),
             (extend, "exact_match", exact_plain),
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
    for ln in ptxas_report(native.build_log.get("kernels", "")):
        log(f"  ptxas {ln}")

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
        m1, m2, pos_f, pos_r, nsub1, nsub2, swapped = workload.sample_pairs(
            text, starts, N_READS, rng, READ_LEN)
        exact_pairs = np.nonzero((nsub1 == 0) & (nsub2 == 0))[0]

        def fq(tag, codes, prefix="r"):
            path = os.path.join(wd, tag + ".fq")
            workload.write_fastq(path, codes, prefix)
            return path

        files = {
            "se_all": (fq("all", reads[:N_READS_ALL]), None),
            "se_best": (fq("best", reads), None),
            "pe_best": (fq("p1", m1), fq("p2", m2)),
            "pe_all_e0": (fq("e1", m1[exact_pairs]), fq("e2", m2[exact_pairs])),
            "pe_all_e2": (fq("b1", m1[:N_PAIRS_E2]), fq("b2", m2[:N_PAIRS_E2])),
        }
        warm = {
            "se_all": (fq("w", reads[:WARMUP_READS], "w"), None),
            "pe_best": (fq("w1", m1[:WARMUP_READS], "w"),
                        fq("w2", m2[:WARMUP_READS], "w")),
        }
        warm["se_best"] = warm["se_all"]
        warm["pe_all_e0"] = (fq("we1", m1[exact_pairs[:4096]], "w"),
                             fq("we2", m2[exact_pairs[:4096]], "w"))
        warm["pe_all_e2"] = warm["pe_best"]
        argv_of = {
            "se_all": ["-a", "all", "-e", str(K)],
            "se_best": ["-a", "best"],
            "pe_best": ["-a", "best"],
            "pe_all_e0": ["-a", "all", "-e", "0"],
            "pe_all_e2": ["-a", "all", "-e", str(K)],
        }
        n_of = {"se_all": N_READS_ALL, "se_best": N_READS,
                "pe_best": N_READS, "pe_all_e0": len(exact_pairs),
                "pe_all_e2": N_PAIRS_E2}

        index = FMIndex.from_arrays(arrays, dev)
        table = build_kmer_table_cached(index, 10, idx)
        log(f"index on device: {index.nbytes()} bytes + k-mer table "
            f"{table.nbytes} bytes")
        report = kernel_checks(index, arrays, reads, table)

        def align(path, files_, out_tag, extra=()):
            argv = ["align", "-r", idx, "-S", "kuch1", "-b", str(BATCH),
                    "-f", files_[0], "-o", os.path.join(wd, out_tag + ".sam"),
                    *argv_of[path], *extra]
            if files_[1] is not None:
                argv += ["-F", files_[1]]
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = cli.main(argv)
            assert rc == 0
            return err.getvalue()

        launches_by_path = {}
        for path in PATH_KERNELS:
            t0 = time.time()
            align(path, warm[path], "warm")
            t_warm = time.time() - t0
            for k in native.KERNELS.values():
                k.launches = 0
            log_path = os.path.join(wd, path + ".log")
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.time()
            err = align(path, files[path], path, ("-v", "-l", log_path))
            torch.cuda.synchronize()
            dt = time.time() - t0
            launches = {k: v.launches for k, v in native.KERNELS.items()}
            launches_by_path[path] = launches
            peak = torch.cuda.max_memory_allocated()
            with open(log_path) as f:
                retries = int(re.search(
                    r"Lossless spill retries[^:]*: (\d+)", f.read()).group(1))
            unit = "pairs" if files[path][1] else "reads"
            log(f"path {path}: {n_of[path]} {unit} x {READ_LEN} bp in "
                f"{dt:.3f} s = {n_of[path] / dt:.1f} {unit}/s (FASTQ -> SAM, "
                f"genome {workload.GENOME_N} bp, {smi}; warm-up "
                f"{t_warm:.1f} s); lossless retries {retries}; peak device "
                f"memory {peak} bytes; kernel launches {launches}")
            for ln in err.splitlines():
                if "inferred" in ln:
                    log(f"  {ln}")
            missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
            if missing:
                raise AssertionError(f"kernels not launched on path {path}: "
                                     f"{missing}")

        # -- checks of what came out --
        def se_key(q, rn, rev):
            return q * 8 + rn * 2 + rev

        seq_of = np.searchsorted(starts, pos, side="right") - 1
        want_p1 = pos - starts[seq_of] + 1

        # SE ALL: every read with <= K substitutions at its locus
        q, rn, p1, fl, nm = parse_sam(os.path.join(wd, "se_all.sam"))
        want = np.nonzero(nsub[:N_READS_ALL] <= K)[0]
        dist, _ = nearest((se_key(q, rn - 1, (fl & 16) > 0), p1, nm),
                          se_key(want, seq_of[want], flip[want]),
                          want_p1[want])
        # an error at a read end has equal-cost alignments that begin up to
        # k bases away; the traceback may pick one
        lost = want[dist > K]
        log(f"SE ALL lossless check: {len(want)} reads with <= {K} "
            f"substitutions; {int((dist == 0).sum())} at their exact begin, "
            f"{int(((dist > 0) & (dist <= K)).sum())} within {K} (end "
            f"errors), {len(lost)} missing")
        if len(lost):
            raise AssertionError(f"SE ALL: reads not found at their locus: "
                                 f"{lost[:10].tolist()}")

        # SE BEST: every read with n <= cutoff substitutions has a record,
        # its best NM is <= n, and where it equals n the true locus is there
        q, rn, p1, fl, nm = parse_sam(os.path.join(wd, "se_best.sam"))
        best_nm = np.full(N_READS, 1 << 40, np.int64)
        np.minimum.at(best_nm, q, nm)
        want = np.nonzero(nsub <= BEST_CUT)[0]
        unmapped = want[best_nm[want] > BEST_CUT]
        worse = want[best_nm[want] > nsub[want]]
        at_n = want[best_nm[want] == nsub[want]]
        dist, _ = nearest((se_key(q, rn - 1, (fl & 16) > 0), p1, nm),
                          se_key(at_n, seq_of[at_n], flip[at_n]),
                          want_p1[at_n])
        lost = at_n[dist > nsub[at_n]]
        log(f"SE BEST check: {len(want)} reads with <= {BEST_CUT} "
            f"substitutions; {len(unmapped)} without a record, {len(worse)} "
            f"with best NM above their substitutions, {len(at_n)} with best "
            f"NM equal to them of which {len(lost)} miss their locus; "
            f"{len(want) - len(at_n) - len(worse)} have a better hit "
            f"elsewhere; {len(q)} records")
        if len(unmapped) or len(worse) or len(lost):
            raise AssertionError(
                f"SE BEST: unmapped {unmapped[:5].tolist()}, worse "
                f"{worse[:5].tolist()}, lost {lost[:5].tolist()}")

        # PE: a pair is found when both mates have a proper-pair record at
        # their true loci. Mate 1 is the forward-strand mate unless swapped.
        # ``ids`` are the pairs' rows in the sample, ``names`` their record
        # names' numbers in this FASTQ.
        def pe_check(sam_path, ids, names, tol):
            q, rn, p1, fl, nm = parse_sam(sam_path)
            proper = (fl & 2) > 0
            seq_f = np.searchsorted(starts, pos_f[ids], side="right") - 1
            found = np.ones(len(ids), bool)
            for mate_bit, is_fwd in ((64, ~swapped[ids]), (128, swapped[ids])):
                sel = proper & ((fl & mate_bit) > 0)
                true_pos = np.where(is_fwd, pos_f[ids], pos_r[ids])
                d, _ = nearest(
                    (se_key(q[sel], rn[sel] - 1, (fl[sel] & 16) > 0),
                     p1[sel], nm[sel]),
                    se_key(names, seq_f, ~is_fwd),
                    true_pos - starts[seq_f] + 1)
                found &= d <= tol
            return found, int(proper.sum())

        want = np.nonzero((nsub1 <= 2) & (nsub2 <= 2))[0]
        found, n_proper = pe_check(os.path.join(wd, "pe_best.sam"), want,
                                   want, 2)
        log(f"PE BEST check: {len(want)} pairs with <= 2 substitutions in "
            f"each mate; {int(found.sum())} reported as a proper pair at "
            f"both true loci, {int((~found).sum())} missing; {n_proper} "
            f"proper-pair records")
        if not found.all():
            raise AssertionError(f"PE BEST: pairs not found: "
                                 f"{want[~found][:10].tolist()}")
        found, n_proper = pe_check(
            os.path.join(wd, "pe_all_e0.sam"), exact_pairs,
            np.arange(len(exact_pairs)), 0)
        log(f"PE ALL -e 0 check: {len(exact_pairs)} pairs sampled without a "
            f"substitution; {int(found.sum())} reported as a proper pair at "
            f"both exact loci, {int((~found).sum())} missing; {n_proper} "
            f"proper-pair records; kernel E launches "
            f"{launches_by_path['pe_all_e0']['exact']}")
        if not found.all():
            raise AssertionError(f"PE ALL -e 0: pairs not found: "
                                 f"{exact_pairs[~found][:10].tolist()}")
        want = want[want < N_PAIRS_E2]
        found, n_proper = pe_check(os.path.join(wd, "pe_all_e2.sam"), want,
                                   want, K)
        log(f"PE ALL -e {K} check (band-only path): {len(want)} pairs with "
            f"<= {K} substitutions in each mate; {int(found.sum())} reported "
            f"as a proper pair at both true loci, {int((~found).sum())} "
            f"missing; {n_proper} proper-pair records")
        if not found.all():
            raise AssertionError(f"PE ALL -e {K}: pairs not found: "
                                 f"{want[~found][:10].tolist()}")

        # one batch again through the plain versions on the card: the scheme
        # path at k = 2 and the exact pass at k = 0
        for k, kw in ((K, dict(kmer_table=table, switchpoint=4)), (0, {})):
            scheme = get_scheme("kuch1", k)
            occ_k, _ = pipeline.match_all(index, reads[:BATCH], scheme, **kw)
            restore = plain_patch()
            try:
                occ_p, _ = pipeline.match_all(index, reads[:BATCH], scheme,
                                              **kw)
            finally:
                restore()
            for f in ("read_id", "strand", "begin", "end", "distance"):
                if not np.array_equal(getattr(occ_k, f), getattr(occ_p, f)):
                    raise AssertionError(
                        f"plain-path OccArray differs in {f} at k = {k}")
            log(f"plain versions on the card, k = {k}: identical OccArray "
                f"for one batch ({len(occ_k)} occurrences)")

    kernels = []
    for k in native.KERNELS.values():
        r = report[k.name]
        by_path = {p: ln[k.name] for p, ln in launches_by_path.items()}
        if sum(by_path.values()) == 0:
            raise AssertionError(f"kernel {k.name} launched on no path")
        kernels.append(dict(
            name=k.name, route="cuda", source=k.source, replaces=k.replaces,
            launches=sum(by_path.values()), launches_by_path=by_path,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], bound_bytes=r["bound_bytes"],
            bound_operations=r["bound_operations"]))
    log(f"total smoke time {time.time() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
