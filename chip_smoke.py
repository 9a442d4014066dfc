"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py`` on a machine with
a CUDA device. It

1. prints the card (torch name, and nvidia-smi's name and power limit);
2. builds the eight CUDA kernels from ``columba_tpu_torch/csrc`` into
   ``columba_tpu_torch/_build`` (one nvcc per source, started together;
   kernel B's RLC entries are a source of their own) and prints ptxas's
   registers and spills per entry, failing if kernels C, D, E or F keep a
   stack frame (local memory);
3. generates a random genome from a fixed seed (128 Mbp in 4 sequences, with
   runs of N), writes it as FASTA and builds the index with the port's
   ``cli build`` (default SA sparseness 4, so locate walks LF);
4. runs each kernel on the card at the paths' shapes and holds it against
   its plain PyTorch version on the same tensors (exact equality: all the
   arithmetic is integer), timing both with CUDA events, and works out the
   least time the card could take for the same call
   (``columba_tpu_torch/tools/bounds.py``). Kernel B is one fused band
   step (the lanes' arithmetic, the drain to the in-text buffer and the
   compaction of the next frontier): it is compared on every field it
   leaves (the next frontier's live rows, the in-text rows and count, kept
   children, visits, overflow), at the main path's shape, at the other
   band radii the paths reach, through its generic entry, and, in each of
   its Vanilla, per-lane, RLC and textless entries, on a step that
   overflows both the frontier and the in-text buffer. Kernel
   A's loop entry (the whole exact prefix in one launch) runs on the main
   path's seeded lanes and on the band-only path's second stage; kernel D
   at kb 0, 4, 5, 7 and 13 (its 32- and 64-bit bands); kernel F (dynamic
   partitioning) with and without the seed table, kernel G (per-read
   tables) on F's boundaries, kernel B's per-lane entry at kb 2 and 4 and
   kernel A's loop on G's tables, kernel E with per-row lengths on the part
   patterns of scheme selection, and kernel H (the row gather) at 262,144
   lanes beside ``torch.index_select``;
5. builds the 10-mer seed table (kernel A's main entry, counted as the
   path ``kmer_table``) and drives eight paths through ``cli align``, each
   with every kernel's launch count reset just before and read just after
   (and kernel A's loop launches per ``run_scheme`` call printed), with its
   peak device memory:

   - SE ALL: ``-a all -e 2 -S kuch1 -b 16384`` on 65,536 sampled 100 bp reads
     (1% substitutions, half reverse-complemented);
   - SE BEST: ``-a best -S kuch1 -b 16384`` (the cutoff is 4) on 131,072 reads;
   - PE BEST: ``-a best -F ...`` with default flags (insert inference on,
     rungs (0,0) -> (2,2) -> (4,4)) on 131,072 ``fr`` pairs of 100 bp mates;
   - PE ALL at ``-e 0`` on the pairs sampled without a substitution, which
     takes the exact pass (kernel E) on both sides;
   - PE ALL at ``-e 2`` on the first 32,768 pairs: the band-only path (no
     in-text crossover, half-size frontier, two-stage exact loop);
   - SE ALL ``-p dynamic -e 2`` on the SE ALL path's FASTQ: kernels F and G
     and kernel B's per-lane entry; its records must be those of SE ALL,
     and kernel F must launch once a batch, whatever its lossless re-runs;
   - SE BEST ``-d DIR`` on the same FASTQ, with a collection of two schemes
     per k written from ``schemes/kuch_k+1`` and its mirror: the selection
     probe (kernel E with lengths) and the masked combined pass;
   - PE BEST ``-p static -c schemes/kuch_k+1 -nD`` on 16,384 pairs: the
     scheme folder's own static fractions;

   and then the row-gather bench (``columba_tpu_torch.tools.gather_bench``,
   kernel H's entry point) at 262,144 lanes;
   On ``se_all``, ``pe_best`` and ``rlc_se_all`` the warm-up align's own
   inputs to kernels C and D (the rows ``stage_expand`` flattens from
   whole SA ranges, the candidates ``stage_dedup`` sorts and pads, with
   their live counts) are captured, and after the path each kernel entry
   and band radius is held to its plain version on them and timed, by
   CUDA events and by ``torch.profiler``'s device time, with a warm and
   with a flushed L2 (``columba_tpu_torch/tools/path_inputs.py``);
6. checks each path's output against the sampled loci (nothing with few
   enough substitutions may be missing), that every kernel launched on the
   paths that should reach it, and that one batch run through the plain
   versions on the card gives the same occurrences as the kernels;
7. on the RLC index: writes the JAX package's pan-genome (128 Mbp in one
   sequence, 20 haplotypes of one 6.4 Mbp base at 0.1 % SNP divergence,
   seed 20260820), builds it with ``cli build --rlc`` and ``--rlc
   --textless`` (two processes at once), prints each flavor's index bytes
   on disk and on the card, holds the RLC entries of kernels A, B, C, E
   and F (``extend.loop_rlc`` on 8- and 12-wide lanes and on per-read
   tables, ``extend.rlc`` both ways, ``band_step.rlc``,
   ``band_step.per_lane_rlc`` at kb 2 and 4, ``band_step.textless``,
   ``locate.rlc``, ``exact.rlc``, ``exact.rlc_lengths``, ``dynpart.rlc``
   with every column of its final part ranges) against their plain
   versions at the paths' shapes with their bounds, builds the RLC index's
   10-mer table (path ``rlc_kmer_table``: ``extend.rlc``, sampled rows held
   to the plain exact match) and drives eight more paths:

   - ``rlc_se_all``: ``-a all -e 2 -S kuch1 -b 16384 -nD`` (the JAX
     package's RLC bench) on 65,536 reads of the pan-genome;
   - ``rlc_se_best``: ``-a best`` on the same reads;
   - ``rlc_pe_best``: ``-a best -F`` on 16,384 ``fr`` pairs (fragments of
     250-450 bp), whose rung (0,0) is the exact pass (``exact.rlc``);
   - ``tl_se_all`` and ``tl_se_best``: the same SE commands on the textless
     index (the frontier pass with witness slots, phi locate on the host);
   - ``rlc_se_all_dynamic``: ``rlc_se_all`` with ``-p dynamic`` (kernels F
     and G, kernel B's per-lane RLC entry); its records must be
     ``rlc_se_all``'s, and kernel F must launch once a batch;
   - ``rlc_se_best_d``: ``-a best -d DIR`` with the SE BEST ``-d`` path's
     collection (``exact.rlc_lengths``, the masked pass);
   - ``rlc_pe_best_c``: ``-a best -c schemes/kuch_k+1 -F`` on the
     ``rlc_pe_best`` pairs, selection on;

   with the same checks (SE ALL: every read with <= 2 substitutions at its
   locus; BEST: its best distance; PE: its pair, unless another haplotype
   holds a better one), and one batch of the RLC and of the textless index,
   and of the RLC index with dynamic partitioning and with scheme selection,
   through the plain versions on the card.

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
N_PAIRS_STATIC = 16_384  # the PE BEST -p static path's share of the pairs
GATHER_LANES = 262_144   # kernel H's check and the gather bench path
READ_LEN = 100
K = 2
BEST_CUT = 4             # BEST cutoff of kuch1 at 100 bp and 95 % identity
BATCH = 16384
WARMUP_READS = 16384
N_RLC_READS = 65_536     # each SE path on the pan-genome's RLC indexes
N_RLC_PAIRS = 16_384     # the PE BEST path on the with-text RLC index
RLC_WARMUP = 4096
PLAIN_TL_READS = 4096    # the textless batch through the plain versions

# the kernels each path must launch at least once
PATH_KERNELS = {
    "se_all": ("extend", "band_step", "locate", "verify"),
    "se_best": ("extend", "band_step", "locate", "verify"),
    "pe_best": ("extend", "band_step", "locate", "verify"),
    "pe_all_e0": ("exact", "locate"),
    "pe_all_e2": ("extend", "band_step", "locate", "verify"),
    "se_all_dynamic": ("extend", "band_step", "locate", "verify", "dynpart",
                       "dyn_tables"),
    "se_best_d": ("extend", "band_step", "locate", "verify", "exact"),
    "pe_best_static": ("extend", "band_step", "locate", "verify"),
    "rlc_se_all": ("extend", "band_step", "locate", "verify"),
    "rlc_se_best": ("extend", "band_step", "locate", "verify"),
    "rlc_pe_best": ("extend", "band_step", "locate", "verify", "exact"),
    "tl_se_all": ("extend", "band_step"),
    "tl_se_best": ("extend", "band_step"),
    "rlc_se_all_dynamic": ("extend", "band_step", "locate", "verify",
                           "dynpart", "dyn_tables"),
    "rlc_se_best_d": ("extend", "band_step", "locate", "verify", "exact"),
    "rlc_pe_best_c": ("extend", "band_step", "locate", "verify", "exact"),
}
# the entries of kernels A, B, C and E each path must go through (see
# native.Kernel.by_entry), as "kernel.entry"
_RLC_ENTRIES = ("extend.loop_rlc", "band_step.rlc", "locate.rlc")
PATH_ENTRIES = {
    "se_all": ("extend.loop",),
    "se_best": ("extend.loop",),
    "pe_best": ("extend.loop",),
    "pe_all_e2": ("extend.loop",),
    "se_all_dynamic": ("extend.loop", "band_step.per_lane"),
    "se_best_d": ("extend.loop", "exact.lengths"),
    "pe_best_static": ("extend.loop",),
    "rlc_se_all": _RLC_ENTRIES,
    "rlc_se_best": _RLC_ENTRIES,
    "rlc_pe_best": _RLC_ENTRIES + ("exact.rlc",),
    "tl_se_all": ("extend.loop_rlc", "band_step.textless"),
    "tl_se_best": ("extend.loop_rlc", "band_step.textless"),
    "rlc_se_all_dynamic": ("extend.loop_rlc", "band_step.per_lane_rlc",
                           "locate.rlc", "dynpart.rlc"),
    "rlc_se_best_d": _RLC_ENTRIES + ("exact.rlc_lengths",),
    "rlc_pe_best_c": _RLC_ENTRIES + ("exact.rlc", "exact.rlc_lengths"),
}
RLC_PATHS = ("rlc_se_all", "rlc_se_best", "rlc_pe_best", "tl_se_all",
             "tl_se_best", "rlc_se_all_dynamic", "rlc_se_best_d",
             "rlc_pe_best_c")
# the kernels whose state must stay out of local memory (ptxas: no stack
# frame); kernels A and B keep BmLane's out-of-line walks
NO_FRAME = ("dynpart_", "exact_", "verify_kernel", "locate")
# the paths with -p dynamic: kernel F launches once a batch, however many
# lossless re-runs the batch takes
DYNAMIC_PATHS = ("se_all_dynamic", "rlc_se_all_dynamic")
SCHEMES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "schemes")
# the paths whose own inputs to kernels C and D are captured and timed
CAPTURE_PATHS = ("se_all", "pe_best", "rlc_se_all")
PATH_INPUT_REPS = 10


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


def check_kernel(name, kern, plain, reps=20, plain_reps=5):
    """Kernel against its plain version on the same inputs (exact), then
    both timed; returns the kernel's output and the record."""
    a, b = kern(), plain()
    torch.cuda.synchronize()
    diff = _max_abs(a, b)
    del b
    if diff != 0:
        raise AssertionError(f"kernel {name} differs from its plain "
                             f"version: max abs error {diff}")
    return a, dict(max_abs_err=diff, ms=cuda_time(kern, reps),
                   plain_ms=cuda_time(plain, plain_reps))


def note_kernel(report, name, shape, rep, b, library_ms=None):
    """Adds the bound to a check's record, files it under ``name``, logs
    it."""
    rep.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"],
               bound_bytes=b["bytes"], bound_operations=b["operations"],
               library_ms=library_ms)
    report[name] = rep
    log(f"kernel {name} ({shape}): equal to plain; {rep['ms']:.4f} ms vs "
        f"plain {rep['plain_ms']:.4f} ms; bound {b['bound_ms']:.5f} ms "
        f"by {b['bound_by']} ({b['bytes']} bytes, {b['operations']} "
        f"operations), share {b['bound_ms'] / rep['ms']:.4f}")


def check_fused(index, state, mrow_t, pchars, T, t, switchpoint,
                dyn_meta=None, track=False, cap=None, M=None, cnt=0,
                reps=20, plain_reps=3):
    """Kernel B (a fused band step over every lane of ``state``) against
    ``band_step_compact_plain`` on the same frontier: the next frontier's
    live rows (ranges, ids, band, colMin), the in-text rows and count, the
    kept children, visits and overflow must be equal. Then both are timed
    on their own preallocated outputs, and the bound is worked out from the
    step's own data. Returns (record, bound, kept children, in-text
    rows)."""
    from columba_tpu_torch.index.bmove import BMoveIndex
    from columba_tpu_torch.search import executor
    from columba_tpu_torch.tools import bounds

    C, dev = state[0].shape[0], state[0].device
    cap = C if cap is None else cap
    M = max(1 << 16, 4 * C) if M is None else M
    calls, got = {}, {}
    for which, fn in (("kernel", executor.band_step_compact),
                      ("plain", executor.band_step_compact_plain)):
        out = [torch.empty((cap, *f.shape[1:]), dtype=f.dtype, device=dev)
               for f in state]
        itv = torch.zeros((M + 1, 4), dtype=torch.int64, device=dev)
        sc = executor.StepScratch(C, dev)

        def call(fn=fn, out=out, itv=itv, sc=sc):
            fn(index, state, C, out, itv, cnt, sc, mrow_t, pchars, T, t,
               switchpoint, dyn_meta, track)
        call()
        torch.cuda.synchronize()
        w = int(sc.ctr[0])
        live = min(w & 0xFFFFFFFF, cap)
        got[which] = dict(
            ranges=out[0][:live].clone(), ids=out[1][:live].clone(),
            band=out[2][:live].clone(), colmin=out[3][:live].clone(),
            itv=itv[:M].clone(), word=sc.ctr[0].clone(),
            visits=sc.ctr[1].clone(), overflow=sc.ctr[2].clone())
        calls[which] = call
    diff = _max_abs(got["kernel"], got["plain"])
    if diff != 0:
        raise AssertionError(f"kernel band_step differs from its plain "
                             f"version: max abs error {diff}")
    w = int(got["kernel"]["word"])
    rep = dict(max_abs_err=diff, ms=cuda_time(calls["kernel"], reps),
               plain_ms=cuda_time(calls["plain"], plain_reps))
    o = executor.band_step_plain(index, *state, mrow_t, pchars, T, t,
                                 switchpoint, dyn_meta, track)
    stats = (bounds.rlc_band_stats(index, state, mrow_t, o, cap, dyn_meta,
                                   T, t)
             if isinstance(index, BMoveIndex) else None)
    b = bounds.band_step(state, mrow_t, o, cap, M, cnt, stats)
    return rep, b, w & 0xFFFFFFFF, w >> 32


def check_overflow(what, index, state, mrow_t, pchars, T, t, switchpoint,
                   dyn_meta=None, track=False):
    """Kernel B against its plain version on a step that overflows both the
    next frontier and the in-text buffer: the plain step runs first with
    room for everything, then the capacity is half its kept children and
    M half its narrow rows, so the clamps and the dropped rows run on the
    card."""
    from columba_tpu_torch.search import executor

    C, dev = state[0].shape[0], state[0].device
    sc = executor.StepScratch(C, dev)
    executor.band_step_compact_plain(
        index, state, C, [torch.empty_like(f) for f in state],
        torch.zeros((4 * C + 1, 4), dtype=torch.int64, device=dev), 0, sc,
        mrow_t, pchars, T, t, switchpoint, dyn_meta, track)
    n, rows = sc.word()
    if n < 2 or rows < 2:
        raise AssertionError(f"{what}: the step keeps {n} children and "
                             f"drains {rows}: nothing to overflow")
    rep, _, n2, rows2 = check_fused(index, state, mrow_t, pchars, T, t,
                                    switchpoint, dyn_meta, track,
                                    cap=n // 2, M=rows // 2, plain_reps=1)
    if (n2, rows2) != (n, rows // 2):
        raise AssertionError(f"{what}: overflow case kept {n2}, drained "
                             f"{rows2}")
    log(f"kernel {what} overflowing both buffers (C={C} lanes, "
        f"switchpoint {switchpoint}: {n} children kept into {n // 2} rows, "
        f"{rows} in-text rows into M = {rows // 2}): equal to plain; "
        f"{rep['ms']:.4f} ms")


def check_loop(index, ranges, ids, t_lo, t_hi, reads, tabs, per_lane,
               gate_t, switchpoint, reps=20, plain_reps=1):
    """Kernel A's loop entry against ``exact_loop_plain`` on the same lanes
    (final ranges and drain rows equal), both timed, and its bound from
    the extensions the plain version counts. Returns (record, bound, final
    ranges, drain rows)."""
    from columba_tpu_torch.search import executor
    from columba_tpu_torch.tools import bounds

    args = (index, ranges, ids, t_lo, t_hi, reads, tabs, per_lane, gate_t,
            switchpoint)
    out, rep = check_kernel(
        "extend.loop",
        lambda: dict(zip(("ranges", "drows"), executor.exact_loop(*args))),
        lambda: dict(zip(("ranges", "drows"),
                         executor.exact_loop_plain(*args))),
        reps=reps, plain_reps=plain_reps)
    stats: dict = {}
    executor.exact_loop_plain(*args, stats=stats)
    b = bounds.exact_loop(ranges, ids, tabs, per_lane, stats, out["ranges"],
                          out["drows"])
    return rep, b, out["ranges"], out["drows"]


def _band_args(index, sched, batch, ranges, rng, switchpoint, div=8):
    """One band step's inputs at the shapes ``match_all`` gives a batch:
    capacity C = rows x searches / div (8 with the in-text crossover, 2
    without), real ranges, the schedule's own step tables and cell codes,
    random band and register state."""
    from columba_tpu_torch.search import executor

    dev = index.device
    R, S = batch.shape[0], sched.num_searches
    C = max(1024, R * S // div)
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
        "locate": (lambda: locate.locate_rows(index, rows),
                   lambda: locate.locate_rows_plain(index, rows)),
        "verify": (lambda: verify.verify_window(index, pats, rid, ws, K),
                   lambda: verify.verify_window_plain(index, pats, rid, ws,
                                                      K)),
        "exact": (lambda: extend.exact_match(index, batch),
                  lambda: extend.zero_empty(
                      extend.exact_match_plain(index, batch))),
    }
    shapes = {"extend": f"{2 * C} lanes", "locate": f"{ml} rows",
              "verify": f"{ml} candidates, m={READ_LEN}, kb={K}",
              "exact": f"{R} rows x {READ_LEN} bp"}

    check = check_kernel
    report = {}
    for name, (kern, plain) in cases.items():
        out, rep = check(name, kern, plain,
                         plain_reps=2 if name == "exact" else 5)
        if name == "extend":
            b = bounds.extend(ranges, dirs, chars, out)
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

    # kernel B, the fused step, at the main path's shape (kb 2, W 2, C =
    # rows x searches / 8), at the other shapes the paths reach, and
    # through its generic entry (runtime sizes)
    def fused(args, **kw):
        return check_fused(args[0], list(args[1:5]), *args[5:], **kw)

    rep, b, n, _ = fused(band_args)
    note_kernel(report, "band_step", f"fused step, C={C} lanes live, kb={K}"
                f", W={sched.W}; {n} children kept", rep, b)
    for scheme, k, metric, what in (
            ("kuch1", BEST_CUT, "edit", "BEST cutoff, templated"),
            ("kuch1", K, "hamming", "Hamming band, templated"),
            ("columba", 5, "edit", "generic entry")):
        sc = pipeline.compile_cached(get_scheme(scheme, k), READ_LEN, metric,
                                     kmer_k=10)
        args = _band_args(index, sc, batch, all_ranges, rng,
                          4 if metric == "edit" else 0)
        rep, b, n, _ = fused(args)
        log(f"kernel band_step at kb={(sc.bw - 1) // 2}, W={sc.W} ({what}; "
            f"{scheme} k={k} {metric}, C={args[1].shape[0]}): equal to "
            f"plain; {rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} ms; "
            f"bound {b['bound_ms']:.5f} ms by {b['bound_by']}")
    # a step that overflows both the next frontier and the in-text buffer:
    # the 10-mer seeds' children are about 30 wide, so switchpoint 30
    # drains about half of them and keeps the rest
    check_overflow("band_step", band_args[0], list(band_args[1:5]),
                   *band_args[5:9], 30)

    # kernel A's loop entry: the main path's exact prefix (R x S lanes from
    # the 10-mer seeds, gate depth 20, switchpoint 4), then the band-only
    # path's second stage (switchpoint 0, the lanes live after 8 steps,
    # compacted, with their own ids)
    tables = executor.device_tables(sched, dev)
    tabs = (tables["ex_pos"], tables["ex_dir"], tables["db_ex"])
    S, Kk = sched.num_searches, sched.kmer_k
    seeds = torch.stack(
        [index.full_range((R,)) if int(ks) < 0
         else kmer.lookup(table, batch[:, ks:ks + Kk])
         for ks in sched.kmer_start], dim=1).reshape(R * S, 4)
    seeds = extend.zero_empty(seeds)
    gate = 20 - Kk - 1
    rep, b, out, drows = check_loop(index, seeds, None, 0, sched.e_max,
                                    batch, tabs, False, gate, 4)
    note_kernel(report, "extend.loop",
                f"{R * S} lanes from the 10-mer seeds, steps 0..{sched.e_max}"
                f", {int((drows[:, 1] > drows[:, 0]).sum())} drained, "
                f"{int((out[:, 1] > out[:, 0]).sum())} live after", rep, b)
    stage1, _ = executor.exact_loop(index, seeds, None, 0, 8, batch, tabs,
                                    False, gate, 0)
    ids = (stage1[:, 1] > stage1[:, 0]).nonzero()[:, 0]
    ids = ids[:R * S // 2].int().contiguous()
    rep, b, out, _ = check_loop(index, stage1[ids.long()].contiguous(), ids,
                                8, sched.e_max, batch, tabs, False, gate, 0)
    log(f"kernel extend.loop, band-only second stage ({ids.numel()} lanes "
        f"live after 8 steps, steps 8..{sched.e_max}): equal to plain; "
        f"{rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} ms; bound "
        f"{b['bound_ms']:.5f} ms")
    for kb in (0, BEST_CUT, 5, 7, 13):
        wsk = win_starts(kb)
        _, rep = check(
            "verify", lambda: verify.verify_window(index, pats, rid, wsk, kb),
            lambda: verify.verify_window_plain(index, pats, rid, wsk, kb),
            plain_reps=2)
        log(f"kernel verify at kb={kb} ({32 if kb <= 7 else 64}-bit band; "
            f"{ml} candidates): equal to plain; {rep['ms']:.4f} ms vs plain "
            f"{rep['plain_ms']:.4f} ms")
    report.update(new_kernel_checks(index, batch, table, all_ranges, rng,
                                    check))
    return report


def new_kernel_checks(index, batch, table, all_ranges, rng, check) -> dict:
    """Kernels F, G and H, kernel B's per-lane entry, kernel A's loop on
    per-read tables and kernel E with lengths against their plain versions
    at the shapes of the dynamic partitioning and scheme selection paths
    (32,768 rows x 100 bp)."""
    from columba_tpu_torch.search import dynschedule, pipeline
    from columba_tpu_torch.search import schedule
    from columba_tpu_torch.search.scheme import get_scheme
    from columba_tpu_torch.tools import bounds, gather_bench

    dev = index.device
    R = batch.shape[0]
    report = {}

    def note(name, shape, rep, b, library_ms=None):
        note_kernel(report, name, shape, rep, b, library_ms)

    # kernel F: kuch1 k = 2 with the 10-mer table, and once without a table
    scheme = get_scheme("kuch1", K)
    p = scheme.num_parts
    pts, rep = check(
        "dynpart",
        lambda: dynschedule.dynamic_partition(index, batch, scheme, table),
        lambda: dynschedule.dynamic_partition_plain(index, batch, scheme,
                                                    table), plain_reps=1)
    note("dynpart", f"{R} rows x {READ_LEN} bp, kuch1 k={K}, p={p}, table "
         f"K=10", rep, bounds.dynpart(batch, p, 10, True, pts))
    pts1, rep1 = check(
        "dynpart",
        lambda: dynschedule.dynamic_partition(index, batch, scheme, None),
        lambda: dynschedule.dynamic_partition_plain(index, batch, scheme,
                                                    None), plain_reps=1)
    b1 = bounds.dynpart(batch, p, 1, False, pts1)
    log(f"kernel dynpart without a table (K = 1, {READ_LEN - p} steps): "
        f"equal to plain; {rep1['ms']:.4f} ms vs plain "
        f"{rep1['plain_ms']:.4f} ms; bound {b1['bound_ms']:.5f} ms by "
        f"{b1['bound_by']}; boundaries differ from the seeded run's in "
        f"{int((pts != pts1).any(dim=1).sum())} of {R} rows")

    # kernel G on F's boundaries (the clamp folded in), then kernel B's
    # per-lane entry on G's tables, at kb 2 and at kb 4
    for k in (K, BEST_CUT):
        sc = get_scheme("kuch1", k)
        st = dynschedule.scheme_static(sc, READ_LEN, "edit")
        pts_k = pts if k == K else dynschedule.dynamic_partition(
            index, batch, sc, table)
        dyn, rep = check(
            "dyn_tables",
            lambda: dynschedule.build_tables(st, pts_k, batch),
            lambda: dynschedule.build_tables_plain(st, pts_k, batch),
            reps=10, plain_reps=1)
        phases = dynschedule._static_on(st, dev)["phases"]
        b = bounds.dyn_tables(pts_k, batch, phases, dyn)
        shape = (f"{R} rows x {st.num_searches} searches, T={st.t_max}, "
                 f"kb={st.kb}")
        if k == K:
            note("dyn_tables", shape, rep, b)
        else:
            log(f"kernel dyn_tables ({shape}): equal to plain; "
                f"{rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} ms; "
                f"bound {b['bound_ms']:.5f} ms ({b['bytes']} bytes)")
        S, T, bw = st.num_searches, st.t_max, 2 * st.kb + 1
        C = max(1024, R * S // 8)
        t = T - READ_LEN // 3          # inside the last part's band steps
        ids = torch.from_numpy(rng.integers(0, R * S, C).astype(
            np.int32)).to(dev)
        band = torch.from_numpy(rng.integers(0, 4, (C, 2, bw)).astype(
            np.int8)).to(dev)
        colmin = torch.from_numpy(rng.integers(0, 3, (C, 2, 1)).astype(
            np.int8)).to(dev)
        state = [all_ranges[:C].contiguous(), ids, band, colmin]
        rep, b, n, _ = check_fused(index, state, None, dyn["pchars"], T, t,
                                   4, dyn["meta"].reshape(-1))
        if n == 0:
            raise AssertionError("no child kept in the per-lane band step")
        shape = (f"per-lane entry, fused step, C={C} lanes, kb={st.kb}, "
                 f"W=1; {n} children kept")
        if k == K:
            note("band_step.per_lane", shape, rep, b)
            check_overflow("band_step.per_lane", index, state, None,
                           dyn["pchars"], T, t, 30, dyn["meta"].reshape(-1))
            # kernel A's loop entry on the per-read tables: every lane
            # from the full range, gate depth 20, switchpoint 4
            L = R * S
            rep, b, out, drows = check_loop(
                index, index.full_range((L,)), None, 0,
                dyn["ex_pos"].shape[1], batch,
                (dyn["ex_pos"], dyn["ex_dir"], dyn["db_ex_steps"]), True,
                19, 4)
            log(f"kernel extend.loop on per-read tables ({L} lanes from the "
                f"full range, {dyn['ex_pos'].shape[1]} steps, "
                f"{int((drows[:, 1] > drows[:, 0]).sum())} drained): equal "
                f"to plain; {rep['ms']:.4f} ms vs plain "
                f"{rep['plain_ms']:.4f} ms; bound {b['bound_ms']:.5f} ms")
        else:
            log(f"kernel band_step ({shape}): equal to plain; "
                f"{rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} ms")
        del dyn, state

    # kernel E with lengths: the R x p part patterns of scheme selection at
    # the BEST cutoff, as select_schemes makes them on the -d path
    p = get_scheme("kuch1", BEST_CUT).num_parts
    cuts = schedule.uniform_partition(READ_LEN, p)
    lens = np.diff(cuts)
    pos = np.full((p, lens.max()), -1, np.int64)
    for i in range(p):
        pos[i, :lens[i]] = np.arange(cuts[i], cuts[i + 1])
    pos = torch.from_numpy(pos).to(dev)
    pats = torch.where((pos >= 0)[None], batch[:, pos.clamp(min=0)], 5)
    pats = pats.reshape(R * p, -1).contiguous()
    lengths = torch.from_numpy(lens.astype(np.int32)).to(dev).repeat(R)
    from columba_tpu_torch.ops import extend
    out, rep = check(
        "exact", lambda: extend.exact_match(index, pats, lengths),
        lambda: extend.zero_empty(extend.exact_match_plain(index, pats,
                                                           lengths)),
        plain_reps=2)
    want = pipeline.part_exact_ranges(index, batch, cuts).reshape(-1, 4)
    if not torch.equal(out, want):
        raise AssertionError("part_exact_ranges differs from kernel E on "
                             "its patterns")
    note("exact.lengths", f"{R * p} part patterns of {lens.min()}-"
         f"{lens.max()} chars", rep,
         bounds.exact(bounds.exact_steps(index, pats, lengths), R * p, out))

    # kernel H: 64 B rows of a 2,000,000-row table at 262,144 lanes. The
    # timed calls cycle through 16 index sets (268 MB of rows), so that no
    # call finds its rows in the 50 MB L2 cache.
    tab = torch.from_numpy(rng.integers(
        0, 2 ** 31, (gather_bench.ROWS, 16)).astype(np.int32)).to(dev)
    idx_sets = [torch.from_numpy(rng.integers(
        0, gather_bench.ROWS, GATHER_LANES)).to(dev) for _ in range(16)]
    idx = idx_sets[0]

    def cycling(fn):
        state = [0]

        def call():
            state[0] += 1
            return fn(tab, idx_sets[state[0] % len(idx_sets)])
        return call

    out = gather_bench.gather_rows(tab, idx)
    rep = dict(
        max_abs_err=_max_abs(out, gather_bench.gather_rows_plain(tab, idx)),
        ms=cuda_time(cycling(gather_bench.gather_rows), 64),
        plain_ms=cuda_time(cycling(gather_bench.gather_rows_plain), 64))
    if rep["max_abs_err"] != 0:
        raise AssertionError("kernel gather differs from its plain version")
    lib = cuda_time(cycling(lambda t, i: torch.index_select(t, 0, i)), 64)
    note("gather", f"{GATHER_LANES} lanes, 64 B rows of {gather_bench.ROWS}, "
         f"one thread per row", rep, bounds.gather(tab, idx, out), lib)
    log(f"library call torch.index_select: {lib:.4f} ms")
    return report


def rlc_lane_states(index, batch, rng, L, max_len=24):
    """Valid lane states of an RLC index at the exact prefix's shapes: each
    lane matches a random stretch (0 to ``max_len`` chars) of a read of
    ``batch`` by extensions in random directions from the full range,
    through the plain extension; a lane whose stretch does not occur ends
    all zero."""
    from columba_tpu_torch.ops import extend

    dev = index.device
    R, m = batch.shape
    row = torch.from_numpy(rng.integers(0, R, L)).to(dev)
    lo = torch.from_numpy(rng.integers(max_len, m - max_len, L)).to(dev)
    hi = lo.clone()
    length = torch.from_numpy(rng.integers(0, max_len + 1, L)).to(dev)
    ranges = index.full_range((L,))
    for step in range(max_len):
        fwd = torch.from_numpy(rng.integers(0, 2, L).astype(bool)).to(dev)
        chars = batch[row, torch.where(fwd, hi, lo - 1)].int()
        new = extend.extend_char_plain(index, ranges, chars, fwd.int())
        act = step < length
        ranges = torch.where(act[:, None], new, ranges)
        lo = torch.where(act & ~fwd, lo - 1, lo)
        hi = torch.where(act & fwd, hi + 1, hi)
    return ranges.contiguous()


def rlc_kernel_checks(bm, tl, batch) -> dict:
    """The RLC entries of kernels A (its loop), B, C and E against their
    plain versions on the card, at the shapes of the RLC paths (a batch of
    16,384 reads of the pan-genome, both strands: 32,768 rows), with their
    bounds."""
    from columba_tpu_torch.ops import blocate, extend, locate
    from columba_tpu_torch.search import executor, pipeline
    from columba_tpu_torch.search.scheme import get_scheme
    from columba_tpu_torch.tools import bounds

    dev = bm.device
    rng = np.random.default_rng(SEED + 3)
    R = batch.shape[0]
    report = {}
    sched = pipeline.compile_cached(get_scheme("kuch1", K), READ_LEN, "edit")
    S = sched.num_searches

    L = R * S
    states = rlc_lane_states(bm, batch, rng, max(1024, L // 8))

    # kernel B (band_step.rlc): C = R x S / 8 lanes with the crossover on
    ba = _band_args(bm, sched, batch, states, rng, 4)
    rep, b, n, _ = check_fused(bm, list(ba[1:5]), *ba[5:], plain_reps=2)
    note_kernel(report, "band_step.rlc",
                f"fused step, C={ba[1].shape[0]} lanes x 8, kb={K}, "
                f"W={sched.W}; {n} children kept", rep, b)
    check_overflow("band_step.rlc", bm, list(ba[1:5]), *ba[5:9], 30)

    # kernel B (band_step.textless): C = R x S / 2 lanes, 12 wide, 2W
    # colMin slots, no crossover
    C = max(1024, R * S // 2)
    tl_states = rlc_lane_states(tl, batch, rng, C)
    tb = list(_band_args(tl, sched, batch, tl_states, rng, 0, div=2))
    tb[4] = torch.from_numpy(rng.integers(0, 3, (C, 2, 2 * sched.W)).astype(
        np.int8)).to(dev)
    rep, b, n, _ = check_fused(tl, tb[1:5], *tb[5:], track=True,
                               plain_reps=2)
    note_kernel(report, "band_step.textless",
                f"fused step, C={C} lanes x 12, kb={K}, W={sched.W} "
                f"(+{sched.W} witness slots); {n} children kept", rep, b)
    check_overflow("band_step.textless", tl, tb[1:5], *tb[5:9], 30,
                   track=True)

    # kernel A's loop entry (extend.loop_rlc): the exact prefix of the RLC
    # paths, R x S lanes from the full range (no seed table), 8 wide with
    # the crossover, and 12 wide on the textless index without it
    tables = executor.device_tables(sched, dev)
    tabs = (tables["ex_pos"], tables["ex_dir"], tables["db_ex"])
    rep, b, out, drows = check_loop(bm, bm.full_range((L,)), None, 0,
                                    sched.e_max, batch, tabs, False, 19, 4)
    note_kernel(report, "extend.loop_rlc",
                f"{L} lanes x 8 from the full range, steps 0..{sched.e_max}"
                f", {int((drows[:, 1] > drows[:, 0]).sum())} drained, "
                f"{int((out[:, 1] > out[:, 0]).sum())} live after", rep, b)
    rep, b, out, _ = check_loop(tl, tl.full_range((L,)), None, 0,
                                sched.e_max, batch, tabs, False, 19, 0)
    log(f"kernel extend.loop_rlc on 12-wide textless lanes ({L} from the "
        f"full range, {int((out[:, 1] > out[:, 0]).sum())} live after): "
        f"equal to plain; {rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} "
        f"ms; bound {b['bound_ms']:.5f} ms")

    # kernel E (exact.rlc): the batch's 32,768 rows x 100 bp
    out, rep = check_kernel(
        "exact.rlc", lambda: extend.exact_match(bm, batch),
        lambda: extend.zero_empty(extend.exact_match_plain(bm, batch)),
        reps=10, plain_reps=1)
    stats = {}
    steps = bounds.exact_steps(bm, batch, stats=stats)
    note_kernel(report, "exact.rlc", f"{R} rows x {READ_LEN} bp, "
                f"{int((out[:, 1] > out[:, 0]).sum())} matched, "
                f"{bounds.rlc_rounds(steps, stats, R):.1f} dependent-read "
                f"rounds a row", rep, bounds.exact_rlc(steps, stats, out))

    report.update(rlc_select_checks(bm, batch, rng, states))

    # kernel C (locate.rlc): max_locate = max(65,536, 4 R) random rows
    ml = max(1 << 16, 4 * R)
    rows = torch.from_numpy(rng.integers(0, bm.n + 1, ml)).to(dev)
    out, rep = check_kernel("locate.rlc", lambda: locate.locate_rows(bm, rows),
                            lambda: blocate.locate_rows_plain(bm, rows),
                            plain_reps=2)
    stats = {}
    blocate.locate_rows_plain(bm, rows, stats)
    note_kernel(report, "locate.rlc",
                f"{ml} rows, {stats['steps'] / ml:.2f} LF steps a row", rep,
                bounds.locate_rlc(rows, stats, out))
    return report


def rlc_select_checks(bm, batch, rng, states) -> dict:
    """The RLC entries of this slice against their plain versions on the
    card, with their bounds, at the shapes of the RLC paths: kernel A's
    per-step entry (``extend.rlc``: extend_all and extend_char on R x S
    lanes), kernel F's (``dynpart.rlc``: kuch1 k = 2, K = 1, every column
    of the final part ranges too), kernel B's per-lane entry
    (``band_step.per_lane_rlc`` at kb 2 and 4 on kernel G's tables of F's
    boundaries, C = 12,288 lanes), kernel A's loop on those per-read
    tables, and kernel E with lengths (``exact.rlc_lengths``: the -d
    probe's 5 x R part patterns of 20 chars at the BEST cutoff)."""
    from columba_tpu_torch.ops import bextend, extend
    from columba_tpu_torch.search import dynschedule, executor, schedule
    from columba_tpu_torch.search.scheme import get_scheme
    from columba_tpu_torch.tools import bounds

    dev = bm.device
    R = batch.shape[0]
    report = {}
    scheme = get_scheme("kuch1", K)
    p, S = scheme.num_parts, len(scheme.searches)
    L = R * S

    # kernel A's per-step RLC entry: valid lanes of the exact prefix's
    # shape (R x S), random directions and chars
    lanes = rlc_lane_states(bm, batch, rng, L)
    dirs = torch.from_numpy(rng.integers(0, 2, L).astype(np.int32)).to(dev)
    chars = torch.from_numpy(rng.integers(0, 5, L).astype(np.int32)).to(dev)
    out, rep = check_kernel(
        "extend.rlc", lambda: extend.extend_all(bm, lanes, dirs),
        lambda: extend.extend_all_plain(bm, lanes, dirs), plain_reps=1)
    stats = {}
    bextend.extend_all_plain(bm, lanes, dirs, None, stats)
    b = bounds.extend_rlc(lanes, dirs, None, out, stats)
    log(f"kernel extend.rlc extend_all ({L} lanes x 8, "
        f"{int((out[..., 1] > out[..., 0]).sum())} children): equal to "
        f"plain; {rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} ms; bound "
        f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({b['bytes']} bytes), "
        f"share {b['bound_ms'] / rep['ms']:.4f}")
    out, rep = check_kernel(
        "extend.rlc", lambda: extend.extend_char(bm, lanes, chars, dirs),
        lambda: extend.extend_char_plain(bm, lanes, chars, dirs),
        plain_reps=1)
    stats = {}
    bextend.extend_char_plain(bm, lanes, chars, dirs, stats)
    note_kernel(report, "extend.rlc", f"extend_char, {L} lanes x 8, "
                f"{int((out[:, 1] > out[:, 0]).sum())} live after", rep,
                bounds.extend_rlc(lanes, dirs, chars, out, stats))
    del lanes, dirs, chars, out

    # kernel F's RLC entry: boundaries and the final 8-wide part ranges
    def part(fn):
        def call():
            rng_out = torch.empty((R, p, 8), dtype=torch.int64, device=dev)
            return dict(pts=fn(bm, batch, scheme, None, rng_out),
                        ranges=rng_out)
        return call
    got, rep = check_kernel(
        "dynpart.rlc", part(dynschedule.dynamic_partition),
        part(dynschedule.dynamic_partition_plain), reps=10, plain_reps=1)
    pts = got["pts"]
    stats = {}
    dynschedule.dynamic_partition_plain(bm, batch, scheme, None, None, stats)
    note_kernel(report, "dynpart.rlc", f"{R} rows x {READ_LEN} bp, kuch1 "
                f"k={K}, p={p}, K=1 ({READ_LEN - p} steps), "
                f"{int((got['ranges'][..., 1] > got['ranges'][..., 0]).sum())}"
                f" of {R * p} final parts live, "
                f"{bounds.rlc_rounds(stats['steps'], stats, R):.1f} "
                f"dependent-read rounds a row", rep,
                bounds.dynpart_rlc(batch, p, 1, False, stats, pts))
    del got

    # kernel G's tables of F's boundaries; kernel B's per-lane RLC entry on
    # them at kb 2 and 4 (C = 12,288 valid lanes); kernel A's loop on the
    # per-read tables at kb 2
    C = 12_288
    for k in (K, BEST_CUT):
        sc = get_scheme("kuch1", k)
        st = dynschedule.scheme_static(sc, READ_LEN, "edit")
        pts_k = pts if k == K else dynschedule.dynamic_partition(
            bm, batch, sc)
        dyn = dynschedule.build_tables(st, pts_k, batch)
        Sk, T, bw = st.num_searches, st.t_max, 2 * st.kb + 1
        t = T - READ_LEN // 3          # inside the last part's band steps
        ids = torch.from_numpy(rng.integers(0, R * Sk, C).astype(
            np.int32)).to(dev)
        band = torch.from_numpy(rng.integers(0, 4, (C, 2, bw)).astype(
            np.int8)).to(dev)
        colmin = torch.from_numpy(rng.integers(0, 3, (C, 2, 1)).astype(
            np.int8)).to(dev)
        state = [states[:C].contiguous(), ids, band, colmin]
        rep, b, n, _ = check_fused(bm, state, None, dyn["pchars"], T, t, 4,
                                   dyn["meta"].reshape(-1), plain_reps=2)
        if n == 0:
            raise AssertionError("no child kept in the per-lane RLC step")
        shape = (f"per-lane RLC entry, fused step, C={C} lanes x 8, "
                 f"kb={st.kb}, W=1; {n} children kept")
        if k == K:
            note_kernel(report, "band_step.per_lane_rlc", shape, rep, b)
            check_overflow("band_step.per_lane_rlc", bm, state, None,
                           dyn["pchars"], T, t, 30, dyn["meta"].reshape(-1))
            rep, b, out, drows = check_loop(
                bm, bm.full_range((R * Sk,)), None, 0,
                dyn["ex_pos"].shape[1], batch,
                (dyn["ex_pos"], dyn["ex_dir"], dyn["db_ex_steps"]), True,
                19, 4, reps=5)
            log(f"kernel extend.loop_rlc on per-read tables ({R * Sk} lanes "
                f"x 8 from the full range, {dyn['ex_pos'].shape[1]} steps, "
                f"{int((drows[:, 1] > drows[:, 0]).sum())} drained, "
                f"{int((out[:, 1] > out[:, 0]).sum())} live after): equal to "
                f"plain; {rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} "
                f"ms; bound {b['bound_ms']:.5f} ms by {b['bound_by']}, share "
                f"{b['bound_ms'] / rep['ms']:.4f}")
        else:
            log(f"kernel band_step.per_lane_rlc ({shape}): equal to plain; "
                f"{rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} ms; "
                f"bound {b['bound_ms']:.5f} ms by {b['bound_by']}, share "
                f"{b['bound_ms'] / rep['ms']:.4f}")
        del dyn, state

    # kernel E with lengths on the R x p part patterns of scheme selection
    # at the BEST cutoff, as select_schemes makes them on the -d path
    p4 = get_scheme("kuch1", BEST_CUT).num_parts
    cuts = schedule.uniform_partition(READ_LEN, p4)
    lens = np.diff(cuts)
    pos = np.full((p4, lens.max()), -1, np.int64)
    for i in range(p4):
        pos[i, :lens[i]] = np.arange(cuts[i], cuts[i + 1])
    pos = torch.from_numpy(pos).to(dev)
    pats = torch.where((pos >= 0)[None], batch[:, pos.clamp(min=0)], 5)
    pats = pats.reshape(R * p4, -1).contiguous()
    lengths = torch.from_numpy(lens.astype(np.int32)).to(dev).repeat(R)
    out, rep = check_kernel(
        "exact.rlc_lengths", lambda: extend.exact_match(bm, pats, lengths),
        lambda: extend.zero_empty(extend.exact_match_plain(bm, pats,
                                                           lengths)),
        reps=10, plain_reps=1)
    stats = {}
    steps = bounds.exact_steps(bm, pats, lengths, stats)
    note_kernel(report, "exact.rlc_lengths",
                f"{R * p4} part patterns of {lens.min()}-{lens.max()} chars, "
                f"{int((out[:, 1] > out[:, 0]).sum())} matched, "
                f"{bounds.rlc_rounds(steps, stats, R * p4):.1f} "
                f"dependent-read rounds a row", rep,
                bounds.exact_rlc(steps, stats, out))
    return report


def path_input_times(path: str, calls: list, smi: str) -> None:
    """Kernels C and D on the inputs a path's warm-up gave them (the first
    launch of each entry and band radius): held to the plain version, then
    timed by CUDA events and by the profiler's device time, with a warm and
    with a flushed L2 (``tools/path_inputs.py``)."""
    from columba_tpu_torch.tools import path_inputs

    seen, picked = set(), []
    for c in calls:
        key = (c["kind"], c.get("kb"))
        if key not in seen:
            seen.add(key)
            picked.append(c)
    path_inputs.time_inputs(path, picked, path_inputs.Clocks(PATH_INPUT_REPS),
                            smi, [])


def parse_sam(path: str, seq_ids: dict | None = None):
    """(qname index, rname index, pos1, flag, NM) of every mapped record;
    a sequence's index is its number in ``chrN`` or ``seq_ids[name]``."""
    q, rn, p, fl, nm = [], [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            c = line.split("\t", 4)
            if c[2] == "*":
                continue
            q.append(int(c[0][1:]))
            rn.append(seq_ids[c[2]] if seq_ids else int(c[2][3:]))
            p.append(int(c[3]))
            fl.append(int(c[1]))
            nm.append(int(line[line.index("NM:i:") + 5:].split("\t", 1)[0]))
    return tuple(np.array(v, np.int64) for v in (q, rn, p, fl, nm))


def proper_pairs(path: str) -> dict:
    """pair number -> [(mate 1 pos1, mate 2 pos1, NM total)] of the proper
    pairs a PE SAM reports (mates matched by RNEXT/PNEXT)."""
    mates = ({}, {})
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            c = line.split("\t", 8)
            flag = int(c[1])
            if not flag & 2:
                continue
            nm = int(line[line.index("NM:i:") + 5:].split("\t", 1)[0])
            mates[0 if flag & 64 else 1].setdefault(int(c[0][1:]), []).append(
                (int(c[3]), int(c[7]), nm))
    out = {}
    for q, recs in mates[0].items():
        for pos, pnext, nm in recs:
            for pos2, pnext2, nm2 in mates[1].get(q, []):
                if pos2 == pnext and pnext2 == pos:
                    out.setdefault(q, []).append((pos, pos2, nm + nm2))
    return out


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
    from columba_tpu_torch.index.bmove import BMoveIndex
    from columba_tpu_torch.ops import blocate, extend, locate, rank, verify
    from columba_tpu_torch.search import dynschedule, executor

    def locate_plain(index, rows):
        if isinstance(index, BMoveIndex):
            return blocate.locate_rows_plain(index, rows)
        if index.sa_sparseness == 1:
            return rank.u32(index.sa_samples[rows])
        return locate.locate_rows_plain(index, rows)

    def verify_plain(index, patterns, rid, window_start, kb, live=None):
        return verify.verify_window_plain(index, patterns, rid,
                                          window_start, kb)

    def exact_plain(index, patterns, lengths=None):
        return extend.zero_empty(extend.exact_match_plain(index, patterns,
                                                          lengths))

    saved = [(extend, "extend_char", extend.extend_char_plain),
             (extend, "exact_match", exact_plain),
             (executor, "exact_loop", executor.exact_loop_plain),
             (executor, "band_step_compact",
              executor.band_step_compact_plain),
             (dynschedule, "dynamic_partition",
              dynschedule.dynamic_partition_plain),
             (dynschedule, "build_tables", dynschedule.build_tables_plain),
             (locate, "locate_rows", locate_plain),
             (verify, "verify_window", verify_plain)]
    undo = [(mod, name, getattr(mod, name)) for mod, name, _ in saved]
    for mod, name, fn in saved:
        setattr(mod, name, fn)

    def restore():
        for mod, name, fn in undo:
            setattr(mod, name, fn)
    return restore


def rlc_section(wd, dev, smi, vanilla_idx, drive, record, collection, files,
                warm, argv_of, n_of, index_of) -> dict:
    """The RLC and textless indexes: the pan-genome's FASTA, both ``cli
    build`` runs (two processes at once), index bytes, the RLC entries'
    kernel checks, the k-mer table build on the RLC index (kernel A's
    per-step RLC entry; its launches go to ``record``), the eight RLC paths
    through ``drive`` (which fills the launch tables; ``collection`` is the
    -d path's folder), their output checks and one batch of each flavor
    through the plain versions. Returns the kernel records."""
    from columba_tpu_torch import native
    from columba_tpu_torch.index.bmove import BMoveIndex, load_bmove
    from columba_tpu_torch.index.kmer import build_kmer_table
    from columba_tpu_torch.ops import extend
    from columba_tpu_torch.search import pipeline
    from columba_tpu_torch.search.scheme import get_multi_scheme, get_scheme
    from columba_tpu_torch.tools import workload

    t0 = time.time()
    pan = workload.pan_genome()
    n = len(pan)
    pan_fa = os.path.join(wd, "pan.fa")
    workload.write_fasta(pan_fa, pan, "pan")
    log(f"pan-genome: {n} bp in one sequence, {workload.PAN_HAPLOTYPES} "
        f"haplotypes of one base at {workload.PAN_SNP_RATE} SNP divergence "
        f"(seed {workload.PAN_SEED}), FASTA in {time.time() - t0:.1f} s")
    idx_of = {"rlc": os.path.join(wd, "pan_rlc.cidx"),
              "textless": os.path.join(wd, "pan_tl.cidx")}
    t0 = time.time()
    procs = {}
    try:
        for f, extra in (("rlc", ["--rlc"]),
                         ("textless", ["--rlc", "--textless"])):
            procs[f] = subprocess.Popen(
                [sys.executable, "-m", "columba_tpu_torch.cli", "build",
                 "-r", idx_of[f], "-f", pan_fa, *extra],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for f, proc in procs.items():
            _, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise AssertionError(f"cli build ({f}) failed:\n{err[-4000:]}")
            log(f"  {err.strip().splitlines()[-1]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"cli build --rlc and --rlc --textless (two processes at once): "
        f"{time.time() - t0:.1f} s")

    def disk(path):
        return sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))

    log(f"index bytes on disk: Vanilla (-s 4, the random genome of the same "
        f"length) {disk(vanilla_idx)}, rlc {disk(idx_of['rlc'])}, textless "
        f"{disk(idx_of['textless'])}")
    arrays = {f: load_bmove(idx_of[f]) for f in idx_of}
    bm = BMoveIndex.from_arrays(arrays["rlc"], dev)
    tl = BMoveIndex.from_arrays(arrays["textless"], dev)
    phi = arrays["textless"].phi_fwd.nbytes + arrays["textless"].phi_rev.nbytes
    log(f"pan-genome runs: fwd {bm.r_fwd} (r/n {bm.r_fwd / n:.4f}), rev "
        f"{bm.r_rev}; index bytes on the card: rlc {bm.nbytes()}, textless "
        f"{tl.nbytes()} (its phi tables stay on the host: {phi} bytes)")

    rng = np.random.default_rng(SEED + 2)
    starts = np.array([0, n], np.int64)
    reads, pos, nsub, flip = workload.sample_reads(pan, starts, N_RLC_READS,
                                                   rng, READ_LEN)
    m1, m2, pos_f, pos_r, nsub1, nsub2, swapped = workload.sample_pairs(
        pan, starts, N_RLC_PAIRS, rng, READ_LEN, frag_min=250, frag_max=450)
    batch = torch.from_numpy(np.concatenate(
        [reads[:BATCH], reads[:BATCH, ::-1] ^ 3])).to(dev)
    report = rlc_kernel_checks(bm, tl, batch)
    del batch

    # kernel A's per-step RLC entry through its caller on the card: the
    # 10-mer seed table of the RLC index (index/kmer.py; cli align builds
    # none on RLC, a library caller may pass one to match_all), 4^10 lanes
    # x 10 extend_char steps; 65,536 sampled rows held to the plain exact
    # match of their k-mers
    for k in native.KERNELS.values():
        k.reset()
    torch.cuda.synchronize()
    t0 = time.time()
    table = build_kmer_table(bm, 10)
    torch.cuda.synchronize()
    dt = time.time() - t0
    record("rlc_kmer_table",
           {k: v.launches for k, v in native.KERNELS.items()},
           {f"{k}.{e}": c for k, v in native.KERNELS.items()
            for e, c in v.by_entry.items()})
    codes = torch.from_numpy(rng.integers(0, 4 ** 10, 65_536)).to(dev)
    kmers = ((codes[:, None] >> (2 * torch.arange(9, -1, -1, device=dev)))
             & 3).to(torch.uint8).contiguous()
    want = extend.zero_empty(extend.exact_match_plain(bm, kmers))
    if not torch.equal(table[codes], want):
        raise AssertionError("the RLC k-mer table differs from the plain "
                             "exact match of its k-mers")
    log(f"path rlc_kmer_table: 10-mer table of the RLC index ({4 ** 10} "
        f"lanes x 8) in {dt:.3f} s, {int((table[:, 1] > table[:, 0]).sum())}"
        f" k-mers occur; 65,536 sampled rows equal the plain exact match; "
        f"kernel A's RLC entry launched "
        f"{native.KERNELS['extend'].by_entry.get('rlc', 0)} times")
    if native.KERNELS["extend"].by_entry.get("rlc", 0) == 0:
        raise AssertionError("extend.rlc not launched by the RLC k-mer "
                             "table build")
    del table, codes, kmers, want

    def fq(tag, codes, prefix="r"):
        path = os.path.join(wd, tag + ".fq")
        workload.write_fastq(path, codes, prefix)
        return path

    se = (fq("pan_se", reads), None)
    se_warm = (fq("pan_w", reads[:RLC_WARMUP], "w"), None)
    for path in RLC_PATHS:
        index_of[path] = idx_of["textless" if path.startswith("tl")
                                else "rlc"]
        files[path], warm[path], n_of[path] = se, se_warm, N_RLC_READS
    files["rlc_pe_best"] = files["rlc_pe_best_c"] = (
        fq("pan_p1", m1), fq("pan_p2", m2))
    warm["rlc_pe_best"] = warm["rlc_pe_best_c"] = (
        fq("pan_w1", m1[:RLC_WARMUP], "w"), fq("pan_w2", m2[:RLC_WARMUP], "w"))
    n_of["rlc_pe_best"] = n_of["rlc_pe_best_c"] = N_RLC_PAIRS
    all_k = ["-a", "all", "-e", str(K), "-nD"]   # the JAX package's bench
    argv_of.update(rlc_se_all=all_k, tl_se_all=all_k,
                   rlc_se_best=["-a", "best"], tl_se_best=["-a", "best"],
                   rlc_pe_best=["-a", "best"],
                   rlc_se_all_dynamic=all_k + ["-p", "dynamic"],
                   rlc_se_best_d=["-a", "best", "-d", collection],
                   rlc_pe_best_c=["-a", "best", "-c",
                                  os.path.join(SCHEMES, "kuch_k+1")])
    for path in RLC_PATHS:
        drive(path, f"pan-genome {n} bp, {path.split('_')[0]} index")

    # -- checks of what came out: the pan-genome is one sequence --
    seq_ids = {"pan": 0}

    def key(q, rev):
        return q * 2 + rev

    want_p1 = pos + 1
    occ_sets = {}
    for tag in ("rlc_se_all", "tl_se_all", "rlc_se_all_dynamic"):
        q, _, p1, fl, nm = parse_sam(os.path.join(wd, tag + ".sam"), seq_ids)
        want = np.nonzero(nsub <= K)[0]
        dist, _ = nearest((key(q, (fl & 16) > 0), p1, nm),
                          key(want, flip[want]), want_p1[want])
        lost = want[dist > K]
        log(f"{tag} lossless check: {len(want)} reads with <= {K} "
            f"substitutions; {int((dist == 0).sum())} at their exact begin, "
            f"{int(((dist > 0) & (dist <= K)).sum())} within {K} (end "
            f"errors), {len(lost)} missing; {len(q)} records")
        if len(lost):
            raise AssertionError(f"{tag}: reads not found at their locus: "
                                 f"{lost[:10].tolist()}")
        occ_sets[tag] = np.unique(np.stack([q, p1, fl & 16, nm], axis=1),
                                  axis=0)
    # both runs are lossless at k: -p dynamic reports the same occurrences
    a, b = occ_sets["rlc_se_all"], occ_sets["rlc_se_all_dynamic"]
    same = a.shape == b.shape and bool((a == b).all())
    log(f"rlc_se_all_dynamic against rlc_se_all on the same FASTQ: {len(b)} "
        f"and {len(a)} distinct (read, position, strand, NM) records, "
        f"{'the same set' if same else 'DIFFERENT sets'}")
    if not same:
        raise AssertionError("rlc_se_all_dynamic reports another occurrence "
                             "set than rlc_se_all")
    for tag in ("rlc_se_best", "tl_se_best", "rlc_se_best_d"):
        q, _, p1, fl, nm = parse_sam(os.path.join(wd, tag + ".sam"), seq_ids)
        best_nm = np.full(N_RLC_READS, 1 << 40, np.int64)
        np.minimum.at(best_nm, q, nm)
        want = np.nonzero(nsub <= BEST_CUT)[0]
        unmapped = want[best_nm[want] > BEST_CUT]
        worse = want[best_nm[want] > nsub[want]]
        at_n = want[best_nm[want] == nsub[want]]
        dist, _ = nearest((key(q, (fl & 16) > 0), p1, nm),
                          key(at_n, flip[at_n]), want_p1[at_n])
        lost = at_n[dist > nsub[at_n]]
        log(f"{tag} check: {len(want)} reads with <= {BEST_CUT} "
            f"substitutions; {len(unmapped)} without a record, {len(worse)} "
            f"with best NM above their substitutions, {len(at_n)} with best "
            f"NM equal to them of which {len(lost)} miss their locus; "
            f"{len(q)} records")
        if len(unmapped) or len(worse) or len(lost):
            raise AssertionError(
                f"{tag}: unmapped {unmapped[:5].tolist()}, worse "
                f"{worse[:5].tolist()}, lost {lost[:5].tolist()}")
    # PE BEST reports the pairs of least total distance; on the pan-genome
    # another haplotype may hold a better pair than the sampled one, so a
    # pair is missing when its best reported total is above its
    # substitutions, or equal to them without the sampled loci among the
    # pairs at that total
    want = np.nonzero((nsub1 <= 2) & (nsub2 <= 2))[0]
    t1 = np.where(swapped, pos_r, pos_f) + 1      # mate 1's sampled pos1
    t2 = np.where(swapped, pos_f, pos_r) + 1
    for tag in ("rlc_pe_best", "rlc_pe_best_c"):
        pairs = proper_pairs(os.path.join(wd, tag + ".sam"))
        missing, better = [], 0
        for i in want:
            got = pairs.get(int(i), [])
            best = min((tot for *_, tot in got), default=1 << 30)
            true_tot = int(nsub1[i] + nsub2[i])
            if best < true_tot:
                better += 1
            elif best > true_tot or not any(
                    tot == best and abs(a - t1[i]) <= 2
                    and abs(b - t2[i]) <= 2 for a, b, tot in got):
                missing.append(int(i))
        log(f"{tag} check: {len(want)} pairs with <= 2 substitutions in "
            f"each mate; {len(want) - better - len(missing)} reported as a "
            f"proper pair at both sampled loci, {better} with a better pair "
            f"elsewhere, {len(missing)} missing; {len(pairs)} pairs with a "
            f"proper pair")
        if missing:
            raise AssertionError(f"{tag}: pairs not found: {missing[:10]}")

    # one batch of each flavor again through the plain versions on the
    # card, and on the RLC index with dynamic partitioning and with scheme
    # selection (kuch1 and its mirror)
    for what, index, kw, nr in (
            ("the RLC index, switchpoint 4", bm, dict(switchpoint=4), BATCH),
            ("the textless index", tl, dict(host_arrays=arrays["textless"]),
             PLAIN_TL_READS),
            ("the RLC index, dynamic partitioning", bm,
             dict(switchpoint=4, partitioning="dynamic"), PLAIN_TL_READS),
            ("the RLC index, scheme selection", bm,
             dict(switchpoint=4, selection=True), PLAIN_TL_READS)):
        scheme = (get_multi_scheme("kuch1", K) if kw.pop("selection", False)
                  else get_scheme("kuch1", K))
        occ_k, _ = pipeline.match_all(index, reads[:nr], scheme, **kw)
        restore = plain_patch()
        try:
            occ_p, _ = pipeline.match_all(index, reads[:nr], scheme, **kw)
        finally:
            restore()
        for f in ("read_id", "strand", "begin", "end", "distance"):
            if not np.array_equal(getattr(occ_k, f), getattr(occ_p, f)):
                raise AssertionError(f"plain-path OccArray differs in {f} "
                                     f"on {what}")
        log(f"plain versions on the card, {what}, k = {K}: identical "
            f"OccArray for one batch of {nr} reads ({len(occ_k)} "
            f"occurrences)")
    return report


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available"
                         "() is false); this script runs only on the card")
    from columba_tpu_torch import cli, native
    from columba_tpu_torch.index.build import decoded_text, load_index
    from columba_tpu_torch.index.fmindex import FMIndex
    from columba_tpu_torch.index.kmer import build_kmer_table_cached
    from columba_tpu_torch.search import executor, pipeline
    from columba_tpu_torch.search.scheme import get_multi_scheme, get_scheme
    from columba_tpu_torch.tools import path_inputs, workload

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
    for ln in native.ptxas_report(native.build_log.get("kernels", "")):
        log(f"  ptxas {ln}")
        if ln.startswith(NO_FRAME) and "stack frame" in ln:
            raise AssertionError(f"local memory in {ln}")

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
            "pe_best_static": (fq("s1", m1[:N_PAIRS_STATIC]),
                               fq("s2", m2[:N_PAIRS_STATIC])),
        }
        # the dynamic and the collection path read the SE ALL path's FASTQ
        files["se_all_dynamic"] = files["se_best_d"] = files["se_all"]
        warm = {
            "se_all": (fq("w", reads[:WARMUP_READS], "w"), None),
            "pe_best": (fq("w1", m1[:WARMUP_READS], "w"),
                        fq("w2", m2[:WARMUP_READS], "w")),
        }
        warm["se_best"] = warm["se_all"]
        warm["pe_all_e0"] = (fq("we1", m1[exact_pairs[:4096]], "w"),
                             fq("we2", m2[exact_pairs[:4096]], "w"))
        warm["pe_all_e2"] = warm["pe_best_static"] = warm["pe_best"]
        warm["se_all_dynamic"] = warm["se_best_d"] = warm["se_all"]
        # a collection of two schemes per k: kuch_k+1's searches and their
        # mirror, in the layout -d reads (<dir>/<k>/scheme<x>.txt)
        multi = os.path.join(wd, "collection")
        for k in range(1, BEST_CUT + 1):
            os.makedirs(os.path.join(multi, str(k)))
            base = get_scheme("kuch1", k)
            for x, sc in enumerate((base, base.mirrored()), 1):
                with open(os.path.join(multi, str(k), f"scheme{x}.txt"),
                          "w") as f:
                    f.write(str(sc) + "\n")
        argv_of = {
            "se_all": ["-a", "all", "-e", str(K)],
            "se_best": ["-a", "best"],
            "pe_best": ["-a", "best"],
            "pe_all_e0": ["-a", "all", "-e", "0"],
            "pe_all_e2": ["-a", "all", "-e", str(K)],
            "se_all_dynamic": ["-a", "all", "-e", str(K), "-p", "dynamic"],
            "se_best_d": ["-a", "best", "-d", multi],
            "pe_best_static": ["-a", "best", "-p", "static", "-nD", "-c",
                               os.path.join(SCHEMES, "kuch_k+1")],
        }
        n_of = {"se_all": N_READS_ALL, "se_best": N_READS,
                "pe_best": N_READS, "pe_all_e0": len(exact_pairs),
                "pe_all_e2": N_PAIRS_E2, "se_all_dynamic": N_READS_ALL,
                "se_best_d": N_READS_ALL, "pe_best_static": N_PAIRS_STATIC}

        index = FMIndex.from_arrays(arrays, dev)
        # kernel A's main entry: the 10-mer seed table, built through the
        # cached table build that cli align calls (10 launches of
        # extend_char)
        for k in native.KERNELS.values():
            k.reset()
        t0 = time.time()
        table = build_kmer_table_cached(index, 10, idx)
        torch.cuda.synchronize()
        kmer_launches = {k: v.launches for k, v in native.KERNELS.items()}
        log(f"index on device: {index.nbytes()} bytes + k-mer table "
            f"{table.nbytes} bytes, built in {time.time() - t0:.2f} s with "
            f"{kmer_launches['extend']} launches of kernel A")
        if kmer_launches["extend"] == 0:
            raise AssertionError("kernel A not launched by the k-mer table "
                                 "build")
        report = kernel_checks(index, arrays, reads, table)

        index_of = {}                # path -> index dir (default: idx)

        def align(path, files_, out_tag, extra=()):
            argv = ["align", "-r", index_of.get(path, idx), "-S", "kuch1",
                    "-b", str(BATCH), "-f", files_[0],
                    "-o", os.path.join(wd, out_tag + ".sam"),
                    *argv_of[path], *extra]
            if files_[1] is not None:
                argv += ["-F", files_[1]]
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = cli.main(argv)
            assert rc == 0
            return err.getvalue()

        launches_by_path = {"kmer_table": kmer_launches}
        entries_by_path = {"kmer_table": {}}

        def record(path, launches, entries):
            launches_by_path[path] = launches
            entries_by_path[path] = entries

        runs = [0]                   # run_scheme calls of a path
        run_scheme = executor.run_scheme

        def counted_run_scheme(*a, **kw):
            runs[0] += 1
            return run_scheme(*a, **kw)

        def drive(path, genome_what):
            """One path: a warm-up align, then the counted and timed one
            with every launch count reset just before. On the paths of
            ``CAPTURE_PATHS`` the warm-up's inputs to kernels C and D are
            kept, and those kernels are timed on them after the path."""
            t0 = time.time()
            warm_up = lambda: align(path, warm[path], "warm")  # noqa: E731
            captured = (path_inputs.capture(warm_up) if path in CAPTURE_PATHS
                        else warm_up())
            t_warm = time.time() - t0
            for k in native.KERNELS.values():
                k.reset()
            runs[0] = 0
            log_path = os.path.join(wd, path + ".log")
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            executor.run_scheme = counted_run_scheme
            t0 = time.time()
            try:
                err = align(path, files[path], path, ("-v", "-l", log_path))
                torch.cuda.synchronize()
            finally:
                executor.run_scheme = run_scheme
            dt = time.time() - t0
            launches = {k: v.launches for k, v in native.KERNELS.items()}
            launches_by_path[path] = launches
            entries = {f"{k}.{e}": n for k, v in native.KERNELS.items()
                       for e, n in v.by_entry.items()}
            entries_by_path[path] = entries
            peak = torch.cuda.max_memory_allocated()
            with open(log_path) as f:
                retries = int(re.search(
                    r"Lossless spill retries[^:]*: (\d+)", f.read()).group(1))
            unit = "pairs" if files[path][1] else "reads"
            log(f"path {path}: {n_of[path]} {unit} x {READ_LEN} bp in "
                f"{dt:.3f} s = {n_of[path] / dt:.1f} {unit}/s (FASTQ -> SAM, "
                f"{genome_what}, {smi}; warm-up "
                f"{t_warm:.1f} s); lossless retries {retries}; peak device "
                f"memory {peak} bytes; kernel launches {launches}"
                + (f", of them by entry {entries}" if entries else ""))
            for ln in err.splitlines():
                if "inferred" in ln:
                    log(f"  {ln}")
            loops = sum(v for e, v in entries.items()
                        if e in ("extend.loop", "extend.loop_rlc"))
            log(f"  kernel A's loop: {loops} launches in {runs[0]} "
                f"run_scheme calls"
                + (f" ({loops / runs[0]:.2f} per call)" if runs[0] else "")
                + f"; kernel B: {launches['band_step']} launches")
            if loops > 2 * runs[0]:
                raise AssertionError(f"path {path}: more than two exact "
                                     "loop launches per run_scheme call")
            missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
            missing += [e for e in PATH_ENTRIES.get(path, ())
                        if entries.get(e, 0) == 0]
            if missing:
                raise AssertionError(f"kernels not launched on path {path}: "
                                     f"{missing}")
            if path in DYNAMIC_PATHS:
                batches = -(-n_of[path] // BATCH)
                log(f"  kernel F: {launches['dynpart']} launches for "
                    f"{batches} batches, {retries} lossless re-runs")
                if launches["dynpart"] != batches:
                    raise AssertionError(f"path {path}: kernel F launched "
                                         f"{launches['dynpart']} times for "
                                         f"{batches} batches")
            if path in CAPTURE_PATHS:
                path_input_times(path, captured, smi)

        for path in PATH_KERNELS:
            if path not in RLC_PATHS:
                drive(path, f"genome {workload.GENOME_N} bp")

        # kernel H's path: the gather bench, its entry point, at one size
        from columba_tpu_torch.tools import gather_bench

        for k in native.KERNELS.values():
            k.reset()
        gather_rows = gather_bench.run(lanes=(GATHER_LANES,),
                                       row_words=(16, 4), reps=5)
        launches = {k: v.launches for k, v in native.KERNELS.items()}
        launches_by_path["gather_bench"] = launches
        entries_by_path["gather_bench"] = {}
        for r in gather_rows:
            log(f"path gather_bench: {r['impl']}, {r['row_bytes']} B rows, "
                f"{r['lanes']} lanes, chain of {gather_bench.CHAIN}: "
                f"{r['chain_ms']:.4f} ms = {r['mrows_per_s']:.1f} M rows/s, "
                f"{r['gbps']:.2f} GB/s; one gather alone "
                f"{r['alone_ms']:.4f} ms = {r['alone_mrows_per_s']:.1f} M "
                f"rows/s ({smi})")
        if launches["gather"] == 0:
            raise AssertionError("kernel gather not launched by its bench")

        # -- checks of what came out --
        def se_key(q, rn, rev):
            return q * 8 + rn * 2 + rev

        seq_of = np.searchsorted(starts, pos, side="right") - 1
        want_p1 = pos - starts[seq_of] + 1

        # SE ALL: every read with <= K substitutions at its locus
        def se_all_check(tag, label):
            recs = parse_sam(os.path.join(wd, tag + ".sam"))
            q, rn, p1, fl, nm = recs
            want = np.nonzero(nsub[:N_READS_ALL] <= K)[0]
            dist, _ = nearest((se_key(q, rn - 1, (fl & 16) > 0), p1, nm),
                              se_key(want, seq_of[want], flip[want]),
                              want_p1[want])
            # an error at a read end has equal-cost alignments that begin up
            # to k bases away; the traceback may pick one
            lost = want[dist > K]
            log(f"{label} lossless check: {len(want)} reads with <= {K} "
                f"substitutions; {int((dist == 0).sum())} at their exact "
                f"begin, {int(((dist > 0) & (dist <= K)).sum())} within {K} "
                f"(end errors), {len(lost)} missing")
            if len(lost):
                raise AssertionError(f"{label}: reads not found at their "
                                     f"locus: {lost[:10].tolist()}")
            return recs

        uni = se_all_check("se_all", "SE ALL")
        dyn = se_all_check("se_all_dynamic", "SE ALL -p dynamic")
        # both runs are lossless at k, so they report the same occurrences
        occ_sets = [np.unique(np.stack([q, rn, p1, fl & 16, nm], axis=1),
                              axis=0) for q, rn, p1, fl, nm in (uni, dyn)]
        same = (occ_sets[0].shape == occ_sets[1].shape
                and bool((occ_sets[0] == occ_sets[1]).all()))
        log(f"SE ALL -p dynamic against SE ALL (uniform) on the same FASTQ: "
            f"{len(occ_sets[1])} and {len(occ_sets[0])} distinct (read, "
            f"sequence, position, strand, NM) records, "
            f"{'the same set' if same else 'DIFFERENT sets'}")
        if not same:
            raise AssertionError("SE ALL -p dynamic reports another "
                                 "occurrence set than the uniform run")

        # SE BEST: every read with n <= cutoff substitutions has a record,
        # its best NM is <= n, and where it equals n the true locus is there
        def se_best_check(tag, label, n_reads):
            q, rn, p1, fl, nm = parse_sam(os.path.join(wd, tag + ".sam"))
            best_nm = np.full(n_reads, 1 << 40, np.int64)
            np.minimum.at(best_nm, q, nm)
            want = np.nonzero(nsub[:n_reads] <= BEST_CUT)[0]
            unmapped = want[best_nm[want] > BEST_CUT]
            worse = want[best_nm[want] > nsub[want]]
            at_n = want[best_nm[want] == nsub[want]]
            dist, _ = nearest((se_key(q, rn - 1, (fl & 16) > 0), p1, nm),
                              se_key(at_n, seq_of[at_n], flip[at_n]),
                              want_p1[at_n])
            lost = at_n[dist > nsub[at_n]]
            log(f"{label} check: {len(want)} reads with <= {BEST_CUT} "
                f"substitutions; {len(unmapped)} without a record, "
                f"{len(worse)} with best NM above their substitutions, "
                f"{len(at_n)} with best NM equal to them of which "
                f"{len(lost)} miss their locus; "
                f"{len(want) - len(at_n) - len(worse)} have a better hit "
                f"elsewhere; {len(q)} records")
            if len(unmapped) or len(worse) or len(lost):
                raise AssertionError(
                    f"{label}: unmapped {unmapped[:5].tolist()}, worse "
                    f"{worse[:5].tolist()}, lost {lost[:5].tolist()}")

        se_best_check("se_best", "SE BEST", N_READS)
        se_best_check("se_best_d", "SE BEST -d (two-scheme collection)",
                      N_READS_ALL)

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
        want = want[want < N_PAIRS_STATIC]
        found, n_proper = pe_check(os.path.join(wd, "pe_best_static.sam"),
                                   want, want, 2)
        log(f"PE BEST -p static -c -nD check: {len(want)} pairs with <= 2 "
            f"substitutions in each mate; {int(found.sum())} reported as a "
            f"proper pair at both true loci, {int((~found).sum())} missing; "
            f"{n_proper} proper-pair records")
        if not found.all():
            raise AssertionError(f"PE BEST -p static: pairs not found: "
                                 f"{want[~found][:10].tolist()}")

        # one batch again through the plain versions on the card: the scheme
        # path at k = 2, the exact pass at k = 0, dynamic partitioning, and
        # scheme selection over kuch1 and its mirror
        for k, kw in ((K, dict(kmer_table=table, switchpoint=4)), (0, {}),
                      (K, dict(kmer_table=table, switchpoint=4,
                               partitioning="dynamic")),
                      (K, dict(kmer_table=table, switchpoint=4,
                               selection=True))):
            scheme = get_scheme("kuch1", k)
            if kw.pop("selection", False):
                scheme = get_multi_scheme("kuch1", k)
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
            what = ("scheme selection" if isinstance(scheme, list) else
                    kw.get("partitioning", "uniform") + " partitioning")
            log(f"plain versions on the card, k = {k}, {what}: identical "
                f"OccArray for one batch ({len(occ_k)} occurrences)")

        del index, table         # card memory for the RLC indexes
        report.update(rlc_section(
            wd, dev, smi, idx, drive, record, multi, files, warm, argv_of,
            n_of, index_of))

    # one record per kernel, and one more for each named entry of kernels
    # A, B, C and E (its launches are a share of its kernel's)
    replaces = {"band_step.per_lane": "columba_tpu/search/executor.py:600",
                "exact.lengths": "columba_tpu/search/pipeline.py:381",
                "extend.loop": "columba_tpu/search/executor.py:437",
                "extend.loop_rlc": "columba_tpu/search/executor.py:437",
                "band_step.rlc": "columba_tpu/search/executor.py:587",
                "band_step.textless": "columba_tpu/search/pipeline.py:770",
                "exact.rlc": "columba_tpu/ops/bextend.py:259",
                "locate.rlc": "columba_tpu/ops/blocate.py:40",
                "extend.rlc": "columba_tpu/ops/bextend.py:259",
                "exact.rlc_lengths": "columba_tpu/search/pipeline.py:381",
                "dynpart.rlc": "columba_tpu/search/dynschedule.py:283",
                "band_step.per_lane_rlc":
                    "columba_tpu/search/executor.py:600"}
    kernels = []
    for k in native.KERNELS.values():
        entries = [k.name] + [n for n in report if n.startswith(k.name + ".")]
        for entry in entries:
            r = report[entry]
            counts = launches_by_path if entry == k.name else entries_by_path
            by_path = {p: ln.get(entry, 0) for p, ln in counts.items()}
            if sum(by_path.values()) == 0:
                raise AssertionError(f"kernel {entry} launched on no path")
            kernels.append(dict(
                name=entry, route="cuda",
                source=k.source_of(entry.partition(".")[2]),
                replaces=replaces.get(entry, k.replaces),
                launches=sum(by_path.values()), launches_by_path=by_path,
                max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"],
                bound_bytes=r["bound_bytes"],
                bound_operations=r["bound_operations"]))
    log(f"total smoke time {time.time() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
