"""Row-gather microbenchmark on the card, and kernel H.

The counterpart of ``tools/pgather_bench.py`` and ``tools/gather_bench.py``
of the JAX package: the random row read behind every rank query (kernels A,
B, C and E read fused 64 B occ rows at data-dependent addresses), measured
alone. A table of 2,000,000 rows (128 Mbp / 128 chars per block x 2
directions) is gathered at 8,192, 49,152 and 262,144 lanes, 32 gathers in a
chain whose next indices come from the rows just fetched (as an LF walk's
do), for rows of 64, 32 and 16 B. Two implementations are timed in turns with
CUDA events: kernel H (``csrc/gather.cu``, W/4 threads a row) and
``torch.index_select``, the library call of the same function. Each is first
held against ``table[idx]``.

The chain's index arithmetic is a handful of small PyTorch launches per
gather, so at these lane counts the chain also measures launch overhead.
Each implementation is therefore timed alone as well: single gathers in a
row over 16 different index sets, so that no set finds its rows in the L2
cache (16 x 262,144 x 64 B = 268 MB against 50 MB).

Run on the card:  python -m columba_tpu_torch.tools.gather_bench
Prints one JSON line per (row bytes, lanes, implementation) with the chain's
M rows/s and GB/s (rows fetched x row bytes) and the single gather's, then
the card's name and power limit.
No library module calls kernel H.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from columba_tpu_torch import native

ROWS = 2_000_000
CHAIN = 32
LANES = (8192, 49152, 262144)
ROW_WORDS = (16, 8, 4)         # 64, 32 and 16 B rows

KERNEL = native.Kernel(
    "gather", "columba_gather",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,    # table, rows, words
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64],  # idx, out, n
    source="columba_tpu_torch/csrc/gather.cu",
    replaces="tools/pgather_bench.py:90",
)


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel H: ``table[idx]`` with clamped indices."""
    return table[idx.clamp(0, table.shape[0] - 1)]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(T, W) int32 table, (N,) int64 indices -> (N, W) rows; W is 4, 8 or
    16 words. The plain version for CPU tensors, kernel H for CUDA
    tensors."""
    if not table.is_cuda:
        return gather_rows_plain(table, idx)
    T, W = table.shape
    if (table.dtype != torch.int32 or W not in (4, 8, 16)
            or not table.is_contiguous() or idx.dtype != torch.int64
            or idx.dim() != 1 or not idx.is_contiguous()
            or idx.device != table.device):
        raise ValueError("kernel H takes a contiguous (T, 4|8|16) int32 "
                         "table and contiguous (N,) int64 indices on one "
                         "device")
    out = torch.empty((idx.shape[0], W), dtype=torch.int32,
                      device=table.device)
    if idx.shape[0]:
        KERNEL(table.data_ptr(), T, W, idx.data_ptr(), out.data_ptr(),
               idx.shape[0])
    return out


IMPLS = {
    "kernel_h": gather_rows,
    "index_select": lambda t, i: torch.index_select(t, 0, i),
}


def chain(gather, table, idx, steps: int = CHAIN):
    """``steps`` gathers, each one's indices taken from the rows the one
    before fetched; returns the last indices and a checksum."""
    acc = torch.zeros_like(idx)
    for _ in range(steps):
        rows = gather(table, idx)
        acc = acc + rows[:, 0]
        idx = ((rows[:, 1] ^ rows[:, 2]).long() % table.shape[0])
    return idx, acc.sum()


def bench_one(gather, table, idx0, reps: int) -> float:
    """Mean ms of one chain of CHAIN gathers (CUDA events)."""
    chain(gather, table, idx0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        chain(gather, table, idx0)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_alone(gather, table, idx_sets, reps: int) -> float:
    """Mean ms of one gather, cycling through ``idx_sets`` (CUDA events)."""
    for idx in idx_sets:
        gather(table, idx)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for idx in idx_sets:
            gather(table, idx)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(idx_sets))


def run(lanes=LANES, row_words=ROW_WORDS, reps: int = 10, rows: int = ROWS,
        seed: int = 3) -> list:
    """The bench on the current CUDA device; returns one dict per (row
    bytes, lanes, implementation). Raises without a card."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    full = torch.from_numpy(
        rng.integers(0, 2 ** 31, size=(rows, 16)).astype(np.int32)).to(dev)
    results = []
    for words in row_words:
        table = full[:, :words].contiguous()
        for n in lanes:
            idx0 = torch.from_numpy(
                np.random.default_rng(5).integers(0, rows, size=n)).to(dev)
            want = gather_rows_plain(table, idx0)
            idx_sets = [torch.from_numpy(np.random.default_rng(
                100 + j).integers(0, rows, size=n)).to(dev)
                for j in range(16)]
            ms, alone = {}, {}
            for name, fn in IMPLS.items():
                if not torch.equal(fn(table, idx0), want):
                    raise AssertionError(f"{name} differs from table[idx] "
                                         f"at {words * 4} B rows, {n} lanes")
                ms[name], alone[name] = [], []
            for _ in range(2):                   # in turns: a, b, a, b
                for name, fn in IMPLS.items():
                    ms[name].append(bench_one(fn, table, idx0, reps))
                    alone[name].append(bench_alone(fn, table, idx_sets,
                                                   reps))
            for name in IMPLS:
                t, ta = min(ms[name]), min(alone[name])
                rate = CHAIN * n / (t * 1e-3)
                rate_a = n / (ta * 1e-3)
                results.append(dict(
                    impl=name, row_bytes=words * 4, lanes=n,
                    chain_ms=t, mrows_per_s=rate / 1e6,
                    gbps=rate * words * 4 / 1e9, alone_ms=ta,
                    alone_mrows_per_s=rate_a / 1e6,
                    alone_gbps=rate_a * words * 4 / 1e9))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON lines "
                    "to this file")
    args = ap.parse_args(argv)
    try:
        torch.zeros(1, device="cuda")
    except (RuntimeError, AssertionError) as e:
        raise SystemExit("gather_bench: no usable CUDA device; this tool "
                         "measures the card") from e
    results = run()
    lines = [json.dumps(r) for r in results]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    lines.append(json.dumps(dict(card=smi, rows=ROWS, chain=CHAIN)))
    print("\n".join(lines))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
