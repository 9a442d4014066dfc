"""Locate on the RLC (b-move) index: plain version of kernel C's RLC entry.

The counterpart of ``columba_tpu/ops/blocate.py``: SA[row] = SA[LF^t(row)]
+ t for the first t at which the walk lands on a sampled row. Samples sit
at every run head and tail and at every ``stride``-th BWT row
(``index/bmove.py``), so t <= stride however long the runs are. Each LF
step is the row's run's LF position plus its offset in the run, and the
run hint follows by fast-forward (uncapped: the walk stays within the
destination interval of one run).

``locate_rows_plain`` returns int64 positions (uint32 values); with
``stats`` it counts what kernel C's RLC entry reads (``tools/bounds.py``):
``bucket``, the walk-table words that finding each row's run from its
bucket's run takes (``index/bmove.py`` ``locate_tables``), ``steps``, the
LF steps, and ``walk``, the walk-table words of those steps and their
fast-forwards.
"""

from __future__ import annotations

import torch

from columba_tpu_torch.index.bmove import (
    BMoveIndex, END, LF_POS, LF_RUN, SA_FIRST, SA_LAST, START,
)
from columba_tpu_torch.ops.bextend import MASK32, sext32


def _col(index, rows, col):
    return index.fused[rows, col].long() & MASK32


def run_of_rows(index: BMoveIndex, rows: torch.Tensor) -> torch.Tensor:
    """Binary-search the fwd run interval containing each row."""
    R = index.r_fwd
    lo = torch.zeros_like(rows)
    hi = torch.full_like(rows, R - 1)
    for _ in range(max(1, (R + 1).bit_length())):
        mid = (lo + hi + 1) >> 1
        go = _col(index, mid, START) <= rows
        lo = torch.where(go, mid, lo)
        hi = torch.where(go, hi, mid - 1)
    return lo


def _at_boundary(index: BMoveIndex, pos, run):
    start, end = _col(index, run, START), _col(index, run, END)
    head = pos == start
    tail = pos == end - 1
    strided = (pos & (index.stride - 1)) == 0
    val = torch.where(head, _col(index, run, SA_FIRST),
                      _col(index, run, SA_LAST))
    if index.sa_stride.numel():
        shift = index.stride.bit_length() - 1
        sidx = (pos >> shift).clamp(max=index.sa_stride.numel() - 1)
        val = torch.where(strided & ~(head | tail),
                          index.sa_stride[sidx].long() & MASK32, val)
    return head | tail | strided, val


def locate_rows_plain(index: BMoveIndex, rows: torch.Tensor,
                      stats: dict | None = None) -> torch.Tensor:
    """Text position for each (N,) int64 fwd-BWT row (bounded LF-walks)."""
    runs = run_of_rows(index, rows)
    tables = index.walk is not None and index.walk.numel() > 0
    if stats is not None and tables:
        # the bucket's run, then one word a run up to the row's
        first = index.run_at[rows >> index.run_shift].long()
        stats["bucket"] = stats.get("bucket", 0) + int(
            (runs - first + 1).sum())
    done, val = _at_boundary(index, rows, runs)
    val = torch.where(done, val, 0)
    pos, run = rows, runs
    steps = torch.zeros_like(rows)
    while not bool(done.all()):
        new_pos = _col(index, run, LF_POS) + (pos - _col(index, run, START))
        new_pos = torch.where(done, 0, new_pos & MASK32)
        new_run = torch.where(done, 0, sext32(_col(index, run, LF_RUN)))
        walked = torch.zeros_like(rows)
        while True:
            adv = _col(index, new_run, END) <= new_pos
            if not bool(adv.any()):
                break
            new_run = new_run + adv.long()
            walked += adv.long()
        if stats is not None:
            live = ~done
            stats["steps"] = stats.get("steps", 0) + int(live.sum())
            stats["walk"] = stats.get("walk", 0) + int(
                ((walked + 1) * live).sum())
        pos = torch.where(done, pos, new_pos)
        run = torch.where(done, run, new_run)
        steps = torch.where(done, steps, steps + 1)
        bnd, v = _at_boundary(index, pos, run)
        val = torch.where(done, val, torch.where(bnd, (v + steps) & MASK32,
                                                 val))
        done = done | bnd
    # the row of suffix '$' (position n) maps to n
    return torch.minimum(val, torch.full_like(val, index.n))
