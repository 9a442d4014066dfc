"""Batched locate: SA row -> text position, and kernel C.

The counterpart of ``columba_tpu/ops/locate.py``. A dense suffix array
(sparseness 1) is one gather. A sparse one walks LF from each row until a
marked row (SA[i] % f == 0 sampling bounds the walk at f-1 steps), then
reads the sample and adds the step count: the plain PyTorch version below
on the CPU, kernel C (``csrc/locate.cu``) on the card.
"""

from __future__ import annotations

import ctypes

import torch

from columba_tpu_torch import native
from columba_tpu_torch.index.fmindex import FMIndex
from columba_tpu_torch.ops import rank

KERNEL = native.Kernel(
    "locate", "columba_locate",
    [ctypes.c_void_p,                                    # occ_fused
     ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
     ctypes.c_uint32,                                    # counts, dollar_fwd
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # bits/rank/samples
     ctypes.c_int32,                                     # sparseness
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64],  # rows, out, count
    source="columba_tpu_torch/csrc/locate.cu",
    replaces="columba_tpu/ops/locate.py:38",
)


def lf_step(index: FMIndex, rows: torch.Tensor) -> torch.Tensor:
    """LF(row) on the forward BWT; the row's own char comes from the same
    occ row read. The '$' row maps to 0."""
    occ4, c = rank.occ_all_and_char(index.occ_fused, rows)
    occ4[..., 0] -= rank.cnt_dollar(index.dollar[0], rows)
    lf = index.counts[c] + occ4.gather(-1, c[..., None])[..., 0]
    return torch.where(rows == index.dollar[0], torch.zeros_like(lf), lf)


def locate_rows_plain(index: FMIndex, rows: torch.Tensor) -> torch.Tensor:
    """Sparse-SA LF-walk (plain version of kernel C)."""
    steps = torch.zeros_like(rows)
    cur = rows
    for _ in range(max(index.sa_sparseness - 1, 0)):
        sampled = rank.get_bit(index.sa_bits, cur)
        cur = torch.where(sampled, cur, lf_step(index, cur))
        steps = torch.where(sampled, steps, steps + 1)
    idx = rank.rank_bits(index.sa_bits, index.sa_bits_rank, cur)
    return (rank.u32(index.sa_samples[idx]) + steps) & rank.MASK32


def locate_rows(index: FMIndex, rows: torch.Tensor) -> torch.Tensor:
    """Text position SA[row] (int64) for each (N,) int64 row."""
    if index.sa_sparseness == 1:
        # dense SA: sa_samples IS the suffix array in row order
        return rank.u32(index.sa_samples[rows])
    if not rows.is_cuda:
        return locate_rows_plain(index, rows)
    if rows.dtype != torch.int64 or rows.dim() != 1 or not rows.is_contiguous():
        raise ValueError("rows must be a contiguous 1-D int64 tensor")
    for t in (index.occ_fused, index.sa_bits, index.sa_samples):
        if t.device != rows.device:
            raise ValueError("index and rows must be on one device")
    out = torch.empty_like(rows)
    if rows.numel():
        KERNEL(index.occ_fused.data_ptr(), *index.counts_host,
               index.dollar_host[0], index.sa_bits.data_ptr(),
               index.sa_bits_rank.data_ptr(), index.sa_samples.data_ptr(),
               index.sa_sparseness, rows.data_ptr(), out.data_ptr(),
               rows.numel())
    return out
