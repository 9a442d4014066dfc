"""Batched bidirectional SA-interval extension, and kernel A.

The counterpart of ``columba_tpu/ops/extend.py``: every lane extends its
range pair ``[f_lo, f_hi, r_lo, r_hi)`` by all four characters (or by its
own character) from the two occ rows at the active interval's endpoints.
dir 0 extends backward (prepend; forward BWT), dir 1 forward (append;
reverse BWT), and the direction is a block-row offset into the
concatenated table, so lanes may mix directions.

Ranges are int64 tensors holding uint32 values (see ``ops/rank.py``).

``extend_all`` / ``extend_char`` take the plain PyTorch version for CPU
tensors and launch kernel A (``csrc/extend.cu``) for CUDA tensors.
"""

from __future__ import annotations

import ctypes

import torch

from columba_tpu_torch import native
from columba_tpu_torch.index.fmindex import FMIndex
from columba_tpu_torch.ops import rank

MASK32 = rank.MASK32

KERNEL = native.Kernel(
    "extend", "columba_extend",
    [ctypes.c_void_p, ctypes.c_int64,                    # occ_fused, blocks
     ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
     ctypes.c_uint32, ctypes.c_uint32,                   # counts, dollar
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ranges/dirs/chars
     ctypes.c_void_p, ctypes.c_int64],                   # out, lanes
    source="columba_tpu_torch/csrc/extend.cu",
    replaces="columba_tpu/ops/extend.py:48",
)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _occ_dir(index: FMIndex, pos, dirs):
    """occ (..., 4) at ``pos`` in the BWT chosen by ``dirs`` with the '$'
    slot removed, and the '$' count (...,)."""
    raw = rank.occ_all(index.occ_fused, pos, dirs.long() * index.blocks)
    d = rank.cnt_dollar(index.dollar[dirs.long()], pos)
    raw[..., 0] -= d
    return raw, d


def extend_all_plain(index: FMIndex, ranges, dirs) -> torch.Tensor:
    """(..., 4) ranges, (...,) dirs -> (..., 4 chars, 4) child ranges."""
    f_lo, f_hi, r_lo, r_hi = ranges.unbind(-1)
    bwd = dirs == 0
    a_lo = torch.where(bwd, f_lo, r_lo)
    a_hi = torch.where(bwd, f_hi, r_hi)
    b_lo = torch.where(bwd, r_lo, f_lo)
    occ_lo, d_lo = _occ_dir(index, a_lo, dirs)
    occ_hi, d_hi = _occ_dir(index, a_hi, dirs)
    new_a_lo = index.counts + occ_lo
    new_a_hi = index.counts + occ_hi
    width = new_a_hi - new_a_lo
    # chars smaller than c in bwt[a_lo:a_hi): '$' + exclusive cumsum of occ
    cum_lo = occ_lo.cumsum(-1) - occ_lo + d_lo[..., None]
    cum_hi = occ_hi.cumsum(-1) - occ_hi + d_hi[..., None]
    new_b_lo = b_lo[..., None] + (cum_hi - cum_lo)
    new_b_hi = new_b_lo + width
    bw = bwd[..., None]
    new_f_lo = torch.where(bw, new_a_lo, new_b_lo)
    new_f_hi = torch.where(bw, new_a_hi, new_b_hi)
    new_r_lo = torch.where(bw, new_b_lo, new_a_lo)
    new_r_hi = torch.where(bw, new_r_lo + width, new_a_hi)
    return torch.stack([new_f_lo, new_f_hi, new_r_lo, new_r_hi],
                       dim=-1) & MASK32


def extend_char_plain(index: FMIndex, ranges, chars, dirs) -> torch.Tensor:
    """Each lane extended by its own char; N (> 3) gives an empty range."""
    all4 = extend_all_plain(index, ranges, dirs)            # (..., 4, 4)
    safe = chars.long().clamp(0, 3)
    child = all4.gather(-2, safe[..., None, None].expand(
        *safe.shape, 1, 4))[..., 0, :]
    return torch.where((chars > 3)[..., None], torch.zeros_like(child), child)


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, kernel A on the card
# ---------------------------------------------------------------------------

def _check(index, ranges, dirs, chars=None):
    L = dirs.numel()
    if ranges.dtype != torch.int64 or ranges.shape != (L, 4):
        raise ValueError(f"ranges must be ({L}, 4) int64, got "
                         f"{tuple(ranges.shape)} {ranges.dtype}")
    for name, t in (("dirs", dirs), ("chars", chars)):
        if t is not None and (t.dtype != torch.int32 or t.dim() != 1):
            raise ValueError(f"{name} must be 1-D int32")
    for t in (ranges, dirs, chars, index.occ_fused):
        if t is not None and (t.device != ranges.device
                              or not t.is_contiguous()):
            raise ValueError("kernel A inputs must be contiguous on one "
                             "device")
    return L


def _launch(index, ranges, dirs, chars):
    L = _check(index, ranges, dirs, chars)
    out = torch.empty((L, 4 if chars is not None else 16), dtype=torch.int64,
                      device=ranges.device)
    if L:
        KERNEL(index.occ_fused.data_ptr(), index.blocks, *index.counts_host,
               *index.dollar_host, ranges.data_ptr(), dirs.data_ptr(),
               chars.data_ptr() if chars is not None else None,
               out.data_ptr(), L)
    return out


def extend_all(index: FMIndex, ranges, dirs) -> torch.Tensor:
    """(L, 4) int64 ranges, (L,) int32 dirs -> (L, 4, 4)."""
    if not ranges.is_cuda:
        return extend_all_plain(index, ranges, dirs)
    return _launch(index, ranges, dirs, None).view(-1, 4, 4)


def extend_char(index: FMIndex, ranges, chars, dirs) -> torch.Tensor:
    """(L, 4) int64 ranges, (L,) int32 chars and dirs -> (L, 4)."""
    if not ranges.is_cuda:
        return extend_char_plain(index, ranges, chars, dirs)
    return _launch(index, ranges, dirs, chars)
