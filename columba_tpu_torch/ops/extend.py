"""Batched bidirectional SA-interval extension, and kernel A.

The counterpart of ``columba_tpu/ops/extend.py``: every lane extends its
range pair ``[f_lo, f_hi, r_lo, r_hi)`` by all four characters (or by its
own character) from the two occ rows at the active interval's endpoints.
dir 0 extends backward (prepend; forward BWT), dir 1 forward (append;
reverse BWT), and the direction is a block-row offset into the
concatenated table, so lanes may mix directions.

Ranges are int64 tensors holding uint32 values (see ``ops/rank.py``).

``extend_all`` / ``extend_char`` take the plain PyTorch version for CPU
tensors and launch kernel A (``csrc/extend.cu``) for CUDA tensors. Kernel
A's loop entries (``loop``, ``loop_rlc``), which walk every exact-prefix
step of a lane in one launch, are registered here and called by
``search/executor.py`` (``exact_loop``).
``exact_match`` (the k = 0 pass, and with per-row lengths the part ranges
of scheme selection) is kernel E (``csrc/exact.cu``) on the card.
On the RLC index (``index/bmove.py``) ranges are 8 or 12 wide and the three
functions dispatch, as ``columba_tpu/ops/extend.py:55-58,105-108`` do, to the
plain versions of ``ops/bextend.py`` on the CPU; on the card they take the
RLC entries of kernel A (``extend.rlc``) and of kernel E (``exact.rlc``,
with lengths ``exact.rlc_lengths``).
"""

from __future__ import annotations

import ctypes

import torch

from columba_tpu_torch import native
from columba_tpu_torch.index.bmove import BMoveIndex
from columba_tpu_torch.index.fmindex import FMIndex
from columba_tpu_torch.ops import bextend, rank

MASK32 = rank.MASK32

_FM_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64,       # occ_fused, blocks
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32]
_LOOP_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,    # ranges, ids, lanes
    ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,     # reads, m, S
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # ex_pos/dir, db_ex
    ctypes.c_int64,                                      # per-lane row stride
    ctypes.c_int32, ctypes.c_int32,                      # t_lo, t_hi
    ctypes.c_int32, ctypes.c_int32,                      # gate_t, switchpoint
    ctypes.c_void_p, ctypes.c_void_p]                    # out, drain rows

KERNEL = native.Kernel(
    "extend", "columba_extend",
    [*_FM_ARGTYPES,                                      # occ, counts, dollar
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ranges/dirs/chars
     ctypes.c_void_p, ctypes.c_int64],                   # out, lanes
    source="columba_tpu_torch/csrc/extend.cu",
    replaces="columba_tpu/ops/extend.py:48",
    symbols={
        # extend_all / extend_char on 8- or 12-wide RLC lanes (K18)
        "rlc": ("columba_extend_rlc", [
            *bextend.BM_ARGTYPES,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ranges,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32]),  # ..., rw
        # the exact-prefix loop (search/executor.py exact_loop)
        "loop": ("columba_extend_loop", [*_FM_ARGTYPES, *_LOOP_ARGTYPES]),
        "loop_rlc": ("columba_extend_loop_rlc", [
            *bextend.BM_ARGTYPES, *_LOOP_ARGTYPES, ctypes.c_int32]),  # rw
    },
)

_EXACT_RLC = ("columba_exact_rlc", [
    *bextend.BM_ARGTYPES, *bextend.BT_ARGTYPES,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,   # patterns, lengths, m
    ctypes.c_void_p, ctypes.c_int64])                   # out, rows
EXACT_KERNEL = native.Kernel(
    "exact", "columba_exact",
    [ctypes.c_void_p, ctypes.c_int64,                    # occ_fused, blocks
     ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
     ctypes.c_uint32, ctypes.c_uint32,                   # counts, dollar
     ctypes.c_void_p, ctypes.c_void_p,                   # patterns, lengths
     ctypes.c_int32, ctypes.c_int64,                     # m, n
     ctypes.c_void_p, ctypes.c_int64],                   # out, rows
    source="columba_tpu_torch/csrc/exact.cu",
    replaces="columba_tpu/ops/extend.py:120",
    symbols={"rlc": _EXACT_RLC,
             # per-row lengths on RLC lanes (the part ranges of K17)
             "rlc_lengths": _EXACT_RLC},
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
    """(..., 4) ranges, (...,) dirs -> (..., 4 chars, 4) child ranges
    (on the RLC index (L, rw) -> (L, 4, rw), ``bextend.extend_all_plain``)."""
    if isinstance(index, BMoveIndex):
        return bextend.extend_all_plain(index, ranges, dirs)
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
    if isinstance(index, BMoveIndex):
        return bextend.extend_char_plain(index, ranges, chars, dirs)
    all4 = extend_all_plain(index, ranges, dirs)            # (..., 4, 4)
    safe = chars.long().clamp(0, 3)
    child = all4.gather(-2, safe[..., None, None].expand(
        *safe.shape, 1, 4))[..., 0, :]
    return torch.where((chars > 3)[..., None], torch.zeros_like(child), child)


def exact_match_plain(index: FMIndex, patterns: torch.Tensor,
                      lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Exact backward match of (B, m) uint8 patterns: m calls of
    ``extend_char_plain`` by pattern[m-1], pattern[m-2], ..., from the full
    range. With per-row ``lengths`` (B,) step i reads pattern[length-1-i] and
    a row stops after its length steps (the rest of the row is padding).
    Returns the (B, 4) ranges those calls leave, empty ones too. On the
    RLC index the walks read the run tables, as kernel E does."""
    B, m = patterns.shape
    ranges = index.full_range((B,))
    dirs = torch.zeros(B, dtype=torch.int32, device=patterns.device)

    def step(c):
        if isinstance(index, BMoveIndex):
            return bextend.extend_char_plain(index, ranges, c, dirs,
                                             tables=True)
        return extend_char_plain(index, ranges, c, dirs)

    for i in range(m):
        if lengths is None:
            ranges = step(patterns[:, m - 1 - i].int())
            continue
        j = lengths.long() - 1 - i
        c = patterns.gather(1, j.clamp(0, m - 1)[:, None])[:, 0].int()
        new = step(c)
        ranges = torch.where((j >= 0)[:, None], new, ranges)
    return ranges


def zero_empty(ranges: torch.Tensor) -> torch.Tensor:
    """Empty ranges (hi <= lo) as the zero range, live ones untouched."""
    return torch.where((ranges[:, 1] > ranges[:, 0])[:, None], ranges, 0)


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, kernels A and E on the card
# ---------------------------------------------------------------------------

def _table(index) -> torch.Tensor:
    return index.fused if isinstance(index, BMoveIndex) else index.occ_fused


def _check(index, ranges, dirs, chars=None):
    L = dirs.numel()
    rw = index.range_width
    if ranges.dtype != torch.int64 or ranges.shape != (L, rw):
        raise ValueError(f"ranges must be ({L}, {rw}) int64, got "
                         f"{tuple(ranges.shape)} {ranges.dtype}")
    for name, t in (("dirs", dirs), ("chars", chars)):
        if t is not None and (t.dtype != torch.int32 or t.dim() != 1):
            raise ValueError(f"{name} must be 1-D int32")
    for t in (ranges, dirs, chars, _table(index)):
        if t is not None and (t.device != ranges.device
                              or not t.is_contiguous()):
            raise ValueError("kernel A inputs must be contiguous on one "
                             "device")
    return L, rw


def _launch(index, ranges, dirs, chars):
    L, rw = _check(index, ranges, dirs, chars)
    out = torch.empty((L, rw if chars is not None else 4 * rw),
                      dtype=torch.int64, device=ranges.device)
    cptr = chars.data_ptr() if chars is not None else None
    if L and isinstance(index, BMoveIndex):
        KERNEL(*bextend.bm_args(index), ranges.data_ptr(), dirs.data_ptr(),
               cptr, out.data_ptr(), L, rw, entry="rlc")
    elif L:
        KERNEL(index.occ_fused.data_ptr(), index.blocks, *index.counts_host,
               *index.dollar_host, ranges.data_ptr(), dirs.data_ptr(),
               cptr, out.data_ptr(), L)
    return out


def extend_all(index: FMIndex, ranges, dirs) -> torch.Tensor:
    """(L, rw) int64 ranges, (L,) int32 dirs -> (L, 4, rw) (rw = 4, or 8 or
    12 on the RLC index: kernel A's RLC entry on the card)."""
    if not ranges.is_cuda:
        return extend_all_plain(index, ranges, dirs)
    return _launch(index, ranges, dirs, None).view(-1, 4, index.range_width)


def extend_char(index: FMIndex, ranges, chars, dirs) -> torch.Tensor:
    """(L, rw) int64 ranges, (L,) int32 chars and dirs -> (L, rw); on the
    RLC index only the chosen child's run hints are walked."""
    if not ranges.is_cuda:
        return extend_char_plain(index, ranges, chars, dirs)
    return _launch(index, ranges, dirs, chars)


def exact_match(index: FMIndex, patterns: torch.Tensor,
                lengths: torch.Tensor | None = None) -> torch.Tensor:
    """(B, m) uint8 patterns -> (B, rw) int64 ranges of their exact
    matches; ``lengths`` (B,) int32 gives each row's own length (None: m).

    A live row holds exactly what its ``extend_char`` steps give; a row
    without a match is the zero range (kernel E stops a row at its first
    empty range, where the value the remaining steps would leave is
    arbitrary; on the RLC index it is zero anyway)."""
    if not patterns.is_cuda:
        return zero_empty(exact_match_plain(index, patterns, lengths))
    if (patterns.dtype != torch.uint8 or patterns.dim() != 2
            or not patterns.is_contiguous()
            or _table(index).device != patterns.device):
        raise ValueError("exact_match takes a contiguous (B, m) uint8 batch "
                         "on the index's device")
    B, m = patterns.shape
    if lengths is not None and (
            lengths.dtype != torch.int32 or lengths.shape != (B,)
            or not lengths.is_contiguous()
            or lengths.device != patterns.device):
        raise ValueError("exact_match lengths must be a contiguous (B,) "
                         "int32 tensor on the patterns' device")
    lptr = lengths.data_ptr() if lengths is not None else None
    if isinstance(index, BMoveIndex):
        if index.textless:
            raise ValueError("kernel E's RLC entries take 8-wide lanes; the "
                             "textless index runs k = 0 through the frontier")
        out = torch.empty((B, 8), dtype=torch.int64, device=patterns.device)
        if B:
            EXACT_KERNEL(*bextend.bm_args(index), *bextend.bt_args(index),
                         patterns.data_ptr(), lptr,
                         m, out.data_ptr(), B,
                         entry="rlc_lengths" if lengths is not None
                         else "rlc")
        return out
    out = torch.empty((B, 4), dtype=torch.int64, device=patterns.device)
    if B:
        EXACT_KERNEL(index.occ_fused.data_ptr(), index.blocks,
                     *index.counts_host, *index.dollar_host,
                     patterns.data_ptr(), lptr, m, index.n, out.data_ptr(), B,
                     entry="lengths" if lengths is not None else "")
    return out
