"""Batched rank/occ over 2-bit packed BWT words (plain PyTorch).

The counterpart of ``columba_tpu/ops/rank.py``. One 64 B fused row per
position gives occ for all four characters: the block checkpoint plus a
masked popcount of the 2-bit matches before the in-block offset. The '$'
row is packed as code 0 (A); callers subtract it.

These are the plain versions of the arithmetic that the CUDA kernels
(``csrc/common.cuh``) run per lane. Word arrays are int32 tensors holding
uint32 bits; positions are int64. torch has no uint32 arithmetic and no
popcount on the CPU, so words are widened to int64 and counted with a SWAR
popcount.
"""

from __future__ import annotations

import torch

BLOCK = 128
WPB = 8  # words per block
MASK32 = 0xFFFFFFFF

_PAT = (0x00000000, 0x55555555, 0xAAAAAAAA, 0xFFFFFFFF)


def u32(words: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values as int64."""
    return words.long() & MASK32


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK32) >> 24


def _count4(wvals: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-char popcounts of masked 2-bit slots -> (..., 4) int64."""
    out = []
    for c in range(4):
        nx = (wvals ^ _PAT[c]) ^ MASK32
        hits = nx & (nx >> 1) & 0x55555555 & mask
        out.append(popcount32(hits).sum(dim=-1))
    return torch.stack(out, dim=-1)


def _word_mask(off: torch.Tensor) -> torch.Tensor:
    """(..., WPB) masks of the 2r low bits, r = chars of each word before
    the in-block offset ``off`` (0..127)."""
    w = torch.arange(WPB, dtype=torch.int64, device=off.device)
    r = (off[..., None] - 16 * w).clamp(0, 16)
    return (torch.ones_like(r) << (2 * r)) - 1


def _row(fused, pos, blk_extra):
    blk = pos >> 7
    if blk_extra is not None:
        blk = blk + blk_extra
    row = u32(fused[blk])                       # (..., 16)
    return row[..., :4], row[..., 4:12], pos & 127


def occ_all(fused: torch.Tensor, pos: torch.Tensor,
            blk_extra: torch.Tensor | None = None) -> torch.Tensor:
    """occ(c, pos) for c in A,C,G,T, counting the '$' slot as A.

    fused: (rows, 16) int32 fused table; pos: (...,) int64 in [0, n+1];
    blk_extra: optional (...,) block-row offset (the direction's half of
    the concatenated table). Returns (..., 4) int64.
    """
    base, wvals, off = _row(fused, pos, blk_extra)
    return base + _count4(wvals, _word_mask(off))


def occ_all_and_char(fused: torch.Tensor, pos: torch.Tensor,
                     blk_extra: torch.Tensor | None = None):
    """occ_all(pos) plus the 2-bit code AT pos, from one row read."""
    base, wvals, off = _row(fused, pos, blk_extra)
    occ = base + _count4(wvals, _word_mask(off))
    w = wvals.gather(-1, (off >> 4)[..., None])[..., 0]
    return occ, (w >> (2 * (off & 15))) & 3


def cnt_dollar(dollar_row: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Number of '$' in bwt[0:pos) (0 or 1)."""
    return (dollar_row < pos).long()


def rank_bits(bits: torch.Tensor, bits_rank: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    """rank1 over flat marker words (32 bits/word, 128 bits/block)."""
    blk = pos >> 7
    off = pos & 127
    j = torch.arange(4, dtype=torch.int64, device=pos.device)
    wvals = u32(bits[(4 * blk)[..., None] + j])       # (..., 4)
    r = (off[..., None] - 32 * j).clamp(0, 32)
    mask = (torch.ones_like(r) << r) - 1
    return u32(bits_rank[blk]) + popcount32(wvals & mask).sum(dim=-1)


def get_bit(bits: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Marker bit at pos (bool)."""
    return ((u32(bits[pos >> 5]) >> (pos & 31)) & 1).bool()
