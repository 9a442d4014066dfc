"""Device-side bidirectional FM-index as PyTorch tensors.

The counterpart of ``columba_tpu/index/fmindex.py``. The forward- and
reverse-BWT rank rows are concatenated into one table, so the extension
direction of a lane is a block-row offset and one read serves a frontier
that mixes directions.

Layouts follow the data, not a device tiling:

- ``occ_fused``: ``(2*blocks, 16)`` words per 128-char block,
  ``[4 checkpoints | 8 packed BWT words | 4 pad]`` = one 64 B row, forward
  blocks then reverse blocks;
- ``text``: the genome as FLAT packed 2-bit words (16 bases per word);
- ``sa_samples``, ``sa_bits`` (flat marker words, 128 bits per rank block),
  ``sa_bits_rank``.

Every 32-bit word array is an int32 tensor holding the uint32 bit pattern
(torch has no general uint32 arithmetic); readers widen with
``& 0xFFFFFFFF``. Ranges and positions are int64 in the port.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from columba_tpu_torch.index.build import IndexArrays

def _words(a) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor with the same bit pattern."""
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).view(np.int32))


@dataclass(frozen=True)
class FMIndex:
    """Device arrays of one index; move with :meth:`to`."""

    occ_fused: torch.Tensor     # (2*blocks, 16) int32 (uint32 bits)
    counts: torch.Tensor        # (4,) int64 first SA row per char
    dollar: torch.Tensor        # (2,) int64 '$' row in [fwd, rev] BWT
    text: torch.Tensor          # (ceil(n/16),) int32 packed genome words
    sa_samples: torch.Tensor    # int32 (uint32 bits) SA values, row order
    sa_bits: torch.Tensor       # int32 marker words, 4 per 128-row block
    sa_bits_rank: torch.Tensor  # (blocks,) int32 set bits before each block

    # -- host metadata --
    n: int = 0
    blocks: int = 0             # occ blocks per direction
    sa_sparseness: int = 4
    counts_host: tuple = (0, 0, 0, 0)
    dollar_host: tuple = (0, 0)

    @staticmethod
    def from_arrays(arrays: IndexArrays, device) -> "FMIndex":
        """Device index from host arrays (either package's IndexArrays: both
        are plain numpy). The caller names the device: every entry point
        that takes the index runs where the index lies, so there is no
        default that could put a caller on the CPU unasked."""
        n = int(arrays.n)
        blocks = arrays.occ.shape[0]
        if arrays.rocc.shape[0] != blocks or arrays.bwt.shape[0] != blocks * 8:
            raise ValueError("inconsistent index arrays")
        fused = np.zeros((2 * blocks, 16), dtype=np.uint32)
        fused[:, :4] = np.concatenate([arrays.occ, arrays.rocc])
        fused[:, 4:12] = np.concatenate(
            [arrays.bwt, arrays.rbwt]).reshape(-1, 8)
        bits = np.asarray(arrays.sa_bits, dtype=np.uint32)
        bits = np.concatenate([bits, np.zeros((-len(bits)) % 4, np.uint32)])
        counts = tuple(int(c) for c in arrays.counts)
        dollar = (int(arrays.dollar_fwd), int(arrays.dollar_rev))
        return FMIndex(
            occ_fused=_words(fused),
            counts=torch.tensor(counts, dtype=torch.int64),
            dollar=torch.tensor(dollar, dtype=torch.int64),
            text=_words(arrays.text),
            sa_samples=_words(arrays.sa_samples),
            sa_bits=_words(bits),
            sa_bits_rank=_words(arrays.sa_bits_rank),
            n=n,
            blocks=blocks,
            sa_sparseness=int(arrays.meta["sa_sparseness"]),
            counts_host=counts,
            dollar_host=dollar,
        ).to(device)

    def to(self, device) -> "FMIndex":
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return replace(self, **moved)

    @property
    def device(self) -> torch.device:
        return self.occ_fused.device

    def nbytes(self) -> int:
        return sum(getattr(self, f.name).nbytes for f in fields(self)
                   if isinstance(getattr(self, f.name), torch.Tensor))

    @property
    def range_width(self) -> int:
        """Values per lane range: [f_lo, f_hi, r_lo, r_hi) (8 or 12 on the
        RLC index, ``index/bmove.py``)."""
        return 4

    def full_range(self, batch_shape=()) -> torch.Tensor:
        """The whole-index range pair [0, n+1, 0, n+1) broadcast to batch."""
        r = torch.tensor([0, self.n + 1, 0, self.n + 1], dtype=torch.int64,
                         device=self.device)
        return r.expand(*batch_shape, 4).contiguous()
