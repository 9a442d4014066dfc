"""Dense k-mer seed table: bidirectional SA ranges of every k-mer.

The counterpart of ``columba_tpu/index/kmer.py``: a direct-addressed
(4^K, 4) table of range pairs indexed by the 2-bit packed k-mer, built by K
lockstep backward ``extend_char`` steps over all 4^K patterns (kernel A on
the card). Lookup is one row gather.

Code convention: code(P) = sum_j P[j] * 4^(K-1-j) (first char = most
significant digits). The on-disk cache ``kmer{K}.npy`` (uint32) is the
same file the JAX package writes, so either package reads the other's.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from columba_tpu_torch.index.fmindex import FMIndex
from columba_tpu_torch.ops import extend

DEFAULT_K = 10  # reference default k-mer size


def pack_codes(chars: torch.Tensor) -> torch.Tensor:
    """(..., K) char codes -> packed int64 k-mer codes; any N -> -1."""
    K = chars.shape[-1]
    c = chars.long()
    weights = 4 ** torch.arange(K - 1, -1, -1, dtype=torch.int64,
                                device=chars.device)
    code = (c.clamp(0, 3) * weights).sum(dim=-1)
    bad = ((c > 3) | (c < 0)).any(dim=-1)
    return torch.where(bad, -1, code)


def table_k(table) -> int:
    """Recover K from a dense table's row count (4^K rows)."""
    n = int(table.shape[0])
    K = max(1, round(math.log(n, 4)))
    if 4 ** K != n:
        raise ValueError(f"k-mer table rows {n} not a power of 4")
    return K


def build_kmer_table(index: FMIndex, K: int = DEFAULT_K) -> torch.Tensor:
    """(4^K, 4) int64 ranges of all K-mers, on the index's device."""
    n = 4 ** K
    codes = torch.arange(n, dtype=torch.int32, device=index.device)
    ranges = index.full_range((n,))
    dirs = torch.zeros(n, dtype=torch.int32, device=index.device)
    # backward match: the last char first, so step s consumes digit s
    for step in range(K):
        chars = ((codes >> (2 * step)) & 3).contiguous()
        ranges = extend.extend_char(index, ranges, chars, dirs)
    return ranges


def build_kmer_table_cached(index: FMIndex, K: int,
                            cache_dir: str) -> torch.Tensor:
    """Seed table with an on-disk cache in the index directory."""
    path = os.path.join(cache_dir, f"kmer{K}.npy")
    if os.path.exists(path):
        try:
            host = np.load(path)
            return torch.from_numpy(host.astype(np.int64)).to(index.device)
        except (ValueError, OSError):
            pass
    table = build_kmer_table(index, K)
    try:
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.save(f, table.cpu().numpy().astype(np.uint32))
        os.replace(tmp, path)
    except OSError:
        pass
    return table


def lookup(table: torch.Tensor, chars: torch.Tensor) -> torch.Tensor:
    """(..., 4) ranges of the k-mers given as (..., K) char windows;
    windows containing N give empty ranges."""
    code = pack_codes(chars)
    out = table[code.clamp(0, table.shape[0] - 1)]
    return torch.where((code >= 0)[..., None], out, 0)
