"""Dense k-mer seed table: bidirectional SA ranges of every k-mer.

The counterpart of ``columba_tpu/index/kmer.py``: a direct-addressed
(4^K, 4) table of range pairs indexed by the 2-bit packed k-mer (rw wide on
the RLC index), what K lockstep backward ``extend_char`` steps over all
4^K patterns leave (the plain version; on the card one launch of kernel
A's table entry walks every k-mer's K steps). Lookup is one row gather
(kernel I's seed entry on the card).

Code convention: code(P) = sum_j P[j] * 4^(K-1-j) (first char = most
significant digits). The on-disk cache ``kmer{K}.npy`` (uint32) is the
same file the JAX package writes, so either package reads the other's.
"""

from __future__ import annotations

import ctypes
import math
import os

import numpy as np
import torch

from columba_tpu_torch.index.bmove import BMoveIndex
from columba_tpu_torch.index.fmindex import FMIndex
from columba_tpu_torch.ops import bextend, extend
from columba_tpu_torch.ops.frontier import FRONTIER

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


def build_kmer_table_plain(index: FMIndex, K: int = DEFAULT_K
                           ) -> torch.Tensor:
    """Plain version of :func:`build_kmer_table`: K lockstep
    ``extend_char`` calls over all 4^K codes from the full range."""
    n = 4 ** K
    codes = torch.arange(n, dtype=torch.int32, device=index.device)
    ranges = index.full_range((n,))
    dirs = torch.zeros(n, dtype=torch.int32, device=index.device)
    # backward match: the last char first, so step s consumes digit s
    for step in range(K):
        chars = ((codes >> (2 * step)) & 3).contiguous()
        ranges = extend.extend_char(index, ranges, chars, dirs)
    return ranges


def build_kmer_table(index: FMIndex, K: int = DEFAULT_K) -> torch.Tensor:
    """(4^K, rw) int64 ranges of all K-mers, on the index's device: the
    plain version on the CPU, one launch of kernel A's table entry on the
    card (``extend.table``, RLC ``extend.table_rlc``), bit for bit what the
    plain version's K steps leave."""
    if index.device.type != "cuda":
        return build_kmer_table_plain(index, K)
    if not 1 <= K <= 15:
        raise ValueError(f"kernel A's table entry takes K in 1..15, not {K}")
    rw = index.range_width
    full = index.full_range((1,))
    out = torch.empty((4 ** K, rw), dtype=torch.int64, device=index.device)
    if isinstance(index, BMoveIndex):
        extend.KERNEL(*bextend.bm_args(index), *bextend.bt_args(index),
                      full.data_ptr(), K, out.data_ptr(), rw,
                      entry="table_rlc")
    else:
        extend.KERNEL(index.occ_fused.data_ptr(), index.blocks,
                      *index.counts_host, *index.dollar_host,
                      full.data_ptr(), K, out.data_ptr(), entry="table")
    return out


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


def lookup_plain(table: torch.Tensor, chars: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`lookup`: pack, clamp, gather, mask."""
    code = pack_codes(chars)
    out = table[code.clamp(0, table.shape[0] - 1)]
    return torch.where((code >= 0)[..., None], out, 0)


def lookup(table: torch.Tensor, chars: torch.Tensor) -> torch.Tensor:
    """(..., 4) ranges of the k-mers given as (..., K) char windows;
    windows containing N give empty ranges. CUDA tensors ((..., K) uint8
    windows) go through kernel I's seed entry with one search starting at
    0 and no zeroing of empty ranges (entry ``frontier.lookup``);
    ``run_scheme`` seeds its lanes in that kernel directly."""
    if not chars.is_cuda:
        return lookup_plain(table, chars)
    K = table_k(table)
    if chars.dtype != torch.uint8 or chars.shape[-1] != K:
        raise ValueError(f"kernel I's lookup takes (..., {K}) uint8 windows")
    if (table.dtype != torch.int64 or tuple(table.shape) != (4 ** K, 4)
            or not table.is_contiguous() or table.device != chars.device):
        raise ValueError(f"kernel I's lookup takes a contiguous ({4 ** K}, "
                         f"4) int64 table on {chars.device}")
    flat = chars.reshape(-1, K).contiguous()
    out = torch.empty((flat.shape[0], 4), dtype=torch.int64,
                      device=chars.device)
    full = (ctypes.c_int64 * 12)()
    if flat.shape[0]:
        FRONTIER(flat.data_ptr(), flat.shape[0], K, 1, K, table.data_ptr(),
                 None, None, ctypes.addressof(full), 4, 0, out.data_ptr(),
                 None, 0, entry="lookup")
    return out.reshape(*chars.shape[:-1], 4)
