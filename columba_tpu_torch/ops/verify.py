"""Batched in-text verification, and kernel D.

The counterpart of ``columba_tpu/ops/verify.py``: every candidate aligns
its whole read against a text window with a banded semi-global DP (band
4kb+1, free start over the first 2kb+1 columns, free end) and returns the
final DP row; the host picks the cluster centres from it.

Window starts are signed int64 here: a start below 0 (an occurrence
within kb of the text start) is simply negative, and every window position
outside [0, n) reads as code 4. This replaces the JAX package's wrapped
uint32 starts (``NEG_T``).

``verify_window`` runs the plain PyTorch version (``gather_window`` +
``verify_window_plain``) on the CPU and kernel D (``csrc/verify.cu``) on
the card: it fuses the window fetch into the DP and runs the band as one
bit-vector word (Myers' recurrence in banded form), with the same final
rows. It reads only the index's flat packed text and its length, so it
takes the Vanilla index and the with-text RLC index (``index/bmove.py``)
alike.
"""

from __future__ import annotations

import ctypes

import torch

from columba_tpu_torch import native
from columba_tpu_torch.ops import rank
from columba_tpu_torch.search.schedule import INF

KERNEL_MAX_KB = 13   # csrc/verify.cu: a 32-bit band to kb 7, 64-bit above

KERNEL = native.Kernel(
    "verify", "columba_verify",
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,    # text, words, n
     ctypes.c_void_p, ctypes.c_int32,                    # patterns, m
     ctypes.c_void_p, ctypes.c_void_p,                   # rid, win_start
     ctypes.c_int32, ctypes.c_void_p,                    # kb, live count
     ctypes.c_void_p, ctypes.c_int64],                   # out, count
    source="columba_tpu_torch/csrc/verify.cu",
    replaces="columba_tpu/ops/verify.py:114",
)


def gather_window(index, starts: torch.Tensor,
                  width: int) -> torch.Tensor:
    """Text codes (B, width) from signed int64 ``starts``; positions
    outside [0, n) give 4."""
    pos = starts[:, None] + torch.arange(width, device=starts.device)
    inb = (pos >= 0) & (pos < index.n)
    p = pos.clamp(0, max(index.n - 1, 0))
    codes = (rank.u32(index.text[p >> 4]) >> (2 * (p & 15))) & 3
    return torch.where(inb, codes, 4)


def verify_window_plain(index, patterns, rid, window_start,
                        kb: int) -> torch.Tensor:
    """(R, m) uint8 reads, (B,) rid and int64 window starts -> (B, 4kb+1)
    int32 final DP rows: entry a is the distance of the best alignment
    ending at text position window_start + m + (a - kb)."""
    m = patterns.shape[1]
    bw = 4 * kb + 1
    W = m + 3 * kb + 1
    win = gather_window(index, window_start, W)
    B = win.shape[0]
    dev = win.device
    # candidate-minor layout: every column below is a contiguous (B,) row;
    # a window code of 4 (or a read N, as 5) never equals the other side
    winp = torch.cat([torch.full((kb, B), 4, dtype=torch.int8, device=dev),
                      win.T.to(torch.int8)]).contiguous()
    pat = patterns[rid].T.to(torch.int8)
    pat = torch.where(pat > 3, 5, pat).contiguous()
    inf = torch.full((B,), INF, dtype=torch.int32, device=dev)
    D = [inf if a < kb or a > 3 * kb else torch.zeros_like(inf)
         for a in range(bw)]                   # starts s in [0, 2kb]
    for j in range(m):
        pc = pat[j]
        nl = [torch.minimum(D[a] + (winp[j + a] != pc),
                            (D[a + 1] if a + 1 < bw else inf) + 1)
              for a in range(bw)]
        d = nl[0]
        D = [d.clamp(max=INF)]
        for a in range(1, bw):
            d = torch.minimum(nl[a], d + 1)
            D.append(d.clamp(max=INF))
    return torch.stack(D, dim=1)


def verify_window(index, patterns: torch.Tensor, rid: torch.Tensor,
                  window_start: torch.Tensor, kb: int,
                  live: torch.Tensor | None = None) -> torch.Tensor:
    """Fused window fetch + banded verify of (B,) candidates.

    ``live``: a device int64 scalar, the count of live slots (the dedup's
    ``n_unique``); the caller guarantees that every slot at or past it
    holds (read 0, window 0), as ``pipeline.stage_dedup`` pads. The kernel
    then verifies one such slot a block and copies its row; the rows equal
    the plain version's either way. Read on the card, with no host sync."""
    if not patterns.is_cuda:
        return verify_window_plain(index, patterns, rid, window_start, kb)
    if not 0 <= kb <= KERNEL_MAX_KB:
        raise ValueError(f"kernel D takes kb in 0..{KERNEL_MAX_KB}, not "
                         f"{kb}: no BEST cutoff exceeds that")
    B = rid.numel()
    if (patterns.dtype != torch.uint8 or patterns.dim() != 2
            or rid.dtype != torch.int64 or window_start.dtype != torch.int64
            or window_start.shape != rid.shape):
        raise ValueError("verify_window takes (R, m) uint8 patterns and (B,) int64 "
                         "rid and window starts")
    if index.text.numel() == 0 or index.text.numel() * 16 < index.n:
        raise ValueError("kernel D needs the packed text; the textless RLC "
                         "index has none")
    if live is not None and (live.dtype != torch.int64 or live.numel() != 1):
        raise ValueError("live must be one int64 count")
    for t in (patterns, rid, window_start, index.text,
              *(() if live is None else (live,))):
        if t.device != patterns.device or not t.is_contiguous():
            raise ValueError("kernel D inputs must be contiguous on one "
                             "device")
    out = torch.empty((B, 4 * kb + 1), dtype=torch.int32,
                      device=patterns.device)
    if B:
        KERNEL(index.text.data_ptr(), index.text.numel(), index.n,
               patterns.data_ptr(), patterns.shape[1], rid.data_ptr(),
               window_start.data_ptr(), kb,
               None if live is None else live.data_ptr(), out.data_ptr(), B,
               shape=f"kb{kb}")
    return out
