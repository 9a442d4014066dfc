"""Bidirectional extension on the RLC (b-move) index: plain versions.

The counterpart of ``columba_tpu/ops/bextend.py``. Per lane, two fused-row
reads at the runs of the active interval's endpoints give, for all four
characters at once, the child intervals (per-character counts before the
run plus the offset inside it) and the next/previous run of each character;
the child's run hints come from the LF run of the first and last run of c
that the parent touches, fast-forwarded to the runs that hold the child's
endpoints. The other side's interval follows arithmetically ('$' count plus
the widths of the smaller characters), its hints by monotone fast-forward
and back-walk from the parent's. Textless lanes (12 wide) also carry a
toehold sample, updated from the rows already read.

Ranges are int64 tensors holding uint32 values; run hints are uint32 bit
patterns of int32 run indices (``PREV = -1`` is ``0xFFFFFFFF`` and is
sign-extended before the clip to 0, as the JAX package's int32 cast does).
Every value the JAX package computes in uint32 is masked to 32 bits here.

A fast-forward walks at most ``FF_CAP`` runs, then binary-searches from
where it stopped (backward: from run 0). The JAX loops run in lockstep over
all lanes; each lane's steps depend only on its own rows, so walking each
lane alone (the kernels, one thread per lane) gives the same runs.

These are the plain versions of the RLC extension of kernels A, B, E
and F; ``ops/extend.py`` and ``search/executor.py`` take them for CPU
tensors. With ``tables=True`` the walks read the run tables of
``index/bmove.run_tables`` (a 4 B START a run; past ``FF_CAP`` runs a
bucket lookup and a forward walk in place of the binary search), as the
four-lane step of ``csrc/bm_quad.cuh`` does in every one of those
kernels: the same runs. ``stats`` (optional dict) accumulates what a
per-lane walk reads: ``walk`` (run-bound reads of the fast-forwards),
``probes`` (binary-search reads) or, on the run tables, ``bucket`` and
``bucket_walk`` (the bucket reads and the STARTs read from there),
``hint_rows`` (LF-run reads), ``toe_rows`` (12-wide lanes: toeholds
reset from the previous c-run's samples) and ``children`` (children
whose hints are walked), for ``tools/bounds.py``; on the run tables also
``walk_rounds``, the dependent reads of each such child's walks in the
four-lane step, where the four walks run at once (see
:func:`walk_tables`).
"""

from __future__ import annotations

import ctypes

import torch

from columba_tpu_torch.index.bmove import (
    BMoveIndex, CHAR, CUM0, END, LF_RUN, NEXT0, PREV0, SA_FIRST, SA_LAST,
    START,
)

MASK32 = 0xFFFFFFFF
FF_CAP = 16
WINDOW = 8       # runs one read of a kernel E / F walk covers (bm_quad.cuh)


def sext32(x: torch.Tensor) -> torch.Tensor:
    """uint32 bit patterns held in int64 -> their int32 values."""
    return ((x + (1 << 31)) & MASK32) - (1 << 31)


def _col(index: BMoveIndex, rows: torch.Tensor, col: int) -> torch.Tensor:
    return index.fused[rows, col].long() & MASK32


def _add(stats, key, n) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(n)


def run_of_pos(index: BMoveIndex, off, pos, lo, stats=None, need=None):
    """Largest run j >= lo of the table at row offset ``off`` with
    START[j] <= pos: a binary search of ceil(log2 r) probes. ``need``: the
    elements that take the search, the only ones ``stats`` counts (a
    thread whose walk ended in place reads no probe)."""
    r_limit = torch.where(off == 0, index.r_fwd, index.r_rev)
    lo = torch.minimum(lo.clamp(min=0), r_limit - 1)
    hi = r_limit - 1
    bits = max(int(index.r_fwd).bit_length(), int(index.r_rev).bit_length())
    need = torch.ones_like(lo, dtype=torch.bool) if need is None else need
    for _ in range(bits):
        _add(stats, "probes", ((lo < hi) & need).sum())
        mid = (lo + hi + 1) >> 1
        take = _col(index, off + mid, START) <= pos
        lo = torch.where(take, mid, lo)
        hi = torch.where(take, hi, mid - 1)
    return lo


def ff_forward(index: BMoveIndex, off, run, pos, stats=None, live=None):
    """Advance run hints while the run's end is <= pos: at most FF_CAP
    steps, then a binary search from where the walk stopped. ``live``: the
    elements ``stats`` counts (default all)."""
    run0 = run
    for _ in range(FF_CAP):
        behind = _col(index, off + run, END) <= pos
        if not bool(behind.any()):
            break
        run = run + behind.long()
    behind = _col(index, off + run, END) <= pos
    live = torch.ones_like(behind) if live is None else live
    _add(stats, "walk", ((run - run0 + 1) * live).sum())
    if bool(behind.any()):
        run = torch.where(behind, run_of_pos(index, off, pos, run, stats,
                                             behind & live), run)
    return run


def ff_backward(index: BMoveIndex, off, run, pos, stats=None, live=None):
    """Retreat run hints while the run's start is > pos: at most FF_CAP
    steps, then a binary search from run 0."""
    run0 = run
    for _ in range(FF_CAP):
        ahead = _col(index, off + run, START) > pos
        if not bool(ahead.any()):
            break
        run = run - ahead.long()
    ahead = _col(index, off + run, START) > pos
    live = torch.ones_like(ahead) if live is None else live
    _add(stats, "walk", ((run0 - run + 1) * live).sum())
    if bool(ahead.any()):
        run = torch.where(ahead, run_of_pos(index, off, pos,
                                            torch.zeros_like(run), stats,
                                            ahead & live), run)
    return run


def walk_tables(index: BMoveIndex, off, run, pos, forward: bool,
                stats=None, live=None):
    """:func:`ff_forward` (``forward``) or :func:`ff_backward` on the run
    tables: the capped walk reads START[j + 1] for END[j] (or START[j]);
    past ``FF_CAP`` runs the run that holds ``pos`` is the bucket's run
    (``run_at`` / ``run_at_rev`` at ``pos >> run_shift``) walked forward,
    which is the run the binary search finds. Returns (runs, rounds):
    ``rounds`` are the dependent reads of the four-lane step's walk, which
    reads ``WINDOW`` runs from the hint at once and, where the answer lies
    further, the bucket and then ``WINDOW`` runs a read from the bucket's
    run (forward: from ``hint + WINDOW`` if that is further)."""
    toff = torch.where(off == 0, 0, index.starts_rev)

    def start(j):
        return index.starts[toff + j].long() & MASK32

    def off_side(r):
        return start(r + 1) <= pos if forward else start(r) > pos

    run0 = run
    for _ in range(FF_CAP):
        away = off_side(run)
        if not bool(away.any()):
            break
        run = run + away.long() if forward else run - away.long()
    miss = off_side(run)
    live = torch.ones_like(miss) if live is None else live
    _add(stats, "walk", (((run - run0).abs() + 1) * live).sum())
    b = pos >> index.run_shift
    b0 = torch.where(toff == 0, index.run_at[b], index.run_at_rev[b]).long()
    if bool(miss.any()):
        t, reads = b0, torch.ones_like(b0)
        while bool((adv := miss & (start(t + 1) <= pos)).any()):
            t, reads = t + adv.long(), reads + adv.long()
        _add(stats, "bucket", (miss & live).sum())
        _add(stats, "bucket_walk", (reads * (miss & live)).sum())
        run = torch.where(miss, t, run)
    s = torch.maximum(b0, run0 + WINDOW) if forward else b0
    far = (run - run0).abs() >= WINDOW
    return run, torch.where(far, 3 + (run - s) // WINDOW, 1)


def extend_all_plain(index: BMoveIndex, ranges: torch.Tensor,
                     dirs: torch.Tensor, mask: torch.Tensor | None = None,
                     stats: dict | None = None,
                     tables: bool = False) -> torch.Tensor:
    """(L, rw) ranges (rw 8, or 12 with toeholds), (L,) dirs -> (L, 4, rw)
    children; an empty child (width 0) is all zero, hints included, as in
    the JAX package. Dead input lanes must be all zero. ``mask`` (L, 4)
    bool: the children whose hints (columns 4..) are computed; the others
    keep their interval (columns 0-3) and have zero hints. ``tables``:
    walk on the run tables (kernels A, B, E and F: the same runs)."""
    M = MASK32
    L, rw = ranges.shape
    dev = ranges.device
    f_lo, f_hi, r_lo, r_hi = ranges[:, :4].unbind(-1)
    fr_lo, fr_hi1, rr_lo, rr_hi1 = sext32(ranges[:, 4:8]).unbind(-1)
    bwd = dirs.long() == 0
    rev_off = index.r_fwd + 1
    off_a = torch.where(bwd, 0, rev_off)
    off_b = torch.where(bwd, rev_off, 0)
    a_lo = torch.where(bwd, f_lo, r_lo)
    a_hi = torch.where(bwd, f_hi, r_hi)
    a_run_lo = torch.where(bwd, fr_lo, rr_lo)
    a_run_hi1 = torch.where(bwd, fr_hi1, rr_hi1)
    b_lo = torch.where(bwd, r_lo, f_lo)
    b_run_lo = torch.where(bwd, rr_lo, fr_lo)
    b_run_hi1 = torch.where(bwd, rr_hi1, fr_hi1)

    row_lo = index.fused[off_a + a_run_lo].long() & M        # (L, NCOLS)
    row_hi = index.fused[off_a + a_run_hi1].long() & M
    char_lo = row_lo[:, CHAR]
    char_hi = row_hi[:, CHAR]
    cvec = torch.arange(4, device=dev)
    is_lo = char_lo[:, None] == cvec                         # (L, 4)
    is_hi = char_hi[:, None] == cvec
    occ_lo = (row_lo[:, CUM0:CUM0 + 4]
              + torch.where(is_lo, (a_lo - row_lo[:, START])[:, None], 0)) & M
    occ_hi = (row_hi[:, CUM0:CUM0 + 4]
              + torch.where(is_hi, (a_hi - row_hi[:, START])[:, None], 0)) & M
    width = (occ_hi - occ_lo) & M
    new_a_lo = (index.first_row[:4] + occ_lo) & M
    new_a_hi = (new_a_lo + width) & M
    # other side: '$' + smaller-char counts ('$' = total - char widths)
    d = ((a_hi - a_lo) - width.sum(-1)) & M
    cum_w = (width.cumsum(-1) - width) & M
    new_b_lo = (b_lo[:, None] + d[:, None] + cum_w) & M
    new_b_hi = (new_b_lo + width) & M
    ok = width > 0
    hint = ok if mask is None else ok & mask

    # active-side hints: LF run of the first / last c-run the parent
    # touches (run_lo itself if it is a c-run, else the next c-run; the
    # same for hi-1 with the previous c-run)
    run_p = torch.where(is_lo, a_run_lo[:, None],
                        sext32(row_lo[:, NEXT0:NEXT0 + 4])).clamp(min=0)
    run_q = torch.where(is_hi, a_run_hi1[:, None],
                        sext32(row_hi[:, PREV0:PREV0 + 4])).clamp(min=0)
    row_p = index.fused[off_a[:, None] + run_p].long() & M   # (L, 4, NCOLS)
    row_q = index.fused[off_a[:, None] + run_q].long() & M
    _add(stats, "children", hint.sum())
    if not tables:
        _add(stats, "hint_rows", 2 * hint.sum())
    else:
        # the four-lane step takes the LF run of the lo / hi row from the
        # row itself where it is a c-run, and reads it elsewhere
        _add(stats, "hint_rows", ((~is_lo & hint).sum()
                                  + (~is_hi & hint).sum()))
    z = torch.zeros_like(width)
    # three forward walks in one batch, (L, 4, 3): active lo, active hi - 1,
    # other lo; dead or unmasked children frozen at (run 0, pos 0)
    hx = hint[..., None]
    ffo = torch.where(hx, torch.stack([off_a[:, None] + z, off_a[:, None] + z,
                                       off_b[:, None] + z], -1), 0)
    ffr = torch.where(hx, torch.stack([
        sext32(row_p[..., LF_RUN]), sext32(row_q[..., LF_RUN]),
        b_run_lo[:, None] + z], -1).clamp(min=0), 0)
    ffp = torch.where(hx, torch.stack([new_a_lo, (new_a_hi - 1) & M,
                                       new_b_lo], -1), 0)
    hbo = torch.where(hint, off_b[:, None] + z, 0)
    hbr = torch.where(hint, b_run_hi1[:, None] + z, 0).clamp(min=0)
    hbp = torch.where(hint, (new_b_hi - 1) & M, 0)
    if not tables:
        ffr = ff_forward(index, ffo, ffr, ffp, stats, hx.expand(-1, -1, 3))
        hb_run = ff_backward(index, hbo, hbr, hbp, stats, hint)
    else:
        ffr, rf = walk_tables(index, ffo, ffr, ffp, True, stats,
                              hx.expand(-1, -1, 3))
        hb_run, rb = walk_tables(index, hbo, hbr, hbp, False, stats, hint)
        # the four walks at once; an active-side walk waits for its LF run
        # where the row read first is not a c-run
        r = torch.stack([rf[..., 0] + (~is_lo).long(),
                         rf[..., 1] + (~is_hi).long(), rf[..., 2], rb],
                        -1).amax(-1)
        _add(stats, "walk_rounds", (r * hint).sum())
    a_rlo, a_rhi1, b_rlo = ffr.unbind(-1)

    bw = bwd[:, None]

    def sel(x, y):
        return torch.where(bw, x, y)

    cols = [sel(new_a_lo, new_b_lo), sel(new_a_hi, new_b_hi),
            sel(new_b_lo, new_a_lo), sel(new_b_hi, new_a_hi),
            sel(a_rlo, b_rlo) & M, sel(a_rhi1, hb_run) & M,
            sel(b_rlo, a_rlo) & M, sel(hb_run, a_rhi1) & M]
    if rw >= 12:
        # textless toehold (reference: src/bmove/bmove.cpp:289-444): lane
        # columns 8..10 = [toe_value, toe_offset, toe_flag]; toe_value is
        # the extent START (flag 0, anchored in the fwd table) or END (flag
        # 1, rev table); toe_offset the anchored row's offset within that
        # side's interval
        tv, toff, tflag = ranges[:, 8], ranges[:, 9], ranges[:, 10]
        preserved = width == ((a_hi - a_lo) & M)[:, None]
        # a reset off the hi row reads run_q's START, END, SA_LAST and CUM
        _add(stats, "toe_rows", (~preserved & ~is_hi & hint).sum())
        tv_pres = torch.where(bwd, tv - (tflag == 0).long(),
                              tv + (tflag == 1).long()) & M
        # reset from the queried side's run samples: the last c-row of the
        # parent interval is hi - 1 itself (its run's FIRST sample) or the
        # previous c-run's LAST row
        sample_q = torch.where(is_hi, row_hi[:, SA_FIRST:SA_FIRST + 1],
                               row_q[..., SA_LAST])
        cum_q_c = row_q[..., CUM0:CUM0 + 4].gather(
            -1, cvec.expand(L, 4)[..., None])[..., 0]
        lf_rs = torch.where(
            is_hi, row_hi[:, CUM0:CUM0 + 4],
            cum_q_c + (row_q[..., END] - row_q[..., START] - 1)) & M
        off_reset = (index.first_row[:4] + lf_rs - new_a_lo) & M
        tv_reset = torch.where(bw, sample_q - 1, index.n - sample_q) & M
        cols += [torch.where(preserved, tv_pres[:, None], tv_reset),
                 torch.where(preserved, toff[:, None], off_reset),
                 torch.where(preserved, tflag[:, None], (~bw).long() + z),
                 z]
    out = torch.stack(cols, dim=-1)                      # (L, 4, rw)
    out = torch.where(ok[..., None], out, 0)
    if mask is not None:
        out[..., 4:] = torch.where(mask[..., None], out[..., 4:], 0)
    return out


def extend_char_plain(index: BMoveIndex, ranges, chars, dirs,
                      stats: dict | None = None,
                      tables: bool = False) -> torch.Tensor:
    """Each lane extended by its own char (exact matching); an N (> 3)
    gives the zero range. Only the chosen child's hints are walked.
    ``tables``: on the run tables (kernels A, B, E and F)."""
    safe = chars.long().clamp(0, 3)
    onehot = ((safe[:, None] == torch.arange(4, device=ranges.device))
              & (chars <= 3)[:, None])
    all4 = extend_all_plain(index, ranges, dirs, onehot, stats, tables)
    rw = ranges.shape[-1]
    child = all4.gather(1, safe[:, None, None].expand(-1, 1, rw))[:, 0]
    return torch.where((chars > 3)[:, None], torch.zeros_like(child), child)


# The index arguments of every RLC kernel entry (``BmParams`` of
# csrc/common.cuh): the fused table, the run counts, the first F-column row
# of A, C, G, T and the text length.
BM_ARGTYPES = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
               ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
               ctypes.c_uint32, ctypes.c_uint32]


def bm_args(index: BMoveIndex) -> tuple:
    return (index.fused.data_ptr(), index.r_fwd, index.r_rev,
            *index.first_host, index.n)


# The run tables of kernels A, B, E and F (``BmTables`` of
# csrc/bm_quad.cuh): the STARTs of both directions and the offset of the
# reverse ones, the bucket tables of both directions and their shift.
BT_ARGTYPES = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_int32]


def bt_args(index: BMoveIndex) -> tuple:
    """The run tables' arguments; raises where they are missing or lie on
    another device than the fused rows."""
    tabs = (index.starts, index.run_at, index.run_at_rev)
    if any(t is None or t.numel() == 0 or t.device != index.fused.device
           or not t.is_contiguous() for t in tabs):
        raise ValueError("the RLC kernels take the index's run tables, "
                         "contiguous beside its fused rows")
    return (index.starts.data_ptr(), index.starts_rev,
            index.run_at.data_ptr(), index.run_at_rev.data_ptr(),
            index.run_shift)
