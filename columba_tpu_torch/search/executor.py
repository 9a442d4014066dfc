"""Lockstep frontier executor for search schemes, and kernel B.

The counterpart of ``columba_tpu/search/executor.py`` (static-schedule
path): a fixed-capacity frontier of SA-interval lanes advances one text
character per step, driven by the tables of ``search/schedule.py``.

1. Exact prefix: each (read, search) lane takes one ``extend_char`` per
   step (kernel A on the card), seeded from the k-mer table; narrow lanes
   past the gate depth drain to the in-text buffer.
2. Frontier init: order-keeping compaction of the live lanes into C.
3. Band steps: kernel B (``csrc/band_step.cu``) computes every lane's
   extension, banded rows, colMin registers, prune and ghost marking; the
   narrow drain and the order-keeping 4C -> C compaction run in PyTorch.
4. Tail: ghosts join the in-text buffer; completion bound per lane.

State is struct-of-arrays tensors (int64 ranges, int32 ids, int8 bands and
registers) rather than the JAX package's packed uint32 rows, which were
laid out for TPU row gathers. Compaction is a cumsum + scatter that keeps
lane order, the same order the JAX sort-compaction produces, so every
intermediate array compares equal with the reference.

Both loops stop before a step when no lane is alive, as the JAX
while-loops do; each check copies one flag to the host.

On the RLC index (``index/bmove.py``) a lane's range is ``rw`` = 8 values
(the range pair and its run hints) or 12 on the textless index (plus a
toehold sample); the in-text rows stay ``[f_lo, f_hi, ids, depth]``. Kernel
B then takes its RLC entry (``band_step.rlc``) or its textless entry
(``band_step.textless``), and a child that does not stay in the frontier has
zero hints (only the frontier reads them). ``track_arg`` (the textless pass)
gives every colMin register a shadow slot at ``[W, 2W)`` per side: the back
depth (mod 64) at which its value last strictly fell, read out as
``FrontierResult.arg_b``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from columba_tpu_torch import native
from columba_tpu_torch.index.bmove import BMoveIndex
from columba_tpu_torch.index.fmindex import FMIndex
from columba_tpu_torch.ops import bextend, extend, rank
from columba_tpu_torch.search.schedule import INF, Schedule

# Ghost-lane ids (boundary-harvest deaths kept inert in the frontier): bit
# 31 flags a ghost, bits 21-30 hold the death-step back depth, bits 0-20
# the lane id (caps R * S at 2^21 lanes per batch).
GHOST_BIT = -(1 << 31)
GHOST_IDM = (1 << 21) - 1

# Kernel B takes every shape a schedule can produce: band radii 0..4 with
# 1..2 colMin registers through templated entries, the rest (up to the BEST
# ladder's cutoff and schedule.MAX_REGS) through its generic entry.
KERNEL_MAX_KB = 13
KERNEL_MAX_W = 10

_BAND_OUT = [ctypes.c_void_p, ctypes.c_void_p,          # ch_ranges, new_ids
             ctypes.c_void_p, ctypes.c_void_p,          # ch_band, ch_colmin
             ctypes.c_void_p, ctypes.c_void_p,          # ch_alive, narrow
             ctypes.c_void_p, ctypes.c_void_p,          # act, dbv
             ctypes.c_int64]                            # lanes
_BAND_RLC = ("columba_band_step_rlc", [
    *bextend.BM_ARGTYPES,
    ctypes.c_void_p, ctypes.c_void_p,                   # ranges, ids
    ctypes.c_void_p, ctypes.c_void_p,                   # band, colmin
    ctypes.c_void_p, ctypes.c_int32,                    # mrow_t, S
    ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,    # pchars, T, t
    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,     # kb, W, switchpoint
    *_BAND_OUT, ctypes.c_int32],                        # ..., rw
    "columba_tpu_torch/csrc/band_step_rlc.cu")
KERNEL = native.Kernel(
    "band_step", "columba_band_step",
    [ctypes.c_void_p, ctypes.c_int64,                    # occ_fused, blocks
     ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
     ctypes.c_uint32, ctypes.c_uint32,                   # counts, dollar
     ctypes.c_void_p, ctypes.c_void_p,                   # ranges, ids
     ctypes.c_void_p, ctypes.c_void_p,                   # band, colmin
     ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,   # mrow_t, S, dyn_meta
     ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,    # pchars, T, t
     ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,     # kb, W, switchpoint
     *_BAND_OUT],
    source="columba_tpu_torch/csrc/band_step.cu",
    replaces="columba_tpu/search/executor.py:587",
    symbols={"rlc": _BAND_RLC, "textless": _BAND_RLC},
)


@dataclass(frozen=True)
class FrontierResult:
    """Final frontier after a scheme run (candidate hits where done)."""

    ranges: torch.Tensor      # (C, rw) int64 SA range pairs (+ RLC hints)
    rid: torch.Tensor         # (C,) read row
    sid: torch.Tensor         # (C,) search id
    ed_lb: torch.Tensor       # (C,) colMin_back + colMin_fwd
    done: torch.Tensor        # (C,) bool: completed candidate
    overflow: torch.Tensor    # () lanes dropped by capacity (0 => lossless)
    nodes_visited: torch.Tensor  # () total extensions
    itv: torch.Tensor         # (M, 4) int64 rows [f_lo, f_hi, ids, depth]
    itv_count: torch.Tensor   # () valid rows (clamped to M)
    searches_started: torch.Tensor  # () lanes entering the band phase
    arg_b: torch.Tensor       # (C,) int8 back depth (mod 64) of the final
                              # back window's minimum (track_arg runs; -1
                              # where the back side has no window or
                              # without track_arg)


def host_tables(sched: Schedule) -> dict:
    """Schedule tables as numpy arrays stacked for the step loops: one
    (T, S, 7) int32 row per step (meta word: bit 0 active, bit 1 side,
    bits 2-5 cacc, 6-9 cfro, 10-17 ub, 18-29 back depth; then the three
    cops and three cini words), the (E, S) exact-prefix tables, the
    per-cell band codes (0 = read char, -1 = no diag, -2 = invalid), and
    the per-search back depth and pivot that candidate staging reads."""
    meta = (
        sched.active.astype(np.int32)
        | (sched.side.astype(np.int32) << 1)
        | (sched.cacc.astype(np.int32) << 2)
        | (sched.cfro.astype(np.int32) << 6)
        | (sched.ub.astype(np.int32) << 10)
        | (sched.db.astype(np.int32) << 18)
    )
    mrow = np.stack(
        [meta.T] + [sched.cops[:, :, w].T for w in range(3)]
        + [sched.cini[:, :, w].T for w in range(3)], axis=-1)
    code = np.where(~sched.cvalid, np.int8(-2),
                    np.where(~sched.mvalid, np.int8(-1), np.int8(0)))
    return dict(
        mrow=np.ascontiguousarray(mrow, dtype=np.int32),     # (T, S, 7)
        ex_pos=np.ascontiguousarray(sched.ex_pos.T),         # (E, S)
        ex_dir=np.ascontiguousarray(sched.ex_dir.T),         # (E, S)
        db_ex=np.ascontiguousarray(sched.db_ex.T),           # (E, S)
        db_exact=sched.db_exact.astype(np.int32),            # (S,)
        band_init=sched.band_init.astype(np.int8),           # (S, 2, BW)
        colmin_init=sched.colmin_init.astype(np.int8),       # (S, 2, W)
        posw=sched.posw.astype(np.int64),                    # (S, T, BW)
        code=code.astype(np.int8),                           # (S, T, BW)
        final_reg=sched.final_reg.astype(np.int64),          # (S, 2)
        u_last=sched.u_last.astype(np.int64),                # (S,)
        t_back=np.asarray(sched.t_back, dtype=np.int64),     # (S,)
        pivot=np.asarray(sched.pivot, dtype=np.int64),       # (S,)
    )


_TABLES: dict = {}


def device_tables(sched: Schedule, device) -> dict:
    """host_tables on ``device``, cached per (schedule, device); the entry
    keeps the schedule alive so its id cannot be reused."""
    key = (id(sched), str(device))
    ent = _TABLES.get(key)
    if ent is None or ent[0] is not sched:
        ent = (sched, {k: torch.from_numpy(v).to(device)
                       for k, v in host_tables(sched).items()})
        _TABLES[key] = ent
    return ent[1]


def _band_row_update(prev: torch.Tensor, pchars: torch.Tensor,
                     bw: int) -> torch.Tensor:
    """One banded-DP row for all 4 extension chars.

    prev: (C, BW) int8 previous row; pchars: (C, BW) int8 cell codes
    (0..4 read char, 4 = N mismatches all; -1 no diag transition; -2 cell
    outside the pattern). Returns (C, 4, BW) int8, saturated at INF."""
    p = prev.int()
    code = pchars.int()
    up = torch.cat([p[:, 1:], torch.full_like(p[:, :1], INF)], dim=1) + 1
    rows = []
    for c in range(4):
        mis = torch.where(code == c, 0, torch.where(code >= 0, 1, INF))
        nl = torch.minimum(p + mis, up)
        cols = [nl[:, 0]]
        for o in range(1, bw):          # deletion scan, left to right
            cols.append(torch.minimum(nl[:, o], cols[-1] + 1))
        row = torch.stack(cols, dim=1)
        rows.append(torch.where(code >= -1, row.clamp(max=INF), INF))
    return torch.stack(rows, dim=1).to(torch.int8)


def _lane_scalars(ids_c, mrow_t, dyn_meta, T: int, t: int):
    """Each lane's packed scalars of step t as (C, 7) int64 rows in the
    static layout's order [meta, 3 cops, 3 cini], and its cacc, cfro, ub and
    back depth. Static schedules: the step's (S, 7) row of the lane's
    search. Per-lane schedules (``dyn_meta``, dynamic partitioning): the
    lane's own word at ``ids * T + t`` in the layout of
    ``search/dynschedule.py`` (creset at bit 2, colo + 1 at bits 3-8, ub at
    bit 9, back depth at bit 17), translated into the ops of its single
    register."""
    if dyn_meta is None:
        mr = mrow_t.long()[ids_c % mrow_t.shape[0]]
        meta = mr[:, 0]
        return (mr, (meta >> 2) & 15, (meta >> 6) & 15, (meta >> 10) & 255,
                (meta >> 18) & 4095)
    meta = dyn_meta.long()[ids_c * T + t]
    colo = ((meta >> 3) & 63) - 1
    zero = torch.zeros_like(meta)
    cops = torch.where(colo >= 0, colo | (((meta >> 2) & 1) << 6), 63)
    mr = torch.stack([meta, cops, zero, zero, zero + 63, zero, zero], dim=1)
    return (mr, torch.where(colo >= 0, 0, 15), zero, (meta >> 9) & 255,
            (meta >> 17) & 4095)


def band_step_plain(index: FMIndex, ranges, ids, band, colmin, mrow_t,
                    pchars, T: int, t: int, switchpoint: int,
                    dyn_meta=None, track_arg: bool = False) -> dict:
    """Plain version of kernel B: one band step's per-lane arithmetic.

    Returns the children's state (``ch_ranges`` (C,4,rw), ``ch_band``
    (C,4,2,BW), ``ch_colmin`` (C,4,2,Wp)), ``new_ids`` (ghost marks),
    ``ch_alive`` and ``narrow`` (C,4) flags, and per-lane ``act`` and
    ``dbv`` (back depth). With ``dyn_meta`` the lanes read their own
    schedule words and ``mrow_t`` is not read (see :func:`_lane_scalars`).
    With ``track_arg`` the last W of the Wp = 2W colMin slots per side are
    the registers' shadow slots (``columba_tpu/search/executor.py:652-675``):
    a reset restarts the witness at the back depth mod 64, a strict
    decrease moves it there, a tie keeps it."""
    C, _, bw = band.shape
    Wp = colmin.shape[-1]
    W = Wp // 2 if track_arg else Wp
    dev = ranges.device
    ghost = ids < 0
    ids_c = (ids & GHOST_IDM).long()
    alive = ranges[:, 1] > ranges[:, 0]
    mr, cacc, cfro, ub, dbv = _lane_scalars(ids_c, mrow_t, dyn_meta, T, t)
    meta = mr[:, 0]
    act = ((meta & 1) == 1) & alive & ~ghost
    sd = (meta >> 1) & 1
    is_b = sd == 0

    children = extend.extend_all_plain(
        index, torch.where(act[:, None], ranges, 0), sd.int())
    prev = torch.where(is_b[:, None], band[:, 0], band[:, 1])
    newD = _band_row_update(prev, pchars[ids_c * T + t], bw)
    nD = newD.long()

    cm0, cm1 = colmin[:, 0].long(), colmin[:, 1].long()
    cm_sd = torch.where(is_b[:, None], cm0, cm1)
    cm_other = torch.where(is_b[:, None], cm1, cm0)
    dbv_mod = dbv & 63
    regs, args = [], []
    for w in range(W):
        op = (mr[:, 1 + w // 4] >> (7 * (w % 4))) & 127
        ini = (mr[:, 4 + w // 4] >> (7 * (w % 4))) & 127
        cell = op & 63
        rst = (op & 64) != 0
        base = torch.where(rst, ini.clamp(max=INF), cm_sd[:, w])
        acc = torch.full((C, 4), INF, dtype=torch.int64, device=dev)
        for o in range(bw):
            acc = torch.where((cell == o)[:, None], nD[:, :, o], acc)
        valid = (cell < 63)[:, None]
        regs.append(torch.where(valid, torch.minimum(base[:, None], acc),
                                cm_sd[:, w, None]))
        if track_arg:
            prev_arg = torch.where(rst, dbv_mod, cm_sd[:, W + w])
            args.append(torch.where(valid & (acc < base[:, None]),
                                    dbv_mod[:, None], prev_arg[:, None]))
    reg = torch.stack(regs + args, dim=2)                   # (C, 4, Wp)

    width = (children[..., 1] - children[..., 0]) & rank.MASK32
    col = torch.full((C, 4), INF, dtype=torch.int64, device=dev)
    cmo = torch.zeros(C, dtype=torch.int64, device=dev)
    for w in range(W):
        col = torch.where((cacc == w)[:, None], reg[:, :, w], col)
        cmo = torch.where(cfro == w, cm_other[:, w], cmo)
    bound = torch.minimum(nD.min(dim=-1).values, col) + cmo[:, None]
    ok = act[:, None] & (width > 0) & (bound <= ub[:, None])
    if switchpoint > 0:
        narrow = ok & (width <= switchpoint)
    else:
        narrow = torch.zeros_like(ok)
    calive = ok & ~narrow
    died = act & alive & ~ok.any(dim=1)
    keepv = act & ~died
    new_ids = torch.where(
        died, ids | GHOST_BIT | (dbv.clamp(max=1023) << 21).int(), ids)

    slot0 = torch.zeros((C, 4), dtype=torch.bool, device=dev)
    slot0[:, 0] = alive
    ch_alive = torch.where(keepv[:, None], calive, slot0)
    if ranges.shape[1] > 4:
        # RLC: only the children that stay in the frontier keep their hints
        children[..., 4:] = torch.where(calive[..., None], children[..., 4:],
                                        0)
    ch_ranges = torch.where(keepv[:, None, None], children,
                            torch.where(slot0[..., None], ranges[:, None], 0))
    kb_ = (is_b & keepv)[:, None, None]
    kf_ = (~is_b & keepv)[:, None, None]
    ch_band = torch.stack([torch.where(kb_, newD, band[:, None, 0]),
                           torch.where(kf_, newD, band[:, None, 1])], dim=2)
    reg8 = reg.to(torch.int8)
    ch_colmin = torch.stack([torch.where(kb_, reg8, colmin[:, None, 0]),
                             torch.where(kf_, reg8, colmin[:, None, 1])],
                            dim=2)
    return dict(ch_ranges=ch_ranges, new_ids=new_ids, ch_band=ch_band,
                ch_colmin=ch_colmin, ch_alive=ch_alive, narrow=narrow,
                act=act, dbv=dbv.int())


def band_step(index: FMIndex, ranges, ids, band, colmin, mrow_t, pchars,
              T: int, t: int, switchpoint: int, dyn_meta=None,
              track_arg: bool = False) -> dict:
    """One band step's per-lane arithmetic: the plain version for CPU
    tensors, kernel B for CUDA tensors (same outputs). ``dyn_meta``
    (R*S*T,) int32 selects the per-lane entry (one register; ``mrow_t`` is
    then None). On the RLC index the lanes are 8 wide (RLC entry) or, with
    ``track_arg``, 12 wide with 2W colMin slots (textless entry)."""
    if not ranges.is_cuda:
        return band_step_plain(index, ranges, ids, band, colmin, mrow_t,
                               pchars, T, t, switchpoint, dyn_meta, track_arg)
    C, _, bw = band.shape
    kb = (bw - 1) // 2
    Wp = colmin.shape[-1]
    W = Wp // 2 if track_arg else Wp
    rw = index.range_width
    rlc = isinstance(index, BMoveIndex)
    if rlc and (dyn_meta is not None or track_arg != index.textless):
        raise ValueError("kernel B takes per-lane schedules on the Vanilla "
                         "index only, and track_arg exactly on the textless "
                         "index")
    if not rlc and track_arg:
        raise ValueError("kernel B tracks colMin witnesses on the textless "
                         "index only")
    if dyn_meta is not None:
        if W != 1 or mrow_t is not None:
            raise ValueError("kernel B's per-lane entry takes one register "
                             "and no step row")
        scalars = (dyn_meta, torch.int32, (dyn_meta.shape[0],))
    else:
        scalars = (mrow_t, torch.int32, (mrow_t.shape[0], 7))
    if bw != 2 * kb + 1 or kb > KERNEL_MAX_KB or not 1 <= W <= KERNEL_MAX_W:
        raise ValueError(
            f"kernel B takes band widths 2kb+1 with kb <= {KERNEL_MAX_KB} "
            f"and 1..{KERNEL_MAX_W} registers, not bw={bw}, W={W}: no "
            "schedule produces that")
    expect = ((ranges, torch.int64, (C, rw)), (ids, torch.int32, (C,)),
              (band, torch.int8, (C, 2, bw)),
              (colmin, torch.int8, (C, 2, Wp)),
              scalars, (pchars, torch.int8, (pchars.shape[0], bw)))
    for tns, dt, shape in expect:
        if (tns.dtype != dt or tuple(tns.shape) != shape
                or not tns.is_contiguous() or tns.device != ranges.device):
            raise ValueError(f"kernel B input {tuple(tns.shape)} "
                             f"{tns.dtype} is not a contiguous {shape} {dt} "
                             "on the lanes' device")
    dev = ranges.device
    out = dict(
        ch_ranges=torch.empty((C, 4, rw), dtype=torch.int64, device=dev),
        new_ids=torch.empty(C, dtype=torch.int32, device=dev),
        ch_band=torch.empty((C, 4, 2, bw), dtype=torch.int8, device=dev),
        ch_colmin=torch.empty((C, 4, 2, Wp), dtype=torch.int8, device=dev),
        ch_alive=torch.empty((C, 4), dtype=torch.bool, device=dev),
        narrow=torch.empty((C, 4), dtype=torch.bool, device=dev),
        act=torch.empty(C, dtype=torch.bool, device=dev),
        dbv=torch.empty(C, dtype=torch.int32, device=dev),
    )
    outs = [out[k].data_ptr() for k in ("ch_ranges", "new_ids", "ch_band",
                                        "ch_colmin", "ch_alive", "narrow",
                                        "act", "dbv")]
    if C and rlc:
        KERNEL(*bextend.bm_args(index), ranges.data_ptr(), ids.data_ptr(),
               band.data_ptr(), colmin.data_ptr(), mrow_t.data_ptr(),
               mrow_t.shape[0], pchars.data_ptr(), T, t, kb, W, switchpoint,
               *outs, C, rw, entry="textless" if index.textless else "rlc")
    elif C:
        KERNEL(index.occ_fused.data_ptr(), index.blocks, *index.counts_host,
               *index.dollar_host, ranges.data_ptr(), ids.data_ptr(),
               band.data_ptr(), colmin.data_ptr(),
               mrow_t.data_ptr() if dyn_meta is None else None,
               mrow_t.shape[0] if dyn_meta is None else 0,
               dyn_meta.data_ptr() if dyn_meta is not None else None,
               pchars.data_ptr(), T, t, kb, W, switchpoint, *outs, C,
               entry="per_lane" if dyn_meta is not None else "")
    return out


def _compact(keep: torch.Tensor, cap: int, fields, fills=None):
    """Order-keeping compaction: the rows where ``keep`` holds, in order,
    into ``cap`` slots (the rest take ``fills``, default 0). Returns the
    compacted fields and the number of kept rows (a device scalar)."""
    pos = keep.long().cumsum(0) - 1
    dest = torch.where(keep & (pos < cap), pos, cap)
    out = []
    for i, f in enumerate(fields):
        fill = 0 if fills is None else fills[i]
        o = torch.full((cap + 1, *f.shape[1:]), fill, dtype=f.dtype,
                       device=f.device)
        o[dest] = f
        out.append(o[:cap])
    return out, pos[-1] + 1


def _append(buf, cnt, rows, keep, M):
    """Append ``rows`` where ``keep`` (in order) to the in-text buffer
    (M valid rows + one scratch row), clamping the count at M."""
    pos = keep.long().cumsum(0) - 1
    buf[torch.where(keep, torch.clamp(cnt + pos, max=M), M)] = rows
    return torch.clamp(cnt + pos[-1] + 1, max=M)


def _any_alive(ranges) -> bool:
    return bool((ranges[:, 1] > ranges[:, 0]).any())


def run_scheme(
    index: FMIndex,
    reads: torch.Tensor,
    sched: Schedule,
    capacity: int,
    kmer_table: torch.Tensor | None = None,
    switchpoint: int = 0,
    itv_cap: int = 0,
    split_step: int = 0,
    capacity2: int = 0,
    itv_min_depth: int = 20,
    tables: dict | None = None,
    ex_split: int = 0,
    ex_cap: int = 0,
    search_mask: torch.Tensor | None = None,
    dyn: dict | None = None,
    track_arg: bool = False,
) -> FrontierResult:
    """Execute one compiled scheme over a read batch.

    reads: (R, m) uint8 codes on the index's device (strands are separate
    rows); capacity: frontier size C; kmer_table: optional (4^K, 4) seed
    table matching the schedule's kmer_k. ex_split/ex_cap: two-stage exact
    loop (after ``ex_split`` steps the survivors are compacted into
    ``ex_cap`` lanes, overflow counted). split_step/capacity2: two-stage
    band loop (after ``split_step`` steps the frontier shrinks to
    ``capacity2``). search_mask: optional (R, S) bool, the searches that
    live per read (dynamic scheme selection); the others start empty.
    dyn: per-(read, search) schedule tables of
    ``dynschedule.build_tables`` (dynamic partitioning); every lane then
    starts from the full range without k-mer seeding, reads its own exact
    steps, band words and cell codes, and has one colMin register.
    track_arg: shadow slots for the colMin registers' witnesses (the
    textless pass; ``FrontierResult.arg_b``).
    """
    from columba_tpu_torch.index import kmer as kmer_mod

    R, m = reads.shape
    S = sched.num_searches
    C = int(capacity)
    bw = sched.bw
    dev = reads.device
    if R * S > GHOST_IDM + 1:
        raise ValueError(
            f"batch of {R} rows x {S} searches exceeds the 2^21 lane-id "
            "space (ghost encoding); lower the batch size")
    if dyn is not None:
        # single register: dynamic partitions are clamped to parts longer
        # than 2k, so colMin windows never overlap
        T, E, W = dyn["meta"].shape[1], dyn["ex_pos"].shape[1], 1
    else:
        if tables is None:
            tables = device_tables(sched, dev)
        T, E, W = sched.t_max, sched.e_max, int(sched.W)
    if track_arg and dyn is not None:
        raise NotImplementedError("track_arg with per-read schedules")
    Wp = 2 * W if track_arg else W
    rw = index.range_width
    if rw != 4 and kmer_table is not None:
        raise NotImplementedError(
            "the k-mer seed table is 4 wide (no run hints); pass "
            "kmer_table=None for the RLC index")
    L = R * S
    i64 = dict(dtype=torch.int64, device=dev)
    ids0 = torch.arange(L, dtype=torch.int32, device=dev)  # rid * S + sid
    kmer_eff = 0 if dyn is not None else sched.kmer_k

    if dyn is not None:
        ranges0 = index.full_range((L,))
    elif sched.kmer_k > 0:
        if kmer_table is None:
            raise ValueError("schedule compiled with k-mer seeding but no "
                             "table given")
        Kk = sched.kmer_k
        cols = [index.full_range((R,)) if int(ks) < 0
                else kmer_mod.lookup(kmer_table, reads[:, ks:ks + Kk])
                for ks in sched.kmer_start]
        ranges0 = torch.stack(cols, dim=1).reshape(L, 4)
    else:
        ranges0 = index.full_range((L,))
    if search_mask is not None:
        ranges0 = torch.where(search_mask.reshape(-1)[:, None], ranges0, 0)
    ranges0 = torch.where((ranges0[:, 1] > ranges0[:, 0])[:, None],
                          ranges0, 0)

    # in-text buffer: crossover drains and boundary-harvest ghosts; row M
    # is scratch for the rows that do not fit
    M = max(int(itv_cap), 4096)
    itv_buf = torch.zeros((M + 1, 4), **i64)
    itv_cnt = torch.zeros((), **i64)
    overflow_ex = torch.zeros((), **i64)

    # ---------------- exact prefix ----------------
    if E > 0:
        # gate the crossover on matched depth: shorter segments are not
        # specific and would flood locate/verify with junk windows
        gate_t = max(0, itv_min_depth - kmer_eff - 1)
        if dyn is not None:
            # per-read schedules pad every lane to E = m steps: keep the
            # steps in which some lane extends, and those up to the gate
            # step, where the narrow lanes that wait are drained. The steps
            # after them change nothing.
            n_ex = int((dyn["ex_pos"] >= 0).any(dim=0).sum())
            E = min(E, max(n_ex, gate_t + 1))
            ex_pos = dyn["ex_pos"][:, :E].t().contiguous()   # (E, L)
            ex_dir = dyn["ex_dir"][:, :E].t().contiguous()
            db_ex = dyn["db_ex_steps"][:, :E].t().long()
            ex_chars = reads[(ids0 // S).long()[:, None],
                             dyn["ex_pos"][:, :E].clamp(0, m - 1).long()]
            ex_chars = ex_chars.t().int().contiguous()
        else:
            ex_pos = tables["ex_pos"].repeat(1, R)           # (E, L)
            ex_dir = tables["ex_dir"].repeat(1, R)
            db_ex = tables["db_ex"].repeat(1, R).long()
            ex_chars = reads[:, tables["ex_pos"].clamp(min=0).long()]
            ex_chars = ex_chars.permute(1, 0, 2).reshape(E, L).int()
        ex_chars = torch.where(ex_pos >= 0, ex_chars, 0)

        def run_ex(pos_t, dir_t, db_t, chars_t, ids_v, t_off, ranges,
                   drows):
            for t in range(pos_t.shape[0]):
                if not _any_alive(ranges):
                    break
                alive = ranges[:, 1] > ranges[:, 0]
                act = (pos_t[t] >= 0) & alive
                new = extend.extend_char(
                    index, torch.where(act[:, None], ranges, 0),
                    chars_t[t], dir_t[t])
                new = torch.where(act[:, None], new, ranges)
                new = torch.where((new[:, 1] > new[:, 0])[:, None], new, 0)
                if switchpoint > 0:
                    width = new[:, 1] - new[:, 0]
                    narrow = ((width > 0) & (width <= switchpoint)
                              & (t + t_off >= gate_t))
                    row = torch.stack([new[:, 0], new[:, 1], ids_v.long(),
                                       db_t[t]], dim=1)
                    drows = torch.where(narrow[:, None], row, drows)
                    new = torch.where(narrow[:, None], 0, new)
                ranges = new
            return ranges, drows

        drows0 = torch.zeros((L, 4), **i64)
        if 0 < ex_split < E and 0 < ex_cap < L:
            ranges0, drows0 = run_ex(ex_pos[:ex_split], ex_dir[:ex_split],
                                     db_ex[:ex_split], ex_chars[:ex_split],
                                     ids0, 0, ranges0, drows0)
            EC = int(ex_cap)
            lane = torch.arange(L, **i64)
            (src,), n1 = _compact(ranges0[:, 1] > ranges0[:, 0], EC,
                                  [lane], [L])
            overflow_ex = torch.clamp(n1 - EC, min=0)
            live1 = src < L
            srcc = torch.where(live1, src, 0)
            r2 = torch.where(live1[:, None], ranges0[srcc], 0)
            r2, dr2 = run_ex(ex_pos[ex_split:, srcc], ex_dir[ex_split:, srcc],
                             db_ex[ex_split:, srcc], ex_chars[ex_split:, srcc],
                             ids0[srcc], ex_split, r2,
                             torch.zeros((EC, 4), **i64))
            # back into the full lane layout (stage-1 survivors had no
            # drain row, so this cannot clobber one)
            back = torch.where(live1, srcc, L)
            ranges0 = torch.zeros((L + 1, rw), **i64)
            ranges0[back] = r2
            ranges0 = ranges0[:L]
            drows0 = torch.cat([drows0, torch.zeros((1, 4), **i64)])
            drows0[back] = dr2
            drows0 = drows0[:L]
        else:
            ranges0, drows0 = run_ex(ex_pos, ex_dir, db_ex, ex_chars, ids0,
                                     0, ranges0, drows0)
        if switchpoint > 0:
            itv_cnt = _append(itv_buf, itv_cnt, drows0,
                              drows0[:, 1] > drows0[:, 0], M)

    # ---------------- frontier init ----------------
    if switchpoint > 0:
        width = ranges0[:, 1] - ranges0[:, 0]
        narrow = (width > 0) & (width <= switchpoint)
        db_exact = (dyn["db_exact"] if dyn is not None
                    else tables["db_exact"].repeat(R))
        rows = torch.stack([ranges0[:, 0], ranges0[:, 1], ids0.long(),
                            db_exact.long()], dim=1)
        itv_cnt = _append(itv_buf, itv_cnt, rows, narrow, M)
        ranges0 = torch.where(narrow[:, None], 0, ranges0)

    if dyn is not None:
        band_init = dyn["band_init"]
        colmin_init = dyn["colmin_init"].reshape(L, 2, 1)
    else:
        band_init = tables["band_init"].repeat(R, 1, 1)
        colmin_init = tables["colmin_init"].repeat(R, 1, 1)
    if track_arg:
        colmin_init = torch.cat([colmin_init, torch.zeros_like(colmin_init)],
                                dim=-1)
    (ranges, ids, band, colmin), n_alive0 = _compact(
        ranges0[:, 1] > ranges0[:, 0], C,
        [ranges0, ids0, band_init, colmin_init], [0, 0, INF, INF])
    overflow = torch.clamp(n_alive0 - C, min=0) + overflow_ex
    visits = torch.zeros((), **i64)

    # ---------------- lockstep band steps ----------------
    if T > 0:
        if dyn is not None:
            pchars = dyn["pchars"]
            dyn_meta = dyn["meta"].reshape(-1)               # (R*S*T,)
        else:
            posw = tables["posw"]                            # (S, T, BW)
            pchars = reads[:, posw].to(torch.int8)           # (R, S, T, BW)
            code = tables["code"]
            pchars = torch.where(code[None] == 0, pchars, code[None])
            pchars = pchars.reshape(R * S * T, bw).contiguous()
            mrow, dyn_meta = tables["mrow"], None

        def run_steps(state, overflow, visits, itv_cnt, t_lo, t_hi):
            ranges, ids, band, colmin = state
            cap = ranges.shape[0]
            for t in range(t_lo, t_hi):
                if not _any_alive(ranges):
                    break
                o = band_step(index, ranges, ids, band, colmin,
                              mrow[t] if dyn_meta is None else None,
                              pchars, T, t, switchpoint, dyn_meta, track_arg)
                visits = visits + o["act"].sum() * 4
                if switchpoint > 0:
                    ch = o["ch_ranges"]
                    rows = torch.stack([
                        ch[..., 0].reshape(-1), ch[..., 1].reshape(-1),
                        (o["new_ids"] & GHOST_IDM).long()
                        .repeat_interleave(4),
                        o["dbv"].long().repeat_interleave(4)], dim=1)
                    itv_cnt = _append(itv_buf, itv_cnt, rows,
                                      o["narrow"].reshape(-1), M)
                (ranges, ids, band, colmin), n = _compact(
                    o["ch_alive"].reshape(-1), cap,
                    [o["ch_ranges"].reshape(4 * cap, rw),
                     o["new_ids"].repeat_interleave(4),
                     o["ch_band"].reshape(4 * cap, 2, bw),
                     o["ch_colmin"].reshape(4 * cap, 2, Wp)])
                overflow = overflow + torch.clamp(n - cap, min=0)
            return (ranges, ids, band, colmin), overflow, visits, itv_cnt

        state = (ranges, ids, band, colmin)
        if 0 < split_step < T and 0 < capacity2 < C:
            state, overflow, visits, itv_cnt = run_steps(
                state, overflow, visits, itv_cnt, 0, split_step)
            state, n = _compact(state[0][:, 1] > state[0][:, 0],
                                int(capacity2), list(state))
            overflow = overflow + torch.clamp(n - int(capacity2), min=0)
            state, overflow, visits, itv_cnt = run_steps(
                state, overflow, visits, itv_cnt, split_step, T)
        else:
            state, overflow, visits, itv_cnt = run_steps(
                state, overflow, visits, itv_cnt, 0, T)
        ranges, ids, band, colmin = state

    # ---------------- tail ----------------
    # ghosts join the in-text buffer with their stashed death depth
    ghost = ids < 0
    grows = torch.stack([ranges[:, 0], ranges[:, 1],
                         (ids & GHOST_IDM).long(),
                         ((ids >> 21) & 1023).long()], dim=1)
    itv_cnt = _append(itv_buf, itv_cnt, grows, ghost, M)
    ids = (ids & GHOST_IDM).long()
    sid = ids % S
    # completion bound: each side's last window register (15 = none => 0);
    # per-lane schedules have the one register on both sides
    arg_b = torch.full(sid.shape, -1, dtype=torch.int8, device=dev)
    if dyn is not None:
        cm_b, cm_f = colmin[:, 0, 0].long(), colmin[:, 1, 0].long()
        u_last = dyn["u_last"].long()
    else:
        freg = tables["final_reg"][sid]                       # (Cf, 2)
        cm_b = torch.zeros_like(sid)
        cm_f = torch.zeros_like(sid)
        for w in range(W):
            cm_b = torch.where(freg[:, 0] == w, colmin[:, 0, w].long(), cm_b)
            cm_f = torch.where(freg[:, 1] == w, colmin[:, 1, w].long(), cm_f)
            if track_arg:
                arg_b = torch.where(freg[:, 0] == w, colmin[:, 0, W + w],
                                    arg_b)
        u_last = tables["u_last"]
    ed_lb = cm_b + cm_f
    alive = (ranges[:, 1] > ranges[:, 0]) & ~ghost
    done = alive & (ed_lb <= u_last[sid])
    return FrontierResult(
        ranges=ranges, rid=ids // S, sid=sid, ed_lb=ed_lb, done=done,
        overflow=overflow, nodes_visited=visits, itv=itv_buf[:M],
        itv_count=itv_cnt, searches_started=n_alive0, arg_b=arg_b)
