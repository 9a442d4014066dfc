"""Lockstep frontier executor for search schemes, and kernel B.

The counterpart of ``columba_tpu/search/executor.py`` (static-schedule
path): a fixed-capacity frontier of SA-interval lanes advances one text
character per step, driven by the tables of ``search/schedule.py``.

1. Exact prefix: each (read, search) lane walks its exact steps, seeded
   from the k-mer table; narrow lanes past the gate depth drain to the
   in-text buffer. On the card one thread walks one lane through every
   step in one launch (kernel A's loop entry, ``csrc/extend.cu``); the
   plain version, :func:`exact_loop_plain`, steps all lanes in lockstep as
   the JAX while-loop does.
2. Frontier init: order-keeping compaction of the live lanes into C.
3. Band steps: kernel B (``csrc/band_step.cuh``) computes every live lane's
   extension, banded rows, colMin registers, prune and ghost marking, and
   writes the kept children straight into the next frontier and the narrow
   children into the in-text buffer, in the order of the order-keeping
   compaction (a block scan and a look-back across blocks). The frontier
   ping-pongs between two buffer sets; per step the host reads one 8 B word
   back (kept count and in-text count) and stops when no lane is live, as
   the JAX while-loop does. The plain version,
   :func:`band_step_compact_plain`, is :func:`band_step_plain` followed by
   the drain append and the compaction in PyTorch.
4. Tail: ghosts join the in-text buffer; completion bound per lane.

State is struct-of-arrays tensors (int64 ranges, int32 ids, int8 bands and
registers) rather than the JAX package's packed uint32 rows, which were
laid out for TPU row gathers. Compaction keeps lane order, the order the JAX
sort-compaction produces, so every intermediate array compares equal with
the reference. Rows of a frontier past its live count are empty lanes; the
band steps never read them, and the frontier handed to the tail has them
zeroed, as the compaction's fill leaves them.

On the RLC index (``index/bmove.py``) a lane's range is ``rw`` = 8 values
(the range pair and its run hints) or 12 on the textless index (plus a
toehold sample); the in-text rows stay ``[f_lo, f_hi, ids, depth]``. Kernel
B then takes its RLC entry (``band_step.rlc``), under per-read schedules
its per-lane RLC entry (``band_step.per_lane_rlc``), or its textless entry
(``band_step.textless``), and a child that does not stay in the frontier
has zero hints (only the frontier reads them). ``track_arg`` (the textless pass)
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
# lanes of one kernel B block, one tile of its look-back (kThreads of
# csrc/band_step.cuh)
BAND_TILE = 64

_BAND_OUT = [ctypes.c_int64, ctypes.c_int64,             # n_live, cap
             ctypes.c_void_p, ctypes.c_void_p,           # next ranges, ids
             ctypes.c_void_p, ctypes.c_void_p,           # next band, colmin
             ctypes.c_void_p, ctypes.c_int64,            # itv, M
             ctypes.c_int64,                             # rows already in itv
             ctypes.c_void_p, ctypes.c_void_p,           # ctr, tile status
             ctypes.c_int64, ctypes.c_uint32]            # tiles, epoch
_BAND_RLC = ("columba_band_step_rlc", [
    *bextend.BM_ARGTYPES,
    ctypes.c_void_p, ctypes.c_void_p,                   # ranges, ids
    ctypes.c_void_p, ctypes.c_void_p,                   # band, colmin
    ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,   # mrow_t, S, dyn_meta
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
    symbols={"rlc": _BAND_RLC, "textless": _BAND_RLC,
             "per_lane_rlc": _BAND_RLC},
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


class StepScratch:
    """What the band steps of one run share besides the frontier.

    ``ctr`` (4,) int64 on the lanes' device: [0] the last step's word, kept
    children (n, before the capacity cut) | in-text rows << 32; [1] visits
    (4 per active lane); [2] overflow; [3] kernel B's block ticket. On the
    card also the look-back's tile statuses (two words a tile, stamped with
    the launch's epoch, 1 to 2^30 - 1, so that nothing is cleared between
    steps) and the pinned host word the step's count comes back through.
    One per run: runs on two host threads never share one."""

    def __init__(self, lanes: int, device):
        device = torch.device(device)
        self.ctr = torch.zeros(4, dtype=torch.int64, device=device)
        self.tiles = max(1, -(-int(lanes) // BAND_TILE))
        self.epoch = 0
        self.status = self.host = None
        if device.type == "cuda":
            self.status = torch.zeros(2 * self.tiles, dtype=torch.int64,
                                      device=device)
            self.host = torch.zeros(1, dtype=torch.int64, pin_memory=True)

    def next_epoch(self) -> int:
        self.epoch += 1
        return self.epoch

    def word(self) -> tuple[int, int]:
        """(kept children, in-text rows) of the last step: on the card one
        8 B copy into pinned memory and a wait for the stream."""
        if self.host is None:
            w = int(self.ctr[0])
        else:
            self.host.copy_(self.ctr[:1], non_blocking=True)
            torch.cuda.current_stream().synchronize()
            w = int(self.host[0])
        return w & rank.MASK32, w >> 32


def band_step_compact_plain(index: FMIndex, state, n_live: int, out, itv,
                            cnt: int, scratch: StepScratch, mrow_t, pchars,
                            T: int, t: int, switchpoint: int, dyn_meta=None,
                            track_arg: bool = False) -> None:
    """Plain version of kernel B: one band step of the first ``n_live``
    lanes of ``state`` (ranges, ids, band, colmin; the rows past it are
    empty lanes and are not read), then the narrow children's rows
    appended to ``itv`` ((M + 1, 4), ``cnt`` rows in it; row M is scratch)
    and the order-keeping compaction of the children that stay into
    ``out`` (the four fields of the next frontier, its capacity rows). The
    step's word (kept children, in-text rows), visits and overflow go to
    ``scratch.ctr``, as kernel B leaves them."""
    ranges, ids, band, colmin = (f[:n_live] for f in state)
    cap, rw = out[0].shape
    M = itv.shape[0] - 1
    o = band_step_plain(index, ranges, ids, band, colmin, mrow_t, pchars, T,
                        t, switchpoint, dyn_meta, track_arg)
    cnt_new = torch.tensor(cnt, dtype=torch.int64, device=ranges.device)
    if switchpoint > 0:
        ch = o["ch_ranges"]
        rows = torch.stack([
            ch[..., 0].reshape(-1), ch[..., 1].reshape(-1),
            (o["new_ids"] & GHOST_IDM).long().repeat_interleave(4),
            o["dbv"].long().repeat_interleave(4)], dim=1)
        cnt_new = _append(itv, cnt, rows, o["narrow"].reshape(-1), M)
    bw, Wp = band.shape[-1], colmin.shape[-1]
    new, n = _compact(o["ch_alive"].reshape(-1), cap,
                      [o["ch_ranges"].reshape(-1, rw),
                       o["new_ids"].repeat_interleave(4),
                       o["ch_band"].reshape(-1, 2, bw),
                       o["ch_colmin"].reshape(-1, 2, Wp)])
    for dst, src in zip(out, new):
        dst.copy_(src)
    ctr = scratch.ctr
    ctr[0] = n | (cnt_new << 32)
    ctr[1] += o["act"].sum() * 4
    ctr[2] += torch.clamp(n - cap, min=0)


def _span(t: torch.Tensor) -> tuple[int, int]:
    return t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()


def check_tensors(what: str, device, expect) -> None:
    """Raise unless each (tensor, dtype, shape) is a contiguous tensor of
    that dtype and shape on ``device``."""
    for tns, dt, shape in expect:
        if (tns.dtype != dt or tuple(tns.shape) != tuple(shape)
                or not tns.is_contiguous() or tns.device != device):
            raise ValueError(f"{what} input {tuple(tns.shape)} {tns.dtype} "
                             f"is not a contiguous {tuple(shape)} {dt} on "
                             f"{device}")


def check_disjoint(what: str, outs, ins) -> None:
    """Raise if an output tensor shares memory with another output or with
    an input: each thread's writes would land under another's reads."""
    outs = [_span(t) for t in outs if t is not None and t.numel()]
    ins = [_span(t) for t in ins if t is not None and t.numel()]
    for i, (a0, a1) in enumerate(outs):
        for b0, b1 in outs[i + 1:] + ins:
            if a0 < b1 and b0 < a1:
                raise ValueError(f"{what}: an output buffer overlaps "
                                 "another buffer of the call")


def check_band_step(index: FMIndex, state, n_live: int, out, itv,
                    scratch: StepScratch, mrow_t, pchars,
                    dyn_meta=None, track_arg: bool = False) -> tuple:
    """What kernel B checks before a launch: lane width, entry and shapes
    it takes, dtypes, contiguity and device of every buffer, 1..C live
    lanes within the scratch's tiles, and outputs that overlap neither each
    other nor an input. Returns (kb, W); raises ValueError otherwise."""
    ranges, ids, band, colmin = state
    C, _, bw = band.shape
    cap = out[0].shape[0]
    kb = (bw - 1) // 2
    Wp = colmin.shape[-1]
    W = Wp // 2 if track_arg else Wp
    rw = index.range_width
    rlc = isinstance(index, BMoveIndex)
    if rlc and (track_arg != index.textless
                or (dyn_meta is not None and index.textless)):
        raise ValueError("kernel B tracks colMin witnesses exactly on the "
                         "textless index, and takes per-lane schedules on "
                         "the Vanilla and the with-text RLC index only")
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
    M = itv.shape[0] - 1
    check_tensors("kernel B", ranges.device, (
        (ranges, torch.int64, (C, rw)), (ids, torch.int32, (C,)),
        (band, torch.int8, (C, 2, bw)), (colmin, torch.int8, (C, 2, Wp)),
        scalars, (pchars, torch.int8, (pchars.shape[0], bw)),
        (out[0], torch.int64, (cap, rw)), (out[1], torch.int32, (cap,)),
        (out[2], torch.int8, (cap, 2, bw)),
        (out[3], torch.int8, (cap, 2, Wp)),
        (itv, torch.int64, (M + 1, 4)), (scratch.ctr, torch.int64, (4,))))
    if not 0 < n_live <= min(C, scratch.tiles * BAND_TILE) or M < 0:
        raise ValueError(f"kernel B reads 1..{C} live lanes within its "
                         f"scratch's {scratch.tiles} tiles, not {n_live}")
    check_disjoint("kernel B", [*out, itv, scratch.ctr, scratch.status],
                   [*state, scalars[0], pchars])
    return kb, W


def band_step_compact(index: FMIndex, state, n_live: int, out, itv,
                      cnt: int, scratch: StepScratch, mrow_t, pchars,
                      T: int, t: int, switchpoint: int, dyn_meta=None,
                      track_arg: bool = False) -> None:
    """One band step fused with the drain append and the compaction (see
    :func:`band_step_compact_plain` for the arguments): the plain version
    for CPU tensors, kernel B for CUDA tensors, which leaves the same next
    frontier in its first min(n, capacity) rows (the rows past them are
    not written), the same in-text rows and the same counters.
    ``dyn_meta`` (R*S*T,) int32 selects the per-lane entry (one register;
    ``mrow_t`` is then None). On the RLC index the lanes are 8 wide (RLC
    entry, with ``dyn_meta`` the per-lane RLC entry) or, with
    ``track_arg``, 12 wide with 2W colMin slots (textless entry)."""
    ranges, ids, band, colmin = state
    if not ranges.is_cuda:
        return band_step_compact_plain(index, state, n_live, out, itv, cnt,
                                       scratch, mrow_t, pchars, T, t,
                                       switchpoint, dyn_meta, track_arg)
    kb, W = check_band_step(index, state, n_live, out, itv, scratch, mrow_t,
                            pchars, dyn_meta, track_arg)
    tail = (n_live, out[0].shape[0], *(f.data_ptr() for f in out),
            itv.data_ptr(), itv.shape[0] - 1, cnt, scratch.ctr.data_ptr(),
            scratch.status.data_ptr(), scratch.tiles, scratch.next_epoch())
    lane = (ranges.data_ptr(), ids.data_ptr(), band.data_ptr(),
            colmin.data_ptr(),
            mrow_t.data_ptr() if dyn_meta is None else None,
            mrow_t.shape[0] if dyn_meta is None else 0,
            dyn_meta.data_ptr() if dyn_meta is not None else None,
            pchars.data_ptr(), T, t, kb, W, switchpoint, *tail)
    if isinstance(index, BMoveIndex):
        KERNEL(*bextend.bm_args(index), *lane, index.range_width,
               entry=("per_lane_rlc" if dyn_meta is not None else
                      "textless" if index.textless else "rlc"))
    else:
        KERNEL(index.occ_fused.data_ptr(), index.blocks, *index.counts_host,
               *index.dollar_host, *lane,
               entry="per_lane" if dyn_meta is not None else "")


def _ex_col(tab, per_lane: bool, idl, S: int, t: int):
    """Step t's column of an exact-prefix table for lanes of ids ``idl``:
    (L_all, E) per-lane tables by id, (E, S) tables by id % S."""
    return tab[idl, t] if per_lane else tab[t][idl % S]


def exact_loop_plain(index: FMIndex, ranges, ids, t_lo: int, t_hi: int,
                     reads, tabs, per_lane: bool, gate_t: int,
                     switchpoint: int, stats: dict | None = None):
    """Plain version of kernel A's loop entry: exact-prefix steps t_lo..t_hi
    of every lane, all lanes in lockstep, as ``run_scheme``'s exact loop of
    the JAX package runs them.

    ranges: (L, rw) int64, dead lanes all zero; ids: (L,) int32 lane ids
    (None: the lane's index), id = read row * S + search; reads: (R, m)
    uint8; tabs: the (ex_pos, ex_dir, db_ex) tables, (E, S) read at
    [t, id % S] or with ``per_lane`` (L_all, E) read at [id, t]. At each
    step a lane with ex_pos < 0 keeps its range, the others extend by the
    read's char at ex_pos in direction ex_dir, and an empty result becomes
    zero; with ``switchpoint`` > 0 a live range of width <= switchpoint at
    a step t >= gate_t drains: its drain row is [lo, hi, id, db_ex[t]] and
    the lane becomes zero (a lane narrow before the gate drains at the gate
    step, with that step's db_ex). Returns the final ranges and the (L, 4)
    int64 drain rows (zero where a lane did not drain). The loop stops when
    no lane is live, or past the last step in which some lane extends and
    the gate step: later steps change nothing. ``stats`` (optional) counts
    the extensions (``steps``) and, on the RLC index, their walks."""
    L = ranges.shape[0]
    dev = ranges.device
    pos_tab, dir_tab, db_tab = tabs
    S = pos_tab.shape[0] // reads.shape[0] if per_lane else pos_tab.shape[1]
    idl = torch.arange(L, device=dev) if ids is None else ids.long()
    rid = idl // S
    ext = (pos_tab >= 0).any(dim=0 if per_lane else 1)
    last = int(ext.nonzero().max()) + 1 if bool(ext.any()) else 0
    t_end = min(t_hi, max(last, gate_t + 1) if switchpoint > 0 else last)
    drows = torch.zeros((L, 4), dtype=torch.int64, device=dev)
    for t in range(t_lo, t_end):
        alive = ranges[:, 1] > ranges[:, 0]
        if not bool(alive.any()):
            break
        pos = _ex_col(pos_tab, per_lane, idl, S, t)
        act = (pos >= 0) & alive
        new = ranges.clone()
        if bool(act.any()):
            sel = act.nonzero()[:, 0]
            chars = reads[rid[sel], pos[sel].long()].int()
            dirs = _ex_col(dir_tab, per_lane, idl, S, t)[sel].int()
            if isinstance(index, BMoveIndex):
                new[sel] = bextend.extend_char_plain(index, ranges[sel],
                                                     chars, dirs, stats)
            else:
                new[sel] = extend.extend_char_plain(index, ranges[sel],
                                                    chars, dirs)
            if stats is not None:         # a lane meeting N reads no row
                stats["steps"] = stats.get("steps", 0) + int(
                    (chars <= 3).sum())
        new = torch.where((new[:, 1] > new[:, 0])[:, None], new, 0)
        if switchpoint > 0:
            width = new[:, 1] - new[:, 0]
            narrow = (width > 0) & (width <= switchpoint) & (t >= gate_t)
            row = torch.stack([new[:, 0], new[:, 1], idl,
                               _ex_col(db_tab, per_lane, idl, S, t).long()],
                              dim=1)
            drows = torch.where(narrow[:, None], row, drows)
            new = torch.where(narrow[:, None], 0, new)
        ranges = new
    return ranges, drows


def check_exact_loop(index: FMIndex, ranges, ids, t_lo: int, t_hi: int,
                     reads, tabs, per_lane: bool) -> tuple:
    """What kernel A's loop entry checks before a launch: contiguous int64
    lanes of the index's width, int32 ids, a uint8 read batch and int32
    tables of the layout ``per_lane`` names, all on one device, and steps
    within the tables. Returns (S, E); raises ValueError otherwise."""
    L = ranges.shape[0]
    R, m = reads.shape
    pos_tab, dir_tab, db_tab = tabs
    E = pos_tab.shape[1] if per_lane else pos_tab.shape[0]
    S = pos_tab.shape[0] // max(R, 1) if per_lane else pos_tab.shape[1]
    tshape = (R * S, E) if per_lane else (E, S)
    check_tensors("kernel A's loop", ranges.device, (
        (ranges, torch.int64, (L, index.range_width)),
        (reads, torch.uint8, (R, m)), (pos_tab, torch.int32, tshape),
        (dir_tab, torch.int32, tshape), (db_tab, torch.int32, tshape),
        *(((ids, torch.int32, (L,)),) if ids is not None else ())))
    if not 0 <= t_lo <= t_hi <= E or S < 1:
        raise ValueError(f"kernel A's loop takes steps within 0..{E} of "
                         f"{S} >= 1 searches, not {t_lo}..{t_hi}")
    return S, E


def exact_loop(index: FMIndex, ranges, ids, t_lo: int, t_hi: int, reads,
               tabs, per_lane: bool, gate_t: int, switchpoint: int):
    """Exact-prefix steps t_lo..t_hi of every lane (see
    :func:`exact_loop_plain`): the plain version for CPU tensors, one
    launch of kernel A's loop entry for CUDA tensors (``extend.loop``, on
    the RLC index ``extend.loop_rlc``), in which one thread walks one lane
    until its range is empty or drained. Returns (ranges, drain rows)."""
    if not ranges.is_cuda:
        return exact_loop_plain(index, ranges, ids, t_lo, t_hi, reads, tabs,
                                per_lane, gate_t, switchpoint)
    S, E = check_exact_loop(index, ranges, ids, t_lo, t_hi, reads, tabs,
                            per_lane)
    L = ranges.shape[0]
    out = torch.empty_like(ranges)
    drows = torch.empty((L, 4), dtype=torch.int64, device=ranges.device)
    args = (ranges.data_ptr(), ids.data_ptr() if ids is not None else None,
            L, reads.data_ptr(), reads.shape[1], S,
            *(tab.data_ptr() for tab in tabs), E if per_lane else 0,
            t_lo, t_hi, gate_t, switchpoint, out.data_ptr(),
            drows.data_ptr())
    if L and isinstance(index, BMoveIndex):
        extend.KERNEL(*bextend.bm_args(index), *args, index.range_width,
                      entry="loop_rlc")
    elif L:
        extend.KERNEL(index.occ_fused.data_ptr(), index.blocks,
                      *index.counts_host, *index.dollar_host, *args,
                      entry="loop")
    return out, drows


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
        tabs = ((dyn["ex_pos"], dyn["ex_dir"], dyn["db_ex_steps"])
                if dyn is not None else
                (tables["ex_pos"], tables["ex_dir"], tables["db_ex"]))
        loop = dict(reads=reads, tabs=tabs, per_lane=dyn is not None,
                    gate_t=gate_t, switchpoint=switchpoint)
        if 0 < ex_split < E and 0 < ex_cap < L:
            ranges0, drows0 = exact_loop(index, ranges0, None, 0, ex_split,
                                         **loop)
            EC = int(ex_cap)
            lane = torch.arange(L, **i64)
            (src,), n1 = _compact(ranges0[:, 1] > ranges0[:, 0], EC,
                                  [lane], [L])
            overflow_ex = torch.clamp(n1 - EC, min=0)
            live1 = src < L
            srcc = torch.where(live1, src, 0)
            r2 = torch.where(live1[:, None], ranges0[srcc], 0)
            r2, dr2 = exact_loop(index, r2, srcc.int(), ex_split, E, **loop)
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
            ranges0, drows0 = exact_loop(index, ranges0, None, 0, E, **loop)
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
    state, n_alive0 = _compact(
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

        # the frontier ping-pongs between two buffer sets of C rows; the
        # host learns each step's live count (kept children, capped) and
        # in-text count from one word, and stops when no lane is live
        sc = StepScratch(C, dev)
        sc.ctr[0] = torch.clamp(n_alive0, max=C) | (itv_cnt << 32)
        sc.ctr[2] = overflow
        live, cnt = sc.word()
        bufs = [list(state), [torch.empty_like(f) for f in state]]
        cap, cur, moved, shrink_ovf = C, 0, False, 0

        def run_steps(t_lo, t_hi):
            nonlocal live, cnt, cur, moved
            nxt = [[f[:cap] for f in b] for b in bufs]   # next frontiers
            for t in range(t_lo, t_hi):
                if live == 0:
                    break
                band_step_compact(
                    index, bufs[cur], live, nxt[1 - cur], itv_buf, cnt, sc,
                    mrow[t] if dyn_meta is None else None, pchars, T, t,
                    switchpoint, dyn_meta, track_arg)
                cur, moved = 1 - cur, True
                n, cnt = sc.word()
                live = min(n, cap)

        if 0 < split_step < T and 0 < capacity2 < C:
            run_steps(0, split_step)
            # the live lanes lead the frontier: the shrink keeps its first
            # capacity2 rows
            cap, moved = int(capacity2), True
            shrink_ovf = max(live - cap, 0)
            live = min(live, cap)
            run_steps(split_step, T)
        else:
            run_steps(0, T)
        state = [f[:cap] for f in bufs[cur]]
        if moved:
            for f in state:
                f[live:] = 0
        overflow = sc.ctr[2] + shrink_ovf
        visits = sc.ctr[1]
        itv_cnt = sc.ctr[0] >> 32
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
