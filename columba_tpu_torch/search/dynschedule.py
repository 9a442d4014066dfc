"""Per-read schedules for dynamic partitioning, and kernels F and G.

The counterpart of ``columba_tpu/search/dynschedule.py``. The static
schedule compiler (``search/schedule.py``) bakes one partition into
per-(search, step) tables; dynamic partitioning (the reference's default,
src/searchstrategy.cpp:240-420) gives every read its own part boundaries
``pts (R, p+1)``, so the same tables are computed on the device per (read,
search):

* :func:`dynamic_partition` seeds each part (k-mer table when there is one,
  else single characters) and then extends, m - p*K times, the part with
  the largest weighted exact-match range by one character. Kernel F
  (``csrc/dynpart.cu``) on the card: one thread a read with its parts in
  registers; on the RLC index's 8-wide lanes (entry ``dynpart.rlc``) four
  lanes a read with its parts in shared memory, walking on the run
  tables.
* :func:`clamp_partition` enforces part length >= 2*kb+1 (the overshoot
  construction of the schedule needs it).
* :func:`build_tables` computes the per-phase arithmetic of the static
  compiler (pivot, side targets, overshoots, colMin windows, band-cell
  pattern positions) per (read, search). Total band steps per search are
  bounded by m + 2*kb, so the lockstep loop keeps one static length and
  shorter schedules idle at the start (end-aligned through the active bit).
  Kernel G (``csrc/dyn_tables.cu``) on the card: one warp per (read,
  search), several a warp for the prologue (the clamp folded in), the
  tables written as coalesced words.

The executor reads the packed per-step word and the pattern-char windows at
``ids * T + t`` (kernel B's per-lane entry).

Each function takes its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from columba_tpu_torch import native
from columba_tpu_torch.index import kmer as kmer_mod
from columba_tpu_torch.index.bmove import BMoveIndex
from columba_tpu_torch.index.fmindex import FMIndex
from columba_tpu_torch.ops import bextend, rank
from columba_tpu_torch.ops import extend as ext
from columba_tpu_torch.search.schedule import INF
from columba_tpu_torch.search.scheme import BACKWARD, FORWARD, SearchScheme

MAX_PARTS = 16          # kernels F and G keep per-part state in fixed arrays
WIDTH_CAP = 1 << 30     # widths above it carry no information for partitioning

_PART_TAIL = [ctypes.c_void_p, ctypes.c_int32,          # kmer table, K
              ctypes.c_void_p, ctypes.c_void_p,          # host seeds, weights
              ctypes.c_int32,                            # p
              ctypes.c_void_p, ctypes.c_void_p,          # pts, final ranges
              ctypes.c_int64]                            # rows
PARTITION_KERNEL = native.Kernel(
    "dynpart", "columba_dynpart",
    [ctypes.c_void_p, ctypes.c_int64,                    # occ_fused, blocks
     ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
     ctypes.c_uint32, ctypes.c_uint32,                   # counts, dollar
     ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,    # reads, m, n
     *_PART_TAIL],
    source="columba_tpu_torch/csrc/dynpart.cu",
    replaces="columba_tpu/search/dynschedule.py:283",
    symbols={"rlc": ("columba_dynpart_rlc", [
        *bextend.BM_ARGTYPES, *bextend.BT_ARGTYPES,
        ctypes.c_void_p, ctypes.c_int32,                        # reads, m
        *_PART_TAIL])},
)

TABLES_KERNEL = native.Kernel(
    "dyn_tables", "columba_dyn_tables",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # pts, reads, phases
     ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,     # R, S, p
     ctypes.c_int32, ctypes.c_int32,                     # m, kb
     ctypes.c_void_p, ctypes.c_void_p,                   # meta, pchars
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ex_pos/dir/db_steps
     ctypes.c_void_p, ctypes.c_void_p,                   # band_init, colmin
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p], # t_back/pivot/db_ex
    source="columba_tpu_torch/csrc/dyn_tables.cu",
    replaces="columba_tpu/search/dynschedule.py:111",
)


@dataclass(frozen=True, eq=False)
class SchemeStatic:
    """Static per-search structure (partition-independent)."""

    k: int
    kb: int
    m: int
    p: int
    num_searches: int
    t_max: int               # static bound on band steps (m + 2*kb)
    e_max: int               # static bound on exact steps
    # (S, p) arrays
    side: np.ndarray         # phase side 0/1
    upper: np.ndarray        # phase U
    lo: np.ndarray           # lowest part after phase
    hi: np.ndarray           # highest part after phase
    is_exact: np.ndarray     # leading U==0 phases
    # (S,)
    pi0: np.ndarray
    pivot_left: np.ndarray   # pivot at left edge of start part?
    u_last: np.ndarray
    n_exact: np.ndarray


def scheme_static(scheme: SearchScheme, m: int,
                  metric: str = "edit") -> SchemeStatic:
    k = scheme.k
    kb = k if metric == "edit" else 0
    p = scheme.num_parts
    S = len(scheme.searches)
    side = np.zeros((S, p), np.int32)
    upper = np.zeros((S, p), np.int32)
    lo = np.zeros((S, p), np.int32)
    hi = np.zeros((S, p), np.int32)
    is_exact = np.zeros((S, p), bool)
    pi0 = np.zeros(S, np.int32)
    pivot_left = np.zeros(S, bool)
    u_last = np.zeros(S, np.int32)
    n_exact = np.zeros(S, np.int32)
    for i, s in enumerate(scheme.searches):
        side[i] = [0 if d == BACKWARD else 1 for d in s.directions]
        upper[i] = s.upper
        lo[i] = [e[0] for e in s.part_extent]
        hi[i] = [e[1] for e in s.part_extent]
        ne = s.num_exact_prefix_phases
        is_exact[i, :ne] = True
        n_exact[i] = ne
        pi0[i] = s.pi[0]
        pivot_left[i] = s.directions[0] == FORWARD
        u_last[i] = s.upper[-1]
    return SchemeStatic(
        k=k, kb=kb, m=m, p=p, num_searches=S,
        t_max=m + 2 * kb, e_max=m,
        side=side, upper=upper, lo=lo, hi=hi, is_exact=is_exact,
        pi0=pi0, pivot_left=pivot_left, u_last=u_last, n_exact=n_exact,
    )


def phase_table(st: SchemeStatic) -> np.ndarray:
    """The scheme's static structure as kernel G reads it: one int32 row per
    search, ``[pi0, pivot_left, then per phase side, upper, lo, hi,
    is_exact]``."""
    per_phase = np.stack([st.side, st.upper, st.lo, st.hi,
                          st.is_exact.astype(np.int32)], axis=2)
    return np.ascontiguousarray(np.concatenate(
        [st.pi0[:, None], st.pivot_left[:, None].astype(np.int32),
         per_phase.reshape(st.num_searches, 5 * st.p)], axis=1),
        dtype=np.int32)


_STATIC_DEV: dict = {}


def _static_on(st: SchemeStatic, device) -> dict:
    """``st``'s arrays on ``device`` (cached per (st, device); the entry
    keeps ``st`` alive so its id cannot be reused)."""
    key = (id(st), str(device))
    ent = _STATIC_DEV.get(key)
    if ent is None or ent[0] is not st:
        dev = {f: torch.from_numpy(np.ascontiguousarray(getattr(st, f)))
               .to(device) for f in ("side", "upper", "lo", "hi", "is_exact",
                                     "pi0", "pivot_left", "u_last")}
        dev["phases"] = torch.from_numpy(phase_table(st)).to(device)
        ent = (st, dev)
        _STATIC_DEV[key] = ent
    return ent[1]


def clamp_partition(pts: torch.Tensor, m: int, kb: int) -> torch.Tensor:
    """Enforce part length >= 2*kb+1 by sweeping boundaries (R, p+1):
    forward from the left edge, then backward from the right edge."""
    if kb == 0:
        return pts
    minlen = 2 * kb + 1
    p = pts.shape[1] - 1
    out = pts.clone()
    out[:, 0] = 0
    for i in range(1, p):
        out[:, i] = torch.maximum(pts[:, i], out[:, i - 1] + minlen)
    out[:, p] = m
    for i in range(p - 1, 0, -1):
        out[:, i] = torch.minimum(out[:, i], out[:, i + 1] - minlen)
    return out


# ---------------------------------------------------------------------------
# K16: per-(read, search) tables
# ---------------------------------------------------------------------------

def build_tables_plain(st: SchemeStatic, pts: torch.Tensor,
                       reads: torch.Tensor) -> dict:
    """Plain version of kernel G; see :func:`build_tables`."""
    pts = clamp_partition(pts, st.m, st.kb)
    R = pts.shape[0]
    S, p, kb, m, T = st.num_searches, st.p, st.kb, st.m, st.t_max
    bw = 2 * kb + 1
    dev = pts.device
    sd = _static_on(st, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    pts = pts.to(torch.int32)
    side = sd["side"]                                    # (S, p)
    upper = sd["upper"]
    is_ex = sd["is_exact"]
    pi0 = sd["pi0"].long()

    pivot = torch.where(sd["pivot_left"][None, :], pts[:, pi0],
                        pts[:, pi0 + 1])                 # (R, S)
    pts_lo = pts[:, sd["lo"].long()]                     # (R, S, p)
    pts_hi1 = pts[:, sd["hi"].long() + 1]
    bt = pivot[:, :, None] - pts_lo                      # back targets
    ft = pts_hi1 - pivot[:, :, None]                     # fwd targets
    is_b = (side == 0)[None]                             # (1, S, p)
    tgt = torch.where(is_b, bt, ft)                      # (R, S, p)

    # depth of each side after each phase
    db = torch.zeros((R, S), **i32)
    df = torch.zeros((R, S), **i32)
    prev_depth, steps, db_before = [], [], []
    for i in range(p):
        db_before.append(db)
        new_depth = torch.where(is_ex[None, :, i], tgt[:, :, i],
                                tgt[:, :, i] + kb)
        cur = torch.where(is_b[:, :, i], db, df)
        prev_depth.append(cur)
        steps.append((new_depth - cur).clamp(min=0))
        db = torch.where(is_b[:, :, i], torch.maximum(db, new_depth), db)
        df = torch.where(~is_b[:, :, i], torch.maximum(df, new_depth), df)
    t_back = db
    prev_depth = torch.stack(prev_depth, dim=2)          # (R, S, p)
    steps = torch.stack(steps, dim=2)
    db_before = torch.stack(db_before, dim=2)

    ex_steps = torch.where(is_ex[None], steps, 0)
    band_steps = torch.where(is_ex[None], 0, steps)
    e_len = ex_steps.sum(dim=2, dtype=torch.int32)       # (R, S)
    t_len = band_steps.sum(dim=2, dtype=torch.int32)
    ex_cum = ex_steps.cumsum(dim=2, dtype=torch.int32)   # end offsets
    band_cum = band_steps.cumsum(dim=2, dtype=torch.int32)
    zero = torch.zeros((R, S, 1), **i32)

    # ---------------- band meta / pchars over the T axis ----------------
    g = torch.arange(T, **i32)
    t_loc = g[None, None, :] - (T - t_len[:, :, None])   # (R, S, T)
    active = t_loc >= 0
    tb = t_loc.clamp(min=0)
    # phase of each band step: first i with band_cum_i > t_loc
    phase = (band_cum[:, :, :, None] <= tb[:, :, None, :]).sum(dim=2)
    phase = phase.clamp(0, p - 1)                        # (R, S, T) int64

    def sel_phase(arr):                                  # (R,S,p) -> (R,S,T)
        return torch.gather(arr.expand(R, S, p), 2, phase)

    side_t = sel_phase(side[None])
    ub_t = sel_phase(upper[None])
    tgt_t = sel_phase(tgt)
    prev_t = sel_phase(prev_depth)
    cum_prev_t = sel_phase(torch.cat([zero, band_cum[:, :, :-1]], dim=2))

    t_new = prev_t + (tb - cum_prev_t) + 1               # (R, S, T)
    in_window = t_new >= (tgt_t - kb)
    o_acc = tgt_t - t_new + kb
    creset = active & in_window & (
        t_new == torch.maximum(prev_t + 1, tgt_t - kb))
    colo = torch.where(active & in_window & (o_acc >= 0) & (o_acc < bw),
                       o_acc, -1)
    db_t = torch.where(side_t == 0, t_new, sel_phase(db_before))
    meta = (active.int() | (side_t << 1) | (creset.int() << 2)
            | ((colo + 1) << 3) | (ub_t << 9)
            | (db_t.clamp(0, 4095) << 17))               # (R, S, T)

    # pchars codes per band cell
    o = torch.arange(bw, **i32)
    j = t_new[..., None] - kb + o                        # (R, S, T, BW)
    sl = torch.where(side_t == 0, pivot[:, :, None], m - pivot[:, :, None])
    cvalid = (j >= 0) & (j <= sl[..., None])
    mvalid = (j >= 1) & (j <= sl[..., None])
    pos = torch.where(side_t[..., None] == 0,
                      pivot[:, :, None, None] - j,
                      pivot[:, :, None, None] + j - 1)
    rows = torch.arange(R, device=dev)[:, None, None, None]
    chars = reads[rows, pos.clamp(0, m - 1).long()].to(torch.int8)
    pchars = torch.where(~cvalid, -2, torch.where(~mvalid, -1, chars))

    # ---------------- exact prefix tables ----------------
    E = int(st.e_max)
    e = torch.arange(E, **i32)
    e_act = e[None, None, :] < e_len[:, :, None]         # (R, S, E)
    ephase = (ex_cum[:, :, :, None] <= e[None, None, None, :]).sum(dim=2)
    ephase = ephase.clamp(0, p - 1)

    def sel_eph(arr):
        return torch.gather(arr.expand(R, S, p), 2, ephase)

    eside = sel_eph(side[None])
    eprev = sel_eph(prev_depth)
    ecum_prev = sel_eph(torch.cat([zero, ex_cum[:, :, :-1]], dim=2))
    ej = eprev + (e[None, None, :] - ecum_prev) + 1      # chars consumed
    ex_pos = torch.where(eside == 0, pivot[:, :, None] - ej,
                         pivot[:, :, None] + ej - 1)
    ex_pos = torch.where(e_act, ex_pos, -1)

    # ---------------- band init ----------------
    exact_extent = torch.stack(
        [torch.where(is_b & is_ex[None], tgt, 0).amax(dim=2),
         torch.where((~is_b) & is_ex[None], tgt, 0).amax(dim=2)], dim=-1)
    side_len = torch.stack([pivot, m - pivot], dim=-1)   # (R, S, 2)
    t0 = exact_extent[..., None]                         # (R, S, 2, 1)
    jj = t0 - kb + o                                     # (R, S, 2, BW)
    binit = torch.where((jj >= 0) & (jj <= side_len[..., None]),
                        (jj - t0).abs(), INF).to(torch.int8)

    return dict(
        meta=meta.reshape(R * S, T),
        pchars=pchars.to(torch.int8).reshape(R * S * T, bw),
        ex_pos=ex_pos.reshape(R * S, E),
        ex_dir=eside.reshape(R * S, E),
        db_ex_steps=(e_act & (eside == 0)).cumsum(
            dim=2, dtype=torch.int32).reshape(R * S, E),
        band_init=binit.reshape(R * S, 2, bw),
        colmin_init=torch.zeros((R * S, 2), dtype=torch.int8, device=dev),
        t_back=t_back.reshape(R * S),
        pivot=pivot.reshape(R * S),
        u_last=sd["u_last"],
        db_exact=exact_extent[..., 0].reshape(R * S),
    )


def build_tables(st: SchemeStatic, pts: torch.Tensor,
                 reads: torch.Tensor) -> dict:
    """Per-(read, search) schedule tables from boundaries pts (R, p+1) int32
    and reads (R, m) uint8. The boundaries go through
    :func:`clamp_partition` first (it leaves boundaries alone whose parts are
    all long enough), so the tables are those of the clamped partition.

    Returns tensors on the reads' device:
      meta   (R*S, T) int32 packed per-step scalars (active | side<<1 |
             creset<<2 | (colo+1)<<3 | ub<<9 | db<<17)
      pchars (R*S*T, BW) int8 band-cell codes (validity folded in: -1 no
             diag transition, -2 cell outside the pattern)
      ex_pos, ex_dir, db_ex_steps (R*S, E) int32 exact-prefix read
             positions (-1 idle), directions and back depths
      band_init (R*S, 2, BW) int8; colmin_init (R*S, 2) int8
      t_back, pivot, db_exact (R*S,) int32; u_last (S,) int32

    The plain version for CPU tensors, kernel G for CUDA tensors."""
    if not pts.is_cuda:
        return build_tables_plain(st, pts, reads)
    R = pts.shape[0]
    S, p, kb, m, T, E = (st.num_searches, st.p, st.kb, st.m, st.t_max,
                         st.e_max)
    bw = 2 * kb + 1
    dev = pts.device
    if p > MAX_PARTS:
        raise ValueError(f"kernel G takes at most {MAX_PARTS} parts, not {p}")
    for tns, dt, shape in ((pts, torch.int32, (R, p + 1)),
                           (reads, torch.uint8, (R, m))):
        if (tns.dtype != dt or tuple(tns.shape) != shape
                or not tns.is_contiguous() or tns.device != dev):
            raise ValueError(f"kernel G input {tuple(tns.shape)} {tns.dtype} "
                             f"is not a contiguous {shape} {dt} on one device")
    sd = _static_on(st, dev)
    L = R * S
    i32 = dict(dtype=torch.int32, device=dev)
    i8 = dict(dtype=torch.int8, device=dev)
    out = dict(
        meta=torch.empty((L, T), **i32),
        pchars=torch.empty((L * T, bw), **i8),
        ex_pos=torch.empty((L, E), **i32),
        ex_dir=torch.empty((L, E), **i32),
        db_ex_steps=torch.empty((L, E), **i32),
        band_init=torch.empty((L, 2, bw), **i8),
        colmin_init=torch.empty((L, 2), **i8),
        t_back=torch.empty(L, **i32),
        pivot=torch.empty(L, **i32),
        u_last=sd["u_last"],
        db_exact=torch.empty(L, **i32),
    )
    if L:
        TABLES_KERNEL(pts.data_ptr(), reads.data_ptr(),
                      sd["phases"].data_ptr(), R, S, p, m, kb,
                      out["meta"].data_ptr(), out["pchars"].data_ptr(),
                      out["ex_pos"].data_ptr(), out["ex_dir"].data_ptr(),
                      out["db_ex_steps"].data_ptr(),
                      out["band_init"].data_ptr(),
                      out["colmin_init"].data_ptr(), out["t_back"].data_ptr(),
                      out["pivot"].data_ptr(), out["db_exact"].data_ptr(),
                      shape=f"kb{kb} parts{p}")
    return out


# ---------------------------------------------------------------------------
# K15: greedy dynamic partitioning
# ---------------------------------------------------------------------------

def partition_setup(scheme: SearchScheme, m: int, kmer_table):
    """Host side of the partitioning: the seed length K (the table's, or 1
    without a table or when p seeds of that length would cover 2/3 of the
    read), the table to use, the seeds' start positions (reference seed():
    first at 0, middles at frac*m - K/2, last at m - K) and the weights."""
    p = scheme.num_parts
    K = kmer_mod.table_k(kmer_table) if kmer_table is not None else 1
    if p * K >= (2 * m) // 3:
        K, kmer_table = 1, None
    if scheme.seed_fracs and len(scheme.seed_fracs) == p - 2:
        mids = [int(f * m) - K // 2 for f in scheme.seed_fracs]
    else:
        mids = [(i * m) // p for i in range(1, p - 1)]
    seeds = [0] + mids + [m - K]
    weights = (list(scheme.weights)
               if scheme.weights and len(scheme.weights) == p else [1] * p)
    return K, kmer_table, seeds, weights


def weighted_widths(widths: torch.Tensor, weights: torch.Tensor,
                    extendable: torch.Tensor) -> torch.Tensor:
    """width x weight as the 32-bit product the JAX package takes (it wraps:
    a width above 2^31 / weight turns negative), -1 where a part cannot
    grow. int64 in, int64 out holding int32 values."""
    prod = (widths * weights) & rank.MASK32
    prod = torch.where(prod >= (1 << 31), prod - (1 << 32), prod)
    return torch.where(extendable, prod, -1)


def _extend_char(index, ranges, chars, dirs, stats, tables):
    """extend_char_plain; on the RLC index on the run tables, as kernel F
    walks (``tables``), and it also counts into ``stats`` the extensions
    that read rows and their walks."""
    if not isinstance(index, BMoveIndex):
        return ext.extend_char_plain(index, ranges, chars, dirs)
    if stats is not None:
        stats["steps"] = stats.get("steps", 0) + int((chars <= 3).sum())
    return bextend.extend_char_plain(index, ranges, chars, dirs, stats,
                                     tables)


def dynamic_partition_plain(index: FMIndex, reads: torch.Tensor,
                            scheme: SearchScheme,
                            kmer_table: torch.Tensor | None = None,
                            ranges_out: torch.Tensor | None = None,
                            stats: dict | None = None,
                            tables: bool = True) -> torch.Tensor:
    """Plain version of kernel F; see :func:`dynamic_partition`. ``stats``
    (optional, RLC index): the extensions that read rows (``steps``) and
    their walks, for ``tools/bounds.py``; ``tables=False`` counts the
    walks on the fused rows instead of the run tables (the same
    boundaries)."""
    R, m = reads.shape
    p = scheme.num_parts
    dev = reads.device
    K, kmer_table, seeds, weights = partition_setup(scheme, m, kmer_table)
    i64 = dict(dtype=torch.int64, device=dev)
    begins = torch.tensor(seeds, **i64).expand(R, p).clone()
    ends = begins + K
    weights = torch.tensor(weights, **i64)
    rows = torch.arange(R, device=dev)
    cols = torch.arange(p, device=dev)

    if kmer_table is not None:
        offs = torch.arange(K, device=dev)
        wchars = reads[rows[:, None, None],
                       (begins[:, :, None] + offs).clamp(0, m - 1)]
        ranges = kmer_mod.lookup_plain(kmer_table, wchars)   # (R, p, 4)
    else:
        # single-char seed ranges: one backward extension of the full range
        # (on the RLC index with its run hints), the (R, p) lanes flattened
        c0 = reads[rows[:, None], begins].int().reshape(-1)
        ranges = _extend_char(
            index, index.full_range((R * p,)), c0,
            torch.zeros(R * p, dtype=torch.int32, device=dev),
            stats, tables).reshape(R, p, -1)

    big = torch.full((R, 1), WIDTH_CAP, **i64)
    for _ in range(m - p * K):
        widths = ((ranges[..., 1] - ranges[..., 0]) & rank.MASK32).clamp(
            max=WIDTH_CAP)                                   # (R, p)
        prev_end = torch.cat([torch.zeros((R, 1), **i64), ends[:, :-1]], 1)
        next_beg = torch.cat([begins[:, 1:], torch.full((R, 1), m, **i64)], 1)
        can_left = begins > prev_end
        can_right = ends < next_beg
        extendable = can_left | can_right
        weighted = weighted_widths(widths, weights[None], extendable)
        # the first maximum, as jnp.argmax takes it
        top = weighted.max(dim=1, keepdim=True).values
        part = torch.where(weighted == top, cols[None], p).min(dim=1).values
        onehot = cols[None] == part[:, None]                 # (R, p)

        def sel(a):
            return a.gather(1, part[:, None])[:, 0]

        cl, cr = sel(can_left), sel(can_right)
        # neighbour widths for the tie direction
        wl = sel(torch.cat([big, widths[:, :-1]], 1))
        wr = sel(torch.cat([widths[:, 1:], big], 1))
        go_back = cl & (~cr | (wl < wr))
        newpos = torch.where(go_back, sel(begins) - 1, sel(ends))
        chars = reads[rows, newpos.clamp(0, m - 1)].int()
        any_ext = sel(extendable)
        # a read whose parts cannot grow extends nothing (and reads no row)
        cur = torch.where(any_ext[:, None], ranges[rows, part], 0)
        new_rng = _extend_char(index, cur, torch.where(any_ext, chars, 4),
                               (~go_back).int(), stats, tables)
        begins = torch.where(onehot & (go_back & any_ext)[:, None],
                             begins - 1, begins)
        ends = torch.where(onehot & (~go_back & any_ext)[:, None],
                           ends + 1, ends)
        ranges = torch.where((onehot & any_ext[:, None])[:, :, None],
                             new_rng[:, None, :], ranges)

    # close any remaining gaps (reference extendParts): boundary = next begin
    pts = torch.cat([torch.zeros((R, 1), **i64), begins[:, 1:],
                     torch.full((R, 1), m, **i64)], dim=1)
    if ranges_out is not None:
        ranges_out.copy_(ranges)
    return pts.to(torch.int32)


def dynamic_partition(index: FMIndex, reads: torch.Tensor,
                      scheme: SearchScheme,
                      kmer_table: torch.Tensor | None = None,
                      ranges_out: torch.Tensor | None = None) -> torch.Tensor:
    """Batched greedy dynamic partitioning (reference default,
    src/searchstrategy.cpp:240-420 ``partitionDynamic``/``seed``).

    Seeds each part at the scheme's seeding positions, then repeatedly
    extends the part with the largest weighted exact-match range by one
    character, toward its smaller neighbour when both directions are open.
    reads: (R, m) uint8 on the index's device. Returns boundaries pts
    (R, p+1) int32 (clamp before scheduling). ``ranges_out`` (optional,
    (R, p, rw) int64): receives each part's final range, run hints
    included on the RLC index.

    The plain version for CPU tensors, kernel F for CUDA tensors (its RLC
    entry on the RLC index)."""
    if not reads.is_cuda:
        return dynamic_partition_plain(index, reads, scheme, kmer_table,
                                       ranges_out)
    R, m = reads.shape
    p = scheme.num_parts
    dev = reads.device
    rlc = isinstance(index, BMoveIndex)
    rw = index.range_width
    if p > MAX_PARTS:
        raise ValueError(f"kernel F takes at most {MAX_PARTS} parts, not {p}")
    if rlc and index.textless:
        raise ValueError("kernel F's RLC entry takes 8-wide lanes; the "
                         "textless index runs uniform partitions")
    K, kmer_table, seeds, weights = partition_setup(scheme, m, kmer_table)
    table_dev = (index.fused if rlc else index.occ_fused).device
    if (reads.dtype != torch.uint8 or not reads.is_contiguous()
            or table_dev != dev):
        raise ValueError("dynamic_partition takes a contiguous (R, m) uint8 "
                         "batch on the index's device")
    if kmer_table is not None and (
            kmer_table.dtype != torch.int64 or kmer_table.device != dev
            or not kmer_table.is_contiguous()
            or tuple(kmer_table.shape) != (4 ** K, rw)):
        raise ValueError(f"kernel F takes a contiguous (4^K, {rw}) int64 "
                         "seed table on the reads' device")
    if ranges_out is not None and (
            ranges_out.dtype != torch.int64 or ranges_out.device != dev
            or not ranges_out.is_contiguous()
            or tuple(ranges_out.shape) != (R, p, rw)):
        raise ValueError(f"ranges_out must be a contiguous ({R}, {p}, {rw}) "
                         "int64 tensor on the reads' device")
    pts = torch.empty((R, p + 1), dtype=torch.int32, device=dev)
    if R:
        # seeds and weights are host arrays: they travel in the kernel's
        # argument block, so the launch copies nothing to the device
        tail = (kmer_table.data_ptr() if kmer_table is not None else None, K,
                (ctypes.c_int32 * p)(*seeds), (ctypes.c_int32 * p)(*weights),
                p, pts.data_ptr(),
                ranges_out.data_ptr() if ranges_out is not None else None, R)
        if rlc:
            PARTITION_KERNEL(*bextend.bm_args(index),
                             *bextend.bt_args(index), reads.data_ptr(), m,
                             *tail, entry="rlc", shape=f"parts{p}")
        else:
            PARTITION_KERNEL(
                index.occ_fused.data_ptr(), index.blocks, *index.counts_host,
                *index.dollar_host, reads.data_ptr(), m, index.n, *tail,
                shape=f"parts{p}")
    return pts
