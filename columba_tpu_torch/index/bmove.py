"""Run-length-compressed bidirectional move-structure index (b-move, RLC).

The counterpart of ``columba_tpu/index/bmove.py``. The BWT is kept as its
maximal equal-character runs: one fused 80 B row per run interval (start,
end, LF destination position and run, char, SA samples at the run's head
and tail, next and previous run of each character, per-character counts
before the run), so an endpoint query is one row read. LF is a table step
plus a short fast-forward of the run hint.

The host part (building, saving and loading the arrays) is a copy of the
JAX package's, on the port's own suffix array and FASTA preprocessing, and
writes the same arrays. The device part, :class:`BMoveIndex`, holds them as
tensors on a device the caller names.

Textless flavor (``--textless``): no packed text and no strided SA samples,
so the index scales with the run count r, not the text length n. Lanes then
carry toehold samples (range width 12) and locate runs on the host with the
phi tables (``search/pipeline.py``).

Lane state: a range widens from 4 to 8 values,
``[f_lo, f_hi, r_lo, r_hi, f_run_lo, f_run_hi1, r_run_lo, r_run_hi1]``,
where ``*_run_lo`` is the run interval holding ``*_lo`` and ``*_run_hi1``
the one holding ``*_hi - 1`` (each in its own direction's table); textless
lanes append ``[toe_value, toe_offset, toe_flag, 0]``.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from columba_tpu_torch.index.build import (
    INDEX_FORMAT_VERSION, MAX_N, pack_2bit, preprocess_fasta,
)
from columba_tpu_torch.index.suffix import suffix_array

# fused row column indices
START, END, LF_POS, LF_RUN, CHAR, SA_FIRST, SA_LAST = 0, 1, 2, 3, 4, 5, 6
NEXT0, PREV0, CUM0 = 8, 12, 16
NCOLS = 20

# stride of the in-run SA sampling (a power of two): every LOCATE_STRIDE-th
# BWT row holds a sample, so a locate walk takes at most that many LF steps
# however long the runs are
LOCATE_STRIDE = 64


def _phi_tables(sa_full: np.ndarray, bounds: np.ndarray):
    """Piecewise phi / phi-inverse over run-boundary samples: for each
    run-first row b, the piece starting at x = SA[b] translates by
    SA[b-1] - x (phi) and the piece at SA[b-1] by SA[b] - SA[b-1] (phi
    inverse). Returns (phi_x sorted, phi_y, phinv_x sorted, phinv_y),
    uint32."""
    x = sa_full[bounds]
    y = sa_full[bounds - 1]
    o = np.argsort(x)
    xi = sa_full[bounds - 1]
    yi = sa_full[bounds]
    oi = np.argsort(xi)
    return (x[o].astype(np.uint32), y[o].astype(np.uint32),
            xi[oi].astype(np.uint32), yi[oi].astype(np.uint32))


def _runs_of_direction(codes: np.ndarray, sa_method: str,
                       want_stride: bool = False,
                       want_phi: bool = False):
    """Move-table arrays for one direction. codes: clean 0..3 text."""
    n = len(codes)
    big = n + 1
    sa = suffix_array(codes, method=sa_method)
    sa_full = np.empty(big, dtype=np.int64)
    sa_full[0] = n
    sa_full[1:] = sa
    prev = sa_full - 1
    bwt5 = np.where(prev < 0, 4, codes[np.clip(prev, 0, n - 1)]).astype(np.uint8)

    # maximal runs
    bounds = np.flatnonzero(np.diff(bwt5.astype(np.int16))) + 1
    starts = np.concatenate([[0], bounds]).astype(np.int64)
    ends = np.concatenate([bounds, [big]]).astype(np.int64)
    R = len(starts)
    rchar = bwt5[starts].astype(np.int64)

    # per-char cumulative counts at run starts (occ_c(start), '$' excluded)
    cum = np.zeros((R, 4), dtype=np.int64)
    for c in range(4):
        lens_c = np.where(rchar == c, ends - starts, 0)
        cum[:, c] = np.concatenate([[0], np.cumsum(lens_c)[:-1]])

    # first F-column row per char, '$ACGT' order: '$'->0
    char_counts = np.bincount(codes, minlength=4).astype(np.int64)
    first = np.zeros(5, dtype=np.int64)
    first[4] = 0  # '$'
    first[0] = 1
    first[1:4] = 1 + np.cumsum(char_counts)[:3]

    lf_pos = first[rchar] + np.where(rchar < 4, cum[np.arange(R),
                                                    np.clip(rchar, 0, 3)], 0)
    lf_run = np.searchsorted(starts, lf_pos, side="right") - 1

    # next/prev run of char c
    nxt = np.full((R, 4), R, dtype=np.int64)
    prv = np.full((R, 4), -1, dtype=np.int64)
    for c in range(4):
        idx = np.flatnonzero(rchar == c)
        if len(idx):
            k = np.searchsorted(idx, np.arange(R), side="left")
            nxt[:, c] = np.where(k < len(idx), idx[np.clip(k, 0, len(idx) - 1)], R)
            k2 = np.searchsorted(idx, np.arange(R), side="right") - 1
            prv[:, c] = np.where(k2 >= 0, idx[np.clip(k2, 0, None)], -1)

    # positions/counts/SA values are uint32 (build.MAX_N ceiling); run
    # indices share the table (PREV = -1 is stored as 0xFFFFFFFF)
    fused = np.zeros((R + 1, NCOLS), dtype=np.uint32)
    fused[:R, START] = starts
    fused[:R, END] = ends
    fused[:R, LF_POS] = lf_pos
    fused[:R, LF_RUN] = lf_run
    fused[:R, CHAR] = rchar
    fused[:R, SA_FIRST] = sa_full[starts]
    fused[:R, SA_LAST] = sa_full[ends - 1]
    fused[:R, NEXT0:NEXT0 + 4] = nxt.astype(np.uint32)
    fused[:R, PREV0:PREV0 + 4] = prv.astype(np.uint32)
    fused[:R, CUM0:CUM0 + 4] = cum
    # sentinel row R: empty interval at big (fast-forward terminator)
    fused[R, START] = big
    fused[R, END] = big
    fused[R, CHAR] = 4
    fused[R, NEXT0:NEXT0 + 4] = R
    fused[R, PREV0:PREV0 + 4] = R - 1
    fused[R, CUM0:CUM0 + 4] = cum[R - 1] + np.where(
        rchar[R - 1] == np.arange(4), ends[R - 1] - starts[R - 1], 0)
    sa_stride = (sa_full[::LOCATE_STRIDE].astype(np.uint32)
                 if want_stride else None)
    phi = _phi_tables(sa_full, bounds) if want_phi else None
    return fused, first.astype(np.uint32), R, sa_stride, phi


@dataclass(frozen=True)
class BMoveArrays:
    """Host-side persisted arrays of one RLC index. Textless
    (``meta["textless"]``): ``text`` and ``sa_stride`` are empty and the
    phi tables are kept."""

    meta: dict
    fused_fwd: np.ndarray   # (R_f + 1, NCOLS) uint32
    fused_rev: np.ndarray   # (R_r + 1, NCOLS) uint32
    first_row: np.ndarray   # (5,) uint32: first F row per '$ACGT' char
    text: np.ndarray        # packed uint32 (2-bit); EMPTY when textless
    sa_stride: np.ndarray   # uint32 strided SA; EMPTY when textless
    seq_starts: np.ndarray
    seq_names: list
    # phi / phi-inverse piece tables (textless locate); empty otherwise
    phi_fwd: np.ndarray = None     # (P_f, 4): x_sorted, y, xinv, yinv
    phi_rev: np.ndarray = None

    @property
    def n(self) -> int:
        return self.meta["n"]

    @property
    def textless(self) -> bool:
        return bool(self.meta.get("textless", False))


def build_bmove_from_codes(
    codes: np.ndarray,
    seq_names=None,
    seq_starts=None,
    sa_method: str = "auto",
    textless: bool = False,
) -> BMoveArrays:
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if codes.max(initial=0) > 3:
        raise ValueError("text contains non-ACGT codes; preprocess first")
    n = len(codes)
    if n > MAX_N:
        raise ValueError(
            f"text length {n} exceeds the uint32 index ceiling {MAX_N}")
    fused_fwd, first, r_f, sa_stride, phi_f = _runs_of_direction(
        codes, sa_method, want_stride=not textless, want_phi=textless)
    fused_rev, _, r_r, _, phi_r = _runs_of_direction(
        codes[::-1].copy(), sa_method, want_phi=textless)
    if seq_names is None:
        seq_names = ["seq0"]
        seq_starts = np.array([0, n], dtype=np.int64)
    meta = dict(
        format_version=INDEX_FORMAT_VERSION, flavor="rlc", n=n,
        runs_fwd=r_f, runs_rev=r_r, num_seqs=len(seq_names),
        locate_stride=LOCATE_STRIDE, textless=bool(textless),
    )
    e32 = np.zeros(0, dtype=np.uint32)
    return BMoveArrays(
        meta=meta, fused_fwd=fused_fwd, fused_rev=fused_rev,
        first_row=first,
        text=e32 if textless else pack_2bit(codes),
        sa_stride=e32 if textless else sa_stride,
        phi_fwd=(np.stack(phi_f, axis=1) if textless
                 else np.zeros((0, 4), np.uint32)),
        phi_rev=(np.stack(phi_r, axis=1) if textless
                 else np.zeros((0, 4), np.uint32)),
        seq_starts=np.asarray(seq_starts, dtype=np.int64),
        seq_names=list(seq_names),
    )


def build_bmove(fasta_paths, out_dir=None, seed=42, sa_method="auto",
                textless: bool = False):
    """FASTA file(s) -> RLC index arrays (optionally persisted)."""
    if isinstance(fasta_paths, str):
        fasta_paths = [fasta_paths]
    codes, names, starts = preprocess_fasta(fasta_paths, seed=seed)
    idx = build_bmove_from_codes(codes, names, starts, sa_method=sa_method,
                                 textless=textless)
    if out_dir is not None:
        save_bmove(idx, out_dir)
    return idx


_BM_FIELDS = ["fused_fwd", "fused_rev", "first_row", "text", "sa_stride",
              "seq_starts", "phi_fwd", "phi_rev"]


def save_bmove(idx: BMoveArrays, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for name in _BM_FIELDS:
        np.save(os.path.join(out_dir, name + ".npy"), getattr(idx, name))
    meta = dict(idx.meta)
    meta["seq_names"] = idx.seq_names
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)


def load_bmove(out_dir: str) -> BMoveArrays:
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("flavor") != "rlc":
        raise ValueError("not an RLC index (flavor mismatch)")
    if meta.get("format_version") != INDEX_FORMAT_VERSION:
        raise ValueError("index format mismatch; rebuild")
    seq_names = meta.pop("seq_names")
    arrs = {}
    for name in _BM_FIELDS:
        path = os.path.join(out_dir, name + ".npy")
        if name in ("phi_fwd", "phi_rev") and not os.path.exists(path):
            # index layout from before the textless flavor: no phi tables
            arrs[name] = np.zeros((0, 4), np.uint32)
            continue
        try:
            arrs[name] = np.load(path)
        except FileNotFoundError as e:
            raise ValueError(
                f"RLC index at {out_dir} is missing {e.filename} "
                "(built by an older version?); rebuild it") from e
    return BMoveArrays(meta=meta, seq_names=seq_names, **arrs)


def locate_tables(fused_fwd: np.ndarray, r_f: int, n: int,
                  textless: bool) -> tuple:
    """Kernel C's RLC walk tables, made at index load (the index on disk
    stays as it is): the forward runs' START, END, LF_POS and LF_RUN and
    the sentinel row, 16 B a run, so that a walk step and its fast-forward
    read one 16 B word a run (the fused rows are 80 B); and the run that
    holds every 2^shift-th BWT row, with 2^shift about twice n / r_f, so
    that a row's run is a short forward walk from its bucket's run and
    not a binary search over every run. Returns (walk (r_f + 1, 4) uint32,
    run_at int32, shift); the walk table is empty on the textless index,
    which locates on the host, but its bucket table is made all the same:
    the run tables of :func:`run_tables` read it."""
    shift = (n // max(r_f, 1)).bit_length()
    heads = np.arange(0, n + 1, 1 << shift, dtype=np.int64)
    run_at = np.searchsorted(fused_fwd[:r_f, START].astype(np.int64), heads,
                             side="right") - 1
    walk = (np.zeros((0, 4), np.uint32) if textless else
            np.ascontiguousarray(fused_fwd[:r_f + 1, START:LF_RUN + 1]))
    return walk, run_at.astype(np.int32), shift


def run_tables(fused_fwd: np.ndarray, fused_rev: np.ndarray, r_f: int,
               r_r: int, n: int, shift: int) -> tuple:
    """The RLC run tables of kernels A, B, E and F, made at index load
    (the index on disk stays as it is). Runs are contiguous (END[j] ==
    START[j + 1]), so one 4 B START array a direction serves the forward
    walks, which read END, and the backward ones, which read START: eight
    runs share a 32 B sector, where a fused row is 80 B. Each direction's
    array is its runs' STARTs, the sentinel's and then n + 1 up to a
    multiple of four entries at least 13 past the sentinel, so that a 16
    B-aligned read of twelve entries around any run stays inside it and
    every entry past the last run compares above every position. The
    reverse direction's array starts at ``rev_off`` (a multiple of four).
    A walk that would go past ``ops/bextend.FF_CAP`` runs looks up the run
    that holds every 2^shift-th position (:func:`locate_tables`'s
    ``run_at`` for the forward direction, the same for the reverse one)
    and walks on from there. Both RLC indexes hold them, the textless one
    (12-wide lanes) included. Returns (starts uint32, rev_off, run_at_rev
    int32)."""
    big = n + 1
    parts = []
    for fused, r in ((fused_fwd, r_f), (fused_rev, r_r)):
        cols = np.full((r + 16) & ~3, big, np.uint32)
        cols[:r] = fused[:r, START]
        parts.append(cols)
    heads = np.arange(0, n + 1, 1 << shift, dtype=np.int64)
    run_at_rev = np.searchsorted(fused_rev[:r_r, START].astype(np.int64),
                                 heads, side="right") - 1
    return (np.concatenate(parts), len(parts[0]),
            run_at_rev.astype(np.int32))


def _words(a) -> torch.Tensor:
    """uint32 numpy words -> int32 tensor with the same bit pattern."""
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).view(np.int32))


@dataclass(frozen=True)
class BMoveIndex:
    """Device tensors of one RLC index; move with :meth:`to`.

    The forward and reverse fused tables are one contiguous table (the
    reverse rows start at ``r_fwd + 1``), so a lane's direction is a row
    offset, as the FM-index's concatenated occ rows are. Word arrays are
    int32 tensors holding uint32 bits, as in ``FMIndex``; the packed text is
    flat (16 bases per word), the layout kernel D reads."""

    fused: torch.Tensor      # (R_f + R_r + 2, NCOLS) int32 (uint32 bits)
    first_row: torch.Tensor  # (5,) int64 first F row per '$ACGT' char
    text: torch.Tensor       # (ceil(n/16),) int32 packed words; empty
    sa_stride: torch.Tensor  # int32 SA at every stride-th fwd row; empty
    # kernel C's locate tables (:func:`locate_tables`); walk empty when
    # textless
    walk: torch.Tensor = None     # (R_f + 1, 4) int32 START END LF_POS LF_RUN
    run_at: torch.Tensor = None   # int32 fwd run of every 2^run_shift-th row
    # the run tables of kernels A, B, E and F (:func:`run_tables`)
    starts: torch.Tensor = None   # int32 fwd then rev runs' START, padded
    run_at_rev: torch.Tensor = None   # int32 rev run of every 2^run_shift-th

    # -- host metadata --
    n: int = 0
    r_fwd: int = 0           # fwd intervals (rev table rows offset r_fwd+1)
    r_rev: int = 0
    stride: int = LOCATE_STRIDE
    textless: bool = False
    toe_init: int = 0        # SA of the full fwd range's last row
    first_host: tuple = (0, 0, 0, 0)
    run_shift: int = 0
    starts_rev: int = 0      # offset of the rev runs in ``starts``

    @staticmethod
    def from_arrays(arrays: BMoveArrays, device) -> "BMoveIndex":
        """Device index from host arrays (either package's BMoveArrays:
        both are plain numpy), on the device the caller names."""
        r_f = int(arrays.meta["runs_fwd"])
        fused = np.concatenate([arrays.fused_fwd, arrays.fused_rev])
        first = np.asarray(arrays.first_row, dtype=np.int64)
        walk, run_at, shift = locate_tables(
            arrays.fused_fwd, r_f, int(arrays.n), bool(arrays.textless))
        r_r = int(arrays.meta["runs_rev"])
        starts, starts_rev, run_at_rev = run_tables(
            arrays.fused_fwd, arrays.fused_rev, r_f, r_r, int(arrays.n),
            shift)
        return BMoveIndex(
            fused=_words(fused),
            first_row=torch.from_numpy(first.copy()),
            text=_words(arrays.text),
            sa_stride=_words(arrays.sa_stride),
            walk=_words(walk),
            run_at=torch.from_numpy(run_at),
            starts=_words(starts),
            run_at_rev=torch.from_numpy(run_at_rev),
            n=int(arrays.n),
            r_fwd=r_f,
            r_rev=r_r,
            stride=int(arrays.meta.get("locate_stride", LOCATE_STRIDE)),
            textless=bool(arrays.textless),
            toe_init=int(arrays.fused_fwd[r_f - 1, SA_LAST]),
            first_host=tuple(int(x) for x in first[:4]),
            run_shift=shift,
            starts_rev=starts_rev,
        ).to(device)

    def to(self, device) -> "BMoveIndex":
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in fields(self)
                 if isinstance(getattr(self, f.name), torch.Tensor)}
        return replace(self, **moved)

    @property
    def device(self) -> torch.device:
        return self.fused.device

    def nbytes(self) -> int:
        return sum(getattr(self, f.name).nbytes for f in fields(self)
                   if isinstance(getattr(self, f.name), torch.Tensor))

    @property
    def range_width(self) -> int:
        # textless lanes append [toe_value, toe_offset, toe_flag, pad]
        return 12 if self.textless else 8

    def full_cols(self) -> list:
        """Whole-index range pair + run hints (+ toehold when textless), as
        host integers."""
        big = self.n + 1
        cols = [0, big, 0, big, 0, self.r_fwd - 1, 0, self.r_rev - 1]
        if self.textless:
            # toehold: SA of the last row (offset big - 1), anchored fwd
            cols += [self.toe_init, big - 1, 0, 0]
        return cols

    def full_range(self, batch_shape=()) -> torch.Tensor:
        """Whole-index range pair + run hints (+ toehold when textless)."""
        cols = self.full_cols()
        r = torch.tensor(cols, dtype=torch.int64, device=self.device)
        return r.expand(*batch_shape, len(cols)).contiguous()
