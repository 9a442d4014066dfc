"""The least time the card could take for one call of each kernel.

For every kernel of the port, the bytes the call must move (each input
read once, each output written once, worked out from the tensors' shapes)
and the integer operations it does, and from them the bound: the larger of
bytes over the card's memory rate and operations over its arithmetic rate.
Where the work depends on the data (kernel B skips the occ rows of inactive
lanes and writes the children that stay, kernel A's loop and kernel E stop
at a lane's first empty range, kernel C walks LF until a sampled row, and
on the RLC index every run-hint walk and binary search has its own length),
the caller passes what this call's data needed, counted with the plain
versions (``stats`` of ``ops/bextend.py``, ``ops/blocate.py``,
``search/executor.exact_loop_plain`` and, on the RLC index,
``search/dynschedule.dynamic_partition_plain``). Kernels G and H, and F on
the Vanilla index, do the same work whatever the data.

Peak rates are NVIDIA's data-sheet figures for the H100 SXM at its full
power limit: 3.35 TB/s of HBM, and 67 T operations/s outside the tensor
cores. The data sheet gives that rate for float32; it stands in here for the
kernels' 32-bit integer operations (the integer units are no faster, so the
bound stays a lower bound). The operation counts are per-lane instruction
estimates of the loops in ``csrc/*.cu``, stated beside each.

Used by ``chip_smoke.py``; run nowhere else.
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

OCC_ROW_BYTES = 48      # 4 checkpoints + 8 packed BWT words; the pad is not read
# one occ row: 8 words x 4 chars x (xor, not, shift, 2 and, popc, add) + setup
OCC_ROW_OPS = 8 * 4 * 7 + 16
# extend_lane: two occ rows + the 4 children's range arithmetic
EXTEND_OPS = 2 * OCC_ROW_OPS + 4 * 10


# RLC index: an endpoint read is four of a run row's five 16 B words
BM_ROW_BYTES = 64
# per lane: unpack the two rows, 4 chars x (occ, width, lo), the other side
BM_LANE_OPS = 60
# per child whose hints are walked: two LF-run reads, four walk set-ups,
# the selects into the child's columns
BM_CHILD_OPS = 40
WALK_OPS = 4         # per read of a walk: compare, add, address
PROBE_OPS = 6        # per binary-search probe: mid, read, compare, 2 selects
# kernel D, a row of the band per 32-bit word: Myers' step and the match
# mask; at kb 0 a row's two plane compares, and the popcount per 32 rows
VERIFY_ROW_OPS = 20
VERIFY_KB0_OPS = 4


def bound(n_bytes: float, n_ops: float) -> dict:
    """bound_ms (the larger of the two times) and what sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / OPS_PER_S * 1e3
    return dict(bytes=int(n_bytes), operations=int(n_ops),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def extend(ranges, dirs, chars, out) -> dict:
    """Kernel A: per lane its range, direction and char in, two occ rows,
    the child range(s) out."""
    L = dirs.numel()
    return bound(_nbytes(ranges, dirs, chars, out) + L * 2 * OCC_ROW_BYTES,
                 L * EXTEND_OPS)


def kmer_table(K: int, out) -> dict:
    """Kernel A's table entry, the (4^K, rw) k-mer seed table: the table
    out and, for each of the 4^s distinct suffixes a step s extends (every
    k-mer ending in the same s chars walks the same range so far), its
    two occ rows (RLC: two endpoint rows) once. The kernel walks every
    k-mer's K steps alone; a build that shared the suffixes' steps would
    read no less."""
    rw = out.shape[1]
    parents = sum(4 ** s for s in range(K))
    rows, ops = ((2 * BM_ROW_BYTES, BM_LANE_OPS) if rw > 4
                 else (2 * OCC_ROW_BYTES, EXTEND_OPS))
    return bound(_nbytes(out) + parents * rows, parents * ops)


def band_step(state, mrow_t, o: dict, cap: int, M: int, cnt: int,
              stats: dict | None = None) -> dict:
    """Kernel B, one fused step over the lanes of ``state`` (ranges, ids,
    band, colmin; every lane read): each lane's range and id in, the band
    and registers of its live lanes; the step's scalars (the (S, 7) row and
    the step's (S, BW) slice of the cell table, 4 B a cell; or
    with ``mrow_t`` None, per-lane schedules, one 4-byte word per lane);
    per active lane its BW cells (the read's chars at them, or its row of
    per-lane codes) and two occ rows (RLC: two endpoint rows, plus the
    walks of the children written on the run tables, ``stats`` of
    :func:`rlc_band_stats`); the kept
    children's state out (at most ``cap`` rows), the narrow rows out (at
    most ``M - cnt``) and the 32 B of counters. No child state goes to
    memory and back. ``o``: ``executor.band_step_plain``'s output for
    these lanes (act, ch_alive, narrow)."""
    ranges, ids, band, colmin = state
    L, rw = ranges.shape
    bw, Wp = band.shape[-1], colmin.shape[-1]
    cells = 2 * bw + 2 * Wp
    n_alive = int((ranges[:, 1] > ranges[:, 0]).sum())
    n_act = int(o["act"].sum())
    kept = min(int(o["ch_alive"].sum()), cap)
    narrow = min(int(o["narrow"].sum()), max(M - cnt, 0))
    wb, wo = _rlc_walks(stats) if stats is not None else (0, 0)
    rows, lane_ops = ((2 * BM_ROW_BYTES, BM_LANE_OPS) if stats is not None
                      else (2 * OCC_ROW_BYTES, EXTEND_OPS))
    n_bytes = (L * (8 * rw + 4) + n_alive * cells
               + (_nbytes(mrow_t) + mrow_t.shape[0] * bw * 4
                  if mrow_t is not None else 4 * L)
               + n_act * (rows + bw) + wb
               + kept * (8 * rw + 4 + cells) + narrow * 32 + 32)
    # 4 chars x bw cells x (compare, select, add, 2 min, clamp) for the
    # row; Wp registers x 4 chars x (bw selects + 3); prune 4 x (bw + Wp +
    # 6); per lane the decode and its share of the block scan; per row
    # written its values and address
    per_act = (lane_ops + 4 * bw * 7 + Wp * 4 * (bw + 3)
               + 4 * (bw + Wp + 6))
    return bound(n_bytes, n_act * per_act + L * 44
                 + kept * (cells + rw + 4) + narrow * 8 + wo)


def exact_loop(ranges, ids, tabs, per_lane: bool, stats: dict,
               out, drows) -> dict:
    """Kernel A's loop entry: per lane its range (and id) in, its final
    range and drain row out; per extension (``stats["steps"]`` of
    ``executor.exact_loop_plain``) the read's code and two occ rows (RLC:
    two endpoint rows, and the chosen child's walks on the run tables in
    ``stats``); the
    (E, S) step tables once, or per-read tables the position and direction
    of each extension and the depth of each drain."""
    L, rw = ranges.shape
    steps = stats.get("steps", 0)
    drains = int((drows[:, 1] > drows[:, 0]).sum())
    rlc = rw > 4
    wb, wo = _rlc_walks(stats) if rlc else (0, 0)
    rows, lane_ops = ((2 * BM_ROW_BYTES, BM_LANE_OPS) if rlc
                      else (2 * OCC_ROW_BYTES, EXTEND_OPS))
    tab_bytes = (steps * 8 + drains * 4 if per_lane
                 else _nbytes(*tabs))
    return bound(_nbytes(ranges, ids, out, drows) + steps * (rows + 1)
                 + tab_bytes + wb,
                 steps * (lane_ops + 12) + L * 12 + wo)


def locate(rows, steps, out) -> dict:
    """Kernel C: per row its LF steps (``steps``, from the plain version) x
    one occ row, a marker word per row visited, then the rank word and the
    sample; the row in, the position out."""
    n_steps = int(steps.sum())
    N = rows.numel()
    return bound(_nbytes(rows, out) + n_steps * OCC_ROW_BYTES
                 + (n_steps + N) * 4 + N * 8,
                 n_steps * (OCC_ROW_OPS + 12) + N * 30)


def verify(patterns, rid, window_start, kb: int, out,
           live: int | None = None) -> dict:
    """Kernel D: per candidate the m + 3kb + 1 window codes at 2 bits
    each, the read's m bytes, its read id and window start; the final row
    out. Operations: the bit-vector band's (Myers' banded step, about 17
    word operations a row as Hyyro counts it, and 3 for the row's match
    mask: VERIFY_ROW_OPS a 32-bit word of the band; at kb 0 the mismatch
    count, VERIFY_KB0_OPS a row), then 4 a cell to rebuild the final row.
    PRs 1-6 counted the scalar recurrence (8 a cell and 6 a row: 78 a row
    at kb 2, 422 at kb 13), which the bit-vector kernel beat at kb 7 and
    13, so that count is no lower bound.

    ``live``: the count of live slots (``verify.verify_window``'s
    ``live``). The slots past it all hold (read 0, window 0), so their
    rows need one DP between them and their rows' bytes out."""
    m = patterns.shape[1]
    B = rid.numel()
    bw = 4 * kb + 1
    dps = B if live is None or live >= B else live + 1
    row_ops = VERIFY_KB0_OPS if kb == 0 else VERIFY_ROW_OPS * (
        1 if bw <= 32 else 2)
    return bound(dps * (16 + (m + 3 * kb + 1 + 3) // 4 + m) + _nbytes(out),
                 dps * (m * row_ops + bw * 4))


def exact(steps_walked: int, rows: int, out) -> dict:
    """Kernel E: per row the steps it walks (until its first empty range) x
    (one char + two occ rows); the final range out."""
    return bound(steps_walked * (2 * OCC_ROW_BYTES + 1) + _nbytes(out),
                 steps_walked * (EXTEND_OPS + 8) + rows * 8)


def exact_steps(index, batch: torch.Tensor, lengths=None,
                stats: dict | None = None, tables: bool = True) -> int:
    """Steps kernel E walks on ``batch``: for each row the number of chars
    it extends by before (and including) the step that empties its range,
    counted with the plain extend. ``lengths``: the rows' own lengths. On
    the RLC index ``stats`` also gets the walks of those steps, on the run
    tables (``tables=False``: on the fused rows)."""
    from columba_tpu_torch.index.bmove import BMoveIndex
    from columba_tpu_torch.ops import bextend
    from columba_tpu_torch.ops import extend as ext

    B, m = batch.shape
    ranges = index.full_range((B,))
    dirs = torch.zeros(B, dtype=torch.int32, device=batch.device)
    alive = torch.ones(B, dtype=torch.bool, device=batch.device)
    if lengths is None:
        lengths = torch.full((B,), m, dtype=torch.int64, device=batch.device)
    steps = 0
    for i in range(m):
        j = lengths.long() - 1 - i
        alive &= j >= 0
        c = batch.gather(1, j.clamp(0, m - 1)[:, None])[:, 0].int()
        # a row that meets N stops without reading its rows; a row past its
        # length reads nothing (its walks are not counted either)
        steps += int((alive & (c <= 3)).sum())
        if isinstance(index, BMoveIndex):
            new = bextend.extend_char_plain(
                index, ranges, torch.where(alive, c, 4), dirs, stats,
                tables)
        else:
            new = ext.extend_char_plain(index, ranges, c, dirs)
        ranges = torch.where(alive[:, None], new, ranges)
        alive &= ranges[:, 1] > ranges[:, 0]
        if not bool(alive.any()):
            break
    return steps


def extend_rlc(ranges, dirs, chars, out, stats: dict) -> dict:
    """Kernel A's RLC entry (``extend.rlc``): per lane its range, direction
    and char in, the child range(s) out; per lane that extends (a live
    range and, for ``extend_char``, a char that is not N) two endpoint
    reads, and the walks of the children it writes (``stats`` of
    ``bextend.extend_all_plain`` / ``extend_char_plain``)."""
    ext = ranges[:, 1] > ranges[:, 0]
    if chars is not None:
        ext &= chars <= 3
    n_ext = int(ext.sum())
    wb, wo = _rlc_walks(stats)
    return bound(_nbytes(ranges, dirs, chars, out) + n_ext * 2 * BM_ROW_BYTES
                 + wb, n_ext * BM_LANE_OPS + wo)


def dynpart_rlc(reads, p: int, K: int, seeded: bool, stats: dict,
                pts) -> dict:
    """Kernel F's RLC entry: per read its m chars in and p + 1 boundaries
    out, the p seeds (a 64 B table row each, or one extension of the full
    range); per extension that reads rows (``stats["steps"]`` of
    ``dynschedule.dynamic_partition_plain``: the seeds without a table and
    the greedy steps, not those that meet N) two endpoint reads and the
    chosen child's walks (``stats``). Each of the m - p*K greedy steps
    first scans the p parts (width, two compares, a product, a compare).
    The walks are on the run tables (4 B STARTs and bucket reads)."""
    R, m = reads.shape
    ext = stats.get("steps", 0)
    wb, wo = _rlc_walks(stats)
    return bound(_nbytes(reads, pts) + (R * p * 64 if seeded else 0)
                 + ext * 2 * BM_ROW_BYTES + wb,
                 ext * BM_LANE_OPS + R * max(m - p * K, 0) * (8 * p + 16)
                 + wo)


def dynpart(reads, p: int, K: int, seeded: bool, pts) -> dict:
    """Kernel F: per read its m chars in, the p seed ranges (a 32 B table
    row each, or without a table one extension of the full range: two occ
    rows), then m - p*K steps of two occ rows each (a thread walks them all,
    whatever its ranges); p + 1 boundaries out. Each step scans the p parts
    (width, two compares, a product, a compare) before it extends."""
    R, m = reads.shape
    steps = R * max(m - p * K, 0)
    seed_bytes = R * p * (32 if seeded else 2 * OCC_ROW_BYTES)
    seed_ops = R * p * (2 * K if seeded else EXTEND_OPS)
    return bound(_nbytes(reads, pts) + seed_bytes
                 + steps * 2 * OCC_ROW_BYTES,
                 seed_ops + steps * (EXTEND_OPS + 8 * p + 16))


def dyn_tables(pts, reads, phases, out: dict) -> dict:
    """Kernel G: boundaries, reads and the scheme's phase table in, every
    table out (u_last is the scheme's own and is not written). Per (read,
    search): a p-phase prologue; per band step the phase search (p), about
    30 operations for the word and 10 per band cell; per exact step two
    loops over the phases."""
    written = [v for k, v in out.items() if k != "u_last"]
    L, T = out["meta"].shape
    E = out["ex_pos"].shape[1]
    bw = out["pchars"].shape[1]
    p = pts.shape[1] - 1
    return bound(_nbytes(pts, reads, phases, *written),
                 L * (20 * p + T * (p + 30 + 10 * bw) + E * (3 * p + 12)))


def gather(table, idx, out) -> dict:
    """Kernel H: per lane its index and its row in, the row out; a move and
    a clamp per 16 B chunk."""
    return bound(_nbytes(idx, out, out),     # the row is read and written
                 idx.numel() * (table.shape[1] // 4) * 4)


def _rlc_walks(stats: dict) -> tuple:
    """(bytes, operations) of the 4 B reads the run-hint walks made (on the
    run tables: the STARTs walked, the bucket reads and the STARTs walked
    from there; on the fused rows: the run bounds and binary-search
    probes), the LF-run reads, and on 12-wide lanes the 16 B of samples a
    toehold reset off the hi row reads, in ``stats``."""
    walk, probes = stats.get("walk", 0), stats.get("probes", 0)
    bucket = stats.get("bucket", 0) + stats.get("bucket_walk", 0)
    hint_rows = stats.get("hint_rows", 0)
    return ((walk + probes + bucket + hint_rows) * 4
            + stats.get("toe_rows", 0) * 16,
            (walk + bucket) * WALK_OPS + probes * PROBE_OPS
            + stats.get("children", 0) * BM_CHILD_OPS)


def rlc_rounds(steps: int, stats: dict, rows: int) -> float:
    """Dependent-read rounds a row (or lane) of the four-lane step on the
    RLC index (kernels A's loop, E and F): one a step for the endpoint
    rows (the next char is read beside them),
    then for each child whose hints are walked the longest of its four
    walks with its LF-run read (``stats["walk_rounds"]`` of the plain
    versions on the run tables, ``ops/bextend.walk_tables``)."""
    return (steps + stats.get("walk_rounds", 0)) / max(rows, 1)


def lane_rounds(steps: int, stats: dict, rows: int) -> float:
    """The same chain where one thread walks a child's four hints one after
    another on the fused rows (the design the four-lane step replaced): a
    step's rows, the two LF-run reads, then every walk read and
    binary-search probe in turn (``stats`` of the plain versions on the
    fused rows)."""
    return (steps + stats.get("children", 0) + stats.get("walk", 0)
            + stats.get("probes", 0)) / max(rows, 1)


def rlc_band_stats(index, state, mrow_t, o: dict, cap: int,
                   dyn_meta=None, T: int = 0, t: int = 0) -> dict:
    """The walks kernel B's RLC entries make in one step: the hints of the
    children that stay in the frontier and are written (the first ``cap``
    of them), of the lanes that keep theirs, counted with the plain
    extension. ``o``: ``executor.band_step_plain``'s output. Per-lane
    schedules: each lane's side comes from its own word of ``dyn_meta``
    at ``id * T + t``. The walks are on the run tables, as the kernel's
    quads walk them."""
    from columba_tpu_torch.ops import bextend

    ranges, ids = state[0], state[1]
    idc = ids.long() & ((1 << 21) - 1)
    if dyn_meta is not None:
        side = (dyn_meta.long()[idc * T + t] >> 1) & 1
    else:
        side = (mrow_t.long()[idc % mrow_t.shape[0], 0] >> 1) & 1
    keep = o["act"] & (o["new_ids"] >= 0)
    pos = o["ch_alive"].reshape(-1).long().cumsum(0).reshape(-1, 4) - 1
    stats: dict = {}
    bextend.extend_all_plain(
        index, torch.where(o["act"][:, None], ranges, 0), side,
        o["ch_alive"] & keep[:, None] & (pos < cap), stats, tables=True)
    return stats


def exact_rlc(steps_walked: int, stats: dict, out) -> dict:
    """Kernel E's RLC entry: per step walked one char and two endpoint
    reads, then the chosen child's walks on the run tables (``stats`` of
    :func:`exact_steps`: 4 B STARTs and bucket reads, and the LF-run reads
    the rows do not hold); the range out."""
    wb, wo = _rlc_walks(stats)
    return bound(steps_walked * (2 * BM_ROW_BYTES + 1) + wb + _nbytes(out),
                 steps_walked * (BM_LANE_OPS + 8) + wo)


def locate_rlc(rows, stats: dict, out) -> dict:
    """Kernel C's RLC entry: per row its bucket's run (one 4 B read of
    ``run_at``) and the walk-table words up to the row's run
    (``stats["bucket"]``, 16 B each), then per LF step the landing run's
    word and its fast-forward's words (``stats["walk"]``, 16 B each), and
    one 4 B sample read; row in, position out."""
    N = rows.numel()
    steps = stats.get("steps", 0)
    words = stats.get("bucket", 0) + stats.get("walk", 0)
    return bound(_nbytes(rows, out) + N * 4 + words * 16 + N * 4,
                 (N + steps) * 12 + words * WALK_OPS)


# -- kernels I-L: the frontier, candidates and dedup outside the band steps --
# operations per element: index arithmetic, compares and selects of the
# entries' loops (csrc/frontier.cu, expand.cu, dedup.cu), and per lane of a
# scan its share of the block scan and the look-back
SCAN_OPS = 24
LANE_OPS = 12


def _n(t) -> int:
    return 0 if t is None else int(t.numel())


def entry(name: str, a: dict, post: dict, out) -> dict:
    """Bound of one call of an entry of kernels I-L. ``a``: the call's
    arguments by name before it ran, ``post``: the same after (the entries
    that write in place), ``out``: what it returned. The kept, narrow and
    ghost rows, the unique pairs and the valid rows are this call's."""
    if name in ("frontier.seed", "frontier.lookup"):
        if name == "frontier.lookup":
            chars, table = a["chars"], a["table"]
            n = chars.numel() // chars.shape[-1]
            return bound(chars.numel() + n * 64, n * (3 * chars.shape[-1]
                                                       + LANE_OPS))
        reads = a["reads"]
        ranges0 = out
        L = ranges0.shape[0]
        seeded = 0
        if a["kmer_table"] is not None:
            Kk = int(a["kmer_table"].shape[0]).bit_length() // 2
            seeded = int((a["kstart"] >= 0).sum()) * reads.shape[0]
            # each seeded lane's K chars and its 32 B table row
            read_bytes = seeded * (Kk + 32)
        else:
            read_bytes = 0
        n_bytes = (read_bytes + _n(a["search_mask"]) + _nbytes(ranges0)
                   + sum(_nbytes(t) for t, _ in a["clears"]))
        return bound(n_bytes, L * LANE_OPS
                     + sum(_nbytes(t) for t, _ in a["clears"]) // 16)
    if name == "frontier.drain":
        L = a["drows"].shape[0]
        kept = int(post["words"][4])
        return bound(32 * L + 32 * kept + 8, L * SCAN_OPS)
    if name == "frontier.init":
        r0, st = a["ranges0"], post["state"]
        L, rw = r0.shape
        w = post["words"]
        narrow = int(w[0] >> 32) - int(a["words"][4])
        kept = min(int(w[5]), st[0].shape[0])
        row = rw * 8 + 4 + st[2][0].numel() + st[3][0].numel()
        n_bytes = (_nbytes(r0) + _nbytes(a["db_exact"], a["band_init"],
                                         a["colmin_init"])
                   + 32 * narrow + row * kept + 24)
        return bound(n_bytes, L * SCAN_OPS)
    if name == "frontier.ex_compact":
        r0 = a["ranges0"]
        L, rw = r0.shape
        kept = int((out >= 0).sum())
        return bound(16 * L + (rw - 2) * 8 * kept + 4 * L
                     + (rw * 8 + 4) * kept + 8, L * SCAN_OPS)
    if name == "frontier.ex_back":
        L, rw = a["ranges0"].shape
        back = int((a["slot"] >= 0).sum())
        return bound(4 * L + (rw * 8 + 32) * back + rw * 8 * L + 32 * back,
                     L * LANE_OPS)
    if name == "frontier.tail":
        return _tail(a, post["words"])
    if name == "expand.frontier_tail":
        # kernel J's rows (its bytes: the frontier's row in, J's outputs
        # and the ghosts' rows out), then per in-text row its 32 B and
        # per candidate the four columns and the prefix sum out; the done
        # lanes' ranges, rid and sid stay on the chip
        t = a["res"].tail
        C, M = t["state"][0].shape[0], t["itv"].shape[0] - 1
        j = _tail(t, post["res"].tail["words"])
        return bound(j["bytes"] + M * 32 + 40 * (C + M) + 8,
                     j["operations"] + (C + M) * (LANE_OPS + SCAN_OPS))
    if name == "expand.ranges":
        n = a["c_lo"].shape[0]
        return bound(16 * n + 8 * n + 8, n * SCAN_OPS)
    if name == "expand.rows":
        # what the function needs: every prefix sum, the lo of each
        # candidate that owns a valid row, 17 B a row out (the kernel's
        # staging reads every candidate's lo: a cost of the kernel, not of
        # the function); a row's search among its block's 2,048 staged
        # prefix sums, 11 probes
        rows, cand, valid = out
        n, ml = a["offsets"].shape[0], rows.shape[0]
        live = int(torch.unique(cand[valid]).numel())
        return bound(8 * n + 8 * live + 17 * ml, ml * (LANE_OPS + 4 * 11))
    if name == "dedup.windows":
        L = a["pos"].shape[0]
        distinct = int(torch.unique(a["cand"]).numel())
        return bound(16 * L + 16 * distinct + 16 * L, L * LANE_OPS)
    if name == "dedup.keys":
        # the valid rows' rid and window in (and the mask, without the
        # prefix count), a 12 B record each out, each pass's 256 digit
        # starts, the verify slots cleared; a digit count a pass a row
        n, starts = int(out[0]), out[1]
        L = a["rid"].shape[0]
        mask = L if a["total"] is None else 8
        return bound(16 * n + mask + 12 * n + starts.numel() * 4
                     + 17 * a["max_verify"] + 8,
                     n * (LANE_OPS + starts.shape[0]))
    if name == "dedup.pass":
        # 12 B in and 12 B out a valid row, and the pass's digit starts
        n = int(a["n"])
        return bound(24 * n + 4 * 256 + 8, n * (LANE_OPS + SCAN_OPS))
    if name == "dedup.compact":
        # a record a valid row (its key and row), its window where kept;
        # 17 B out a kept row
        n, mv = int(a["n"]), a["outs"][0].shape[0]
        kept = min(int(out[3]), mv)
        return bound(12 * n + 8 * kept + 17 * kept + 16, n * SCAN_OPS)
    raise ValueError(f"no bound for {name}")


def _tail(t: dict, words_after) -> dict:
    """Kernel J's bytes and operations: the live rows' range ends, id and
    colMin registers in, the zeroed rows' fields, rid, sid, ed_lb, done
    and arg_b out, a 32 B row a ghost."""
    st = t["state"]
    cap, rw = st[0].shape
    Wp = st[3].shape[-1]
    live = cap if not t["moved"] else min(t["live"], cap)
    zeroed = cap - live
    row = rw * 8 + 4 + st[2][0].numel() + st[3][0].numel()
    ghosts = int(words_after[6]) - int(t["words"][0] >> 32)
    n_bytes = (live * (16 + 4 + 2 * Wp) + zeroed * row
               + cap * (3 * 8 + 2) + 32 * ghosts + 16)
    return bound(n_bytes, cap * (SCAN_OPS + 2 * Wp))
