"""Plain versions of kernels I-L against the JAX package, on the CPU.

Kernels I and J (``csrc/frontier.cu``: the k-mer seeds, the drain and init
of the frontier, the two-stage exact loop's compaction, the tail) run inside
``executor.run_scheme``; kernels K and L (``csrc/expand.cu``,
``csrc/dedup.cu``) are ``pipeline.stage_tail_candidates`` (J's tail in
K's launch on ``match_device_core``'s path), ``stage_expand``,
``stage_windows`` and
``stage_dedup`` (kernel L's keys, radix passes and compaction). On CPU
tensors each wrapper takes its plain version, so these tests hold the plain
versions to the JAX package with exact equality: the stage functions on
inputs made with numpy from a seed that push their edges (widths past
``max_locate``, a total past it, no candidate at all; kernel L's edges of
``tools/edges.py``: masks, duplicates, windows below 0 and near 2^32, odd
read counts, one row, more unique pairs than ``max_verify``, each also
through the composed plain entries), and run_scheme's whole FrontierResult
where the in-text buffer clamps at M, the frontier overflows its capacity,
ghosts reach the tail and the two-stage band loop shrinks (also with the
tail deferred to the candidates), and under track_arg on a textless index.
The kernels themselves are held to these plain versions on the card
(``tests/test_torch_kernels.py``, ``chip_smoke.py``).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columba_tpu.index import bmove as jbm
from columba_tpu.index import kmer as jkmer
from columba_tpu.search import executor as jexec
from columba_tpu.search import pipeline as jpipe
from columba_tpu.search.scheme import get_scheme as jscheme
from columba_tpu_torch.index import bmove as tbm
from columba_tpu_torch.index import kmer as tkmer
from columba_tpu_torch.search import executor as texec
from columba_tpu_torch.search import pipeline as tpipe
from columba_tpu_torch.search.scheme import get_scheme as tscheme
from columba_tpu_torch.tools.edges import (DEDUP_CASES, dedup_case,
                                           dedup_entries, tail_frontier)

from tests.test_torch_executor import FIELDS, world  # noqa: F401

torch.set_num_threads(1)


def _eq(got, want, what=""):
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                  np.asarray(want).astype(np.int64),
                                  err_msg=what)


@pytest.mark.parametrize("case", ["wide", "over_cap", "empty", "fits",
                                  "empty_runs"])
def test_stage_expand_edges(case):
    """stage_expand: candidates wider than max_locate, a total past it, no
    live candidate (zero and negative widths), a total that fits, and live
    candidates between runs of empty ones longer than a block of kernel
    K's rows stages (2,048 merged rows and candidates)."""
    rng = np.random.default_rng(["wide", "over_cap", "empty",
                                 "fits", "empty_runs"].index(case) + 70)
    n, ml = (300, 256) if case != "empty_runs" else (12_000, 512)
    lo = rng.integers(0, 1 << 31, n).astype(np.int64)
    runs = np.zeros(n, np.int64)
    if case == "empty_runs":
        runs[[0, 1, 2500, 2501, 7000, n - 1]] = [3, 1, 40, 2, 7, 5]
    width = {"wide": rng.choice([0, 1, 3, ml + 40, 5 * ml], n),
             "over_cap": rng.integers(0, 6, n),
             "empty": -rng.integers(0, 3, n),
             "fits": rng.choice([0, 0, 0, 1, 2], n),
             "empty_runs": runs}[case]
    hi = lo + width
    got = tpipe.stage_expand(torch.from_numpy(lo), torch.from_numpy(hi), ml)
    want = jpipe.stage_expand(jnp.asarray(lo.astype(np.uint32)),
                              jnp.asarray(np.maximum(hi, 0).astype(
                                  np.uint32)) if case != "empty" else
                              jnp.asarray(lo.astype(np.uint32)), ml)
    for a, b, f in zip(got, want, ("rows", "cand", "valid", "total")):
        _eq(a, b, f)
    total = int(got[3])
    assert {"wide": total > ml, "over_cap": total > ml, "empty": total == 0,
            "fits": 0 < total < ml, "empty_runs": total == 58}[case]
    offsets, tot = tpipe.expand_scan_plain(torch.from_numpy(lo),
                                           torch.from_numpy(hi), ml)
    assert int(tot) == total and int(offsets[-1]) == total


@pytest.mark.parametrize("case", DEDUP_CASES)
def test_stage_dedup_edges(case):
    """stage_dedup: duplicate (rid, window) pairs, more unique pairs than
    max_verify, negative windows (they sort as uint32), no valid row,
    duplicates on both sides of a valid prefix's end (the prefix given by
    its count, as match_device_core gives it), windows past 2^31 and near
    2^32, read rows that are no power of two with rids up to the last, one
    row; and kernel L's entries (keys with their digit histograms, one
    stable pass a digit, the compaction) composed, against the same."""
    rid, win, valid, mv, rows, total = dedup_case(case)
    got = tpipe.stage_dedup(rid, win, valid, mv, rows, total)
    want = jpipe.stage_dedup(jnp.asarray(rid.numpy().astype(np.int32)),
                             jnp.asarray(win.numpy().astype(np.uint32)),
                             jnp.asarray(valid.numpy()), rid.shape[0], mv)
    rid_t, win_t, live_t, n_t = (np.asarray(x) for x in got)
    rid_j, win_j, live_j, n_j = (np.asarray(x) for x in want)
    assert int(n_t) == int(n_j)
    _eq(live_t, live_j, "vlive")
    _eq(rid_t, rid_j, "rid_v")
    # the port keeps signed starts; the JAX package wraps them to uint32
    _eq(win_t & 0xFFFFFFFF, win_j, "win_v")
    if case == "past_max_verify":
        assert int(n_t) > mv and live_t.all()
    if case == "negative":
        assert (win_t[live_t] < 0).any()
    if case in ("duplicates", "prefix_dups"):
        assert int(n_t) < int(valid.sum())
    if case == "past_2_31":
        assert (win_t[live_t] >= 1 << 31).any() and (
            win_t[live_t] < 0).any()
    if case == "rows_odd":
        assert rid_t[live_t].max() == rows - 1
    for a, b in zip(dedup_entries(rid, win, valid, mv, rows, total), got):
        assert torch.equal(a, b), case


def test_stage_dedup_rid_bound():
    """A valid row whose rid is at or past the read rows stage_dedup is
    told of (or below 0) raises; an invalid row's rid is not looked at."""
    rid, win, valid, mv, rows, total = dedup_case("rows_odd")
    assert tpipe.dedup_passes(rows) == 5 and tpipe.dedup_passes(32_768) == 6
    assert tpipe.dedup_passes(None) == 8 and tpipe.dedup_passes(1) == 4
    for bad in (rows, rows + 7, -1):
        r = rid.clone()
        r[int(np.flatnonzero(valid.numpy())[3])] = bad
        with pytest.raises(ValueError):
            tpipe.stage_dedup(r, win, valid, mv, rows)
        with pytest.raises(ValueError):
            tpipe.dedup_keys_plain(r, win, valid, mv, torch.empty_like(r),
                                   torch.empty_like(r, dtype=torch.int32),
                                   rows)
    r = rid.clone()
    r[~valid] = rows + 50
    tpipe.stage_dedup(r, win, valid, mv, rows)


def test_stage_windows():
    rng = np.random.default_rng(90)
    n, L, kb = 50, 300, 2
    c_rid = rng.integers(0, 30, n)
    c_estb = rng.integers(-20, 20, n)
    cand = rng.integers(0, n, L)
    pos = rng.integers(0, 1 << 33, L)
    rid, win = tpipe.stage_windows(*(torch.from_numpy(x) for x in
                                     (pos, c_rid, c_estb, cand)), kb)
    _eq(rid, c_rid[cand])
    _eq(win, pos + c_estb[cand] - kb)


@pytest.mark.parametrize("dyn", [False, True])
def test_stage_candidates(dyn):
    """stage_candidates_plain (the candidates' part of kernel K's
    frontier_tail entry) on a frontier of done and not-done lanes and an
    in-text buffer filled past its count, with per-search or per-lane
    (dynamic partitioning) back depths and pivots."""
    rng = np.random.default_rng(91 + dyn)
    jsched = jpipe.compile_cached(jscheme("kuch1", 2), 100, "edit")
    tsched = tpipe.compile_cached(tscheme("kuch1", 2), 100, "edit")
    S, R, C, M = jsched.num_searches, 40, 64, 48
    ranges = rng.integers(0, 1 << 31, (C, 4)).astype(np.int64)
    ranges[:, 1] = ranges[:, 0] + rng.integers(0, 9, C)
    rid = rng.integers(0, R, C)
    sid = rng.integers(0, S, C)
    done = rng.random(C) < 0.5
    itv = np.zeros((M, 4), np.int64)
    itv[:, 0] = rng.integers(0, 1 << 31, M)
    itv[:, 1] = itv[:, 0] + rng.integers(1, 5, M)
    itv[:, 2] = rng.integers(0, R * S, M)
    itv[:, 3] = rng.integers(0, 60, M)
    count = 30
    dyn_np = (dict(t_back=rng.integers(20, 70, R * S).astype(np.int32),
                   pivot=rng.integers(0, 60, R * S).astype(np.int32))
              if dyn else None)
    tres = texec.FrontierResult(
        ranges=torch.from_numpy(ranges), rid=torch.from_numpy(rid),
        sid=torch.from_numpy(sid), ed_lb=None, done=torch.from_numpy(done),
        overflow=None, nodes_visited=None, itv=torch.from_numpy(itv),
        itv_count=torch.tensor(count), searches_started=None, arg_b=None)
    jres = SimpleNamespace(
        ranges=jnp.asarray(ranges.astype(np.uint32)),
        rid=jnp.asarray(rid.astype(np.int32)),
        sid=jnp.asarray(sid.astype(np.int32)), done=jnp.asarray(done),
        itv=jnp.asarray(itv.astype(np.uint32)), itv_count=jnp.int32(count))
    ml = 40
    got = tpipe.stage_candidates_plain(
        tres, texec.device_tables(tsched, "cpu"), S, ml,
        {k: torch.from_numpy(v) for k, v in dyn_np.items()} if dyn else None)
    want = jpipe.stage_candidates(
        jres, jsched, {k: jnp.asarray(v) for k, v in dyn_np.items()}
        if dyn else None)
    assert len(got) == 6
    for a, b, f in zip(got, want, ("c_lo", "c_hi", "c_rid", "c_estb")):
        _eq(a, b, f)
    # the expansion counts of the same launch: the JAX package's total, and
    # the prefix sums of the widths clamped at max_locate + 1
    widths = np.clip(np.asarray(want[1]).astype(np.int64)
                     - np.asarray(want[0]).astype(np.int64), 0, ml + 1)
    _eq(got[4], np.cumsum(widths), "offsets")
    _eq(got[5], jpipe.stage_expand(want[0], want[1], ml)[3], "total")
    if dyn:
        return
    # a deferred tail (run_scheme(defer_tail=True)) on a final frontier
    # with ghosts, moved: stage_tail_candidates runs kernel J's rows and
    # the candidates, whose result the JAX package's stage_candidates
    # takes as it is
    tables = texec.device_tables(tsched, "cpu")
    dres, _ = tail_frontier(rng, C + 40, M + 100, True, R, S, "cpu",
                            bw=tsched.bw, W=int(tsched.W))
    dres.tail.update(final_reg=tables["final_reg"], u_last=tables["u_last"])
    got = tpipe.stage_tail_candidates(dres, tables, S, ml)
    t = dres.tail
    assert int(t["words"][6]) > int(t["words"][0]) >> 32      # ghosts
    want = jpipe.stage_candidates(SimpleNamespace(
        ranges=jnp.asarray(t["state"][0].numpy().astype(np.uint32)),
        rid=jnp.asarray(dres.rid.numpy().astype(np.int32)),
        sid=jnp.asarray(dres.sid.numpy().astype(np.int32)),
        done=jnp.asarray(dres.done.numpy()),
        itv=jnp.asarray(t["itv"][:-1].numpy().astype(np.uint32)),
        itv_count=jnp.int32(int(t["words"][6]))), jsched, None)
    for a, b, f in zip(got, want, ("c_lo", "c_hi", "c_rid", "c_estb")):
        _eq(a, b, f)


def test_kmer_lookup():
    """kmer.lookup (kernel I's seed entry on the card) on windows with and
    without N."""
    from columba_tpu.index.build import build_index_from_codes
    from columba_tpu.index.fmindex import FMIndex as JFMIndex
    from columba_tpu_torch.index.fmindex import FMIndex as TFMIndex

    rng = np.random.default_rng(93)
    g = rng.integers(0, 4, 4000).astype(np.uint8)
    arrays = build_index_from_codes(g)
    jtab = jkmer.build_kmer_table(JFMIndex.from_arrays(arrays), 5)
    ttab = tkmer.build_kmer_table(TFMIndex.from_arrays(arrays, "cpu"), 5)
    chars = rng.integers(0, 4, (7, 9, 5)).astype(np.uint8)
    chars[0, :3, 2] = 4
    got = tkmer.lookup(ttab, torch.from_numpy(chars))
    want = jkmer.lookup(jtab, jnp.asarray(chars.astype(np.int32)))
    _eq(got, want)
    assert (got[0, :3] == 0).all() and (got[..., 1] > got[..., 0]).any()


@pytest.mark.parametrize("case", ["clamp", "ghosts"])
def test_run_scheme_edges(world, case, monkeypatch):  # noqa: F811
    """run_scheme's FrontierResult. "clamp": the in-text buffer clamps at M
    (4,096 rows: the exact prefix drains more lanes than that) and the
    frontier is over its capacity at init (n_alive0 > C). "ghosts": ghosts
    reach the tail (the frontier it reads holds ghost ids) after the
    two-stage band loop's shrink."""
    from tests.test_torch_executor import sample_batch

    rng = np.random.default_rng(94)
    n, capacity = (3000, 512) if case == "clamp" else (150, 2048)
    batch = sample_batch(rng, world["g"], n)
    jsched = jpipe.compile_cached(jscheme("kuch1", 2), 100, "edit", kmer_k=6)
    tsched = tpipe.compile_cached(tscheme("kuch1", 2), 100, "edit", kmer_k=6)
    kw = dict(switchpoint=4, itv_cap=4096, split_step=3,
              capacity2=64 if case == "clamp" else 1024, itv_min_depth=8)
    want = jax.jit(lambda b, tab, tables: jexec.run_scheme(
        world["jfm"], b, jsched, capacity, tab, tables=tables, **kw))(
            jnp.asarray(batch.astype(np.int32)), world["jtab"],
            jpipe.device_tables(jsched))
    seen = []
    tail = texec.frontier_tail

    def spy(state, *a, **k):
        seen.append(int((state[1] < 0).sum()))
        return tail(state, *a, **k)

    monkeypatch.setattr(texec, "frontier_tail", spy)
    got = texec.run_scheme(world["tfm"], torch.from_numpy(batch), tsched,
                           capacity, world["ttab"], **kw)
    for f in FIELDS + ("itv",):
        _eq(getattr(got, f), getattr(want, f), f)
    assert got.ranges.shape[0] == kw["capacity2"]    # the shrink ran
    if case == "clamp":
        assert int(got.itv_count) == got.itv.shape[0]
        assert int(got.searches_started) > capacity
        assert int(got.overflow) > 0
    else:
        assert seen[0] > 0 and int(got.itv_count) < got.itv.shape[0]
    # the tail deferred to kernel K's frontier_tail launch (as
    # match_device_core runs it): the same result, and the candidates of
    # frontier_tail_plain then stage_candidates_plain and of the JAX
    # package's stage_candidates
    S, ml = tsched.num_searches, 4096
    tables = texec.device_tables(tsched, "cpu")
    res = texec.run_scheme(world["tfm"], torch.from_numpy(batch), tsched,
                           capacity, world["ttab"], tables=tables,
                           defer_tail=True, **kw)
    assert res.tail is not None and len(seen) == 1
    cands = tpipe.stage_tail_candidates(res, tables, S, ml)
    for f in FIELDS + ("itv", "arg_b"):
        _eq(getattr(res, f), getattr(got, f), f)
    for a, b in zip(cands, tpipe.stage_candidates_plain(got, tables, S, ml)):
        assert torch.equal(a, b)
    for a, b, f in zip(cands, jpipe.stage_candidates(want, jsched, None),
                       ("c_lo", "c_hi", "c_rid", "c_estb")):
        _eq(a, b, f)


@pytest.fixture(scope="module")
def textless():
    rng = np.random.default_rng(95)
    base = rng.integers(0, 4, 1500).astype(np.uint8)
    haps = [base]
    for _ in range(3):
        h = base.copy()
        snp = rng.random(len(h)) < 0.005
        h[snp] = (h[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
        haps.append(h)
    g = np.concatenate(haps + [rng.integers(0, 4, 1000).astype(np.uint8)])
    ja = jbm.build_bmove_from_codes(g, textless=True)
    ta = tbm.build_bmove_from_codes(g, textless=True)
    return g, jbm.BMoveIndex.from_arrays(ja), tbm.BMoveIndex.from_arrays(
        ta, "cpu")


def test_run_scheme_textless_track_arg(textless):
    """run_scheme on 12-wide textless lanes with track_arg (kernel J reads
    the witness slots into arg_b), with a frontier small enough to
    overflow."""
    from tests.conftest import sample_reads

    g, jb, tb = textless
    rng = np.random.default_rng(96)
    reads = sample_reads(rng, g, num=24, length=60, max_err=2)
    batch = np.concatenate([reads, reads[:, ::-1] ^ 3]).astype(np.uint8)
    sched = jpipe.compile_cached(jscheme("kuch1", 2), 60, "edit", kmer_k=0)
    tsched = tpipe.compile_cached(tscheme("kuch1", 2), 60, "edit")
    cap = 16
    res = jax.jit(lambda ix, rd: jexec.run_scheme(
        ix, rd, sched, cap, None, None, None, 0, 0, 0, 0, 16,
        track_arg=True))(jb, jnp.asarray(batch.astype(np.int32)))
    got = texec.run_scheme(tb, torch.from_numpy(batch), tsched, cap, None,
                           0, 0, 0, 0, itv_min_depth=16, track_arg=True)
    for f in FIELDS + ("itv", "arg_b"):
        _eq(getattr(got, f), getattr(res, f), f)
    assert int(got.overflow) > 0 and (got.arg_b >= 0).any()
