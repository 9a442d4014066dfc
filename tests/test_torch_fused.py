"""The fused band step and the one-launch exact loop, held to the JAX package.

``run_scheme`` of the port (its plain versions, which the kernels equal on
the card) runs beside the JAX package's ``run_scheme`` on the same numpy
inputs, with exact equality on every ``FrontierResult`` field and on the
in-text rows, in the configurations where the fused step's clamps and
orders and the exact loop's drain rules matter: the in-text buffer past M,
frontier overflow with and without the two-stage band loop, the two-stage
exact loop, the crossover at switchpoint 4, the textless pass (overflow and
k = 0), and per-read schedules (masked and unmasked) with overflow and with
lanes whose exact prefix ends before the gate step. Then the plain entries
directly: ``exact_loop_plain`` against the per-step loop it replaces, and
``band_step_compact_plain`` against the three calls it fuses; the checks
the card's wrappers make before a launch, the launches ``run_scheme``
makes, and the bound of a tiny fused step counted by hand.

Indexes are built by the port's own build functions (the JAX package reads
the same arrays), so no native library of the JAX package is compiled
here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columba_tpu.index import bmove as jbm
from columba_tpu.index import kmer as jkmer
from columba_tpu.index.fmindex import FMIndex as JFMIndex
from columba_tpu.search import dynschedule as jdyn
from columba_tpu.search import executor as jexec
from columba_tpu.search import pipeline as jpipe
from columba_tpu.search.scheme import get_scheme as jscheme
from columba_tpu_torch.index import bmove as tbm
from columba_tpu_torch.index import kmer as tkmer
from columba_tpu_torch.index.build import build_index_from_codes
from columba_tpu_torch.index.fmindex import FMIndex as TFMIndex
from columba_tpu_torch.ops import extend
from columba_tpu_torch.search import dynschedule as tdyn
from columba_tpu_torch.search import executor as texec
from columba_tpu_torch.search import pipeline as tpipe
from columba_tpu_torch.search.scheme import get_scheme as tscheme
from columba_tpu_torch.tools import bounds

from tests.test_torch_dynschedule import random_pts
from tests.test_torch_executor import repeat_genome, sample_batch

torch.set_num_threads(1)

FIELDS = ("ranges", "rid", "sid", "ed_lb", "done", "overflow",
          "nodes_visited", "itv_count", "searches_started", "arg_b")


@pytest.fixture(scope="module")
def vanilla():
    rng = np.random.default_rng(71)
    g = repeat_genome(rng)
    arrays = build_index_from_codes(g)
    jfm = JFMIndex.from_arrays(arrays)
    tfm = TFMIndex.from_arrays(arrays, "cpu")
    return dict(g=g, jfm=jfm, tfm=tfm, jtab=jkmer.build_kmer_table(jfm, 6),
                ttab=tkmer.build_kmer_table(tfm, 6))


@pytest.fixture(scope="module")
def rlc():
    """Five near-identical haplotypes of a 3 kbp base and a random tail:
    long BWT runs, ranges that stay wide."""
    rng = np.random.default_rng(72)
    base = rng.integers(0, 4, 3000).astype(np.uint8)
    haps = [base]
    for _ in range(4):
        h = base.copy()
        snp = rng.random(len(h)) < 0.005
        h[snp] = (h[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
        haps.append(h)
    g = np.concatenate(haps + [rng.integers(0, 4, 2000).astype(np.uint8)])
    out = dict(g=g)
    for flavor, tl in (("rlc", False), ("textless", True)):
        arrays = tbm.build_bmove_from_codes(g, textless=tl)
        out[flavor] = (jbm.BMoveIndex.from_arrays(arrays),
                       tbm.BMoveIndex.from_arrays(arrays, "cpu"))
    return out


def assert_same(want, got):
    """Every FrontierResult field and the valid in-text rows equal."""
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(want, f)).astype(np.int64),
            getattr(got, f).numpy().astype(np.int64), err_msg=f)
    n = int(want.itv_count)
    np.testing.assert_array_equal(np.asarray(want.itv)[:n].astype(np.int64),
                                  got.itv[:n].numpy())


def run_both(jidx, tidx, batch, scheme, m, capacity, kmer_k=0, jtab=None,
             ttab=None, **kw):
    """run_scheme of both packages on one uint8 batch; the JAX side under
    jax.jit with its schedule tables as arguments, as its pipeline runs
    it."""
    jsched = jpipe.compile_cached(jscheme(*scheme), m, "edit", kmer_k=kmer_k)
    tsched = tpipe.compile_cached(tscheme(*scheme), m, "edit", kmer_k=kmer_k)
    want = jax.jit(lambda b, tab, tables: jexec.run_scheme(
        jidx, b, jsched, capacity, tab, tables=tables, **kw))(
            jnp.asarray(batch.astype(np.int32)), jtab,
            jpipe.device_tables(jsched))
    got = texec.run_scheme(tidx, torch.from_numpy(batch), tsched, capacity,
                           ttab, **kw)
    assert_same(want, got)
    return got


# ---------------------------------------------------------------------------
# run_scheme against the JAX package
# ---------------------------------------------------------------------------

def test_vanilla_itv_past_m(vanilla):
    """More in-text rows than the buffer's M = 4096: the exact drains fill
    it, and every later row (band steps, ghosts) is dropped with the count
    clamped at M."""
    rng = np.random.default_rng(73)
    batch = sample_batch(rng, vanilla["g"], 2048)
    got = run_both(vanilla["jfm"], vanilla["tfm"], batch, ("kuch1", 2), 100,
                   2048, kmer_k=6, jtab=vanilla["jtab"],
                   ttab=vanilla["ttab"], switchpoint=4, itv_cap=4096,
                   split_step=2, capacity2=1024, itv_min_depth=8)
    assert int(got.itv_count) == 4096 and int(got.nodes_visited) > 0


def test_vanilla_overflow_two_stage_band(vanilla):
    """Frontier overflow at init, at the band steps and at the shrink to
    capacity2 (the two-stage band loop), with the crossover on."""
    rng = np.random.default_rng(74)
    batch = sample_batch(rng, vanilla["g"], 256)
    got = run_both(vanilla["jfm"], vanilla["tfm"], batch, ("kuch1", 2), 100,
                   256, kmer_k=6, jtab=vanilla["jtab"],
                   ttab=vanilla["ttab"], switchpoint=4, itv_cap=4096,
                   split_step=3, capacity2=96, itv_min_depth=16)
    assert int(got.overflow) > 0 and got.ranges.shape[0] == 96


@pytest.mark.parametrize("case", ["overflow", "two_stage_exact",
                                  "crossover"])
def test_rlc(rlc, case):
    """RLC lanes (8 wide, run hints): frontier overflow; the crossover at
    switchpoint 4 with the gate at depth 0, so that exact lanes drain; and
    the two-stage exact loop, whose survivors all fit in ex_cap: it must
    give the single-stage run of the JAX package (whose own two-stage loop
    takes 4-wide lanes only, and which its pipeline never asks of an RLC
    index)."""
    jb, tb = rlc["rlc"]
    rng = np.random.default_rng(75)
    batch = sample_batch(rng, rlc["g"], 24, m=60)
    kw = dict(switchpoint=4, itv_cap=4096, itv_min_depth=16)
    if case == "overflow":
        capacity = 16
    elif case == "two_stage_exact":
        capacity = 1024
    else:
        capacity = 1024
        kw.update(itv_min_depth=0, split_step=2, capacity2=256)
    if case != "two_stage_exact":
        got = run_both(jb, tb, batch, ("kuch1", 2), 60, capacity, **kw)
        assert int(got.itv_count) > 0
        assert (int(got.overflow) > 0) == (case == "overflow")
        return
    jsched = jpipe.compile_cached(jscheme("kuch1", 2), 60, "edit")
    tsched = tpipe.compile_cached(tscheme("kuch1", 2), 60, "edit")
    want = jax.jit(lambda b, tables: jexec.run_scheme(
        jb, b, jsched, capacity, None, tables=tables, **kw))(
            jnp.asarray(batch.astype(np.int32)), jpipe.device_tables(jsched))
    L = len(batch) * tsched.num_searches
    assert 15 < tsched.e_max
    got = texec.run_scheme(tb, torch.from_numpy(batch), tsched, capacity,
                           None, ex_split=15, ex_cap=L - 1, **kw)
    assert_same(want, got)
    assert int(got.itv_count) > 0 and int(got.searches_started) > 0


@pytest.mark.parametrize("k,capacity", [(2, 48), (0, 1024)])
def test_textless(rlc, k, capacity):
    """The textless pass (12-wide lanes, witness slots, track_arg): frontier
    overflow at k = 2, and k = 0, where the exact loop is the whole
    search."""
    jb, tb = rlc["textless"]
    rng = np.random.default_rng(76 + k)
    batch = sample_batch(rng, rlc["g"], 24, m=60, max_err=k)
    got = run_both(jb, tb, batch, ("kuch1", k), 60, capacity,
                   track_arg=True)
    assert bool(got.done.any())
    assert (int(got.overflow) > 0) == (k > 0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", ["overflow", "gate"])
def test_dyn(vanilla, masked, case):
    """Per-read schedules, with a search mask and without: frontier
    overflow; and a gate at depth 40, past the end of the exact prefix of
    many lanes, so that narrow lanes wait and drain at the gate step with
    that step's depth."""
    rng = np.random.default_rng(77)
    batch = sample_batch(rng, vanilla["g"], 48)
    m, k = 100, 2
    jsc, tsc = jscheme("kuch1", k), tscheme("kuch1", k)
    pts = random_pts(rng, len(batch), jsc.num_parts, m, k)
    mask = (rng.random((len(batch), len(jsc.searches))) < 0.6
            if masked else None)
    jsched = jpipe.compile_cached(jsc, m, "edit", kmer_k=0)
    tsched = tpipe.compile_cached(tsc, m, "edit", kmer_k=0)
    jst = jdyn.scheme_static(jsc, m, "edit")
    tst = tdyn.scheme_static(tsc, m, "edit")
    capacity = 16 if case == "overflow" else 2048
    kw = dict(switchpoint=4, itv_cap=4096, split_step=2, capacity2=1024,
              itv_min_depth=16 if case == "overflow" else 41)

    def jrun(b, p_, mk):
        dyn = jdyn.build_tables(jst, p_, b)
        return jexec.run_scheme(vanilla["jfm"], b, jsched, capacity, None,
                                search_mask=mk, dyn=dyn, **kw)

    want = jax.jit(jrun)(jnp.asarray(batch.astype(np.int32)),
                         jnp.asarray(pts),
                         None if mask is None else jnp.asarray(mask))
    tb = torch.from_numpy(batch)
    dyn = tdyn.build_tables(tst, torch.from_numpy(pts), tb)
    got = texec.run_scheme(
        vanilla["tfm"], tb, tsched, capacity, None, dyn=dyn,
        search_mask=None if mask is None else torch.from_numpy(mask), **kw)
    assert_same(want, got)
    if case == "overflow":
        assert int(got.overflow) > 0
    else:
        # lanes whose exact prefix ended before the gate drained at it
        e_len = (dyn["ex_pos"] >= 0).sum(dim=1)
        n = int(got.itv_count)
        rows = got.itv[:n]
        at_gate = rows[:, 3] == dyn["db_ex_steps"][rows[:, 2], 40]
        assert bool((at_gate & (e_len[rows[:, 2]] < 40)).any())


# ---------------------------------------------------------------------------
# the plain entries against what they replace
# ---------------------------------------------------------------------------

def exact_loop_per_step(index, ranges, ids, t_lo, t_hi, reads, tabs,
                        per_lane, gate_t, switchpoint):
    """The exact loop as run_scheme ran it before the loop entry: (E, L)
    step tables materialised for the lanes, one extend_char over all lanes
    per step, and a liveness check before each step."""
    S = tabs[0].shape[0] // reads.shape[0] if per_lane else tabs[0].shape[1]
    idl = ids.long()
    cols = [tab[idl, t_lo:t_hi].t() if per_lane
            else tab[t_lo:t_hi][:, idl % S] for tab in tabs]
    pos_t, dir_t, db_t = cols
    chars_t = reads[(idl // S)[None, :], pos_t.clamp(min=0).long()].int()
    chars_t = torch.where(pos_t >= 0, chars_t, 0)
    drows = torch.zeros((ranges.shape[0], 4), dtype=torch.int64)
    for t in range(pos_t.shape[0]):
        if not bool((ranges[:, 1] > ranges[:, 0]).any()):
            break
        alive = ranges[:, 1] > ranges[:, 0]
        act = (pos_t[t] >= 0) & alive
        new = extend.extend_char_plain(
            index, torch.where(act[:, None], ranges, 0), chars_t[t],
            dir_t[t])
        new = torch.where(act[:, None], new, ranges)
        new = torch.where((new[:, 1] > new[:, 0])[:, None], new, 0)
        if switchpoint > 0:
            width = new[:, 1] - new[:, 0]
            narrow = ((width > 0) & (width <= switchpoint)
                      & (t + t_lo >= gate_t))
            row = torch.stack([new[:, 0], new[:, 1], idl, db_t[t].long()],
                              dim=1)
            drows = torch.where(narrow[:, None], row, drows)
            new = torch.where(narrow[:, None], 0, new)
        ranges = new
    return ranges, drows


@pytest.mark.parametrize("layout", ["static", "compacted", "per_lane"])
def test_exact_loop_plain(vanilla, layout):
    """exact_loop_plain equals the per-step loop on lanes built to meet
    every rule: dead lanes, reads with N, lanes that go narrow before the
    gate step and wait for it (some past the end of their exact prefix),
    lanes that narrow after it, and lanes that stay wide."""
    rng = np.random.default_rng(78)
    m = 100
    reads = torch.from_numpy(sample_batch(rng, vanilla["g"], 64))
    R = reads.shape[0]
    tfm = vanilla["tfm"]
    if layout == "per_lane":
        st = tdyn.scheme_static(tscheme("kuch1", 2), m, "edit")
        pts = torch.from_numpy(random_pts(rng, R, st.num_searches, m, 2))
        dyn = tdyn.build_tables(st, pts, reads)
        tabs = (dyn["ex_pos"], dyn["ex_dir"], dyn["db_ex_steps"])
        S, E = st.num_searches, tabs[0].shape[1]
    else:
        sched = tpipe.compile_cached(tscheme("kuch1", 2), m, "edit")
        tables = texec.device_tables(sched, "cpu")
        tabs = (tables["ex_pos"], tables["ex_dir"], tables["db_ex"])
        S, E = sched.num_searches, sched.e_max
    L = R * S
    ids = torch.arange(L, dtype=torch.int32)
    t_lo = 0
    if layout == "compacted":
        ids = torch.from_numpy(np.sort(rng.choice(L, L // 2, replace=False))
                               .astype(np.int32))
        t_lo = 5
    ranges = tfm.full_range((ids.numel(),)).clone()
    ranges[::7] = 0
    gate = 24
    got = texec.exact_loop_plain(tfm, ranges,
                                 None if layout == "static" else ids, t_lo,
                                 E, reads, tabs, layout == "per_lane", gate,
                                 4)
    want = exact_loop_per_step(tfm, ranges, ids, t_lo, E, reads, tabs,
                               layout == "per_lane", gate, 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    drained = got[1][:, 1] > got[1][:, 0]
    assert bool(drained.any()) and bool((got[0][:, 1] > got[0][:, 0]).any())
    # drains at the gate step with its depth, and at later steps
    db = got[1][drained, 3]
    idl = ids.long()[drained]
    db_gate = (tabs[2][idl, gate] if layout == "per_lane"
               else tabs[2][gate][idl % S])
    assert bool((db == db_gate).any()) and bool((db != db_gate).any())


def compact_three_calls(index, state, n_live, cap, itv, cnt, mrow_t,
                        cells, T, t, switchpoint):
    """The band step as run_scheme ran it before the fused step: the
    per-lane arithmetic over every row, the drain append, the compaction."""
    M = itv.shape[0] - 1
    o = texec.band_step_plain(index, *state, mrow_t, cells, T, t,
                              switchpoint)
    cnt_t = torch.tensor(cnt)
    if switchpoint > 0:
        ch = o["ch_ranges"]
        rows = torch.stack([
            ch[..., 0].reshape(-1), ch[..., 1].reshape(-1),
            (o["new_ids"] & texec.GHOST_IDM).long().repeat_interleave(4),
            o["dbv"].long().repeat_interleave(4)], dim=1)
        cnt_t = texec._append(itv, cnt_t, rows, o["narrow"].reshape(-1), M)
    bw, Wp = state[2].shape[-1], state[3].shape[-1]
    new, n = texec._compact(o["ch_alive"].reshape(-1), cap,
                            [o["ch_ranges"].reshape(-1, 4),
                             o["new_ids"].repeat_interleave(4),
                             o["ch_band"].reshape(-1, 2, bw),
                             o["ch_colmin"].reshape(-1, 2, Wp)])
    return new, int(n), int(cnt_t), int(o["act"].sum()) * 4


def frontier(rng, tfm, C, n_live, S, R, bw, W):
    """A frontier of n_live live lanes (ranges from 6-mer windows of a
    genome with repeats, some ghosts) and empty rows past them."""
    lo = rng.integers(0, tfm.n - 40, C)
    ranges = torch.from_numpy(np.stack(
        [lo, lo + rng.integers(1, 40, C), lo, lo], 1).astype(np.int64))
    ranges[:, 3] = ranges[:, 2] + ranges[:, 1] - ranges[:, 0]
    ids = rng.integers(0, R * S, C).astype(np.int64)
    ghost = rng.random(C) < 0.1
    ids = np.where(ghost, ids | (rng.integers(0, 1024, C) << 21) | (1 << 31),
                   ids).astype(np.uint32).view(np.int32)
    state = [ranges, torch.from_numpy(ids),
             torch.from_numpy(rng.integers(0, 4, (C, 2, bw)).astype(np.int8)),
             torch.from_numpy(rng.integers(0, 3, (C, 2, W)).astype(np.int8))]
    for f in state:
        f[n_live:] = 0
    return state


def random_cells(rng, R, S, T, bw, m=100, codes=(0, 0, 0, 0, 0, -1)):
    """Random static cells: reads of chars 0-4 (N included) and random
    (S, T, BW) cell tables, positions < m and codes drawn from ``codes``
    (0: the read's char, -1: no diagonal, -2: outside the pattern). The
    default makes every cell value of -1..4 equally likely, as a uniform
    random per-lane code array of those values."""
    posw = rng.integers(0, m, (S, T, bw))
    code = rng.choice(codes, (S, T, bw)).astype(np.int8)
    return texec.StaticCells(
        torch.from_numpy(rng.integers(0, 5, (R, m)).astype(np.uint8)),
        torch.from_numpy(texec.cell_table(posw, code)))


def test_static_cells_rule():
    """The cells a static step reads at use (executor.step_cells) equal the
    JAX package's gathered (R * S * T, BW) array at every lane and step
    (columba_tpu/search/executor.py: reads[:, posw], the codes where they
    are not 0)."""
    rng = np.random.default_rng(78)
    R, S, T, bw, m = 12, 3, 9, 5, 40
    reads = rng.integers(0, 5, (R, m)).astype(np.uint8)
    posw = rng.integers(0, m, (S, T, bw))
    code = rng.choice((0, 0, -1, -2), (S, T, bw)).astype(np.int8)
    cells = texec.StaticCells(torch.from_numpy(reads), torch.from_numpy(
        texec.cell_table(posw, code)))
    want = reads.astype(np.int8)[:, posw]
    want = np.where(code[None] == 0, want, code[None]).reshape(-1, bw)
    ids = torch.arange(R * S)
    for t in range(T):
        got = texec.step_cells(cells, ids, T, t)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want[ids.numpy() * T + t])
    assert set(np.unique(want)) == {-2, -1, 0, 1, 2, 3, 4}


@pytest.mark.parametrize("cap,M,cnt", [(4096, 8192, 0), (300, 8192, 10),
                                       (4096, 200, 150)])
def test_band_step_compact_plain(vanilla, cap, M, cnt):
    """band_step_compact_plain over the live lanes equals the three calls
    over the whole frontier: the next frontier (all cap rows, zero past the
    kept children), the in-text buffer, the counters; with room to spare,
    with the frontier overflowing and with the in-text buffer past M."""
    rng = np.random.default_rng(79 + cap)
    tfm = vanilla["tfm"]
    sched = tpipe.compile_cached(tscheme("kuch1", 2), 100, "edit", kmer_k=6)
    tables = texec.device_tables(sched, "cpu")
    S, T, bw, W = sched.num_searches, sched.t_max, sched.bw, sched.W
    R, C, n_live, t = 1024, 2048, 1500, 30
    state = frontier(rng, tfm, C, n_live, S, R, bw, W)
    cells = random_cells(rng, R, S, T, bw)
    itv = torch.zeros((M + 1, 4), dtype=torch.int64)
    itv[:cnt] = 7
    itv_want = itv.clone()
    new, n, cnt_new, visits = compact_three_calls(
        tfm, state, n_live, cap, itv_want, cnt, tables["mrow"][t], cells,
        T, t, 12)
    out = [torch.full((cap, *f.shape[1:]), 9, dtype=f.dtype) for f in state]
    sc = texec.StepScratch(C, "cpu")
    sc.ctr[2] = 3
    texec.band_step_compact_plain(tfm, state, n_live, out, itv, cnt, sc,
                                  tables["mrow"][t], cells, T, t, 12)
    for a, b in zip(out, new):
        assert torch.equal(a, b)
    assert torch.equal(itv[:M], itv_want[:M])         # row M is scratch
    assert sc.word() == (n, cnt_new)
    assert int(sc.ctr[1]) == visits and int(sc.ctr[2]) == 3 + max(n - cap, 0)
    assert n > 0 and cnt_new > cnt
    if cap < 4096:
        assert n > cap
    if M < 8192:
        assert cnt_new == M


# ---------------------------------------------------------------------------
# the wrappers' checks, the launches per run, the bound
# ---------------------------------------------------------------------------

def _band_call(vanilla):
    rng = np.random.default_rng(80)
    sched = tpipe.compile_cached(tscheme("kuch1", 2), 100, "edit", kmer_k=6)
    tables = texec.device_tables(sched, "cpu")
    S, T, bw, W = sched.num_searches, sched.t_max, sched.bw, sched.W
    state = frontier(rng, vanilla["tfm"], 256, 200, S, 64, bw, W)
    out = [torch.empty_like(f) for f in state]
    itv = torch.zeros((4097, 4), dtype=torch.int64)
    cells = texec.StaticCells(torch.zeros((64, 100), dtype=torch.uint8),
                              tables["cells"])
    return (vanilla["tfm"], state, 200, out, itv,
            texec.StepScratch(256, "cpu"), tables["mrow"][3], cells)


def test_band_step_checks(vanilla):
    """Kernel B's pre-launch checks pass a well-formed call and refuse an
    output that aliases an input, or the ranges of another dtype."""
    args = _band_call(vanilla)
    assert texec.check_band_step(*args) == (2, 2)
    index, state, n, out, itv, sc, mrow, cells = args
    with pytest.raises(ValueError, match="overlaps"):
        texec.check_band_step(index, state, n, [state[0]] + out[1:], itv,
                              sc, mrow, cells)
    with pytest.raises(ValueError, match="overlaps"):       # itv = ranges
        texec.check_band_step(index, state, n, out, state[0], sc, mrow,
                              cells)
    bad = [state[0].int()] + state[1:]
    with pytest.raises(ValueError, match="contiguous"):
        texec.check_band_step(index, bad, n, out, itv, sc, mrow, cells)
    with pytest.raises(ValueError, match="live lanes"):
        texec.check_band_step(index, state, 0, out, itv, sc, mrow, cells)


def test_exact_loop_checks(vanilla):
    """Kernel A's loop checks pass the executor's tables and refuse int64
    tables and steps past them."""
    sched = tpipe.compile_cached(tscheme("kuch1", 2), 100, "edit")
    tables = texec.device_tables(sched, "cpu")
    tabs = (tables["ex_pos"], tables["ex_dir"], tables["db_ex"])
    reads = torch.zeros((8, 100), dtype=torch.uint8)
    L = 8 * sched.num_searches
    ranges = vanilla["tfm"].full_range((L,))
    assert texec.check_exact_loop(vanilla["tfm"], ranges, None, 0,
                                  sched.e_max, reads, tabs, False) == (
        sched.num_searches, sched.e_max)
    with pytest.raises(ValueError, match="contiguous"):
        texec.check_exact_loop(vanilla["tfm"], ranges, None, 0, sched.e_max,
                               reads, (tabs[0].long(), *tabs[1:]), False)
    with pytest.raises(ValueError, match="steps"):
        texec.check_exact_loop(vanilla["tfm"], ranges, None, 0,
                               sched.e_max + 1, reads, tabs, False)


@pytest.mark.parametrize("ex_split,loops", [(0, 1), (4, 2)])
def test_launches_per_run(vanilla, monkeypatch, ex_split, loops):
    """run_scheme walks its exact prefix in one exact_loop call (one launch
    on the card), two with the two-stage loop, and takes one fused band
    step per step until no lane is live."""
    calls = {"loop": 0, "band": 0}
    loop, band = texec.exact_loop, texec.band_step_compact

    def count_loop(*a, **kw):
        calls["loop"] += 1
        return loop(*a, **kw)

    def count_band(*a, **kw):
        calls["band"] += 1
        return band(*a, **kw)

    monkeypatch.setattr(texec, "exact_loop", count_loop)
    monkeypatch.setattr(texec, "band_step_compact", count_band)
    rng = np.random.default_rng(81)
    batch = torch.from_numpy(sample_batch(rng, vanilla["g"], 32))
    sched = tpipe.compile_cached(tscheme("kuch1", 2), 100, "edit", kmer_k=6)
    res = texec.run_scheme(vanilla["tfm"], batch, sched, 1024,
                           vanilla["ttab"], 0, ex_split=ex_split, ex_cap=64)
    assert calls["loop"] == loops
    assert 0 < calls["band"] <= sched.t_max
    assert int(res.nodes_visited) > 0


def test_static_steps_read_cells_at_use(vanilla, monkeypatch):
    """On a static schedule run_scheme's seed returns the lanes' ranges
    alone (no (L * T, BW) cell array) and every band step takes the batch
    and the schedule's cell tables as StaticCells; under per-read
    schedules the steps take kernel G's per-lane codes."""
    seeds, cells = [], []
    seed, band = texec.frontier_seed, texec.band_step_compact

    def spy_seed(*a, **kw):
        out = seed(*a, **kw)
        seeds.append(out)
        return out

    def spy_band(*a, **kw):
        cells.append(a[8])
        return band(*a, **kw)

    monkeypatch.setattr(texec, "frontier_seed", spy_seed)
    monkeypatch.setattr(texec, "band_step_compact", spy_band)
    rng = np.random.default_rng(82)
    batch = torch.from_numpy(sample_batch(rng, vanilla["g"], 32))
    sched = tpipe.compile_cached(tscheme("kuch1", 2), 100, "edit", kmer_k=6)
    tables = texec.device_tables(sched, "cpu")
    texec.run_scheme(vanilla["tfm"], batch, sched, 1024, vanilla["ttab"], 0,
                     tables=tables)
    L = batch.shape[0] * sched.num_searches
    assert len(seeds) == 1 and isinstance(seeds[0], torch.Tensor)
    assert tuple(seeds[0].shape) == (L, 4)
    assert cells and all(isinstance(c, texec.StaticCells) for c in cells)
    assert all(c.reads is batch and c.cells is tables["cells"]
               for c in cells)
    cells.clear()
    st = tdyn.scheme_static(tscheme("kuch1", 2), 100, "edit")
    dyn = tdyn.build_tables(st, tdyn.dynamic_partition(
        vanilla["tfm"], batch, tscheme("kuch1", 2)), batch)
    texec.run_scheme(vanilla["tfm"], batch, sched, 1024, dyn=dyn)
    assert cells and all(c is dyn["pchars"] for c in cells)


def test_band_step_bound_by_hand():
    """The fused step's bytes on a two-lane frontier, counted by hand: one
    active lane keeps two children and drains one, the other is a ghost
    passed through."""
    C, bw, W = 2, 5, 2
    state = [torch.tensor([[0, 9, 0, 9], [3, 5, 3, 5]], dtype=torch.int64),
             torch.tensor([1, -(1 << 31)], dtype=torch.int32),
             torch.zeros((C, 2, bw), dtype=torch.int8),
             torch.zeros((C, 2, W), dtype=torch.int8)]
    mrow = torch.zeros((3, 7), dtype=torch.int32)
    o = dict(act=torch.tensor([True, False]),
             ch_alive=torch.tensor([[True, False, True, False],
                                    [True, False, False, False]]),
             narrow=torch.tensor([[False, True, False, False],
                                  [False] * 4]))
    b = bounds.band_step(state, mrow, o, cap=16, M=64, cnt=0)
    lane = 4 * 8 + 4                              # range and id
    cells = 2 * bw + 2 * W                        # band and registers
    want = (2 * lane + 2 * cells + 3 * 7 * 4      # lanes, the (S, 7) row
            + 3 * bw * 4                          # the step's cell table
            + (2 * 48 + bw)                       # active: occ rows, chars
            + 3 * (lane + cells)                  # three children kept
            + 32 + 32)                            # one drain row, counters
    assert b["bytes"] == want
    # a capacity of one row writes one child; M = 0 drains nothing
    b1 = bounds.band_step(state, mrow, o, cap=1, M=0, cnt=0)
    assert b1["bytes"] == want - 2 * (lane + cells) - 32


@pytest.mark.parametrize("per_lane", [False, True])
def test_exact_loop_bound_by_hand(per_lane):
    """Kernel A's loop bytes on three lanes that extend five times in all
    and drain once, counted by hand: lanes in and out, the drain rows, two
    occ rows and a code per extension, and the (E, S) tables once, or per
    read the position and direction of each extension and the depth of the
    drain."""
    ranges = torch.zeros((3, 4), dtype=torch.int64)
    drows = torch.tensor([[4, 6, 1, 9], [0] * 4, [0] * 4])
    tabs = [torch.zeros((2, 3), dtype=torch.int32)] * 3
    b = bounds.exact_loop(ranges, None, tabs, per_lane, {"steps": 5},
                          ranges.clone(), drows)
    lanes = 3 * 32 + 3 * 32 + 3 * 32              # in, out, drain rows
    tables = 5 * 8 + 4 if per_lane else 3 * 24
    assert b["bytes"] == lanes + 5 * (2 * 48 + 1) + tables


@pytest.mark.parametrize("per_char", [False, True])
def test_extend_rlc_bound_by_hand(per_char):
    """Kernel A's per-step RLC bytes on four 8-wide lanes, counted by hand:
    lanes, directions, chars in and children out; endpoint rows only for
    the lanes that extend (a dead lane never, an N lane not for
    extend_char); the walks' 4 B reads."""
    ranges = torch.tensor([[2, 7] + [0] * 6, [0] * 8, [1, 3] + [0] * 6,
                           [4, 5] + [0] * 6], dtype=torch.int64)
    dirs = torch.zeros(4, dtype=torch.int32)
    chars = torch.tensor([0, 1, 4, 3], dtype=torch.int32) if per_char \
        else None
    out = torch.zeros((4, 8) if per_char else (4, 4, 8), dtype=torch.int64)
    stats = {"walk": 10, "probes": 3, "hint_rows": 4}
    b = bounds.extend_rlc(ranges, dirs, chars, out, stats)
    lanes_io = 4 * 64 + 4 * 4 + (4 * 4 if per_char else 0) + out.numel() * 8
    extending = 2 if per_char else 3
    assert b["bytes"] == (lanes_io + extending * 2 * bounds.BM_ROW_BYTES
                          + (10 + 3 + 4) * 4)


@pytest.mark.parametrize("live", [None, 1000, 40, 0])
def test_verify_bound_by_hand(live):
    """Kernel D's bound on 1,000 slots of m 100 at kb 2, counted by hand:
    per live slot its read id and window start (16 B), the window's 107
    codes at 2 bits each (27 B), 100 read bytes, 100 rows of one 32-bit
    band word and the 9 cells of the final row; the dead slots (read 0,
    window 0) need one DP between them; every slot's row out. At kb 13 the
    band is two words, and at kb 0 a row is two plane compares."""
    B, m, kb = 1000, 100, 2
    pats = torch.zeros((4, m), dtype=torch.uint8)
    rid = torch.zeros(B, dtype=torch.int64)
    out = torch.zeros((B, 4 * kb + 1), dtype=torch.int32)
    b = bounds.verify(pats, rid, rid, kb, out, live)
    dps = B if live in (None, B) else live + 1
    assert b["bytes"] == dps * (16 + 27 + m) + B * 9 * 4
    assert b["operations"] == dps * (m * bounds.VERIFY_ROW_OPS + 9 * 4)
    wide = bounds.verify(pats, rid, rid, 13, torch.zeros((B, 53)), live)
    assert wide["operations"] == dps * (m * 2 * bounds.VERIFY_ROW_OPS
                                        + 53 * 4)
    kb0 = bounds.verify(pats, rid, rid, 0, torch.zeros((B, 1)), live)
    assert kb0["operations"] == dps * (m * bounds.VERIFY_KB0_OPS + 4)


@pytest.mark.parametrize("case", ["runs", "none_valid"])
def test_expand_rows_bound_by_hand(case):
    """Kernel K's ``rows`` bound counts what the function needs: every
    candidate's prefix sum (8 B), the lo (8 B) of each candidate that owns
    a valid row, once however many rows it owns, and 17 B a row out; not
    the lo of the empty candidates between them, which the kernel's
    staging reads."""
    n, ml = 1000, 64
    offsets = torch.zeros(n, dtype=torch.int64)
    cand = torch.zeros(ml, dtype=torch.int64)
    valid = torch.zeros(ml, dtype=torch.bool)
    if case == "runs":
        # 3 candidates own 40 rows; the rows past them are clipped
        cand[:40] = torch.tensor([7] * 10 + [500] * 20 + [999] * 10)
        cand[40:] = n - 1
        valid[:40] = True
    rows = torch.zeros(ml, dtype=torch.int64)
    b = bounds.entry("expand.rows", {"offsets": offsets}, {},
                     (rows, cand, valid))
    live = 3 if case == "runs" else 0
    assert b["bytes"] == 8 * n + 8 * live + 17 * ml
    assert b["operations"] == ml * (bounds.LANE_OPS + 4 * 11)


def test_bench_steps_a_tree_that_reads_cells_at_use(vanilla, tmp_path):
    """``kernel_bench --parent`` on a tree whose static band steps take
    ``StaticCells`` (here a copy of this tree's package, as in an A/A
    run): the captured cells reach that tree's wrapper in its own class,
    and its step equals this tree's plain version."""
    import os
    import shutil

    from columba_tpu_torch.tools import kernel_bench as kb
    from columba_tpu_torch.tools import path_inputs as pi

    port = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "columba_tpu_torch")
    shutil.copytree(port, tmp_path / "columba_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    mods = kb.load_tree(str(tmp_path))
    assert mods["search.executor"].StaticCells is not texec.StaticCells
    rng = np.random.default_rng(81)
    sched = tpipe.compile_cached(tscheme("kuch1", 2), 100, "edit", kmer_k=6)
    batch = torch.from_numpy(rng.integers(0, 5, (64, 100)).astype(np.uint8))
    ranges = vanilla["tfm"].full_range((1024,))
    inp = pi.band_input("band_step", pi.band_args(vanilla["tfm"], sched,
                                                  batch, ranges, rng, 4))
    want = pi.plain_call("band_step", vanilla["tfm"], dict(inp))
    got = kb.tree_launcher(mods)("band_step", dict(inp))
    assert int(want["ctr"][0]) > 0
    assert pi.equal_band(got, want)
    # on the card the tree's wrapper checks the cells' class first
    ex = mods["search.executor"]
    index, state, n, out, itv, _, mrow, cells = _band_call(vanilla)
    assert ex.check_band_step(index, state, n, out, itv,
                              ex.StepScratch(256, "cpu"), mrow,
                              pi.tree_cells(ex, {"cells": cells})) == (2, 2)
