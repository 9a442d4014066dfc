"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
neither JAX nor the test conftest's helpers, so on a machine without JAX it
runs with ``python -m pytest --noconftest -o addopts="" -m cuda
tests/test_torch_kernels.py``. All kernel arithmetic is integer: each
kernel must equal its plain version exactly.
"""

import numpy as np
import pytest
import torch

from columba_tpu_torch.core import alphabet
from columba_tpu_torch.index import kmer
from columba_tpu_torch.index.build import build_index_from_codes
from columba_tpu_torch.index.fmindex import FMIndex
from columba_tpu_torch.ops import extend, locate, verify
from columba_tpu_torch.ops.frontier import WIDE_TILE
from columba_tpu_torch.search import dynschedule, executor, pipeline
from columba_tpu_torch.search.scheme import get_multi_scheme, get_scheme
from columba_tpu_torch.tools import edges, gather_bench

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def setup(gpu):
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 50000).astype(np.uint8)
    g[20000:22000] = g[30000:32000]           # a repeat keeps ranges wide
    arrays = build_index_from_codes(g, sa_sparseness=4)
    return (g, FMIndex.from_arrays(arrays, "cpu"),
            FMIndex.from_arrays(arrays, gpu))


def _ranges(rng, n, L):
    lo = rng.integers(0, n + 2, L)
    hi = np.minimum(lo + rng.integers(0, 64, L), n + 1)
    rlo = rng.integers(0, n + 2, L)
    rhi = np.minimum(rlo + (hi - lo), n + 1)
    hi = lo + (rhi - rlo)
    return torch.from_numpy(np.stack([lo, hi, rlo, rhi], 1).astype(np.int64))


def test_extend_kernel(setup, gpu):
    g, cpu_fm, fm = setup
    rng = np.random.default_rng(1)
    L = 10000
    r = _ranges(rng, cpu_fm.n, L).to(gpu)
    dirs = torch.from_numpy(rng.integers(0, 2, L).astype(np.int32)).to(gpu)
    chars = torch.from_numpy(rng.integers(-1, 5, L).astype(np.int32)).to(gpu)
    got = extend.extend_all(fm, r, dirs)
    assert torch.equal(got, extend.extend_all_plain(fm, r, dirs))
    got = extend.extend_char(fm, r, chars, dirs)
    assert torch.equal(got, extend.extend_char_plain(fm, r, chars, dirs))
    assert torch.equal(kmer.build_kmer_table(fm, 6).cpu(),
                       kmer.build_kmer_table(cpu_fm, 6))


def test_locate_kernel(setup, gpu):
    _, cpu_fm, fm = setup
    rows = torch.arange(cpu_fm.n + 1, dtype=torch.int64, device=gpu)
    got = locate.locate_rows(fm, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, locate.locate_rows_plain(fm, rows))


@pytest.mark.parametrize("with_n", [False, True])
def test_exact_kernel(setup, gpu, with_n):
    """Kernel E equals m plain extend_char steps on every live row, and
    gives the zero range where those steps end empty."""
    g, cpu_fm, fm = setup
    rng = np.random.default_rng(21)
    m, R = 60, 2048
    starts = rng.integers(0, len(g) - m, R)
    reads = g[starts[:, None] + np.arange(m)].copy()
    miss = rng.random(R) < 0.3                  # rows that stop early
    reads[miss, rng.integers(0, m, int(miss.sum()))] ^= 1
    if with_n:
        reads[::9, rng.integers(0, m)] = 4
    batch = torch.from_numpy(np.concatenate(
        [reads, alphabet.revcomp(reads, axis=-1)])).to(gpu)
    got = extend.exact_match(fm, batch)
    torch.cuda.synchronize()
    want = extend.zero_empty(extend.exact_match_plain(fm, batch))
    assert torch.equal(got, want)
    live = int((got[:, 1] > got[:, 0]).sum())
    assert 0 < live < 2 * R
    assert torch.equal(got.cpu(), extend.exact_match(cpu_fm, batch.cpu()))


# every band radius kernel D takes (a 32-bit band to kb 7, 64-bit above), at
# m 50 and 100, and reads shorter than the band (m < 4kb+1; m < kb too)
@pytest.mark.parametrize("kb,m", [(kb, m) for kb in range(14)
                                  for m in (50, 100)]
                         + [(2, 5), (5, 12), (9, 20), (13, 40), (13, 7)])
def test_verify_kernel(setup, gpu, kb, m):
    """Kernel D equals its plain version: windows before the text start and
    past its end, reads with N (and a byte above 4), and every read at its
    own window with a few errors."""
    g, cpu_fm, fm = setup
    rng = np.random.default_rng(2 + kb + m)
    n, B = cpu_fm.n, 4096
    starts = rng.integers(-kb, n - m, B)
    starts[:8] = np.arange(-kb, 8 - kb)
    starts[8:16] = n - m + rng.integers(-3, 10, 8)
    reads = g[np.clip(starts[:64, None] + kb + np.arange(m), 0, n - 1)]
    for r in reads[16:]:
        e = rng.integers(0, kb + 2)
        r[rng.integers(0, m, e)] = rng.integers(0, 4, e)
    reads[::7, m // 2] = 4
    reads[5, m - 1] = 200
    pats = torch.from_numpy(np.ascontiguousarray(reads)).to(gpu)
    rid = torch.from_numpy(rng.integers(0, 64, B)).to(gpu)
    rid[:64] = torch.arange(64)
    ws = torch.from_numpy(starts.astype(np.int64)).to(gpu)
    got = verify.verify_window(fm, pats, rid, ws, kb)
    want = verify.verify_window_plain(fm, pats, rid, ws, kb)
    assert torch.equal(got, want)
    assert int((want.min(dim=1).values <= kb).sum()) > 0


@pytest.mark.parametrize("kb", [0, 2, 5, 13])
def test_verify_kernel_dead_slots(setup, gpu, kb):
    """With the live count the dedup passes, slots at or past it hold
    (read 0, window 0) and the kernel copies one such row a block: every
    row still equals the plain version's, for a count of 0, inside a block,
    on a block's edge, at and past the capacity."""
    g, cpu_fm, fm = setup
    rng = np.random.default_rng(60 + kb)
    n, m, B = cpu_fm.n, 100, 1000
    starts = rng.integers(-kb, n - m, B)
    reads = g[np.clip(starts[:32, None] + kb + np.arange(m), 0, n - 1)]
    pats = torch.from_numpy(np.ascontiguousarray(reads)).to(gpu)
    for live in (0, 77, 128, 640, B, B + 5):
        keep = np.arange(B) < live
        rid = torch.from_numpy(np.where(keep, rng.integers(0, 32, B),
                                        0)).to(gpu)
        ws = torch.from_numpy(np.where(keep, starts, 0)).to(gpu)
        live_t = torch.tensor(live, dtype=torch.int64, device=gpu)
        got = verify.verify_window(fm, pats, rid, ws, kb, live=live_t)
        assert torch.equal(got, verify.verify_window_plain(fm, pats, rid, ws,
                                                           kb)), live


def _path_rows(index, g, seed, max_locate=1 << 14):
    """The SA rows the path gives kernel C: run_scheme's candidate ranges
    (frontier lanes and in-text rows) flattened into consecutive rows by
    stage_expand, padded with row 0 to the capacity."""
    rng = np.random.default_rng(seed)
    reads = g[rng.integers(0, len(g) - 100, 96)[:, None] + np.arange(100)]
    batch = torch.from_numpy(np.concatenate(
        [reads, alphabet.revcomp(reads, axis=-1)])).to(index.device)
    sched = pipeline.compile_cached(get_scheme("kuch1", 2), 100, "edit")
    itv_cap, ss, c2 = pipeline.crossover_caps(2048, max_locate, 4)
    tables = executor.device_tables(sched, index.device)
    res = executor.run_scheme(index, batch, sched, 2048, None, 4, itv_cap,
                              ss, c2, itv_min_depth=16, tables=tables,
                              defer_tail=True)
    c_lo, _, _, _, offsets, total = pipeline.stage_tail_candidates(
        res, tables, sched.num_searches, max_locate)
    rows, _, _ = pipeline.expand_rows(c_lo, offsets, total, max_locate)
    assert 0 < int(total) < max_locate
    return rows


def test_locate_kernel_path_rows(setup, gpu):
    """Kernel C on the rows the path gives it: whole SA ranges of
    consecutive rows, then row 0 to the capacity."""
    g, cpu_fm, fm = setup
    rows = _path_rows(fm, g, 70)
    got = locate.locate_rows(fm, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, locate.locate_rows_plain(fm, rows))


def fused_vs_plain(index, state, mrow_t, cells, T, t, switchpoint,
                   dyn_meta=None, track_arg=False, cap=None, M=4096, cnt=0,
                   scratch=None):
    """Kernel B's fused step against band_step_compact_plain on the same
    frontier (every row read): the next frontier's live rows, the in-text
    rows (row M is scratch), the word, visits and overflow must be equal,
    and the block ticket back at 0. Returns (kept children, in-text rows)
    of the step."""
    C, dev = state[0].shape[0], state[0].device
    cap = C if cap is None else cap
    res = []
    for fn in (executor.band_step_compact, executor.band_step_compact_plain):
        out = [torch.full((cap, *f.shape[1:]), 3, dtype=f.dtype, device=dev)
               for f in state]
        itv = torch.full((M + 1, 4), -1, dtype=torch.int64, device=dev)
        sc = executor.StepScratch(C, dev)
        if fn is executor.band_step_compact and scratch is not None:
            sc = scratch
        sc.ctr[1] = 5
        sc.ctr[2] = 7
        fn(index, state, C, out, itv, cnt, sc, mrow_t, cells, T, t,
           switchpoint, dyn_meta, track_arg)
        torch.cuda.synchronize()
        res.append((out, itv, sc.ctr.clone()))
    (o1, i1, c1), (o2, i2, c2) = res
    assert torch.equal(c1[:3], c2[:3]) and int(c1[3]) == 0
    n, rows = int(c1[0]) & 0xFFFFFFFF, int(c1[0]) >> 32
    live = min(n, cap)
    for k, (a, b) in enumerate(zip(o1, o2)):
        assert torch.equal(a[:live], b[:live]), k
    assert torch.equal(i1[:M], i2[:M])
    return n, rows


def _random_state(rng, n, C, R, S, bw, Wp, gpu, cells=64):
    """Random lane states: ranges, ids with 10 % ghosts, bands and
    registers."""
    ids = rng.integers(0, R * S, C).astype(np.int64)
    ghost = rng.random(C) < 0.1
    ids = np.where(ghost, ids | (rng.integers(0, 1024, C) << 21) | (1 << 31),
                   ids).astype(np.uint32).view(np.int32)
    return [
        _ranges(rng, n, C).to(gpu), torch.from_numpy(ids).to(gpu),
        # half the cells small, so that children survive the prune
        torch.from_numpy(np.where(rng.random((C, 2, bw)) < 0.5,
                                  rng.integers(0, 4, (C, 2, bw)),
                                  rng.integers(0, cells, (C, 2, bw))
                                  ).astype(np.int8)).to(gpu),
        torch.from_numpy(rng.integers(0, 64, (C, 2, Wp)).astype(np.int8)
                         ).to(gpu)]


# cell codes: 0 (the read's char), -1 (no diagonal), -2 (outside the
# pattern), so weighted that every cell value of -2..4 (or -1..4) is as
# likely as in a uniform random per-lane code array
ALL_CODES = (0, 0, 0, 0, 0, -1, -2)
DIAG_CODES = (0, 0, 0, 0, 0, -1)


def _cells(rng, R, S, T, bw, gpu, codes, m=100):
    """Random static cells, read at use by kernel B's static entries:
    reads of chars 0-4 (N included) and random (S, T, BW) cell tables."""
    posw = rng.integers(0, m, (S, T, bw))
    code = rng.choice(codes, (S, T, bw)).astype(np.int8)
    return executor.StaticCells(
        torch.from_numpy(rng.integers(0, 5, (R, m)).astype(np.uint8)).to(gpu),
        torch.from_numpy(executor.cell_table(posw, code)).to(gpu))


@pytest.mark.parametrize("t", [0, 20, 40])
def test_band_step_kernel(setup, gpu, t):
    """Kernel B on random lane states (ghosts, dead lanes, saturated
    cells) equals its plain version on every output: the next frontier,
    the in-text rows, the counters."""
    _, cpu_fm, fm = setup
    rng = np.random.default_rng(11 + t)
    sched = pipeline.compile_cached(get_scheme("kuch1", 2), 100, "edit",
                                    kmer_k=6)
    tables = executor.device_tables(sched, gpu)
    C, R, S, T, bw = 4096, 192, sched.num_searches, sched.t_max, sched.bw
    state = _random_state(rng, cpu_fm.n, C, R, S, bw, sched.W, gpu)
    cells = _cells(rng, R, S, T, bw, gpu, ALL_CODES)
    n, _ = fused_vs_plain(fm, state, tables["mrow"][t], cells, T, t, 4)
    assert n > 0


@pytest.mark.parametrize("flavor", ["vanilla", "rlc", "textless",
                                    "per_lane_rlc"])
def test_band_step_overflow(setup, rlc_setup, gpu, flavor):
    """A step whose kept children overflow the next frontier (n > cap) and
    whose narrow rows overflow the in-text buffer: the clamps, the dropped
    rows and the overflow count equal the plain version's, over three
    launches on one scratch (fresh epochs, the ticket reset between). On
    the RLC index the block that holds row cap stages children past it,
    which its quads must skip; with cap = 256 that block lies deep in the
    grid, so its look-back crosses many tiles."""
    rng = np.random.default_rng(12)
    track = flavor == "textless"
    dyn = None
    if flavor == "vanilla":
        _, cpu_fm, index = setup
        state = _random_state(rng, cpu_fm.n, 4096, 96, 7, 5, 2, gpu, cells=4)
    else:
        _, idx = rlc_setup
        _, cpu_bm, index = idx["rlc" if flavor == "per_lane_rlc"
                               else flavor]
        states = _rlc_states(cpu_bm, rng, 512)
        W = 1 if flavor == "per_lane_rlc" else 2
        state = _random_state(rng, 8, states.shape[0], 96, 7, 5,
                              2 * W if track else W, gpu, cells=4)
        state[0] = states.to(gpu)
    mrow = torch.from_numpy(_random_mrow(rng, 7, 5, 2)).to(gpu)
    mrow[:, 0] |= 1                            # every search active
    mrow[:, 0] &= ~(255 << 10)
    mrow[:, 0] |= 6 << 10                      # a loose bound: most survive
    if flavor == "per_lane_rlc":
        # per-lane words (dynschedule layout): active, a side each, a fresh
        # register on cell 2 (colo + 1 = 3), bound 6, back depth 9
        words = (1 | (rng.integers(0, 2, 96 * 7 * 5) << 1) | (1 << 2)
                 | (3 << 3) | (6 << 9) | (9 << 17))
        dyn = torch.from_numpy(words.astype(np.int32)).to(gpu)
        mrow = None
    if flavor == "per_lane_rlc":              # kernel G's per-lane codes
        cells = torch.from_numpy(rng.integers(-1, 5, (96 * 7 * 5, 5)).astype(
            np.int8)).to(gpu)
    else:
        cells = _cells(rng, 96, 7, 5, 5, gpu, DIAG_CODES)
    scratch = executor.StepScratch(state[0].shape[0], gpu)
    # the scratch's statuses are the stream's scan pool, whose epochs every
    # scanning launch on the stream shares: each launch takes the next one
    first = executor.scan_pool(gpu).epoch
    for rep in range(3):
        n, rows = fused_vs_plain(index, state, mrow, cells, 5, 3, 8, dyn,
                                 track_arg=track, cap=256, M=64, cnt=40,
                                 scratch=scratch)
        assert n > 256 and rows == 64, (n, rows)
    assert scratch.epoch == first + 3


def _random_mrow(rng, S, bw, W):
    """Random per-search step scalars in the layout of
    executor.host_tables: the meta word, then W 7-bit colMin ops
    (cell | reset << 6, cell 63 = idle) and initial values, 4 per word."""
    meta = (rng.integers(0, 2, S) | (rng.integers(0, 2, S) << 1)
            | (rng.choice([*range(W), 15], S) << 2)
            | (rng.choice([*range(W), 15], S) << 6)
            | (rng.integers(0, 8, S) << 10) | (rng.integers(0, 2000, S) << 18))
    words = np.zeros((S, 6), np.int64)
    for w in range(W):
        op = rng.choice([*range(bw), 63], S) | (rng.integers(0, 2, S) << 6)
        ini = rng.integers(0, 128, S)
        words[:, w // 4] |= op << (7 * (w % 4))
        words[:, 3 + w // 4] |= ini << (7 * (w % 4))
    return np.concatenate([meta[:, None], words], axis=1).astype(np.int32)


# kb 0..7 x W 1..2 are templated entries of csrc/band_step.cu; kb 8..13
# with up to executor.QUAD_MAX_W[kb] registers its quad body; the others
# run its generic entry (runtime sizes, up to kb 13 and W 10)
@pytest.mark.parametrize("kb,W", [
    (0, 1), (0, 2), (1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2), (4, 1),
    (4, 2), (2, 3), (5, 2), (7, 5), (13, 10), (0, 10)])
def test_band_step_shapes(setup, gpu, kb, W):
    """Kernel B at every shape a schedule can give, on random lane states
    and random step tables, equals its plain version on every output."""
    _, cpu_fm, fm = setup
    rng = np.random.default_rng(100 * kb + W)
    bw = 2 * kb + 1
    C, R, S, T, t = 2048, 96, 7, 5, 3
    state = _random_state(rng, cpu_fm.n, C, R, S, bw, W, gpu)
    mrow = torch.from_numpy(_random_mrow(rng, S, bw, W)).to(gpu)
    cells = _cells(rng, R, S, T, bw, gpu, ALL_CODES)
    n, _ = fused_vs_plain(fm, state, mrow, cells, T, t,
                          4 if kb % 2 else 0)
    assert n > 0


@pytest.mark.parametrize("kb,W", [(5, 1), (5, 2), (6, 1), (6, 2), (7, 1),
                                  (7, 2)])
def test_band_step_instances(setup, gpu, kb, W):
    """Kernel B's templated instances at kb 5..7 x W 1..2 (the Vanilla
    static entry's) and its generic entry at the same shape, each on the
    same random lane states and step tables, equal the plain version on
    every output, so each other bit for bit; the launch census names the
    instance each took."""
    _, cpu_fm, fm = setup
    rng = np.random.default_rng(300 + 10 * kb + W)
    bw = 2 * kb + 1
    C, R, S, T, t = 2048, 96, 7, 5, 3
    state = _random_state(rng, cpu_fm.n, C, R, S, bw, W, gpu)
    mrow = torch.from_numpy(_random_mrow(rng, S, bw, W)).to(gpu)
    cells = _cells(rng, R, S, T, bw, gpu, ALL_CODES, m=150)
    got = []
    for generic in (False, True):
        executor.KERNEL.reset()
        executor.BAND_GENERIC = generic
        try:
            got.append(fused_vs_plain(fm, state, mrow, cells, T, t,
                                      4 if kb % 2 else 0))
        finally:
            executor.BAND_GENERIC = False
        inst = "generic" if generic else "templated"
        assert executor.KERNEL.by_shape == {f"static kb{kb} W{W} {inst}": 1}
    assert got[0] == got[1] and got[0][0] > 0


def instance_and_generic(step, entry, kb, W):
    """``step()`` (one kernel B launch held to its plain version, returning
    what it kept) through the instance the shape takes (templated, or the
    quad body) and through the forced generic entry
    (``executor.BAND_GENERIC``): both equal the plain version, so each
    other, and the launch census names the body taken."""
    got = []
    for generic in (False, True):
        executor.KERNEL.reset()
        executor.BAND_GENERIC = generic
        try:
            got.append(step())
        finally:
            executor.BAND_GENERIC = False
        name = executor.band_shape("" if entry == "static" else entry, kb, W,
                                   generic)
        assert name.endswith("generic" if generic else
                             ("quad" if kb > 7 else "templated"))
        assert set(executor.KERNEL.by_shape) == {name}
    assert got[0] == got[1]
    return got[0]


# the quad body's shapes (csrc/band_step_wide.cuh): kb 8..13 with the
# registers the shipped schemes' schedules give there, and any fewer
QUAD_SHAPES = [(kb, W) for kb, top in executor.QUAD_MAX_W.items()
               for W in range(1, top + 1)]


@pytest.mark.parametrize("kb,W", QUAD_SHAPES)
def test_band_step_quad(setup, gpu, kb, W):
    """Kernel B's quad body in the Vanilla static entry at every shape it
    takes, and the forced generic entry at the same shape, on the same
    random lane states and step tables (ghosts, dead lanes, saturated
    cells, narrow children), each equal the plain version on every
    output."""
    _, cpu_fm, fm = setup
    rng = np.random.default_rng(500 + 10 * kb + W)
    bw = 2 * kb + 1
    C, R, S, T, t = 4096, 96, 7, 5, 3
    state = _random_state(rng, cpu_fm.n, C, R, S, bw, W, gpu)
    mrow = torch.from_numpy(_random_mrow(rng, S, bw, W)).to(gpu)
    cells = _cells(rng, R, S, T, bw, gpu, ALL_CODES, m=250)
    n, rows = instance_and_generic(
        lambda: fused_vs_plain(fm, state, mrow, cells, T, t,
                               4 if kb % 2 else 0), "static", kb, W)
    assert n > 0 and (rows > 0) == (kb % 2 == 1)


def _random_words(rng, L, bw):
    """Random per-lane schedule words (search/dynschedule.py layout):
    mostly active, either side, a register reset or not on a random cell
    or none (colo + 1 = 0), bounds 0..12, back depths 0..2000."""
    return torch.from_numpy((
        (rng.random(L) < 0.8) | (rng.integers(0, 2, L) << 1)
        | (rng.integers(0, 2, L) << 2) | (rng.integers(0, bw + 1, L) << 3)
        | (rng.integers(0, 13, L) << 9) | (rng.integers(0, 2001, L) << 17)
    ).astype(np.int32))


@pytest.mark.parametrize("kb", sorted(executor.QUAD_MAX_W))
def test_band_step_quad_per_lane(setup, gpu, kb):
    """Kernel B's quad body in the Vanilla per-lane entry (one register)
    at kb 8..13, and the forced generic entry, on random lane states,
    per-lane words and per-lane cell codes, each equal the plain version
    on every output."""
    _, cpu_fm, fm = setup
    rng = np.random.default_rng(600 + kb)
    bw = 2 * kb + 1
    C, R, S, T = 4096, 96, 7, 5
    state = _random_state(rng, cpu_fm.n, C, R, S, bw, 1, gpu)
    words = _random_words(rng, R * S * T, bw).to(gpu)
    codes = torch.from_numpy(rng.integers(-2, 5, (R * S * T, bw)).astype(
        np.int8)).to(gpu)
    kept = 0
    for t in (0, 2, 4):
        n, _ = instance_and_generic(
            lambda: fused_vs_plain(fm, state, None, codes, T, t, 4, words),
            "per_lane", kb, 1)
        kept += n
    assert kept > 0


def test_band_step_quad_overflow(setup, gpu):
    """The quad body at kb 12, W 3 (the columba scheme at 250 bp) on a
    step whose kept children overflow the next frontier and whose narrow
    rows overflow the in-text buffer: the clamps, the dropped rows and the
    overflow count equal the plain version's and the forced generic
    entry's, over three launches on one scratch."""
    _, cpu_fm, fm = setup
    rng = np.random.default_rng(13)
    kb, W, bw = 12, 3, 25
    state = _random_state(rng, cpu_fm.n, 4096, 96, 7, bw, W, gpu, cells=4)
    mrow = torch.from_numpy(_random_mrow(rng, 7, bw, W)).to(gpu)
    mrow[:, 0] |= 1                            # every search active
    mrow[:, 0] &= ~(255 << 10)
    mrow[:, 0] |= 6 << 10                      # a loose bound: most survive
    cells = _cells(rng, 96, 7, 5, bw, gpu, DIAG_CODES, m=250)
    scratch = executor.StepScratch(4096, gpu)
    for rep in range(3):
        n, rows = instance_and_generic(
            lambda: fused_vs_plain(fm, state, mrow, cells, 5, 3, 8,
                                   cap=256, M=64, cnt=40, scratch=scratch),
            "static", kb, W)
        assert n > 256 and rows == 64, (n, rows)


@pytest.mark.parametrize("kmer_k,switchpoint,capacity", [
    (6, 4, 2048), (0, 0, 1024), (6, 0, 256)])
def test_scheme_kernels_vs_plain(setup, gpu, kmer_k, switchpoint, capacity):
    """run_scheme through kernels A and B on the card equals the plain
    versions on the CPU, field by field."""
    g, cpu_fm, fm = setup
    rng = np.random.default_rng(9)
    starts = rng.integers(0, len(g) - 100, 96)
    starts[:4] = [0, 1, len(g) - 100, len(g) - 101]
    reads = g[starts[:, None] + np.arange(100)].copy()
    for r in reads:
        r[rng.integers(0, 100, 2)] = rng.integers(0, 4, 2)
    batch = np.concatenate([reads, alphabet.revcomp(reads, axis=-1)])
    sched = pipeline.compile_cached(get_scheme("kuch1", 2), 100, "edit",
                                    kmer_k=kmer_k)
    itv_cap, ss, c2 = pipeline.crossover_caps(capacity, 4096, switchpoint)
    out = []
    for index in (fm, cpu_fm):
        table = kmer.build_kmer_table(index, kmer_k) if kmer_k else None
        b = torch.from_numpy(batch).to(index.device)
        out.append(executor.run_scheme(
            index, b, sched, capacity, table, switchpoint, itv_cap, ss, c2,
            itv_min_depth=16))
    for f in ("ranges", "rid", "sid", "ed_lb", "done", "overflow",
              "nodes_visited", "itv", "itv_count", "searches_started"):
        assert torch.equal(getattr(out[0], f).cpu(), getattr(out[1], f)), f


def _reads(rng, g, R, m, err):
    starts = rng.integers(0, len(g) - m, R)
    reads = g[starts[:, None] + np.arange(m)].copy()
    for r in reads:
        n = rng.integers(0, err + 1)
        r[rng.integers(0, m, n)] = rng.integers(0, 4, n)
    reads[::17, m // 2] = 4                      # reads with N
    reads[3] = 0                                 # a homopolymer
    return np.concatenate([reads, alphabet.revcomp(reads, axis=-1)])


def test_exact_kernel_lengths(setup, gpu):
    """Kernel E with per-row lengths: each row matches its first `length`
    chars backward; the padding behind them is never read."""
    g, cpu_fm, fm = setup
    rng = np.random.default_rng(22)
    m, B = 40, 4096
    starts = rng.integers(0, len(g) - m, B)
    pats = g[starts[:, None] + np.arange(m)].copy()
    lengths = rng.integers(0, m + 1, B).astype(np.int32)
    lengths[:3] = [0, 1, m]
    pats[rng.random(B) < 0.3, 2] ^= 1
    pats[::11, 1] = 4
    for i, n in enumerate(lengths):
        pats[i, n:] = 5
    tp = torch.from_numpy(pats).to(gpu)
    tl = torch.from_numpy(lengths).to(gpu)
    got = extend.exact_match(fm, tp, tl)
    torch.cuda.synchronize()
    assert torch.equal(got, extend.zero_empty(
        extend.exact_match_plain(fm, tp, tl)))
    live = int((got[:, 1] > got[:, 0]).sum())
    assert 0 < live < B
    # through part_exact_ranges and select_schemes, against the CPU
    batch = _reads(rng, g, 128, 100, 2)
    pts = [0, 30, 71, 100]
    assert torch.equal(
        pipeline.part_exact_ranges(fm, torch.from_numpy(batch).to(gpu),
                                   pts).cpu(),
        pipeline.part_exact_ranges(cpu_fm, torch.from_numpy(batch), pts))
    sets = get_multi_scheme("columba", 2)
    _, mask_g, choice_g = pipeline.select_schemes(
        fm, torch.from_numpy(batch).to(gpu), sets)
    _, mask_c, choice_c = pipeline.select_schemes(
        cpu_fm, torch.from_numpy(batch), sets)
    assert np.array_equal(mask_g, mask_c) and np.array_equal(choice_g,
                                                             choice_c)


@pytest.mark.parametrize("name,k,table_k,m", [
    ("kuch1", 2, 6, 100), ("kuch1", 2, 0, 100), ("kuch1", 4, 6, 100),
    ("kuch1", 4, 6, 40), ("pigeon", 3, 6, 90), ("columba", 13, 0, 150),
    ("pigeon", 15, 0, 100)])
def test_dynpart_kernel(setup, gpu, name, k, table_k, m):
    """Kernel F equals the plain partition scan, boundaries and every column
    of the final part ranges: seeded from the k-mer table and from single
    characters, with kuch_k+1's weights and seed fractions and without,
    and at the largest part counts (p = 15, and 16: kernel F's limit)."""
    g, cpu_fm, fm = setup
    rng = np.random.default_rng(23 + k)
    batch = torch.from_numpy(_reads(rng, g, 256, m, k)).to(gpu)
    table = kmer.build_kmer_table(fm, table_k) if table_k else None
    scheme = get_scheme(name, k)
    p = scheme.num_parts
    out = []
    for fn in (dynschedule.dynamic_partition,
               dynschedule.dynamic_partition_plain):
        rng_out = torch.zeros((batch.shape[0], p, 4), dtype=torch.int64,
                              device=gpu)
        out.append((fn(fm, batch, scheme, table, rng_out), rng_out))
    torch.cuda.synchronize()
    got, want = out[0][0], out[1][0]
    assert torch.equal(got, want)
    assert torch.equal(out[0][1], out[1][1])
    assert len({tuple(r) for r in got.cpu().tolist()}) > 1
    cpu_table = table.cpu() if table is not None else None
    assert torch.equal(got.cpu(), dynschedule.dynamic_partition(
        cpu_fm, batch.cpu(), scheme, cpu_table))


def test_dynpart_kernel_wide_ranges(gpu):
    """Widths above 2^31 / weight: on a low-complexity genome of 60 Mbp the
    single-character seed ranges are about 30 M wide, so kuch1's weights
    at k = 4 (100, 5, 1, 6, 105) wrap the 32-bit product; kernel F must wrap
    as the plain scan does."""
    rng = np.random.default_rng(24)
    g = rng.integers(0, 2, 60_000_000).astype(np.uint8)      # A and C only
    arrays = build_index_from_codes(g, sa_sparseness=64)
    fm = FMIndex.from_arrays(arrays, gpu)
    starts = rng.integers(0, len(g) - 100, 512)
    batch = torch.from_numpy(np.ascontiguousarray(
        g[starts[:, None] + np.arange(100)])).to(gpu)
    scheme = get_scheme("kuch1", 4)
    out = []
    for fn in (dynschedule.dynamic_partition,
               dynschedule.dynamic_partition_plain):
        rng_out = torch.zeros((512, 5, 4), dtype=torch.int64, device=gpu)
        out.append((fn(fm, batch, scheme, None, rng_out), rng_out))
    torch.cuda.synchronize()
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    width = int(fm.counts_host[1] - fm.counts_host[0])
    assert width * scheme.weights[0] >= 1 << 31  # the product does wrap


@pytest.mark.parametrize("name,k,metric,m", [
    ("kuch1", 2, "edit", 100), ("kuch1", 4, "edit", 100),
    ("kuch1", 2, "hamming", 100), ("columba", 5, "edit", 150),
    ("columba", 13, "edit", 250)])
def test_dyn_tables_kernel(setup, gpu, name, k, metric, m):
    """Kernel G equals build_tables_plain on every key, on random boundaries
    that need the clamp and on clamped ones."""
    g, cpu_fm, fm = setup
    rng = np.random.default_rng(25 + k)
    R = 64
    batch = torch.from_numpy(_reads(rng, g, R // 2, m, 2)).to(gpu)
    scheme = get_scheme(name, k)
    st = dynschedule.scheme_static(scheme, m, metric)
    p = scheme.num_parts
    raw = np.sort(rng.integers(0, m + 1, (R, p + 1)), axis=1).astype(np.int32)
    raw[:, 0], raw[:, p] = 0, m
    raw_d = torch.from_numpy(raw).to(gpu)
    clamped = dynschedule.clamp_partition(raw_d, m, st.kb)
    for pts in (raw_d, clamped):
        got = dynschedule.build_tables(st, pts, batch)
        torch.cuda.synchronize()
        want = dynschedule.build_tables_plain(st, pts, batch)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            assert torch.equal(got[key], want[key]), key
    assert bool((got["meta"] & 1).any()) and bool((got["ex_pos"] >= 0).any())


def _largest_folder_scheme():
    """The scheme under ``schemes/`` with the most parts (then the most
    searches), over every k its folder holds. The searches are parsed
    without the losslessness check, which takes minutes at k = 14."""
    import os

    from columba_tpu_torch.search.scheme import parse_scheme_text

    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "schemes")
    best = None
    for name in sorted(os.listdir(root)):
        for k in sorted(os.listdir(os.path.join(root, name))):
            path = os.path.join(root, name, k, "searches.txt")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                try:
                    sc = parse_scheme_text(f.read(), int(k), name)
                except ValueError:
                    continue          # a line both packages refuse
            key = (sc.num_parts, len(sc.searches))
            if best is None or key > best[0]:
                best = (key, sc)
    return best[1]


@pytest.mark.parametrize("case", ["one_read", "ragged_block", "odd_m",
                                  "kb0", "most_parts", "most_parts_kb0",
                                  "three_chunks", "long_reads"])
def test_dyn_tables_kernel_shapes(gpu, case):
    """Kernel G equals build_tables_plain on every key at the shapes its
    warp-a-lane blocks and word-wide pchars stores must handle: one read,
    a lane count that is not a multiple of a block's lanes, odd m (pchars
    runs that start and end inside a 4 B word), kb 0, the largest part
    count of any scheme folder (edit and Hamming), pchars staged in three
    chunks (odd m = 301), and reads too long to stage in shared memory."""
    name, k, m, metric, R = {
        "one_read": ("kuch1", 2, 100, "edit", 1),
        "ragged_block": ("kuch1", 2, 100, "edit", 5),
        "odd_m": ("kuch1", 4, 101, "edit", 37),
        "kb0": ("kuch1", 2, 99, "hamming", 29),
        "most_parts": (None, 0, 451, "edit", 7),
        "most_parts_kb0": (None, 0, 97, "hamming", 7),
        "three_chunks": ("kuch1", 2, 301, "edit", 9),
        "long_reads": ("kuch1", 2, 1601, "edit", 5),
    }[case]
    scheme = _largest_folder_scheme() if name is None else get_scheme(name, k)
    st = dynschedule.scheme_static(scheme, m, metric)
    p = scheme.num_parts
    if case.startswith("most_parts"):
        assert p >= 15 and p <= dynschedule.MAX_PARTS
    rng = np.random.default_rng(31)
    reads = torch.from_numpy(rng.integers(0, 5, (R, m)).astype(
        np.uint8)).to(gpu)
    raw = np.sort(rng.integers(0, m + 1, (R, p + 1)), axis=1).astype(np.int32)
    raw[:, 0], raw[:, p] = 0, m
    raw_d = torch.from_numpy(raw).to(gpu)
    for pts in (raw_d, dynschedule.clamp_partition(raw_d, m, st.kb)):
        got = dynschedule.build_tables(st, pts, reads)
        torch.cuda.synchronize()
        want = dynschedule.build_tables_plain(st, pts, reads)
        assert set(got) == set(want)
        for key in want:
            assert got[key].dtype == want[key].dtype, key
            assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("k,metric", [(0, "edit"), (1, "edit"), (2, "edit"),
                                      (3, "edit"), (4, "edit"), (5, "edit"),
                                      (6, "edit"), (7, "edit"),
                                      (2, "hamming")])
def test_band_step_per_lane(setup, gpu, k, metric):
    """Kernel B's per-lane entry (kb 0..7 templated) on kernel G's tables
    and random lane states equals band_step_compact_plain with the same
    switch, at steps where searches idle, reset and accumulate; at kb 5..7
    (-p dynamic on 150 bp reads) its forced generic entry too."""
    g, cpu_fm, fm = setup
    rng = np.random.default_rng(26 + k)
    m, R = 100, 128
    scheme = get_scheme("columba" if k > 4 else "kuch1", max(k, 1))
    st = dynschedule.scheme_static(scheme, m, metric if k else "hamming")
    batch = torch.from_numpy(_reads(rng, g, R // 2, m, 2)).to(gpu)
    table = kmer.build_kmer_table(fm, 6)
    pts = dynschedule.dynamic_partition(fm, batch, scheme, table)
    dyn = dynschedule.build_tables(st, pts, batch)
    S, T, bw = st.num_searches, st.t_max, 2 * st.kb + 1
    state = _random_state(rng, cpu_fm.n, 4096, R, S, bw, 1, gpu)
    kept = 0
    for t in (0, T // 3, T // 2, T - 20, T - 1):
        def step():
            return fused_vs_plain(fm, state, None, dyn["pchars"], T, t,
                                  4 if k % 2 else 0, dyn["meta"].reshape(-1))
        n, _ = (instance_and_generic(step, "per_lane", k, 1) if k >= 5
                else step())
        kept += n
    assert kept > 0


@pytest.mark.parametrize("masked", [False, True])
def test_dyn_scheme_kernels_vs_plain(setup, gpu, masked):
    """match_all with dynamic partitioning (kernels F, G, A, B per-lane, C,
    D) and with a scheme list (kernel E with lengths, the search mask) on
    the card equals the plain versions on the CPU."""
    g, cpu_fm, fm = setup
    rng = np.random.default_rng(27)
    reads = _reads(rng, g, 96, 100, 2)[:96]
    scheme = (get_multi_scheme("columba", 2) if masked
              else get_scheme("kuch1", 2))
    out = []
    for index in (fm, cpu_fm):
        table = kmer.build_kmer_table(index, 6)
        out.append(pipeline.match_all(index, reads, scheme, kmer_table=table,
                                      partitioning="dynamic", switchpoint=4))
    assert out[0][1] == out[1][1]
    for f in ("read_id", "strand", "begin", "end", "distance"):
        assert np.array_equal(getattr(out[0][0], f), getattr(out[1][0], f)), f
    assert len(out[0][0]) >= 96


def loop_vs_plain(index, ranges, ids, t_lo, t_hi, reads, tabs, per_lane,
                  gate_t, switchpoint):
    """Kernel A's loop entry against exact_loop_plain: final ranges and
    drain rows equal. Returns them."""
    got = executor.exact_loop(index, ranges, ids, t_lo, t_hi, reads, tabs,
                              per_lane, gate_t, switchpoint)
    torch.cuda.synchronize()
    want = executor.exact_loop_plain(index, ranges, ids, t_lo, t_hi, reads,
                                     tabs, per_lane, gate_t, switchpoint)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got


@pytest.mark.parametrize("shape", ["static", "two_stage", "dyn"])
def test_exact_loop_kernel(setup, gpu, shape):
    """Kernel A's loop entry on the Vanilla index: a static schedule's
    (E, S) tables from the full range, the second stage of the two-stage
    loop (compacted lanes with their own ids, steps from 8), and per-read
    tables; narrow lanes drain past the gate step, dead lanes stay zero."""
    g, cpu_fm, fm = setup
    rng = np.random.default_rng(29)
    m = 100
    batch = torch.from_numpy(_reads(rng, g, 128, m, 2)).to(gpu)
    R = batch.shape[0]
    if shape == "dyn":
        scheme = get_scheme("kuch1", 2)
        st = dynschedule.scheme_static(scheme, m, "edit")
        pts = dynschedule.dynamic_partition(fm, batch, scheme, None)
        dyn = dynschedule.build_tables(st, pts, batch)
        tabs = (dyn["ex_pos"], dyn["ex_dir"], dyn["db_ex_steps"])
        S = st.num_searches
    else:
        sched = pipeline.compile_cached(get_scheme("kuch1", 2), m, "edit",
                                        kmer_k=0)
        tables = executor.device_tables(sched, gpu)
        tabs = (tables["ex_pos"], tables["ex_dir"], tables["db_ex"])
        S = sched.num_searches
    L = R * S
    ranges = fm.full_range((L,)).clone()
    ranges[::13] = 0                              # lanes that start dead
    E = tabs[0].shape[1] if shape == "dyn" else tabs[0].shape[0]
    ids, t_lo = None, 0
    if shape == "two_stage":
        ids = torch.from_numpy(np.sort(rng.choice(L, L // 3, replace=False))
                               .astype(np.int32)).to(gpu)
        ranges, _ = executor.exact_loop_plain(
            fm, ranges[ids.long()], ids, 0, 8, batch, tabs, False, 10, 4)
        t_lo = 8
    _, drows = loop_vs_plain(fm, ranges, ids, t_lo, E, batch, tabs,
                             shape == "dyn", 10, 4)
    assert bool((drows[:, 1] > drows[:, 0]).any())
    # without the crossover the lanes of exact read stretches stay live
    out, drows = loop_vs_plain(fm, ranges, ids, t_lo, E, batch, tabs,
                               shape == "dyn", 10, 0)
    assert bool((out[:, 1] > out[:, 0]).any()) and not bool(drows.any())


def test_exact_loop_launches(setup, gpu):
    """run_scheme's exact prefix is one launch of kernel A's loop entry, or
    two with the two-stage loop, and kernel B launches once per band
    step; no extend_char launch."""
    g, cpu_fm, fm = setup
    rng = np.random.default_rng(30)
    batch = torch.from_numpy(_reads(rng, g, 96, 100, 2)).to(gpu)
    sched = pipeline.compile_cached(get_scheme("kuch1", 2), 100, "edit",
                                    kmer_k=6)
    table = kmer.build_kmer_table(fm, 6)
    for ex_split, loops in ((0, 1), (4, 2)):
        for k in (extend.KERNEL, executor.KERNEL):
            k.reset()
        executor.run_scheme(fm, batch, sched, 2048, table, 0,
                            ex_split=ex_split, ex_cap=256)
        torch.cuda.synchronize()
        assert extend.KERNEL.by_entry == {"loop": loops}
        assert extend.KERNEL.launches == loops
        assert 0 < executor.KERNEL.launches <= sched.t_max


def test_sharded_match_vs_plain(setup, gpu):
    """dist.mesh.sharded_match over 2 shards on the card (kernels A-D in
    each shard) equals the same call on the CPU's plain versions: every
    array slot for slot, and the six counters."""
    from columba_tpu_torch.dist import mesh as dmesh

    g, cpu_fm, fm = setup
    rng = np.random.default_rng(31)
    # both strands of 32 reads a shard, as ranks feed them
    rows = np.concatenate([_reads(rng, g, 32, 100, 2) for _ in range(2)])
    sched = pipeline.compile_cached(get_scheme("kuch1", 2), 100, "edit",
                                    kmer_k=6)
    for k in (extend.KERNEL, locate.KERNEL, verify.KERNEL):
        k.reset()
    out = [dmesh.sharded_match(
        dmesh.make_data_mesh(2, index.device), index,
        torch.from_numpy(rows).to(index.device), sched, 1024, 4096, 2,
        kmer_table=kmer.build_kmer_table(index, 6), switchpoint=4)
        for index in (fm, cpu_fm)]
    for f in dmesh.ARRAYS:
        assert torch.equal(out[0][f].cpu(), out[1][f]), f
    for f in dmesh.COUNTERS:
        assert int(out[0][f]) == int(out[1][f]), f
    assert int(out[1]["overflow"]) == 0 and bool(out[1]["valid"].any())
    assert bool((out[1]["rid"][out[1]["valid"]] >= len(rows) // 2).any())
    for k in (extend.KERNEL, locate.KERNEL, verify.KERNEL):
        assert k.launches >= 2, k.name


@pytest.mark.parametrize("words", [4, 8, 16])
def test_gather_kernel(gpu, words):
    """Kernel H equals table[idx] for rows of 16, 32 and 64 B; indices past
    the table clamp."""
    rng = np.random.default_rng(28)
    table = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (5000, words),
                                          dtype=np.int64).astype(np.int32)
                             ).to(gpu)
    idx = torch.from_numpy(rng.integers(0, 5000, 10001)).to(gpu)
    idx[:3] = torch.tensor([0, 4999, 7000], device=gpu)
    got = gather_bench.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, gather_bench.gather_rows_plain(table, idx))
    assert torch.equal(got.cpu(), gather_bench.gather_rows(table.cpu(),
                                                           idx.cpu()))


@pytest.mark.parametrize("words", [4, 8, 16])
@pytest.mark.parametrize("n", [1, 1027, 1_000_003])
def test_gather_kernel_lanes(gpu, words, n):
    """Kernel H equals table[clamp(idx)] for one row, a row count that is
    not a multiple of a thread's rows in flight, and more rows than the
    card holds threads (the grid strides)."""
    rng = np.random.default_rng(29)
    table = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (70001, words),
                                          dtype=np.int64).astype(np.int32)
                             ).to(gpu)
    idx = torch.from_numpy(rng.integers(-5, 70010, n)).to(gpu)
    got = gather_bench.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, gather_bench.gather_rows_plain(table, idx))


def test_launch_counters(setup, gpu):
    _, _, fm = setup
    before = locate.KERNEL.launches
    locate.locate_rows(fm, torch.zeros(4, dtype=torch.int64, device=gpu))
    assert locate.KERNEL.launches == before + 1


def test_launch_counters_from_threads(setup, gpu):
    """Two host threads may launch at once (the dispatch thread and a
    finish side that escalates): no launch is lost from the count, and
    each thread's result is right."""
    import sys
    import threading

    _, cpu_fm, fm = setup
    rows = torch.arange(0, cpu_fm.n, 7, dtype=torch.int64, device=gpu)
    want = locate.locate_rows_plain(fm, rows)
    n_threads, n_calls = 8, 200
    ok = []

    def work():
        good = True
        for _ in range(n_calls):
            good &= torch.equal(locate.locate_rows(fm, rows), want)
        ok.append(good)

    before = locate.KERNEL.launches
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert ok == [True] * n_threads
    assert locate.KERNEL.launches == before + n_threads * n_calls


# ---------------------------------------------------------------------------
# RLC (b-move) entries of kernels A (its loop), B, C and E
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rlc_setup(gpu):
    """A repeat-rich genome (six near-identical haplotypes, long BWT runs,
    and a random tail), its with-text and textless RLC indexes on the CPU
    and on the card."""
    from columba_tpu_torch.index.bmove import BMoveIndex, build_bmove_from_codes

    rng = np.random.default_rng(40)
    base = rng.integers(0, 4, 8000).astype(np.uint8)
    haps = [base]
    for _ in range(5):
        h = base.copy()
        snp = rng.random(len(h)) < 0.004
        h[snp] = (h[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
        haps.append(h)
    g = np.concatenate(haps + [rng.integers(0, 4, 12000).astype(np.uint8)])
    out = {}
    for name, tl in (("rlc", False), ("textless", True)):
        arrays = build_bmove_from_codes(g, textless=tl)
        out[name] = (arrays, BMoveIndex.from_arrays(arrays, "cpu"),
                     BMoveIndex.from_arrays(arrays, gpu))
    return g, out


def _rlc_states(index, rng, L, steps=12):
    """Valid lane states of the RLC index: random walks of extensions with
    direction flips from the full range (a dead child restarts there), every
    step's lanes collected, and a few dead (all-zero) lanes."""
    from columba_tpu_torch.ops import bextend

    full = index.full_range((L,))
    cur, seen = full, [full]
    for _ in range(steps):
        dirs = torch.from_numpy(rng.integers(0, 2, L).astype(np.int32))
        ch = bextend.extend_all_plain(index, cur, dirs)
        pick = torch.from_numpy(rng.integers(0, 4, L))
        nxt = ch[torch.arange(L), pick]
        cur = torch.where((nxt[:, 1] > nxt[:, 0])[:, None], nxt, full)
        seen.append(cur)
    states = torch.cat(seen)
    states[::97] = 0
    return states


def test_rlc_locate_kernel(rlc_setup, gpu):
    """Kernel C's RLC entry on every row: run heads and tails, strided rows,
    row 0 and row n among them."""
    _, idx = rlc_setup
    _, cpu_bm, bm = idx["rlc"]
    rows = torch.arange(cpu_bm.n + 1, dtype=torch.int64)
    got = locate.locate_rows(bm, rows.to(gpu))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), locate.locate_rows(cpu_bm, rows))
    assert sorted(got.cpu().tolist())[-2:] == [cpu_bm.n - 1, cpu_bm.n]


def test_rlc_locate_kernel_path_rows(rlc_setup, gpu):
    """Kernel C's RLC entry on the path's rows: whole SA ranges of the
    repeat-rich genome (each locus about six times), flattened."""
    g, idx = rlc_setup
    _, cpu_bm, bm = idx["rlc"]
    rows = _path_rows(bm, g, 71)
    got = locate.locate_rows(bm, rows)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), locate.locate_rows(cpu_bm, rows.cpu()))


def test_rlc_exact_kernel(rlc_setup, gpu):
    """Kernel E's RLC entry equals m plain extend_char steps on every
    column, run hints included (zero where they end empty), at m = 60, 100
    and 1, with N: the first steps from the full range walk past FF_CAP
    runs (the bucket lookup of the run tables)."""
    from columba_tpu_torch.tools import bounds

    g, idx = rlc_setup
    _, cpu_bm, bm = idx["rlc"]
    rng = np.random.default_rng(42)
    for m, R in ((60, 1024), (100, 512), (1, 64)):
        starts = rng.integers(0, len(g) - m, R)
        reads = g[starts[:, None] + np.arange(m)].copy()
        miss = rng.random(R) < 0.3
        reads[miss, rng.integers(0, m, int(miss.sum()))] ^= 1
        reads[::9, rng.integers(0, m)] = 4
        batch = torch.from_numpy(np.concatenate(
            [reads, alphabet.revcomp(reads, axis=-1)]))
        got = extend.exact_match(bm, batch.to(gpu))
        torch.cuda.synchronize()
        want = extend.exact_match(cpu_bm, batch)
        assert torch.equal(got.cpu(), want)
        live = int((want[:, 1] > want[:, 0]).sum())
        assert 0 < live < 2 * R
    stats = {}
    bounds.exact_steps(cpu_bm, batch, stats=stats)
    assert stats["bucket"] > 0 and "probes" not in stats


# every templated (kb, W) of both RLC lane widths (kb 0: the Hamming band),
# and the generic entry above kb 7 or W 2
@pytest.mark.parametrize("flavor,kb,W", [
    (f, kb, W) for f in ("rlc", "textless") for kb in range(8)
    for W in (1, 2)] + [("rlc", 5, 3), ("rlc", 7, 5), ("textless", 5, 3),
                        ("textless", 13, 10)])
def test_rlc_band_step_kernel(rlc_setup, gpu, flavor, kb, W):
    """Kernel B's RLC and textless entries (templated and generic) on valid
    RLC lane states and random step tables equal band_step_compact_plain on
    every output, witness slots included: the kept children's intervals
    from the lanes' threads, their run hints and toeholds from the quads.
    At kb 5..7 (the columba scheme's at 150 bp) the instance and the forced
    generic entry both."""
    _, idx = rlc_setup
    _, cpu_bm, bm = idx[flavor]
    rng = np.random.default_rng(43 + 10 * kb + W)
    track = flavor == "textless"
    states = _rlc_states(cpu_bm, rng, 256)
    C = states.shape[0]
    bw, R, S, T, t = 2 * kb + 1, 96, 7, 5, 3
    state = _random_state(rng, 8, C, R, S, bw, 2 * W if track else W, gpu)
    state[0] = states.to(gpu)
    mrow = torch.from_numpy(_random_mrow(rng, S, bw, W)).to(gpu)
    cells = _cells(rng, R, S, T, bw, gpu, ALL_CODES,
                   m=150 if kb >= 5 else 100)

    def step():
        return fused_vs_plain(bm, state, mrow, cells, T, t,
                              0 if track else 4, track_arg=track)

    n, _ = (instance_and_generic(step, flavor, kb, W)
            if 5 <= kb <= 7 and W <= 2 else step())
    assert n > 0


@pytest.mark.parametrize("flavor", ["rlc", "textless", "per_lane_rlc"])
@pytest.mark.parametrize("block", [64, 128, 256])
def test_rlc_band_step_block_sizes(rlc_setup, gpu, flavor, block):
    """Kernel B's RLC entries at each block size the launch may choose
    (64, 128 or 256 threads a 64-lane tile: 16, 32 or 64 quads walk the
    kept children) equal band_step_compact_plain on every output, on a
    step that keeps most children and overflows the frontier."""
    _, idx = rlc_setup
    _, cpu_bm, bm = idx["rlc" if flavor == "per_lane_rlc" else flavor]
    rng = np.random.default_rng(60 + block)
    track = flavor == "textless"
    W = 1 if flavor == "per_lane_rlc" else 2
    states = _rlc_states(cpu_bm, rng, 384)
    state = _random_state(rng, 8, states.shape[0], 96, 7, 5,
                          2 * W if track else W, gpu, cells=4)
    state[0] = states.to(gpu)
    mrow = torch.from_numpy(_random_mrow(rng, 7, 5, W)).to(gpu)
    mrow[:, 0] |= 1
    mrow[:, 0] &= ~(255 << 10)
    mrow[:, 0] |= 6 << 10
    dyn = None
    if flavor == "per_lane_rlc":
        words = (1 | (rng.integers(0, 2, 96 * 7 * 5) << 1) | (1 << 2)
                 | (3 << 3) | (6 << 9) | (9 << 17))
        dyn = torch.from_numpy(words.astype(np.int32)).to(gpu)
        mrow = None
        cells = torch.from_numpy(rng.integers(-1, 5, (96 * 7 * 5, 5)).astype(
            np.int8)).to(gpu)
    else:
        cells = _cells(rng, 96, 7, 5, 5, gpu, DIAG_CODES)
    executor.BAND_QUAD_BLOCK = block
    try:
        for cap in (None, 1000):
            n, _ = fused_vs_plain(bm, state, mrow, cells, 5, 3, 0, dyn,
                                  track_arg=track, cap=cap)
            assert n > 1000
    finally:
        executor.BAND_QUAD_BLOCK = 0


@pytest.mark.parametrize("flavor", ["rlc", "textless"])
@pytest.mark.parametrize("shape", ["static", "two_stage", "dyn"])
def test_rlc_exact_loop_kernel(rlc_setup, gpu, flavor, shape):
    """Kernel A's loop entry on 8- and 12-wide RLC lanes (run hints and
    toeholds walked with every step, a quad a lane) equals
    exact_loop_plain: from the full range on a static schedule's tables,
    the second stage of the two-stage loop (compacted lanes with their own
    ids, steps from 8), and per-read tables (kernel G's, of kernel F's
    boundaries on the with-text index; the tables depend on the reads
    only, so the textless lanes take them too)."""
    g, idx = rlc_setup
    _, cpu_bm, bm = idx[flavor]
    rng = np.random.default_rng(46)
    batch = torch.from_numpy(_reads(rng, g, 64, 100, 2)).to(gpu)
    if shape == "dyn":
        scheme = get_scheme("kuch1", 2)
        st = dynschedule.scheme_static(scheme, 100, "edit")
        pts = dynschedule.dynamic_partition(idx["rlc"][2], batch, scheme)
        dyn = dynschedule.build_tables(st, pts, batch)
        tabs = (dyn["ex_pos"], dyn["ex_dir"], dyn["db_ex_steps"])
        S, E = st.num_searches, dyn["ex_pos"].shape[1]
    else:
        sched = pipeline.compile_cached(get_scheme("kuch1", 2), 100, "edit")
        tables = executor.device_tables(sched, gpu)
        tabs = (tables["ex_pos"], tables["ex_dir"], tables["db_ex"])
        S, E = sched.num_searches, sched.e_max
    L = batch.shape[0] * S
    ranges = bm.full_range((L,)).clone()
    ranges[::11] = 0
    ids, t_lo = None, 0
    sp = 0 if flavor == "textless" else 4
    if shape == "two_stage":
        ids = torch.from_numpy(np.sort(rng.choice(L, L // 3, replace=False))
                               .astype(np.int32)).to(gpu)
        ranges, _ = executor.exact_loop_plain(
            bm, ranges[ids.long()], ids, 0, 8, batch, tabs, False, 10, sp)
        t_lo = 8
    out, drows = loop_vs_plain(bm, ranges, ids, t_lo, E, batch, tabs,
                               shape == "dyn", 10, sp)
    assert bool((out[:, 1] > out[:, 0]).any())


@pytest.mark.parametrize("flavor,switchpoint", [("rlc", 4), ("rlc", 0),
                                                ("textless", 0)])
def test_rlc_scheme_kernels_vs_plain(rlc_setup, gpu, flavor, switchpoint):
    """run_scheme on the RLC index through kernels A and B on the card
    equals the plain versions on the CPU, field by field, arg_b included."""
    g, idx = rlc_setup
    _, cpu_bm, bm = idx[flavor]
    rng = np.random.default_rng(44)
    batch = _reads(rng, g, 48, 100, 2)
    sched = pipeline.compile_cached(get_scheme("kuch1", 2), 100, "edit")
    itv_cap, ss, c2 = pipeline.crossover_caps(1024, 4096, switchpoint)
    out = []
    for index in (bm, cpu_bm):
        out.append(executor.run_scheme(
            index, torch.from_numpy(batch).to(index.device), sched, 1024,
            None, switchpoint, itv_cap, ss, c2, itv_min_depth=16,
            track_arg=flavor == "textless"))
    for f in ("ranges", "rid", "sid", "ed_lb", "done", "overflow",
              "nodes_visited", "itv", "itv_count", "searches_started",
              "arg_b"):
        assert torch.equal(getattr(out[0], f).cpu(), getattr(out[1], f)), f
    assert bool(out[1].done.any())


@pytest.mark.parametrize("flavor,k", [("rlc", 2), ("rlc", 0),
                                      ("textless", 2), ("textless", 0)])
def test_rlc_match_all_vs_plain(rlc_setup, gpu, flavor, k):
    """match_all on the RLC indexes (kernels A, B, C, D, E; the textless
    pass and its host locate) on the card equals the plain versions."""
    g, idx = rlc_setup
    arrays, cpu_bm, bm = idx[flavor]
    rng = np.random.default_rng(45)
    reads = _reads(rng, g, 96, 100, k)[:96]
    out = [pipeline.match_all(index, reads, get_scheme("kuch1", k),
                              switchpoint=4, host_arrays=arrays)
           for index in (bm, cpu_bm)]
    for f in ("read_id", "strand", "begin", "end", "distance"):
        assert np.array_equal(getattr(out[0][0], f), getattr(out[1][0], f)), f
    assert len(out[0][0]) >= 96


# ---------------------------------------------------------------------------
# RLC entries of dynamic partitioning and scheme selection: kernel A's
# per-step entry, kernel F, kernel E with lengths, kernel B's per-lane entry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flavor", ["rlc", "textless"])
def test_rlc_extend_kernel(rlc_setup, gpu, flavor):
    """Kernel A's per-step RLC entry (extend.rlc) on 8- and 12-wide lanes
    equals bextend's extend_all_plain and extend_char_plain on every column
    (intervals, run hints, toeholds), with N chars and dead lanes."""
    from columba_tpu_torch.ops import bextend

    _, idx = rlc_setup
    _, cpu_bm, bm = idx[flavor]
    rng = np.random.default_rng(47)
    states = _rlc_states(cpu_bm, rng, 512)
    L = states.shape[0]
    dirs = torch.from_numpy(rng.integers(0, 2, L).astype(np.int32))
    chars = torch.from_numpy(rng.integers(0, 5, L).astype(np.int32))
    got = extend.extend_all(bm, states.to(gpu), dirs.to(gpu))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), bextend.extend_all_plain(cpu_bm, states,
                                                           dirs))
    got = extend.extend_char(bm, states.to(gpu), chars.to(gpu), dirs.to(gpu))
    torch.cuda.synchronize()
    want = bextend.extend_char_plain(cpu_bm, states, chars, dirs)
    assert torch.equal(got.cpu(), want)
    assert 0 < int((want[:, 1] > want[:, 0]).sum()) < L
    assert extend.KERNEL.by_entry.get("rlc", 0) >= 2


@pytest.mark.parametrize("flavor", ["vanilla", "rlc", "textless"])
@pytest.mark.parametrize("K", [6, 10])
def test_kmer_table_kernel(setup, rlc_setup, gpu, flavor, K):
    """Kernel A's table entry (the k-mer seed table in one launch) equals
    the K-launch build (``build_kmer_table_plain``: K ``extend_char`` calls
    through kernel A's per-step entries) bit for bit, empty ranges
    included: on the Vanilla index they keep stepping, on the RLC indexes
    they are zero."""
    index = setup[2] if flavor == "vanilla" else rlc_setup[1][flavor][2]
    extend.KERNEL.reset()
    got = kmer.build_kmer_table(index, K)
    torch.cuda.synchronize()
    assert extend.KERNEL.by_entry == {
        "table" if flavor == "vanilla" else "table_rlc": 1}
    want = kmer.build_kmer_table_plain(index, K)
    assert torch.equal(got, want)
    empty = want[:, 1] <= want[:, 0]
    assert int(empty.sum()) < 4 ** K
    if K == 10:
        assert bool(empty.any())
        assert bool((want[empty] != 0).any()) == (flavor == "vanilla")


@pytest.mark.parametrize("k", [2, 4])
def test_rlc_dynpart_kernel(rlc_setup, gpu, k):
    """Kernel F's RLC entry equals the plain partition scan on the
    boundaries and on every column of the final part ranges, without a seed
    table (K = 1) and seeded from the RLC index's 6-mer table."""
    g, idx = rlc_setup
    _, cpu_bm, bm = idx["rlc"]
    rng = np.random.default_rng(48 + k)
    batch = torch.from_numpy(_reads(rng, g, 256, 100, k)).to(gpu)
    scheme = get_scheme("kuch1", k)
    p = scheme.num_parts
    for table in (None, kmer.build_kmer_table(bm, 6)):
        out = []
        for fn in (dynschedule.dynamic_partition,
                   dynschedule.dynamic_partition_plain):
            rng_out = torch.zeros((batch.shape[0], p, 8), dtype=torch.int64,
                                  device=gpu)
            out.append((fn(bm, batch, scheme, table, rng_out), rng_out))
        torch.cuda.synchronize()
        assert torch.equal(out[0][0], out[1][0])
        assert torch.equal(out[0][1], out[1][1])
        assert len({tuple(r) for r in out[0][0].cpu().tolist()}) > 1
    assert dynschedule.PARTITION_KERNEL.by_entry.get("rlc", 0) >= 2
    stats = {}
    dynschedule.dynamic_partition_plain(cpu_bm, batch.cpu(), scheme, None,
                                        None, stats)
    assert stats["bucket"] > 0 and "probes" not in stats


@pytest.mark.parametrize("name,k,m", [("pigeon", 15, 100),
                                      ("columba", 13, 150), ("kuch1", 4, 40)])
def test_rlc_dynpart_kernel_parts(rlc_setup, gpu, name, k, m):
    """Kernel F's RLC entry at the largest part counts (16: its limit, and
    15) and on short reads, with N and a homopolymer, every column of the
    final part ranges; kuch1's wrapping weights scaled up."""
    import dataclasses

    g, idx = rlc_setup
    _, cpu_bm, bm = idx["rlc"]
    rng = np.random.default_rng(50 + k)
    batch = torch.from_numpy(_reads(rng, g, 256, m, 2)).to(gpu)
    scheme = get_scheme(name, k)
    if scheme.weights:
        scheme = dataclasses.replace(
            scheme, weights=tuple(w * 40_000 for w in scheme.weights))
    p = scheme.num_parts
    out = []
    for fn in (dynschedule.dynamic_partition,
               dynschedule.dynamic_partition_plain):
        rng_out = torch.zeros((batch.shape[0], p, 8), dtype=torch.int64,
                              device=gpu)
        out.append((fn(bm, batch, scheme, None, rng_out), rng_out))
    torch.cuda.synchronize()
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert torch.equal(out[0][0].cpu(), dynschedule.dynamic_partition(
        cpu_bm, batch.cpu(), scheme, None))


def test_rlc_exact_kernel_lengths(rlc_setup, gpu):
    """Kernel E's RLC entry with per-row lengths (exact.rlc_lengths) equals
    the plain exact match, and part_exact_ranges / select_schemes on the
    card equal the CPU's (8-wide ranges, choice and mask)."""
    g, idx = rlc_setup
    _, cpu_bm, bm = idx["rlc"]
    rng = np.random.default_rng(49)
    m, B = 40, 4096
    starts = rng.integers(0, len(g) - m, B)
    pats = g[starts[:, None] + np.arange(m)].copy()
    lengths = rng.integers(0, m + 1, B).astype(np.int32)
    lengths[:3] = [0, 1, m]
    pats[rng.random(B) < 0.3, 2] ^= 1
    pats[::11, 1] = 4
    for i, n in enumerate(lengths):
        pats[i, n:] = 5
    tp = torch.from_numpy(pats).to(gpu)
    tl = torch.from_numpy(lengths).to(gpu)
    got = extend.exact_match(bm, tp, tl)
    torch.cuda.synchronize()
    assert torch.equal(got, extend.zero_empty(
        extend.exact_match_plain(bm, tp, tl)))
    assert 0 < int((got[:, 1] > got[:, 0]).sum()) < B
    batch = _reads(rng, g, 128, 100, 2)
    pts = [0, 30, 71, 100]
    assert torch.equal(
        pipeline.part_exact_ranges(bm, torch.from_numpy(batch).to(gpu),
                                   pts).cpu(),
        pipeline.part_exact_ranges(cpu_bm, torch.from_numpy(batch), pts))
    sets = get_multi_scheme("columba", 2)
    _, mask_g, choice_g = pipeline.select_schemes(
        bm, torch.from_numpy(batch).to(gpu), sets)
    _, mask_c, choice_c = pipeline.select_schemes(
        cpu_bm, torch.from_numpy(batch), sets)
    assert np.array_equal(mask_g, mask_c) and np.array_equal(choice_g,
                                                             choice_c)
    assert extend.EXACT_KERNEL.by_entry.get("rlc_lengths", 0) >= 2
    from columba_tpu_torch.tools import bounds
    stats = {}
    bounds.exact_steps(cpu_bm, tp.cpu(), tl.cpu(), stats)
    assert stats["bucket"] > 0 and "probes" not in stats


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4, 5, 6, 7])
def test_rlc_band_step_per_lane(rlc_setup, gpu, k):
    """Kernel B's per-lane RLC entry (kb 0..7 templated; at kb 5..7 its
    forced generic entry too) on kernel G's tables of kernel F's boundaries
    and valid RLC lane states equals band_step_compact_plain, at steps
    where searches idle, reset and accumulate; then kernel A's loop entry
    on the same per-read tables."""
    g, idx = rlc_setup
    _, cpu_bm, bm = idx["rlc"]
    rng = np.random.default_rng(50 + k)
    m, R = 100, 128
    # kb 0: a Hamming schedule of a k = 1 partition (p = 1 has none)
    scheme = get_scheme("columba" if k > 4 else "kuch1", max(k, 1))
    st = dynschedule.scheme_static(scheme, m, "edit" if k else "hamming")
    batch = torch.from_numpy(_reads(rng, g, R // 2, m, 2)).to(gpu)
    pts = dynschedule.dynamic_partition(bm, batch, scheme)
    dyn = dynschedule.build_tables(st, pts, batch)
    S, T, bw = st.num_searches, st.t_max, 2 * st.kb + 1
    states = _rlc_states(cpu_bm, rng, 256)
    C = states.shape[0]
    state = _random_state(rng, 8, C, R, S, bw, 1, gpu)
    state[0] = states.to(gpu)
    kept, launches = 0, 0
    for t in (0, T // 3, T // 2, T - 20, T - 1):
        def step():
            return fused_vs_plain(bm, state, None, dyn["pchars"], T, t,
                                  4 if k % 2 else 0, dyn["meta"].reshape(-1))
        n, _ = (instance_and_generic(step, "per_lane_rlc", k, 1) if k >= 5
                else step())
        kept += n
        launches += executor.KERNEL.by_entry.get("per_lane_rlc", 0)
        executor.KERNEL.reset()
    assert kept > 0
    assert launches >= 5
    out, _ = loop_vs_plain(
        bm, bm.full_range((R * S,)), None, 0, dyn["ex_pos"].shape[1], batch,
        (dyn["ex_pos"], dyn["ex_dir"], dyn["db_ex_steps"]), True, 19, 4)
    assert bool((out[:, 1] > out[:, 0]).any())


@pytest.mark.parametrize("mode", ["dynamic", "selection"])
def test_rlc_select_match_all_vs_plain(rlc_setup, gpu, mode):
    """match_all on the with-text RLC index with dynamic partitioning
    (kernels F, G, A's loop and B per-lane on RLC lanes) and with a scheme
    list (kernel E with lengths, the search mask) on the card equals the
    plain versions on the CPU."""
    g, idx = rlc_setup
    _, cpu_bm, bm = idx["rlc"]
    rng = np.random.default_rng(51)
    reads = _reads(rng, g, 96, 100, 2)[:96]
    scheme, kw = ((get_scheme("kuch1", 2), dict(partitioning="dynamic"))
                  if mode == "dynamic" else (get_multi_scheme("kuch1", 2), {}))
    out = [pipeline.match_all(index, reads, scheme, switchpoint=4, **kw)
           for index in (bm, cpu_bm)]
    assert out[0][1] == out[1][1]
    for f in ("read_id", "strand", "begin", "end", "distance"):
        assert np.array_equal(getattr(out[0][0], f), getattr(out[1][0], f)), f
    assert len(out[0][0]) >= 96


# ---------------------------------------------------------------------------
# Kernels I-L: the frontier (seed, drain, init, the two-stage exact loop's
# compaction and scatter, tail), the candidates' expansion and the dedup
# ---------------------------------------------------------------------------

FRONTIER_ENTRIES = ("frontier.seed", "frontier.lookup", "frontier.drain",
                    "frontier.init", "frontier.ex_compact",
                    "frontier.ex_back", "frontier.tail",
                    "expand.frontier_tail", "expand.ranges", "expand.rows",
                    "dedup.windows", "dedup.keys", "dedup.pass",
                    "dedup.compact")

def _lanes(rng, L, sw, gpu):
    """(L, 4) lane ranges: a third empty, a third narrow (width 1..sw),
    the rest wider; and (L, 4) drain rows, a quarter drained."""
    lo = rng.integers(0, 1 << 30, L)
    kind = rng.integers(0, 3, L)
    width = np.where(kind == 0, 0, np.where(kind == 1,
                                            rng.integers(1, sw + 1, L),
                                            rng.integers(sw + 1, 90, L)))
    ranges = np.stack([lo, lo + width, lo + 7, lo + 7 + width], 1)
    drows = np.where((rng.random(L) < 0.25)[:, None],
                     np.stack([lo, lo + 2, rng.integers(0, L, L),
                               rng.integers(0, 99, L)], 1), 0)
    return (torch.from_numpy(ranges.astype(np.int64)).to(gpu),
            torch.from_numpy(drows.astype(np.int64)).to(gpu))


# the multi-lane scans (WIDE_TILE lanes a tile, csrc/frontier.cu kTile):
# one lane, exactly one tile, one lane past it, many tiles with both the
# frontier and the in-text buffer overflowing
@pytest.mark.parametrize("case,L", [("one", 1), ("tile", WIDE_TILE),
                                    ("tile_plus_one", WIDE_TILE + 1),
                                    ("overflow", 50_001)])
def test_frontier_wide_scans(gpu, case, L):
    """Kernel I's drain, init and ex_compact on their multi-lane tiles
    equal their plain versions on every buffer they write: the in-text
    rows in lane order (drain rows before narrow lanes), the compacted
    frontier and its inits, the lanes' slots, the run's counter words."""
    rng = np.random.default_rng(L)
    S, sw, bw, W = 1, 4, 5, 2
    ranges0, drows = _lanes(rng, L, sw, gpu)
    C, M = (max(1, L // 8), max(1, L // 10)) if case == "overflow" else (
        L, 2 * L + 8)
    inits = (torch.from_numpy(rng.integers(0, 60, S).astype(np.int32)),
             torch.from_numpy(rng.integers(0, 9, (S, 2, bw)).astype(np.int8)),
             torch.from_numpy(rng.integers(0, 9, (S, 2, W)).astype(np.int8)))
    inits = [x.to(gpu) for x in inits]
    got = []
    for drain, init, exc in (
            (executor.frontier_drain, executor.frontier_init,
             executor.frontier_ex_compact),
            (executor.frontier_drain_plain, executor.frontier_init_plain,
             executor.frontier_ex_compact_plain)):
        itv = torch.zeros((M + 1, 4), dtype=torch.int64, device=gpu)
        words = torch.zeros(executor.RUN_WORDS, dtype=torch.int64,
                            device=gpu)
        state = [torch.zeros((C, 4), dtype=torch.int64, device=gpu),
                 torch.zeros(C, dtype=torch.int32, device=gpu),
                 torch.full((C, 2, bw), 63, dtype=torch.int8, device=gpu),
                 torch.full((C, 2, W), 63, dtype=torch.int8, device=gpu)]
        drain(itv, words, drows)
        init(ranges0, S, sw, *inits, False, W, state, itv, words)
        ec = max(1, L // 3)
        r2 = torch.zeros((ec, 4), dtype=torch.int64, device=gpu)
        src = torch.zeros(ec, dtype=torch.int32, device=gpu)
        slot = exc(ranges0, r2, src, words)
        torch.cuda.synchronize()
        got.append([itv[:M], words, *state, r2, src, slot])
    for k, (a, b) in enumerate(zip(*got)):
        assert torch.equal(a, b), k
    words = got[0][1]
    n_live, rows = int(words[5]), int(words[0]) >> 32
    if case == "overflow":
        assert n_live > C and int(words[4]) == M and rows == M
        assert int(words[2]) > 0
    else:
        assert rows <= M and (L == 1 or 0 < n_live <= C)


def _candidates(rng, case, C, M, gpu):
    """A final frontier (C lanes, some done; its tail deferred, as
    run_scheme(defer_tail=True) leaves it: kernel K's frontier_tail takes
    it) and an in-text buffer (M rows and a scratch row, the first
    ``count`` valid). "empty_runs": live candidates only every 3,000 or
    so, runs of empty ones longer than a block of rows stages; "zero": none
    live; "over": widths that pass max_locate."""
    lo = rng.integers(0, 1 << 31, C)
    width = {"empty_runs": np.zeros(C, np.int64),
             "zero": np.zeros(C, np.int64),
             "over": rng.integers(0, 300, C)}[case]
    if case == "empty_runs":
        width[::3001] = rng.integers(1, 5, len(width[::3001]))
    ranges = np.stack([lo, lo + width, lo, lo + width], 1)
    done = rng.random(C) < (1.0 if case == "empty_runs" else 0.5)
    S, R = 3, 4096
    itv = np.zeros((M + 1, 4), np.int64)
    itv[:, 0] = rng.integers(0, 1 << 31, M + 1)
    iw = np.zeros(M + 1, np.int64) if case != "over" else rng.integers(
        0, 9, M + 1)
    if case == "empty_runs":
        iw[1234::4567] = 3
    itv[:, 1] = itv[:, 0] + iw
    itv[:, 2] = rng.integers(0, R * S, M + 1)
    itv[:, 3] = rng.integers(0, 60, M + 1)
    count = M - 17
    words = np.zeros(executor.RUN_WORDS, np.int64)
    words[0] = count << 32
    t = lambda x: torch.from_numpy(np.asarray(x)).to(gpu)  # noqa: E731
    # a lane is done where its range is not empty and its one colMin
    # register a side (per-lane schedules) stays within u_last = 5
    colmin = np.where(done, 0, 9)[:, None, None].repeat(2, 1).astype(np.int8)
    state = [t(ranges.astype(np.int64)),
             t((rng.integers(0, R, C) * S + rng.integers(0, S, C)).astype(
                 np.int32)),
             t(np.zeros((C, 2, 5), np.int8)), t(colmin)]
    words_t, itv_t = t(words), t(itv)

    def out(dt):
        return torch.empty(C, dtype=dt, device=gpu)

    res = executor.FrontierResult(
        ranges=state[0], rid=out(torch.int64), sid=out(torch.int64),
        ed_lb=out(torch.int64), done=out(torch.bool), overflow=words_t[7],
        nodes_visited=words_t[1], itv=itv_t[:M], itv_count=words_t[6],
        searches_started=words_t[5], arg_b=out(torch.int8),
        tail=dict(state=state, live=C, moved=False, itv=itv_t, words=words_t,
                  shrink=0, S=S, W=1, final_reg=None,
                  u_last=t(np.full(S, 5, np.int64))))
    tables = dict(t_back=t(rng.integers(20, 70, S)),
                  pivot=t(rng.integers(0, 60, S)))
    return res, tables, S


@pytest.mark.parametrize("case,ml", [("empty_runs", 1024), ("zero", 4096),
                                     ("over", 4096)])
def test_expand_kernels_edges(gpu, case, ml):
    """Kernel K's candidates-and-scan entry (kernel J's tail in its launch)
    and its rows entry equal
    their plain versions with long runs of empty candidates (longer than
    a block's staging), with a total of 0, and with a total past
    max_locate (the clip: rows past it invalid, on the last candidate);
    and the ranges entry on strided columns."""
    from columba_tpu_torch.tools.path_inputs import copies

    rng = np.random.default_rng(len(case) + ml)
    res, tables, S = _candidates(rng, case, 20_000, 24_000, gpu)
    got = pipeline.stage_tail_candidates(copies(res), tables, S, ml)
    want = pipeline.stage_tail_candidates_plain(copies(res), tables, S, ml)
    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), k
    c_lo, offsets, total = got[0], got[4], got[5]
    rows = pipeline.expand_rows(c_lo, offsets, total, ml)
    rows_p = pipeline.expand_rows_plain(c_lo, offsets, total, ml)
    for k, (a, b) in enumerate(zip(rows, rows_p)):
        assert torch.equal(a, b), k
    tot = int(total)
    assert {"empty_runs": 0 < tot < ml, "zero": tot == 0,
            "over": tot > ml}[case], tot
    strided = res.ranges[:, 0], res.ranges[:, 1]
    assert all(torch.equal(a, b) for a, b in zip(
        pipeline.expand_scan(*strided, ml),
        pipeline.expand_scan_plain(*strided, ml)))


@pytest.mark.parametrize("path", ["seeded", "band_only", "dynamic", "exact",
                                  "rlc", "textless", "overflow"])
def test_frontier_kernels_vs_plain(setup, rlc_setup, gpu, path):
    """Every entry of kernels I-L that a path launches, captured from one
    match_device_core (or run_scheme, or the k = 0 pass) on the card and
    replayed through its plain version on copies of its inputs: the same
    result and the same buffers it writes in place, exactly."""
    from columba_tpu_torch.tools import path_inputs

    g, cpu_fm, fm = setup
    rng = np.random.default_rng(60)
    m = 100
    reads = _reads(rng, g, 200, m, 2)
    batch = torch.from_numpy(np.concatenate(
        [reads, alphabet.revcomp(reads, axis=-1)])).to(gpu)
    table = kmer.build_kmer_table(fm, 6)
    sched = pipeline.compile_cached(get_scheme("kuch1", 2), m, "edit",
                                    kmer_k=0 if path in ("band_only", "rlc",
                                                         "textless",
                                                         "dynamic") else 6)

    def core(index, cap, sw, tab=None, **kw):
        return pipeline.match_device_core(
            index, batch, sched, cap, 4096, 2, tab, sw,
            *pipeline.crossover_caps(cap, 4096, sw), **kw)

    if path == "seeded":
        fn = lambda: (core(fm, 1024, 4, table),  # noqa: E731
                      kmer.lookup(table, batch[:, 10:16]))
    elif path == "overflow":                  # the frontier's capacity
        fn = lambda: core(fm, 64, 0, table)  # noqa: E731
    elif path == "band_only":
        fn = lambda: core(fm, 1024, 0, ex_split=8, ex_cap=96)  # noqa: E731
    elif path == "dynamic":
        st = dynschedule.scheme_static(get_scheme("kuch1", 2), m, "edit")
        pts = dynschedule.dynamic_partition(fm, batch, get_scheme("kuch1", 2),
                                            table)
        fn = lambda: core(fm, 1024, 4,  # noqa: E731
                          dyn=dynschedule.build_tables(st, pts, batch))
    elif path == "exact":
        fn = lambda: pipeline._exact_device(fm, batch, 4096)  # noqa: E731
    else:
        _, idx = rlc_setup
        index = idx[path][2]
        if path == "rlc":
            fn = lambda: core(index, 1024, 4)  # noqa: E731
        else:
            fn = lambda: executor.run_scheme(  # noqa: E731
                index, batch, sched, 256, track_arg=True)
    calls = path_inputs.capture_entries(fn)
    torch.cuda.synchronize()
    want = {"seeded": ("frontier.seed", "frontier.lookup", "frontier.drain",
                       "frontier.init", "expand.frontier_tail",
                       "expand.rows", "dedup.windows", "dedup.keys",
                       "dedup.pass", "dedup.compact"),
            "overflow": ("frontier.seed", "frontier.init",
                         "expand.frontier_tail"),
            "band_only": ("frontier.ex_compact", "frontier.ex_back",
                          "frontier.init", "expand.frontier_tail"),
            "dynamic": ("frontier.seed", "frontier.drain", "frontier.init",
                        "expand.frontier_tail"),
            "exact": ("expand.ranges", "expand.rows"),
            "rlc": ("frontier.seed", "frontier.init", "expand.frontier_tail",
                    "dedup.pass", "dedup.compact"),
            "textless": ("frontier.seed", "frontier.init",
                         "frontier.tail")}[path]
    assert set(want) <= set(calls), sorted(calls)
    for name, call in calls.items():
        assert path_inputs.replay_plain(call) == 0, name
    assert path == "textless" or "frontier.tail" not in calls
    if path == "overflow":
        words = calls["expand.frontier_tail"]["after"]["res"].tail["words"]
        assert int(words[7]) > 0                  # the frontier overflowed


@pytest.mark.parametrize("case", edges.DEDUP_CASES + ("se_all",))
def test_dedup_entries(gpu, case):
    """Kernel L's keys (with the prefix count and with the mask), each
    pass and the compaction equal their plain versions on every edge, and
    stage_dedup on CUDA tensors equals stage_dedup_plain with torch.sort,
    argsort, unique and searchsorted patched to raise
    (``tools/edges.py``)."""
    info = edges.dedup_vs_plain(case, gpu)
    assert info["passes"] == pipeline.dedup_passes(info["rows"])
    assert case != "se_all" or info["passes"] == 6


@pytest.mark.parametrize("moved", [False, True])
def test_expand_frontier_tail(gpu, moved):
    """Kernel K's frontier_tail entry (kernel J's rows and K's candidates
    in one launch) equals frontier_tail_plain then stage_candidates_plain
    at SE ALL's shape after the shrink (C = 1,024 final rows, M = 131,072
    in-text rows), with and without a move, and with C not a multiple of
    the tile (a tile that holds frontier and in-text lanes), and on 12
    frontier tiles."""
    for C, M in ((1024, 131_072), (1500, 4096), (12_288, 131_072)):
        info = edges.frontier_tail_vs_plain(C, M, moved, gpu)
        assert info["ghosts"] > 0


def test_frontier_kernels_no_fallback(setup, gpu):
    """A CUDA tensor reaching kernels I-L launches the kernel or raises."""
    g, cpu_fm, fm = setup
    with pytest.raises(ValueError):
        pipeline.stage_windows(torch.zeros(4, dtype=torch.int32, device=gpu),
                               torch.zeros(4, dtype=torch.int64, device=gpu),
                               torch.zeros(4, dtype=torch.int64, device=gpu),
                               torch.zeros(4, dtype=torch.int64, device=gpu),
                               2)
    before = pipeline.EXPAND.launches
    pipeline.stage_expand(torch.zeros(8, dtype=torch.int64, device=gpu),
                          torch.ones(8, dtype=torch.int64, device=gpu), 16)
    assert pipeline.EXPAND.launches == before + 2
