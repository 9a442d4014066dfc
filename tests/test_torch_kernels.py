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
from columba_tpu_torch.search import dynschedule, executor, pipeline
from columba_tpu_torch.search.scheme import get_multi_scheme, get_scheme
from columba_tpu_torch.tools import gather_bench

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
                              ss, c2, itv_min_depth=16, tables=tables)
    c_lo, c_hi, _, _ = pipeline.stage_candidates(res, tables,
                                                 sched.num_searches)
    rows, _, _, total = pipeline.stage_expand(c_lo, c_hi, max_locate)
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


def fused_vs_plain(index, state, mrow_t, pchars, T, t, switchpoint,
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
        fn(index, state, C, out, itv, cnt, sc, mrow_t, pchars, T, t,
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
    pchars = torch.from_numpy(rng.integers(-2, 5, (R * S * T, bw)).astype(
        np.int8)).to(gpu)
    n, _ = fused_vs_plain(fm, state, tables["mrow"][t], pchars, T, t, 4)
    assert n > 0


@pytest.mark.parametrize("flavor", ["vanilla", "rlc", "textless"])
def test_band_step_overflow(setup, rlc_setup, gpu, flavor):
    """A step whose kept children overflow the next frontier (n > cap) and
    whose narrow rows overflow the in-text buffer: the clamps, the dropped
    rows and the overflow count equal the plain version's, over three
    launches on one scratch (fresh epochs, the ticket reset between)."""
    rng = np.random.default_rng(12)
    track = flavor == "textless"
    if flavor == "vanilla":
        _, cpu_fm, index = setup
        state = _random_state(rng, cpu_fm.n, 4096, 96, 7, 5, 2, gpu, cells=4)
    else:
        _, idx = rlc_setup
        _, cpu_bm, index = idx[flavor]
        states = _rlc_states(cpu_bm, rng, 512)
        state = _random_state(rng, 8, states.shape[0], 96, 7, 5,
                              4 if track else 2, gpu, cells=4)
        state[0] = states.to(gpu)
    mrow = torch.from_numpy(_random_mrow(rng, 7, 5, 2)).to(gpu)
    mrow[:, 0] |= 1                            # every search active
    mrow[:, 0] &= ~(255 << 10)
    mrow[:, 0] |= 6 << 10                      # a loose bound: most survive
    pchars = torch.from_numpy(rng.integers(-1, 5, (96 * 7 * 5, 5)).astype(
        np.int8)).to(gpu)
    scratch = executor.StepScratch(state[0].shape[0], gpu)
    for rep in range(3):
        n, rows = fused_vs_plain(index, state, mrow, pchars, 5, 3, 8,
                                 track_arg=track, cap=256, M=64, cnt=40,
                                 scratch=scratch)
        assert n > 256 and rows == 64, (n, rows)
    assert scratch.epoch == 3


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


# kb 0..4 x W 1..2 are templated entries of csrc/band_step.cu; the others
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
    pchars = torch.from_numpy(rng.integers(-2, 5, (R * S * T, bw)).astype(
        np.int8)).to(gpu)
    n, _ = fused_vs_plain(fm, state, mrow, pchars, T, t,
                          4 if kb % 2 else 0)
    assert n > 0


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


@pytest.mark.parametrize("k,metric", [(0, "edit"), (1, "edit"), (2, "edit"),
                                      (3, "edit"), (4, "edit"), (5, "edit"),
                                      (2, "hamming")])
def test_band_step_per_lane(setup, gpu, k, metric):
    """Kernel B's per-lane entry (kb 0..4 templated, kb 5 generic) on kernel
    G's tables and random lane states equals band_step_compact_plain with
    the same switch, at steps where searches idle, reset and accumulate."""
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
        n, _ = fused_vs_plain(fm, state, None, dyn["pchars"], T, t,
                              4 if k % 2 else 0, dyn["meta"].reshape(-1))
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


@pytest.mark.parametrize("flavor,kb,W", [
    ("rlc", 0, 1), ("rlc", 2, 2), ("rlc", 4, 2), ("rlc", 5, 3),
    ("textless", 0, 2), ("textless", 2, 2), ("textless", 4, 1),
    ("textless", 5, 3)])
def test_rlc_band_step_kernel(rlc_setup, gpu, flavor, kb, W):
    """Kernel B's RLC and textless entries (templated and generic) on valid
    RLC lane states and random step tables equal band_step_compact_plain on
    every output, witness slots included."""
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
    pchars = torch.from_numpy(rng.integers(-2, 5, (R * S * T, bw)).astype(
        np.int8)).to(gpu)
    n, _ = fused_vs_plain(bm, state, mrow, pchars, T, t,
                          0 if track else 4, track_arg=track)
    assert n > 0


@pytest.mark.parametrize("flavor", ["rlc", "textless"])
def test_rlc_exact_loop_kernel(rlc_setup, gpu, flavor):
    """Kernel A's loop entry on 8- and 12-wide RLC lanes (run hints and
    toeholds walked with every step) equals exact_loop_plain."""
    g, idx = rlc_setup
    _, cpu_bm, bm = idx[flavor]
    rng = np.random.default_rng(46)
    batch = torch.from_numpy(_reads(rng, g, 64, 100, 2)).to(gpu)
    sched = pipeline.compile_cached(get_scheme("kuch1", 2), 100, "edit")
    tables = executor.device_tables(sched, gpu)
    tabs = (tables["ex_pos"], tables["ex_dir"], tables["db_ex"])
    L = batch.shape[0] * sched.num_searches
    ranges = bm.full_range((L,)).clone()
    ranges[::11] = 0
    out, drows = loop_vs_plain(bm, ranges, None, 0, sched.e_max, batch,
                               tabs, False, 10, 0 if flavor == "textless"
                               else 4)
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


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_rlc_band_step_per_lane(rlc_setup, gpu, k):
    """Kernel B's per-lane RLC entry (kb 1..4 templated, kb 5 generic) on
    kernel G's tables of kernel F's boundaries and valid RLC lane states
    equals band_step_compact_plain, at steps where searches idle, reset and
    accumulate; then kernel A's loop entry on the same per-read tables."""
    g, idx = rlc_setup
    _, cpu_bm, bm = idx["rlc"]
    rng = np.random.default_rng(50 + k)
    m, R = 100, 128
    scheme = get_scheme("columba" if k > 4 else "kuch1", k)
    st = dynschedule.scheme_static(scheme, m, "edit")
    batch = torch.from_numpy(_reads(rng, g, R // 2, m, 2)).to(gpu)
    pts = dynschedule.dynamic_partition(bm, batch, scheme)
    dyn = dynschedule.build_tables(st, pts, batch)
    S, T, bw = st.num_searches, st.t_max, 2 * st.kb + 1
    states = _rlc_states(cpu_bm, rng, 256)
    C = states.shape[0]
    state = _random_state(rng, 8, C, R, S, bw, 1, gpu)
    state[0] = states.to(gpu)
    kept = 0
    for t in (0, T // 3, T // 2, T - 20, T - 1):
        n, _ = fused_vs_plain(bm, state, None, dyn["pchars"], T, t,
                              4 if k % 2 else 0, dyn["meta"].reshape(-1))
        kept += n
    assert kept > 0
    assert executor.KERNEL.by_entry.get("per_lane_rlc", 0) >= 5
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
