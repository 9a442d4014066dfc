"""The port's RLC (b-move) index against the JAX package's, on a small
repeat-rich world: five near-identical haplotypes of a 3 kbp base (so the
BWT has long runs) and a random tail, 17 kbp in all.

Every comparison is exact: the arrays the two builds write, every column of
the extensions (intervals, run hints and toeholds) along random walks with
direction flips from the full range (where the fast-forwards take their
binary-search fallback), locate on run heads, run tails, strided rows and
both ends, the exact match, ``run_scheme``'s whole frontier (``arg_b``
included) on the with-text and the textless index, and ``match_all``
against the JAX package and against the port's own Vanilla index. The port
runs its plain versions here (CPU tensors); the kernels are held to them on
the card in ``test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columba_tpu.index import bmove as jbm
from columba_tpu.ops import bextend as jbext, blocate as jbloc
from columba_tpu.ops import extend as jext
from columba_tpu.search import executor as jexe, pipeline as jpipe
from columba_tpu.search.scheme import get_scheme as jscheme
from columba_tpu_torch.index import bmove as tbm
from columba_tpu_torch.index.build import build_index_from_codes
from columba_tpu_torch.index.fmindex import FMIndex
from columba_tpu_torch.ops import bextend as tbext
from columba_tpu_torch.ops import extend as text, locate as tloc
from columba_tpu_torch.search import executor as texe, pipeline as tpipe
from columba_tpu_torch.search.scheme import get_scheme as tscheme

from tests.conftest import sample_reads

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(61)
    base = rng.integers(0, 4, 3000).astype(np.uint8)
    haps = [base]
    for _ in range(4):
        h = base.copy()
        snp = rng.random(len(h)) < 0.005
        h[snp] = (h[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
        haps.append(h)
    g = np.concatenate(haps + [rng.integers(0, 4, 2000).astype(np.uint8)])
    idx = {}
    for flavor, tl in (("rlc", False), ("textless", True)):
        ja = jbm.build_bmove_from_codes(g, textless=tl)
        ta = tbm.build_bmove_from_codes(g, textless=tl)
        idx[flavor] = (ja, ta, jbm.BMoveIndex.from_arrays(ja),
                       tbm.BMoveIndex.from_arrays(ta, "cpu"))
    return g, idx


def _key(occs):
    return list(zip(*(getattr(occs, f).tolist() for f in
                      ("read_id", "strand", "begin", "end", "distance"))))


@pytest.mark.parametrize("flavor", ["rlc", "textless"])
def test_build_identical_arrays(world, flavor):
    g, idx = world
    ja, ta, _, tb = idx[flavor]
    for name in jbm._BM_FIELDS:
        a, b = getattr(ja, name), getattr(ta, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ja.meta == ta.meta and ja.seq_names == ta.seq_names
    assert tb.r_fwd < len(g) / 3          # long runs: r well below n
    assert tb.range_width == (12 if flavor == "textless" else 8)


@pytest.mark.parametrize("flavor", ["rlc", "textless"])
def test_extension_random_walk(world, flavor):
    """Both packages extend in lockstep through random chars with random
    direction flips, from the full range (whose first extensions span many
    runs, so the fast-forwards fall back to the binary search); every
    column of extend_all and extend_char must agree at every step."""
    _, idx = world
    _, _, jb, tb = idx[flavor]
    rng = np.random.default_rng(62)
    ext_all = jax.jit(jbext.extend_all)
    ext_char = jax.jit(jbext.extend_char)
    B = 64
    full = tb.full_range((B,)).numpy()
    assert np.array_equal(np.asarray(jb.full_range((B,))).astype(np.int64),
                          full)
    cur = full
    for step in range(24):
        dirs = rng.integers(0, 2, B).astype(np.int32)
        chars = rng.integers(0, 5, B).astype(np.int32)
        want = np.asarray(ext_all(jb, jnp.asarray(cur.astype(np.uint32)),
                                  jnp.asarray(dirs))).astype(np.int64)
        got = text.extend_all(tb, torch.from_numpy(cur),
                              torch.from_numpy(dirs)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
        want_c = np.asarray(ext_char(
            jb, jnp.asarray(cur.astype(np.uint32)), jnp.asarray(chars),
            jnp.asarray(dirs))).astype(np.int64)
        got_c = text.extend_char(tb, torch.from_numpy(cur),
                                 torch.from_numpy(chars),
                                 torch.from_numpy(dirs)).numpy()
        np.testing.assert_array_equal(got_c, want_c, err_msg=f"step {step}")
        live = want[..., 1] > want[..., 0]
        pick = rng.integers(0, 4, B)
        ok = live[np.arange(B), pick]
        cur = np.where(ok[:, None], want[np.arange(B), pick], full)
    assert ok.any()


@pytest.mark.parametrize("forward", [True, False])
def test_walk_stats_count_per_lane_reads(world, forward):
    """The walk and probe counts behind tools/bounds.py's byte bound are the
    4 B reads of a thread that walks each live element alone, as the kernels
    do: the first check and one per step, then, only where the capped walk
    fell short, the probes of its binary search. Dead elements (frozen at
    run 0, pos 0) and walks that end in place read no probe."""
    _, idx = world
    _, _, _, tb = idx["rlc"]
    fused = (tb.fused.long() & tbext.MASK32).numpy()
    rng = np.random.default_rng(68)
    N, dead = 96, 16
    offs = rng.choice([0, tb.r_fwd + 1], N)
    pos = rng.integers(0, tb.n + 1, N)
    shift = rng.choice([0, 1, 5, 16, 17, 400], N)
    truth, hint, reads = [], [], 0
    for o, p, s in zip(offs, pos, shift):
        r_limit = tb.r_fwd if o == 0 else tb.r_rev
        t = int(np.searchsorted(fused[o:o + r_limit, 0], p, "right")) - 1
        run = min(max(t - s if forward else t + s, 0), r_limit - 1)
        truth.append(t)
        hint.append(run)
        col = 1 if forward else 0

        def off_side(v):
            return v <= p if forward else v > p
        reads += 1
        steps = 0
        while steps < tbext.FF_CAP and off_side(fused[o + run, col]):
            run += 1 if forward else -1
            reads += 1
            steps += 1
        if off_side(fused[o + run, col]):
            lo, hi = (run if forward else 0), r_limit - 1
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                reads += 1
                lo, hi = (mid, hi) if fused[o + mid, 0] <= p else (lo, mid - 1)
    live = torch.arange(N + dead) < N
    pad = [0] * dead
    args = [torch.tensor(list(v) + pad) for v in (offs, hint, pos)]
    stats: dict = {}
    walk = tbext.ff_forward if forward else tbext.ff_backward
    got = walk(tb, *args, stats, live)
    assert got[:N].tolist() == truth
    assert stats["walk"] + stats.get("probes", 0) == reads
    assert stats.get("probes", 0) > 0 and (shift == 0).any()


def test_run_tables_hold_every_run(world):
    """Kernels E and F's run tables: each direction's STARTs, the
    sentinel's and n + 1 at least 13 entries past it, 16 B aligned; from
    every position's bucket a forward walk reaches the run that holds it;
    the textless index keeps none."""
    g, idx = world
    _, ta, _, tb = idx["rlc"]
    n = len(g)
    starts = tb.starts.numpy().view(np.uint32)
    assert tb.starts_rev % 4 == 0 and len(starts) % 4 == 0
    pos = torch.arange(n + 1, dtype=torch.int64)
    for off, end, fused, r, run_at in (
            (0, tb.starts_rev, ta.fused_fwd, tb.r_fwd, tb.run_at),
            (tb.starts_rev, len(starts), ta.fused_rev, tb.r_rev,
             tb.run_at_rev)):
        s = starts[off:end]
        np.testing.assert_array_equal(s[:r + 1], fused[:r + 1, 0])
        assert len(s) >= r + 13 and (s[r:] == n + 1).all()
        want = np.searchsorted(s[:r], pos.numpy(), side="right") - 1
        run = run_at[pos >> tb.run_shift].long()
        st = torch.from_numpy(s.astype(np.int64))
        while bool((adv := st[run + 1] <= pos).any()):
            run += adv.long()
        np.testing.assert_array_equal(run.numpy(), want)
    tl = idx["textless"][3]
    assert tl.starts.numel() == 0 and tl.run_at_rev.numel() == 0


@pytest.mark.parametrize("forward", [True, False])
def test_run_tables_walk_to_the_same_runs(world, forward):
    """The walks on the run tables (``bextend.walk_tables``, kernels E and
    F's) end at the run that ``ff_forward`` / ``ff_backward`` on the fused
    rows and the JAX package's ``_ff_forward`` / ``_ff_backward`` reach,
    in both directions: hints at the target, within and past ``FF_CAP``
    runs of it, at run 0 and at the sentinel, positions 0 and n among
    them. Past the cap the binary search's probes become one bucket read
    and a forward walk over START; the capped walk reads as many runs."""
    g, idx = world
    _, _, jb, tb = idx["rlc"]
    n = len(g)
    rng = np.random.default_rng(70)
    N = 3000
    rev = rng.random(N) < 0.5
    offs = np.where(rev, tb.r_fwd + 1, 0)
    r_lim = np.where(rev, tb.r_rev, tb.r_fwd)
    pos = rng.integers(0, n + 1, N)
    pos[:4] = [0, n, 0, n]
    fused = (tb.fused.long() & tbext.MASK32).numpy()
    truth = np.array([np.searchsorted(fused[o:o + r, 0], p, "right") - 1
                      for o, r, p in zip(offs, r_lim, pos)])
    shift = rng.choice([0, 1, 7, 8, 9, 16, 17, 30, 400], N)
    hint = np.clip(truth - shift if forward else truth + shift, 0, r_lim)
    hint[:2] = 0
    hint[2:4] = r_lim[2:4]                 # the sentinel row
    args = [torch.from_numpy(np.asarray(v, np.int64))
            for v in (offs, hint, pos)]
    fstats, tstats = {}, {}
    want = (tbext.ff_forward if forward else tbext.ff_backward)(
        tb, *args, fstats)
    got, rounds = tbext.walk_tables(tb, *args, forward, tstats)
    assert torch.equal(got, want)
    jwalk = jbext._ff_forward if forward else jbext._ff_backward
    jgot = np.asarray(jwalk(jb, *(jnp.asarray(a.numpy().astype(np.int32))
                                  for a in args)))
    np.testing.assert_array_equal(got.numpy(), jgot)
    behind = (truth - hint if forward else hint - truth) > tbext.FF_CAP
    assert behind.any() and (got.numpy()[behind] == truth[behind]).all()
    assert tstats["walk"] == fstats["walk"] and "probes" not in tstats
    assert tstats["bucket"] == int(behind.sum()) and fstats["probes"] > 0
    near = np.abs(got.numpy() - hint) < tbext.WINDOW
    assert (rounds.numpy()[near] == 1).all()
    assert (rounds.numpy()[~near] >= 3).all() and (~near).any()


def test_locate_rows(world):
    """Locate on run heads and tails, strided rows, row 0 and row n, and
    random rows."""
    g, idx = world
    ja, _, jb, tb = idx["rlc"]
    rng = np.random.default_rng(63)
    n = len(g)
    rows = np.concatenate([
        [0, n], ja.fused_fwd[:200, 0].astype(np.int64),
        ja.fused_fwd[:200, 1].astype(np.int64) - 1,
        np.arange(0, n + 1, 64), rng.integers(0, n + 1, 300)])
    want = np.asarray(jax.jit(jbloc.locate_rows)(
        jb, jnp.asarray(rows.astype(np.int32)))).astype(np.int64)
    got = tloc.locate_rows(tb, torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want[0] == n


def test_locate_tables_find_every_run(world):
    """Kernel C's RLC walk tables: the walk table is the forward runs'
    START END LF_POS LF_RUN with the sentinel row, and from every row's
    bucket a forward walk over END reaches the run the JAX package's binary
    search finds; the textless index keeps none."""
    g, idx = world
    ja, ta, jb, tb = idx["rlc"]
    n, r = len(g), tb.r_fwd
    np.testing.assert_array_equal(tb.walk.numpy().view(np.uint32),
                                  ta.fused_fwd[:r + 1, :4])
    rows = np.arange(n + 1, dtype=np.int64)
    want = np.asarray(jax.jit(jbloc.run_of_rows)(
        jb, jnp.asarray(rows.astype(np.int32)))).astype(np.int64)
    end = tb.walk[:, 1].long() & 0xFFFFFFFF
    t_rows = torch.from_numpy(rows)
    run = tb.run_at[t_rows >> tb.run_shift].long()
    walked = torch.zeros_like(run)
    while bool((adv := end[run] <= t_rows).any()):
        run, walked = run + adv.long(), walked + adv.long()
    np.testing.assert_array_equal(run.numpy(), want)
    assert 0 < float(walked.float().mean()) < 2    # about two runs a bucket
    tl = idx["textless"][3]
    assert tl.walk.numel() == 0 and tl.run_at.numel() == 0


def test_locate_stats_count_the_kernels_reads(world):
    """The counts behind tools/bounds.py's ``locate_rlc`` are the 16 B
    walk-table words of a thread that locates each row alone, as kernel C's
    RLC entry does: its bucket's run and one word a run up to the row's
    run, then per LF step the landing run's word and one a fast-forward;
    no binary-search probe. The bound counts those words and two 4 B reads
    a row (the bucket table and the sample)."""
    from columba_tpu_torch.ops import blocate
    from columba_tpu_torch.tools import bounds

    g, idx = world
    tb = idx["rlc"][3]
    walk = (tb.walk.long() & tbext.MASK32).numpy()
    run_at = tb.run_at.numpy()
    rng = np.random.default_rng(69)
    rows = np.concatenate([[0, len(g)], rng.integers(0, len(g) + 1, 400)])
    mask = tb.stride - 1
    bucket = steps = words = 0
    for pos in rows.tolist():
        run = int(run_at[pos >> tb.run_shift])
        bucket += 1
        while walk[run, 1] <= pos:
            run += 1
            bucket += 1
        while not (pos in (walk[run, 0], walk[run, 1] - 1)
                   or pos & mask == 0):
            pos = int(walk[run, 2] + pos - walk[run, 0])
            run = int(walk[run, 3])
            steps += 1
            words += 1
            while walk[run, 1] <= pos:
                run += 1
                words += 1
    t_rows = torch.from_numpy(rows)
    stats: dict = {}
    out = blocate.locate_rows_plain(tb, t_rows, stats)
    assert "probes" not in stats
    assert (stats["bucket"], stats["steps"], stats["walk"]) == (
        bucket, steps, words)
    b = bounds.locate_rlc(t_rows, stats, out)
    assert b["bytes"] == len(rows) * (8 + 4 + 4 + 8) + (bucket + words) * 16


def test_exact_match(world):
    g, idx = world
    _, _, jb, tb = idx["rlc"]
    rng = np.random.default_rng(64)
    pats = np.stack([g[p:p + 24] for p in
                     rng.integers(0, len(g) - 24, 48)]).astype(np.uint8)
    pats[::5, 7] ^= 1                     # some miss
    pats[3, 11] = 4                       # an N never matches
    want = np.asarray(jext.exact_match(
        jb, jnp.asarray(pats.astype(np.int32)))).astype(np.int64)
    got = text.exact_match(tb, torch.from_numpy(pats)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < int((want[:, 1] > want[:, 0]).sum()) < len(pats)


@pytest.mark.parametrize("flavor,switchpoint", [("rlc", 4),
                                                ("textless", 0)])
def test_run_scheme_frontier(world, flavor, switchpoint):
    """run_scheme's whole FrontierResult on 8-wide lanes with the in-text
    crossover, and on 12-wide textless lanes with track_arg (the JAX
    package's _textless_device), arg_b included."""
    g, idx = world
    _, _, jb, tb = idx[flavor]
    rng = np.random.default_rng(65)
    reads = sample_reads(rng, g, num=16, length=60, max_err=2, edits=True)
    batch = np.concatenate([reads, reads[:, ::-1] ^ 3]).astype(np.uint8)
    scheme, cap = jscheme("kuch1", 2), 1024
    sched = jpipe.compile_cached(scheme, 60, "edit", kmer_k=0)
    tsched = tpipe.compile_cached(tscheme("kuch1", 2), 60, "edit")
    track = flavor == "textless"
    itv_cap, ss, c2 = jpipe.crossover_caps(cap, 4096, switchpoint)
    res = jax.jit(lambda ix, rd: jexe.run_scheme(
        ix, rd, sched, cap, None, None, None, switchpoint, itv_cap, ss, c2,
        16, track_arg=track))(jb, jnp.asarray(batch.astype(np.int32)))
    got = texe.run_scheme(tb, torch.from_numpy(batch), tsched, cap, None,
                          switchpoint, itv_cap, ss, c2, itv_min_depth=16,
                          track_arg=track)
    for f in ("ranges", "rid", "sid", "ed_lb", "done", "overflow",
              "nodes_visited", "itv", "itv_count", "searches_started",
              "arg_b"):
        want = np.asarray(getattr(res, f))
        have = getattr(got, f).numpy()
        np.testing.assert_array_equal(have.astype(np.int64),
                                      want.astype(np.int64), err_msg=f)
    assert got.done.any() and int(got.overflow) == 0
    assert (got.arg_b >= 0).any() if track else (got.arg_b == -1).all()


@pytest.mark.parametrize("metric,switchpoint", [
    ("edit", 0), ("edit", 4), ("hamming", 0), ("hamming", 4)])
def test_match_all_rlc(world, metric, switchpoint):
    """match_all on the with-text RLC index: the same OccArray as the JAX
    package's, and the same occurrence set as the port's own Vanilla index
    (the reference's cross-flavor conformance, tests/test_bmove.py)."""
    g, idx = world
    _, _, jb, tb = idx["rlc"]
    rng = np.random.default_rng(66 + switchpoint)
    reads = sample_reads(rng, g, num=12, length=60, max_err=2,
                         edits=metric == "edit")
    want, _ = jpipe.match_all(jb, reads, jscheme("kuch1", 2), metric=metric,
                              switchpoint=switchpoint)
    got, stats = tpipe.match_all(tb, reads, tscheme("kuch1", 2),
                                 metric=metric, switchpoint=switchpoint)
    assert _key(got) == _key(want) and len(got) >= 12
    assert stats["overflow"] == 0
    fm = FMIndex.from_arrays(build_index_from_codes(g), "cpu")
    kw = dict(metric=metric, switchpoint=switchpoint,
              redundancy_filter=False)
    o_fm, _ = tpipe.match_all(fm, reads, tscheme("kuch1", 2), **kw)
    o_bm, _ = tpipe.match_all(tb, reads, tscheme("kuch1", 2), **kw)

    def key(o):
        return set(zip(o.read_id.tolist(), o.strand.tolist(),
                       o.end.tolist(), o.distance.tolist()))
    assert key(o_bm) == key(o_fm)


@pytest.mark.parametrize("k", [2, 0])
def test_match_all_textless(world, k):
    """match_all on the textless index (frontier pass + phi locate on the
    host) gives the JAX package's OccArray, at k = 2 and through the k = 0
    frontier; a scheme collection collapses to its first scheme."""
    g, idx = world
    ja, ta, jb, tb = idx["textless"]
    rng = np.random.default_rng(67 + k)
    reads = sample_reads(rng, g, num=12, length=60, max_err=k, edits=True)
    want, _ = jpipe.match_all(jb, reads, jscheme("kuch1", k), metric="edit",
                              host_arrays=ja)
    got, _ = tpipe.match_all(tb, reads, tscheme("kuch1", k), metric="edit",
                             host_arrays=ta)
    assert _key(got) == _key(want) and len(got) >= 12
    if k:
        coll = [tscheme("kuch1", k), tscheme("kuch1", k).mirrored()]
        got_c, _ = tpipe.match_all(tb, reads, coll, metric="edit",
                                   host_arrays=ta)
        assert _key(got_c) == _key(got)
