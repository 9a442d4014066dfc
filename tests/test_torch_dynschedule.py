"""The port's per-read schedules against the JAX package's.

``clamp_partition``, ``build_tables`` (every key) and ``dynamic_partition``
of both packages run on the same inputs, made with numpy from a seed; exact
equality, tolerance 0 (all the arithmetic is integer). The JAX functions run
under ``jax.jit``, as its pipeline runs them. One hand-made case holds the
32-bit wrap of width x weight in the partition scan: the JAX scan's body on
int32 against the port's ``weighted_widths``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columba_tpu.index import kmer as jkmer
from columba_tpu.index.fmindex import FMIndex as JFMIndex
from columba_tpu.search import dynschedule as jdyn
from columba_tpu.search.scheme import get_scheme as jscheme
from columba_tpu_torch.index import kmer as tkmer
from columba_tpu_torch.index.fmindex import FMIndex as TFMIndex
from columba_tpu_torch.search import dynschedule as tdyn
from columba_tpu_torch.search.scheme import get_scheme as tscheme

torch.set_num_threads(1)


def random_pts(rng, rows, p, m, k):
    """Random boundaries with every part longer than 2k."""
    pts = np.zeros((rows, p + 1), dtype=np.int32)
    for r in range(rows):
        while True:
            cuts = np.sort(rng.integers(6, m - 6, size=p - 1))
            cand = np.concatenate([[0], cuts, [m]])
            if np.diff(cand).min() > 2 * k:
                pts[r] = cand
                break
    return pts


def sample_reads(rng, g, num, m, max_err):
    starts = rng.integers(0, len(g) - m, num)
    reads = g[starts[:, None] + np.arange(m)].copy()
    for r in reads:
        k = rng.integers(0, max_err + 1)
        r[rng.integers(0, m, k)] = rng.integers(0, 4, k)
    reads[1, m // 3] = 4                                    # a read with N
    return reads.astype(np.uint8)


def test_clamp_partition():
    rng = np.random.default_rng(71)
    m = 90
    for p, kb in ((3, 2), (5, 4), (4, 0), (6, 3)):
        pts = np.sort(rng.integers(0, m + 1, (200, p + 1)), axis=1).astype(
            np.int32)
        pts[:, 0], pts[:, p] = 0, m
        pts[:5] = 0                                         # all cuts at 0
        pts[5:10, 1:] = m                                   # all cuts at m
        want = jax.jit(jdyn.clamp_partition, static_argnums=(1, 2))(
            jnp.asarray(pts), m, kb)
        got = tdyn.clamp_partition(torch.from_numpy(pts), m, kb)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
        if kb:
            assert np.diff(got.numpy(), axis=1).min() >= 2 * kb + 1


@pytest.mark.parametrize("name,k,metric", [
    ("kuch1", 2, "edit"),        # the smoke's scheme: 3 searches, 3 parts
    ("columba", 3, "edit"),      # more searches, exact prefixes of 2 phases
    ("kuch1", 2, "hamming"),     # kb = 0: a band of one cell
])
def test_build_tables(small_index, name, k, metric):
    g, _ = small_index
    rng = np.random.default_rng(72 + k)
    m = 90
    reads = sample_reads(rng, g, 12, m, k)
    jsc, tsc = jscheme(name, k), tscheme(name, k)
    pts = random_pts(rng, len(reads), jsc.num_parts, m, k)
    jst = jdyn.scheme_static(jsc, m, metric)
    tst = tdyn.scheme_static(tsc, m, metric)
    for f in ("side", "upper", "lo", "hi", "is_exact", "pi0", "pivot_left",
              "u_last", "n_exact"):
        np.testing.assert_array_equal(getattr(jst, f), getattr(tst, f), f)
    want = jax.jit(lambda p_, r_: jdyn.build_tables(jst, p_, r_))(
        jnp.asarray(pts), jnp.asarray(reads.astype(np.int32)))
    got = tdyn.build_tables(tst, torch.from_numpy(pts),
                            torch.from_numpy(reads))
    assert set(want) == set(got)
    for key in want:
        w = np.asarray(want[key])
        assert w.shape == tuple(got[key].shape), key
        np.testing.assert_array_equal(w.astype(np.int64),
                                      got[key].numpy().astype(np.int64), key)
    # the clamp is folded in: boundaries that need it give the tables of the
    # clamped boundaries (the JAX pipeline clamps, then builds)
    raw = pts.copy()
    raw[:, 1] = 1
    clamped = tdyn.clamp_partition(torch.from_numpy(raw), m, tst.kb)
    assert not torch.equal(clamped, torch.from_numpy(raw)) or tst.kb == 0
    a = tdyn.build_tables(tst, torch.from_numpy(raw), torch.from_numpy(reads))
    b = tdyn.build_tables(tst, clamped, torch.from_numpy(reads))
    for key in a:
        assert torch.equal(a[key], b[key]), key


@pytest.mark.parametrize("name,k,table_k,m", [
    ("kuch1", 2, 6, 90),      # seeded from the k-mer table, kuch_k+1's
                              # weights (39, 10, 40) and seed fractions
    ("kuch1", 2, 0, 90),      # no table: single-character seeds
    ("kuch1", 4, 6, 40),      # p*K >= 2m/3: falls back to K = 1
    ("pigeon", 3, 6, 90),     # no weights or fractions: uniform seeds
])
def test_dynamic_partition(small_index, name, k, table_k, m):
    g, arrays = small_index
    rng = np.random.default_rng(73 + k + table_k)
    reads = sample_reads(rng, g, 24, m, k)
    reads[2] = 0                                            # homopolymer
    jfm = JFMIndex.from_arrays(arrays)
    tfm = TFMIndex.from_arrays(arrays, "cpu")
    jtab = jkmer.build_kmer_table(jfm, table_k) if table_k else None
    ttab = tkmer.build_kmer_table(tfm, table_k) if table_k else None
    jsc, tsc = jscheme(name, k), tscheme(name, k)
    assert jsc.weights == tsc.weights and jsc.seed_fracs == tsc.seed_fracs
    assert jsc.static_fracs == tsc.static_fracs
    want = jax.jit(lambda r_, t_: jdyn.dynamic_partition(jfm, r_, jsc, t_))(
        jnp.asarray(reads.astype(np.int32)), jtab)
    got = tdyn.dynamic_partition(tfm, torch.from_numpy(reads), tsc, ttab)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got.dtype == torch.int32
    # parts differ between reads: the partition is per read
    assert len({tuple(r) for r in got.numpy().tolist()}) > 1


def test_weighted_width_wraps_as_int32():
    """A width of 2^30 times kuch1's weights wraps in 32 bits: the JAX scan
    multiplies int32 arrays; the port's plain scan must pick the same part."""
    widths = np.array([[1 << 30, 1 << 30, 1 << 30],
                       [1 << 30, 5, 1 << 29],
                       [30_000_000, 21_000_000, 7]], dtype=np.int64)
    weights = np.array([39, 10, 40], dtype=np.int64)
    ext = np.array([[True, True, True], [True, False, True],
                    [True, True, True]])
    want = jnp.where(jnp.asarray(ext),
                     jnp.asarray(widths.astype(np.int32))
                     * jnp.asarray(weights.astype(np.int32))[None], -1)
    got = tdyn.weighted_widths(torch.from_numpy(widths),
                               torch.from_numpy(weights)[None],
                               torch.from_numpy(ext))
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64),
                                  got.numpy())
    assert (got.numpy() < -1).any()                         # it did wrap
    np.testing.assert_array_equal(
        np.asarray(jnp.argmax(want, axis=1)),
        torch.where(got == got.max(dim=1, keepdim=True).values,
                    torch.arange(3)[None], 3).min(dim=1).values.numpy())
