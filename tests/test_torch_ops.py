"""The port's device ops (plain PyTorch versions) against the JAX package.

Same inputs, made with numpy from a seed, go through ``columba_tpu`` on the
CPU and through ``columba_tpu_torch`` on the CPU; all the arithmetic is
integer, so every output must be exactly equal. Ranges and positions are
uint32 in the JAX package and int64 (same values) in the port; window
starts below 0 are wrapped uint32 in the JAX package and signed in the port.
The JAX functions run under ``jax.jit``, as the JAX pipeline runs them:
one compile per call instead of one per primitive.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columba_tpu.index import kmer as jkmer
from columba_tpu.index.build import build_index_from_codes
from columba_tpu.index.fmindex import FMIndex as JFMIndex
from columba_tpu.ops import extend as jextend
from columba_tpu.ops import locate as jlocate
from columba_tpu.ops import rank as jrank
from columba_tpu.ops import verify as jverify
from columba_tpu_torch.index import kmer as tkmer
from columba_tpu_torch.index.fmindex import FMIndex as TFMIndex
from columba_tpu_torch.ops import extend as textend
from columba_tpu_torch.ops import locate as tlocate
from columba_tpu_torch.ops import rank as trank
from columba_tpu_torch.ops import verify as tverify

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both(small_index):
    g, arrays = small_index
    return g, JFMIndex.from_arrays(arrays), TFMIndex.from_arrays(arrays)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    return np.asarray(a).astype(np.int64)


@pytest.fixture(scope="module")
def tables(both):
    _, jfm, tfm = both
    return jkmer.build_kmer_table(jfm, 6), tkmer.build_kmer_table(tfm, 6)


def _ranges(rng, g, table, L):
    """Real range pairs: 6-mer seeds of random genome windows, plus the
    full range and empty ones."""
    pos = rng.integers(0, len(g) - 6, L)
    win = g[pos[:, None] + np.arange(6)]
    r = np.asarray(jkmer.lookup(table, jnp.asarray(win))).astype(np.int64)
    r[:4] = [0, len(g) + 1, 0, len(g) + 1]
    r[4:8] = 0
    return r


def test_occ_all_and_char(both):
    g, jfm, tfm = both
    rng = np.random.default_rng(21)
    pos = rng.integers(0, tfm.n + 2, 3000)
    extra = rng.integers(0, 2, 3000) * tfm.blocks
    j_occ = jax.jit(jrank.occ_all)(jfm.occ_fused, jnp.asarray(pos, jnp.uint32),
                                   jnp.asarray(extra, jnp.int32))
    t_occ = trank.occ_all(tfm.occ_fused, _t(pos), _t(extra))
    np.testing.assert_array_equal(_np(j_occ), t_occ.numpy())
    j_occ, j_c = jax.jit(jrank.occ_all_and_char)(
        jfm.occ_fused, jnp.asarray(pos, jnp.uint32))
    t_occ, t_c = trank.occ_all_and_char(tfm.occ_fused, _t(pos))
    np.testing.assert_array_equal(_np(j_occ), t_occ.numpy())
    np.testing.assert_array_equal(_np(j_c), t_c.numpy())


def test_extend_all_and_char(both, tables):
    g, jfm, tfm = both
    rng = np.random.default_rng(22)
    L = 2000
    r = _ranges(rng, g, tables[0], L)
    dirs = rng.integers(0, 2, L).astype(np.int32)
    chars = rng.integers(0, 5, L).astype(np.int32)     # 4 = N
    j_all = jax.jit(lambda r, d: jextend.extend_all(jfm, r, d))(
        jnp.asarray(r, jnp.uint32), jnp.asarray(dirs))
    t_all = textend.extend_all(tfm, _t(r), _t(dirs))
    np.testing.assert_array_equal(_np(j_all), t_all.numpy())
    j_ch = jax.jit(lambda r, c, d: jextend.extend_char(jfm, r, c, d))(
        jnp.asarray(r, jnp.uint32), jnp.asarray(chars), jnp.asarray(dirs))
    t_ch = textend.extend_char(tfm, _t(r), _t(chars), _t(dirs))
    np.testing.assert_array_equal(_np(j_ch), t_ch.numpy())


def test_kmer_table_and_lookup(both, tables):
    g, _, _ = both
    j_tab, t_tab = tables
    np.testing.assert_array_equal(_np(j_tab), t_tab.numpy())
    rng = np.random.default_rng(23)
    win = g[rng.integers(0, len(g) - 6, 500)[:, None] + np.arange(6)]
    win[::9, 3] = 4                                     # windows with N
    np.testing.assert_array_equal(
        _np(jkmer.lookup(j_tab, jnp.asarray(win))),
        tkmer.lookup(t_tab, _t(win)).numpy())


def test_kmer_cache_interchange(both, tables, tmp_path):
    """The port reads the JAX package's kmer{K}.npy and writes the same
    file itself."""
    _, jfm, tfm = both
    jkmer.build_kmer_table_cached(jfm, 6, str(tmp_path))
    got = tkmer.build_kmer_table_cached(tfm, 6, str(tmp_path))
    np.testing.assert_array_equal(got.numpy(), tables[1].numpy())
    own = tmp_path / "own"
    own.mkdir()
    tkmer.build_kmer_table_cached(tfm, 6, str(own))
    a, b = np.load(tmp_path / "kmer6.npy"), np.load(own / "kmer6.npy")
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("f", [1, 4])
def test_locate_rows(both, f):
    g, jfm, tfm = both
    if f == 1:
        arrays = build_index_from_codes(g, sa_sparseness=1)
        jfm, tfm = JFMIndex.from_arrays(arrays), TFMIndex.from_arrays(arrays)
    rows = np.arange(tfm.n + 1)
    np.testing.assert_array_equal(
        _np(jax.jit(lambda r: jlocate.locate_rows(jfm, r))(
            jnp.asarray(rows, jnp.uint32))),
        tlocate.locate_rows(tfm, _t(rows)).numpy())


def test_gather_and_verify_window(both):
    g, jfm, tfm = both
    kb = 2                                   # the slice's band radius
    rng = np.random.default_rng(24 + kb)
    n, m, B = tfm.n, 100, 600
    starts = rng.integers(-kb, n - m, B)
    starts[:2 * kb] = np.arange(-kb, kb)                 # below / at 0
    starts[8:24] = n - m + rng.integers(-5, 40, 16)       # near / past n
    reads = g[np.clip(starts[:48, None] + kb + np.arange(m), 0, n - 1)]
    reads[::5, 37] = 4                                    # reads with N
    rid = rng.integers(0, 48, B)
    wrapped = (starts & 0xFFFFFFFF).astype(np.uint32)
    W = m + 3 * kb + 1
    np.testing.assert_array_equal(
        _np(jax.jit(lambda s: jverify.gather_window(jfm, s, W))(
            jnp.asarray(wrapped))),
        tverify.gather_window(tfm, _t(starts), W).numpy())
    j_rows = jax.jit(lambda p, r, s: jverify.verify_window(jfm, p, r, s, kb))(
        jnp.asarray(reads.astype(np.int32)), jnp.asarray(rid),
        jnp.asarray(wrapped))
    t_rows = tverify.verify_window(tfm, _t(reads.astype(np.uint8)), _t(rid),
                                   _t(starts), kb)
    np.testing.assert_array_equal(_np(j_rows), t_rows.numpy())
