"""Per-read scheme selection of the port against the JAX package's.

``exact_match`` with per-row lengths, ``part_exact_ranges``,
``select_schemes`` (mask and choice) and ``match_all`` with a list of
schemes run on the same numpy inputs in both packages; exact equality. A
row without a match is an arbitrary empty range in the JAX package (its
loop keeps extending) and the zero range in the port (kernel E stops
there), so the JAX side's empty rows are zeroed before the comparison; the
widths, which are all that selection reads, are compared as they are.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columba_tpu.index.fmindex import FMIndex as JFMIndex
from columba_tpu.ops import extend as jext
from columba_tpu.search import pipeline as jpipe
from columba_tpu.search import scheme as jschemes
from columba_tpu_torch.index.fmindex import FMIndex as TFMIndex
from columba_tpu_torch.ops import extend as text
from columba_tpu_torch.search import pipeline as tpipe
from columba_tpu_torch.search import scheme as tschemes

from tests.test_torch_executor import repeat_genome, sample_batch

torch.set_num_threads(1)


def zero_empty(r):
    r = np.asarray(r).astype(np.int64)
    return np.where((r[..., 1] > r[..., 0])[..., None], r, 0)


@pytest.fixture(scope="module")
def world():
    from columba_tpu.index.build import build_index_from_codes

    rng = np.random.default_rng(81)
    g = repeat_genome(rng)
    arrays = build_index_from_codes(g)
    return dict(g=g, jfm=JFMIndex.from_arrays(arrays),
                tfm=TFMIndex.from_arrays(arrays, "cpu"),
                batch=sample_batch(rng, g, 48))


def test_exact_match_lengths(world):
    rng = np.random.default_rng(82)
    g = world["g"]
    B, m = 96, 34
    lengths = rng.integers(0, m + 1, B).astype(np.int32)
    lengths[:3] = [0, 1, m]
    starts = rng.integers(0, len(g) - m, B)
    pats = g[starts[:, None] + np.arange(m)].copy()
    pats[10, 3] = 4                                  # N inside the pattern
    lengths[10] = 20
    pats[20:30, 5] ^= 1                              # mostly no match
    for i, n in enumerate(lengths):
        pats[i, n:] = 5                              # padding
    want = jax.jit(lambda p_, l_: jext.exact_match(world["jfm"], p_, l_))(
        jnp.asarray(pats.astype(np.int32)), jnp.asarray(lengths))
    tp, tl = torch.from_numpy(pats.astype(np.uint8)), torch.from_numpy(lengths)
    # the plain version keeps the empty ranges the JAX loop leaves
    np.testing.assert_array_equal(
        np.asarray(want).astype(np.int64),
        text.exact_match_plain(world["tfm"], tp, tl).numpy())
    got = text.exact_match(world["tfm"], tp, tl).numpy()
    np.testing.assert_array_equal(zero_empty(want), got)
    assert (got[:, 1] > got[:, 0]).sum() > B // 2
    # None means every row has m chars
    full = np.full(B, m, np.int32)
    np.testing.assert_array_equal(
        text.exact_match(world["tfm"], tp, torch.from_numpy(full)).numpy(),
        text.exact_match(world["tfm"], tp).numpy())


def test_part_exact_ranges(world):
    batch = world["batch"]
    pts = [0, 30, 71, 100]                           # parts of unequal length
    want = jax.jit(lambda b: jpipe.part_exact_ranges(world["jfm"], b, pts))(
        jnp.asarray(batch.astype(np.int32)))
    got = tpipe.part_exact_ranges(world["tfm"], torch.from_numpy(batch), pts)
    assert tuple(got.shape) == (len(batch), 3, 4)
    np.testing.assert_array_equal(zero_empty(want), got.numpy())
    w = np.asarray(want).astype(np.int64)
    np.testing.assert_array_equal(w[..., 1] - w[..., 0],
                                  got.numpy()[..., 1] - got.numpy()[..., 0])


def test_multi_scheme_sets(tmp_path):
    """get_multi_scheme and load_multi_scheme_folder give the JAX package's
    schemes, search by search."""
    multi = tmp_path / "multi" / "2"
    multi.mkdir(parents=True)
    base = tschemes.get_scheme("kuch1", 2)
    (multi / "scheme1.txt").write_text(str(base) + "\n")
    (multi / "scheme2.txt").write_text(str(base.mirrored()) + "\n")
    for name, k in (("columba", 2), ("columba", 3), ("columba", 6),
                    ("kuch1", 2), ("pigeon", 3), (str(tmp_path / "multi"), 2)):
        want = jschemes.get_multi_scheme(name, k)
        got = tschemes.get_multi_scheme(name, k)
        assert [str(s) for s in want] == [str(s) for s in got], (name, k)
        assert [s.critical_part_index for s in want] == \
            [s.critical_part_index for s in got]
        assert [(s.weights, s.seed_fracs, s.static_fracs) for s in want] == \
            [(s.weights, s.seed_fracs, s.static_fracs) for s in got]
    with pytest.raises(ValueError, match="scheme1.txt"):
        tschemes.load_multi_scheme_folder(str(tmp_path / "multi"), 3)


def test_select_schemes(world):
    batch = world["batch"]
    jset = jschemes.get_multi_scheme("columba", 2)
    tset = tschemes.get_multi_scheme("columba", 2)
    jc, jmask, jchoice = jpipe.select_schemes(
        world["jfm"], jnp.asarray(batch.astype(np.int32)), jset)
    tc, tmask, tchoice = tpipe.select_schemes(
        world["tfm"], torch.from_numpy(batch), tset)
    assert str(jc) == str(tc) and jc.name == tc.name
    np.testing.assert_array_equal(jmask, tmask)
    np.testing.assert_array_equal(jchoice, tchoice)
    assert len(set(tchoice.tolist())) > 1            # the choice is per read


def test_match_all_scheme_list(world):
    """match_all with a list of schemes: probe, masked combined pass, and
    the capacity taken from the mask."""
    reads = world["batch"][:48]
    jset = jschemes.get_multi_scheme("kuch1", 2)
    tset = tschemes.get_multi_scheme("kuch1", 2)
    kw = dict(metric="edit", switchpoint=4)
    j_occ, j_stats = jpipe.match_all(world["jfm"], reads, jset, **kw)
    t_occ, t_stats = tpipe.match_all(world["tfm"], reads, tset, **kw)
    assert t_stats == j_stats
    for f in ("read_id", "strand", "begin", "end", "distance"):
        np.testing.assert_array_equal(getattr(j_occ, f), getattr(t_occ, f),
                                      err_msg=f)
    assert len(t_occ) >= 48
