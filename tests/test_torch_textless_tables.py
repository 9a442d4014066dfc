"""The textless RLC index's run tables, against the JAX package.

Kernels A and B walk the run hints of the textless index's 12-wide lanes on
the same compact run tables as the with-text index (``index/bmove.py``
``run_tables``: one 4 B START a run a direction, bucket tables past eight
runs). These tests hold those tables, on a tiny genome (the conftest's
``small_index`` genome, 20 kbp), to the fused rows' walks and to the JAX
package's ``_ff_forward`` / ``_ff_backward``, and the plain extension on
them (``extend_all_plain`` / ``extend_char_plain`` with ``tables=True``,
the kernels' walks) to the JAX package's ``extend_all`` / ``extend_char``
along random walks: every one of the 12 columns, toehold included, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columba_tpu.index import bmove as jbm
from columba_tpu.ops import bextend as jbext
from columba_tpu_torch.index import bmove as tbm
from columba_tpu_torch.ops import bextend as tbext

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def textless(small_index):
    g = small_index[0]
    ja = jbm.build_bmove_from_codes(g, textless=True)
    ta = tbm.build_bmove_from_codes(g, textless=True)
    return g, ja, jbm.BMoveIndex.from_arrays(ja), \
        tbm.BMoveIndex.from_arrays(ta, "cpu")


def test_textless_run_tables_bytes(textless):
    """The textless index holds run tables (and no walk table): 4 B a run
    a direction plus at most 16 entries of padding, and a bucket table a
    direction of one 4 B entry for every 2^shift positions, 2^shift about
    n / r; every START equals the fused rows'."""
    g, ja, _, tb = textless
    n = len(g)
    assert tb.textless and tb.walk.numel() == 0
    assert tb.starts.numel() <= tb.r_fwd + tb.r_rev + 2 * 16
    for run_at in (tb.run_at, tb.run_at_rev):
        assert run_at.numel() == (n >> tb.run_shift) + 1
    assert n / tb.r_fwd < 1 << tb.run_shift <= 2 * n / tb.r_fwd
    starts = tb.starts.numpy().view(np.uint32)
    np.testing.assert_array_equal(starts[:tb.r_fwd + 1],
                                  ja.fused_fwd[:tb.r_fwd + 1, 0])
    np.testing.assert_array_equal(
        starts[tb.starts_rev:tb.starts_rev + tb.r_rev + 1],
        ja.fused_rev[:tb.r_rev + 1, 0])


@pytest.mark.parametrize("forward", [True, False])
def test_textless_run_tables_walk_to_the_same_runs(textless, forward):
    """On the textless index, the walks on the run tables
    (``bextend.walk_tables``) end at the run that ``ff_forward`` /
    ``ff_backward`` on the fused rows and the JAX package's
    ``_ff_forward`` / ``_ff_backward`` reach, in both directions: hints at
    the target, within and past ``FF_CAP`` runs of it, at run 0 and at the
    sentinel, positions 0 and n among them."""
    g, _, jb, tb = textless
    n = len(g)
    rng = np.random.default_rng(80)
    N = 2000
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
    want = (tbext.ff_forward if forward else tbext.ff_backward)(tb, *args)
    got, _ = tbext.walk_tables(tb, *args, forward)
    assert torch.equal(got, want)
    jwalk = jbext._ff_forward if forward else jbext._ff_backward
    jgot = np.asarray(jwalk(jb, *(jnp.asarray(a.numpy().astype(np.int32))
                                  for a in args)))
    np.testing.assert_array_equal(got.numpy(), jgot)
    behind = (truth - hint if forward else hint - truth) > tbext.FF_CAP
    assert behind.any() and (got.numpy()[behind] == truth[behind]).all()


def test_textless_extension_on_tables(textless):
    """Both packages extend 12-wide textless lanes in lockstep through
    random chars (N among them) with random direction flips from the full
    range; ``extend_all_plain`` and ``extend_char_plain`` on the run tables
    give every column of the JAX package's ``extend_all`` and
    ``extend_char`` at every step: intervals, run hints and the toehold,
    both where it survives and where it resets from a run's samples."""
    _, _, jb, tb = textless
    rng = np.random.default_rng(81)
    ext_all = jax.jit(jbext.extend_all)
    ext_char = jax.jit(jbext.extend_char)
    B = 96
    full = tb.full_range((B,)).numpy()
    assert full.shape == (B, 12)
    cur, stats = full, {}
    for step in range(20):
        dirs = rng.integers(0, 2, B).astype(np.int32)
        chars = rng.integers(0, 5, B).astype(np.int32)
        want = np.asarray(ext_all(jb, jnp.asarray(cur.astype(np.uint32)),
                                  jnp.asarray(dirs))).astype(np.int64)
        got = tbext.extend_all_plain(tb, torch.from_numpy(cur),
                                     torch.from_numpy(dirs), stats=stats,
                                     tables=True).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"step {step}")
        want_c = np.asarray(ext_char(
            jb, jnp.asarray(cur.astype(np.uint32)), jnp.asarray(chars),
            jnp.asarray(dirs))).astype(np.int64)
        got_c = tbext.extend_char_plain(tb, torch.from_numpy(cur),
                                        torch.from_numpy(chars),
                                        torch.from_numpy(dirs),
                                        tables=True).numpy()
        np.testing.assert_array_equal(got_c, want_c, err_msg=f"step {step}")
        live = want[..., 1] > want[..., 0]
        pick = rng.integers(0, 4, B)
        ok = live[np.arange(B), pick]
        cur = np.where(ok[:, None], want[np.arange(B), pick], full)
    assert ok.any()
    # the walks went past the window (bucket reads) and toeholds reset
    # from the previous c-run's samples
    assert stats["bucket"] > 0 and stats["toe_rows"] > 0
