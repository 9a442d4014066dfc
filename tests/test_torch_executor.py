"""The port's frontier executor against the JAX package's, field by field.

``run_scheme`` of both packages runs on the same reads (numpy, seeded) over
a genome with repeats, so that ranges stay wider than the in-text
switchpoint long enough for the band steps and the crossover to work
together. Exact equality on every FrontierResult field: both compact lanes
in order, so even the intermediate frontier layout agrees. The JAX side runs
under ``jax.jit`` with the schedule tables as arguments, as its pipeline
runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columba_tpu.core import alphabet
from columba_tpu.index import kmer as jkmer
from columba_tpu.index.build import build_index_from_codes
from columba_tpu.index.fmindex import FMIndex as JFMIndex
from columba_tpu.search import executor as jexec
from columba_tpu.search import pipeline as jpipe
from columba_tpu.search.scheme import get_scheme as jscheme
from columba_tpu_torch.index import kmer as tkmer
from columba_tpu_torch.index.fmindex import FMIndex as TFMIndex
from columba_tpu_torch.search import executor as texec
from columba_tpu_torch.search import pipeline as tpipe
from columba_tpu_torch.search.scheme import get_scheme as tscheme

torch.set_num_threads(1)


def repeat_genome(rng, n=24000, unit=2000, copies=6):
    """Random genome with ``copies`` lightly mutated copies of one unit."""
    g = rng.integers(0, 4, n).astype(np.uint8)
    src = g[:unit].copy()
    for c in range(1, copies + 1):
        cp = src.copy()
        idx = rng.integers(0, unit, 6)
        cp[idx] = rng.integers(0, 4, 6)
        g[c * (unit + 1500):c * (unit + 1500) + unit] = cp
    return g


def sample_batch(rng, g, num, m=100, max_err=2):
    """Reads (both strands stacked) with up to max_err substitutions, some
    at the text ends; returns uint8 (2*num, m)."""
    starts = rng.integers(0, len(g) - m, num)
    starts[:4] = [0, 1, len(g) - m, len(g) - m - 1]
    reads = g[starts[:, None] + np.arange(m)].copy()
    for r in reads:
        k = rng.integers(0, max_err + 1)
        r[rng.integers(0, m, k)] = rng.integers(0, 4, k)
    reads[5, 40] = 4                                    # a read with N
    return np.concatenate([reads, alphabet.revcomp(reads, axis=-1)])


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(31)
    g = repeat_genome(rng)
    arrays = build_index_from_codes(g)
    jfm = JFMIndex.from_arrays(arrays)
    tfm = TFMIndex.from_arrays(arrays, "cpu")
    return dict(g=g, jfm=jfm, tfm=tfm,
                jtab=jkmer.build_kmer_table(jfm, 6),
                ttab=tkmer.build_kmer_table(tfm, 6),
                batch=sample_batch(rng, g, 64))


def test_band_row_update():
    rng = np.random.default_rng(32)
    for bw in (1, 3, 5, 7):
        prev = rng.integers(0, 64, (500, bw)).astype(np.int8)
        pch = rng.integers(-2, 5, (500, bw)).astype(np.int8)
        want = jax.jit(jexec._band_row_update, static_argnums=2)(
            jnp.asarray(prev), jnp.asarray(pch), bw)
        got = texec._band_row_update(torch.from_numpy(prev),
                                     torch.from_numpy(pch), bw)
        np.testing.assert_array_equal(np.asarray(want), got.numpy())


FIELDS = ("ranges", "rid", "sid", "ed_lb", "done", "overflow",
          "nodes_visited", "itv_count", "searches_started")


@pytest.mark.parametrize("kmer_k,switchpoint,capacity,ex_split,ex_cap", [
    (6, 4, 2048, 0, 0),      # the CLI shape: seeds + crossover, and the
                             # two-stage band loop (shrink to 1024)
    (0, 0, 384, 0, 0),       # band path only, frontier overflow
    (0, 4, 1024, 12, 64),    # two-stage exact loop, ex_cap overflow
])
def test_run_scheme(world, kmer_k, switchpoint, capacity, ex_split, ex_cap):
    batch = world["batch"]
    jsched = jpipe.compile_cached(jscheme("kuch1", 2), 100, "edit",
                                  kmer_k=kmer_k)
    tsched = tpipe.compile_cached(tscheme("kuch1", 2), 100, "edit",
                                  kmer_k=kmer_k)
    itv_cap, split, cap2 = jpipe.crossover_caps(capacity, 4096, switchpoint)
    kw = dict(switchpoint=switchpoint, itv_cap=itv_cap, split_step=split,
              capacity2=cap2, itv_min_depth=16, ex_split=ex_split,
              ex_cap=ex_cap)
    want = jax.jit(lambda b, tab, tables: jexec.run_scheme(
        world["jfm"], b, jsched, capacity, tab, tables=tables, **kw))(
            jnp.asarray(batch.astype(np.int32)),
            world["jtab"] if kmer_k else None, jpipe.device_tables(jsched))
    got = texec.run_scheme(world["tfm"], torch.from_numpy(batch), tsched,
                           capacity, world["ttab"] if kmer_k else None, **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(want, f)).astype(np.int64),
            getattr(got, f).numpy().astype(np.int64), err_msg=f)
    n = int(want.itv_count)
    np.testing.assert_array_equal(np.asarray(want.itv)[:n].astype(np.int64),
                                  got.itv[:n].numpy())
    if (kmer_k, switchpoint, capacity) == (6, 4, 2048):
        # the repeats must drive both the band steps and the crossover
        assert int(want.nodes_visited) > 0 and n > 0


@pytest.mark.parametrize("metric,k,m", [
    ("hamming", 2, 48),      # kb = 0: a band of one cell, no deletion scan
    ("edit", 1, 48),         # kb = 1
    ("edit", 3, 60),         # kb = 3
])
def test_run_scheme_band_radii(world, metric, k, m):
    """The band step (band_step_plain against the JAX step) at the other
    band radii the port reaches, on short reads: every FrontierResult field
    of a whole run_scheme, band path only and with the crossover."""
    rng = np.random.default_rng(33 + k)
    batch = sample_batch(rng, world["g"], 24, m=m, max_err=k)
    jsched = jpipe.compile_cached(jscheme("kuch1", k), m, metric, kmer_k=6)
    tsched = tpipe.compile_cached(tscheme("kuch1", k), m, metric, kmer_k=6)
    assert tsched.bw == (2 * k + 1 if metric == "edit" else 1)
    capacity = 1024
    itv_cap, split, cap2 = jpipe.crossover_caps(capacity, 4096, 4)
    kw = dict(switchpoint=4, itv_cap=itv_cap, split_step=split,
              capacity2=cap2, itv_min_depth=16)
    want = jax.jit(lambda b, tab, tables: jexec.run_scheme(
        world["jfm"], b, jsched, capacity, tab, tables=tables, **kw))(
            jnp.asarray(batch.astype(np.int32)), world["jtab"],
            jpipe.device_tables(jsched))
    got = texec.run_scheme(world["tfm"], torch.from_numpy(batch), tsched,
                           capacity, world["ttab"], **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(want, f)).astype(np.int64),
            getattr(got, f).numpy().astype(np.int64), err_msg=f)
    n = int(want.itv_count)
    np.testing.assert_array_equal(np.asarray(want.itv)[:n].astype(np.int64),
                                  got.itv[:n].numpy())
    assert int(want.nodes_visited) > 0 and int(want.overflow) == 0


@pytest.mark.parametrize("masked", [False, True])
def test_run_scheme_dyn(world, masked):
    """run_scheme under per-read schedules (dynamic partitioning): full-range
    start without k-mer seeding, the per-lane exact loop, kernel B's per-lane
    scalars in band_step_plain, one register, the per-lane tail. With a
    search mask (dynamic scheme selection) the masked searches start empty.
    Every FrontierResult field and the in-text rows equal the JAX run."""
    from columba_tpu.search import dynschedule as jdyn
    from columba_tpu_torch.search import dynschedule as tdyn

    from tests.test_torch_dynschedule import random_pts

    rng = np.random.default_rng(34)
    batch = world["batch"]
    m, k = 100, 2
    jsc, tsc = jscheme("kuch1", k), tscheme("kuch1", k)
    pts = random_pts(rng, len(batch), jsc.num_parts, m, k)
    mask = (rng.random((len(batch), len(jsc.searches))) < 0.6
            if masked else None)
    jsched = jpipe.compile_cached(jsc, m, "edit", kmer_k=0)
    tsched = tpipe.compile_cached(tsc, m, "edit", kmer_k=0)
    jst = jdyn.scheme_static(jsc, m, "edit")
    tst = tdyn.scheme_static(tsc, m, "edit")
    capacity = 2048
    itv_cap, split, cap2 = jpipe.crossover_caps(capacity, 4096, 4)
    kw = dict(switchpoint=4, itv_cap=itv_cap, split_step=split,
              capacity2=cap2, itv_min_depth=16)

    def jrun(b, p_, mk):
        dyn = jdyn.build_tables(jst, p_, b)
        return jexec.run_scheme(world["jfm"], b, jsched, capacity, None,
                                search_mask=mk, dyn=dyn, **kw)

    want = jax.jit(jrun)(jnp.asarray(batch.astype(np.int32)),
                         jnp.asarray(pts),
                         None if mask is None else jnp.asarray(mask))
    tb = torch.from_numpy(batch)
    dyn = tdyn.build_tables(tst, torch.from_numpy(pts), tb)
    got = texec.run_scheme(
        world["tfm"], tb, tsched, capacity, None, dyn=dyn,
        search_mask=None if mask is None else torch.from_numpy(mask), **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(want, f)).astype(np.int64),
            getattr(got, f).numpy().astype(np.int64), err_msg=f)
    n = int(want.itv_count)
    np.testing.assert_array_equal(np.asarray(want.itv)[:n].astype(np.int64),
                                  got.itv[:n].numpy())
    # bands and registers of the final frontier: the packed JAX state is
    # not returned, so the band path shows in visits, ed_lb and done
    assert int(want.nodes_visited) > 0 and n > 0
    assert bool(np.asarray(want.done).any())
