"""The port's BEST(+x) strategy against the JAX package's.

``map_batch_best_arr`` of both packages runs on the same reads (numpy,
seeded; m = 50 at 96 % identity, so the cutoff is 2 and one schedule
serves every case): identical OccArrays, for +x = 0 and +x = 1. The stratum
ladder, which both packages take only above cutoff 6, is held against the
JAX ladder at cutoff 7 (pigeon, Hamming, m = 40 at 82 % identity, 64 reads:
strata 0, 1, 3, 5, 7 at one batch shape), and against the port's own single
pass at cutoff 2 (the two are the same output set: the union of the
explored strata is the <= cutoff set).
All arithmetic is integer: exact equality, tolerance 0.
"""

import numpy as np
import pytest
import torch

from columba_tpu.index import kmer as jkmer
from columba_tpu.index.build import build_index_from_codes
from columba_tpu.index.fmindex import FMIndex as JFMIndex
from columba_tpu.search import strategy as jstrategy
from columba_tpu_torch.index import kmer as tkmer
from columba_tpu_torch.index.fmindex import FMIndex as TFMIndex
from columba_tpu_torch.search import strategy as tstrategy

torch.set_num_threads(1)

FIELDS = ("read_id", "strand", "begin", "end", "distance")
M, R = 50, 256


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(61)
    g = rng.integers(0, 4, 16000).astype(np.uint8)
    # a second copy of one region with a substitution every 40 bases:
    # reads from either copy also hit the other, one stratum up
    g[9000:9800] = g[2000:2800]
    g[9020:9800:40] ^= 1
    arrays = build_index_from_codes(g)
    starts = rng.integers(0, len(g) - M, R)
    starts[:3] = [0, len(g) - M, 1]
    starts[3:60] = rng.integers(2000, 2750, 57)
    reads = g[starts[:, None] + np.arange(M)].copy()
    for r in reads:
        k = rng.integers(0, 4)                 # up to 3 > cutoff: unmapped
        r[rng.integers(0, M, k)] = rng.integers(0, 4, k)
    reads[9, 17] = 4
    flip = rng.random(R) < 0.5
    reads[flip] = (3 - reads[flip])[:, ::-1]
    reads = np.where(reads > 4, 4, reads).astype(np.uint8)  # N stays N
    jfm = JFMIndex.from_arrays(arrays)
    tfm = TFMIndex.from_arrays(arrays, "cpu")
    return dict(reads=reads, jfm=jfm, tfm=tfm,
                jtab=jkmer.build_kmer_table(jfm, 6),
                ttab=tkmer.build_kmer_table(tfm, 6))


def _cfgs(world, x):
    kw = dict(scheme_name="kuch1", metric="edit", mode="best",
              best_plus_x=x, min_identity=96, switchpoint=4)
    return (jstrategy.MappingConfig(kmer_table=world["jtab"], **kw),
            tstrategy.MappingConfig(kmer_table=world["ttab"], **kw))


def test_cutoffs_match():
    for scheme in ("kuch1", "columba", "pigeon", "minU", "naive"):
        for m in (20, 50, 100, 150, 250):
            for metric in ("edit", "hamming"):
                assert (tstrategy.max_supported_k(scheme, m, metric)
                        == jstrategy.max_supported_k(scheme, m, metric))
                for ident in (80, 90, 95, 96, 99):
                    j = jstrategy.MappingConfig(scheme_name=scheme,
                                                metric=metric,
                                                min_identity=ident)
                    t = tstrategy.MappingConfig(scheme_name=scheme,
                                                metric=metric,
                                                min_identity=ident)
                    assert (tstrategy.best_cutoff_for(t, m)
                            == jstrategy.best_cutoff_for(j, m))


@pytest.mark.parametrize("x", [0, 1])
def test_map_batch_best_arr(world, x):
    jcfg, tcfg = _cfgs(world, x)
    assert tstrategy.best_cutoff_for(tcfg, M) == 2
    want = jstrategy.map_batch_best_arr(world["jfm"], world["reads"], jcfg)
    got = tstrategy.map_batch_best_arr(world["tfm"], world["reads"], tcfg)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f),
                                      err_msg=f)
    assert len(got) > R // 2
    if x == 1:
        best = np.full(R, 9)
        np.minimum.at(best, got.read_id, got.distance)
        assert (got.distance > best[got.read_id]).any()   # a +1 stratum hit
    # the grouped form agrees with the JAX package's
    jm = jstrategy._group_mapped(want, R)
    tm = tstrategy._group_mapped(got, R)
    assert [(a.best, a.n_best, len(a.occs)) for a in jm] == \
        [(b.best, b.n_best, len(b.occs)) for b in tm]


@pytest.mark.parametrize("x,seeded", [(0, True), (1, True), (0, False)])
def test_ladder_equals_rung_path(world, x, seeded):
    """The stratum ladder, called directly at cutoff 2, reports what the
    single pass at the cutoff reports. Without a seed table its k = 0 stratum is the exact
    pass."""
    _, tcfg = _cfgs(world, x)
    if not seeded:
        tcfg.kmer_table = None
    rung = tstrategy.map_batch_best_arr(world["tfm"], world["reads"], tcfg)
    ladder = tstrategy._ladder_best_arr(world["tfm"], world["reads"], tcfg,
                                        cutoff=2)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(rung, f), getattr(ladder, f),
                                      err_msg=f)
    assert len(ladder) > R // 2


def test_ladder_equals_jax_ladder():
    """Cutoff 7 takes the stratum ladder in both packages. Read i carries
    i mod 10 substitutions, so every stratum resolves some reads and the
    reads above the cutoff stay unmapped."""
    m, n = 40, 64
    rng = np.random.default_rng(62)
    g = rng.integers(0, 4, 16000).astype(np.uint8)
    g[9000:9800] = g[2000:2800]
    g[9020:9800:40] ^= 1
    arrays = build_index_from_codes(g)
    starts = rng.integers(0, len(g) - m, n)
    starts[:20] = rng.integers(2000, 2750, 20)
    reads = g[starts[:, None] + np.arange(m)].copy()
    for i, r in enumerate(reads):
        r[rng.choice(m, i % 10, replace=False)] ^= 1
    flip = rng.random(n) < 0.5
    reads[flip] = (3 - reads[flip])[:, ::-1]
    kw = dict(scheme_name="pigeon", metric="hamming", mode="best",
              min_identity=82, switchpoint=4)
    jcfg, tcfg = jstrategy.MappingConfig(**kw), tstrategy.MappingConfig(**kw)
    assert tstrategy.best_cutoff_for(tcfg, m) == 7
    tfm = TFMIndex.from_arrays(arrays, "cpu")
    handle = tstrategy.map_batch_best_start(tfm, reads, tcfg)
    assert handle["mode"] == "ladder"
    got = tstrategy.map_batch_best_finish(handle, tfm, reads, tcfg)
    want = jstrategy.map_batch_best_arr(JFMIndex.from_arrays(arrays), reads,
                                        jcfg)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f),
                                      err_msg=f)
    assert (np.bincount(got.distance, minlength=8) > 0).all()
    assert len(np.unique(got.read_id)) < n


def test_pad_pow2_and_mapq():
    from columba_tpu.io import sam as jsam
    from columba_tpu_torch.io import sam as tsam

    reads = np.arange(30, dtype=np.uint8).reshape(10, 3)
    np.testing.assert_array_equal(jstrategy._pad_pow2(reads, 4),
                                  tstrategy._pad_pow2(reads, 4))
    assert tstrategy._pad_pow2(reads).shape == (512, 3)
    assert [tsam.mapq(n) for n in range(0, 40)] == \
        [jsam.mapq(n) for n in range(0, 40)]
