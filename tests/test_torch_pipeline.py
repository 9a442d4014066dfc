"""The port's ALL-mode pipeline against the JAX package's.

``match_all_start`` / ``match_all_finish`` of both packages run on the same
reads; the occurrence arrays and the run statistics must be identical,
including the lossless retries. The batch is built so that its first
attempt overflows both capacities at once: reads from a repeated region
overflow the two-stage exact loop's ``ex_cap`` (4x capacity retry) and
reads from a long homopolymer run spill the locate capacity (4x
max_locate retry). One batch covers both so that the JAX side compiles
two shapes instead of four. The k = 0 test takes the exact pass (no seed
table): reads of a homopolymer run spill its locate capacity too. The
partitioning test runs ``match_all`` with given boundaries, with dynamic
partitioning (seeded from the k-mer table and without it) and with the
scheme's static fractions.
"""

import numpy as np
import pytest
import torch

from columba_tpu.index import kmer as jkmer
from columba_tpu.index.build import build_index_from_codes
from columba_tpu.index.fmindex import FMIndex as JFMIndex
from columba_tpu.search import pipeline as jpipe
from columba_tpu.search.scheme import get_scheme as jscheme
from columba_tpu_torch.index import kmer as tkmer
from columba_tpu_torch.index.fmindex import FMIndex as TFMIndex
from columba_tpu_torch.search import pipeline as tpipe
from columba_tpu_torch.search.scheme import get_scheme as tscheme

from tests.test_torch_executor import repeat_genome, sample_batch

torch.set_num_threads(1)


def test_match_all_lossless_retries():
    rng = np.random.default_rng(41)
    rep = repeat_genome(rng)
    g = np.concatenate([rep, np.zeros(12000, np.uint8),
                        rng.integers(0, 4, 4000).astype(np.uint8)])
    # homopolymer reads first: lanes past ex_cap are the ones dropped
    reads = np.concatenate([np.zeros((2, 100), np.uint8),
                            sample_batch(rng, rep, 64)[:64]])
    kw = dict(metric="edit", switchpoint=4, ex_split=6, ex_cap=128)
    arrays = build_index_from_codes(g)
    jfm = JFMIndex.from_arrays(arrays)
    tfm = TFMIndex.from_arrays(arrays, "cpu")
    j_ctx = jpipe.match_all_start(jfm, reads, jscheme("kuch1", 2),
                                  kmer_table=jkmer.build_kmer_table(jfm, 6),
                                  **kw)
    first = j_ctx["out"]
    assert int(first["overflow"]) > 0
    assert int(first["total"]) > j_ctx["max_locate"]
    j_occ, j_stats = jpipe.match_all_finish(j_ctx)
    t_occ, t_stats = tpipe.match_all_finish(tpipe.match_all_start(
        tfm, reads, tscheme("kuch1", 2),
        kmer_table=tkmer.build_kmer_table(tfm, 6), **kw))
    assert t_stats == j_stats
    assert j_stats["retries"] == 1 and j_stats["overflow"] == 0
    assert not j_stats["locate_truncated"]
    for f in ("read_id", "strand", "begin", "end", "distance"):
        np.testing.assert_array_equal(getattr(j_occ, f), getattr(t_occ, f),
                                      err_msg=f)
    assert len(t_occ) > 0


def test_match_all_retries_until_lossless():
    """The 4x retries go on until nothing spills. The JAX package stops
    after three and then drops occurrences (on a pan-genome batch of the
    RLC smoke 18 % of the reads lost their locus); here a first attempt
    with a frontier of 16 lanes and a first exact stage of 1 needs four,
    and the result equals a run whose capacities are large enough from the
    start."""
    rng = np.random.default_rng(41)
    rep = repeat_genome(rng)
    g = np.concatenate([rep, np.zeros(12000, np.uint8),
                        rng.integers(0, 4, 4000).astype(np.uint8)])
    reads = sample_batch(rng, rep, 64)[:64]
    tfm = TFMIndex.from_arrays(build_index_from_codes(g), "cpu")
    table = tkmer.build_kmer_table(tfm, 6)
    kw = dict(metric="edit", switchpoint=4, kmer_table=table, ex_split=6)
    ctx = tpipe.match_all_start(tfm, reads, tscheme("kuch1", 2), ex_cap=1,
                                **kw)
    ctx["capacity"], ctx["ex_cap"] = 16, 1
    ctx["out"], ctx["event"] = ctx["run"](16, 1, ctx["max_locate"])
    occ, stats = tpipe.match_all_finish(ctx)
    assert stats["retries"] >= 4 and stats["overflow"] == 0
    assert not stats["locate_truncated"]
    want, wstats = tpipe.match_all(tfm, reads, tscheme("kuch1", 2),
                                   capacity=4096, max_locate=1 << 16,
                                   ex_cap=4096, **kw)
    assert wstats["retries"] == 0 and wstats["overflow"] == 0
    for f in ("read_id", "strand", "begin", "end", "distance"):
        np.testing.assert_array_equal(getattr(occ, f), getattr(want, f),
                                      err_msg=f)



def test_batch_sizing_and_growth():
    """The sizing that match_all_start, the dryrun and the smoke share, at
    the headline batch (32,768 rows, kuch1 at k = 2: 3 searches), and the
    capacities of a lossless re-run."""
    assert tpipe.batch_capacity(32768, 3, 4) == 12288
    assert tpipe.batch_capacity(32768, 3, 0) == 49152
    assert tpipe.batch_capacity(100, 3, 4) == 1024
    assert tpipe.batch_max_locate(32768) == 131072
    assert tpipe.batch_max_locate(10) == 1 << 16
    g = np.random.default_rng(5).integers(0, 4, 2000).astype(np.uint8)
    tfm = TFMIndex.from_arrays(build_index_from_codes(g), "cpu")
    assert tpipe.batch_max_locate(32768, tfm) == 131072
    tpipe._ml_hint_bump(tfm, 1 << 20)
    assert tpipe.batch_max_locate(32768, tfm) == 1 << 20
    ok = dict(overflow=0, total=16, n_unique=16)
    assert tpipe.grown_caps(ok, 8, 4, 16) is None
    assert tpipe.grown_caps(dict(ok, overflow=1), 8, 4, 16) == (32, 16, 16)
    assert tpipe.grown_caps(dict(ok, total=17), 8, 4, 16) == (8, 4, 64)
    assert tpipe.grown_caps(dict(ok, n_unique=17, overflow=2),
                            8, 4, 16) == (32, 16, 64)
    assert tpipe.grown_caps(dict(ok, overflow=1, total=17), 8, 4, 16,
                            grow_capacity=False) == (8, 4, 64)
    assert tpipe.grown_caps(dict(ok, overflow=1, total=17), 8, 4, 16,
                            grow_locate=False) == (32, 16, 16)
    assert tpipe.grown_caps(dict(ok, total=17), 8, 4, 16,
                            grow_locate=False) is None

def test_match_all_dynamic_partitions_once_a_dispatch(monkeypatch):
    """Under dynamic partitioning the boundaries are made once a dispatch:
    a lossless re-run makes only the per-read tables again, from the same
    boundaries. A first attempt with a frontier of 16 lanes needs at least
    two re-runs; the result equals a run whose capacities are large
    enough from the start."""
    from columba_tpu_torch.search import dynschedule

    rng = np.random.default_rng(41)
    rep = repeat_genome(rng)
    g = np.concatenate([rep, rng.integers(0, 4, 4000).astype(np.uint8)])
    reads = sample_batch(rng, rep, 64)[:64]
    tfm = TFMIndex.from_arrays(build_index_from_codes(g), "cpu")
    kw = dict(metric="edit", switchpoint=4,
              kmer_table=tkmer.build_kmer_table(tfm, 6),
              partitioning="dynamic")
    calls = dict(dynamic_partition=0, build_tables=0)
    for name in calls:
        def counted(*a, _fn=getattr(dynschedule, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(dynschedule, name, counted)
    ctx = tpipe.match_all_start(tfm, reads, tscheme("kuch1", 2), **kw)
    assert calls == dict(dynamic_partition=1, build_tables=1)
    ctx["capacity"] = 16
    ctx["out"], ctx["event"] = ctx["run"](16, ctx["ex_cap"],
                                          ctx["max_locate"])
    occ, stats = tpipe.match_all_finish(ctx)
    assert stats["retries"] >= 2 and stats["overflow"] == 0
    assert calls == dict(dynamic_partition=1,
                         build_tables=2 + stats["retries"])
    want, wstats = tpipe.match_all(tfm, reads, tscheme("kuch1", 2),
                                   capacity=4096, max_locate=1 << 16, **kw)
    assert wstats["retries"] == 0 and wstats["overflow"] == 0
    assert calls["dynamic_partition"] == 2
    for f in ("read_id", "strand", "begin", "end", "distance"):
        np.testing.assert_array_equal(getattr(occ, f), getattr(want, f),
                                      err_msg=f)
    assert len(occ) >= 64


def test_match_all_exact_pass():
    """k = 0 without a seed table: the exact branch of match_all, with its
    4x locate-spill retries, gives the JAX package's OccArray and stats."""
    rng = np.random.default_rng(43)
    g = np.concatenate([rng.integers(0, 4, 6000).astype(np.uint8),
                        np.zeros(1500, np.uint8),
                        rng.integers(0, 4, 2500).astype(np.uint8)])
    g[8500:8800] = g[1000:1300]                       # a repeat: 2 loci
    m, R = 40, 64
    starts = rng.integers(0, len(g) - m, R)
    starts[:4] = [0, len(g) - m, 1000, 1100]
    reads = g[starts[:, None] + np.arange(m)].copy()
    reads[8:24, rng.integers(0, m, 16)] ^= 1          # no exact match
    reads[5, 11] = 4                                  # a read with N
    flip = rng.random(R) < 0.5
    reads[flip] = np.where(reads[flip] > 3, 4, 3 - reads[flip])[:, ::-1]
    reads[30:33] = 0                                  # homopolymer: spill
    arrays = build_index_from_codes(g)
    jfm = JFMIndex.from_arrays(arrays)
    tfm = TFMIndex.from_arrays(arrays, "cpu")
    kw = dict(metric="edit", max_locate=None)
    j_ctx = jpipe.match_all_start(jfm, reads, jscheme("kuch1", 0), **kw)
    t_ctx = tpipe.match_all_start(tfm, reads, tscheme("kuch1", 0), **kw)
    assert "exact" in j_ctx and "exact" in t_ctx
    # shrink the first attempt's capacity on both sides: the reads inside
    # the homopolymer run spill it, and the 4x retries make up for it
    for ctx in (j_ctx, t_ctx):
        ctx["exact"]["max_locate"] = 2048
    j_ctx["exact"]["out"] = jpipe._exact_device(jfm, j_ctx["exact"]["batch"],
                                                2048)
    t_ctx["exact"]["out"], t_ctx["exact"]["event"] = tpipe._exact_device(
        tfm, t_ctx["exact"]["batch"], 2048)
    j_occ, j_stats = jpipe.match_all_finish(j_ctx)
    t_occ, t_stats = tpipe.match_all_finish(t_ctx)
    assert t_stats == j_stats
    assert j_stats["retries"] >= 1 and not j_stats["locate_truncated"]
    for f in ("read_id", "strand", "begin", "end", "distance"):
        np.testing.assert_array_equal(getattr(j_occ, f), getattr(t_occ, f),
                                      err_msg=f)
    assert len(t_occ) > 3 * 1400                      # the homopolymer rows
    assert set(np.unique(t_occ.strand)) == {0, 1}


@pytest.fixture(scope="module")
def part_world():
    rng = np.random.default_rng(44)
    g = repeat_genome(rng)
    arrays = build_index_from_codes(g)
    jfm = JFMIndex.from_arrays(arrays)
    tfm = TFMIndex.from_arrays(arrays, "cpu")
    return dict(jfm=jfm, tfm=tfm, jtab=jkmer.build_kmer_table(jfm, 6),
                ttab=tkmer.build_kmer_table(tfm, 6),
                reads=sample_batch(rng, g, 64)[:64], rng=rng)


@pytest.mark.parametrize("mode", ["partition_pts", "dynamic",
                                  "dynamic_no_table", "dynamic_short",
                                  "static"])
def test_match_all_partitioning(part_world, mode):
    """match_all with per-read boundaries, dynamic and static partitioning:
    OccArray and stats of the JAX package, and the occurrence set of the
    uniform run (every partition is lossless at k)."""
    from tests.test_torch_dynschedule import random_pts

    w = part_world
    reads = w["reads"]
    kw = dict(metric="edit", switchpoint=4)
    jkw, tkw = dict(kw), dict(kw)
    if mode == "partition_pts":
        pts = random_pts(np.random.default_rng(45), 2 * len(reads), 3, 100, 2)
        jkw.update(partition_pts=pts)
        tkw.update(partition_pts=pts)
    elif mode == "static":
        jkw.update(partitioning="static", kmer_table=w["jtab"])
        tkw.update(partitioning="static", kmer_table=w["ttab"])
    else:
        jkw.update(partitioning="dynamic")
        tkw.update(partitioning="dynamic")
        if mode != "dynamic_no_table":
            jkw.update(kmer_table=w["jtab"])
            tkw.update(kmer_table=w["ttab"])
    if mode == "dynamic_short":
        # m < p * (2kb + 1): falls back to the uniform static schedule
        reads = reads[:, :14]
    j_occ, j_stats = jpipe.match_all(w["jfm"], reads, jscheme("kuch1", 2),
                                     **jkw)
    t_occ, t_stats = tpipe.match_all(w["tfm"], reads, tscheme("kuch1", 2),
                                     **tkw)
    assert t_stats == j_stats
    for f in ("read_id", "strand", "begin", "end", "distance"):
        np.testing.assert_array_equal(getattr(j_occ, f), getattr(t_occ, f),
                                      err_msg=f)
    u_occ, _ = tpipe.match_all(w["tfm"], reads, tscheme("kuch1", 2),
                               kmer_table=w["ttab"], **kw)
    key = lambda o: set(zip(o.read_id.tolist(), o.strand.tolist(),
                            o.end.tolist(), o.distance.tolist()))
    assert key(t_occ) == key(u_occ) and len(t_occ) >= 64
