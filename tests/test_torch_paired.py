"""The port's paired-end mapping against the JAX package's.

``pairing.*`` is pure numpy on both sides and is compared on random
occurrence arrays. ``map_pairs_all`` (at k = 0: both sides take the exact
pass), ``map_pairs_best_start/_finish`` in both result shapes (the
``PERowsBest`` arrays and the ``MappedPair`` list, with and without
discordant pairing), ``infer_parameters`` and ``map_pairs_best`` (the
stratum ladder of cutoffs above 6, called directly on the first 64 pairs)
run on the same pairs (numpy, seeded; m = 50 at 96 % identity, so the rungs
are (0,0) -> (2,2)). 512 pairs, so that the escalated rung, which pads to
512 rows, and the inference pass share one compiled JAX shape. Exact
equality throughout.
"""

import dataclasses

import numpy as np
import pytest
import torch

from columba_tpu.index import kmer as jkmer
from columba_tpu.index.build import build_index_from_codes
from columba_tpu.index.fmindex import FMIndex as JFMIndex
from columba_tpu.search import paired as jpaired
from columba_tpu.search import pairing as jpairing
from columba_tpu.search import pipeline as jpipe
from columba_tpu.search import strategy as jstrategy
from columba_tpu_torch.index import kmer as tkmer
from columba_tpu_torch.index.fmindex import FMIndex as TFMIndex
from columba_tpu_torch.search import paired as tpaired
from columba_tpu_torch.search import pairing as tpairing
from columba_tpu_torch.search import pipeline as tpipe
from columba_tpu_torch.search import strategy as tstrategy

torch.set_num_threads(1)

OCC = ("read_id", "strand", "begin", "end", "distance")
ROWS = ("pair_id", "up_is_1", "u_begin", "u_end", "u_dist", "u_strand",
        "d_begin", "d_end", "d_dist", "d_strand")
M, R = 50, 512
LADDER_PAIRS = 64


def _rows_equal(a, b):
    for f in ROWS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def _random_occs(rng, n_reads, n):
    """Occurrences sorted by (read, strand, end), as the pipeline gives
    them, clustered so that many fall into each other's insert window."""
    rid = rng.integers(0, n_reads, n)
    begin = (rid * 37) % 5000 + rng.integers(0, 700, n)
    strand = rng.integers(0, 2, n)
    o = np.lexsort((begin, strand, rid))
    f = (rid[o], strand[o], begin[o], begin[o] + 50 + rng.integers(-2, 3, n),
         rng.integers(0, 4, n))
    return jpipe.OccArray(*f), tpipe.OccArray(*f)


@pytest.mark.parametrize("orientation", ["fr", "rf", "ff"])
def test_pairing_on_random_occurrences(orientation):
    rng = np.random.default_rng(70)
    j1, t1 = _random_occs(rng, 200, 1500)
    j2, t2 = _random_occs(rng, 200, 1500)
    starts = np.array([0, 2500, 6000], np.int64)
    jc = jpairing.concordant_pairs(j1, j2, orientation, 100, 400, starts)
    tc = tpairing.concordant_pairs(t1, t2, orientation, 100, 400, starts)
    assert len(tc) > 200
    _rows_equal(jc, tc)
    _rows_equal(jpairing.sort_pairs(jc), tpairing.sort_pairs(tc))
    for x in (0, 1):
        jk, jb = jpairing.best_filter(jc, 200, 4, x)
        tk, tb = tpairing.best_filter(tc, 200, 4, x)
        _rows_equal(jk, tk)
        np.testing.assert_array_equal(jb, tb)
        assert 0 < len(tk) < len(tc)
    e = tpairing.PairRows.empty()
    assert len(tpairing.PairRows.concat([e, e])) == 0
    assert len(tpairing.concordant_pairs(tpipe.OccArray.empty(), t2,
                                         orientation, 0, 500, starts)) == 0


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(71)
    g = rng.integers(0, 4, 20000).astype(np.uint8)
    g[12000:12600] = g[3000:3600]          # a repeat: ambiguous pairs
    g[12030:12600:45] ^= 2
    arrays = build_index_from_codes(g)
    frag = rng.integers(150, 300, R)
    pos = rng.integers(0, len(g) - 300, R)
    pos[:40] = rng.integers(3000, 3300, 40)
    pos[40], frag[40] = 0, 200
    pos[41] = len(g) - frag[41]
    r1 = g[pos[:, None] + np.arange(M)].copy()
    r2 = (3 - g[(pos + frag - M)[:, None] + np.arange(M)])[:, ::-1].copy()
    for rr in (r1, r2):
        for r in rr:
            k = rng.integers(0, 4)          # up to 3 > cutoff 2
            r[rng.integers(0, M, k)] = rng.integers(0, 4, k)
    r1[7, 20] = 4                           # a read with N
    flip = rng.random(R) < 0.5
    r1[flip], r2[flip] = r2[flip].copy(), r1[flip].copy()
    r2[10] = rng.integers(0, 4, M)          # mate 2 unmappable
    r1[11] = g[5000:5050]                   # both exact, far apart, same
    r2[11] = g[9000:9050]                   # strand: discordant only
    r1[12] = rng.integers(0, 4, M)          # both unmappable
    r2[12] = rng.integers(0, 4, M)
    jfm = JFMIndex.from_arrays(arrays)
    tfm = TFMIndex.from_arrays(arrays, "cpu")
    jtab, ttab = jkmer.build_kmer_table(jfm, 6), tkmer.build_kmer_table(tfm, 6)
    kw = dict(scheme_name="kuch1", metric="edit", mode="best",
              min_identity=96, switchpoint=4)
    return dict(
        r1=r1, r2=r2, jfm=jfm, tfm=tfm, jtab=jtab, ttab=ttab,
        starts=np.asarray(arrays.seq_starts),
        jcfg=jstrategy.MappingConfig(kmer_table=jtab, **kw),
        tcfg=tstrategy.MappingConfig(kmer_table=ttab, **kw))


def _occ_key(o):
    return (o.read_id, o.strand, o.begin, o.end, o.distance)


def _pair_key(p):
    return (_occ_key(p.up), _occ_key(p.down), p.up_is_read1)


def _mapped_equal(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert [_pair_key(p) for p in a.pairs] == \
            [_pair_key(p) for p in b.pairs]
        assert [_pair_key(p) for p in a.discordant] == \
            [_pair_key(p) for p in b.discordant]
        assert [_occ_key(o) for o in a.unpaired1] == \
            [_occ_key(o) for o in b.unpaired1]
        assert [_occ_key(o) for o in a.unpaired2] == \
            [_occ_key(o) for o in b.unpaired2]


@pytest.mark.parametrize("discordant", [False, True])
def test_map_pairs_all_exact(world, discordant):
    """ALL mode at k = 0 passes no switchpoint, so both sides take the exact
    pass; pairless reads fall back to discordant pairing or unpaired."""
    w = world
    jp = jpaired.PairedConfig(max_insert=400, discordant=discordant)
    tp = tpaired.PairedConfig(max_insert=400, discordant=discordant)
    want = jpaired.map_pairs_all(w["jfm"], w["r1"], w["r2"], "kuch1", 0,
                                 "edit", jp, w["starts"], w["jtab"])
    got = tpaired.map_pairs_all(w["tfm"], w["r1"], w["r2"], "kuch1", 0,
                                "edit", tp, w["starts"], w["ttab"])
    _mapped_equal(want, got)
    assert sum(1 for mp in got if mp.pairs) > R // 16
    assert any(mp.unpaired1 or mp.unpaired2 for mp in got)
    assert any(mp.discordant for mp in got) == discordant


@pytest.mark.parametrize("x", [0, 1])
def test_map_pairs_best_rows(world, x):
    """The array-native result (PERowsBest) through the rungs (0,0) ->
    (2,2): concordant rows and the unpaired fallbacks."""
    w = world
    jcfg = dataclasses.replace(w["jcfg"], best_plus_x=x)
    tcfg = dataclasses.replace(w["tcfg"], best_plus_x=x)
    jp, tp = jpaired.PairedConfig(max_insert=400), \
        tpaired.PairedConfig(max_insert=400)
    jh = jpaired.map_pairs_best_start(w["jfm"], w["r1"], w["r2"], jcfg, jp,
                                      w["starts"], w["jtab"])
    th = tpaired.map_pairs_best_start(w["tfm"], w["r1"], w["r2"], tcfg, tp,
                                      w["starts"], w["ttab"])
    assert th["rungs"] == jh["rungs"] == [(0, 0), (2, 2)]
    want = jpaired.map_pairs_best_finish(jh, jcfg, jp, w["starts"],
                                         as_rows=True)
    got = tpaired.map_pairs_best_finish(th, tcfg, tp, w["starts"],
                                        as_rows=True)
    _rows_equal(want.rows, got.rows)
    for f in ("u_end1", "u_st1", "u_mq1", "u_end2", "u_st2", "u_mq2"):
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f),
                                      err_msg=f)
    assert got.n == R and len(got.rows) > R // 2
    assert (got.rows.total > 0).any()              # an escalated pair
    assert (got.u_end1 >= 0).any() or (got.u_end2 >= 0).any()
    if x == 1:
        best = np.full(R, 99)
        np.minimum.at(best, got.rows.pair_id, got.rows.total)
        assert (got.rows.total > best[got.rows.pair_id]).any()


@pytest.mark.parametrize("discordant", [False, True])
def test_map_pairs_best_mapped(world, discordant):
    """The MappedPair list form, with the discordant fallback on and off;
    rows mode refuses discordant pairing (None) in both packages."""
    w = world
    jp = jpaired.PairedConfig(max_insert=400, discordant=discordant)
    tp = tpaired.PairedConfig(max_insert=400, discordant=discordant)
    jh = jpaired.map_pairs_best_start(w["jfm"], w["r1"], w["r2"], w["jcfg"],
                                      jp, w["starts"], w["jtab"])
    th = tpaired.map_pairs_best_start(w["tfm"], w["r1"], w["r2"], w["tcfg"],
                                      tp, w["starts"], w["ttab"])
    if discordant:
        assert tpaired.map_pairs_best_finish(th, w["tcfg"], tp, w["starts"],
                                             as_rows=True) is None
    want = jpaired.map_pairs_best_finish(jh, w["jcfg"], jp, w["starts"])
    got = tpaired.map_pairs_best_finish(th, w["tcfg"], tp, w["starts"])
    _mapped_equal(want, got)
    assert any(mp.discordant for mp in got) == discordant
    assert any(mp.unpaired1 or mp.unpaired2 for mp in got)


def test_infer_parameters(world):
    w = world
    want = jpaired.infer_parameters(w["jfm"], w["r1"], w["r2"], w["jcfg"],
                                    w["starts"], w["jtab"])
    got = tpaired.infer_parameters(w["tfm"], w["r1"], w["r2"], w["tcfg"],
                                   w["starts"], w["ttab"])
    assert dataclasses.asdict(want) == dataclasses.asdict(got)
    assert got.orientation == "fr" and not got.infer
    assert 0 <= got.min_insert < 150 and 300 < got.max_insert < 600
    # too few unambiguous pairs: the given settings stay, inference is off
    few = tpaired.infer_parameters(
        w["tfm"], w["r1"][:8], w["r2"][:8], w["tcfg"], w["starts"],
        w["ttab"], pcfg_in=tpaired.PairedConfig(max_insert=321))
    assert few.max_insert == 321 and not few.infer


def test_mapq_vec_matches_mapq():
    from columba_tpu_torch.io import sam

    nb = np.arange(1, 300)
    np.testing.assert_array_equal(jpaired._mapq_vec(nb),
                                  tpaired._mapq_vec(nb))
    assert tpaired._mapq_vec(nb).tolist() == [sam.mapq(int(n)) for n in nb]


def test_map_pairs_best_ladder(world, monkeypatch):
    """The total-distance stratum ladder, which ``map_pairs_best_start``
    takes at cutoffs above 6, called directly at cutoff 2 in both packages:
    strata, budget split, early exit and the discordant and unpaired
    fallbacks give the same MappedPair lists, at +x = 1. The ladder maps a
    different subset of reads in every stratum; the JAX package's
    ``match_all`` is given each subset padded to R rows (pad lanes dropped
    from its result), so that every stratum runs a shape the other tests
    have compiled."""
    w = world
    n = LADDER_PAIRS
    jax_match_all = jpipe.match_all

    def padded(index, reads, *a, **kw):
        occs, stats = jax_match_all(index, jstrategy._pad_pow2(reads, R),
                                    *a, **kw)
        return occs.take(occs.read_id < len(reads)), stats

    monkeypatch.setattr(jpipe, "match_all", padded)
    jcfg = dataclasses.replace(w["jcfg"], best_plus_x=1)
    tcfg = dataclasses.replace(w["tcfg"], best_plus_x=1)
    jp = jpaired.PairedConfig(max_insert=400, discordant=True)
    tp = tpaired.PairedConfig(max_insert=400, discordant=True)
    want = jpaired.map_pairs_best(w["jfm"], w["r1"][:n], w["r2"][:n], jcfg,
                                  jp, w["starts"], w["jtab"])
    got = tpaired.map_pairs_best(w["tfm"], w["r1"][:n], w["r2"][:n], tcfg,
                                 tp, w["starts"], w["ttab"])
    _mapped_equal(want, got)
    assert sum(1 for mp in got if mp.pairs) > n // 2
    assert any(p.total_distance > 0 for mp in got for p in mp.pairs)
    assert any(mp.discordant for mp in got)
    assert any(mp.unpaired1 or mp.unpaired2 for mp in got)
