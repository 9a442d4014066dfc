"""Dynamic partitioning and per-read scheme selection on the with-text RLC
(b-move) index: the port against the JAX package.

The world is repeat-rich (five near-identical haplotypes of a 3 kbp base and
a random tail, so the BWT has long runs). Every comparison is exact:
``dynamic_partition`` (the boundaries and, through a hook on the JAX scan's
final carry, every column of the final 8-wide part ranges, run hints
included), ``exact_match`` with per-row lengths, ``part_exact_ranges`` and
``select_schemes`` (its ``choice`` and ``mask`` arrays, not only the SAM,
which is the same whichever lossless scheme runs), ``run_scheme`` under
per-read tables (frontier and in-text rows), ``match_all`` with
``partitioning="dynamic"`` and with a scheme list, and byte-identical SAM
records from both packages' ``cli align --rlc`` in the four modes that reach
these functions. The port runs its plain versions here (CPU tensors); the
card tests of the kernels' RLC entries are in ``test_torch_kernels.py``,
which imports no JAX (the card's machine has none).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columba_tpu import cli as jcli
from columba_tpu.index import bmove as jbm
from columba_tpu.ops import extend as jext
from columba_tpu.search import dynschedule as jdyn
from columba_tpu.search import executor as jexe, pipeline as jpipe
from columba_tpu.search.scheme import get_multi_scheme as jmulti
from columba_tpu.search.scheme import get_scheme as jscheme
from columba_tpu_torch import cli as tcli
from columba_tpu_torch.index import bmove as tbm
from columba_tpu_torch.ops import extend as text
from columba_tpu_torch.search import dynschedule as tdyn
from columba_tpu_torch.search import executor as texe, pipeline as tpipe
from columba_tpu_torch.search.scheme import get_multi_scheme as tmulti
from columba_tpu_torch.search.scheme import get_scheme as tscheme

from tests.conftest import sample_reads

torch.set_num_threads(1)

SCHEMES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "schemes")
FIELDS = ("ranges", "rid", "sid", "ed_lb", "done", "overflow",
          "nodes_visited", "itv_count", "searches_started")


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(81)
    base = rng.integers(0, 4, 3000).astype(np.uint8)
    haps = [base]
    for _ in range(4):
        h = base.copy()
        snp = rng.random(len(h)) < 0.005
        h[snp] = (h[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
        haps.append(h)
    g = np.concatenate(haps + [rng.integers(0, 4, 2000).astype(np.uint8)])
    ja = jbm.build_bmove_from_codes(g)
    ta = tbm.build_bmove_from_codes(g)
    return g, jbm.BMoveIndex.from_arrays(ja), tbm.BMoveIndex.from_arrays(
        ta, "cpu")


def _reads(g, seed, num, m, k):
    reads = sample_reads(np.random.default_rng(seed), g, num=num, length=m,
                         max_err=k, edits=True)
    reads[1, m // 3] = 4                                     # a read with N
    return reads.astype(np.uint8)


def _key(occs):
    return list(zip(*(getattr(occs, f).tolist() for f in
                      ("read_id", "strand", "begin", "end", "distance"))))


@pytest.mark.parametrize("k", [2, 4])
def test_dynamic_partition_rlc(world, monkeypatch, k):
    """kuch1 at k = 2 (3 parts) and k = 4 (5 parts), K = 1 (no seed table
    on RLC): the boundaries and every column of each part's final range.
    The JAX scan's final carry is caught by a wrapper around
    ``jax.lax.scan``, with the function run outside ``jit``."""
    g, jb, tb = world
    m = 90
    reads = _reads(g, 82 + k, 24, m, k)
    reads[2] = 0                                             # homopolymer
    reads[3, :40] = reads[3, 40:80]                          # a tandem copy
    jsc, tsc = jscheme("kuch1", k), tscheme("kuch1", k)
    carry = {}
    scan = jax.lax.scan

    def caught(body, init, xs, length=None):
        out = scan(body, init, xs, length=length)
        carry["final"] = out[0]
        return out

    monkeypatch.setattr(jax.lax, "scan", caught)
    want = np.asarray(jdyn.dynamic_partition(
        jb, jnp.asarray(reads.astype(np.int32)), jsc, None))
    monkeypatch.undo()
    want_rng = np.asarray(carry["final"][2]).astype(np.int64)
    p = tsc.num_parts
    got_rng = torch.zeros((len(reads), p, 8), dtype=torch.int64)
    got = tdyn.dynamic_partition(tb, torch.from_numpy(reads), tsc, None,
                                 got_rng)
    np.testing.assert_array_equal(want, got.numpy())
    assert want_rng.shape == (len(reads), p, 8)
    np.testing.assert_array_equal(want_rng, got_rng.numpy())
    # partitions are per read; some parts end empty, some wide
    assert len({tuple(r) for r in got.numpy().tolist()}) > 1
    widths = want_rng[..., 1] - want_rng[..., 0]
    assert (widths == 0).any() and (widths > 1).any()


def test_part_ranges_and_selection_rlc(world):
    """exact_match with per-row lengths (empty rows, an N, length 0),
    part_exact_ranges (8 wide) and select_schemes' choice and mask on the
    RLC index, for kuch1 and its mirror and for the columba set."""
    g, jb, tb = world
    rng = np.random.default_rng(85)
    B, m = 64, 30
    starts = rng.integers(0, len(g) - m, B)
    pats = g[starts[:, None] + np.arange(m)].copy()
    pats[::5, rng.integers(0, m)] ^= 1                      # some miss
    pats[7, 3] = 4
    lens = rng.integers(0, m + 1, B).astype(np.int32)
    lens[:2] = [0, m]
    jpats = np.where(np.arange(m)[None] < lens[:, None], pats, 5)
    want = np.asarray(jext.exact_match(
        jb, jnp.asarray(jpats.astype(np.int32)),
        jnp.asarray(lens))).astype(np.int64)
    got = text.exact_match(tb, torch.from_numpy(jpats.astype(np.uint8)),
                           torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(got, want)
    live = want[:, 1] > want[:, 0]
    assert 0 < int(live.sum()) < B
    np.testing.assert_array_equal(want[~live], 0)           # empty is zero

    reads = _reads(g, 86, 40, 60, 2)
    batch = np.concatenate([reads, reads[:, ::-1] ^ 3])
    batch[batch > 3] = 4
    for name, k in (("kuch1", 2), ("columba", 2), ("columba", 4)):
        js, ts = jmulti(name, k), tmulti(name, k)
        pts = jpipe.schedule.uniform_partition(60, js[0].num_parts)
        wr = np.asarray(jpipe.part_exact_ranges(
            jb, jnp.asarray(batch.astype(np.int32)), pts)).astype(np.int64)
        gr = tpipe.part_exact_ranges(tb, torch.from_numpy(batch), pts)
        np.testing.assert_array_equal(gr.numpy(), wr)
        _, wmask, wchoice = jpipe.select_schemes(
            jb, jnp.asarray(batch.astype(np.int32)), js)
        _, gmask, gchoice = tpipe.select_schemes(
            tb, torch.from_numpy(batch), ts)
        np.testing.assert_array_equal(gchoice, wchoice)
        np.testing.assert_array_equal(gmask, wmask)
        if name == "kuch1":
            assert len(set(gchoice.tolist())) == 2          # both schemes


@pytest.mark.parametrize("masked", [False, True])
def test_run_scheme_dyn_rlc(world, masked):
    """run_scheme under per-read schedules on 8-wide RLC lanes (the
    per-lane exact loop and band step), with and without a search mask:
    every FrontierResult field and the in-text rows equal the JAX run."""
    g, jb, tb = world
    rng = np.random.default_rng(87)
    m, k = 60, 2
    reads = _reads(g, 88, 16, m, k)
    batch = np.concatenate([reads, reads[:, ::-1] ^ 3])
    batch[batch > 3] = 4
    jsc, tsc = jscheme("kuch1", k), tscheme("kuch1", k)
    pts = tdyn.dynamic_partition(tb, torch.from_numpy(batch), tsc)
    mask = (rng.random((len(batch), len(jsc.searches))) < 0.6
            if masked else None)
    jsched = jpipe.compile_cached(jsc, m, "edit", kmer_k=0)
    tsched = tpipe.compile_cached(tsc, m, "edit", kmer_k=0)
    jst = jdyn.scheme_static(jsc, m, "edit")
    tst = tdyn.scheme_static(tsc, m, "edit")
    cap = 1024
    itv_cap, split, cap2 = jpipe.crossover_caps(cap, 4096, 4)
    kw = dict(switchpoint=4, itv_cap=itv_cap, split_step=split,
              capacity2=cap2, itv_min_depth=16)

    def jrun(b, p_, mk):
        dyn = jdyn.build_tables(jst, jdyn.clamp_partition(p_, m, k), b)
        return jexe.run_scheme(jb, b, jsched, cap, None, search_mask=mk,
                               dyn=dyn, **kw)

    want = jax.jit(jrun)(jnp.asarray(batch.astype(np.int32)),
                         jnp.asarray(pts.numpy()),
                         None if mask is None else jnp.asarray(mask))
    tbatch = torch.from_numpy(batch)
    got = texe.run_scheme(
        tb, tbatch, tsched, cap, None, dyn=tdyn.build_tables(tst, pts, tbatch),
        search_mask=None if mask is None else torch.from_numpy(mask), **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(want, f)).astype(np.int64),
            getattr(got, f).numpy().astype(np.int64), err_msg=f)
    n = int(want.itv_count)
    np.testing.assert_array_equal(np.asarray(want.itv)[:n].astype(np.int64),
                                  got.itv[:n].numpy())
    assert n > 0 and bool(got.done.any()) and int(got.overflow) == 0


@pytest.mark.parametrize("mode", ["dynamic", "selection"])
def test_match_all_rlc_select(world, mode):
    """match_all on the RLC index with per-read boundaries (kernel F's path)
    and with kuch1 and its mirror (the selection probe, then the masked
    combined pass): the JAX package's OccArray."""
    g, jb, tb = world
    reads = _reads(g, 89, 16, 60, 2)
    if mode == "dynamic":
        js, ts, kw = jscheme("kuch1", 2), tscheme("kuch1", 2), dict(
            partitioning="dynamic")
    else:
        js, ts, kw = jmulti("kuch1", 2), tmulti("kuch1", 2), {}
    want, _ = jpipe.match_all(jb, reads, js, switchpoint=4, **kw)
    got, stats = tpipe.match_all(tb, reads, ts, switchpoint=4, **kw)
    assert _key(got) == _key(want) and len(got) >= 16
    assert stats["overflow"] == 0


@pytest.fixture(scope="module")
def cli_world(world, tmp_path_factory):
    """The world as a FASTA, both packages' ``cli build --rlc`` of it, 200
    single-end reads of 60 bp and 128 FR pairs of 60 bp mates (up to 2
    substitutions each, an N, half reverse-complemented or swapped), and a
    two-scheme collection for -d (kuch_k+1 and its mirror per k)."""
    g = world[0]
    wd = tmp_path_factory.mktemp("rlcselect")
    lut = np.frombuffer(b"ACGTN", np.uint8)
    txt = lut[g].tobytes().decode()
    with open(wd / "g.fa", "w") as f:
        f.write(">pan one\n" + "\n".join(
            txt[j:j + 70] for j in range(0, len(txt), 70)) + "\n")
    idx = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        idx[name] = str(wd / f"{name}.rlc.cidx")
        assert cli.main(["build", "-r", idx[name], "-f", str(wd / "g.fa"),
                         "--rlc"]) == 0
    rng = np.random.default_rng(90)
    m = 60
    comp = np.array([3, 2, 1, 0, 4], np.uint8)

    def mutate(rr):
        for r in rr:
            k = rng.integers(0, 3)
            r[rng.integers(0, m, k)] = rng.integers(0, 4, k)

    def write(name, rr, suffix=""):
        with open(wd / name, "w") as f:
            for i, r in enumerate(rr):
                f.write(f"@q{i}{suffix}\n{lut[r].tobytes().decode()}\n+\n"
                        f"{'I' * m}\n")
        return str(wd / name)

    starts = rng.integers(0, len(g) - m, 200)
    se = g[starts[:, None] + np.arange(m)].copy()
    mutate(se)
    se[5, 30] = 4
    flip = rng.random(len(se)) < 0.5
    se[flip] = comp[se[flip]][:, ::-1]
    R = 128
    frag = rng.integers(150, 300, R)
    pos = rng.integers(0, len(g) - 300, R)
    r1 = g[pos[:, None] + np.arange(m)].copy()
    r2 = comp[g[(pos + frag - m)[:, None] + np.arange(m)]][:, ::-1].copy()
    mutate(r1)
    mutate(r2)
    swap = rng.random(R) < 0.5
    r1[swap], r2[swap] = r2[swap].copy(), r1[swap].copy()
    r2[9] = rng.integers(0, 4, m)                 # mate 2 unmappable
    multi = wd / "multi"
    for k in (1, 2):
        (multi / str(k)).mkdir(parents=True)
        base = tscheme("kuch1", k)
        for x, sc in enumerate((base, base.mirrored()), 1):
            (multi / str(k) / f"scheme{x}.txt").write_text(str(sc) + "\n")
    return dict(idx=idx, se=write("se.fq", se),
                pe=(write("p1.fq", r1, "/1"), write("p2.fq", r2, "/2")),
                multi=str(multi), wd=wd)


@pytest.mark.parametrize("tag,opts,paired", [
    ("se_all_dynamic", ["-a", "all", "-e", "2", "-p", "dynamic"], False),
    ("se_best_d", ["-a", "best", "-I", "96", "-d", "@MULTI@"], False),
    ("pe_best_c", ["-a", "best", "-I", "96", "-c",
                   os.path.join(SCHEMES, "kuch_k+1")], True),
    ("se_best_probe", ["-a", "best", "-I", "96", "-S", "columba",
                       "--probe-selection"], False),
])
def test_align_rlc_select_identical_sam(cli_world, tag, opts, paired):
    """Byte-identical SAM records from both packages' ``cli align --rlc``
    with -p dynamic (SE ALL), a two-scheme collection (-d, SE BEST), a
    scheme folder with selection on (-c without -nD, PE BEST) and the
    forced probe of the columba set (SE BEST)."""
    w = cli_world
    opts = [w["multi"] if o == "@MULTI@" else o for o in opts]
    out = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        out[name] = str(w["wd"] / f"{tag}.{name}.sam")
        argv = ["align", "-r", w["idx"][name], "-f",
                w["pe"][0] if paired else w["se"], "-o", out[name],
                "-S", "kuch1", "-b", "256"] + opts
        if paired:
            argv += ["-F", w["pe"][1]]
        if name == "torch":
            argv += ["--device", "cpu"]
        assert cli.main(argv) == 0
    body = {k: [ln for ln in open(v).read().splitlines()
                if not ln.startswith("@")] for k, v in out.items()}
    assert body["jax"] == body["torch"]
    assert len(body["torch"]) >= (256 if paired else 200)
    mapped = [ln for ln in body["torch"] if ln.split("\t")[2] != "*"]
    assert len(mapped) > (200 if paired else 150)
