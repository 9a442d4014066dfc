"""The port's GRCh38-scale tool, and its positions past 2^31, against the
JAX package.

The tool (``columba_tpu_torch/tools/bigbuild.py`` against ``tools/
bigbuild.py``): ``synth_genome``'s codes, names and starts; both packages'
index arrays of its genome at ``--sa-sparseness 16``; ``match_all``'s
occurrence set and recall on the tool's reads (JAX on the CPU, the port with
``device="cpu"``); and the port tool's ``main`` with ``--device cpu``, as
it is and with ``--blocks --block-bp 150000``. Both tools cut the genome
into sequences of ``CHROMO`` bases; the tests set it to 2^17 in both, so
that a 400,000 bp genome has four sequences and three blocks (at 2^27 it
would be one sequence, which no block of 150,000 bp holds). The blocked
run's ``cli align`` takes a 6-mer seed table in place of the default
10-mer one, whose plain build costs about 80 s a block on one core.

No test builds a 2 Gbp text. The functions that map a global position
(a candidate's SA rows, a window start, an occurrence's begin and end) to
a sequence, a trim, a SAM record or a pair are held to the JAX package's on
numpy inputs at 2^31 - m .. 2^31 + m and near the largest index
(``MAX_N`` = 2^32 - 2^18, the top of the uint32 range), with the sequence
starts of a 3.1 Gbp genome of 2^27 bp sequences (``chr17`` begins at
2^31) and of 32 such sequences ending at ``MAX_N``:

- ``pipeline.stage_expand`` (SA rows past 2^31) and ``stage_dedup``
  (window starts past 2^31, and below 0 as the JAX package's wrapped
  uint32);
- ``pipeline._extract_occurrences`` (final rows at window starts past
  2^31);
- ``pipeline.apply_boundary_trim`` on occurrences that straddle 2^31 (the
  ``chr16``/``chr17`` boundary) and the last boundary below ``MAX_N``;
- ``pairing.concordant_pairs`` on mates on both sides of those
  boundaries;
- the SAM records of occurrences on ``chr16`` .. ``chr32``: the port's
  native emitter and Python emitter against the JAX package's Python
  emitter;
- ``ops/locate.py`` ``locate_rows_plain`` against the JAX package's
  ``locate_rows`` on a small index whose SA samples both packages see
  shifted past 2^31 and up to 2^32 - 2.

The text these read lies in a sparse file of 2^32 bases (2 bits each in
the packed words the trim reads, 1 byte each in the decoded text the
emitters read): only the pages around the test loci are ever written.

The build's passes, which a 3.1 Gbp build needs to fit its time and
memory: its chunked numpy passes, with chunks shrunk so that each pass runs
over many, against the JAX package's arrays at sparseness 4 and 16; the
FASTA parser, a record at a time, against the JAX package's line reader;
the parallel bucket sort's suffix array against numpy prefix doubling, on
fewer and more threads than its count slices, and its hand-off to SA-IS
on a repeat deeper than its limit; the native BWT gather against numpy's
chunks.
"""

import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

from columba_tpu.core import alphabet as jalphabet
from columba_tpu.index.build import IndexArrays as JIndexArrays
from columba_tpu.index.build import build_index_from_codes as jbuild
from columba_tpu.index.fmindex import FMIndex as JFMIndex
from columba_tpu.io.fastq import ReadRecord as JRecord
from columba_tpu.ops import locate as jlocate
from columba_tpu.search import pairing as jpairing
from columba_tpu.search import pipeline as jpipe
from columba_tpu.search import strategy as jstrategy
from columba_tpu.search.scheme import get_scheme as jget_scheme
from columba_tpu_torch import cli as tcli
from columba_tpu_torch.index.build import MAX_N
from columba_tpu_torch.index.build import build_index_from_codes as tbuild
from columba_tpu_torch.index.fmindex import FMIndex as TFMIndex
from columba_tpu_torch.io import emit as temit
from columba_tpu_torch.io.fastq import ReadRecord as TRecord
from columba_tpu_torch.ops import locate as tlocate
from columba_tpu_torch.search import pairing as tpairing
from columba_tpu_torch.search import pipeline as tpipe
from columba_tpu_torch.search import strategy as tstrategy
from columba_tpu_torch.search.scheme import get_scheme as tget_scheme
from columba_tpu_torch.tools import bigbuild as tbig

torch.set_num_threads(1)

ARRAYS = ["text", "bwt", "rbwt", "occ", "rocc", "counts", "sa_samples",
          "sa_bits", "sa_bits_rank", "seq_starts"]
SMALL_CHROMO = 1 << 17
N_TOOL = 400_000            # --gbp 0.0004
M = 100
TWO31 = 1 << 31
SEQ = 1 << 27


def _jax_tool():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "bigbuild.py")
    spec = importlib.util.spec_from_file_location("jax_bigbuild", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def small_chromo(monkeypatch):
    jbig = _jax_tool()
    monkeypatch.setattr(jbig, "CHROMO", SMALL_CHROMO)
    monkeypatch.setattr(tbig, "CHROMO", SMALL_CHROMO)
    return jbig


@pytest.fixture(scope="module")
def tool_genome():
    """The tool's 400,000 bp genome in 2^17 bp sequences, both packages'
    indexes of it at sparseness 16, and the tool's reads."""
    jbig = _jax_tool()
    saved = (jbig.CHROMO, tbig.CHROMO)
    jbig.CHROMO = tbig.CHROMO = SMALL_CHROMO
    try:
        codes, names, starts = tbig.synth_genome(N_TOOL)
        jcodes, jnames, jstarts = jbig.synth_genome(N_TOOL)
        tarr = tbuild(codes, names, starts, sa_sparseness=16)
        jarr = jbuild(jcodes, jnames, jstarts, sa_sparseness=16)
        reads, begins = tbig.sample_reads(tarr.text, tarr.n, 64, M, 2)
    finally:
        jbig.CHROMO, tbig.CHROMO = saved
    return dict(codes=codes, names=names, starts=starts, jcodes=jcodes,
                jnames=jnames, jstarts=jstarts, tarr=tarr, jarr=jarr,
                reads=reads, begins=begins)


@pytest.mark.parametrize("chromo", [1 << 27, SMALL_CHROMO])
def test_synth_genome_matches_jax(chromo, monkeypatch):
    jbig = _jax_tool()
    monkeypatch.setattr(jbig, "CHROMO", chromo)
    monkeypatch.setattr(tbig, "CHROMO", chromo)
    for n in (N_TOOL, 3 * SMALL_CHROMO):
        tc, tn, ts = tbig.synth_genome(n)
        jc, jn, js = jbig.synth_genome(n)
        assert np.array_equal(tc, jc) and tc.dtype == jc.dtype
        assert tn == jn
        assert np.array_equal(ts, js) and ts.dtype == js.dtype


def test_tool_index_arrays_match_jax(tool_genome):
    g = tool_genome
    assert g["names"] == [f"chr{i}" for i in range(1, 5)]
    assert g["tarr"].meta == g["jarr"].meta
    for name in ARRAYS:
        a, b = getattr(g["tarr"], name), getattr(g["jarr"], name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("sparseness", [4, 16])
def test_chunked_build_passes_match_jax(sparseness, tool_genome,
                                        monkeypatch):
    """The build's chunked passes at chunk sizes small enough that each
    runs over many chunks, as at 3.1 Gbp (``pack_2bit`` 98 chunks, the occ
    and bit passes 98, the SA sampling and the base count 98,
    ``unpack_2bit`` 98): every array equals the JAX package's."""
    from columba_tpu.index.build import unpack_2bit as junpack
    from columba_tpu_torch.index import build as tb

    monkeypatch.setattr(tb, "PACK_SPAN", 4096)
    monkeypatch.setattr(tb, "UNPACK_SPAN", 256)
    monkeypatch.setattr(tb, "BLOCK_SPAN", 32)
    monkeypatch.setattr(tb, "ROW_SPAN", 4096)
    g = tool_genome
    tarr = tb.build_index_from_codes(g["codes"], g["names"], g["starts"],
                                     sa_sparseness=sparseness)
    jarr = (g["jarr"] if sparseness == 16 else
            jbuild(g["jcodes"], g["jnames"], g["jstarts"], sa_sparseness=4))
    assert tarr.meta == jarr.meta
    for name in ARRAYS:
        a, b = getattr(tarr, name), getattr(jarr, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert np.array_equal(tb.unpack_2bit(tarr.text, tarr.n),
                          junpack(jarr.text, jarr.n))


FASTAS = {
    "plain": b">s0\nACGTNNAC\nGGTA\n>s1\nTTGCA\n",
    "descriptions": b">1 dna:chromosome chromosome:GRCh38:1:1:9:1 REF\n"
                    b"ACGTNAC\nGG\n>chr2 2\nTTRCA\nA",
    "crlf": b">s0 desc\r\nACGTAC\r\nGGTA\r\n>s1\r\nTTGCA\r\n",
    "per_record": b">s0 x\nACG TA\n\n  CC\t\n>s1 y\nGGGNNNT\nAA\n",
    "preamble": b"junk ACGT\n\n>s0\nACGT\n",
    "indented_header": b"ACGT\n  >s0 a\nAC\n>s1\nGT\n \t>s2\nTT\n",
    "empty_record": b">s0\n>s1\nACGT\n\n>s2\n",
    "no_newline": b">s0\nACGTN",
}


@pytest.mark.parametrize("case", sorted(FASTAS))
def test_preprocess_fasta_matches_jax(case, tmp_path):
    """One parser, a record at a time: headers with descriptions, CR line
    ends, blanks inside a body, an indented header, lines before the first
    header, empty records; two files at once. The JAX package reads line
    by line."""
    from columba_tpu.index.build import preprocess_fasta as jpre
    from columba_tpu_torch.index.build import preprocess_fasta as tpre

    paths = [str(tmp_path / "a.fa"), str(tmp_path / "b.fa")]
    (tmp_path / "a.fa").write_bytes(FASTAS[case])
    (tmp_path / "b.fa").write_bytes(b">t0 z\nNNACGTRY\n")
    for seed_length in (100, 0):
        tc, tn, ts = tpre(paths, seed=3, seed_length=seed_length)
        jc, jn, js = jpre(paths, seed=3, seed_length=seed_length)
        assert tn == jn
        assert tc.dtype == jc.dtype and np.array_equal(tc, jc)
        assert ts.dtype == js.dtype and np.array_equal(ts, js)


def test_tool_reads_match_jax_draws(tool_genome):
    """The port's sampler makes the JAX tool's reads: the same draws of a
    generator seeded 7, in its order (re-done here inline as the JAX tool
    does in its main)."""
    from columba_tpu.index.build import unpack_2bit

    g = tool_genome
    rng = np.random.default_rng(7)
    starts_pos = rng.integers(0, N_TOOL - M - 8, size=64)
    bad = (starts_pos % SMALL_CHROMO) > (SMALL_CHROMO - M - 8)
    starts_pos[bad] -= M + 8
    words = g["jarr"].text
    for i, s in enumerate(starts_pos):
        w0 = int(s) // 16
        seq = unpack_2bit(words[w0:w0 + M // 16 + 2], M + 16)[
            int(s) % 16:int(s) % 16 + M].copy()
        for _ in range(min(int(rng.poisson(0.01 * M)), 2)):
            j = int(rng.integers(0, M))
            seq[j] = (seq[j] + 1 + rng.integers(0, 3)) % 4
        if rng.random() < 0.5:
            seq = jalphabet.revcomp(seq)
        assert np.array_equal(seq, g["reads"][i]), i
    assert np.array_equal(starts_pos, g["begins"])


def test_tool_match_all_matches_jax(tool_genome):
    g = tool_genome
    reads, begins = g["reads"], g["begins"]
    jocc, jstats = jpipe.match_all(
        JFMIndex.from_arrays(g["jarr"]), reads, jget_scheme("kuch1", 2),
        metric="edit", switchpoint=4, max_locate=4096)
    tocc, tstats = tpipe.match_all(
        TFMIndex.from_arrays(g["tarr"], "cpu"), reads,
        tget_scheme("kuch1", 2), metric="edit", switchpoint=4,
        max_locate=4096)
    jset = sorted(zip(*(getattr(jocc, f).tolist() for f in
                        ("read_id", "strand", "begin", "end", "distance"))))
    tset = sorted(zip(*(getattr(tocc, f).tolist() for f in
                        ("read_id", "strand", "begin", "end", "distance"))))
    assert tset == jset and len(tset) >= 64
    assert tstats["overflow"] == jstats["overflow"] == 0
    jrec = np.zeros(64, bool)
    for o in jocc:
        if abs(o.begin - int(begins[o.read_id])) <= 2:
            jrec[o.read_id] = True
    trec = tbig.recall_at_truth(tocc.read_id, tocc.begin, begins, 2)
    assert trec == float(jrec.mean()) >= tbig.MIN_RECALL


def test_tool_main_cpu(tmp_path, capsys):
    assert tbig.main(["--device", "cpu", "--gbp", "0.0004", "--reads",
                      "64", "--cache", str(tmp_path)]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["n"] == N_TOOL and res["reads"] == 64 and res["k"] == 2
    assert res["recall_at_truth"] >= 0.99 and res["overflow"] == 0
    assert set(res) == {"n", "reads", "k", "recall_at_truth",
                        "total_candidates", "overflow"}


def test_tool_main_blocks_cpu(tmp_path, capsys, small_chromo, monkeypatch):
    main = tcli.main
    monkeypatch.setattr(tcli, "main", lambda argv: main(argv + ["-K", "6"]))
    assert tbig.main(["--device", "cpu", "--gbp", "0.0004", "--reads", "64",
                      "--cache", str(tmp_path), "--blocks", "--block-bp",
                      "150000"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["blocks"] == 3 and res["n"] == N_TOOL
    assert res["recall_at_truth"] >= 0.99


# -- values past 2^31 ------------------------------------------------------

def layout_31():
    """Sequence starts of a 3.1 Gbp genome of 2^27 bp sequences: chr17
    begins at 2^31."""
    return np.append(np.arange(0, 3_100_000_000, SEQ),
                     3_100_000_000).astype(np.int64)


def layout_top():
    """32 sequences of 2^27 bp, the last ending at MAX_N."""
    return np.append(np.arange(0, 32 * SEQ, SEQ), MAX_N).astype(np.int64)


@pytest.fixture(scope="module")
def sparse_text(tmp_path_factory):
    """A 2^32-base text in sparse files (packed words and decoded bytes),
    random bases around each test locus and A elsewhere, with the loci."""
    wd = tmp_path_factory.mktemp("sparse")
    words = np.memmap(wd / "text.u32", dtype=np.uint32, mode="w+",
                      shape=(1 << 28,))
    decoded = np.memmap(wd / "text.u8", dtype=np.uint8, mode="w+",
                        shape=(1 << 32,))
    rng = np.random.default_rng(2026)
    loci = [TWO31 + d for d in range(-M, M + 1, 7)]
    loci += [15 * SEQ - M // 2, 31 * SEQ - 3 * M, 31 * SEQ - 40, 31 * SEQ + 3,
             MAX_N - M - 1, MAX_N - 3 * M, 3_100_000_000 - M]
    for p in loci:
        lo = (p - 4 * M) & ~15
        hi = min(p + 5 * M, 1 << 32)
        hi = (hi + 15) & ~15
        codes = rng.integers(0, 4, hi - lo).astype(np.uint8)
        decoded[lo:hi] = codes
        shifts = 2 * np.arange(16, dtype=np.uint32)
        words[lo // 16:hi // 16] = np.bitwise_or.reduce(
            codes.reshape(-1, 16).astype(np.uint32) << shifts, axis=1)
    return words, decoded, sorted(set(loci))


def occurrences(decoded, loci, rng, straddle_ok=True):
    """Reads of M bases at each locus (some reverse-complemented, up to two
    substitutions) and their occurrences, as rows of (read, strand, begin,
    end, distance)."""
    reads, rows = [], []
    for i, p in enumerate(loci):
        seq = np.array(decoded[p:p + M])
        nsub = i % 3
        for j in rng.choice(M, nsub, replace=False):
            seq[j] = (seq[j] + 1) % 4
        strand = i % 2
        reads.append(seq if strand == 0 else jalphabet.revcomp(seq))
        rows.append((i, strand, p, p + M, nsub))
    return np.stack(reads).astype(np.uint8), np.array(rows, np.int64)


def both_occ(rows):
    cols = [rows[:, c] for c in range(5)]
    return tpipe.OccArray(*cols), jpipe.OccArray(*cols)


def occ_tuples(o):
    return list(zip(*(getattr(o, f).tolist() for f in
                      ("read_id", "strand", "begin", "end", "distance"))))


def test_stage_expand_past_2_31():
    import jax.numpy as jnp

    c_lo = np.array([TWO31 - 5, TWO31 + 9, MAX_N - 40, 7, TWO31 - 1,
                     MAX_N - 2], np.int64)
    c_hi = c_lo + np.array([12, 3, 41, 0, 2, 3])
    for cap in (16, 64):
        t = tpipe.stage_expand(torch.from_numpy(c_lo),
                               torch.from_numpy(c_hi), cap)
        j = jpipe.stage_expand(jnp.asarray(c_lo.astype(np.uint32)),
                               jnp.asarray(c_hi.astype(np.uint32)), cap)
        for a, b in zip(t, j):
            assert np.array_equal(np.asarray(a).astype(np.int64),
                                  np.asarray(b).astype(np.int64))
        assert int(np.asarray(t[0]).max()) >= TWO31


def test_stage_dedup_past_2_31():
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    base = np.array([TWO31 - M, TWO31 - 1, TWO31, TWO31 + M, MAX_N - M,
                     (1 << 32) - 1 - 2 * M, -3, 0, 5])
    win = rng.choice(base, 200).astype(np.int64)
    rid = rng.integers(0, 6, 200).astype(np.int64)
    valid = rng.random(200) < 0.9
    for cap in (8, 256):
        t = tpipe.stage_dedup(torch.from_numpy(rid), torch.from_numpy(win),
                              torch.from_numpy(valid), cap)
        j = jpipe.stage_dedup(jnp.asarray(rid.astype(np.int32)),
                              jnp.asarray(win.astype(np.uint32)),
                              jnp.asarray(valid), 200, cap)
        rid_t, win_t, live_t, n_t = (np.asarray(x) for x in t)
        rid_j, win_j, live_j, n_j = (np.asarray(x) for x in j)
        assert int(n_t) == int(n_j)
        assert np.array_equal(live_t, live_j)
        assert np.array_equal(rid_t, rid_j.astype(np.int64))
        # the port keeps signed starts; the JAX package wraps them to uint32
        assert np.array_equal(win_t & 0xFFFFFFFF, win_j.astype(np.int64))
        assert (win_t[live_t] >= TWO31).any()


def test_extract_occurrences_past_2_31():
    rng = np.random.default_rng(6)
    kb, k, R = 2, 2, 4
    B = 40
    starts = np.concatenate([TWO31 - M + np.arange(20) * 9,
                             MAX_N - 3 * M + np.arange(20) * 11])
    rows = rng.integers(0, 6, (B, 4 * kb + 1)).astype(np.int32)
    out = dict(valid=rng.random(B) < 0.8, final_rows=rows,
               rid=rng.integers(0, 2 * R, B).astype(np.int32),
               win_start=starts.astype(np.uint32))
    t = tpipe._extract_occurrences(
        dict(out, win_start=starts.astype(np.int64)), R, M, k, kb)
    j = jpipe._extract_occurrences(out, R, M, k, kb)
    assert occ_tuples(t) == occ_tuples(j) and len(t)
    assert (t.begin >= TWO31 - M).all() and (t.end > TWO31).any()


@pytest.mark.parametrize("layout", ["3.1gbp", "top"])
def test_boundary_trim_past_2_31(layout, sparse_text):
    words, decoded, loci = sparse_text
    starts = layout_31() if layout == "3.1gbp" else layout_top()
    end = int(starts[-1])
    loci = [p for p in loci if p + M <= end]
    reads, rows = occurrences(decoded, loci, np.random.default_rng(9))
    arrays = types.SimpleNamespace(text=words, seq_starts=starts, n=end)
    for kb, k in ((2, 2), (4, 4), (0, 0)):
        t_occ, j_occ = both_occ(rows if kb else rows * [1, 1, 1, 1, 0])
        t = tpipe.apply_boundary_trim(t_occ, reads, arrays, kb, k)
        j = jpipe.apply_boundary_trim(j_occ, reads, arrays, kb, k)
        assert occ_tuples(t) == occ_tuples(j)
        # occurrences that straddle a boundary at 2^31 or above are trimmed
        # or dropped, never kept whole
        i_lo = np.searchsorted(starts, t.begin, side="right")
        i_hi = np.searchsorted(starts, t.end - 1, side="right")
        assert (i_lo == i_hi).all()
        assert len(t) < len(rows) and (t.begin >= TWO31).any()


@pytest.mark.parametrize("orientation", ["fr", "rf", "ff"])
def test_concordant_pairs_past_2_31(orientation):
    rng = np.random.default_rng(11)
    rows1, rows2 = [], []
    for pid, p in enumerate([TWO31 - 300, TWO31 - 150, TWO31 + 20,
                             16 * SEQ - 90, 31 * SEQ - 120, MAX_N - 500,
                             TWO31 + 5 * SEQ - 60]):
        frag = int(rng.integers(200, 450))
        for s1 in (0, 1):
            rows1.append((pid, s1, p, p + M, pid % 3))
            rows2.append((pid, 1 - s1, p + frag - M, p + frag, pid % 2))
            rows2.append((pid, s1, p + frag - M, p + frag, 1))
    r1, r2 = np.array(rows1, np.int64), np.array(rows2, np.int64)
    for starts in (layout_31(), layout_top()):
        (t1, j1), (t2, j2) = both_occ(r1), both_occ(r2)
        t = tpairing.concordant_pairs(t1, t2, orientation, 150, 500, starts)
        j = jpairing.concordant_pairs(j1, j2, orientation, 150, 500, starts)
        for f in ("pair_id", "up_is_1", "u_begin", "u_end", "u_dist",
                  "u_strand", "d_begin", "d_end", "d_dist", "d_strand"):
            assert np.array_equal(getattr(t, f), getattr(j, f)), f
        su = np.searchsorted(starts, t.u_begin, side="right")
        sd = np.searchsorted(starts, t.d_begin, side="right")
        assert (su == sd).all() and len(t)


def test_sam_records_past_2_31(sparse_text):
    """SAM of occurrences on chr16 .. chr32 (no straddling one: the trim
    runs first): the port's native emitter, its Python emitter and the JAX
    package's Python emitter, byte for byte."""
    words, decoded, loci = sparse_text
    starts = layout_top()
    names = [f"chr{i + 1}" for i in range(32)]
    loci = [p for p in loci
            if np.searchsorted(starts, p, side="right")
            == np.searchsorted(starts, p + M - 1, side="right")]
    reads, rows = occurrences(decoded, loci, np.random.default_rng(13))
    qual = "I" * M
    recs = [(f"r{i}", reads[i]) for i in range(len(reads))]
    lines = {}
    for pkg, OA, Rec, strat in (("torch", tpipe.OccArray, TRecord,
                                 tstrategy),
                                ("jax", jpipe.OccArray, JRecord,
                                 jstrategy)):
        arrays = types.SimpleNamespace(
            seq_starts=starts, seq_names=names, n=MAX_N,
            _decoded_text=decoded)
        occ = OA(*(rows[:, c] for c in range(5)))
        mapped = strat._group_mapped(occ, len(recs))
        out = strat.emit_sam([Rec(nm, c, qual) for nm, c in recs], mapped,
                             arrays, None, 2, mode="all")
        lines[pkg] = "".join(out)
    assert lines["torch"] == lines["jax"]
    if temit.available():
        names_buf, name_offs = temit.pack_strings([r[0] for r in recs])
        quals_buf, qual_offs = temit.pack_strings([qual] * len(recs))
        arrays = types.SimpleNamespace(seq_starts=starts, seq_names=names)
        occ = tpipe.OccArray(*(rows[:, c] for c in range(5)))
        native = temit.emit_sam_native(
            reads, names_buf, name_offs, quals_buf, qual_offs, occ, arrays,
            decoded, 2, n_threads=2).decode()
        assert native == lines["torch"]
    body = [ln.split("\t") for ln in lines["jax"].splitlines()]
    assert {int(f[2][3:]) for f in body} == {16, 17, 24, 31, 32}
    assert max(int(f[3]) for f in body) > SEQ - 2 * M


@pytest.mark.parametrize("shift", [TWO31 + 12_345, "top"])
def test_locate_rows_plain_past_2_31(shift, small_index):
    """locate_rows_plain (kernel C's plain version) against the JAX
    package's locate_rows, with the SA samples shifted past 2^31 in
    both."""
    arrays = small_index[1]
    n = int(arrays.n)
    s = (1 << 32) - 2 - n if shift == "top" else shift
    samples = (arrays.sa_samples.astype(np.int64) + s).astype(np.uint32)
    fields = {f: getattr(arrays, f) for f in ARRAYS}
    fields["sa_samples"] = samples
    jarr = JIndexArrays(meta=dict(arrays.meta), seq_names=list(
        arrays.seq_names), **fields)
    rows = np.random.default_rng(3).integers(0, n + 1, 3000)
    j = np.asarray(jlocate.locate_rows(JFMIndex.from_arrays(jarr),
                                       rows.astype(np.uint32)))
    t = tlocate.locate_rows_plain(TFMIndex.from_arrays(jarr, "cpu"),
                                  torch.from_numpy(rows)).numpy()
    assert np.array_equal(t, j.astype(np.int64))
    assert t.min() >= s and t.max() <= (1 << 32) - 2


# -- the build's native passes ---------------------------------------------

def _bucket_sa(text, depth, threads=3):
    import ctypes

    from columba_tpu_torch import native

    lib = native.load("sais_tpu", ["sais.cpp", "bucket_sa.cpp"])
    sa = np.empty(len(text), np.uint32)
    rc = lib.bucket_sa_u32(
        text.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(len(text)),
        sa.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(threads),
        ctypes.c_int64(depth))
    return rc, sa


def _texts():
    rng = np.random.default_rng(17)
    out = []
    for n in (1, 2, 13, 31, 32, 33, 44, 45, 64, 65, 1000):
        out += [rng.integers(0, 4, n).astype(np.uint8),
                np.zeros(n, np.uint8), np.full(n, 3, np.uint8)]
    t = rng.integers(0, 4, 60_000).astype(np.uint8)
    cycle = rng.integers(0, 4, 100).astype(np.uint8)
    for s in rng.integers(0, len(t) - 300, 40):   # the seeded runs of N
        L = int(rng.integers(10, 300))
        t[s:s + L] = cycle[np.arange(L) % 100]
    t[-150:] = 0                                   # a repeat at the end
    return out + [t]


def test_bucket_sa_matches_prefix_doubling():
    """The parallel bucket sort's suffix array is the suffix array: ties
    past the 12-base buckets and the 32-base keys, suffixes that end
    inside a key (the shorter first), runs of one base. A repeat deeper
    than its limit returns 1, and suffix_array then runs SA-IS."""
    _check_bucket_sa(3)


def test_bucket_sa_more_threads_than_count_slices():
    """The same on 12 threads, more than the sort's 8 count slices."""
    _check_bucket_sa(12)


def _check_bucket_sa(threads):
    from columba_tpu_torch.index import suffix

    for t in _texts():
        rc, sa = _bucket_sa(t, suffix.BUCKET_DEPTH, threads)
        want = suffix._prefix_doubling(t)
        if rc == 1:                       # all one base: deeper than 1,024
            assert len(t) > suffix.BUCKET_DEPTH and len(set(t)) == 1
        else:
            assert rc == 0 and np.array_equal(sa, want), len(t)
        assert np.array_equal(suffix.suffix_array(t), want)
    periodic = np.tile(np.arange(4, dtype=np.uint8), 600)
    assert _bucket_sa(periodic, 256, threads)[0] == 1
    rc, sa = _bucket_sa(periodic, 1 << 40, threads)
    assert rc == 0 and np.array_equal(sa, suffix._prefix_doubling(periodic))


def test_bwt_rows_native_matches_numpy():
    from columba_tpu_torch.index import suffix

    for t in _texts()[-4:]:
        sa = suffix._prefix_doubling(t)
        a, ra = suffix.bwt_rows(t, sa.astype(np.uint32))   # native
        b, rb = suffix.bwt_rows(t, sa.astype(np.int64))    # numpy chunks
        assert ra == rb and np.array_equal(a, b)
