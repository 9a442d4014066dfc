"""The port's blocked indexes against the JAX package's.

The workload of ``tests/test_blocked.py``: four random 30,000 bp sequences,
``build -B 70000`` (two blocks of two sequences), 48 reads of 100 bp with
up to two substitutions (a third reverse-complemented) and 26 pairs of
80 bp mates (24 ``fr`` pairs, two of random junk). Both packages' ``cli
build -B`` must write the same top ``meta.json`` and the same arrays in
each block directory, and both ``cli align`` runs on the blocked index
byte-identical records (SAM without the @PG line, and ``.rhs``) in SE ALL,
SE BEST, ``.rhs``, PE ALL and PE BEST (a 6-mer seed table, one batch a
block for each side). The JAX runs happen once, in a module fixture, with
a locate cap that fits the workload (:func:`jax_locate_cap`). The port runs
with ``--device cpu`` and must release each block's index and k-mer table
before the next block loads. ``merge_best`` is held to the JAX package's on
occurrence arrays whose positions pass 2^32, and ``sam.traceback_batch``
(the host DP of the Python emitters) at kb 0, 2 and 4. The locate-cap
hint, which outlives a block, holds its index weakly.
"""

import contextlib
import gc
import json
import os
import weakref

import numpy as np
import pytest
import torch

from columba_tpu import cli as jcli
from columba_tpu.index import blocked as jblocked
from columba_tpu.io import sam as jsam
from columba_tpu.search import pipeline as jpipe
from columba_tpu_torch import cli as tcli
from columba_tpu_torch.index import blocked as tblocked
from columba_tpu_torch.index import kmer as tkmer
from columba_tpu_torch.index.build import build_index_from_codes
from columba_tpu_torch.index.fmindex import FMIndex as TFMIndex
from columba_tpu_torch.io import sam as tsam
from columba_tpu_torch.search import pipeline as tpipe

torch.set_num_threads(1)

ARRAYS = ["text", "bwt", "rbwt", "occ", "rocc", "counts", "sa_samples",
          "sa_bits", "sa_bits_rank", "seq_starts"]
PE = ["--no-inferring", "-O", "fr", "-N", "150", "-X", "350"]
# tag -> (align options, paired, output suffix)
RUNS = {
    "se_all": (["-a", "all", "-e", "2"], False, ".sam"),
    "se_best": (["-a", "best"], False, ".sam"),
    "se_rhs": (["-a", "all", "-e", "2"], False, ".rhs"),
    "pe_all": (["-a", "all", "-e", "2"] + PE, True, ".sam"),
    "pe_best": (["-a", "best"] + PE, True, ".sam"),
}


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """``tests/test_blocked.py``'s genome, reads and pairs, and both
    packages' blocked builds of it."""
    wd = tmp_path_factory.mktemp("tblk")
    rng = np.random.default_rng(21)
    seqs = ["".join(rng.choice(list("ACGT"), 30000)) for _ in range(4)]
    with open(wd / "g.fa", "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">chr{i}\n{s}\n")
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    with open(wd / "r.fq", "w") as f:
        for i in range(48):
            si = i % 4
            p = int(rng.integers(0, 29000))
            r = list(seqs[si][p:p + 100])
            for _ in range(int(rng.integers(0, 3))):
                r[int(rng.integers(0, 100))] = "ACGT"[int(rng.integers(0, 4))]
            read = "".join(r)
            if i % 3 == 0:
                read = "".join(comp[c] for c in reversed(read))
            f.write(f"@r{i}\n{read}\n+\n{'I' * 100}\n")
    rng = np.random.default_rng(31)
    frag, m = 250, 80
    with open(wd / "p1.fq", "w") as a, open(wd / "p2.fq", "w") as b:
        for i in range(24):
            si = i % 4
            p = int(rng.integers(0, len(seqs[si]) - frag - 1))
            up = list(seqs[si][p:p + m])
            dn = [comp[c] for c in reversed(seqs[si][p + frag - m:p + frag])]
            for r in (up, dn):
                for _ in range(int(rng.integers(0, 2))):
                    r[int(rng.integers(0, m))] = "ACGT"[
                        int(rng.integers(0, 4))]
            a.write(f"@p{i}\n{''.join(up)}\n+\n{'I' * m}\n")
            b.write(f"@p{i}\n{''.join(dn)}\n+\n{'I' * m}\n")
        for i in range(24, 26):   # junk
            for f in (a, b):
                f.write(f"@p{i}\n{''.join(rng.choice(list('ACGT'), m))}\n+\n"
                        f"{'I' * m}\n")
    idx = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        idx[name] = str(wd / f"{name}.blk")
        assert cli.main(["build", "-r", idx[name], "-f", str(wd / "g.fa"),
                         "-B", "70000"]) == 0
    return wd, idx


def _argv(wd, index, tag, name):
    opts, paired, suffix = RUNS[tag]
    out = str(wd / f"{tag}.{name}{suffix}")
    argv = ["align", "-r", index, "-o", out, "-S", "kuch1", "-K", "6",
            "-b", "64",
            "-f", str(wd / ("p1.fq" if paired else "r.fq"))] + opts
    if paired:
        argv += ["-F", str(wd / "p2.fq")]
    return argv, out


@contextlib.contextmanager
def jax_locate_cap(rows: int = 4096):
    """The JAX package's device passes with an explicit locate cap of
    ``rows`` in place of its automatic one (at least 65,536 rows, which
    costs about 12 s a pass on the CPU). The reads here locate far fewer
    rows; a pass that spilled would truncate, and show as a difference."""
    start = jpipe.match_all_start

    def capped(*args, **kwargs):
        if kwargs.get("max_locate") is None:
            kwargs["max_locate"] = rows
        return start(*args, **kwargs)

    jpipe.match_all_start = capped
    try:
        yield
    finally:
        jpipe.match_all_start = start


@pytest.fixture(scope="module")
def jax_runs(workload):
    """Each run of ``RUNS`` through the JAX package's ``cli align``, once."""
    wd, idx = workload
    out = {}
    with jax_locate_cap():
        for tag in RUNS:
            argv, out[tag] = _argv(wd, idx["jax"], tag, "jax")
            assert jcli.main(argv) == 0
    return out


@pytest.mark.parametrize("starts,max_bp,want", [
    ([0, 10, 30, 35, 60], 30, [(0, 2), (2, 4)]),
    ([0, 10, 30, 35, 60], 60, [(0, 4)]),
    ([0, 10, 30, 35, 60], 40, [(0, 3), (3, 4)]),
    ([0, 10, 30, 35, 60], 20, ValueError),   # a 25 bp sequence won't fit
    ([0], 10, ValueError),                   # no sequences
])
def test_partition_sequences(starts, max_bp, want):
    starts = np.array(starts)
    if want is ValueError:
        for mod in (jblocked, tblocked):
            with pytest.raises(ValueError):
                mod.partition_sequences(starts, max_bp)
        return
    assert tblocked.partition_sequences(starts, max_bp) == want
    assert jblocked.partition_sequences(starts, max_bp) == want


def test_build_blocked_identical(workload):
    """The same top meta.json and, per block, the same arrays and meta."""
    _, idx = workload
    metas = [json.load(open(os.path.join(idx[k], "meta.json")))
             for k in ("jax", "torch")]
    assert metas[0] == metas[1]
    assert metas[0]["flavor"] == "blocked"
    assert [b["num_seqs"] for b in metas[0]["blocks"]] == [2, 2]
    assert tblocked.load_blocked_meta(idx["torch"]) == metas[0]
    for bm in metas[0]["blocks"]:
        for name in ARRAYS:
            a = np.load(os.path.join(idx["jax"], bm["dir"], name + ".npy"))
            b = np.load(os.path.join(idx["torch"], bm["dir"], name + ".npy"))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=f"{bm['dir']} {name}")
        bmetas = [json.load(open(os.path.join(idx[k], bm["dir"],
                                              "meta.json")))
                  for k in ("jax", "torch")]
        assert bmetas[0] == bmetas[1]
    # the lazily decoded global view reads the same text either way
    views = [mod.make_view(idx[k], metas[0])
             for mod, k in ((jblocked, "jax"), (tblocked, "torch"))]
    np.testing.assert_array_equal(views[0].seq_starts, views[1].seq_starts)
    assert views[0].seq_names == views[1].seq_names
    for lo, hi in ((0, 100), (29950, 30000), (60000, 60100), (119900, 120000)):
        np.testing.assert_array_equal(views[0]._decoded_text[lo:hi],
                                      views[1]._decoded_text[lo:hi])
    with pytest.raises(IndexError):
        views[1]._decoded_text[59990:60010]     # crosses the block boundary


def test_build_blocked_refuses_rlc(workload):
    wd, _ = workload
    for cli in (jcli, tcli):
        with pytest.raises(SystemExit, match="Vanilla-only"):
            cli.main(["build", "-r", str(wd / "x.blk"), "-f",
                      str(wd / "g.fa"), "-B", "70000", "--rlc"])


@pytest.mark.parametrize("tag", list(RUNS))
def test_blocked_align_identical(workload, jax_runs, tag):
    """Byte-identical records from both packages' ``cli align`` on the
    blocked index; the port's run releases each block's index and k-mer
    table before the next block loads."""
    wd, idx = workload
    argv, out = _argv(wd, idx["torch"], tag, "torch")
    alive, loaded = [], []
    from_arrays = TFMIndex.from_arrays
    kmer_cached = tkmer.build_kmer_table_cached
    iter_blocks = tblocked.iter_blocks

    def tracked_from_arrays(arrays, device):
        index = from_arrays(arrays, device)
        alive.append(weakref.ref(index))
        return index

    def tracked_kmer(index, K, cache_dir):
        table = kmer_cached(index, K, cache_dir)
        alive.append(weakref.ref(table))
        return table

    def tracked_iter(index_dir, meta):
        for item in iter_blocks(index_dir, meta):
            loaded.append(sum(r() is not None for r in alive))
            yield item
        loaded.append(sum(r() is not None for r in alive))

    TFMIndex.from_arrays = staticmethod(tracked_from_arrays)
    tkmer.build_kmer_table_cached = tracked_kmer
    tblocked.iter_blocks = tracked_iter
    try:
        assert tcli.main(argv + ["--device", "cpu"]) == 0
    finally:
        TFMIndex.from_arrays = staticmethod(from_arrays)
        tkmer.build_kmer_table_cached = kmer_cached
        tblocked.iter_blocks = iter_blocks
    # each block loaded its index and its table, and nothing of a block was
    # alive when the next one loaded, nor after the last
    assert len(alive) == 4
    assert loaded == [0, 0, 0]
    lines = {k: open(p).read().splitlines() for k, p in
             (("jax", jax_runs[tag]), ("torch", out))}
    body = {k: [ln for ln in v if not ln.startswith("@PG")]
            for k, v in lines.items()}
    assert body["jax"] == body["torch"]
    recs = [ln for ln in body["torch"] if not ln.startswith("@")]
    assert len(recs) >= (52 if RUNS[tag][1] else 48)
    if RUNS[tag][2] == ".rhs":
        hits = [ln for ln in recs if "\t" in ln]
        assert len(hits) >= 40
        assert {h.split("\t")[1][1:5] for h in hits} == {"chr0", "chr1",
                                                          "chr2", "chr3"}
    else:
        mapped = [ln.split("\t") for ln in recs if ln.split("\t")[2] != "*"]
        assert {c[2] for c in mapped} == {"chr0", "chr1", "chr2", "chr3"}


def _occ_pair(rng, n, n_reads, span):
    f = (rng.integers(0, n_reads, n), rng.integers(0, 2, n),
         rng.integers(0, span, n), None, rng.integers(0, 5, n))
    f = (f[0], f[1], f[2], f[2] + 100 + rng.integers(-2, 3, n), f[4])
    return jpipe.OccArray(*f), tpipe.OccArray(*f)


@pytest.mark.parametrize("x,cutoff", [(0, 4), (1, 4), (2, 3)])
def test_merge_best_identical(x, cutoff):
    """Occurrences of 3 blocks, their positions offset past 2^32 as a
    > 4.29 Gbp genome's are, merged to the global best(+x) stratum."""
    rng = np.random.default_rng(40 + x)
    parts_j, parts_t = [], []
    for b in range(3):
        oj, ot = _occ_pair(rng, 300, 120, 1 << 20)
        off = b * (3 << 31)                       # 0, 6.4e9, 12.9e9
        for o in (oj, ot):
            o.begin = o.begin + off
            o.end = o.end + off
        parts_j.append(oj)
        parts_t.append(ot)
    got_j = jblocked.merge_best(parts_j, x, cutoff)
    got_t = tblocked.merge_best(parts_t, x, cutoff)
    assert len(got_t) > 100
    assert int(got_t.end.max()) > 1 << 33
    for f in ("read_id", "strand", "begin", "end", "distance"):
        np.testing.assert_array_equal(getattr(got_j, f), getattr(got_t, f),
                                      err_msg=f)
    assert len(tblocked.merge_best([tpipe.OccArray.empty()], x, cutoff)) == 0


@pytest.mark.parametrize("kb", [0, 2, 4])
def test_traceback_batch_identical(kb):
    """The batched host traceback of both packages on windows around
    mutated copies of random patterns (substitutions, insertions,
    deletions, N in the read and in the text, windows shorter than the
    pattern plus kb), two read lengths."""
    rng = np.random.default_rng(60 + kb)
    patterns, windows = [], []
    for i in range(300):
        m = 40 if i % 3 else 57
        p = rng.integers(0, 4, m).astype(np.uint8)
        w = p.copy()
        for _ in range(int(rng.integers(0, kb + 1))):
            j = int(rng.integers(0, len(w)))
            op = rng.integers(0, 3) if kb else 0
            if op == 0:
                w[j] = (w[j] + 1) % 4
            elif op == 1:
                w = np.insert(w, j, rng.integers(0, 4))
            else:
                w = np.delete(w, j)
        if i % 17 == 0:
            p[int(rng.integers(0, m))] = 4
        if i % 19 == 0:
            w[int(rng.integers(0, len(w)))] = 4
        lead = rng.integers(0, 4, int(rng.integers(0, kb + 1))).astype(
            np.uint8)
        w = np.concatenate([lead, w])[-(m + kb):]
        patterns.append(p)
        windows.append(w.astype(np.uint8))
    want = jsam.traceback_batch(patterns, windows, kb)
    got = tsam.traceback_batch(patterns, windows, kb)
    assert got == want
    assert sum(1 for g in got if g[2] > 0) > (100 if kb else 0)
    assert tsam.traceback_batch([], [], kb) == []


def test_locate_hint_holds_no_index():
    """The locate-cap hint keeps no index alive, and an index that reuses a
    freed one's id() does not read the freed one's hint."""
    g = np.random.default_rng(3).integers(0, 4, 3000).astype(np.uint8)
    index = TFMIndex.from_arrays(build_index_from_codes(g), "cpu")
    tpipe._ml_hint_bump(index, 1 << 20)
    assert tpipe._ml_hint_get(index) == 1 << 20
    ref = weakref.ref(index)
    del index
    gc.collect()
    assert ref() is None
    other = TFMIndex.from_arrays(build_index_from_codes(g), "cpu")

    class Gone:
        pass

    dead = weakref.ref(Gone())              # a freed object's reference
    tpipe._ML_HINT[id(other)] = (dead, 1 << 22)
    assert tpipe._ml_hint_get(other) == 0
    tpipe._ml_hint_bump(other, 5)
    assert tpipe._ml_hint_get(other) == 5
