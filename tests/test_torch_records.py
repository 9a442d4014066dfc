"""The port's record path against the JAX package's, and against its own
native path.

The record path parses FASTQ or FASTA records in Python, trims them with
``-T``, and emits through the Python emitters (``strategy.emit_sam``,
``emit_sam_textless``, ``emit_rhs``, ``paired.emit_sam_paired``). On a
genome of two sequences with runs of N (``build`` and ``build --rlc`` and
``--rlc --textless`` of the port; the JAX package reads the same
directories), ``-T 0-50`` in BEST mode and ``-T 0-50`` to a
read-hit-summary file (``.rhs``) in ALL mode must give byte-identical
output from both packages' ``cli align`` on the Vanilla, RLC and textless
indexes (each JAX run once, in a module fixture, with the locate cap of
``test_torch_blocked.jax_locate_cap``; 50 bp at 95 % identity makes the
BEST cutoff 2, so both runs of a flavor share the JAX package's compiled
shapes). FASTA reads, single-end and paired-end, must give the
records of the port's FASTQ run of the same reads (the FASTQ qualities
are all ``I``, as the FASTA parser's are), and the Python emitters, with
the native emitter (and for one case the native parser) patched away in
process, the records of the native run.
"""

import numpy as np
import pytest
import torch

from columba_tpu import cli as jcli
from columba_tpu_torch import cli as tcli
from columba_tpu_torch.io import emit, fastq
from tests.test_torch_blocked import jax_locate_cap

torch.set_num_threads(1)

LUT = np.frombuffer(b"ACGTN", np.uint8)
COMP = np.array([3, 2, 1, 0, 4], np.uint8)
M_SE, R_SE = 100, 96
M_PE, R_PE = 50, 64
# tag -> (align options, output suffix); each on every flavor
JAX_RUNS = {
    "trim_best": (["-a", "best", "-T", "0-50"], ".sam"),
    "trim_rhs": (["-a", "all", "-e", "2", "-T", "0-50"], ".rhs"),
}
FLAVORS = {"vanilla": [], "rlc": ["--rlc"], "textless": ["--rlc",
                                                          "--textless"]}


def _write(path, names, reads, fasta=False):
    with open(path, "w") as f:
        for name, r in zip(names, reads):
            seq = LUT[r].tobytes().decode()
            if fasta:
                # wrapped, as FASTA often is
                f.write(f">{name} sampled\n" + "\n".join(
                    seq[j:j + 60] for j in range(0, len(seq), 60)) + "\n")
            else:
                f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Genome, the three index flavors, and the reads and pairs as FASTQ
    and as FASTA."""
    wd = tmp_path_factory.mktemp("trec")
    rng = np.random.default_rng(71)
    seqs = [rng.integers(0, 4, 9000), rng.integers(0, 4, 7000)]
    seqs[0][3000:3040] = 4                 # runs of N
    seqs[1][100:103] = 4
    with open(wd / "g.fa", "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">s{i}\n{LUT[s].tobytes().decode()}\n")
    idx = {}
    for flavor, extra in FLAVORS.items():
        idx[flavor] = str(wd / f"{flavor}.cidx")
        assert tcli.main(["build", "-r", idx[flavor], "-f", str(wd / "g.fa")]
                         + extra) == 0
    text = np.concatenate(seqs)
    text = np.where(text > 3, 0, text).astype(np.uint8)   # N -> seeded base
    n = len(text)
    # single-end: substitutions, a read with N, reads at both text ends and
    # across the sequence boundary, half reverse-complemented
    starts = rng.integers(0, n - M_SE, R_SE)
    starts[:3] = [0, n - M_SE, 9000 - 50]
    reads = text[starts[:, None] + np.arange(M_SE)].copy()
    for r in reads:
        k = rng.integers(0, 4)
        r[rng.integers(0, M_SE, k)] = rng.integers(0, 4, k)
    reads[5, 20] = 4
    flip = rng.random(R_SE) < 0.5
    reads[flip] = COMP[reads[flip]][:, ::-1]
    names = [f"q{i}" for i in range(R_SE)]
    _write(wd / "r.fq", names, reads)
    _write(wd / "r.fa", names, reads, fasta=True)
    # paired-end: fr pairs of 50 bp mates, fragments 150-300, half swapped,
    # one mate unmappable, one pair discordant
    frag = rng.integers(150, 300, R_PE)
    pos = rng.integers(0, n - 300, R_PE)
    r1 = text[pos[:, None] + np.arange(M_PE)].copy()
    r2 = COMP[text[(pos + frag - M_PE)[:, None] + np.arange(M_PE)]][:, ::-1]
    r2 = r2.copy()
    for rr in (r1, r2):
        for r in rr:
            k = rng.integers(0, 3)
            r[rng.integers(0, M_PE, k)] = rng.integers(0, 4, k)
    swap = rng.random(R_PE) < 0.5
    r1[swap], r2[swap] = r2[swap].copy(), r1[swap].copy()
    r2[3] = rng.integers(0, 4, M_PE)
    r1[4], r2[4] = text[2000:2050], text[5000:5050]
    for mate, rr in (("1", r1), ("2", r2)):
        pnames = [f"p{i}/{mate}" for i in range(R_PE)]
        _write(wd / f"p{mate}.fq", pnames, rr)
        _write(wd / f"p{mate}.fa", pnames, rr, fasta=True)
    return wd, idx


SE_READS = {"fq": ("r.fq",), "fa": ("r.fa",)}
PE_READS = {"fq": ("p1.fq", "p2.fq"), "fa": ("p1.fa", "p2.fa")}


def _align(cli, wd, index, out, opts, reads=("r.fq",), device=True):
    argv = ["align", "-r", index, "-o", str(wd / out), "-S", "kuch1", "-K",
            "6", "-b", "128", "-f", str(wd / reads[0])] + opts
    if len(reads) > 1:
        argv += ["-F", str(wd / reads[1])]
    if device:
        argv += ["--device", "cpu"]
    assert cli.main(argv) == 0
    return [ln for ln in open(wd / out).read().splitlines()
            if not ln.startswith("@PG")]


@pytest.fixture(scope="module")
def jax_runs(data):
    """Each JAX_RUNS entry on each flavor through the JAX package's ``cli
    align``, once."""
    wd, idx = data
    with jax_locate_cap():
        return {(flavor, tag): _align(jcli, wd, idx[flavor],
                                      f"jax.{flavor}.{tag}{suffix}", opts,
                                      device=False)
                for flavor in FLAVORS
                for tag, (opts, suffix) in JAX_RUNS.items()}


@pytest.fixture(scope="module")
def fastq_run(data):
    """The port's run of the FASTQ reads (native parser and emitter where
    the record path does not take them), once per (flavor, options,
    paired)."""
    wd, idx = data
    done = {}

    def run(flavor, opts, paired):
        key = (flavor, tuple(opts), paired)
        if key not in done:
            done[key] = _align(tcli, wd, idx[flavor],
                               f"fastq.{len(done)}.sam", opts,
                               (PE_READS if paired else SE_READS)["fq"])
        return done[key]
    return run


@pytest.mark.parametrize("flavor", list(FLAVORS))
@pytest.mark.parametrize("tag", list(JAX_RUNS))
def test_record_path_identical(data, jax_runs, flavor, tag):
    """``-T 0-50`` to SAM in BEST mode and to ``.rhs`` in ALL mode:
    byte-identical output from both packages on each index flavor."""
    wd, idx = data
    opts, suffix = JAX_RUNS[tag]
    got = _align(tcli, wd, idx[flavor], f"torch.{flavor}.{tag}{suffix}",
                 opts)
    assert got == jax_runs[flavor, tag]
    body = [ln for ln in got if not ln.startswith("@")]
    assert len(body) >= R_SE
    if suffix == ".rhs":
        assert sum("\t" in ln for ln in body) > R_SE // 2
    else:
        cols = [ln.split("\t") for ln in body if ln.split("\t")[2] != "*"]
        assert len(cols) > R_SE // 2
        assert {len(c[9]) for c in cols} == {50}          # trimmed
        cigars = {c[5] for c in cols}
        assert (cigars == {"*"}) == (flavor != "vanilla")


@pytest.mark.parametrize("flavor,opts,paired", [
    ("vanilla", ["-a", "all", "-e", "2"], False),
    ("vanilla", ["-a", "best", "-XA"], False),
    ("rlc", ["-a", "all", "-e", "2", "-aC"], False),
    ("textless", ["-a", "best"], False),
    ("vanilla", ["-a", "best", "-I", "96"], True),
    ("vanilla", ["-a", "all", "-e", "1", "-D", "-X", "400"], True),
], ids=["se_all", "se_best_xa", "rlc_se_all_aC", "tl_se_best", "pe_best",
        "pe_all_disc"])
def test_fasta_reads_as_fastq(data, fastq_run, flavor, opts, paired):
    """FASTA reads (wrapped lines, descriptions after the name) give the
    records of the same reads as FASTQ."""
    wd, idx = data
    tag = f"{flavor}.{'pe' if paired else 'se'}.{len(opts)}"
    fasta = _align(tcli, wd, idx[flavor], f"fasta.{tag}.sam", opts,
                   (PE_READS if paired else SE_READS)["fa"])
    assert fasta == fastq_run(flavor, opts, paired)
    n_rec = sum(not ln.startswith("@") for ln in fasta)
    assert n_rec >= (2 * R_PE if paired else R_SE)


@pytest.mark.parametrize("opts,paired,no_parser", [
    (["-a", "all", "-e", "2"], False, False),
    (["-a", "best", "-x", "1", "-XA", "-nU"], False, False),
    (["-a", "best", "-I", "96"], True, False),
    (["-a", "all", "-e", "1", "-D", "-X", "400"], True, False),
    (["-a", "best", "-I", "96", "-x", "1"], True, True),
], ids=["se_all", "se_best_x1_xa_nu", "pe_best", "pe_all_disc",
        "pe_best_x1_no_parser"])
def test_python_emitters_as_native(data, fastq_run, monkeypatch, opts,
                                   paired, no_parser):
    """With the native emitter missing (and, in one case, the native
    parser too), single-end runs take the record path and paired-end runs
    ``paired.emit_sam_paired`` (on record-parsed chunks without the parser):
    the same records as the native run."""
    wd, idx = data
    tag = f"{'pe' if paired else 'se'}.{len(opts)}.{int(no_parser)}"
    native = fastq_run("vanilla", opts, paired)
    monkeypatch.setattr(emit, "available", lambda: False)
    monkeypatch.setattr(emit, "pe_available", lambda: False)
    if no_parser:
        monkeypatch.setattr(fastq, "native_reader_available", lambda: False)
    python = _align(tcli, wd, idx["vanilla"], f"emit.{tag}.sam", opts,
                    (PE_READS if paired else SE_READS)["fq"])
    assert python == native
    assert sum(not ln.startswith("@") for ln in python) >= (
        2 * R_PE if paired else R_SE // 2)
