"""The port's command line against the JAX package's, and the port's
independence from JAX.

``cli build`` of both packages on one FASTA (two sequences, runs of N) must
write identical index arrays, and ``cli align -a all`` on the same FASTQ
must write byte-identical SAM records (the header differs only in the
@PG line's program name). The port aligns in two batches and the JAX
package in one: records do not depend on the batch size, and one JAX batch
halves its share of the run time. The static test parses every module of
the port and fails on any import of JAX or of the JAX package.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from columba_tpu import cli as jcli
from columba_tpu_torch import cli as tcli

torch.set_num_threads(1)

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "columba_tpu_torch")
ARRAYS = ["text", "bwt", "rbwt", "occ", "rocc", "counts", "sa_samples",
          "sa_bits", "sa_bits_rank", "seq_starts"]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    wd = tmp_path_factory.mktemp("torchcli")
    rng = np.random.default_rng(51)
    seqs = [rng.integers(0, 4, 9000), rng.integers(0, 4, 7000)]
    seqs[0][3000:3040] = 4                 # runs of N
    seqs[1][100:103] = 4
    lut = np.frombuffer(b"ACGTN", np.uint8)
    with open(wd / "g.fa", "w") as f:
        for i, s in enumerate(seqs):
            txt = lut[s].tobytes().decode()
            f.write(f">s{i} desc\n" + "\n".join(
                txt[j:j + 70] for j in range(0, len(txt), 70)) + "\n")
    idx = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        idx[name] = str(wd / f"{name}.cidx")
        assert cli.main(["build", "-r", idx[name], "-f", str(wd / "g.fa")]) \
            == 0
    return wd, idx


def test_build_identical_arrays(built):
    _, idx = built
    for name in ARRAYS:
        a = np.load(os.path.join(idx["jax"], name + ".npy"))
        b = np.load(os.path.join(idx["torch"], name + ".npy"))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    metas = [json.load(open(os.path.join(idx[k], "meta.json")))
             for k in ("jax", "torch")]
    assert metas[0] == metas[1]


def test_align_identical_sam(built):
    wd, idx = built
    from columba_tpu.index.build import load_index, unpack_2bit

    arrays = load_index(idx["jax"])
    text = unpack_2bit(arrays.text, arrays.n)
    rng = np.random.default_rng(52)
    m, R = 100, 200
    starts = rng.integers(0, arrays.n - m, R)
    starts[:3] = [0, arrays.n - m, 9000 - 50]          # ends, a boundary
    reads = text[starts[:, None] + np.arange(m)].copy()
    for r in reads:
        k = rng.integers(0, 4)
        r[rng.integers(0, m, k)] = rng.integers(0, 4, k)
    reads[7, 20] = 4
    comp = np.array([3, 2, 1, 0, 4], np.uint8)
    flip = rng.random(R) < 0.5
    reads[flip] = comp[reads[flip]][:, ::-1]
    lut = np.frombuffer(b"ACGTN", np.uint8)
    with open(wd / "r.fq", "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@q{i}\n{lut[r].tobytes().decode()}\n+\n{'I' * m}\n")
    out = {}
    for name, cli, bsize in (("jax", jcli, "256"), ("torch", tcli, "128")):
        out[name] = str(wd / f"{name}.sam")
        assert cli.main(["align", "-r", idx[name], "-f", str(wd / "r.fq"),
                         "-o", out[name], "-a", "all", "-e", "2", "-S",
                         "kuch1", "-K", "6", "-b", bsize]) == 0
    lines = {k: open(v).read().splitlines() for k, v in out.items()}
    body = {k: [ln for ln in v if not ln.startswith("@")]
            for k, v in lines.items()}
    assert body["jax"] == body["torch"]
    assert len(body["jax"]) >= R
    head = {k: [ln for ln in v if ln.startswith("@") and
                not ln.startswith("@PG")] for k, v in lines.items()}
    assert head["jax"] == head["torch"]
    pg = {k: [ln for ln in v if ln.startswith("@PG")][0].split("\t")
          for k, v in lines.items()}
    assert [c for c in pg["jax"] if not c.startswith(("ID:", "PN:"))] == \
        [c for c in pg["torch"] if not c.startswith(("ID:", "PN:"))]


def test_align_refuses_modes_not_ported(built):
    wd, idx = built
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcli.main(["align", "-r", idx["torch"], "-f", str(wd / "r.fq"),
                   "-o", str(wd / "x.sam"), "-a", "best"])


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_port_imports_no_jax():
    files = []
    for d, dirs, fs in os.walk(PORT):
        dirs[:] = [x for x in dirs if x != "_build"]   # build output only
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert len(files) >= 20
    bad = []
    for path in files:
        with open(path) as f:
            for mod in _imports(ast.parse(f.read(), path)):
                root = mod.split(".")[0]
                if root in ("jax", "jaxlib", "columba_tpu"):
                    bad.append((path, mod))
    assert not bad, bad
