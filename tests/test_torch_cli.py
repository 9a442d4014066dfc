"""The port's command line against the JAX package's, and the port's
independence from JAX.

``cli build`` of both packages on one FASTA (two sequences, runs of N) must
write identical index arrays, and ``cli align -a all`` on the same FASTQ
must write byte-identical SAM records (the header differs only in the
@PG line's program name). The port aligns in two batches and the JAX
package in one: records do not depend on the batch size, and one JAX batch
halves its share of the run time. The same holds for BEST(+x) single-end
and for paired-end BEST and ALL (50 bp mates at 96 % identity, so the
cutoff is 2 and the rungs are (0,0) -> (2,2); ``-e 0`` takes the exact pass
on both sides), and for dynamic and static partitioning, scheme folders
(``-c``), scheme collections (``-d``) and the forced selection probe. The
port runs with ``--device cpu``; without it, it must
raise here, where there is no card. The static test parses every module
of the port and fails on any import of JAX or of the JAX package, and on
any call that builds a path into the JAX package.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from columba_tpu import cli as jcli
from columba_tpu_torch import cli as tcli
from columba_tpu_torch.search import strategy

torch.set_num_threads(1)

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "columba_tpu_torch")
SCHEMES = os.path.join(os.path.dirname(PORT), "schemes")
CPU = {"jax": [], "torch": ["--device", "cpu"]}
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
                         "kuch1", "-K", "6", "-b", bsize]
                        + CPU[name]) == 0
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


def test_align_reorder_is_accepted(built, pairs):
    """-R/--reorder is accepted as in the JAX package and changes nothing:
    output is always in input order."""
    wd, idx = built
    out = {}
    for tag, extra in (("plain", []), ("reorder", ["-R"]),
                       ("reorder_long", ["--reorder"])):
        out[tag] = str(wd / f"reorder.{tag}.sam")
        assert tcli.main(["align", "-r", idx["torch"], "-f", pairs[0],
                          "-o", out[tag], "-a", "all", "-e", "2", "-S",
                          "kuch1", "-K", "6", "-b", "128", "--device",
                          "cpu"] + extra) == 0
    body = {k: [ln for ln in open(v).read().splitlines()
                if not ln.startswith("@PG")] for k, v in out.items()}
    assert body["reorder"] == body["plain"] == body["reorder_long"]
    assert len(body["plain"]) > 200


@pytest.mark.parametrize("opts", [["-o", "hits.rhs"], ["-T", "0-50"]])
def test_align_refuses_modes_not_ported(built, opts):
    wd, idx = built
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcli.main(["align", "-r", idx["torch"], "-f", str(wd / "r.fq"),
                   "-o", str(wd / "x.sam"), "-a", "all", "-e", "2",
                   "--device", "cpu"] + opts)


def test_align_needs_the_card_unless_told(built):
    """Without --device cpu the align must raise where there is no usable
    CUDA device; it never falls back to the plain versions by itself."""
    wd, idx = built
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = wd / "nocard.sam"
    with pytest.raises(RuntimeError, match="no usable CUDA device"):
        tcli.main(["align", "-r", idx["torch"], "-f", str(wd / "r.fq"),
                   "-o", str(out), "-a", "all", "-e", "2", "-K", "6"])
    assert not out.exists()


@pytest.fixture(scope="module")
def pairs(built):
    """256 FR pairs of 50 bp mates (fragments of 150-300 bp, up to 3
    substitutions per mate, half with the mates swapped), among them a
    read with N, pairs at the text ends, and pairs that cannot pair."""
    wd, idx = built
    from columba_tpu.index.build import load_index, unpack_2bit

    arrays = load_index(idx["jax"])
    text = unpack_2bit(arrays.text, arrays.n)
    rng = np.random.default_rng(53)
    m, R = 50, 256
    comp = np.array([3, 2, 1, 0, 4], np.uint8)
    frag = rng.integers(150, 300, R)
    seq = rng.integers(0, 2, R)
    lo, hi = arrays.seq_starts[seq], arrays.seq_starts[seq + 1] - frag
    pos = lo + (rng.random(R) * (hi - lo)).astype(np.int64)
    pos[:2] = [0, arrays.n - frag[1]]
    r1 = text[pos[:, None] + np.arange(m)].copy()
    r2 = comp[text[(pos + frag - m)[:, None] + np.arange(m)]][:, ::-1].copy()
    for rr in (r1, r2):
        for r in rr:
            k = rng.integers(0, 4)
            r[rng.integers(0, m, k)] = rng.integers(0, 4, k)
    r1[7, 20] = 4
    flip = rng.random(R) < 0.5
    r1[flip], r2[flip] = r2[flip].copy(), r1[flip].copy()
    r2[10] = rng.integers(0, 4, m)          # mate 2 unmappable
    r1[11] = text[2000:2050]                # both exact, far apart, same
    r2[11] = text[5000:5050]                # strand: discordant only
    r1[12] = rng.integers(0, 4, m)          # both unmappable
    r2[12] = rng.integers(0, 4, m)
    lut = np.frombuffer(b"ACGTN", np.uint8)
    for name, rr in (("p1", r1), ("p2", r2)):
        with open(wd / f"{name}.fq", "w") as f:
            for i, r in enumerate(rr):
                f.write(f"@q{i}/{name[1]}\n{lut[r].tobytes().decode()}\n+\n"
                        f"{'I' * m}\n")
    return str(wd / "p1.fq"), str(wd / "p2.fq")


@pytest.mark.parametrize("tag,opts,paired", [
    ("se_best", ["-a", "best", "-I", "96"], False),
    ("se_best_x1", ["-a", "best", "-I", "96", "-x", "1", "-XA"], False),
    ("se_all_exact", ["-a", "all", "-e", "0", "--no-kmer-table"], False),
    ("pe_best", ["-a", "best", "-I", "96"], True),
    ("pe_best_x1_disc", ["-a", "best", "-I", "96", "-x", "1", "-D"], True),
    ("pe_all_e0", ["-a", "all", "-e", "0", "--no-inferring", "-X", "400"],
     True),
    ("pe_all_e1_disc", ["-a", "all", "-e", "1", "-D", "-X", "400", "-N",
                        "60"], True),
    ("se_all_dynamic", ["-a", "all", "-e", "2", "-p", "dynamic"], False),
    ("pe_best_static_c", ["-a", "best", "-I", "96", "-p", "static", "-c",
                          os.path.join(SCHEMES, "kuch_k+1")], True),
    ("se_all_static_c_nD", ["-a", "all", "-e", "2", "-p", "static", "-nD",
                            "-c", os.path.join(SCHEMES, "kuch_k+1")], False),
    ("se_best_d", ["-a", "best", "-I", "96", "-d", "@COLLECTION@"], False),
    ("se_all_probe", ["-a", "all", "-e", "2", "-S", "columba",
                      "--probe-selection", "-p", "dynamic"], False),
    ("se_best_ladder_edit", ["-a", "best", "-S", "pigeon", "-I", "86"],
     False),
])
def test_align_modes_identical_sam(built, pairs, tag, opts, paired):
    """Byte-identical SAM records from the two packages in BEST(+x) mode,
    through the exact pass, paired-end in BEST and ALL mode, and with
    dynamic and static partitioning, a scheme folder with its mirror (-c)
    and alone with its static fractions (-c -nD), a scheme collection (-d: kuch_k+1's searches twice, as the JAX package's
    own CLI test builds it), the forced probe of the columba set, and the
    edit-metric stratum ladder (pigeon at -I 86: cutoff 7 at 50 bp, above
    the single pass's 6, so every stratum goes through kernel D's generic
    radii)."""
    wd, idx = built
    if tag == "se_best_ladder_edit":
        cfg = strategy.MappingConfig(scheme_name="pigeon", metric="edit",
                                     min_identity=86)
        assert strategy.best_cutoff_for(cfg, 50) == 7
    if "@COLLECTION@" in opts:
        multi = wd / "multi"
        for k in (1, 2):
            (multi / str(k)).mkdir(parents=True, exist_ok=True)
            text = open(os.path.join(SCHEMES, "kuch_k+1", str(k),
                                     "searches.txt")).read()
            (multi / str(k) / "scheme1.txt").write_text(text)
            (multi / str(k) / "scheme2.txt").write_text(text)
        opts = [str(multi) if o == "@COLLECTION@" else o for o in opts]
    out = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        out[name] = str(wd / f"{tag}.{name}.sam")
        argv = ["align", "-r", idx[name], "-f", pairs[0], "-o", out[name],
                "-S", "kuch1", "-K", "6", "-b", "256"] + opts + CPU[name]
        if paired:
            argv += ["-F", pairs[1]]
        assert cli.main(argv) == 0
    body = {k: [ln for ln in open(v).read().splitlines()
                if not ln.startswith("@")] for k, v in out.items()}
    assert body["jax"] == body["torch"]
    n_rec = len(body["torch"])
    assert n_rec >= (512 if paired else 256)
    mapped = [ln for ln in body["torch"] if ln.split("\t")[2] != "*"]
    assert len(mapped) > (40 if "e0" in tag or "exact" in tag else 200)
    if paired:
        flags = np.array([int(ln.split("\t")[1]) for ln in body["torch"]])
        assert (flags & 2).any() and (flags & 8).any()    # proper, unpaired


def _path_into_jax_package(tree):
    """Calls that build a path with a component or prefix ``columba_tpu``:
    ``os.path.join(..., "columba_tpu", ...)``, ``Path(...)``, ``open(...)``,
    ``glob(...)`` with such a constant string argument."""
    def into(s):
        parts = s.replace("\\", "/").split("/")
        return "columba_tpu" in parts
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        fname = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
        if fname not in ("join", "Path", "PurePath", "open", "glob",
                         "listdir", "CDLL", "abspath", "realpath"):
            continue
        for arg in node.args:
            if (isinstance(arg, ast.Constant) and isinstance(arg.value, str)
                    and into(arg.value)):
                yield fname, arg.value


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
    for need in ("search/dynschedule.py", "tools/gather_bench.py",
                 "tools/profile_align.py", "native/__init__.py"):
        assert any(f.replace(os.sep, "/").endswith(need) for f in files), need
    files.append(os.path.join(os.path.dirname(PORT), "chip_smoke.py"))
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for mod in _imports(tree):
            root = mod.split(".")[0]
            if root in ("jax", "jaxlib", "columba_tpu"):
                bad.append((path, mod))
        bad += [(path, hit) for hit in _path_into_jax_package(tree)]
    assert not bad, bad
    # the check itself catches the path the port once built
    old = ast.parse('import os\nD = os.path.join(os.path.dirname(P), '
                    '"columba_tpu", "native")\n')
    assert list(_path_into_jax_package(old)) == [("join", "columba_tpu")]
    # and the port holds its own host sources
    for src in ("emit.cpp", "parse.cpp", "sais.cpp"):
        assert os.path.exists(os.path.join(PORT, "csrc", "host", src))


def test_kernel_entries_name_their_sources():
    """Each kernel entry's C function is defined in the CUDA source it names
    (the smoke's record reports that source): kernel B's RLC and textless
    entries in band_step_rlc.cu, the other entries (kernel A's loop among
    them) in their kernel's file."""
    import importlib

    from columba_tpu_torch import native
    for mod in ("ops.extend", "ops.locate", "ops.verify", "search.executor",
                "search.dynschedule", "tools.gather_bench"):
        importlib.import_module("columba_tpu_torch." + mod)
    root = os.path.dirname(PORT)
    seen = 0
    for k in native.KERNELS.values():
        for entry, (symbol, *_) in k.symbols.items():
            with open(os.path.join(root, k.source_of(entry))) as f:
                assert f"{symbol}(" in f.read(), (k.name, entry)
            seen += 1
    assert seen == 18      # 8 kernels; A's loop (Vanilla, RLC); 8 RLC
    band = native.KERNELS["band_step"]
    assert band.source_of("textless").endswith("csrc/band_step_rlc.cu")
    assert band.source_of("per_lane_rlc").endswith("csrc/band_step_rlc.cu")
    assert band.source_of("per_lane") == band.source


# ---------------------------------------------------------------------------
# RLC (b-move) and textless indexes
# ---------------------------------------------------------------------------

BM_ARRAYS = ["fused_fwd", "fused_rev", "first_row", "text", "sa_stride",
             "seq_starts", "phi_fwd", "phi_rev"]


@pytest.fixture(scope="module")
def built_rlc(built):
    """``cli build --rlc`` and ``--rlc --textless`` of both packages on the
    FASTA of ``built``."""
    wd, _ = built
    idx = {}
    for flavor, extra in (("rlc", ["--rlc"]),
                          ("textless", ["--rlc", "--textless"])):
        for name, cli in (("jax", jcli), ("torch", tcli)):
            idx[flavor, name] = str(wd / f"{name}.{flavor}.cidx")
            assert cli.main(["build", "-r", idx[flavor, name], "-f",
                             str(wd / "g.fa")] + extra) == 0
    return idx


@pytest.mark.parametrize("flavor", ["rlc", "textless"])
def test_build_rlc_identical_arrays(built_rlc, flavor):
    for name in BM_ARRAYS:
        a = np.load(os.path.join(built_rlc[flavor, "jax"], name + ".npy"))
        b = np.load(os.path.join(built_rlc[flavor, "torch"], name + ".npy"))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    metas = [json.load(open(os.path.join(built_rlc[flavor, k], "meta.json")))
             for k in ("jax", "torch")]
    assert metas[0] == metas[1]
    assert metas[0]["textless"] == (flavor == "textless")


@pytest.mark.parametrize("tag,flavor,opts,paired", [
    ("rlc_se_all", "rlc", ["-a", "all", "-e", "2"], False),
    ("rlc_se_all_aC", "rlc", ["-a", "all", "-e", "2", "-aC"], False),
    ("rlc_se_best", "rlc", ["-a", "best", "-I", "96"], False),
    ("rlc_pe_best", "rlc", ["-a", "best", "-I", "96"], True),
    ("rlc_pe_all_e0", "rlc", ["-a", "all", "-e", "0", "--no-inferring",
                              "-X", "400"], True),
    ("tl_se_all", "textless", ["-a", "all", "-e", "2"], False),
    ("tl_se_best", "textless", ["-a", "best", "-I", "96"], False),
    ("tl_se_all_e0", "textless", ["-a", "all", "-e", "0"], False),
])
def test_align_rlc_identical_sam(built_rlc, pairs, tag, flavor, opts, paired):
    """Byte-identical SAM records from the two packages on the with-text RLC
    index (SE ALL with and without CIGARs, SE BEST, PE BEST through the
    exact rung, PE ALL -e 0: the exact pass) and on the textless index (SE
    ALL, SE BEST, -e 0 through the frontier)."""
    wd = os.path.dirname(built_rlc[flavor, "jax"])
    out = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        out[name] = os.path.join(wd, f"{tag}.{name}.sam")
        argv = ["align", "-r", built_rlc[flavor, name], "-f", pairs[0],
                "-o", out[name], "-S", "kuch1", "-b", "256"] + opts + CPU[name]
        if paired:
            argv += ["-F", pairs[1]]
        assert cli.main(argv) == 0
    body = {k: [ln for ln in open(v).read().splitlines()
                if not ln.startswith("@")] for k, v in out.items()}
    assert body["jax"] == body["torch"]
    assert len(body["torch"]) >= (512 if paired else 256)
    mapped = [ln.split("\t") for ln in body["torch"]
              if ln.split("\t")[2] != "*"]
    assert len(mapped) > (40 if "e0" in tag else 200)
    cigars = {c[5] for c in mapped}
    if paired or "-aC" in opts:
        assert "*" not in cigars
    else:
        assert cigars == {"*"}        # RLC: no CIGAR unless -aC


@pytest.mark.parametrize("flavor,opts,exc", [
    ("textless", ["-F", "@P2@"], SystemExit),
    ("textless", ["-aC"], SystemExit),
    ("rlc", ["-o", "hits.rhs"], NotImplementedError),
    ("rlc", ["-T", "0-50"], NotImplementedError),
])
def test_align_rlc_refusals(built_rlc, pairs, flavor, opts, exc):
    """Textless refuses paired-end and -aC as the JAX package does; on the
    with-text RLC index read-hit-summary output and -T trim are not ported
    yet and name their ROADMAP item."""
    opts = [pairs[1] if o == "@P2@" else o for o in opts]
    wd = os.path.dirname(built_rlc[flavor, "torch"])
    with pytest.raises(exc) as err:
        tcli.main(["align", "-r", built_rlc[flavor, "torch"], "-f", pairs[0],
                   "-o", os.path.join(wd, "refused.sam"), "-a", "all", "-e",
                   "2", "--device", "cpu"] + opts)
    if exc is NotImplementedError:
        assert "ROADMAP" in str(err.value)


def test_bench_times_an_earlier_tree_through_its_wrappers(tmp_path):
    """``kernel_bench --parent`` imports the earlier tree's own kernel
    wrappers (here a copy of this tree's package) beside this tree's, puts
    this tree's modules back after, and launches through them on a copy of
    each index in the tree's own index class: on CPU tensors the wrappers
    run their plain versions, which must equal this tree's (locate, verify,
    exact match with and without lengths, dynamic partition, on both
    indexes); the bench's synthetic E and F inputs and its counts of them
    come out of this tree's plain versions too."""
    import shutil
    import sys

    from columba_tpu_torch.index import bmove
    from columba_tpu_torch.index.build import build_index_from_codes
    from columba_tpu_torch.index.fmindex import FMIndex
    from columba_tpu_torch.ops import blocate, locate, verify
    from columba_tpu_torch.search import dynschedule
    from columba_tpu_torch.search.scheme import get_scheme
    from columba_tpu_torch.tools import kernel_bench as lvb
    from columba_tpu_torch.tools import path_inputs

    shutil.copytree(PORT, tmp_path / "columba_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    mods = lvb.load_tree(str(tmp_path))
    for m in mods.values():
        assert m.__file__.startswith(str(tmp_path))
    assert sys.modules["columba_tpu_torch.ops.locate"] is locate
    assert mods["ops.locate"] is not locate

    rng = np.random.default_rng(5)
    g = np.concatenate([np.tile(rng.integers(0, 4, 400), 4),
                        rng.integers(0, 4, 400)]).astype(np.uint8)
    fm = FMIndex.from_arrays(build_index_from_codes(g), "cpu")
    bm = bmove.BMoveIndex.from_arrays(bmove.build_bmove_from_codes(g), "cpu")
    rows = torch.from_numpy(rng.integers(0, len(g) + 1, 200))
    rid = torch.from_numpy(rng.integers(0, 8, 50))
    ws = torch.from_numpy(rng.integers(-3, len(g) - 20, 50))
    reads = torch.from_numpy(rng.integers(0, 5, (8, 30)).astype(np.uint8))
    launch = lvb.tree_launcher(mods)
    assert torch.equal(launch("locate", dict(index=fm, rows=rows)),
                       locate.locate_rows_plain(fm, rows))
    assert torch.equal(launch("locate.rlc", dict(index=bm, rows=rows)),
                       blocate.locate_rows_plain(bm, rows))
    inp = dict(index=bm, reads=reads, rid=rid, ws=ws, kb=3, live=20)
    assert torch.equal(launch("verify", inp),
                       verify.verify_window_plain(bm, reads, rid, ws, 3))
    batch = torch.from_numpy(np.stack([g[s:s + 100] for s in rng.integers(
        0, len(g) - 100, 6)]).astype(np.uint8))
    batch[1, 50] = 4
    for index in (fm, bm):
        for inp in lvb.exact_part_inputs(index, batch, None):
            got = launch(inp["kind"], inp)
            assert torch.equal(got, path_inputs.plain_call(inp["kind"],
                                                           index, inp))
            counts = path_inputs.hand_counts(inp)
            assert counts["bound"]["bound_ms"] > 0
            if index is bm:
                assert 0 < counts["rounds_per_row"] < counts[
                    "lane_rounds_per_row"]
    assert torch.equal(
        launch("dynpart.rlc", dict(index=bm, reads=batch,
                                   scheme=get_scheme("kuch1", 2),
                                   table=None)),
        dynschedule.dynamic_partition_plain(bm, batch,
                                            get_scheme("kuch1", 2)))
