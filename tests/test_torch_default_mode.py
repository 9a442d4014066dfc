"""The reference's default run (BEST, ``-S columba``, ``-p dynamic``, 150
bp reads) on the port against the JAX package, and the rules that pick
kernel A's table entry and kernel B's instances there.

At 150 bp and ``-I 95`` the BEST cutoff is 7, so the stratum ladder runs
its rungs 0, 1, 3, 5 and 7: kernel B's band steps at kb 5 and 7, through
the per-lane entry under ``-p dynamic`` and the RLC entry on the b-move
index. Both CLI cases require byte-identical SAM records from the two
packages' ``cli align`` on one FASTA (the with-text RLC setup of
``test_torch_rlc_select.py``: near-identical haplotypes, so the lanes stay
wide and reach the band steps) and record the band steps the port took.
The port runs its plain versions here; the kernels' own cases are in
``test_torch_kernels.py`` (marker ``cuda``).
"""

import numpy as np
import pytest
import torch

from columba_tpu import cli as jcli
from columba_tpu.index import kmer as jkmer
from columba_tpu.index.fmindex import FMIndex as JFMIndex
from columba_tpu.search import pipeline as jpipe
from columba_tpu_torch import cli as tcli
from columba_tpu_torch.index import kmer as tkmer
from columba_tpu_torch.index.build import build_index_from_codes
from columba_tpu_torch.index.fmindex import FMIndex
from columba_tpu_torch.search import executor

torch.set_num_threads(1)

M = 150                      # Columba's reproduction read length


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Five near-identical haplotypes of a 3 kbp base and a random tail,
    its Vanilla and RLC indexes from both packages' ``cli build``, and 27
    reads of 150 bp with 0-8 substitutions (the ladder's deep rungs get
    the reads with 5 or more), half reverse-complemented."""
    wd = tmp_path_factory.mktemp("default_mode")
    rng = np.random.default_rng(181)
    base = rng.integers(0, 4, 3000).astype(np.uint8)
    haps = [base]
    for _ in range(4):
        h = base.copy()
        snp = rng.random(len(h)) < 0.005
        h[snp] = (h[snp] + rng.integers(1, 4, int(snp.sum()))) % 4
        haps.append(h)
    g = np.concatenate(haps + [rng.integers(0, 4, 2000).astype(np.uint8)])
    lut = np.frombuffer(b"ACGTN", np.uint8)
    txt = lut[g].tobytes().decode()
    with open(wd / "g.fa", "w") as f:
        f.write(">pan\n" + "\n".join(txt[j:j + 70]
                                     for j in range(0, len(txt), 70)) + "\n")
    idx = {}
    for flavor, extra in (("vanilla", []), ("rlc", ["--rlc"])):
        for name, cli in (("jax", jcli), ("torch", tcli)):
            idx[flavor, name] = str(wd / f"{name}.{flavor}.cidx")
            assert cli.main(["build", "-r", idx[flavor, name], "-f",
                             str(wd / "g.fa")] + extra) == 0
    R = 27
    starts = rng.integers(0, len(g) - M, R)
    reads = g[starts[:, None] + np.arange(M)].copy()
    for i, r in enumerate(reads):
        k = i % 9
        at = rng.choice(M, k, replace=False)
        r[at] = (r[at] + rng.integers(1, 4, k)) % 4
    comp = np.array([3, 2, 1, 0], np.uint8)
    flip = rng.random(R) < 0.5
    reads[flip] = comp[reads[flip]][:, ::-1]
    with open(wd / "r.fq", "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@q{i}\n{lut[r].tobytes().decode()}\n+\n{'I' * M}\n")
    return dict(wd=wd, idx=idx, fq=str(wd / "r.fq"), g=g)


def _band_steps(monkeypatch):
    """Records (entry, kb) of every band step the port takes."""
    seen = set()
    step = executor.band_step_compact_plain

    def recorded(index, state, *a, **kw):
        dyn = a[10] if len(a) > 10 else kw.get("dyn_meta")
        per_lane = dyn is not None
        rlc = not isinstance(index, FMIndex)
        seen.add(((("per_lane_rlc" if per_lane else "rlc") if rlc else
                   ("per_lane" if per_lane else "static")),
                  (state[2].shape[-1] - 1) // 2))
        return step(index, state, *a, **kw)

    monkeypatch.setattr(executor, "band_step_compact_plain", recorded)
    return seen


@pytest.fixture
def jax_locate_cap(monkeypatch):
    """The JAX package's device passes with a locate cap of 4,096 rows in
    place of its automatic one (at least 65,536 rows, about 12 s a pass on
    the CPU; ``test_torch_blocked.jax_locate_cap``). These reads locate far
    fewer rows; a pass that spilled would truncate and show as a
    difference."""
    start = jpipe.match_all_start

    def capped(*args, **kwargs):
        if kwargs.get("max_locate") is None:
            kwargs["max_locate"] = 4096
        return start(*args, **kwargs)

    monkeypatch.setattr(jpipe, "match_all_start", capped)


def _align(cli, world, flavor, name, tag, opts):
    out = str(world["wd"] / f"{tag}.{name}.sam")
    argv = ["align", "-r", world["idx"][flavor, name], "-f", world["fq"],
            "-o", out, "-a", "best", "-S", "columba", "-b", "256", *opts]
    if name == "torch":
        argv += ["--device", "cpu"]
    assert cli.main(argv) == 0
    return [ln for ln in open(out).read().splitlines()
            if not ln.startswith("@")]


@pytest.mark.parametrize("flavor,opts,entry", [
    ("vanilla", ["-p", "dynamic", "--no-kmer-table"], "per_lane"),
    ("rlc", [], "rlc"),
])
def test_default_run_identical_sam(world, monkeypatch, jax_locate_cap,
                                   flavor, opts, entry):
    """``align -a best -S columba`` on 150 bp reads, ``-p dynamic`` on the
    Vanilla index and the default (uniform) partitioning on the b-move
    index: byte-identical SAM records from both packages, and the port's
    band steps at kb 5 and 7 through the entry the card takes (kernel B's
    per-lane entry, its RLC entry).

    With a seed table, ``-p dynamic`` reaches the ladder's exact rung as a
    one-part scheme, whose dynamic partition the JAX package cannot place
    (``columba_tpu/search/dynschedule.py:314`` raises); the port takes
    that rung's only partition, the uniform one, and reports the same
    records as without the table."""
    seen = _band_steps(monkeypatch)
    body = _align(jcli, world, flavor, "jax", flavor, opts)
    assert _align(tcli, world, flavor, "torch", flavor, opts) == body
    mapped = [ln for ln in body if ln.split("\t")[2] != "*"]
    assert len(mapped) >= 24
    assert {(entry, 5), (entry, 7)} <= seen
    if flavor == "vanilla":
        table = ["-p", "dynamic", "-K", "6"]
        assert _align(tcli, world, flavor, "torch", "table", table) == body
        with pytest.raises(ValueError, match="broadcast"):
            _align(jcli, world, flavor, "jax", "table", table)


def test_band_shape_names_the_instance_taken():
    """``executor.band_shape`` names a launch templated, quad or generic by
    the rule of ``csrc/band_step.cuh`` (``launch_static``,
    ``launch_per_lane``): every entry templated at kb 0..7 with one or two
    registers (the per-lane entries take one); the Vanilla static and
    per-lane entries through the quad body at kb 8..13 with the registers
    the shipped schemes' schedules give there at 160..270 bp (kb 8: W 1-2;
    9 and 10: 1-3; 11: 1 and 3; 12 and 13: 1, 3 and 4) and any fewer;
    generic above, in the RLC and textless entries past kb 7, and wherever
    ``generic`` forces it."""
    listed = {8: (1, 2), 9: (1, 2, 3), 10: (1, 2, 3), 11: (1, 3),
              12: (1, 3, 4), 13: (1, 3, 4)}
    for entry, name in (("", "static"), ("per_lane", "per_lane"),
                        ("rlc", "rlc"), ("textless", "textless"),
                        ("per_lane_rlc", "per_lane_rlc")):
        for W in ((1,) if entry.startswith("per_lane") else range(1, 6)):
            for kb in range(4, 14):
                quad = (name in ("static", "per_lane") and kb in listed
                        and W <= max(listed[kb]))
                inst = ("templated" if kb <= 7 and W <= 2 else
                        "quad" if quad else "generic")
                assert executor.band_shape(entry, kb, W) == \
                    f"{name} kb{kb} W{W} {inst}"
                assert executor.band_shape(entry, kb, W, True) == \
                    f"{name} kb{kb} W{W} generic"
    for kb, ws in listed.items():
        for W in ws:
            assert executor.band_shape("", kb, W).endswith(" quad")
        assert executor.band_shape("per_lane", kb, 1).endswith(" quad")


def test_kmer_table_plain_equals_jax(world):
    """``build_kmer_table_plain`` (the K-step build, kernel A's table
    entry's plain version) and ``build_kmer_table`` on a CPU index equal
    the JAX package's table at K = 5, empty ranges (which keep stepping)
    included."""
    from columba_tpu.index.build import build_index_from_codes as jbuild

    g = world["g"]
    want = np.asarray(jkmer.build_kmer_table(
        JFMIndex.from_arrays(jbuild(g)), 5)).astype(np.int64) & 0xFFFFFFFF
    index = FMIndex.from_arrays(build_index_from_codes(g), "cpu")
    for fn in (tkmer.build_kmer_table_plain, tkmer.build_kmer_table):
        got = fn(index, 5)
        assert got.shape == (4 ** 5, 4)
        np.testing.assert_array_equal(got.numpy(), want)
    empty = want[:, 1] <= want[:, 0]
    assert empty.any() and (want[empty] != 0).any()
