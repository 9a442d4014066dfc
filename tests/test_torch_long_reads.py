"""The reference's default run on long reads: ``align -a best -S columba``
on 200 bp reads, the port against the JAX package.

At 200 bp and ``-I 95`` the BEST cutoff is 10, so the stratum ladder runs
its rungs 0, 1, 3, 5, 9 and 10, and the band steps run at kb 9 (the
columba scheme at 200 bp: two colMin registers) and kb 10 (three). On the
card those take kernel B's quad body (``csrc/band_step_wide.cuh``); here
the port runs its plain versions, and the kernels' own cases are in
``test_torch_kernels.py`` (marker ``cuda``). The genome is
``test_torch_default_mode.py``'s kind (near-identical haplotypes, so lanes
stay wide and reach the band steps); two random reads map nowhere and walk
every rung. The JAX package's run is compile-bound (a compile a rung), so
the file keeps to 200 bp; the card's paths run 250 bp reads
(``chip_smoke.py``, ``col250_se_best``).
"""

import numpy as np
import pytest
import torch

from columba_tpu import cli as jcli
from columba_tpu_torch import cli as tcli
from tests.test_torch_default_mode import _band_steps, jax_locate_cap  # noqa: F401

torch.set_num_threads(1)

M = 200
CUT = 10                     # the BEST cutoff at 200 bp and -I 95


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Five near-identical haplotypes of a 3 kbp base and a random tail,
    the Vanilla index of both packages' ``cli build``, and 24 reads of
    200 bp: 22 with 0-10 substitutions and two random ones, half
    reverse-complemented."""
    wd = tmp_path_factory.mktemp("long_reads")
    rng = np.random.default_rng(250)
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
    for name, cli in (("jax", jcli), ("torch", tcli)):
        idx[name] = str(wd / f"{name}.cidx")
        assert cli.main(["build", "-r", idx[name], "-f",
                         str(wd / "g.fa")]) == 0
    R = 22
    starts = rng.integers(0, len(g) - M, R)
    reads = g[starts[:, None] + np.arange(M)].copy()
    nsub = np.arange(R) % (CUT + 1)
    for r, k in zip(reads, nsub):
        at = rng.choice(M, k, replace=False)
        r[at] = (r[at] + rng.integers(1, 4, k)) % 4
    reads = np.concatenate([reads, rng.integers(0, 4, (2, M)).astype(
        np.uint8)])
    comp = np.array([3, 2, 1, 0], np.uint8)
    flip = rng.random(len(reads)) < 0.5
    reads[flip] = comp[reads[flip]][:, ::-1]
    with open(wd / "r.fq", "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@q{i}\n{lut[r].tobytes().decode()}\n+\n{'I' * M}\n")
    return dict(wd=wd, idx=idx, fq=str(wd / "r.fq"))


def _align(cli, world, name, tag, opts=()):
    out = str(world["wd"] / f"{tag}.{name}.sam")
    argv = ["align", "-r", world["idx"][name], "-f", world["fq"], "-o", out,
            "-a", "best", "-S", "columba", "-b", "256", "-K", "6", *opts]
    if name == "torch":
        argv += ["--device", "cpu"]
    assert cli.main(argv) == 0
    return [ln for ln in open(out).read().splitlines()
            if not ln.startswith("@")]


def test_long_reads_identical_sam(world, monkeypatch, jax_locate_cap):
    """``align -a best -S columba -K 6`` on 200 bp reads (cutoff 10; a
    6-mer seed table, as the port's plain 10-mer build is slow on the
    CPU): byte-identical SAM records from both packages, every read
    with a substitution count within the cutoff mapped, and the port's band
    steps at kb 9 and 10 in the static entry. Then the port's ``-p
    dynamic`` twin: the same records, sorted; its band steps at kb 9 in the
    per-lane entry, and at kb 10 in the static one: per-read schedules need
    every part >= 2kb + 1, and 11 parts of 21 do not fit in 200 bp, so that
    rung takes the uniform partition (``pipeline.match_all_start``). The
    JAX package has no such twin with a seed table: its dynamic partition
    raises at the ladder's exact rung
    (``columba_tpu/search/dynschedule.py:314``)."""
    seen = _band_steps(monkeypatch)
    body = _align(jcli, world, "jax", "uniform")
    assert _align(tcli, world, "torch", "uniform") == body
    mapped = {ln.split("\t")[0] for ln in body if ln.split("\t")[2] != "*"}
    assert {f"q{i}" for i in range(22)} <= mapped
    assert {("static", 9), ("static", 10)} <= seen
    seen.clear()
    dyn = _align(tcli, world, "torch", "dynamic", ["-p", "dynamic"])
    assert sorted(dyn) == sorted(body)
    assert {("per_lane", 9), ("static", 10)} <= seen
    assert ("per_lane", 10) not in seen


def test_quad_shapes_within_the_instances():
    """``tools/quad_shapes.py`` at 250 bp and kb 9: the shipped schemes
    give W 1 (``naive``) and W 2 (the columba scheme among them), both
    within ``executor.QUAD_MAX_W``, so kernel B's quad body takes every
    such step (``band_shape`` names it)."""
    from columba_tpu_torch.search import executor
    from columba_tpu_torch.tools import quad_shapes

    found = quad_shapes.shapes(range(250, 251), kbs=(9,))
    assert set(found) == {(9, 1), (9, 2)}
    assert "columba" in {w[0] for w in found[(9, 2)]}
    for kb, W in found:
        assert W <= executor.QUAD_MAX_W[kb]
        assert executor.band_shape("", kb, W) == f"static kb{kb} W{W} quad"


def test_ptxas_report_names_the_quad_body():
    """``native.ptxas_report`` names the quad body's instances by radius,
    registers and per-lane flag, and keeps a stack frame in its line, as
    ``chip_smoke.py``'s build check reads them."""
    from columba_tpu_torch import native

    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_Z21band_step_quad_kernelILi12ELi3ELb0EEvN12columba_band8BandArgsE'"
        " for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_Z21band_step_quad_kernelILi12ELi3ELb0EEvN12columba_band8BandArgsE",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 117 registers",
        "ptxas info    : Compiling entry function "
        "'_Z21band_step_quad_kernelILi9ELi1ELb1EEvN12columba_band8BandArgsE'"
        " for 'sm_90a'",
        "    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers"])
    assert native.ptxas_report(log) == [
        "band_step_quad_kernel<12, 3, 0>: 117 registers, no spills",
        "band_step_quad_kernel<9, 1, 1>: 96 registers; 16 bytes stack "
        "frame, 0 bytes spill stores, 0 bytes spill loads"]
