"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips elsewhere. The file imports
neither JAX nor the test conftest's helpers, so on a machine without JAX it
runs with ``python -m pytest --noconftest -o addopts="" -m cuda
tests/test_torch_kernels.py``. All kernel arithmetic is integer: each
kernel must equal its plain version exactly.
"""

import numpy as np
import pytest
import torch

from columba_tpu_torch.core import alphabet
from columba_tpu_torch.index import kmer
from columba_tpu_torch.index.build import build_index_from_codes
from columba_tpu_torch.index.fmindex import FMIndex
from columba_tpu_torch.ops import extend, locate, verify
from columba_tpu_torch.search import executor, pipeline
from columba_tpu_torch.search.scheme import get_scheme

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def setup(gpu):
    rng = np.random.default_rng(5)
    g = rng.integers(0, 4, 50000).astype(np.uint8)
    g[20000:22000] = g[30000:32000]           # a repeat keeps ranges wide
    arrays = build_index_from_codes(g, sa_sparseness=4)
    return g, FMIndex.from_arrays(arrays), FMIndex.from_arrays(arrays, gpu)


def _ranges(rng, n, L):
    lo = rng.integers(0, n + 2, L)
    hi = np.minimum(lo + rng.integers(0, 64, L), n + 1)
    rlo = rng.integers(0, n + 2, L)
    rhi = np.minimum(rlo + (hi - lo), n + 1)
    hi = lo + (rhi - rlo)
    return torch.from_numpy(np.stack([lo, hi, rlo, rhi], 1).astype(np.int64))


def test_extend_kernel(setup, gpu):
    g, cpu_fm, fm = setup
    rng = np.random.default_rng(1)
    L = 10000
    r = _ranges(rng, cpu_fm.n, L).to(gpu)
    dirs = torch.from_numpy(rng.integers(0, 2, L).astype(np.int32)).to(gpu)
    chars = torch.from_numpy(rng.integers(-1, 5, L).astype(np.int32)).to(gpu)
    got = extend.extend_all(fm, r, dirs)
    assert torch.equal(got, extend.extend_all_plain(fm, r, dirs))
    got = extend.extend_char(fm, r, chars, dirs)
    assert torch.equal(got, extend.extend_char_plain(fm, r, chars, dirs))
    assert torch.equal(kmer.build_kmer_table(fm, 6).cpu(),
                       kmer.build_kmer_table(cpu_fm, 6))


def test_locate_kernel(setup, gpu):
    _, cpu_fm, fm = setup
    rows = torch.arange(cpu_fm.n + 1, dtype=torch.int64, device=gpu)
    got = locate.locate_rows(fm, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, locate.locate_rows_plain(fm, rows))


@pytest.mark.parametrize("kb", [1, 2])
def test_verify_kernel(setup, gpu, kb):
    g, cpu_fm, fm = setup
    rng = np.random.default_rng(2 + kb)
    n, m, B = cpu_fm.n, 100, 4096
    starts = rng.integers(-kb, n - m, B)
    starts[:8] = np.arange(-kb, 8 - kb)
    starts[8:16] = n - m + rng.integers(-3, 10, 8)
    reads = g[np.clip(starts[:64, None] + kb + np.arange(m), 0, n - 1)]
    reads[::7, 50] = 4
    pats = torch.from_numpy(np.ascontiguousarray(reads)).to(gpu)
    rid = torch.from_numpy(rng.integers(0, 64, B)).to(gpu)
    ws = torch.from_numpy(starts.astype(np.int64)).to(gpu)
    got = verify.verify_window(fm, pats, rid, ws, kb)
    assert torch.equal(got, verify.verify_window_plain(fm, pats, rid, ws, kb))


@pytest.mark.parametrize("t", [0, 20, 40])
def test_band_step_kernel(setup, gpu, t):
    """Kernel B on random lane states (ghosts, dead lanes, saturated
    cells) equals its plain version on every output."""
    _, cpu_fm, fm = setup
    rng = np.random.default_rng(11 + t)
    sched = pipeline.compile_cached(get_scheme("kuch1", 2), 100, "edit",
                                    kmer_k=6)
    tables = executor.device_tables(sched, gpu)
    C, R, S, T, bw = 4096, 192, sched.num_searches, sched.t_max, sched.bw
    ranges = _ranges(rng, cpu_fm.n, C).to(gpu)
    ids = rng.integers(0, R * S, C).astype(np.int64)
    ghost = rng.random(C) < 0.1
    ids = np.where(ghost, ids | (rng.integers(0, 1024, C) << 21) | (1 << 31),
                   ids).astype(np.uint32).view(np.int32)
    args = (
        fm, ranges, torch.from_numpy(ids).to(gpu),
        torch.from_numpy(rng.integers(0, 64, (C, 2, bw)).astype(np.int8)
                         ).to(gpu),
        torch.from_numpy(rng.integers(0, 64, (C, 2, sched.W)).astype(np.int8)
                         ).to(gpu),
        tables["mrow"][t],
        torch.from_numpy(rng.integers(-2, 5, (R * S * T, bw)).astype(np.int8)
                         ).to(gpu),
        T, t, 4)
    got = executor.band_step(*args)
    want = executor.band_step_plain(*args)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("kmer_k,switchpoint,capacity", [
    (6, 4, 2048), (0, 0, 1024), (6, 0, 256)])
def test_scheme_kernels_vs_plain(setup, gpu, kmer_k, switchpoint, capacity):
    """run_scheme through kernels A and B on the card equals the plain
    versions on the CPU, field by field."""
    g, cpu_fm, fm = setup
    rng = np.random.default_rng(9)
    starts = rng.integers(0, len(g) - 100, 96)
    starts[:4] = [0, 1, len(g) - 100, len(g) - 101]
    reads = g[starts[:, None] + np.arange(100)].copy()
    for r in reads:
        r[rng.integers(0, 100, 2)] = rng.integers(0, 4, 2)
    batch = np.concatenate([reads, alphabet.revcomp(reads, axis=-1)])
    sched = pipeline.compile_cached(get_scheme("kuch1", 2), 100, "edit",
                                    kmer_k=kmer_k)
    itv_cap, ss, c2 = pipeline.crossover_caps(capacity, 4096, switchpoint)
    out = []
    for index in (fm, cpu_fm):
        table = kmer.build_kmer_table(index, kmer_k) if kmer_k else None
        b = torch.from_numpy(batch).to(index.device)
        out.append(executor.run_scheme(
            index, b, sched, capacity, table, switchpoint, itv_cap, ss, c2,
            itv_min_depth=16))
    for f in ("ranges", "rid", "sid", "ed_lb", "done", "overflow",
              "nodes_visited", "itv", "itv_count", "searches_started"):
        assert torch.equal(getattr(out[0], f).cpu(), getattr(out[1], f)), f


def test_launch_counters(setup, gpu):
    _, _, fm = setup
    before = locate.KERNEL.launches
    locate.locate_rows(fm, torch.zeros(4, dtype=torch.int64, device=gpu))
    assert locate.KERNEL.launches == before + 1
