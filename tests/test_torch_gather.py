"""Kernel H's function against the JAX package's Pallas row gather.

``tools/pgather_bench.py``'s ``gather_rows`` (a DMA ring over aligned
8-row groups, then a lane select) runs in Pallas's TPU interpret mode on
the CPU; the port's ``tools/gather_bench.gather_rows`` gets the same table
and indices as CPU tensors (its plain version). Both clamp indices to the
table. Exact equality, tolerance 0: the rows are copied words.
"""

import importlib.util
import os

import numpy as np
import torch
from jax.experimental.pallas import tpu as pltpu

from columba_tpu_torch.tools import gather_bench

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pallas_bench():
    spec = importlib.util.spec_from_file_location(
        "pgather_bench", os.path.join(_ROOT, "tools", "pgather_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_gather_equals_pallas_gather():
    """1,024 lanes, 64 B rows of a 5,000-row table (not a multiple of the
    Pallas kernel's 8-row groups), chunk 256; the first indices are 0,
    T - 1 and two past the table (the clamp)."""
    T, W, N = 5000, 16, 1024
    rng = np.random.default_rng(41)
    table = rng.integers(-2 ** 31, 2 ** 31, (T, W),
                         dtype=np.int64).astype(np.int32)
    idx = rng.integers(0, T, N).astype(np.int32)
    idx[:4] = [0, T - 1, T, T + 999]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_pallas_bench().gather_rows(table, idx, chunk=256))
    got = gather_bench.gather_rows(torch.from_numpy(table),
                                   torch.from_numpy(idx.astype(np.int64)))
    assert want.shape == (N, W) and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[2:4], table[[T - 1, T - 1]])
