"""The port's data-parallel match (``columba_tpu_torch/dist``) against the
JAX package's.

The same numpy rows go through ``columba_tpu.dist.mesh.sharded_match`` over
the conftest's 8 virtual devices and through the port's over an 8-shard
mesh on the CPU, in the three configurations of ``tests/test_dist.py``
(Vanilla; the k-mer seed table with the in-text crossover; the RLC index).
All the arithmetic is integer, so the outputs must be equal: the ``valid``
mask, ``rid`` / ``win_start`` / ``final_rows`` at the valid slots, slot for
slot, and the six reduced counters. The 2-rank dryrun runs the port's
gloo path in two processes. 82 s pinned to one core (``taskset -c 0``,
``-n 0``), about 35 s in one worker of the parallel run (``--durations``),
most of it the JAX package's three compiles.
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from columba_tpu.core import alphabet
from columba_tpu.dist import mesh as jmesh
from columba_tpu.index import bmove as jbm, kmer as jkmer
from columba_tpu.index.fmindex import FMIndex as JFMIndex
from columba_tpu.search import pipeline as jpipe
from columba_tpu.search.scheme import get_scheme as jscheme
from columba_tpu_torch.dist import mesh as tmesh
from columba_tpu_torch.index import kmer as tkmer
from columba_tpu_torch.index.bmove import BMoveIndex
from columba_tpu_torch.index.fmindex import FMIndex as TFMIndex
from columba_tpu_torch.search import pipeline as tpipe
from columba_tpu_torch.search.scheme import get_scheme as tscheme

from tests.conftest import sample_reads

torch.set_num_threads(1)


def _vanilla(genome, arrays):
    """tests/test_dist.py:17: m = 60, k = 2, both strands of 16 reads."""
    reads = sample_reads(np.random.default_rng(17), genome, num=16,
                         length=60, max_err=2)
    rows = np.concatenate([reads, alphabet.revcomp(reads, axis=-1)])
    return (JFMIndex.from_arrays(arrays), TFMIndex.from_arrays(arrays, "cpu"),
            rows, 60, dict(capacity_per_shard=1024, max_locate_per_shard=512),
            0, 0)


def _seeded(genome, arrays):
    """tests/test_dist.py:53: the 6-mer table and the in-text crossover."""
    rng = np.random.default_rng(9)
    m = 80
    starts = rng.integers(0, len(genome) - m, size=16)
    rows = np.stack([genome[s:s + m] for s in starts])
    for i in range(16):
        j = int(rng.integers(0, m))
        rows[i, j] = (rows[i, j] + 1) % 4
    return (JFMIndex.from_arrays(arrays), TFMIndex.from_arrays(arrays, "cpu"),
            rows, m, dict(capacity_per_shard=256, max_locate_per_shard=1024),
            6, 4)


def _rlc(genome, arrays):
    """tests/test_dist.py:100: the RLC (b-move) index."""
    rng = np.random.default_rng(100)
    m = 80
    starts = rng.integers(0, len(genome) - m, size=16)
    rows = np.stack([genome[s:s + m] for s in starts])
    ba = jbm.build_bmove_from_codes(genome)
    return (jbm.BMoveIndex.from_arrays(ba), BMoveIndex.from_arrays(ba, "cpu"),
            rows, m, dict(capacity_per_shard=256, max_locate_per_shard=512),
            0, 0)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("case", [_vanilla, _seeded, _rlc],
                         ids=["vanilla", "seeded_crossover", "rlc"])
def test_sharded_match_equals_jax(small_index, case):
    genome, arrays = small_index
    jidx, tidx, rows, m, caps, kmer_k, switchpoint = case(genome, arrays)
    rows = rows.astype(np.uint8)
    kw = dict(kb=2, switchpoint=switchpoint, **caps)

    jsched = jpipe.compile_cached(jscheme("kuch1", 2), m, "edit",
                                  kmer_k=kmer_k)
    jout = jmesh.sharded_match(
        jmesh.make_data_mesh(8), jidx, jnp.asarray(rows.astype(np.int32)),
        jsched, kmer_table=(jkmer.build_kmer_table(jidx, kmer_k)
                            if kmer_k else None), **kw)
    jout = {k: np.asarray(v) for k, v in jout.items()}

    tsched = tpipe.compile_cached(tscheme("kuch1", 2), m, "edit",
                                  kmer_k=kmer_k)
    tout = tmesh.sharded_match(
        tmesh.make_data_mesh(8, device="cpu"), tidx, torch.from_numpy(rows),
        tsched, kmer_table=(tkmer.build_kmer_table(tidx, kmer_k)
                            if kmer_k else None), **kw)

    valid = jout["valid"]
    np.testing.assert_array_equal(tout["valid"].numpy(), valid)
    assert valid.sum() > 0
    np.testing.assert_array_equal(tout["rid"].numpy()[valid],
                                  jout["rid"][valid].astype(np.int64))
    np.testing.assert_array_equal(
        tout["win_start"].numpy()[valid],
        jpipe.signed_positions(jout["win_start"])[valid])
    np.testing.assert_array_equal(
        tout["final_rows"].numpy()[valid].astype(np.int64),
        jout["final_rows"][valid].astype(np.int64))
    for k in tmesh.COUNTERS:
        assert int(tout[k]) == int(jout[k]), k
    assert int(tout["overflow"]) == 0
    # every row's shard is a block of 2 (or 4) rows, and rid is global
    assert set(tout["rid"].numpy()[valid]) <= set(range(len(rows)))


def test_sharded_match_equals_single_shard():
    """Two shards equal one match_device_core on the whole batch at twice
    the caps: the occurrence set and three counters (the port alone, so no
    JAX compile); sharded_match_jit equals sharded_match."""
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 30_000).astype(np.uint8)
    from columba_tpu_torch.index.build import build_index_from_codes

    index = TFMIndex.from_arrays(build_index_from_codes(genome), "cpu")
    reads = sample_reads(rng, genome, num=24, length=70, max_err=2)
    rows = torch.from_numpy(np.concatenate(
        [reads, alphabet.revcomp(reads, axis=-1)]).astype(np.uint8))
    sched = tpipe.compile_cached(tscheme("kuch1", 2), 70, "edit")
    out = tmesh.sharded_match(tmesh.make_data_mesh(2, device="cpu"), index,
                              rows, sched, 512, 1024, 2)
    one = tpipe.match_device_core(index, rows, sched, 1024, 2048, 2)

    def occ(o):
        v = o["valid"]
        return set(zip(o["rid"][v].tolist(), o["win_start"][v].tolist()))

    assert occ(out) == occ(one) and len(occ(one)) >= 24
    for k in ("overflow", "total", "n_unique"):
        assert int(out[k]) == int(one[k]), k
    # the convenience entry compiles the same schedule
    jit = tmesh.sharded_match_jit(tmesh.make_data_mesh(2, device="cpu"),
                                  index, rows, tscheme("kuch1", 2), 70,
                                  capacity_per_shard=512,
                                  max_locate_per_shard=1024)
    for k in (*tmesh.ARRAYS, *tmesh.COUNTERS):
        assert torch.equal(jit[k], out[k]), k
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.sharded_match(tmesh.make_data_mesh(5, device="cpu"), index,
                            rows, sched, 512, 1024, 2)


def test_multihost_dryrun_gloo():
    """Two rank processes joined by gloo on the CPU: recall 1.0 on each
    rank, and rank 0's in-process 2-shard mesh gives the same occurrences
    and counters."""
    r = subprocess.run(
        [sys.executable, "-m", "columba_tpu_torch.tools.multihost_dryrun",
         "--device", "cpu"],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["ok"] is True
    assert summary["ranks"] == 2
    assert summary["recalls"] == [1.0, 1.0]
    assert summary["overflow"] == 0 and summary["total"] > 0


def test_mesh_requires_a_usable_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the error path needs none")
    with pytest.raises(RuntimeError, match="no usable CUDA device"):
        tmesh.make_data_mesh(device="cuda")
    with pytest.raises(RuntimeError, match="no usable CUDA device"):
        tmesh.make_data_mesh(2)
