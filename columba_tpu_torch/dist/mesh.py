"""Data parallelism: shard read batches over devices and ranks.

The counterpart of ``columba_tpu/dist/mesh.py`` on ``torch.distributed``.
The index and the k-mer seed table are replicated: every shard reads all
of them. A read batch is split on its leading axis into equal shards, and
each shard runs the single-device match step
(``pipeline.match_device_core``) with a frontier of its own, so the hot
loop never leaves its device. Only the six counters are reduced: summed
over the shards of this process, then, when a process group is up,
all-reduced across the ranks (the JAX package's ``psum``).

Within one process the shards run on the one device, one after another:
the form that the JAX package's mesh of virtual devices takes on a CPU or
on a machine with one card. Across processes every rank holds the same
number of shards, laid out in rank order (``multihost.shard_batch``), so a
row's global id is its rank's offset plus its id in the rank.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from columba_tpu_torch import native
from columba_tpu_torch.search import pipeline, schedule

ARRAYS = ("rid", "win_start", "final_rows", "valid")
COUNTERS = ("overflow", "nodes_visited", "total", "n_unique", "itv_started",
            "searches_started")


@dataclass(frozen=True)
class DataMesh:
    """A 1-D ``data`` mesh as one process sees it: ``local_shards`` shards
    on ``device``; ``shards`` holds their global indices."""

    device: torch.device
    local_shards: int
    world_size: int
    shards: tuple


def make_data_mesh(num_shards: int | None = None,
                   device="cuda") -> DataMesh:
    """``num_shards`` (default 1) shards in this process, on ``device``
    (a CUDA device must be usable: no fallback to the CPU). Their global
    indices follow this rank's place in the process group (rank 0 of 1
    when no group is up)."""
    n = 1 if num_shards is None else int(num_shards)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n}")
    device = native.usable_device(device)
    rank, world = 0, 1
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    return DataMesh(device, n, world, tuple(rank * n + i for i in range(n)))


def sharded_match(mesh: DataMesh, index, reads: torch.Tensor,
                  sched: schedule.Schedule, capacity_per_shard: int,
                  max_locate_per_shard: int, kb: int, kmer_table=None,
                  switchpoint: int = 0,
                  max_verify_per_shard: int | None = None) -> dict:
    """Run the device match step data-parallel over ``mesh``.

    reads: this process's (R, m) uint8 rows on the mesh's device, R
    divisible by its shard count. Returns the dict of
    ``pipeline.match_device_core`` with the shards' arrays concatenated on
    axis 0 (``rid`` global) and the six counters summed over every shard of
    every rank, as 0-d int64 tensors on the host (the same on every rank).
    The capacities, the in-text crossover and the verify sizing are the
    single-device arguments, per shard.
    """
    n = mesh.local_shards
    R = reads.shape[0]
    if R % n:
        raise ValueError(f"batch {R} not divisible by {n} shards")
    rows = R // n
    itv_cap, split_step, cap2 = pipeline.crossover_caps(
        capacity_per_shard, max_locate_per_shard, switchpoint)
    outs = []
    for i, shard in enumerate(mesh.shards):
        out = pipeline.match_device_core(
            index, reads[i * rows:(i + 1) * rows], sched,
            capacity_per_shard, max_locate_per_shard, kb,
            kmer_table=kmer_table, switchpoint=switchpoint, itv_cap=itv_cap,
            split_step=split_step, capacity2=cap2,
            max_verify=max_verify_per_shard)
        out["rid"] = out["rid"] + shard * rows
        outs.append(out)
    res = {k: torch.cat([o[k] for o in outs]) for k in ARRAYS}
    counts = torch.stack([
        torch.stack([o[k].to(torch.int64) for k in COUNTERS])
        for o in outs]).sum(0).cpu()
    # The counters travel on the host: one copy of six integers a call, and
    # one collective of the process group, which multihost.initialize makes
    # gloo. Ranks may share a card, and NCCL takes no two ranks on one
    # device; six integers need no device collective.
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(counts)
    res.update(zip(COUNTERS, counts.unbind()))
    return res


def sharded_match_jit(mesh: DataMesh, index, reads: torch.Tensor, scheme,
                      m: int, metric: str = "edit",
                      capacity_per_shard: int = 4096,
                      max_locate_per_shard: int = 4096) -> dict:
    """Convenience: compile the schedule, then :func:`sharded_match`. The
    name is the JAX package's; nothing is jitted here."""
    sched = pipeline.compile_cached(scheme, m, metric)
    kb = scheme.k if metric == "edit" else 0
    return sharded_match(mesh, index, reads, sched, capacity_per_shard,
                         max_locate_per_shard, kb)
