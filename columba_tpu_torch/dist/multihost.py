"""Multi-process scale-out: ``torch.distributed`` + per-rank readers.

The counterpart of ``columba_tpu/dist/multihost.py``. Every rank

- calls :func:`initialize` (a gloo process group),
- loads the same persisted index and places it on its own device
  (:func:`replicate`),
- reads its own slice of the input (:func:`shard_batch`; every rank the
  same number of rows),
- runs ``mesh.sharded_match`` over :func:`global_mesh`: the hot loop stays
  on the rank's device, and only the six counters cross ranks,
- takes its own rows' occurrences from :func:`local_out`.

``columba_tpu_torch/tools/multihost_dryrun.py`` runs this end to end with
two rank processes on one machine.
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from columba_tpu_torch.dist import mesh as dmesh
from columba_tpu_torch.index.bmove import BMoveArrays, BMoveIndex
from columba_tpu_torch.index.fmindex import FMIndex

# a collective that waits longer fails the run: a lost rank never hangs it
TIMEOUT = timedelta(seconds=120)


def initialize(init_method: str, world_size: int, rank: int) -> None:
    """Join the job's gloo process group (``init_method`` such as
    ``tcp://127.0.0.1:PORT``)."""
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=TIMEOUT)


def global_mesh(device="cuda") -> dmesh.DataMesh:
    """One shard per rank, on the rank's device: ``cuda`` means card
    ``rank % device_count`` (every rank on the one card of a one-card
    machine)."""
    device = torch.device(device)
    if (device.type == "cuda" and device.index is None
            and torch.cuda.device_count() > 0):
        device = torch.device("cuda", dist.get_rank()
                              % torch.cuda.device_count())
    return dmesh.make_data_mesh(1, device)


def replicate(mesh: dmesh.DataMesh, arrays):
    """The index of host ``arrays`` (Vanilla or RLC) on the rank's device."""
    if isinstance(arrays, BMoveArrays):
        return BMoveIndex.from_arrays(arrays, mesh.device)
    return FMIndex.from_arrays(arrays, mesh.device)


def shard_batch(mesh: dmesh.DataMesh, local_reads: np.ndarray
                ) -> torch.Tensor:
    """This rank's (R_local, m) rows on its device. Every rank must hold
    the same R_local (one all-reduce of its minimum and maximum): shards
    are laid out in rank order, so a global row id is
    ``rank * R_local + local id``."""
    R = int(local_reads.shape[0])
    if mesh.world_size > 1:
        span = torch.tensor([-R, R], dtype=torch.int64)
        dist.all_reduce(span, op=dist.ReduceOp.MAX)
        if -int(span[0]) != int(span[1]):
            raise ValueError(f"ranks hold {-int(span[0])} to {int(span[1])} "
                             f"rows; every rank must hold the same count")
    return torch.from_numpy(np.ascontiguousarray(local_reads)).to(
        mesh.device)


def local_out(out: dict) -> dict:
    """The rank's view of a ``sharded_match`` output: its arrays as numpy,
    the reduced counters as ints."""
    return {k: (int(v) if v.dim() == 0 else v.cpu().numpy())
            for k, v in out.items()}
