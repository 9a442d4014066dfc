"""Mapping strategy: single-end ALL mode over read batches.

The counterpart of the ALL-mode part of ``columba_tpu/search/strategy.py``:
every occurrence with ed <= k is reported. BEST(+x), dynamic scheme
selection and paired-end mapping are not in the port yet (ROADMAP queue 1,
items 9 and 11).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from columba_tpu_torch.index.fmindex import FMIndex
from columba_tpu_torch.search import pipeline
from columba_tpu_torch.search.scheme import get_scheme


@dataclass
class MappingConfig:
    scheme_name: str = "kuch1"
    metric: str = "edit"
    max_distance: int = 2     # ALL mode k (reference -e)
    switchpoint: int = 4      # in-text crossover (reference -i, default 4)
    capacity: int | None = None
    max_locate: int | None = None  # None: scale with batch + spill retry
    kmer_table: object = None  # optional device seed table
    arrays: object = None      # host IndexArrays; enables cross-boundary
                               # occurrence trimming on multi-sequence texts


def map_batch_all_start(index: FMIndex, reads: np.ndarray,
                        cfg: MappingConfig) -> dict:
    """Dispatch ALL-mode matching of a batch; the handle goes to
    :func:`map_batch_all_finish` (possibly on another thread)."""
    # the builtin 'columba' set collapses to its base scheme, as in the JAX
    # package without probe selection (the occurrence set is identical)
    return pipeline.match_all_start(
        index, reads, get_scheme(cfg.scheme_name, cfg.max_distance),
        metric=cfg.metric,
        capacity=cfg.capacity, max_locate=cfg.max_locate,
        kmer_table=cfg.kmer_table, switchpoint=cfg.switchpoint)


def map_batch_all_finish(ctx, index: FMIndex, reads: np.ndarray,
                         cfg: MappingConfig, counters=None):
    """Fetch + post-process a dispatched batch -> (OccArray, stats)."""
    occs, stats = pipeline.match_all_finish(ctx)
    if counters is not None:
        counters.add_device_stats(stats)
    if cfg.arrays is not None:
        kb = cfg.max_distance if cfg.metric == "edit" else 0
        occs = pipeline.apply_boundary_trim(occs, reads, cfg.arrays, kb,
                                            cfg.max_distance)
    return occs, stats
