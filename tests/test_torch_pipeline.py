"""The port's ALL-mode pipeline against the JAX package's.

``match_all_start`` / ``match_all_finish`` of both packages run on the same
reads; the occurrence arrays and the run statistics must be identical,
including the lossless retries. The batch is built so that its first
attempt overflows both capacities at once: reads from a repeated region
overflow the two-stage exact loop's ``ex_cap`` (4x capacity retry) and
reads from a long homopolymer run spill the locate capacity (4x
max_locate retry). One batch covers both so that the JAX side compiles
two shapes instead of four.
"""

import numpy as np
import torch

from columba_tpu.index import kmer as jkmer
from columba_tpu.index.build import build_index_from_codes
from columba_tpu.index.fmindex import FMIndex as JFMIndex
from columba_tpu.search import pipeline as jpipe
from columba_tpu.search.scheme import get_scheme as jscheme
from columba_tpu_torch.index import kmer as tkmer
from columba_tpu_torch.index.fmindex import FMIndex as TFMIndex
from columba_tpu_torch.search import pipeline as tpipe
from columba_tpu_torch.search.scheme import get_scheme as tscheme

from tests.test_torch_executor import repeat_genome, sample_batch

torch.set_num_threads(1)


def test_match_all_lossless_retries():
    rng = np.random.default_rng(41)
    rep = repeat_genome(rng)
    g = np.concatenate([rep, np.zeros(12000, np.uint8),
                        rng.integers(0, 4, 4000).astype(np.uint8)])
    # homopolymer reads first: lanes past ex_cap are the ones dropped
    reads = np.concatenate([np.zeros((2, 100), np.uint8),
                            sample_batch(rng, rep, 64)[:64]])
    kw = dict(metric="edit", switchpoint=4, ex_split=6, ex_cap=128)
    arrays = build_index_from_codes(g)
    jfm, tfm = JFMIndex.from_arrays(arrays), TFMIndex.from_arrays(arrays)
    j_ctx = jpipe.match_all_start(jfm, reads, jscheme("kuch1", 2),
                                  kmer_table=jkmer.build_kmer_table(jfm, 6),
                                  **kw)
    first = j_ctx["out"]
    assert int(first["overflow"]) > 0
    assert int(first["total"]) > j_ctx["max_locate"]
    j_occ, j_stats = jpipe.match_all_finish(j_ctx)
    t_occ, t_stats = tpipe.match_all_finish(tpipe.match_all_start(
        tfm, reads, tscheme("kuch1", 2),
        kmer_table=tkmer.build_kmer_table(tfm, 6), **kw))
    assert t_stats == j_stats
    assert j_stats["retries"] == 1 and j_stats["overflow"] == 0
    assert not j_stats["locate_truncated"]
    for f in ("read_id", "strand", "begin", "end", "distance"):
        np.testing.assert_array_equal(getattr(j_occ, f), getattr(t_occ, f),
                                      err_msg=f)
    assert len(t_occ) > 0
