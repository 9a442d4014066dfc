"""Block-partitioned indexes: genomes past the 4.29 Gbp uint32 ceiling.

The counterpart of ``columba_tpu/index/blocked.py``, over the port's own
``index/build.py``. The single-index format keeps every device word at
uint32 (index/build.py MAX_N), which caps one index at ~4.29 Gbp. The
reference covers the regime above that with 64-bit words plus Big-BWT
prefix-free parsing (reference: src/definitions.h:69-75,
src/bmove/columba_build_pfp.sh). Here the hot path stays 32-bit and the
genome is **partitioned into blocks of whole sequences**, each an ordinary
sub-index:

  <out>/meta.json                 {"flavor": "blocked", ...}
  <out>/block0/ ... block<B-1>/   ordinary .cidx sub-indexes

Alignment maps every read batch against each block (one block's index on
the device at a time; reads stream once per block) and merges the
occurrence sets on the host. Sequences are never split across blocks, so
per-block occurrences are independent: ALL mode merges by concatenation;
BEST(+x) re-filters the union to the global best stratum. The reference's
occurrence semantics compose over disjoint reference sequences the same
way (src/indexinterface.cpp:799-897 assigns by sequence; nothing crosses
sequence boundaries after trimming).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from columba_tpu_torch.index import build as ibuild

BLOCKED_FORMAT_VERSION = 1


def partition_sequences(starts: np.ndarray, max_block_bp: int) -> list[tuple[int, int]]:
    """Greedy partition of whole sequences into blocks <= max_block_bp.

    starts: (num_seqs+1,) cumulative offsets. Returns [(seq_lo, seq_hi)).
    A single sequence longer than max_block_bp is rejected — sequences are
    never split (occurrence merging relies on it)."""
    lens = np.diff(starts)
    if len(lens) == 0:
        raise ValueError("no sequences")
    if int(lens.max()) > max_block_bp:
        raise ValueError(
            f"sequence of {int(lens.max())} bp exceeds the block size "
            f"{max_block_bp}; blocks hold whole sequences")
    blocks = []
    lo = 0
    acc = 0
    for i, ln in enumerate(lens):
        if acc and acc + int(ln) > max_block_bp:
            blocks.append((lo, i))
            lo, acc = i, 0
        acc += int(ln)
    blocks.append((lo, len(lens)))
    return blocks


def build_blocked_index(
    fasta_paths: list[str] | str,
    out_dir: str,
    max_block_bp: int = ibuild.MAX_N,
    sa_sparseness: int = 4,
    seed: int = 42,
    seed_length: int = 100,
    sa_method: str = "auto",
) -> dict:
    """FASTA file(s) -> blocked index directory; returns the top meta."""
    if isinstance(fasta_paths, str):
        fasta_paths = [fasta_paths]
    codes, names, starts = ibuild.preprocess_fasta(
        fasta_paths, seed=seed, seed_length=seed_length)
    return build_blocked_from_codes(
        codes, names, starts, out_dir, max_block_bp=max_block_bp,
        sa_sparseness=sa_sparseness, sa_method=sa_method)


def build_blocked_from_codes(
    codes: np.ndarray,
    names: list[str],
    starts: np.ndarray,
    out_dir: str,
    max_block_bp: int = ibuild.MAX_N,
    sa_sparseness: int = 4,
    sa_method: str = "auto",
) -> dict:
    """Preprocessed codes -> blocked index directory (see module doc)."""
    max_block_bp = min(int(max_block_bp), ibuild.MAX_N)
    starts = np.asarray(starts)
    blocks = partition_sequences(starts, max_block_bp)
    os.makedirs(out_dir, exist_ok=True)
    block_meta = []
    for bi, (s_lo, s_hi) in enumerate(blocks):
        t_lo, t_hi = int(starts[s_lo]), int(starts[s_hi])
        sub = ibuild.build_index_from_codes(
            codes[t_lo:t_hi],
            names[s_lo:s_hi],
            (starts[s_lo:s_hi + 1] - t_lo),
            sa_sparseness=sa_sparseness,
            sa_method=sa_method,
        )
        bdir = os.path.join(out_dir, f"block{bi}")
        ibuild.save_index(sub, bdir)
        block_meta.append({
            "dir": f"block{bi}",
            "n": int(t_hi - t_lo),
            "num_seqs": int(s_hi - s_lo),
            "text_offset": t_lo,
            "seq_offset": int(s_lo),
        })
    meta = {
        "flavor": "blocked",
        "format_version": BLOCKED_FORMAT_VERSION,
        "n": int(starts[-1]),
        "num_seqs": len(names),
        "sa_sparseness": int(sa_sparseness),
        "blocks": block_meta,
    }
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return meta


class LazyBlockText:
    """Sliceable global-genome facade over per-block 2-bit packed text.

    Memory-maps each block's ``text.npy`` (so the OS pages in only the
    windows touched) and decodes the requested window on demand. Emission
    windows are clamped to one sequence and sequences never cross blocks
    (partition_sequences), so every slice hits exactly one block. This is
    what lets blocked alignment run on genomes whose decoded text would
    not fit in host RAM (the >4.29 Gbp regime the reference reaches via
    64-bit words + Big-BWT, src/definitions.h:69-75)."""

    def __init__(self, index_dir: str, meta: dict):
        self.offsets = np.array(
            [bm["text_offset"] for bm in meta["blocks"]], dtype=np.int64)
        self.ns = np.array([bm["n"] for bm in meta["blocks"]],
                           dtype=np.int64)
        self.words = [
            np.load(os.path.join(index_dir, bm["dir"], "text.npy"),
                    mmap_mode="r")
            for bm in meta["blocks"]
        ]
        self.n = int(meta["n"])

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, key):
        if not isinstance(key, slice):
            return self[key:key + 1][0]
        lo = 0 if key.start is None else int(key.start)
        hi = self.n if key.stop is None else int(key.stop)
        lo, hi = max(lo, 0), min(hi, self.n)
        if hi <= lo:
            return np.empty(0, dtype=np.uint8)
        bi = int(np.searchsorted(self.offsets, lo, side="right") - 1)
        off = int(self.offsets[bi])
        if hi - off > int(self.ns[bi]):
            raise IndexError(
                f"window [{lo},{hi}) crosses block boundary at "
                f"{off + int(self.ns[bi])}")
        return ibuild.unpack_window(self.words[bi], lo - off, hi - off)


@dataclass
class BlockedView:
    """Global genome view for host emission over a blocked index: the
    fields emit_sam/emit_rhs touch (decoded text, seq starts/names).
    ``_decoded_text`` is a LazyBlockText so decoded_text(view) in
    strategy.emit_sam never materialises the whole genome."""

    meta: dict
    seq_starts: np.ndarray            # (num_seqs+1,) int64 global offsets
    seq_names: list[str] = field(default_factory=list)
    _decoded_text: "LazyBlockText | np.ndarray | None" = None

    @property
    def n(self) -> int:
        return int(self.meta["n"])


def load_blocked_meta(index_dir: str) -> dict:
    with open(os.path.join(index_dir, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("flavor") != "blocked":
        raise ValueError(f"{index_dir} is not a blocked index")
    if meta.get("format_version") != BLOCKED_FORMAT_VERSION:
        raise ValueError("blocked index format mismatch; rebuild")
    return meta


def iter_blocks(index_dir: str, meta: dict):
    """Yield (block_meta, IndexArrays) for each block, loading lazily."""
    for bm in meta["blocks"]:
        yield bm, ibuild.load_index(os.path.join(index_dir, bm["dir"]))


def make_view(index_dir: str, meta: dict) -> BlockedView:
    """Assemble the global emission view WITHOUT loading any block's index
    arrays: sequence names/starts come from each block's small meta.json +
    seq_starts.npy, and the genome text is a lazily-decoded memory map."""
    names: list[str] = []
    starts = [0]
    for bm in meta["blocks"]:
        bdir = os.path.join(index_dir, bm["dir"])
        with open(os.path.join(bdir, "meta.json")) as f:
            bmeta = json.load(f)
        names.extend(bmeta["seq_names"])
        seq_starts = np.load(os.path.join(bdir, "seq_starts.npy"))
        off = bm["text_offset"]
        starts.extend((np.asarray(seq_starts[1:], dtype=np.int64)
                       + off).tolist())
    view = BlockedView(
        meta=meta,
        seq_starts=np.asarray(starts, dtype=np.int64),
        seq_names=names,
    )
    view._decoded_text = LazyBlockText(index_dir, meta)
    return view


def merge_best(occs_per_block: list, best_plus_x: int, cutoff: int):
    """Global BEST(+x) filter over per-block best results: each block's
    map_batch_best_arr output already holds [block_best, block_best+x];
    keep the union's occurrences within [global_best, global_best+x]
    (reference semantics: one global stratum ladder,
    src/searchstrategy.cpp:623-712)."""
    from columba_tpu_torch.search import pipeline

    allo = pipeline.OccArray.concat(occs_per_block)
    if not len(allo):
        return allo
    n_reads = int(allo.read_id.max()) + 1
    best = np.full(n_reads, cutoff + 1, dtype=np.int64)
    np.minimum.at(best, allo.read_id, allo.distance)
    rb = best[allo.read_id]
    keep = (rb <= cutoff) & (allo.distance <= np.minimum(rb + best_plus_x,
                                                         cutoff))
    allo = allo.take(keep)
    o = np.lexsort((allo.begin, allo.end, allo.strand, allo.read_id))
    return allo.take(o)
