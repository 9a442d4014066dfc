"""Host-side index construction.

Mirrors the role of the reference's ``columba_build``
(reference: src/buildindex.cpp): FASTA concatenation with seeded non-ACGT
replacement, suffix array, BWT + reverse BWT, and packing into the TPU-native
layout:

  - ``text``     : 2-bit packed genome (16 bases / uint32 word)
  - ``bwt``/``rbwt``: 2-bit packed BWT of text+'$' and revtext+'$' with the
    '$' slot stored as code 0 and its row recorded separately (the reference
    similarly leaves '$' out of its occ bitvectors, src/fmindex/bwtrepr.h)
  - ``occ``/``rocc`` : per-128-char block checkpoints of occ(c, block_start),
    i.e. the L1/L2 counts of the reference's interleaved rank9 bitvector
    (src/bitvec.h:234-478) re-laid-out as a dense (blocks, 4) uint32 array so a
    batched rank is one row gather + popcount-style in-block reduction.
  - sparse SA samples at SA[i] % f == 0 with a marker bitvector
    (reference: src/fmindex/suffixArray.h)

Index directory layout: ``<name>.cidx/`` with .npy arrays + meta.json.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np

from columba_tpu_torch.core import alphabet
from columba_tpu_torch.index.suffix import bwt_rows, suffix_array
from columba_tpu_torch.logger import logger

INDEX_FORMAT_VERSION = 1
BLOCK = 128          # chars per occ checkpoint block
WORDS_PER_BLOCK = BLOCK // 16

# Largest supported text: device positions are uint32 with a 2^18 guard band
# reserved for wrapped-negative window starts (ops/verify.py NEG_T) — one
# index covers genomes to ~4.29 Gbp, the reference's 64-bit length_t regime
# (src/definitions.h:69-75) without widening any hot-path word.
MAX_N = 2**32 - 2**18


@dataclass
class IndexArrays:
    """All host numpy arrays of a built index."""

    meta: dict
    text: np.ndarray        # packed uint32, 16 bases/word, n bases
    bwt: np.ndarray         # packed uint32 (N = n+1 slots incl. '$' as A)
    rbwt: np.ndarray
    occ: np.ndarray         # (blocks, 4) uint32 checkpoint counts
    rocc: np.ndarray
    counts: np.ndarray      # (4,) uint32: first SA row of A,C,G,T
    sa_samples: np.ndarray  # uint32 sampled SA values, in SA-row order
    sa_bits: np.ndarray     # packed uint32 marker bitvector over N rows
    sa_bits_rank: np.ndarray  # (blocks,) uint32: set bits before each 128-bit block
    seq_starts: np.ndarray  # (num_seqs+1,) int64 cumulative start offsets
    seq_names: list[str] = field(default_factory=list)

    @property
    def n(self) -> int:
        return self.meta["n"]

    @property
    def dollar_fwd(self) -> int:
        return self.meta["dollar_fwd"]

    @property
    def dollar_rev(self) -> int:
        return self.meta["dollar_rev"]


# Chunk sizes of the multi-Gbp passes (module constants so that a test can
# shrink them and run every pass over several chunks).
PACK_SPAN = 1 << 24     # codes a chunk of pack_2bit (a multiple of 16)
UNPACK_SPAN = 1 << 22   # words a chunk of unpack_2bit
BLOCK_SPAN = 1 << 17    # 128-row blocks a chunk of the occ and bit passes
ROW_SPAN = 1 << 24      # rows a chunk of the SA sampling and the base count


def _spans(n: int, step: int) -> list[tuple[int, int]]:
    return [(lo, min(lo + step, n)) for lo in range(0, n, step)]


def _cores() -> int:
    return len(os.sched_getaffinity(0))


def _each(fn, spans, threads: int | None = None) -> list:
    """``fn(lo, hi)`` over the spans on ``threads`` threads (default: a
    core each; numpy's loops release the GIL): the multi-Gbp passes of a
    build use every core."""
    if len(spans) < 2:
        return [fn(lo, hi) for lo, hi in spans]
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(threads or _cores()) as pool:
        return list(pool.map(lambda s: fn(*s), spans))


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """uint8 codes (0..3) -> packed uint32, 16 codes/word, little-end first.

    Chunked (``PACK_SPAN`` codes, in parallel) so multi-Gbp builds never
    materialize a 4B/char temporary."""
    n = len(codes)
    n_words = (n + 15) // 16
    out = np.empty(n_words, dtype=np.uint32)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]

    def one(lo, hi):
        chunk = np.zeros(hi - lo, dtype=np.uint32)
        top = min(n, hi)
        if top > lo:
            chunk[: top - lo] = codes[lo:top]
        out[lo // 16: hi // 16] = np.bitwise_or.reduce(
            chunk.reshape(-1, 16) << shifts, axis=1).astype(np.uint32)

    _each(one, _spans(n_words * 16, PACK_SPAN))
    return out


def unpack_2bit(words: np.ndarray, n: int) -> np.ndarray:
    """The first ``n`` codes of packed words. Chunked (``UNPACK_SPAN``
    words): a multi-Gbp text must not materialize a 4 B/code temporary."""
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    n_words = min(len(words), (n + 15) // 16)
    codes = np.empty(n_words * 16, dtype=np.uint8)
    for lo, hi in _spans(n_words, UNPACK_SPAN):
        codes[lo * 16:hi * 16] = ((words[lo:hi, None] >> shifts) & 3).reshape(-1)
    return codes[:n]


def unpack_window(words: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Decode codes [lo, hi) without touching the rest of the packed text
    (a multi-Gbp genome must not be fully decoded per small query)."""
    lo_w, hi_w = lo >> 4, (hi + 15) >> 4
    chunk = unpack_2bit(words[lo_w:hi_w], (hi_w - lo_w) * 16)
    return chunk[lo - (lo_w << 4): hi - (lo_w << 4)]


def decoded_text(arrays) -> np.ndarray:
    """Whole decoded genome, cached on the arrays object (1 B/base): the
    emission tracebacks slice it per occurrence, and decoding per batch
    was the host hot spot. Works for IndexArrays and BMoveArrays."""
    d = getattr(arrays, "_decoded_text", None)
    if d is None:
        d = unpack_2bit(arrays.text, arrays.n)
        object.__setattr__(arrays, "_decoded_text", d)
    return d


def _occ_checkpoints(codes: np.ndarray, n_rows: int,
                     threads: int | None = None) -> np.ndarray:
    """(blocks, 4) uint32 checkpoints: count of code c in codes[0:128*b).
    Only whole blocks reach a checkpoint; they are counted in parallel."""
    blocks = (n_rows >> 7) + 1
    full = blocks - 1
    per_block = np.zeros((full, 4), dtype=np.int64)
    view = codes[:full * BLOCK].reshape(full, BLOCK)

    def one(lo, hi):
        for c in range(4):
            per_block[lo:hi, c] = (view[lo:hi] == c).sum(axis=1)

    _each(one, _spans(full, BLOCK_SPAN), threads)
    ckpt = np.zeros((blocks, 4), dtype=np.int64)
    np.cumsum(per_block, axis=0, out=ckpt[1:])
    return ckpt.astype(np.uint32)


def _pack_bits(bits: np.ndarray, threads: int | None = None
               ) -> tuple[np.ndarray, np.ndarray]:
    """bool array -> (packed uint32 words, per-128-bit-block rank ckpts).

    Bit (pos & 31) of word pos>>5, little-endian within each byte — i.e.
    numpy packbits(bitorder='little') viewed as little-endian uint32.
    Whole blocks in parallel, then the last (zero-padded) one."""
    n = len(bits)
    blocks = (n >> 7) + 1
    full = blocks - 1
    words = np.empty(blocks * 4, dtype="<u4")
    per_block = np.zeros(full, dtype=np.int64)

    def one(lo, hi):
        seg = bits[lo * BLOCK:hi * BLOCK]
        words[lo * 4:hi * 4] = np.packbits(seg, bitorder="little").view("<u4")
        per_block[lo:hi] = seg.reshape(-1, BLOCK).sum(axis=1, dtype=np.int64)

    _each(one, _spans(full, BLOCK_SPAN), threads)
    tail = np.zeros(BLOCK, dtype=np.uint8)
    tail[:n - full * BLOCK] = bits[full * BLOCK:]
    words[full * 4:] = np.packbits(tail, bitorder="little").view("<u4")
    rank = np.zeros(blocks, dtype=np.int64)
    np.cumsum(per_block, out=rank[1:])
    return words, rank.astype(np.uint32)


def _minstd_uniform4(count: int) -> np.ndarray:
    """First `count` draws of libstdc++ uniform_int_distribution(0,3) over
    std::minstd_rand(42) — bit-exact with the reference's replacement RNG
    (src/buildindex.cpp:86-96, 617-630). minstd: x <- x*48271 mod 2^31-1;
    the distribution divides by scaling with rejection of the tail."""
    out = np.empty(count, dtype=np.uint8)
    x = 42
    scaling = 2147483646 // 4
    past = 4 * scaling
    i = 0
    while i < count:
        x = (x * 48271) % 2147483647
        ret = x - 1  # generator min() is 1
        if ret < past:
            out[i] = ret // scaling
            i += 1
    return out


# ASCII whitespace other than the newline (bytes.strip removes all of it)
_OTHER_SPACE = (b" ", b"\t", b"\r", b"\x0b", b"\x0c")
# alphabet.encode as a bytes.translate table
_ENCODE = bytes(alphabet.encode(bytes(range(256))))


def _fasta_records(data: bytes, add) -> None:
    """``add(name, sequence)`` for each FASTA record of ``data``, as a
    line reader gives them: each line stripped, empty lines skipped, a line
    starting with '>' a header (its first word the name), lines before the
    first header ignored.

    A record runs from a '>' at the start of a line to the next; its
    sequence is its body with the newlines removed, one C pass a record (a
    multi-Gbp FASTA has tens of millions of lines). Only a body that holds
    other whitespace (CR line ends, blanks, an indented header) is read
    line by line."""
    s = 0
    while True:
        end = data.find(b"\n>", s)
        end = len(data) if end < 0 else end
        if data.startswith(b">", s):
            eol = data.find(b"\n", s, end)
            eol = end if eol < 0 else eol
            name, body = data[s + 1:eol].split()[0].decode(), data[eol:end]
        else:                                       # before the first header
            name, body = None, data[s:end]
        if any(c in body for c in _OTHER_SPACE):
            parts: list[bytes] = []
            for line in body.split(b"\n"):
                line = line.strip()
                if not line:
                    continue
                if line.startswith(b">"):
                    if name is not None:
                        add(name, b"".join(parts))
                    name, parts = line[1:].split()[0].decode(), []
                else:
                    parts.append(line)
            if name is not None:
                add(name, b"".join(parts))
        elif name is not None:
            add(name, body.replace(b"\n", b""))
        if end == len(data):
            return
        s = end + 1


def preprocess_fasta(
    fasta_paths: list[str], seed: int = 42, seed_length: int = 100
) -> tuple[np.ndarray, list[str], np.ndarray]:
    """Concatenate FASTA files, replace non-ACGT with seeded bases.

    Returns (codes uint8 0..3, seq names, seq start offsets int64 with final
    sentinel offset). Replacement is bit-exact with the reference default
    (src/buildindex.cpp:614-650): a seed string of `seed_length` ACGT chars
    is drawn from minstd_rand(42), and every maximal run of non-ACGT
    characters cycles through it from its start (replaceNonACGTWithSeed
    resets the seed index on each ACGT char). seed_length=0 falls back to a
    numpy RNG (`seed`) — the reference's unseeded path is also random.
    """
    names: list[str] = []
    chunks: list[np.ndarray] = []
    starts = [0]
    total = 0

    def add(name, seq: bytes):
        nonlocal total
        codes = np.frombuffer(seq.translate(_ENCODE), dtype=np.uint8)
        names.append(name)
        chunks.append(codes)
        total += len(codes)
        starts.append(total)

    for path in fasta_paths:
        with open(path, "rb") as f:
            _fasta_records(f.read(), add)
    if not chunks:
        raise ValueError("no sequences found")
    codes = np.concatenate(chunks)
    bad = codes > 3
    n_bad = int(bad.sum())
    if n_bad:
        if seed_length > 0:
            seed_codes = _minstd_uniform4(seed_length)
            pos = np.nonzero(bad)[0]
            is_start = np.ones(len(pos), bool)
            is_start[1:] = np.diff(pos) > 1
            start_of_run = np.where(is_start, pos, 0)
            np.maximum.accumulate(start_of_run, out=start_of_run)
            off = pos - start_of_run
            codes[pos] = seed_codes[off % seed_length]
        else:
            rng = np.random.default_rng(seed)
            codes[bad] = rng.integers(
                0, 4, size=n_bad, dtype=np.int64).astype(np.uint8)
    return codes, names, np.array(starts, dtype=np.int64)


def build_index_from_codes(
    codes: np.ndarray,
    seq_names: list[str] | None = None,
    seq_starts: np.ndarray | None = None,
    sa_sparseness: int = 4,
    sa_method: str = "auto",
) -> IndexArrays:
    """Build all index arrays from a clean 0..3 code array (no sentinel)."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    if codes.max(initial=0) > 3:
        raise ValueError("text contains non-ACGT codes; preprocess first")
    n = len(codes)
    big = n + 1  # rows incl. '$'
    if n > MAX_N:
        raise ValueError(
            f"text length {n} exceeds the uint32 index ceiling {MAX_N} "
            "(~4.29 Gbp); split the input or use the RLC flavor per bin")

    # The two directions are independent; the native suffix sorts release
    # the GIL (ctypes) and the numpy passes mostly do too, so two threads
    # overlap the dominant cost (the reference instead runs them
    # sequentially, src/buildindex.cpp:1964-1996), each on half the cores.
    # Each direction peaks at roughly 12 bytes/bp (SA + native text copy +
    # bucket/temp buffers; the bucket sort's counts are at most 0.54 GB,
    # whatever the core count), so overlap doubles that; fall back to
    # sequential when 2x would not fit in free host RAM (the 4.29 Gbp
    # ceiling regime).
    overlap = True
    try:
        with open("/proc/meminfo") as mf:
            avail_kb = next(int(line.split()[1]) for line in mf
                            if line.startswith("MemAvailable"))
        overlap = 2 * 12 * n < avail_kb * 1024 * 0.9
    except Exception:
        overlap = n < 2_000_000_000
    threads = max(1, _cores() // 2) if overlap else _cores()

    def bwt_of(text: np.ndarray, direction: str):
        """BWT rows of text+'$' with '$' slot as code 0.

        Returns (bwt codes (big,), dollar row, sa (n,)). One parallel
        native gather (``suffix.bwt_rows``): a GRCh38-scale build must not
        allocate int64 temporaries of the whole text beyond the SA itself."""
        t0 = time.time()
        sa = suffix_array(text, method=sa_method, threads=threads)
        logger.verbose_msg(f"build: {direction} suffix array of {n} bases "
                           f"in {time.time() - t0:.1f} s")
        bwt_codes, dollar_row = bwt_rows(text, sa, threads=threads)
        return bwt_codes, dollar_row, sa

    f = int(sa_sparseness)

    def build_fwd():
        bwt_codes, dollar_fwd, sa = bwt_of(codes, "forward")
        occ = _occ_checkpoints(bwt_codes, big, threads)
        # sparse SA sampling over sa_full = [n] + sa, in parallel chunks
        sampled = np.empty(big, dtype=bool)
        sampled[0] = (n % f) == 0
        spans = _spans(n, ROW_SPAN)

        def mark(lo, hi):
            np.equal(sa[lo:hi] % f, 0, out=sampled[lo + 1:hi + 1])
            return int(np.count_nonzero(sampled[lo + 1:hi + 1]))

        at = np.cumsum([int(sampled[0])] + _each(mark, spans, threads))
        sa_samples = np.empty(int(at[-1]), dtype=np.uint32)
        if sampled[0]:
            sa_samples[0] = n

        def take(lo, hi):
            w = int(at[lo // ROW_SPAN])
            vals = sa[lo:hi][sampled[lo + 1:hi + 1]]
            sa_samples[w:w + len(vals)] = vals

        _each(take, spans, threads)
        sa_bits, sa_bits_rank = _pack_bits(sampled, threads)
        return bwt_codes, dollar_fwd, occ, sa_samples, sa_bits, sa_bits_rank

    def build_rev():
        rcodes = codes[::-1].copy()
        rbwt_codes, dollar_rev, rsa = bwt_of(rcodes, "reverse")
        del rsa, rcodes
        rocc = _occ_checkpoints(rbwt_codes, big, threads)
        return rbwt_codes, dollar_rev, rocc

    if overlap:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(2) as pool:
            fut_fwd = pool.submit(build_fwd)
            fut_rev = pool.submit(build_rev)
            bwt_codes, dollar_fwd, occ, sa_samples, sa_bits, sa_bits_rank = \
                fut_fwd.result()
            rbwt_codes, dollar_rev, rocc = fut_rev.result()
    else:
        bwt_codes, dollar_fwd, occ, sa_samples, sa_bits, sa_bits_rank = \
            build_fwd()
        rbwt_codes, dollar_rev, rocc = build_rev()

    # chunked: bincount widens its input to int64 (8 B a base)
    char_counts = np.zeros(4, dtype=np.int64)
    for lo, hi in _spans(n, ROW_SPAN):
        char_counts += np.bincount(codes[lo:hi], minlength=4)
    counts = np.zeros(4, dtype=np.int64)
    counts[0] = 1  # '$'
    np.cumsum(char_counts[:-1], out=counts[1:])
    counts[1:] += 1

    if seq_names is None:
        seq_names = ["seq0"]
        seq_starts = np.array([0, n], dtype=np.int64)

    meta = {
        "format_version": INDEX_FORMAT_VERSION,
        "n": n,
        "dollar_fwd": dollar_fwd,
        "dollar_rev": dollar_rev,
        "sa_sparseness": f,
        "num_seqs": len(seq_names),
    }
    return IndexArrays(
        meta=meta,
        text=pack_2bit(codes),
        bwt=pack_2bit(_pad_to_blocks(bwt_codes)),
        rbwt=pack_2bit(_pad_to_blocks(rbwt_codes)),
        occ=occ,
        rocc=rocc,
        counts=counts.astype(np.uint32),
        sa_samples=sa_samples,
        sa_bits=sa_bits,
        sa_bits_rank=sa_bits_rank,
        seq_starts=np.asarray(seq_starts, dtype=np.int64),
        seq_names=list(seq_names),
    )


def _pad_to_blocks(codes: np.ndarray) -> np.ndarray:
    n = len(codes)
    blocks = (n >> 7) + 1
    out = np.zeros(blocks * BLOCK, dtype=np.uint8)
    out[:n] = codes
    return out


def build_index(
    fasta_paths: list[str] | str,
    out_dir: str | None = None,
    sa_sparseness: int = 4,
    seed: int = 42,
    sa_method: str = "auto",
    write_preprocessed_fasta: bool = False,
    seed_length: int = 100,
) -> IndexArrays:
    """End-to-end: FASTA file(s) -> index arrays (optionally persisted)."""
    if isinstance(fasta_paths, str):
        fasta_paths = [fasta_paths]
    t0 = time.time()
    codes, names, starts = preprocess_fasta(fasta_paths, seed=seed,
                                            seed_length=seed_length)
    logger.verbose_msg(f"build: FASTA parsed in {time.time() - t0:.1f} s")
    t0 = time.time()
    idx = build_index_from_codes(
        codes, names, starts, sa_sparseness=sa_sparseness, sa_method=sa_method
    )
    logger.verbose_msg(f"build: index arrays in {time.time() - t0:.1f} s")
    if out_dir is not None:
        t0 = time.time()
        save_index(idx, out_dir)
        logger.verbose_msg(f"build: saved in {time.time() - t0:.1f} s")
        if write_preprocessed_fasta:
            write_fasta_back(codes, names, starts, os.path.join(out_dir, "preprocessed.fa"))
    return idx


def write_fasta_back(codes, names, starts, path, width: int = 80) -> None:
    with open(path, "w") as f:
        for i, name in enumerate(names):
            f.write(f">{name}\n")
            seq = alphabet.decode(codes[starts[i]:starts[i + 1]])
            for j in range(0, len(seq), width):
                f.write(seq[j:j + width] + "\n")


_ARRAY_FIELDS = [
    "text", "bwt", "rbwt", "occ", "rocc", "counts",
    "sa_samples", "sa_bits", "sa_bits_rank", "seq_starts",
]


def save_index(idx: IndexArrays, out_dir: str) -> None:
    os.makedirs(out_dir, exist_ok=True)
    for name in _ARRAY_FIELDS:
        np.save(os.path.join(out_dir, name + ".npy"), getattr(idx, name))
    meta = dict(idx.meta)
    meta["seq_names"] = idx.seq_names
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)


def subsample_sa(idx: IndexArrays, sa_sparseness: int) -> IndexArrays:
    """Derive a coarser SA sampling from a built index in place of a
    rebuild: rows sampled at f generalize to any multiple F (SA[i] % F == 0
    implies SA[i] % f == 0). The reference instead persists one file per
    sparseness (-a, src/buildindex.cpp:1902-1918); a single fine sampling +
    on-load subsample covers the same -s sweep from one build."""
    f = int(idx.meta["sa_sparseness"])
    F = int(sa_sparseness)
    if F == f:
        return idx
    if F % f != 0:
        raise ValueError(
            f"requested sparseness {F} not a multiple of built {f}")
    keep = (idx.sa_samples % F) == 0
    big = idx.meta["n"] + 1
    # rows whose bit is set, in order, correspond to sa_samples entries
    words = idx.sa_bits.astype(np.uint32)
    bits = ((words[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
            ).astype(bool).reshape(-1)[:big]
    rows = np.nonzero(bits)[0]
    new_bits = np.zeros(big, bool)
    new_bits[rows[keep]] = True
    sa_bits, sa_bits_rank = _pack_bits(new_bits)
    meta = dict(idx.meta)
    meta["sa_sparseness"] = F
    from dataclasses import replace

    return replace(idx, meta=meta, sa_samples=idx.sa_samples[keep],
                   sa_bits=sa_bits, sa_bits_rank=sa_bits_rank)


def load_index(out_dir: str) -> IndexArrays:
    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format_version") != INDEX_FORMAT_VERSION:
        raise ValueError(
            f"index format {meta.get('format_version')} != {INDEX_FORMAT_VERSION};"
            " rebuild the index"
        )
    seq_names = meta.pop("seq_names")
    arrays = {
        name: np.load(os.path.join(out_dir, name + ".npy")) for name in _ARRAY_FIELDS
    }
    return IndexArrays(meta=meta, seq_names=seq_names, **arrays)
