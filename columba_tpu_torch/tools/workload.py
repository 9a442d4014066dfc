"""The smoke and profile workload: a random genome and reads sampled from it.

The genome is uniform random with runs of N, split into equal sequences and
written as FASTA; reads are sampled as ``bench.py`` samples them (uniform
loci inside one sequence, substitutions at a fixed rate, half
reverse-complemented) and written as FASTQ. Everything comes from the
numpy generator passed in, so a seed fixes the workload.
"""

from __future__ import annotations

import numpy as np

GENOME_N = 128_000_000       # bench.py's genome size
N_SEQS = 4
READ_LEN = 100
ERR_RATE = 0.01


def write_genome(path: str, rng, n: int = GENOME_N,
                 n_seqs: int = N_SEQS) -> tuple[np.ndarray, np.ndarray]:
    """Random genome as a FASTA of ``n_seqs`` sequences with 40 runs of N.
    Returns (codes with 4 at N, sequence start offsets)."""
    codes = rng.integers(0, 4, n, dtype=np.uint8)
    for s in rng.integers(0, n - 300, 40):
        codes[s:s + int(rng.integers(10, 300))] = 4
    starts = np.linspace(0, n, n_seqs + 1).astype(np.int64)
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    with open(path, "wb") as f:
        for i in range(n_seqs):
            seq = lut[codes[starts[i]:starts[i + 1]]]
            full = len(seq) // 80 * 80
            lines = np.concatenate([seq[:full].reshape(-1, 80),
                                    np.full((full // 80, 1), 10, np.uint8)],
                                   axis=1)
            f.write(f">chr{i + 1}\n".encode() + lines.tobytes())
            if full < len(seq):
                f.write(seq[full:].tobytes() + b"\n")
    return codes, starts


def sample_reads(text: np.ndarray, starts: np.ndarray, n: int, rng,
                 m: int = READ_LEN, err_rate: float = ERR_RATE):
    """Reads kept inside one sequence. Returns (codes (n, m), begin
    positions, substitution counts, reverse-complemented flags)."""
    seq = rng.integers(0, len(starts) - 1, n)
    lo, hi = starts[seq], starts[seq + 1] - m
    pos = lo + (rng.random(n) * (hi - lo)).astype(np.int64)
    reads = text[pos[:, None] + np.arange(m)[None, :]]
    errs = rng.random((n, m)) < err_rate
    reads = np.where(errs, (reads + rng.integers(1, 4, (n, m))) % 4, reads)
    flip = rng.random(n) < 0.5
    comp = np.array([3, 2, 1, 0], np.uint8)
    reads[flip] = comp[reads[flip]][:, ::-1]
    return reads.astype(np.uint8), pos, errs.sum(axis=1), flip


def write_fastq(path: str, reads: np.ndarray, prefix: str) -> None:
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    qual = "I" * reads.shape[1]
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@{prefix}{i}\n{lut[r].tobytes().decode()}\n+\n{qual}\n")
