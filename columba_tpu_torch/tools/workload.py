"""The smoke and profile workload: a random genome and reads sampled from it.

The genome is uniform random with runs of N, split into equal sequences and
written as FASTA. The repeat-rich one of the RLC index (:func:`pan_genome`)
is a pan-genome of 20 near-identical haplotypes in one sequence. Reads are
sampled as ``bench.py`` samples them (uniform
loci inside one sequence, substitutions at a fixed rate, half
reverse-complemented) and written as FASTQ. Pairs are the two ends of
fragments sampled the same way (``fr``: mate 1 forward at the fragment's
start, mate 2 reverse-complemented at its end; half of the fragments come
from the reverse strand, which swaps the mates). Everything comes from the
numpy generator passed in, so a seed fixes the workload.
"""

from __future__ import annotations

import numpy as np

GENOME_N = 128_000_000       # bench.py's genome size
N_SEQS = 4
READ_LEN = 100
ERR_RATE = 0.01
PAN_SEED = 20260820          # the JAX package's pan-genome seed
PAN_HAPLOTYPES = 20
PAN_SNP_RATE = 0.001


def pan_genome(n: int = GENOME_N) -> np.ndarray:
    """Repeat-rich pan-genome: a random base of n / 20 bp and 19 copies of
    it, each with 0.1 % SNPs, concatenated (every locus occurs about 20
    times). The construction, seed and draws of the JAX package's
    ``tools/bench_matrix.py:63-88`` (``pan_genome``), so the same genome.
    Returns uint8 codes 0..3."""
    base_n = n // PAN_HAPLOTYPES
    rng = np.random.default_rng(PAN_SEED)
    base = rng.integers(0, 4, size=base_n).astype(np.uint8)
    haps = [base]
    for _ in range(PAN_HAPLOTYPES - 1):
        h = base.copy()
        snps = rng.random(base_n) < PAN_SNP_RATE
        h[snps] = (h[snps] + rng.integers(1, 4, snps.sum())) % 4
        haps.append(h)
    return np.concatenate(haps)


def write_fasta(path: str, codes: np.ndarray, name: str = "pan") -> None:
    """One sequence as FASTA, 80 bases a line."""
    lut = np.frombuffer(b"ACGTN", dtype=np.uint8)
    seq = lut[codes]
    full = len(seq) // 80 * 80
    lines = np.concatenate([seq[:full].reshape(-1, 80),
                            np.full((full // 80, 1), 10, np.uint8)], axis=1)
    with open(path, "wb") as f:
        f.write(f">{name}\n".encode() + lines.tobytes())
        if full < len(seq):
            f.write(seq[full:].tobytes() + b"\n")


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


def sample_pairs(text: np.ndarray, starts: np.ndarray, n: int, rng,
                 m: int = READ_LEN, err_rate: float = ERR_RATE,
                 frag_min: int = 200, frag_max: int = 450):
    """``fr`` pairs of ``m`` bp mates from fragments kept inside one
    sequence, fragment lengths uniform in [frag_min, frag_max]. Returns
    (mate-1 codes (n, m), mate-2 codes (n, m), begin of the forward-strand
    mate, begin of the reverse-strand mate, substitution counts of mate 1
    and of mate 2, swapped flags). Where ``swapped`` is false mate 1 is the
    forward-strand one, else mate 2."""
    comp = np.array([3, 2, 1, 0], np.uint8)
    frag = rng.integers(frag_min, frag_max + 1, n)
    seq = rng.integers(0, len(starts) - 1, n)
    lo, hi = starts[seq], starts[seq + 1] - frag
    pos_f = lo + (rng.random(n) * (hi - lo)).astype(np.int64)
    pos_r = pos_f + frag - m
    cols = np.arange(m)[None, :]
    mates = []
    for pos in (pos_f, pos_r):
        reads = text[pos[:, None] + cols]
        errs = rng.random((n, m)) < err_rate
        reads = np.where(errs, (reads + rng.integers(1, 4, (n, m))) % 4,
                         reads).astype(np.uint8)
        mates.append((reads, errs.sum(axis=1)))
    (fwd, nsub_f), (rev, nsub_r) = mates
    rev = comp[rev][:, ::-1]
    swapped = rng.random(n) < 0.5
    sw = swapped[:, None]
    return (np.where(sw, rev, fwd), np.where(sw, fwd, rev), pos_f, pos_r,
            np.where(swapped, nsub_r, nsub_f),
            np.where(swapped, nsub_f, nsub_r), swapped)


def write_fastq(path: str, reads: np.ndarray, prefix: str) -> None:
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    qual = "I" * reads.shape[1]
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@{prefix}{i}\n{lut[r].tobytes().decode()}\n+\n{qual}\n")
