"""SAM helpers on the host: the header, and the banded DP with traceback
that cross-boundary trimming re-verifies with (reference:
src/indexhelpers.cpp, src/bitparallelmatrix.h), and the MAPQ rule. The
records themselves are written by the native emitter (``io/emit.py``),
except on the textless RLC index, whose emitter
(``strategy.emit_sam_textless``) formats them with :func:`record` and
:func:`unmapped_record`.
"""

from __future__ import annotations

import math

import numpy as np

from columba_tpu_torch.core import alphabet

MAX_MAPQ = 60  # reference: src/definitions.h


def mapq(n_best: int) -> int:
    """MAPQ = -10 log10(1 - 1/n) capped at 60 (reference indexhelpers.h)."""
    if n_best <= 1:
        return MAX_MAPQ
    v = -10.0 * math.log10(1.0 - 1.0 / n_best)
    return min(MAX_MAPQ, int(round(v)))


def header(seq_names: list[str], seq_lengths: list[int],
           program_name: str = "ColumbaTPU", version: str = "0.1.0",
           command_line: str = "") -> str:
    lines = ["@HD\tVN:1.6\tSO:unsorted"]
    for name, length in zip(seq_names, seq_lengths):
        lines.append(f"@SQ\tSN:{name}\tLN:{length}")
    lines.append(
        f"@PG\tID:{program_name}\tPN:{program_name}\tVN:{version}"
        + (f"\tCL:{command_line}" if command_line else "")
    )
    return "\n".join(lines) + "\n"


def traceback(pattern: np.ndarray, window: np.ndarray, end_col: int,
              kb: int) -> tuple[int, str, int]:
    """Host banded DP + traceback for one occurrence.

    pattern: (m,) codes; window: (W,) text codes; end_col: alignment end
    (exclusive) within window. Returns (begin_col, cigar, ed).
    Tie preference walking backward from the end is insertion > diagonal >
    deletion, exactly mirroring the reference's traceback (HP bit first,
    then match-or-diag-delta-one, then vertical gap;
    reference: src/bitparallelmatrix.h:531-586 and findCIGAR :450-526).
    """
    m = len(pattern)
    if kb == 0:
        begin = end_col - m
        ed = int((pattern != window[begin:end_col]).sum())
        return begin, f"{m}M", ed
    # full DP over [max(0,end-m-kb), end)
    lo = max(0, end_col - m - kb)
    text = window[lo:end_col]
    t = len(text)
    D = np.zeros((m + 1, t + 1), dtype=np.int32)
    D[:, 0] = np.arange(m + 1)
    D[0, :] = 0  # free start
    for j in range(1, m + 1):
        mis = ((text != pattern[j - 1]) | (pattern[j - 1] > 3) | (text > 3)).astype(np.int32)
        diag = D[j - 1, :-1] + mis
        up = D[j - 1, 1:] + 1
        best = np.minimum(diag, up)
        run = best - np.arange(1, t + 1)
        np.minimum.accumulate(run, out=run)
        D[j, 1:] = np.minimum(best, run + np.arange(1, t + 1))
        D[j, 1:] = np.minimum(D[j, 1:], D[j, 0] + np.arange(1, t + 1))
    ed = int(D[m, t])
    # greedy backward walk, insertion-first (reference tie order)
    j, c = m, t
    ops: list[str] = []
    while j > 0:
        if D[j - 1, c] + 1 == D[j, c]:
            op, j = "I", j - 1
        elif c > 0 and D[j - 1, c - 1] + (
                0 if (pattern[j - 1] == text[c - 1] and pattern[j - 1] <= 3)
                else 1) == D[j, c]:
            op, j, c = "M", j - 1, c - 1
        else:
            assert c > 0 and D[j, c - 1] + 1 == D[j, c]
            op, c = "D", c - 1
        ops.append(op)
    begin = lo + c
    ops.reverse()
    # run-length encode
    cigar = []
    for op in ops:
        if cigar and cigar[-1][1] == op:
            cigar[-1][0] += 1
        else:
            cigar.append([1, op])
    return begin, "".join(f"{n}{op}" for n, op in cigar), ed


def best_in_window(pattern: np.ndarray, window: np.ndarray, kb: int):
    """Best full-pattern alignment anywhere in ``window`` (free begin AND
    free end), or None if none scores <= kb.

    Mirrors the reference's one-string in-text re-verification used for
    cross-boundary trimming (src/indexinterface.cpp:850-867 ->
    inTextVerificationOneString; candidate ends = final-column cluster
    centers, winner = min TextOcc, i.e. smallest begin, then distance,
    then width, src/indexhelpers.h:779-795).

    Returns (begin_col, end_col, ed, cigar) relative to window."""
    m = len(pattern)
    t = len(window)
    if t == 0 or m > t + kb:
        return None
    D = np.zeros((m + 1, t + 1), dtype=np.int32)
    D[:, 0] = np.arange(m + 1)
    for j in range(1, m + 1):
        mis = ((window != pattern[j - 1]) | (pattern[j - 1] > 3)
               | (window > 3)).astype(np.int32)
        diag = D[j - 1, :-1] + mis
        up = D[j - 1, 1:] + 1
        best = np.minimum(diag, up)
        run = best - np.arange(1, t + 1)
        np.minimum.accumulate(run, out=run)
        D[j, 1:] = np.minimum(best, run + np.arange(1, t + 1))
        D[j, 1:] = np.minimum(D[j, 1:], D[j, 0] + np.arange(1, t + 1))
    final = D[m]
    # candidate ends: local minima <= kb, leftmost of each plateau
    ok = final <= kb
    left = np.concatenate([[127], final[:-1]])
    right = np.concatenate([final[1:], [127]])
    cand = ok & (final <= left) & (final <= right) & (final != left)
    cand[0] = False
    results = []
    for c in np.nonzero(cand)[0]:
        b, cigar, ed = traceback(pattern, window, int(c), kb)
        results.append((b, ed, int(c) - b, int(c), cigar))
    if not results:
        return None
    b, ed, _, c, cigar = min(results)
    return b, c, ed, cigar


def record(qname: str, flag: int, rname: str, pos1: int, mq: int, cigar: str,
           seq_codes: np.ndarray, qual: str, distance: int) -> str:
    seq = alphabet.decode(seq_codes)
    return (
        f"{qname}\t{flag}\t{rname}\t{pos1}\t{mq}\t{cigar}\t*\t0\t0\t"
        f"{seq}\t{qual}\tAS:i:{distance}\tNM:i:{distance}\tPG:Z:Columba\n"
    )


def unmapped_record(qname: str, seq_codes: np.ndarray, qual: str) -> str:
    seq = alphabet.decode(seq_codes)
    return f"{qname}\t4\t*\t0\t0\t*\t*\t0\t0\t{seq}\t{qual}\tPG:Z:Columba\n"
