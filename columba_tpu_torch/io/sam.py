"""SAM output on the host: the header, the banded DP with traceback
(per record, and batched over a whole emission chunk), the MAPQ rule and
the record lines (reference: src/indexhelpers.cpp:56-260 ``TextOcc`` SAM
line generation, src/bitparallelmatrix.h). The native emitter
(``io/emit.py``) writes the same records in C++; the Python emitters
(``strategy.emit_sam``, ``strategy.emit_sam_textless``,
``paired.emit_sam_paired``) format them with :func:`record` and
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


def traceback_batch(patterns, windows, kb: int):
    """Batched host traceback: one vectorized DP per read-length group.

    patterns/windows: sequences of 1-D code arrays (len(window) <= len(
    pattern)+kb). Returns a list of (begin_col, cigar, ed) per entry with
    IDENTICAL results to traceback() — the per-cell DP and the backward
    walk's tie order are the same; only the row computation is batched.
    Exact diagonal matches short-circuit to "<m>M" (provably what the
    walk produces when ed == 0).
    """
    out = [None] * len(patterns)
    if not patterns:
        return out
    if kb == 0:
        for i, (p, w) in enumerate(zip(patterns, windows)):
            out[i] = traceback(p, w, len(w), kb)
        return out
    groups: dict[int, list[int]] = {}
    for i, p in enumerate(patterns):
        groups.setdefault(len(p), []).append(i)
    for m, idxs in groups.items():
        t = m + kb  # left-padded window length
        B = len(idxs)
        pat = np.stack([patterns[i] for i in idxs]).astype(np.int16)
        text = np.full((B, t), 5, np.int16)  # 5 = pad, mismatches all
        pads = np.empty(B, np.int32)
        for bi, i in enumerate(idxs):
            w = windows[i]
            pads[bi] = t - len(w)
            text[bi, t - len(w):] = w
        # exact-diagonal shortcut
        diag = text[:, kb:]
        exact = ((diag == pat) & (pat <= 3)).all(axis=1) & (pads <= kb)
        todo_all = np.nonzero(~exact)[0]
        for bi in np.nonzero(exact)[0]:
            out[idxs[bi]] = (kb - int(pads[bi]), f"{m}M", 0)
        if todo_all.size == 0:
            continue
        # sub-batch: the DP tensor is (m+1, Bc, t+1) int16 — bound the
        # transient allocation on repeat-heavy workloads
        CHUNK = 8192
        for c0 in range(0, todo_all.size, CHUNK):
            _traceback_chunk(out, idxs, pat, text, pads,
                             todo_all[c0:c0 + CHUNK], m, t, kb)
    return out


def _traceback_chunk(out, idxs, pat, text, pads, todo, m, t, kb):
    patc, textc = pat[todo], text[todo]
    Bc = todo.size
    D = np.zeros((m + 1, Bc, t + 1), np.int16)
    D[:, :, 0] = np.arange(m + 1, dtype=np.int16)[:, None]
    col = np.arange(1, t + 1, dtype=np.int16)
    bad = textc > 3
    for j in range(1, m + 1):
        pj = patc[:, j - 1:j]
        mis = ((textc != pj) | (pj > 3) | bad).astype(np.int16)
        best = np.minimum(D[j - 1, :, :-1] + mis, D[j - 1, :, 1:] + 1)
        run = best - col
        np.minimum.accumulate(run, axis=1, out=run)
        D[j, :, 1:] = np.minimum(np.minimum(best, run + col),
                                 D[j, :, 0:1] + col)
    # lockstep backward walk over all remaining records: each step
    # picks I/M/D per lane with the reference's insertion-first tie
    # order; a lane halts at j == 0. <= m + t steps total.
    lanes = np.arange(Bc)
    j = np.full(Bc, m, np.int32)
    c = np.full(Bc, t, np.int32)
    ops_mat = np.zeros((m + t, Bc), np.int8)  # 0 none, 1 I, 2 M, 3 D
    n_ops = np.zeros(Bc, np.int32)
    for _ in range(m + t):
        livew = j > 0
        if not livew.any():
            break
        jc = np.clip(j, 1, m)
        cc = np.clip(c, 0, t)
        d_cur = D[jc, lanes, cc]
        is_i = D[jc - 1, lanes, cc] + 1 == d_cur
        ccm = np.clip(cc - 1, 0, t)
        pj = patc[lanes, jc - 1]
        tc = textc[lanes, ccm]
        mis = ((pj != tc) | (pj > 3)).astype(np.int16)
        is_m = (~is_i) & (cc > 0) & (
            D[jc - 1, lanes, ccm] + mis == d_cur)
        op = np.where(is_i, 1, np.where(is_m, 2, 3)).astype(np.int8)
        op = np.where(livew, op, 0)
        ops_mat[n_ops, lanes] = op
        n_ops += livew
        j = np.where(livew & (op != 3), j - 1, j)
        c = np.where(livew & (op != 1), c - 1, c)
    OPC = "?IMD"
    for bi_pos, bi in enumerate(todo):
        i = idxs[bi]
        ed = int(D[m, bi_pos, t])
        seq = ops_mat[:n_ops[bi_pos], bi_pos][::-1]
        # run-length encode via change points
        chg = np.flatnonzero(np.diff(seq)) + 1
        bounds = np.concatenate([[0], chg, [len(seq)]])
        cigar = "".join(
            f"{bounds[x+1]-bounds[x]}{OPC[seq[bounds[x]]]}"
            for x in range(len(bounds) - 1))
        out[i] = (int(c[bi_pos]) - int(pads[bi]), cigar, ed)


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
