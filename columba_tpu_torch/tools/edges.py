"""Synthetic edge inputs of kernel L (the dedup's keys, radix passes and
compaction) and of kernel K's frontier_tail entry (kernel J's tail folded
into the candidates' launch), and their check against the plain versions.

Used by ``chip_smoke.py`` and by the tests (``tests/test_torch_kernels.py``
on the card; ``tests/test_torch_frontier_kernels.py`` holds the plain
versions on the same inputs to the JAX package on the CPU). Inputs are
made with numpy from a seed; nothing here needs JAX.
"""

from __future__ import annotations

import numpy as np
import torch

# kernel L's edges: a mask that is no prefix, no valid row, duplicates on
# both sides of a valid prefix's end, windows below 0, windows past 2^31
# and within a few bases of 2^32, read rows that are no power of two with
# rids up to the last, one row, more unique pairs than max_verify; and
# "se_all", SE ALL's sizes (the card's checks only)
DEDUP_CASES = ("duplicates", "past_max_verify", "negative", "none_valid",
               "prefix_dups", "past_2_31", "rows_odd", "one_row")
LIBRARY_SORTS = ("sort", "argsort", "unique", "searchsorted")


def dedup_case(case: str):
    """(rid, win, valid, max_verify, rows, total) of a kernel L edge, as
    CPU tensors; ``total`` (a () int64) where ``valid`` is the prefix
    [0, min(total, L)), else None."""
    rng = np.random.default_rng(80 + (DEDUP_CASES + ("se_all",)).index(case))
    L, rows, mv, total = 400, 200, 512, None
    rid = rng.integers(0, rows, L)
    win = rng.integers(0, 1 << 20, L)
    valid = rng.random(L) < 0.8
    if case == "duplicates":
        rows = 8
        rid, win = rng.integers(0, rows, L), rng.integers(0, 5, L)
    elif case == "past_max_verify":
        mv = 64
    elif case == "negative":
        win = rng.integers(-40, 40, L)
    elif case == "none_valid":
        valid[:] = False
    elif case == "prefix_dups":
        # the rows just past the prefix repeat the pairs just before it
        total = 250
        rid, win = rng.integers(0, 6, L), rng.integers(0, 7, L)
        rid[250:270], win[250:270] = rid[230:250], win[230:250]
    elif case == "past_2_31":
        win = rng.choice(np.array([(1 << 31) - 2, (1 << 31) + 3,
                                   (1 << 32) - 3, (1 << 32) - 1, -1, -2,
                                   (1 << 31) + 12345, 7]), L)
        rid = rng.integers(0, 3, L)
    elif case == "rows_odd":
        rows = 100
        rid = rng.integers(90, rows, L)
    elif case == "one_row":
        L = 1
        rid, win, valid = rid[:1], win[:1], np.ones(1, bool)
    elif case == "se_all":
        # SE ALL's sizes: 32,768 read rows, max_locate = max_verify =
        # 131,072, a valid prefix of 34 % with repeats
        L, rows, mv, total = 131_072, 32_768, 131_072, 45_000
        rid = rng.integers(0, rows, L)
        win = rng.integers(-2, 128_000_000, L)
        rid[1000:3000], win[1000:3000] = rid[:2000], win[:2000]
    else:
        raise ValueError(f"no dedup case {case}")
    if total is not None:
        valid = np.arange(L) < total
    t = lambda x: torch.from_numpy(np.asarray(x, np.int64))  # noqa: E731
    return (t(rid), t(win), torch.from_numpy(valid), mv, rows,
            None if total is None else torch.tensor(total))


def dedup_entries(rid, win, valid, mv, rows, total):
    """stage_dedup as the card runs it, through the plain versions of its
    entries: the keys, one pass a digit, the compaction."""
    from columba_tpu_torch.search import pipeline

    L = rid.shape[0]
    key = [torch.full((L,), -7, dtype=torch.int64, device=rid.device)
           for _ in range(2)]
    row = [torch.full((L,), -7, dtype=torch.int32, device=rid.device)
           for _ in range(2)]
    n, starts, outs = pipeline.dedup_keys_plain(rid, win, valid, mv, key[0],
                                                row[0], rows, total)
    P = starts.shape[0]
    for p in range(P):
        pipeline.dedup_pass_plain(key[p % 2], row[p % 2], n, starts, p,
                                  key[1 - p % 2], row[1 - p % 2])
    return pipeline.dedup_compact_plain(key[P % 2], row[P % 2], n, win, outs)


class _Refused:
    """``torch.sort``, ``argsort``, ``unique`` and ``searchsorted`` patched
    to raise inside the block."""

    def __enter__(self):
        self.saved = {n: getattr(torch, n) for n in LIBRARY_SORTS}

        def refuse(name):
            def call(*_, **__):
                raise AssertionError(f"torch.{name} on the card's path")
            return call
        for n in LIBRARY_SORTS:
            setattr(torch, n, refuse(n))

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(torch, n, fn)


def dedup_vs_plain(case: str, device) -> dict:
    """Kernel L's keys (with the prefix count, where the case has one, and
    with the mask), each pass and the compaction against their plain
    versions on the same inputs, and ``stage_dedup`` on the card (no
    library sort: ``torch.sort`` and kin raise) against
    ``stage_dedup_plain``; raises AssertionError on a difference. Returns
    the case's rows, passes, valid rows and unique pairs."""
    from columba_tpu_torch.search import pipeline

    rid, win, valid, mv, rows, total = dedup_case(case)
    want = pipeline.stage_dedup_plain(rid, win, valid, mv, rows)
    g = [x.to(device) for x in (rid, win, valid)]
    L = rid.shape[0]

    def bufs():
        return (torch.full((L,), -7, dtype=torch.int64, device=device),
                torch.full((L,), -7, dtype=torch.int32, device=device))

    def slots():
        return tuple(torch.full((mv,), 3, dtype=dt, device=device)
                     for dt in (torch.int64, torch.int64, torch.bool))

    def same(a, b, what):
        torch.cuda.synchronize()
        for x, y in zip(a, b):
            if not torch.equal(x.cpu(), y.cpu()):
                raise AssertionError(f"kernel L {what} differs from its "
                                     f"plain version on {case}")

    for tot in [None] + ([total.to(device)] if total is not None else []):
        (k1, r1), (k2, r2) = bufs(), bufs()
        a = pipeline.dedup_keys(*g, mv, k1, r1, rows, tot)
        b = pipeline.dedup_keys_plain(*g, mv, k2, r2, rows, tot)
        same((k1, r1, a[0], a[1], *a[2]), (k2, r2, b[0], b[1], *b[2]),
             "keys" + (" (prefix)" if tot is not None else " (mask)"))
        n, starts = a[0], a[1]
        key, row = k1, r1
        for p in range(starts.shape[0]):
            (ko1, ro1), (ko2, ro2) = bufs(), bufs()
            pipeline.dedup_pass(key, row, n, starts, p, ko1, ro1)
            pipeline.dedup_pass_plain(key, row, n, starts, p, ko2, ro2)
            same((ko1, ro1), (ko2, ro2), f"pass {p}")
            key, row = ko1, ro1
        same(pipeline.dedup_compact(key, row, n, g[1], slots()),
             pipeline.dedup_compact_plain(key, row, n, g[1], slots()),
             "compact")
        with _Refused():
            got = pipeline.stage_dedup(*g, mv, rows, tot)
            torch.cuda.synchronize()
        same(got, want, "stage_dedup")
    return dict(rows=rows, passes=int(starts.shape[0]), L=L,
                valid=int(valid.sum()), n_unique=int(want[3]))


def tail_frontier(rng, C, M, moved, R, S, device, bw=5, W=2):
    """A deferred final frontier (``run_scheme(defer_tail=True)``'s
    result) of C rows, a quarter past the live count, ghosts among the
    live rows, an in-text buffer of M + 1 rows holding M // 3, and static
    tables (t_back, pivot, final_reg, u_last) of S searches."""
    from columba_tpu_torch.search import executor

    lo = rng.integers(0, 1 << 31, C)
    ranges = np.stack([lo, lo + rng.integers(0, 6, C), lo, lo + 3], 1)
    lane = rng.integers(0, R * S, C)
    ids = np.where(rng.random(C) < 0.2,
                   lane | (rng.integers(0, 60, C) << 21) | (1 << 31), lane)
    itv = np.zeros((M + 1, 4), np.int64)
    itv[:, 0] = rng.integers(0, 1 << 31, M + 1)
    itv[:, 1] = itv[:, 0] + rng.integers(0, 5, M + 1)
    itv[:, 2] = rng.integers(0, R * S, M + 1)
    itv[:, 3] = rng.integers(0, 60, M + 1)
    words = np.zeros(executor.RUN_WORDS, np.int64)
    words[0] = (M // 3) << 32 | 17
    words[2] = 5

    def t(x, dt=torch.int64):
        return torch.from_numpy(np.asarray(x)).to(dt).to(device)

    state = [t(ranges), t(ids.astype(np.int64), torch.int32),
             t(rng.integers(0, 9, (C, 2, bw)), torch.int8),
             t(rng.integers(0, 4, (C, 2, W)), torch.int8)]

    def out(dt):
        return torch.empty(C, dtype=dt, device=device)

    itv_t, words_t = t(itv), t(words)
    res = executor.FrontierResult(
        ranges=state[0], rid=out(torch.int64), sid=out(torch.int64),
        ed_lb=out(torch.int64), done=out(torch.bool), overflow=words_t[7],
        nodes_visited=words_t[1], itv=itv_t[:M], itv_count=words_t[6],
        searches_started=words_t[5], arg_b=out(torch.int8),
        tail=dict(state=state, live=(3 * C) // 4, moved=moved, itv=itv_t,
                  words=words_t, shrink=3, S=S, W=W,
                  final_reg=t(rng.integers(0, W, (S, 2))),
                  u_last=t(rng.integers(2, 6, S))))
    tables = dict(t_back=t(rng.integers(20, 70, S)),
                  pivot=t(rng.integers(0, 60, S)))
    return res, tables


def frontier_tail_vs_plain(C: int, M: int, moved: bool, device,
                           R: int = 32_768, S: int = 3,
                           max_locate: int = 4096) -> dict:
    """Kernel K's frontier_tail entry against ``frontier_tail_plain`` then
    ``stage_candidates_plain`` on copies of one synthetic deferred
    frontier (:func:`tail_frontier`): the candidates, J's outputs, the
    frontier's rows, the in-text rows and the counter words must be equal;
    raises AssertionError where they differ. Returns the ghost count."""
    from columba_tpu_torch.search import pipeline
    from columba_tpu_torch.tools.path_inputs import copies

    rng = np.random.default_rng(C + M + moved)
    base, tables = tail_frontier(rng, C, M, moved, R, S, device)
    got_res, want_res = copies(base), copies(base)
    got = pipeline.stage_tail_candidates(got_res, tables, S, max_locate)
    want = pipeline.stage_tail_candidates_plain(want_res, tables, S,
                                                max_locate)
    torch.cuda.synchronize()
    gt, wt = got_res.tail, want_res.tail
    pairs = [*zip(got, want), (gt["itv"][:M], wt["itv"][:M]),
             (gt["words"], wt["words"]), *zip(gt["state"], wt["state"])]
    pairs += [(getattr(got_res, f), getattr(want_res, f))
              for f in ("rid", "sid", "ed_lb", "done", "arg_b")]
    for k, (a, b) in enumerate(pairs):
        if not torch.equal(a, b):
            raise AssertionError(f"kernel K's frontier_tail differs from "
                                 f"its plain versions (output {k}; C = {C}, "
                                 f"M = {M}, moved {moved})")
    return dict(ghosts=int(wt["words"][6]) - (int(wt["words"][0]) >> 32))
