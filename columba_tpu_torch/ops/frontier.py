"""Kernels I and J's C entry points (``csrc/frontier.cu``).

Declared here, below both layers that launch them: the index layer's
``kmer.lookup`` (entry ``lookup``) and the search layer's frontier wrappers
(``search/executor.py``: ``seed``, ``drain``, ``init``, ``ex_compact``,
``ex_back``, ``tail``). ``SCAN_ARGS`` are the trailing arguments of every
entry that scans with the shared look-back (kernels I, J, K and L);
``WIDE_TILE`` lanes make a tile of the multi-lane scans (kernel I's
``drain``, ``init`` and ``ex_compact``, kernel K's ``frontier``,
``frontier_tail`` and ``ranges``, kernel L's ``keys`` and ``compact``: 512
threads of 2 lanes), ``SCAN_TILE`` of the one-lane scans (kernel J's
``tail``).
"""

from __future__ import annotations

import ctypes

from columba_tpu_torch import native

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
SCAN_ARGS = [_P, _P, _I64, ctypes.c_uint32]      # ticket, status, tiles, epoch
# kThreads of the one-lane scans: csrc/frontier.cu tail
SCAN_TILE = 256
WIDE_TILE = 2 * 512      # kTile of csrc/frontier.cu and expand.cu
FRONTIER = native.Kernel(
    "frontier", "columba_frontier_seed",
    [_P, _I64, _I32, _I32, _I32,                  # reads, R, m, S, K
     _P, _P, _P, _P, _I32, _I32,                  # table, kstart, mask, full,
                                                  # rw, zero_empty
     _P, _P, _I32],                               # ranges, clears, n_clears
    source="columba_tpu_torch/csrc/frontier.cu",
    replaces="columba_tpu/index/kmer.py:91",
    symbols={
        "drain": ("columba_frontier_drain",
                  [_P, _I64, _P, _I64, _P, *SCAN_ARGS]),
        "init": ("columba_frontier_init",
                 [_P, _I64, _I32, _I32, _I32,     # ranges0, L, rw, S, sw
                  _P, _P, _P, _I32,               # db, band, colmin inits,
                                                  # per lane
                  _I32, _I32, _I32, _I64,         # bw, W, Wp, C
                  _P, _P, _P, _P,                 # the frontier's fields
                  _P, _I64, _P, *SCAN_ARGS]),     # itv, M, words
        "ex_compact": ("columba_frontier_ex_compact",
                       [_P, _I64, _I32, _I64, _P, _P, _P, _P, *SCAN_ARGS]),
        "ex_back": ("columba_frontier_ex_back",
                    [_P, _I64, _I32, _P, _P, _P, _P]),
        "tail": ("columba_frontier_tail",
                 [_P, _P, _P, _P, _I64, _I64,     # fields, cap, live
                  _I32, _I32, _I32, _I32, _I32,   # moved, rw, bw, W, Wp
                  _I32, _I32, _P, _P, _P,         # track, S, final_reg,
                                                  # u_last (64 / 32 bit)
                  _P, _I64, _P, _I64,             # itv, M, words, shrink
                  _P, _P, _P, _P, _P,             # rid, sid, ed_lb, done,
                                                  # arg_b
                  *SCAN_ARGS]),
    },
)
