"""Smoke run of the PyTorch port on one NVIDIA GPU.

Run from the repository root with ``python3 chip_smoke.py`` on a machine with
a CUDA device. It

1. prints the card (torch name, and nvidia-smi's name and power limit);
2. builds the eleven CUDA kernels from ``columba_tpu_torch/csrc`` into
   ``columba_tpu_torch/_build`` (one nvcc per source, started together,
   each source's seconds printed; kernel B's RLC and textless entries and
   its quad body's static and per-lane instances are sources of their own)
   and prints ptxas's registers and spills per entry, failing if any entry
   but kernel B's generic one keeps a stack frame (local memory), the quad
   body's 25 instances (every RW 4 shape at kb 8-13) included, or if one of
   those is missing;
3. generates a random genome from a fixed seed (128 Mbp in 4 sequences, with
   runs of N), writes it as FASTA and builds the index with the port's
   ``cli build`` (default SA sparseness 4, so locate walks LF);
4. runs each kernel on the card at the paths' shapes and holds it against
   its plain PyTorch version on the same tensors (exact equality: all the
   arithmetic is integer), timing both with CUDA events, and works out the
   least time the card could take for the same call
   (``columba_tpu_torch/tools/bounds.py``). Kernel B is one fused band
   step (the lanes' arithmetic, the drain to the in-text buffer and the
   compaction of the next frontier): it is compared on every field it
   leaves (the next frontier's live rows, the in-text rows and count, kept
   children, visits, overflow), at the main path's shape, at the other
   band radii the paths reach, through its generic entry, and, in each of
   its Vanilla, per-lane, RLC and textless entries, on a step that
   overflows both the frontier and the in-text buffer. Kernel
   A's loop entry (the whole exact prefix in one launch) runs on the main
   path's seeded lanes and on the band-only path's second stage; kernel D
   at kb 0, 4, 5, 7 and 13 (its 32- and 64-bit bands); kernel F (dynamic
   partitioning) with and without the seed table, kernel G (per-read
   tables) on F's boundaries, kernel B's per-lane entry at kb 2 and 4 and
   kernel A's loop on G's tables, kernel E with per-row lengths on the part
   patterns of scheme selection, and kernel H (the row gather) at 262,144
   lanes beside ``torch.index_select``; every entry of kernels I-L (the
   seeds, drain, init, two-stage compaction and tail around kernels A and
   B; the candidates' expansion, with kernel J's tail folded into its
   launch on ``match_device_core``; the dedup's keys, radix passes and
   compaction) on one ``match_device_core`` call at the SE ALL path's
   sizes, on the band-only call, the k = 0 pass, a k-mer lookup and (J's
   own entry) ``run_scheme``, each held to its plain version on copies of
   its inputs (``tools/path_inputs.py`` ``capture_entries``) and timed,
   kernel K's ``ranges`` and ``rows`` beside the one PyTorch call of the
   same function (``torch.cumsum``, ``torch.searchsorted``) and kernel
   L's passes beside ``torch.sort``; kernel L's and K's ``frontier_tail``
   entries on synthetic edges (``tools/edges.py``: masks, windows below 0
   and near 2^32, odd read counts, no valid row, one row, a move or none,
   with ``torch.sort`` and kin patched to raise); then the launch census
   of that call outside kernel B's band steps (``torch.profiler``: at most
   20, no library sort). Kernel B's static entries read each
   lane's cells at use from the reads and the schedule's cell tables
   (``executor.StaticCells``); every path prints the device bytes kernel
   I's seed allocated a ``run_scheme`` call beside the lanes' ranges and
   fails if that reaches the (L x T, BW) cell array's size (no such array
   on the card);
5. builds the 10-mer seed table (kernel A's table entry, one launch,
   counted as the path ``kmer_table``; held to the ten-launch build of its
   plain version and timed among the kernel checks) and drives eight paths
   through ``cli align``, each
   with every kernel's launch count reset just before and read just after
   (and kernel A's loop launches per ``run_scheme`` call printed), with its
   peak device memory:

   - SE ALL: ``-a all -e 2 -S kuch1 -b 16384`` on 65,536 sampled 100 bp reads
     (1% substitutions, half reverse-complemented);
   - SE BEST: ``-a best -S kuch1 -b 16384`` (the cutoff is 4) on 131,072 reads;
   - PE BEST: ``-a best -F ...`` with default flags (insert inference on,
     rungs (0,0) -> (2,2) -> (4,4)) on 131,072 ``fr`` pairs of 100 bp mates;
   - PE ALL at ``-e 0`` on the pairs sampled without a substitution, which
     takes the exact pass (kernel E) on both sides;
   - PE ALL at ``-e 2`` on the first 32,768 pairs: the band-only path (no
     in-text crossover, half-size frontier, two-stage exact loop);
   - SE ALL ``-p dynamic -e 2`` on the SE ALL path's FASTQ: kernels F and G
     and kernel B's per-lane entry; its records must be those of SE ALL,
     and kernel F must launch once a batch, whatever its lossless re-runs;
   - SE BEST ``-d DIR`` on the same FASTQ, with a collection of two schemes
     per k written from ``schemes/kuch_k+1`` and its mirror: the selection
     probe (kernel E with lengths) and the masked combined pass;
   - PE BEST ``-p static -c schemes/kuch_k+1 -nD`` on 16,384 pairs: the
     scheme folder's own static fractions;

   and then the row-gather bench (``columba_tpu_torch.tools.gather_bench``,
   kernel H's entry point) at 262,144 lanes;
   On ``se_all``, ``pe_best`` and ``rlc_se_all`` the warm-up align's own
   inputs to kernels C and D (the rows ``stage_expand`` flattens from
   whole SA ranges, the candidates ``stage_dedup`` sorts and pads, with
   their live counts) and to kernels I-L are captured, and after the path
   each kernel entry and band radius is held to its plain version on them
   and timed, by CUDA events and by ``torch.profiler``'s device time, with
   a warm and with a flushed L2 (``columba_tpu_torch/tools/path_inputs.py``);
6. checks each path's output against the sampled loci (nothing with few
   enough substitutions may be missing), that every kernel launched on the
   paths that should reach it, and that one batch run through the plain
   versions on the card gives the same occurrences as the kernels;
7. on the RLC index: writes the JAX package's pan-genome (128 Mbp in one
   sequence, 20 haplotypes of one 6.4 Mbp base at 0.1 % SNP divergence,
   seed 20260820), builds it with ``cli build --rlc`` and ``--rlc
   --textless`` (two processes at once), prints each flavor's index bytes
   on disk and on the card, holds the RLC entries of kernels A, B, C, E
   and F, and kernels I-L on one RLC and one textless batch
   (``extend.loop_rlc`` on 8- and 12-wide lanes and on per-read
   tables, ``extend.rlc`` both ways, ``band_step.rlc``,
   ``band_step.per_lane_rlc`` at kb 2 and 4, ``band_step.textless``,
   ``locate.rlc``, ``exact.rlc``, ``exact.rlc_lengths``, ``dynpart.rlc``
   with every column of its final part ranges) against their plain
   versions at the paths' shapes with their bounds, builds the RLC index's
   10-mer table (path ``rlc_kmer_table``: kernel A's ``table_rlc``, one
   launch; path ``rlc_kmer_steps``: a library caller's ten ``extend_char``
   calls, ``extend.rlc``; the two tables equal, sampled rows held to the
   plain exact match) and drives eight more paths:

   - ``rlc_se_all``: ``-a all -e 2 -S kuch1 -b 16384 -nD`` (the JAX
     package's RLC bench) on 65,536 reads of the pan-genome;
   - ``rlc_se_best``: ``-a best`` on the same reads;
   - ``rlc_pe_best``: ``-a best -F`` on 16,384 ``fr`` pairs (fragments of
     250-450 bp), whose rung (0,0) is the exact pass (``exact.rlc``);
   - ``tl_se_all`` and ``tl_se_best``: the same SE commands on the textless
     index (the frontier pass with witness slots, phi locate on the host);
   - ``rlc_se_all_dynamic``: ``rlc_se_all`` with ``-p dynamic`` (kernels F
     and G, kernel B's per-lane RLC entry); its records must be
     ``rlc_se_all``'s, and kernel F must launch once a batch;
   - ``rlc_se_best_d``: ``-a best -d DIR`` with the SE BEST ``-d`` path's
     collection (``exact.rlc_lengths``, the masked pass);
   - ``rlc_pe_best_c``: ``-a best -c schemes/kuch_k+1 -F`` on the
     ``rlc_pe_best`` pairs, selection on;

   with the same checks (SE ALL: every read with <= 2 substitutions at its
   locus; BEST: its best distance; PE: its pair, unless another haplotype
   holds a better one), and one batch of the RLC and of the textless index,
   and of the RLC index with dynamic partitioning and with scheme selection,
   through the plain versions on the card. Then the reference's default
   run on the b-move indexes (``rlc_default_run``), 16,384 reads of 150 bp
   (the first 1,024 at 3 % substitutions): ``rlc_col150_se_best`` (``-a
   best -S columba``), ``rlc_col150_se_best_dyn`` (the same with ``-p
   dynamic``; its sorted records must be the uniform run's) and
   ``tl_col150_se_best`` (textless), each checked at cutoff 7, its first
   1,024 reads again through the plain versions, and kernel B required at
   kb 5 and 7 through the instances of the path's entry
   (``PATH_SHAPES``, with kernels F and G's shapes under ``-p
   dynamic``). On every path a kernel B launch at kb 5-7 with one or two
   registers through the generic entry fails the run.

   Then the ``readme`` section, on the same index: the README's two
   ``align`` commands. Kernel B's templated instances at kb 5, 6 and 7
   (the columba scheme at 150 bp, W 2) and its generic entry at the same
   steps, each against the plain version and timed in turns; then four
   paths through the same helper:

   - ``col150_se_best``: ``-a best -S columba`` on 32,768 reads of 150 bp
     (the first 640 at the runs of N with 3 % substitutions, the rest
     uniform at 1 %): cutoff 7, the stratum ladder's rungs 0, 1, 3, 5 and
     7; kernel B must launch at kb 5 and 7 through templated instances;
   - ``col150_se_all_e5``: ``-a all -e 5 -S columba`` on its first 16,384
     reads (kb 5 through its instance);
   - ``ham_se_all``: ``-a all -e 2 -m hamming -S pigeon`` on SE ALL's
     first 32,768 reads (every read with <= 2 substitutions at its begin,
     NM at most its substitutions);
   - ``ham_se_best``: ``-a best -m hamming -S pigeon`` on the same reads
     (cutoff 5, one pass);
   - ``col150_se_best_dyn``: ``col150_se_best`` with ``-p dynamic``, the
     reference's default run (kernel F at 6 and 8 parts, G at kb 5 and 7,
     kernel B's per-lane kb 5 and 7 instances; its sorted records must be
     ``col150_se_best``'s; its first 1,024 reads through the plain
     versions);

   each with its lossless check, each path's first 4,096 reads again
   through the plain versions (the same records), and every path's
   kernel B launches by entry, band radius, registers and instance
   (``native.Kernel.by_shape``). Last, ``conformance``: the port's fuzz
   (``columba_tpu_torch/tools/fuzz_conformance.py``), 80 trials against
   brute-force oracles on the card, 0 failures and 0 crashes, kernels
   A-D launched.

   Then ``col250``, the same run on 250 bp reads (Illumina's 2 x 250):
   16,384 reads, the first 1,024 at 4 % substitutions (8 at each run of
   N), the rest at 1 %; BEST cutoff 12, the ladder's rungs 0, 1, 3, 5, 9
   and 12. Kernel B's quad body (a quad of threads a lane, the Vanilla
   entries at kb 8-13) against the plain version and the forced generic
   entry in turns at C = 12,288 at kb 8-13, per-lane at kb 9, and on a kb
   12 step that overflows both buffers; then ``col250_se_best`` (``-a
   best -S columba``: the quad body at kb 9, W 2 and kb 12, W 3; kernel D
   at both) and ``col250_se_best_dyn`` (``-p dynamic``: F at 10 parts, G
   and the per-lane quad body at kb 9; rung 12 runs the static entry, as
   13 parts of 25 do not fit in 250 bp), each checked at cutoff 12, the
   twin's sorted records equal to the uniform run's, each path's first 512
   reads again through the plain versions. On every path a Vanilla launch
   at kb 8-13 with a register count of the quad body's through the
   generic entry fails the run. Each section's seconds are printed as it
   ends.

6. runs the ``dist`` phase at the same width (SE ALL's reads 16,384 to
   49,151, the 10-mer table, switchpoint 4): ``dist_shards``,
   ``dist.mesh.sharded_match`` over 2 shards of 16,384 reads in this
   process, against one ``match_device_core`` on the whole batch at twice
   the caps and, on the first shard, against the plain versions;
   ``dist_ranks``, the 2-rank dryrun
   (``columba_tpu_torch.tools.multihost_dryrun``: two processes on the one
   card, gloo) on a FASTQ of the same reads, whose occurrences must be
   ``dist_shards``' and whose every rank must launch kernels A-D and
   I-L; and, in
   the RLC section, ``rlc_dist_shards`` on the pan-genome's first 16,384
   reads.

8. runs the ``big`` section last, with every other index released: one
   index past 2^31 bases. Right after the kernels are built, a thread
   starts two child processes one after the other, beside every other
   section: the FASTA of a 3,100,000,000 bp random genome (GRCh38's scale;
   24 sequences of 2^27 bp, the layout of the JAX package's
   ``tools/bigbuild.py``, so chr17 begins at 2^31; 40 runs of N, seed
   20260819) and its ``cli build`` (SA sparseness 4), whose time and peak
   RSS are printed. Then three paths through the same helper as the
   others:

   - ``big_se_all``: ``-a all -e 2`` on 65,536 reads, 320 of them at the
     runs of N (the only reads that need band steps at this size) and the
     rest uniform over every sequence, a third of them past 2^31;
   - ``big_se_best``: ``-a best`` on the same reads;
   - ``big_pe_best``: ``-a best -F`` on 16,384 ``fr`` pairs;

   each checked as the other paths are (no read or pair with few enough
   substitutions missing, and none of those past 2^31), with records on
   chr17 and later required; kernels A, B, C and D must launch on
   ``big_se_all``, whose first 16,384 reads go through the plain versions
   once more (the same records), and kernels C and D are held to their
   plain versions on rows and windows of this index past 2^31 (and across
   it), and timed.

The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failure raises, so the exit code is
non-zero and that line is not printed. It needs no network and no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SEED = 20260817
N_READS = 131_072
N_READS_ALL = 65_536     # the SE ALL path's share of the reads
N_PAIRS_E2 = 32_768      # the PE ALL -e 2 path's share of the pairs
N_PAIRS_STATIC = 16_384  # the PE BEST -p static path's share of the pairs
GATHER_LANES = 262_144   # kernel H's check and the gather bench path
READ_LEN = 100
K = 2
BEST_CUT = 4             # BEST cutoff of kuch1 at 100 bp and 95 % identity
BATCH = 16384
WARMUP_READS = 16384
N_RLC_READS = 65_536     # each SE path on the pan-genome's RLC indexes
N_RLC_PAIRS = 16_384     # the PE BEST path on the with-text RLC index
RLC_WARMUP = 4096
PLAIN_TL_READS = 4096    # the textless batch through the plain versions
N_REC_READS = 16_384     # the record-path paths (-T, FASTA, RLC .rhs)
REC_WARMUP = 4096
TRIM = (0, 50)           # -T of se_all_trim
BLOCK_BP = 70_000_000    # -B of the blocked build: 2 blocks of 2 sequences
N_BLOCKS = 2
N_BLK_READS = 32_768     # the blocked SE paths (SE ALL's first reads)
N_BLK_PAIRS = 16_384     # the blocked PE path (the -p static path's pairs)
BLK_WARMUP = 4096
BLOCK_MEM_SLACK = 8 << 20  # device bytes a released block may leave behind

# the readme section: the README's two align commands (-S columba, Hamming
# -S pigeon) on the smoke genome's index
COL_LEN = 150            # Columba's reproduction read length
N_COL_READS = 32_768     # col150_se_best
N_COL_ALL_READS = 16_384  # col150_se_all_e5: the same reads' first
COL_RUN_READS = 16       # col150 reads at each run of N (the first reads)
COL_RUN_ERR = 0.03       # their substitution rate: most reach rung 5
COL_CUT = 7              # BEST cutoff at 150 bp and -I 95
COL_E = 5                # -e of col150_se_all_e5
N_HAM_READS = 32_768     # the Hamming paths: SE ALL's first reads
HAM_E = 2                # -e of ham_se_all
HAM_CUT = 5              # BEST cutoff of pigeon at 100 bp and -I 95
N_README_PLAIN = 4096    # each path's first reads through the plain versions
README_WARMUP = 4096
README_PATHS = ("col150_se_best", "col150_se_all_e5", "ham_se_all",
                "ham_se_best", "col150_se_best_dyn")
# the reference's default run (BEST, -p dynamic, 150 bp) on the b-move
# indexes: 16,384 pan-genome reads, the first 1,024 at 3 % substitutions
# (rungs 5 and 7 get lanes), the rest at 1 %
RLC_COL_PATHS = ("rlc_col150_se_best", "rlc_col150_se_best_dyn",
                 "tl_col150_se_best")
N_RLC_COL_READS = 16_384
N_RLC_COL_HARD = 1024
N_DEFAULT_PLAIN = 1024   # the default-run paths' first reads, plain versions
# the reference's default run on 250 bp reads (Illumina's 2 x 250): BEST
# cutoff 12 at -I 95, the ladder's rungs 0, 1, 3, 5, 9 and 12; kernel B's
# quad body at kb 9 (W 2) and 12 (W 3). The first 1,024 reads at 4 %
# substitutions (about 10 a read: rungs 9 and 12 get lanes), 8 of them at
# each run of N, the rest at 1 %
COL250_LEN = 250
COL250_PATHS = ("col250_se_best", "col250_se_best_dyn")
N_COL250_READS = 16_384
N_COL250_HARD = 1024
COL250_RUN_READS = 8
COL250_ERR = 0.04
COL250_CUT = 12
N_COL250_PLAIN = 512     # each path's first reads through the plain versions
COL250_WARMUP = 2048
# kernel B at C = 12,288 at kb 8..13 in the smoke: the columba scheme's W
# and searches at 250 bp (kb 9 and 12 on the schedule's own tables, the
# paths' radii; the others on random tables, which spares the host
# loading and checking the columba scheme at k = 11 and 13;
# tools/kernel_bench.py --only columba250 takes the schedules' own)
COL250_STEPS = {8: (2, 9), 9: (2, 10), 10: (2, 11), 11: (3, 12),
                12: (3, 13), 13: (3, 14)}
READ_LEN_OF = {p: COL_LEN for p in ("col150_se_best", "col150_se_all_e5",
                                    "col150_se_best_dyn", *RLC_COL_PATHS)}
READ_LEN_OF.update({p: COL250_LEN for p in COL250_PATHS})
FUZZ_TRIALS = 80         # tools/fuzz_conformance.py: 40 seeds x 2

# the kernels each path must launch at least once
PATH_KERNELS = {
    "se_all": ("extend", "band_step", "locate", "verify"),
    "se_best": ("extend", "band_step", "locate", "verify"),
    "pe_best": ("extend", "band_step", "locate", "verify"),
    "pe_all_e0": ("exact", "locate", "expand"),
    "pe_all_e2": ("extend", "band_step", "locate", "verify"),
    "se_all_dynamic": ("extend", "band_step", "locate", "verify", "dynpart",
                       "dyn_tables"),
    "se_best_d": ("extend", "band_step", "locate", "verify", "exact"),
    "pe_best_static": ("extend", "band_step", "locate", "verify"),
    "rlc_se_all": ("extend", "band_step", "locate", "verify"),
    "rlc_se_best": ("extend", "band_step", "locate", "verify"),
    "rlc_pe_best": ("extend", "band_step", "locate", "verify", "exact"),
    "tl_se_all": ("extend", "band_step", "frontier"),
    "tl_se_best": ("extend", "band_step", "frontier"),
    "rlc_se_all_dynamic": ("extend", "band_step", "locate", "verify",
                           "dynpart", "dyn_tables"),
    "rlc_se_best_d": ("extend", "band_step", "locate", "verify", "exact"),
    "rlc_pe_best_c": ("extend", "band_step", "locate", "verify", "exact"),
    # On the random genome a batch needs kernel B only where a read lies in
    # a repeat (a seeded N run): elsewhere the seeded exact prefix takes
    # every lane to the in-text crossover. SE ALL's first 16,384 reads have
    # no such read, so the record-path and blocked paths require A, C and D
    # each, and the blocked paths kernel B together (``blocked_section``).
    "se_all_trim": ("extend", "locate", "verify"),
    "se_all_fasta": ("extend", "locate", "verify"),
    "rlc_se_all_rhs": ("extend", "band_step", "locate", "verify"),
    "blk_se_all": ("extend", "locate", "verify"),
    "blk_se_best": ("extend", "locate", "verify"),
    "blk_se_rhs": ("extend", "locate", "verify"),
    "blk_pe_best": ("extend", "locate", "verify"),
    "big_se_all": ("extend", "band_step", "locate", "verify"),
    "big_se_best": ("extend", "locate", "verify"),
    "big_pe_best": ("extend", "locate", "verify"),
    "col150_se_best": ("extend", "band_step", "locate", "verify"),
    "col150_se_all_e5": ("extend", "band_step", "locate", "verify"),
    "ham_se_all": ("extend", "band_step", "locate", "verify"),
    "ham_se_best": ("extend", "band_step", "locate", "verify"),
    "col150_se_best_dyn": ("extend", "band_step", "locate", "verify",
                           "dynpart", "dyn_tables"),
    "rlc_col150_se_best": ("extend", "band_step", "locate", "verify"),
    "rlc_col150_se_best_dyn": ("extend", "band_step", "locate", "verify",
                               "dynpart", "dyn_tables"),
    "tl_col150_se_best": ("extend", "band_step", "frontier"),
    "col250_se_best": ("extend", "band_step", "locate", "verify"),
    "col250_se_best_dyn": ("extend", "band_step", "locate", "verify",
                           "dynpart", "dyn_tables"),
}
# kernels I-L (the frontier around kernels A and B, the candidates'
# expansion and the dedup) run on every path that runs the scheme executor
# and verifies: I, K (J's tail in its launch) and L wherever kernel D runs;
# on the textless paths
# (no locate, no verify) I and J; on PE ALL -e 0 (the exact pass) K
for _p, _k in PATH_KERNELS.items():
    if "verify" in _k:
        PATH_KERNELS[_p] = _k + ("frontier", "expand", "dedup")
# the entries of kernels A, B, C and E each path must go through (see
# native.Kernel.by_entry), as "kernel.entry"
_RLC_ENTRIES = ("extend.loop_rlc", "band_step.rlc", "locate.rlc")
PATH_ENTRIES = {
    "se_all": ("extend.loop", "frontier.seed", "frontier.drain",
               "frontier.init", "expand.frontier_tail", "expand.rows",
               "dedup.windows", "dedup.keys", "dedup.pass",
               "dedup.compact"),
    "pe_all_e0": ("expand.ranges", "expand.rows"),
    "se_best": ("extend.loop",),
    "pe_best": ("extend.loop",),
    "pe_all_e2": ("extend.loop", "frontier.ex_compact", "frontier.ex_back"),
    "se_all_dynamic": ("extend.loop", "band_step.per_lane"),
    "se_best_d": ("extend.loop", "exact.lengths"),
    "pe_best_static": ("extend.loop",),
    "rlc_se_all": _RLC_ENTRIES,
    "rlc_se_best": _RLC_ENTRIES,
    "rlc_pe_best": _RLC_ENTRIES + ("exact.rlc",),
    "tl_se_all": ("extend.loop_rlc", "band_step.textless", "frontier.tail"),
    "tl_se_best": ("extend.loop_rlc", "band_step.textless"),
    "rlc_se_all_dynamic": ("extend.loop_rlc", "band_step.per_lane_rlc",
                           "locate.rlc", "dynpart.rlc"),
    "rlc_se_best_d": _RLC_ENTRIES + ("exact.rlc_lengths",),
    "rlc_pe_best_c": _RLC_ENTRIES + ("exact.rlc", "exact.rlc_lengths"),
    "se_all_trim": ("extend.loop",),
    "se_all_fasta": ("extend.loop",),
    "rlc_se_all_rhs": _RLC_ENTRIES,
    "blk_se_all": ("extend.loop",),
    "blk_se_best": ("extend.loop",),
    "blk_se_rhs": ("extend.loop",),
    "blk_pe_best": ("extend.loop",),
    "big_se_all": ("extend.loop",),
    "big_se_best": ("extend.loop",),
    "big_pe_best": ("extend.loop",),
    "col150_se_best": ("extend.loop",),
    "col150_se_all_e5": ("extend.loop",),
    "ham_se_all": ("extend.loop",),
    "ham_se_best": ("extend.loop",),
    "col150_se_best_dyn": ("extend.loop", "band_step.per_lane"),
    "rlc_col150_se_best": _RLC_ENTRIES,
    "rlc_col150_se_best_dyn": ("extend.loop_rlc", "band_step.per_lane_rlc",
                               "locate.rlc", "dynpart.rlc"),
    "tl_col150_se_best": ("extend.loop_rlc", "band_step.textless"),
    "col250_se_best": ("extend.loop",),
    "col250_se_best_dyn": ("extend.loop", "band_step.per_lane"),
}
# the launches by shape (``native.Kernel.by_shape``) a path must make:
# kernel B at kb 5 and 7 through the templated instances of the path's
# entry (the columba scheme at 150 bp: W 2, per-lane W 1), and kernels F
# and G's shapes under -p dynamic (columba at k = 5 and 7: 6 and 8 parts);
# at 250 bp kernel B at kb 9 (W 2) and 12 (W 3) through the quad body and
# kernel D at both radii; under -p dynamic the per-lane entry, F and G at
# kb 9 (10 parts) only: per-read schedules need k + 1 parts of 2k + 1, and
# 13 parts of 25 do not fit in 250 bp, so rung 12 runs the static entry
PATH_SHAPES = {
    "col150_se_best": {"band_step": ("static kb5 W2 templated",
                                     "static kb7 W2 templated")},
    "col150_se_all_e5": {"band_step": ("static kb5 W2 templated",)},
    "col150_se_best_dyn": {"band_step": ("per_lane kb5 W1 templated",
                                         "per_lane kb7 W1 templated"),
                           "dynpart": ("parts6", "parts8"),
                           "dyn_tables": ("kb5 parts6", "kb7 parts8")},
    "rlc_col150_se_best": {"band_step": ("rlc kb5 W2 templated",
                                         "rlc kb7 W2 templated")},
    "rlc_col150_se_best_dyn": {"band_step": ("per_lane_rlc kb5 W1 templated",
                                             "per_lane_rlc kb7 W1 templated"),
                               "dynpart": ("parts6", "parts8"),
                               "dyn_tables": ("kb5 parts6", "kb7 parts8")},
    "tl_col150_se_best": {"band_step": ("textless kb5 W2 templated",
                                        "textless kb7 W2 templated")},
    "col250_se_best": {"band_step": ("static kb9 W2 quad",
                                     "static kb12 W3 quad"),
                       "verify": ("kb9", "kb12")},
    "col250_se_best_dyn": {"band_step": ("per_lane kb9 W1 quad",
                                         "static kb12 W3 quad"),
                           "verify": ("kb9", "kb12"),
                           "dynpart": ("parts10",),
                           "dyn_tables": ("kb9 parts10",)},
}
RLC_PATHS = ("rlc_se_all", "rlc_se_best", "rlc_pe_best", "tl_se_all",
             "tl_se_best", "rlc_se_all_dynamic", "rlc_se_best_d",
             "rlc_pe_best_c", "rlc_se_all_rhs")
BLOCKED_PATHS = ("blk_se_all", "blk_se_best", "blk_se_rhs", "blk_pe_best")
# the paths that write read-hit-summary lines, not SAM
RHS_PATHS = ("rlc_se_all_rhs", "blk_se_rhs")
# the kernels whose state must stay out of local memory (ptxas: no stack
# frame): every entry but kernel B's generic one (KB = -1, runtime sizes),
# whose arrays are sized for the largest band; kernel B's quad body
# (band_step_quad_kernel: every RW 4 instance at kb 8..13) among them
NO_FRAME = ("dynpart_", "exact_", "verify_kernel", "locate", "dyn_tables",
            "gather_kernel", "extend_", "band_step_", "seed_kernel",
            "drain_kernel", "init_kernel", "ex_compact_kernel",
            "ex_back_kernel", "tail_kernel", "frontier_kernel", "scan_kernel",
            "rows_kernel", "windows_kernel", "keys_kernel", "pass_kernel",
            "compact_kernel", "table_")
GENERIC_B = ("band_step_kernel<-1", "band_step_rlc_kernel<-1")
# the paths with -p dynamic: kernel F launches once a batch, however many
# lossless re-runs the batch takes
DYNAMIC_PATHS = ("se_all_dynamic", "rlc_se_all_dynamic")
SCHEMES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "schemes")
# the paths whose own inputs to kernels C and D are captured and timed
CAPTURE_PATHS = ("se_all", "pe_best", "rlc_se_all")
PATH_INPUT_REPS = 10
# the dist phase: shards in this process, rank processes, the RLC shards
DIST_SHARDS = 2          # shards in one process, and rank processes
DIST_READS = 16_384      # reads a shard or a rank holds on the Vanilla index
# SE ALL's reads from here on: each shard's and each rank's 16,384 hold a
# read wholly inside an N run (reads 18,586, 26,926 and 42,324), so each
# launches kernel B; SE ALL's first 16,384 hold none
DIST_FIRST = 16_384
N_RLC_DIST_READS = 16_384  # rlc_dist_shards: rlc_se_all's first reads
DIST_KERNELS = ("extend", "band_step", "locate", "verify", "frontier",
                "expand", "dedup")
# the big section: one index past 2^31 bases (GRCh38's scale), the layout of
# the JAX package's tools/bigbuild.py (sequences of 2^27 bp: chr17 begins
# at 2^31), with the smoke genome's 40 runs of N
BIG_N = 3_100_000_000
BIG_SEED = 20260819      # tools/bigbuild.py's genome seed
N_BIG_READS = 65_536     # big_se_all and big_se_best
N_BIG_PAIRS = 16_384     # big_pe_best
BIG_WARMUP = 4096
N_BIG_PLAIN = 16_384     # big_se_all's first reads again through the plain
BIG_BUILD_TIMEOUT = 1000  # seconds for the FASTA and its cli build
BIG_PATHS = ("big_se_all", "big_se_best", "big_pe_best")
TWO31 = 1 << 31
N_BIG_RUN_READS = 8      # big_se_all's reads at each run of N (band steps)
# the FASTA, and the positions of its Ns beside it
BIG_FASTA = ("import sys; import numpy as np; "
             "from columba_tpu_torch.tools import workload; "
             "codes, _ = workload.write_genome(sys.argv[1], "
             "np.random.default_rng(int(sys.argv[2])), int(sys.argv[3]), "
             "seq_len=workload.BIG_SEQ); "
             "np.save(sys.argv[4], np.flatnonzero(codes == 4))")


def quad_shape(shape: str) -> bool:
    """Whether kernel B's census key names a shape of the quad body: the
    Vanilla static or per-lane entry at kb 8..13 with at most
    ``executor.QUAD_MAX_W[kb]`` registers."""
    from columba_tpu_torch.search import executor

    m = re.match(r"(static|per_lane) kb(\d+) W(\d+) ", shape)
    return m is not None and int(m.group(3)) <= executor.QUAD_MAX_W.get(
        int(m.group(2)), 0)


def log(msg: str) -> None:
    print(msg, flush=True)


class Sections:
    """The seconds of each section of the run, logged as each ends."""

    def __init__(self):
        self.t = time.time()
        self.rows: list = []

    def done(self, name: str) -> None:
        now = time.time()
        self.rows.append((name, now - self.t))
        log(f"section {name}: {now - self.t:.1f} s")
        self.t = now


def cuda_time(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` on the current stream (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs(a, b) -> int:
    if isinstance(a, dict):
        return max(_max_abs(a[k], b[k]) for k in a)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"shape/dtype {a.shape} {a.dtype} vs "
                             f"{b.shape} {b.dtype}")
    if a.numel() == 0:
        return 0
    return int((a.long() - b.long()).abs().max())


def check_kernel(name, kern, plain, reps=20, plain_reps=5):
    """Kernel against its plain version on the same inputs (exact), then
    both timed; returns the kernel's output and the record."""
    a, b = kern(), plain()
    torch.cuda.synchronize()
    diff = _max_abs(a, b)
    del b
    if diff != 0:
        raise AssertionError(f"kernel {name} differs from its plain "
                             f"version: max abs error {diff}")
    return a, dict(max_abs_err=diff, ms=cuda_time(kern, reps),
                   plain_ms=cuda_time(plain, plain_reps))


def note_kernel(report, name, shape, rep, b, library_ms=None):
    """Adds the bound to a check's record, files it under ``name``, logs
    it."""
    rep.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"],
               bound_bytes=b["bytes"], bound_operations=b["operations"],
               library_ms=library_ms)
    report[name] = rep
    log(f"kernel {name} ({shape}): equal to plain; {rep['ms']:.4f} ms vs "
        f"plain {rep['plain_ms']:.4f} ms; bound {b['bound_ms']:.5f} ms "
        f"by {b['bound_by']} ({b['bytes']} bytes, {b['operations']} "
        f"operations), share {b['bound_ms'] / rep['ms']:.4f}")


def check_fused(index, state, mrow_t, cells, T, t, switchpoint,
                dyn_meta=None, track=False, cap=None, M=None, cnt=0,
                reps=20, plain_reps=3, generic=False):
    """Kernel B (a fused band step over every lane of ``state``) against
    ``band_step_compact_plain`` on the same frontier: the next frontier's
    live rows (ranges, ids, band, colMin), the in-text rows and count, the
    kept children, visits and overflow must be equal. Then both are timed
    on their own preallocated outputs, and the bound is worked out from the
    step's own data. ``generic``: the Vanilla static step through the
    generic entry (``executor.BAND_GENERIC``). Returns (record, bound, kept
    children, in-text rows)."""
    from columba_tpu_torch.index.bmove import BMoveIndex
    from columba_tpu_torch.search import executor
    from columba_tpu_torch.tools import bounds

    def kernel(*a):
        executor.BAND_GENERIC = generic
        try:
            executor.band_step_compact(*a)
        finally:
            executor.BAND_GENERIC = False

    C, dev = state[0].shape[0], state[0].device
    cap = C if cap is None else cap
    M = max(1 << 16, 4 * C) if M is None else M
    calls, got = {}, {}
    for which, fn in (("kernel", kernel),
                      ("plain", executor.band_step_compact_plain)):
        out = [torch.empty((cap, *f.shape[1:]), dtype=f.dtype, device=dev)
               for f in state]
        itv = torch.zeros((M + 1, 4), dtype=torch.int64, device=dev)
        sc = executor.StepScratch(C, dev)

        def call(fn=fn, out=out, itv=itv, sc=sc):
            fn(index, state, C, out, itv, cnt, sc, mrow_t, cells, T, t,
               switchpoint, dyn_meta, track)
        call()
        torch.cuda.synchronize()
        w = int(sc.ctr[0])
        live = min(w & 0xFFFFFFFF, cap)
        got[which] = dict(
            ranges=out[0][:live].clone(), ids=out[1][:live].clone(),
            band=out[2][:live].clone(), colmin=out[3][:live].clone(),
            itv=itv[:M].clone(), word=sc.ctr[0].clone(),
            visits=sc.ctr[1].clone(), overflow=sc.ctr[2].clone())
        calls[which] = call
    diff = _max_abs(got["kernel"], got["plain"])
    if diff != 0:
        raise AssertionError(f"kernel band_step differs from its plain "
                             f"version: max abs error {diff}")
    w = int(got["kernel"]["word"])
    rep = dict(max_abs_err=diff, ms=cuda_time(calls["kernel"], reps),
               plain_ms=cuda_time(calls["plain"], plain_reps))
    o = executor.band_step_plain(index, *state, mrow_t, cells, T, t,
                                 switchpoint, dyn_meta, track)
    stats = (bounds.rlc_band_stats(index, state, mrow_t, o, cap, dyn_meta,
                                   T, t)
             if isinstance(index, BMoveIndex) else None)
    b = bounds.band_step(state, mrow_t, o, cap, M, cnt, stats)
    return rep, b, w & 0xFFFFFFFF, w >> 32


def check_overflow(what, index, state, mrow_t, cells, T, t, switchpoint,
                   dyn_meta=None, track=False):
    """Kernel B against its plain version on a step that overflows both the
    next frontier and the in-text buffer: the plain step runs first with
    room for everything, then the capacity is half its kept children and
    M half its narrow rows, so the clamps and the dropped rows run on the
    card."""
    from columba_tpu_torch.search import executor

    C, dev = state[0].shape[0], state[0].device
    sc = executor.StepScratch(C, dev)
    executor.band_step_compact_plain(
        index, state, C, [torch.empty_like(f) for f in state],
        torch.zeros((4 * C + 1, 4), dtype=torch.int64, device=dev), 0, sc,
        mrow_t, cells, T, t, switchpoint, dyn_meta, track)
    n, rows = sc.word()
    if n < 2 or rows < 2:
        raise AssertionError(f"{what}: the step keeps {n} children and "
                             f"drains {rows}: nothing to overflow")
    rep, _, n2, rows2 = check_fused(index, state, mrow_t, cells, T, t,
                                    switchpoint, dyn_meta, track,
                                    cap=n // 2, M=rows // 2, plain_reps=1)
    if (n2, rows2) != (n, rows // 2):
        raise AssertionError(f"{what}: overflow case kept {n2}, drained "
                             f"{rows2}")
    log(f"kernel {what} overflowing both buffers (C={C} lanes, "
        f"switchpoint {switchpoint}: {n} children kept into {n // 2} rows, "
        f"{rows} in-text rows into M = {rows // 2}): equal to plain; "
        f"{rep['ms']:.4f} ms")


def check_loop(index, ranges, ids, t_lo, t_hi, reads, tabs, per_lane,
               gate_t, switchpoint, reps=20, plain_reps=1):
    """Kernel A's loop entry against ``exact_loop_plain`` on the same lanes
    (final ranges and drain rows equal), both timed, and its bound from
    the extensions the plain version counts. Returns (record, bound, final
    ranges, drain rows)."""
    from columba_tpu_torch.search import executor
    from columba_tpu_torch.tools import bounds

    args = (index, ranges, ids, t_lo, t_hi, reads, tabs, per_lane, gate_t,
            switchpoint)
    out, rep = check_kernel(
        "extend.loop",
        lambda: dict(zip(("ranges", "drows"), executor.exact_loop(*args))),
        lambda: dict(zip(("ranges", "drows"),
                         executor.exact_loop_plain(*args))),
        reps=reps, plain_reps=plain_reps)
    stats: dict = {}
    executor.exact_loop_plain(*args, stats=stats)
    b = bounds.exact_loop(ranges, ids, tabs, per_lane, stats, out["ranges"],
                          out["drows"])
    return rep, b, out["ranges"], out["drows"]


def table_check(report, name, index, K) -> None:
    """Kernel A's table entry (``kmer.build_kmer_table`` on the card: the
    (4^K, rw) seed table in one launch) against its plain version, K
    ``extend_char`` launches of kernel A's per-step entry, bit for bit,
    timed, with its bound."""
    from columba_tpu_torch.index import kmer
    from columba_tpu_torch.tools import bounds

    out, rep = check_kernel(name, lambda: kmer.build_kmer_table(index, K),
                            lambda: kmer.build_kmer_table_plain(index, K),
                            reps=5, plain_reps=2)
    note_kernel(report, name, f"K={K}, {4 ** K} k-mers x {out.shape[1]}, "
                f"{int((out[:, 1] > out[:, 0]).sum())} occur; plain: K "
                f"launches", rep, bounds.kmer_table(K, out))


def kernel_checks(index, arrays, reads, table) -> dict:
    """Each kernel vs its plain version on the card, at the paths' shapes
    (a batch of 16384 reads, both strands), with its bound."""
    from columba_tpu_torch.index import kmer
    from columba_tpu_torch.index.build import decoded_text
    from columba_tpu_torch.ops import extend, locate, verify
    from columba_tpu_torch.search import executor, pipeline
    from columba_tpu_torch.search.scheme import get_scheme
    from columba_tpu_torch.tools import bounds, path_inputs

    dev = index.device
    rng = np.random.default_rng(SEED + 1)
    R = 2 * BATCH
    sched = pipeline.compile_cached(get_scheme("kuch1", K), READ_LEN, "edit",
                                    kmer_k=10)
    C = pipeline.batch_capacity(R, sched.num_searches, 4)   # match_all's
    ml = pipeline.batch_max_locate(R)                        # auto sizes
    batch = torch.from_numpy(np.concatenate(
        [reads[:BATCH], reads[:BATCH, ::-1] ^ 3])).to(dev)
    # kernel A: real ranges (10-mer seeds of read windows), random
    # directions and chars (N included)
    n_rng = 2 * R                                   # enough for k = 4 too
    row = torch.from_numpy(rng.integers(0, R, n_rng)).to(dev)
    off = torch.from_numpy(rng.integers(0, READ_LEN - 10, n_rng)).to(dev)
    all_ranges = kmer.lookup(table, batch[
        row[:, None], off[:, None] + torch.arange(10, device=dev)])
    ranges = all_ranges[:2 * C].contiguous()
    dirs = torch.from_numpy(rng.integers(0, 2, 2 * C).astype(np.int32)).to(dev)
    chars = torch.from_numpy(rng.integers(0, 5, 2 * C).astype(np.int32)).to(dev)
    band_args = path_inputs.band_args(index, sched, batch, all_ranges, rng,
                                      4)

    # kernel C: max_locate random SA rows; the dense suffix array, made by
    # kernel C itself, serves the one-gather library call
    rows = torch.from_numpy(rng.integers(0, index.n + 1, ml)).to(dev)
    # kernel D: max_locate candidates, each near its read's true locus
    text = decoded_text(arrays)
    true_pos = rng.integers(0, index.n - READ_LEN, R)
    pats = torch.from_numpy(np.ascontiguousarray(
        text[true_pos[:, None] + np.arange(READ_LEN)])).to(dev)
    rid_np = rng.integers(0, R, ml)
    rid = torch.from_numpy(rid_np).to(dev)

    def win_starts(kb):
        return torch.from_numpy(true_pos[rid_np] - kb
                                + rng.integers(-2, 3, ml)).to(dev)

    ws = win_starts(K)
    cases = {
        "extend": (lambda: extend.extend_char(index, ranges, chars, dirs),
                   lambda: extend.extend_char_plain(index, ranges, chars,
                                                    dirs)),
        "locate": (lambda: locate.locate_rows(index, rows),
                   lambda: locate.locate_rows_plain(index, rows)),
        "verify": (lambda: verify.verify_window(index, pats, rid, ws, K),
                   lambda: verify.verify_window_plain(index, pats, rid, ws,
                                                      K)),
        "exact": (lambda: extend.exact_match(index, batch),
                  lambda: extend.zero_empty(
                      extend.exact_match_plain(index, batch))),
    }
    shapes = {"extend": f"{2 * C} lanes", "locate": f"{ml} rows",
              "verify": f"{ml} candidates, m={READ_LEN}, kb={K}",
              "exact": f"{R} rows x {READ_LEN} bp"}

    check = check_kernel
    report = {}
    for name, (kern, plain) in cases.items():
        out, rep = check(name, kern, plain,
                         plain_reps=2 if name == "exact" else 5)
        if name == "extend":
            b = bounds.extend(ranges, dirs, chars, out)
        elif name == "locate":
            _, steps = locate.locate_rows_plain(index, rows,
                                                return_steps=True)
            b = bounds.locate(rows, steps, out)
        elif name == "verify":
            b = bounds.verify(pats, rid, ws, K, out)
        else:
            b = bounds.exact(bounds.exact_steps(index, batch), R, out)
        rep.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                   bound_bytes=b["bytes"], bound_operations=b["operations"],
                   library_ms=None)
        report[name] = rep
        log(f"kernel {name} ({shapes[name]}): equal to plain; "
            f"{rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} ms; bound "
            f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({b['bytes']} bytes, "
            f"{b['operations']} operations), share "
            f"{b['bound_ms'] / rep['ms']:.4f}")

    # kernel A's table entry: the 10-mer seed table in one launch against
    # its plain version, the ten extend_char launches of the K-step build
    table_check(report, "extend.table", index, 10)

    # the library call of kernel C's function: with a dense suffix array,
    # SA[row] is one gather. The dense array comes from kernel C itself.
    dense = locate.locate_rows(
        index, torch.arange(index.n + 1, dtype=torch.int64, device=dev)
    ).to(torch.int32)
    want = locate.locate_rows(index, rows)
    if not torch.equal(dense[rows].long() & 0xFFFFFFFF, want):
        raise AssertionError("dense-SA gather differs from kernel C")
    report["locate"]["library_ms"] = cuda_time(lambda: dense[rows], 20)
    log(f"library call for locate (one gather from the dense SA, "
        f"{dense.numel()} entries): {report['locate']['library_ms']:.4f} ms")
    del dense

    # kernel B, the fused step, at the main path's shape (kb 2, W 2, C =
    # rows x searches / 8) and at the other shapes the paths reach
    def fused(args, **kw):
        return check_fused(args[0], list(args[1:5]), *args[5:], **kw)

    rep, b, n, _ = fused(band_args)
    note_kernel(report, "band_step", f"fused step, C={C} lanes live, kb={K}"
                f", W={sched.W}; {n} children kept", rep, b)
    for scheme, k, metric, what in (
            ("kuch1", BEST_CUT, "edit", "BEST cutoff, templated"),
            ("kuch1", K, "hamming", "Hamming band, templated"),
            ("columba", 5, "edit", "templated; the generic entry in the "
             "readme section")):
        sc = pipeline.compile_cached(get_scheme(scheme, k), READ_LEN, metric,
                                     kmer_k=10)
        args = path_inputs.band_args(index, sc, batch, all_ranges, rng,
                          4 if metric == "edit" else 0)
        rep, b, n, _ = fused(args)
        log(f"kernel band_step at kb={(sc.bw - 1) // 2}, W={sc.W} ({what}; "
            f"{scheme} k={k} {metric}, C={args[1].shape[0]}): equal to "
            f"plain; {rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} ms; "
            f"bound {b['bound_ms']:.5f} ms by {b['bound_by']}")
    # a step that overflows both the next frontier and the in-text buffer:
    # the 10-mer seeds' children are about 30 wide, so switchpoint 30
    # drains about half of them and keeps the rest
    check_overflow("band_step", band_args[0], list(band_args[1:5]),
                   *band_args[5:9], 30)

    # kernel A's loop entry: the main path's exact prefix (R x S lanes from
    # the 10-mer seeds, gate depth 20, switchpoint 4), then the band-only
    # path's second stage (switchpoint 0, the lanes live after 8 steps,
    # compacted, with their own ids)
    tables = executor.device_tables(sched, dev)
    tabs = (tables["ex_pos"], tables["ex_dir"], tables["db_ex"])
    S, Kk = sched.num_searches, sched.kmer_k
    seeds = torch.stack(
        [index.full_range((R,)) if int(ks) < 0
         else kmer.lookup(table, batch[:, ks:ks + Kk])
         for ks in sched.kmer_start], dim=1).reshape(R * S, 4)
    seeds = extend.zero_empty(seeds)
    gate = 20 - Kk - 1
    rep, b, out, drows = check_loop(index, seeds, None, 0, sched.e_max,
                                    batch, tabs, False, gate, 4)
    note_kernel(report, "extend.loop",
                f"{R * S} lanes from the 10-mer seeds, steps 0..{sched.e_max}"
                f", {int((drows[:, 1] > drows[:, 0]).sum())} drained, "
                f"{int((out[:, 1] > out[:, 0]).sum())} live after", rep, b)
    stage1, _ = executor.exact_loop(index, seeds, None, 0, 8, batch, tabs,
                                    False, gate, 0)
    ids = (stage1[:, 1] > stage1[:, 0]).nonzero()[:, 0]
    ids = ids[:R * S // 2].int().contiguous()
    rep, b, out, _ = check_loop(index, stage1[ids.long()].contiguous(), ids,
                                8, sched.e_max, batch, tabs, False, gate, 0)
    log(f"kernel extend.loop, band-only second stage ({ids.numel()} lanes "
        f"live after 8 steps, steps 8..{sched.e_max}): equal to plain; "
        f"{rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} ms; bound "
        f"{b['bound_ms']:.5f} ms")
    for kb in (0, BEST_CUT, 5, 7, 13):
        wsk = win_starts(kb)
        _, rep = check(
            "verify", lambda: verify.verify_window(index, pats, rid, wsk, kb),
            lambda: verify.verify_window_plain(index, pats, rid, wsk, kb),
            plain_reps=2)
        log(f"kernel verify at kb={kb} ({32 if kb <= 7 else 64}-bit band; "
            f"{ml} candidates): equal to plain; {rep['ms']:.4f} ms vs plain "
            f"{rep['plain_ms']:.4f} ms")
    # kernels I-L on reads 16,384-32,767 (two lie in N runs: band steps)
    il_batch = torch.from_numpy(np.concatenate(
        [reads[DIST_FIRST:DIST_FIRST + BATCH],
         reads[DIST_FIRST:DIST_FIRST + BATCH, ::-1] ^ 3])).to(dev)
    report.update(il_checks(index, il_batch, table, sched, C, ml))
    report.update(new_kernel_checks(index, batch, table, all_ranges, rng,
                                    check))
    return report


def new_kernel_checks(index, batch, table, all_ranges, rng, check) -> dict:
    """Kernels F, G and H, kernel B's per-lane entry, kernel A's loop on
    per-read tables and kernel E with lengths against their plain versions
    at the shapes of the dynamic partitioning and scheme selection paths
    (32,768 rows x 100 bp)."""
    from columba_tpu_torch.search import dynschedule, pipeline
    from columba_tpu_torch.search import schedule
    from columba_tpu_torch.search.scheme import get_scheme
    from columba_tpu_torch.tools import bounds, gather_bench, path_inputs

    dev = index.device
    R = batch.shape[0]
    report = {}

    def note(name, shape, rep, b, library_ms=None):
        note_kernel(report, name, shape, rep, b, library_ms)

    # kernel F: kuch1 k = 2 with the 10-mer table, and once without a table
    scheme = get_scheme("kuch1", K)
    p = scheme.num_parts
    pts, rep = check(
        "dynpart",
        lambda: dynschedule.dynamic_partition(index, batch, scheme, table),
        lambda: dynschedule.dynamic_partition_plain(index, batch, scheme,
                                                    table), plain_reps=1)
    note("dynpart", f"{R} rows x {READ_LEN} bp, kuch1 k={K}, p={p}, table "
         f"K=10", rep, bounds.dynpart(batch, p, 10, True, pts))
    pts1, rep1 = check(
        "dynpart",
        lambda: dynschedule.dynamic_partition(index, batch, scheme, None),
        lambda: dynschedule.dynamic_partition_plain(index, batch, scheme,
                                                    None), plain_reps=1)
    b1 = bounds.dynpart(batch, p, 1, False, pts1)
    log(f"kernel dynpart without a table (K = 1, {READ_LEN - p} steps): "
        f"equal to plain; {rep1['ms']:.4f} ms vs plain "
        f"{rep1['plain_ms']:.4f} ms; bound {b1['bound_ms']:.5f} ms by "
        f"{b1['bound_by']}; boundaries differ from the seeded run's in "
        f"{int((pts != pts1).any(dim=1).sum())} of {R} rows")

    # kernel G on F's boundaries (the clamp folded in), then kernel B's
    # per-lane entry on G's tables, at kb 2 and at kb 4
    for k in (K, BEST_CUT):
        sc = get_scheme("kuch1", k)
        st = dynschedule.scheme_static(sc, READ_LEN, "edit")
        pts_k = pts if k == K else dynschedule.dynamic_partition(
            index, batch, sc, table)
        dyn, rep = check(
            "dyn_tables",
            lambda: dynschedule.build_tables(st, pts_k, batch),
            lambda: dynschedule.build_tables_plain(st, pts_k, batch),
            reps=10, plain_reps=1)
        phases = dynschedule._static_on(st, dev)["phases"]
        b = bounds.dyn_tables(pts_k, batch, phases, dyn)
        rep["prof_ms"] = path_inputs.Clocks(10).profiled(
            lambda: dynschedule.build_tables(st, pts_k, batch), "dyn_tables",
            False)
        shape = (f"{R} rows x {st.num_searches} searches, T={st.t_max}, "
                 f"kb={st.kb}, a warp a (read, search)")
        log(f"kernel dyn_tables ({shape}): profiler {_prof(rep)} ms warm")
        if k == K:
            note("dyn_tables", shape, rep, b)
        else:
            log(f"kernel dyn_tables ({shape}): equal to plain; "
                f"{rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} ms; "
                f"bound {b['bound_ms']:.5f} ms ({b['bytes']} bytes)")
        S, T, bw = st.num_searches, st.t_max, 2 * st.kb + 1
        C = max(1024, R * S // 8)
        t = T - READ_LEN // 3          # inside the last part's band steps
        ids = torch.from_numpy(rng.integers(0, R * S, C).astype(
            np.int32)).to(dev)
        band = torch.from_numpy(rng.integers(0, 4, (C, 2, bw)).astype(
            np.int8)).to(dev)
        colmin = torch.from_numpy(rng.integers(0, 3, (C, 2, 1)).astype(
            np.int8)).to(dev)
        state = [all_ranges[:C].contiguous(), ids, band, colmin]
        rep, b, n, _ = check_fused(index, state, None, dyn["pchars"], T, t,
                                   4, dyn["meta"].reshape(-1))
        if n == 0:
            raise AssertionError("no child kept in the per-lane band step")
        shape = (f"per-lane entry, fused step, C={C} lanes, kb={st.kb}, "
                 f"W=1; {n} children kept")
        if k == K:
            note("band_step.per_lane", shape, rep, b)
            check_overflow("band_step.per_lane", index, state, None,
                           dyn["pchars"], T, t, 30, dyn["meta"].reshape(-1))
            # kernel A's loop entry on the per-read tables: every lane
            # from the full range, gate depth 20, switchpoint 4
            L = R * S
            rep, b, out, drows = check_loop(
                index, index.full_range((L,)), None, 0,
                dyn["ex_pos"].shape[1], batch,
                (dyn["ex_pos"], dyn["ex_dir"], dyn["db_ex_steps"]), True,
                19, 4)
            log(f"kernel extend.loop on per-read tables ({L} lanes from the "
                f"full range, {dyn['ex_pos'].shape[1]} steps, "
                f"{int((drows[:, 1] > drows[:, 0]).sum())} drained): equal "
                f"to plain; {rep['ms']:.4f} ms vs plain "
                f"{rep['plain_ms']:.4f} ms; bound {b['bound_ms']:.5f} ms")
        else:
            log(f"kernel band_step ({shape}): equal to plain; "
                f"{rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} ms")
        del dyn, state

    # kernel E with lengths: the R x p part patterns of scheme selection at
    # the BEST cutoff, as select_schemes makes them on the -d path
    p = get_scheme("kuch1", BEST_CUT).num_parts
    cuts = schedule.uniform_partition(READ_LEN, p)
    lens = np.diff(cuts)
    pos = np.full((p, lens.max()), -1, np.int64)
    for i in range(p):
        pos[i, :lens[i]] = np.arange(cuts[i], cuts[i + 1])
    pos = torch.from_numpy(pos).to(dev)
    pats = torch.where((pos >= 0)[None], batch[:, pos.clamp(min=0)], 5)
    pats = pats.reshape(R * p, -1).contiguous()
    lengths = torch.from_numpy(lens.astype(np.int32)).to(dev).repeat(R)
    from columba_tpu_torch.ops import extend
    out, rep = check(
        "exact", lambda: extend.exact_match(index, pats, lengths),
        lambda: extend.zero_empty(extend.exact_match_plain(index, pats,
                                                           lengths)),
        plain_reps=2)
    want = pipeline.part_exact_ranges(index, batch, cuts).reshape(-1, 4)
    if not torch.equal(out, want):
        raise AssertionError("part_exact_ranges differs from kernel E on "
                             "its patterns")
    note("exact.lengths", f"{R * p} part patterns of {lens.min()}-"
         f"{lens.max()} chars", rep,
         bounds.exact(bounds.exact_steps(index, pats, lengths), R * p, out))

    # kernel H: 64 B rows of a 2,000,000-row table at 262,144 lanes. The
    # timed calls cycle through 16 index sets (268 MB of rows), so that no
    # call finds its rows in the 50 MB L2 cache.
    tab = torch.from_numpy(rng.integers(
        0, 2 ** 31, (gather_bench.ROWS, 16)).astype(np.int32)).to(dev)
    idx_sets = [torch.from_numpy(rng.integers(
        0, gather_bench.ROWS, GATHER_LANES)).to(dev) for _ in range(16)]
    idx = idx_sets[0]

    def cycling(fn):
        state = [0]

        def call():
            state[0] += 1
            return fn(tab, idx_sets[state[0] % len(idx_sets)])
        return call

    out = gather_bench.gather_rows(tab, idx)
    rep = dict(
        max_abs_err=_max_abs(out, gather_bench.gather_rows_plain(tab, idx)),
        ms=cuda_time(cycling(gather_bench.gather_rows), 64),
        plain_ms=cuda_time(cycling(gather_bench.gather_rows_plain), 64))
    if rep["max_abs_err"] != 0:
        raise AssertionError("kernel gather differs from its plain version")
    clocks = path_inputs.Clocks(64)
    rep["prof_ms"] = clocks.profiled(cycling(gather_bench.gather_rows),
                                     "gather_kernel", False)
    library = cycling(lambda t, i: torch.index_select(t, 0, i))
    lib = cuda_time(library, 64)
    shape = (f"{GATHER_LANES} lanes, 64 B rows of {gather_bench.ROWS}, a "
             f"quad of threads a row")
    log(f"kernel gather ({shape}): profiler {_prof(rep)} ms warm")
    note("gather", shape, rep, bounds.gather(tab, idx, out), lib)
    lib_prof = clocks.profiled(library, ("vectorized_gather", "indexSelect"),
                               False)
    log(f"library call torch.index_select: {lib:.4f} ms; profiler "
        f"{'not measured' if lib_prof is None else f'{lib_prof:.4f}'} ms")
    return report


def _prof(rep) -> str:
    return ("not measured" if rep.get("prof_ms") is None
            else f"{rep['prof_ms']:.4f}")


# the record of each of kernels I-L in the kernels line: its main entry's
IL_MAIN = {"frontier": "frontier.seed", "expand": "expand.frontier_tail",
           "dedup": "dedup.windows"}


def entry_checks(label, calls, report=None, prof=True) -> None:
    """Kernels I-L's captured calls (``path_inputs.capture_entries``) held
    to their plain versions on copies of their inputs (max abs error 0, the
    buffers written in place included), timed (CUDA events, and with
    ``prof`` the profiler's device time, warm and with a flushed L2; the
    plain version by events) beside their bound and, where one PyTorch
    call computes the same function, that call's time
    (``path_inputs.library``; the profiler's device time with ``prof``,
    else events); with ``report`` each entry's record is filed there,
    kernel L's with the library sort's device time beside it
    (``torch.sort`` of every row's key, as the port sorted before kernel
    L's passes; the library time of ``dedup.pass``, whose launches, one a
    digit, do that sort's work with the keys')."""
    from columba_tpu_torch.tools import bounds, path_inputs

    clocks = path_inputs.Clocks(PATH_INPUT_REPS)
    sort_ms = None
    if "dedup.keys" in calls:
        sort_ms = path_inputs.sort_ms(calls["dedup.keys"], clocks)
    for name in sorted(calls):
        c = calls[name]
        err = path_inputs.replay_plain(c)
        if err != 0:
            raise AssertionError(f"{label}: kernel {name} differs from its "
                                 f"plain version: max abs error {err}")
        b = bounds.entry(name, c["args"], c["after"], c["out"])
        if prof:
            t = path_inputs.time_entry(c, clocks)
        else:
            kargs = path_inputs.copies(c["args"])
            t = dict(events_warm=clocks.events(lambda: c["real"](**kargs),
                                               False),
                     events_cold=None, prof_warm=None, prof_cold=None,
                     plain_ms=None)
        # one PyTorch call of the same function, where there is one
        # (kernel K's ranges: torch.cumsum; rows: torch.searchsorted)
        lib_fn = path_inputs.library(c)
        lib = sort_ms if name == "dedup.pass" else None
        if lib_fn is not None:
            lib = (clocks.device_ms(lib_fn) if prof
                   else clocks.events(lib_fn, False))
        sort = sort_ms if name.startswith("dedup.") else None
        log(f"kernel {name} ({label}): equal to plain; events warm "
            f"{t['events_warm']:.4f} ms, cold {_opt(t['events_cold'])}; "
            f"profiler warm {_opt(t['prof_warm'])}, cold "
            f"{_opt(t['prof_cold'])}; plain {_opt(t['plain_ms'])} ms; "
            f"library {_opt(lib)} ms"
            + (f"; sort {sort:.4f} ms" if sort is not None else "")
            + f"; bound {b['bound_ms']:.5f} ms by {b['bound_by']} "
            f"({b['bytes']} bytes), share by events "
            f"{b['bound_ms'] / t['events_warm']:.4f}")
        if report is not None and name != "frontier.lookup":
            report[name] = dict(
                max_abs_err=err, ms=t["events_warm"], prof_ms=t["prof_warm"],
                plain_ms=t["plain_ms"], bound_ms=b["bound_ms"],
                bound_by=b["bound_by"], bound_bytes=b["bytes"],
                bound_operations=b["operations"], library_ms=lib,
                sort_ms=sort)
    if report is not None:
        for kern, main in IL_MAIN.items():
            if main in report:
                report[kern] = dict(report[main])


def _opt(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def il_checks(index, batch, table, sched, C, ml) -> dict:
    """Kernels I-L at the SE ALL path's sizes (32,768 rows, L = 98,304
    lanes, C = 12,288, max_locate = M = 131,072; reads that hold two in N
    runs, so the call makes band steps): every entry of one
    ``match_device_core`` call as ``match_all`` makes it (10-mer seeds,
    switchpoint 4), of the band-only call (switchpoint 0, the two-stage
    exact loop), of the k = 0 pass and of a k-mer lookup, and kernel J's
    own entry on that call's ``run_scheme`` (its direct callers and the
    textless pass launch it; ``match_device_core`` leaves the tail to
    kernel K's ``frontier_tail``), held to its plain version and timed;
    kernel L's and K's ``frontier_tail`` entries on synthetic edges
    (``tools/edges.py``); then the launch census of the first call outside
    kernel B's band steps (kernel L's passes among them)."""
    from columba_tpu_torch.index import kmer
    from columba_tpu_torch.search import executor, pipeline
    from columba_tpu_torch.tools import edges, path_inputs

    for case in edges.DEDUP_CASES + ("se_all",):
        info = edges.dedup_vs_plain(case, batch.device)
        log(f"kernel L on the synthetic edge {case} ({info['L']} rows, "
            f"{info['valid']} valid, rids below {info['rows']}: "
            f"{info['passes']} passes, {info['n_unique']} unique pairs): "
            f"keys (prefix and mask), every pass, compact and stage_dedup "
            f"(no library sort) equal to plain")
    for Ct, Mt, moved in ((1024, 131_072, True), (1024, 131_072, False),
                          (1500, 4096, True), (12_288, 131_072, True)):
        info = edges.frontier_tail_vs_plain(Ct, Mt, moved, batch.device)
        log(f"kernel K's frontier_tail on a synthetic final frontier (C = "
            f"{Ct}, M = {Mt}, moved {moved}, {info['ghosts']} ghosts): "
            f"equal to frontier_tail_plain then stage_candidates_plain")
    R, S = batch.shape[0], sched.num_searches
    caps = pipeline.crossover_caps(C, ml, 4)

    def se_all():
        return pipeline.match_device_core(index, batch, sched, C, ml, K,
                                          table, 4, *caps)

    C0 = pipeline.batch_capacity(R, S, 0)

    def band_only():
        return pipeline.match_device_core(index, batch, sched, C0, ml, K,
                                          table, 0, 0, 0, 0, ex_split=8,
                                          ex_cap=C0)

    report = {}
    calls = path_inputs.capture_entries(se_all)
    band = path_inputs.capture_entries(band_only)
    for what, c in (("SE ALL", calls), ("band-only", band)):
        w = c["expand.frontier_tail"]["after"]["res"].tail["words"]
        log(f"kernels I-L, the {what} call at the SE ALL sizes: {R} rows x "
            f"{S} searches = {R * S} lanes, C = {C}, M = max_locate = {ml};"
            f" {int(w[5])} lanes live after the exact prefix, {int(w[6])} "
            f"in-text rows, {int(w[1])} visits")
    calls.update({k: v for k, v in band.items() if k not in calls})
    more = path_inputs.capture_entries(
        lambda: pipeline._exact_device(index, batch, ml))
    calls.update({k: v for k, v in more.items() if k not in calls})
    more = path_inputs.capture_entries(
        lambda: kmer.lookup(table, batch[:, 20:30]))
    calls.update(more)
    more = path_inputs.capture_entries(
        lambda: executor.run_scheme(index, batch, sched, C, table, 4, *caps,
                                    itv_min_depth=16))
    calls["frontier.tail"] = more["frontier.tail"]
    entry_checks("SE ALL sizes", calls, report)
    entry_checks("SE ALL sizes, the band-only call", band, prof=False)
    census = path_inputs.launch_census(se_all)
    log(f"launch census, one SE ALL match_device_core call ({R} rows, C = "
        f"{C}, max_locate = {ml}; torch.profiler): {census['outside']} "
        f"launches, memsets and copies outside kernel B's band steps "
        f"({census['band']} with their word copies), kernel L's sort among "
        f"them; a library sort's {census['sort']}; {census['total']} in "
        f"all; by name {json.dumps(census['by_name'], sort_keys=True)}")
    if census["sort"] or census["outside"] > 20:
        raise AssertionError("the SE ALL call ran a library sort or more "
                             "than 20 launches outside kernel B's steps")
    return report


def rlc_kernel_checks(bm, tl, batch) -> dict:
    """The RLC entries of kernels A (its loop), B, C and E against their
    plain versions on the card, at the shapes of the RLC paths (a batch of
    16,384 reads of the pan-genome, both strands: 32,768 rows), with their
    bounds."""
    from columba_tpu_torch.ops import blocate, extend, locate
    from columba_tpu_torch.search import executor, pipeline
    from columba_tpu_torch.search.scheme import get_scheme
    from columba_tpu_torch.tools import bounds, path_inputs

    dev = bm.device
    rng = np.random.default_rng(SEED + 3)
    R = batch.shape[0]
    report = {}
    sched = pipeline.compile_cached(get_scheme("kuch1", K), READ_LEN, "edit")
    S = sched.num_searches

    L = R * S
    states = path_inputs.rlc_lane_states(bm, batch, rng, max(1024, L // 8))

    # kernel A's table entry on the RLC index (a quad a k-mer)
    table_check(report, "extend.table_rlc", bm, 10)

    # kernel B (band_step.rlc): C = R x S / 8 lanes with the crossover on
    ba = path_inputs.band_args(bm, sched, batch, states, rng, 4)
    rep, b, n, _ = check_fused(bm, list(ba[1:5]), *ba[5:], plain_reps=2)
    note_kernel(report, "band_step.rlc",
                f"fused step, C={ba[1].shape[0]} lanes x 8, kb={K}, "
                f"W={sched.W}; {n} children kept", rep, b)
    check_overflow("band_step.rlc", bm, list(ba[1:5]), *ba[5:9], 30)

    # kernel B (band_step.textless): C = R x S / 2 lanes, 12 wide, 2W
    # colMin slots, no crossover
    C = max(1024, R * S // 2)
    tl_states = path_inputs.rlc_lane_states(tl, batch, rng, C)
    tb = list(path_inputs.band_args(tl, sched, batch, tl_states, rng, 0,
                                    div=2))
    tb[4] = torch.from_numpy(rng.integers(0, 3, (C, 2, 2 * sched.W)).astype(
        np.int8)).to(dev)
    rep, b, n, _ = check_fused(tl, tb[1:5], *tb[5:], track=True,
                               plain_reps=2)
    note_kernel(report, "band_step.textless",
                f"fused step, C={C} lanes x 12, kb={K}, W={sched.W} "
                f"(+{sched.W} witness slots); {n} children kept", rep, b)
    check_overflow("band_step.textless", tl, tb[1:5], *tb[5:9], 30,
                   track=True)

    # kernel A's loop entry (extend.loop_rlc): the exact prefix of the RLC
    # paths, R x S lanes from the full range (no seed table), 8 wide with
    # the crossover, and 12 wide on the textless index without it
    tables = executor.device_tables(sched, dev)
    tabs = (tables["ex_pos"], tables["ex_dir"], tables["db_ex"])
    rep, b, out, drows = check_loop(bm, bm.full_range((L,)), None, 0,
                                    sched.e_max, batch, tabs, False, 19, 4)
    note_kernel(report, "extend.loop_rlc",
                f"{L} lanes x 8 from the full range, steps 0..{sched.e_max}"
                f", {int((drows[:, 1] > drows[:, 0]).sum())} drained, "
                f"{int((out[:, 1] > out[:, 0]).sum())} live after", rep, b)
    rep, b, out, _ = check_loop(tl, tl.full_range((L,)), None, 0,
                                sched.e_max, batch, tabs, False, 19, 0)
    log(f"kernel extend.loop_rlc on 12-wide textless lanes ({L} from the "
        f"full range, {int((out[:, 1] > out[:, 0]).sum())} live after): "
        f"equal to plain; {rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} "
        f"ms; bound {b['bound_ms']:.5f} ms")

    # kernel E (exact.rlc): the batch's 32,768 rows x 100 bp
    out, rep = check_kernel(
        "exact.rlc", lambda: extend.exact_match(bm, batch),
        lambda: extend.zero_empty(extend.exact_match_plain(bm, batch)),
        reps=10, plain_reps=1)
    stats = {}
    steps = bounds.exact_steps(bm, batch, stats=stats)
    note_kernel(report, "exact.rlc", f"{R} rows x {READ_LEN} bp, "
                f"{int((out[:, 1] > out[:, 0]).sum())} matched, "
                f"{bounds.rlc_rounds(steps, stats, R):.1f} dependent-read "
                f"rounds a row", rep, bounds.exact_rlc(steps, stats, out))

    report.update(rlc_select_checks(bm, batch, rng, states))

    # kernels I-L on one RLC batch (8-wide lanes, no seed table, switchpoint
    # 4) and on one textless batch (12-wide lanes, track_arg: I and J)
    ml = pipeline.batch_max_locate(R)
    Cr = pipeline.batch_capacity(R, S, 4)
    calls = path_inputs.capture_entries(
        lambda: pipeline.match_device_core(
            bm, batch, sched, Cr, ml, K, None, 4,
            *pipeline.crossover_caps(Cr, ml, 4)))
    entry_checks(f"RLC batch, {R} rows", calls, prof=False)
    calls = path_inputs.capture_entries(
        lambda: executor.run_scheme(tl, batch, sched,
                                    pipeline.batch_capacity(R, S, 0),
                                    track_arg=True))
    entry_checks(f"textless batch, {R} rows", calls, prof=False)

    # kernel C (locate.rlc): max_locate = max(65,536, 4 R) random rows
    ml = max(1 << 16, 4 * R)
    rows = torch.from_numpy(rng.integers(0, bm.n + 1, ml)).to(dev)
    out, rep = check_kernel("locate.rlc", lambda: locate.locate_rows(bm, rows),
                            lambda: blocate.locate_rows_plain(bm, rows),
                            plain_reps=2)
    stats = {}
    blocate.locate_rows_plain(bm, rows, stats)
    note_kernel(report, "locate.rlc",
                f"{ml} rows, {stats['steps'] / ml:.2f} LF steps a row", rep,
                bounds.locate_rlc(rows, stats, out))
    return report


def rlc_select_checks(bm, batch, rng, states) -> dict:
    """The RLC entries of this slice against their plain versions on the
    card, with their bounds, at the shapes of the RLC paths: kernel A's
    per-step entry (``extend.rlc``: extend_all and extend_char on R x S
    lanes), kernel F's (``dynpart.rlc``: kuch1 k = 2, K = 1, every column
    of the final part ranges too), kernel B's per-lane entry
    (``band_step.per_lane_rlc`` at kb 2 and 4 on kernel G's tables of F's
    boundaries, C = 12,288 lanes), kernel A's loop on those per-read
    tables, and kernel E with lengths (``exact.rlc_lengths``: the -d
    probe's 5 x R part patterns of 20 chars at the BEST cutoff)."""
    from columba_tpu_torch.ops import bextend, extend
    from columba_tpu_torch.search import dynschedule, schedule
    from columba_tpu_torch.search.scheme import get_scheme
    from columba_tpu_torch.tools import bounds, path_inputs

    dev = bm.device
    R = batch.shape[0]
    report = {}
    scheme = get_scheme("kuch1", K)
    p, S = scheme.num_parts, len(scheme.searches)
    L = R * S

    # kernel A's per-step RLC entry: valid lanes of the exact prefix's
    # shape (R x S), random directions and chars
    lanes = path_inputs.rlc_lane_states(bm, batch, rng, L)
    dirs = torch.from_numpy(rng.integers(0, 2, L).astype(np.int32)).to(dev)
    chars = torch.from_numpy(rng.integers(0, 5, L).astype(np.int32)).to(dev)
    out, rep = check_kernel(
        "extend.rlc", lambda: extend.extend_all(bm, lanes, dirs),
        lambda: extend.extend_all_plain(bm, lanes, dirs), plain_reps=1)
    stats = {}
    bextend.extend_all_plain(bm, lanes, dirs, None, stats)
    b = bounds.extend_rlc(lanes, dirs, None, out, stats)
    log(f"kernel extend.rlc extend_all ({L} lanes x 8, "
        f"{int((out[..., 1] > out[..., 0]).sum())} children): equal to "
        f"plain; {rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} ms; bound "
        f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({b['bytes']} bytes), "
        f"share {b['bound_ms'] / rep['ms']:.4f}")
    out, rep = check_kernel(
        "extend.rlc", lambda: extend.extend_char(bm, lanes, chars, dirs),
        lambda: extend.extend_char_plain(bm, lanes, chars, dirs),
        plain_reps=1)
    stats = {}
    bextend.extend_char_plain(bm, lanes, chars, dirs, stats)
    note_kernel(report, "extend.rlc", f"extend_char, {L} lanes x 8, "
                f"{int((out[:, 1] > out[:, 0]).sum())} live after", rep,
                bounds.extend_rlc(lanes, dirs, chars, out, stats))
    del lanes, dirs, chars, out

    # kernel F's RLC entry: boundaries and the final 8-wide part ranges
    def part(fn):
        def call():
            rng_out = torch.empty((R, p, 8), dtype=torch.int64, device=dev)
            return dict(pts=fn(bm, batch, scheme, None, rng_out),
                        ranges=rng_out)
        return call
    got, rep = check_kernel(
        "dynpart.rlc", part(dynschedule.dynamic_partition),
        part(dynschedule.dynamic_partition_plain), reps=10, plain_reps=1)
    pts = got["pts"]
    stats = {}
    dynschedule.dynamic_partition_plain(bm, batch, scheme, None, None, stats)
    note_kernel(report, "dynpart.rlc", f"{R} rows x {READ_LEN} bp, kuch1 "
                f"k={K}, p={p}, K=1 ({READ_LEN - p} steps), "
                f"{int((got['ranges'][..., 1] > got['ranges'][..., 0]).sum())}"
                f" of {R * p} final parts live, "
                f"{bounds.rlc_rounds(stats['steps'], stats, R):.1f} "
                f"dependent-read rounds a row", rep,
                bounds.dynpart_rlc(batch, p, 1, False, stats, pts))
    del got

    # kernel G's tables of F's boundaries; kernel B's per-lane RLC entry on
    # them at kb 2 and 4 (C = 12,288 valid lanes); kernel A's loop on the
    # per-read tables at kb 2
    C = 12_288
    for k in (K, BEST_CUT):
        sc = get_scheme("kuch1", k)
        st = dynschedule.scheme_static(sc, READ_LEN, "edit")
        pts_k = pts if k == K else dynschedule.dynamic_partition(
            bm, batch, sc)
        dyn = dynschedule.build_tables(st, pts_k, batch)
        Sk, T, bw = st.num_searches, st.t_max, 2 * st.kb + 1
        t = T - READ_LEN // 3          # inside the last part's band steps
        ids = torch.from_numpy(rng.integers(0, R * Sk, C).astype(
            np.int32)).to(dev)
        band = torch.from_numpy(rng.integers(0, 4, (C, 2, bw)).astype(
            np.int8)).to(dev)
        colmin = torch.from_numpy(rng.integers(0, 3, (C, 2, 1)).astype(
            np.int8)).to(dev)
        state = [states[:C].contiguous(), ids, band, colmin]
        rep, b, n, _ = check_fused(bm, state, None, dyn["pchars"], T, t, 4,
                                   dyn["meta"].reshape(-1), plain_reps=2)
        if n == 0:
            raise AssertionError("no child kept in the per-lane RLC step")
        shape = (f"per-lane RLC entry, fused step, C={C} lanes x 8, "
                 f"kb={st.kb}, W=1; {n} children kept")
        if k == K:
            note_kernel(report, "band_step.per_lane_rlc", shape, rep, b)
            check_overflow("band_step.per_lane_rlc", bm, state, None,
                           dyn["pchars"], T, t, 30, dyn["meta"].reshape(-1))
            rep, b, out, drows = check_loop(
                bm, bm.full_range((R * Sk,)), None, 0,
                dyn["ex_pos"].shape[1], batch,
                (dyn["ex_pos"], dyn["ex_dir"], dyn["db_ex_steps"]), True,
                19, 4, reps=5)
            log(f"kernel extend.loop_rlc on per-read tables ({R * Sk} lanes "
                f"x 8 from the full range, {dyn['ex_pos'].shape[1]} steps, "
                f"{int((drows[:, 1] > drows[:, 0]).sum())} drained, "
                f"{int((out[:, 1] > out[:, 0]).sum())} live after): equal to "
                f"plain; {rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} "
                f"ms; bound {b['bound_ms']:.5f} ms by {b['bound_by']}, share "
                f"{b['bound_ms'] / rep['ms']:.4f}")
        else:
            log(f"kernel band_step.per_lane_rlc ({shape}): equal to plain; "
                f"{rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} ms; "
                f"bound {b['bound_ms']:.5f} ms by {b['bound_by']}, share "
                f"{b['bound_ms'] / rep['ms']:.4f}")
        del dyn, state

    # kernel E with lengths on the R x p part patterns of scheme selection
    # at the BEST cutoff, as select_schemes makes them on the -d path
    p4 = get_scheme("kuch1", BEST_CUT).num_parts
    cuts = schedule.uniform_partition(READ_LEN, p4)
    lens = np.diff(cuts)
    pos = np.full((p4, lens.max()), -1, np.int64)
    for i in range(p4):
        pos[i, :lens[i]] = np.arange(cuts[i], cuts[i + 1])
    pos = torch.from_numpy(pos).to(dev)
    pats = torch.where((pos >= 0)[None], batch[:, pos.clamp(min=0)], 5)
    pats = pats.reshape(R * p4, -1).contiguous()
    lengths = torch.from_numpy(lens.astype(np.int32)).to(dev).repeat(R)
    out, rep = check_kernel(
        "exact.rlc_lengths", lambda: extend.exact_match(bm, pats, lengths),
        lambda: extend.zero_empty(extend.exact_match_plain(bm, pats,
                                                           lengths)),
        reps=10, plain_reps=1)
    stats = {}
    steps = bounds.exact_steps(bm, pats, lengths, stats)
    note_kernel(report, "exact.rlc_lengths",
                f"{R * p4} part patterns of {lens.min()}-{lens.max()} chars, "
                f"{int((out[:, 1] > out[:, 0]).sum())} matched, "
                f"{bounds.rlc_rounds(steps, stats, R * p4):.1f} "
                f"dependent-read rounds a row", rep,
                bounds.exact_rlc(steps, stats, out))
    return report


def path_input_times(path: str, calls: list, smi: str) -> None:
    """Kernels C and D on the inputs a path's warm-up gave them (the first
    launch of each entry and band radius): held to the plain version, then
    timed by CUDA events and by the profiler's device time, with a warm and
    with a flushed L2 (``tools/path_inputs.py``)."""
    from columba_tpu_torch.tools import path_inputs

    seen, picked = set(), []
    for c in calls:
        key = (c["kind"], c.get("kb"))
        if key not in seen:
            seen.add(key)
            picked.append(c)
    path_inputs.time_inputs(path, picked, path_inputs.Clocks(PATH_INPUT_REPS),
                            smi, [])


@contextlib.contextmanager
def block_memory(rows: list):
    """While in the block, record for each block that a blocked ``cli
    align`` loads one row of ``rows``: [block dir, device bytes allocated
    before it loads, its index's bytes, its k-mer table's bytes, device
    bytes allocated after it is released]. The blocked paths take the
    blocks from ``blocked.iter_blocks`` and resume it for the next block
    only after the last one is released."""
    from columba_tpu_torch.index import blocked, kmer
    from columba_tpu_torch.index.fmindex import FMIndex

    iter_blocks, from_arrays = blocked.iter_blocks, FMIndex.from_arrays
    kmer_cached = kmer.build_kmer_table_cached

    def tracked_iter(index_dir, meta):
        for bm, arrays in iter_blocks(index_dir, meta):
            torch.cuda.synchronize()
            rows.append([bm["dir"], torch.cuda.memory_allocated(), 0, 0,
                         None])
            yield bm, arrays
            torch.cuda.synchronize()
            rows[-1][4] = torch.cuda.memory_allocated()

    def tracked_index(arrays, device):
        index = from_arrays(arrays, device)
        rows[-1][2] = index.nbytes()
        return index

    def tracked_table(index, k, cache_dir):
        table = kmer_cached(index, k, cache_dir)
        rows[-1][3] = table.nbytes
        return table

    blocked.iter_blocks = tracked_iter
    FMIndex.from_arrays = staticmethod(tracked_index)
    kmer.build_kmer_table_cached = tracked_table
    try:
        yield rows
    finally:
        blocked.iter_blocks = iter_blocks
        FMIndex.from_arrays = staticmethod(from_arrays)
        kmer.build_kmer_table_cached = kmer_cached


def sam_body(path: str, n_reads: int | None = None, ordered=True):
    """A SAM file's @SQ lines and its records (without @PG), of the reads
    numbered below ``n_reads`` where given, in file order or sorted."""
    heads, body = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                if line.startswith("@SQ"):
                    heads.append(line)
            elif n_reads is None or int(line.split("\t", 1)[0][1:]) < n_reads:
                body.append(line)
    return heads, (body if ordered else sorted(body))


def rhs_hits(path: str) -> dict:
    """read number -> [(sequence name, distance)] of a read-hit-summary
    file (reads without a hit map to [])."""
    out = {}
    with open(path) as f:
        for line in f:
            name, _, hits = line.rstrip("\n").partition("\t")
            out[int(name[1:])] = [
                (h[1:-1].rsplit(",", 1)[0], int(h[1:-1].rsplit(",", 1)[1]))
                for h in hits.split(";") if h]
    return out


def parse_sam(path: str, seq_ids: dict | None = None):
    """(qname index, rname index, pos1, flag, NM) of every mapped record;
    a sequence's index is its number in ``chrN`` or ``seq_ids[name]``."""
    q, rn, p, fl, nm = [], [], [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            c = line.split("\t", 4)
            if c[2] == "*":
                continue
            q.append(int(c[0][1:]))
            rn.append(seq_ids[c[2]] if seq_ids else int(c[2][3:]))
            p.append(int(c[3]))
            fl.append(int(c[1]))
            nm.append(int(line[line.index("NM:i:") + 5:].split("\t", 1)[0]))
    return tuple(np.array(v, np.int64) for v in (q, rn, p, fl, nm))


def proper_pairs(path: str) -> dict:
    """pair number -> [(mate 1 pos1, mate 2 pos1, NM total)] of the proper
    pairs a PE SAM reports (mates matched by RNEXT/PNEXT)."""
    mates = ({}, {})
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            c = line.split("\t", 8)
            flag = int(c[1])
            if not flag & 2:
                continue
            nm = int(line[line.index("NM:i:") + 5:].split("\t", 1)[0])
            mates[0 if flag & 64 else 1].setdefault(int(c[0][1:]), []).append(
                (int(c[3]), int(c[7]), nm))
    out = {}
    for q, recs in mates[0].items():
        for pos, pnext, nm in recs:
            for pos2, pnext2, nm2 in mates[1].get(q, []):
                if pos2 == pnext and pnext2 == pos:
                    out.setdefault(q, []).append((pos, pos2, nm + nm2))
    return out


def nearest(recs, want_key, want_p1):
    """For each wanted (key, pos) the smallest |pos - record pos| over the
    records with that key (a large number where there is none), and the
    smallest NM of those records. ``recs`` = (key, pos1, nm) arrays."""
    key, p1, nm = recs
    order = np.lexsort((p1, key))
    key, p1, nm = key[order], p1[order], nm[order]
    lo = np.searchsorted(key, want_key, side="left")
    hi = np.searchsorted(key, want_key, side="right")
    dist = np.full(len(want_key), 1 << 40, np.int64)
    best_nm = np.full(len(want_key), 1 << 40, np.int64)
    for i, (a, b) in enumerate(zip(lo, hi)):
        if b > a:
            dist[i] = np.abs(p1[a:b] - want_p1[i]).min()
            best_nm[i] = nm[a:b].min()
    return dist, best_nm


def plain_patch():
    """Swap every kernel wrapper of the paths for its plain version (module
    attributes the pipeline calls through); returns the undo."""
    from columba_tpu_torch.index.bmove import BMoveIndex
    from columba_tpu_torch.ops import blocate, extend, locate, rank, verify
    from columba_tpu_torch.search import dynschedule, executor
    from columba_tpu_torch.tools import path_inputs

    def locate_plain(index, rows):
        if isinstance(index, BMoveIndex):
            return blocate.locate_rows_plain(index, rows)
        if index.sa_sparseness == 1:
            return rank.u32(index.sa_samples[rows])
        return locate.locate_rows_plain(index, rows)

    def verify_plain(index, patterns, rid, window_start, kb, live=None):
        return verify.verify_window_plain(index, patterns, rid,
                                          window_start, kb)

    def exact_plain(index, patterns, lengths=None):
        return extend.zero_empty(extend.exact_match_plain(index, patterns,
                                                          lengths))

    saved = [(extend, "extend_char", extend.extend_char_plain),
             (extend, "exact_match", exact_plain),
             (executor, "exact_loop", executor.exact_loop_plain),
             (executor, "band_step_compact",
              executor.band_step_compact_plain),
             (dynschedule, "dynamic_partition",
              dynschedule.dynamic_partition_plain),
             (dynschedule, "build_tables", dynschedule.build_tables_plain),
             (locate, "locate_rows", locate_plain),
             (verify, "verify_window", verify_plain)]
    undo = [(mod, name, getattr(mod, name)) for mod, name, _ in saved]
    for mod, name, fn in saved:
        setattr(mod, name, fn)
    restore_entries = path_inputs.plain_entries()       # kernels I-L

    def restore():
        restore_entries()
        for mod, name, fn in undo:
            setattr(mod, name, fn)
    return restore


def dist_shards(path, index, fwd, nsub, pos, smi, record, kmer_table=None,
                regrow=False, plain=False) -> np.ndarray:
    """``sharded_match`` over ``DIST_SHARDS`` shards of ``fwd`` (both
    strands of each shard's reads, shard after shard, as ranks feed them)
    in this process, against one ``match_device_core`` on the whole batch
    at twice the caps: the same (rid, window start) set, the same ``total``
    and overflow 0, and 0 missing of the reads with at most K
    substitutions. Capacity and locate cap as ``match_all_start`` sizes
    them for a shard's rows on ``index`` (its locate cap takes what earlier
    batches grew it to: the pan-genome fans out 20x). ``regrow``: on a
    frontier overflow both runs re-run at grown capacity, as
    ``match_all_finish`` does (the pan-genome's repeats). ``plain``: the
    first shard again through the plain versions. Launch counts of the
    timed sharded run go to ``record``. Returns the occurrence set."""
    from columba_tpu_torch import native
    from columba_tpu_torch.core import alphabet
    from columba_tpu_torch.dist import mesh as dmesh
    from columba_tpu_torch.index.kmer import table_k
    from columba_tpu_torch.search import pipeline
    from columba_tpu_torch.search.scheme import get_scheme
    from columba_tpu_torch.tools.multihost_dryrun import occurrences

    t_path = time.time()
    dev = index.device
    per = len(fwd) // DIST_SHARDS
    rows = np.concatenate([np.concatenate([r, alphabet.revcomp(r, axis=-1)])
                           for r in np.split(fwd, DIST_SHARDS)])
    batch = torch.from_numpy(rows).to(dev)
    sched = pipeline.compile_cached(
        get_scheme("kuch1", K), READ_LEN, "edit",
        kmer_k=0 if kmer_table is None else table_k(kmer_table))
    cap = pipeline.batch_capacity(2 * per, sched.num_searches, 4)
    ml = pipeline.batch_max_locate(2 * per, index)
    mesh = dmesh.make_data_mesh(DIST_SHARDS, dev)

    def sharded(c):
        return dmesh.sharded_match(mesh, index, batch, sched, c, ml, K,
                                   kmer_table=kmer_table, switchpoint=4)

    def single(c):
        out = pipeline.match_device_core(
            index, batch, sched, 2 * c, 2 * ml, K, kmer_table, 4,
            *pipeline.crossover_caps(2 * c, 2 * ml, 4))
        return {k: v.cpu() for k, v in out.items()}

    def lossless(fn, what):
        c, reruns = cap, 0
        out = fn(c)
        # the counters are the shards' sums: only the capacity grows
        while regrow and (g := pipeline.grown_caps(
                out, c, c, ml, grow_locate=False)) is not None:
            c, reruns = g[0], reruns + 1
            out = fn(c)
        log(f"  {path} {what}: capacity {c} a shard ({reruns} lossless "
            f"re-runs), locate cap {ml} a shard")
        return out, c

    one, _ = lossless(single, "one match_device_core at twice the caps")
    for k in native.KERNELS.values():
        k.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.time()
    out, c = lossless(sharded, f"{DIST_SHARDS} shards")
    res = {k: v.cpu().numpy() for k, v in out.items()}
    dt = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v.launches for k, v in native.KERNELS.items()}
    entries = {f"{k}.{e}": n for k, v in native.KERNELS.items()
               for e, n in v.by_entry.items()}
    record(path, launches, entries)
    occ, occ_1 = occurrences(res), occurrences(
        {k: v.numpy() for k, v in one.items()})
    same = np.array_equal(occ, occ_1)
    # a read is found where a row of it has a valid window of at most K
    # edits beginning K before its sampled locus, within K
    v = res["valid"] & (res["final_rows"].min(axis=-1) <= K)
    rid = res["rid"][v]
    read = rid // (2 * per) * per + rid % per
    found = np.unique(read[np.abs(res["win_start"][v] + K - pos[read]) <= K])
    want = np.nonzero(nsub[:len(fwd)] <= K)[0]
    lost = np.setdiff1d(want, found)
    table_bytes = 0 if kmer_table is None else kmer_table.nbytes
    log(f"path {path}: {len(fwd)} reads x {READ_LEN} bp in {DIST_SHARDS} "
        f"shards of {2 * per} rows in one process, in {dt:.3f} s = "
        f"{len(fwd) / dt:.1f} reads/s ({smi}; one shard after the other on "
        f"the card); peak device memory {peak} bytes ({base} allocated "
        f"before the run); index "
        f"{index.nbytes()} + k-mer table {table_bytes} bytes on the card; "
        f"total {res['total']}, overflow {res['overflow']} (one device: "
        f"{int(one['total'])}, {int(one['overflow'])}); {len(occ)} "
        f"(read row, window) pairs, {'the same' if same else 'a DIFFERENT'}"
        f" set as one device; {len(want)} reads with <= {K} "
        f"substitutions, {len(lost)} missing; kernel launches {launches}")
    missing = [k for k in DIST_KERNELS if launches[k] == 0]
    if (not same or int(res["total"]) != int(one["total"])
            or int(res["overflow"]) or int(one["overflow"]) or len(lost)
            or missing):
        raise AssertionError(
            f"{path}: same set {same}, totals {res['total']} and "
            f"{int(one['total'])}, overflow {res['overflow']} and "
            f"{int(one['overflow'])}, lost {lost[:10].tolist()}, kernels not "
            f"launched {missing}, capacity {c} (sized {cap})")
    if plain:
        restore = plain_patch()
        try:
            p = dmesh.sharded_match(
                dmesh.make_data_mesh(1, dev), index, batch[:2 * per], sched,
                c, ml, K, kmer_table=kmer_table, switchpoint=4)
        finally:
            restore()
        p = {k: v.cpu().numpy() for k, v in p.items()}
        occ_p = occurrences(p)
        same = np.array_equal(occ_p, occ[occ[:, 0] < 2 * per])
        slots = all(np.array_equal(p[k], res[k][:len(p[k])])
                    for k in dmesh.ARRAYS)
        log(f"  {path}, plain versions on the card, the first shard: "
            f"{len(occ_p)} pairs, {'the same' if same else 'a DIFFERENT'} "
            f"set as the kernels' (slot for slot: {slots})")
        if not same:
            raise AssertionError(f"{path}: the plain versions give another "
                                 "occurrence set on the first shard")
    log(f"  {path} took {time.time() - t_path:.1f} s")
    return occ


def dist_ranks(path, idx, reads_fq, want_occ, smi, record) -> None:
    """``tools/multihost_dryrun.py`` on the card: ``DIST_SHARDS`` rank
    processes joined by gloo, each loading the index of ``idx`` and taking
    ``DIST_READS`` reads of ``reads_fq`` in rank order. Requires ``ok``,
    the occurrence set ``want_occ`` (``dist_shards``' on the same reads)
    and kernels A, B, C, D and I-L on every rank; the ranks' summed launches go
    to ``record``."""
    t0 = time.time()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="columba_dist_") as td:
        occ_path = os.path.join(td, "occ.npy")
        done = subprocess.run(
            [sys.executable, "-m", "columba_tpu_torch.tools.multihost_dryrun",
             "--index", idx, "--reads", reads_fq, "--reads-per-rank",
             str(DIST_READS), "--out", occ_path],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=660)
        if done.returncode != 0:
            raise AssertionError(f"{path}: multihost_dryrun exited "
                                 f"{done.returncode}:\n{done.stdout[-3000:]}"
                                 f"\n{done.stderr[-4000:]}")
        s = json.loads(done.stdout.strip().splitlines()[-1])
        occ = np.load(occ_path)
    launches = {k: sum(ln.get(k, 0) for ln in s["launches"])
                for k in DIST_KERNELS}
    entries: dict = {}
    for ent in s["entries"]:
        for e, n in ent.items():
            entries[e] = entries.get(e, 0) + n
    record(path, launches, entries)
    same = np.array_equal(occ, want_occ)
    log(f"path {path}: {s['ranks']} rank processes on one card, "
        f"{s['reads_per_rank']} reads x {s['read_len']} bp each, gloo; "
        f"reads/s by rank {s['reads_per_s']} (the ranks share the card: "
        f"not a chip rate; {smi}); peak device memory by rank "
        f"{s['peak_bytes']} bytes; index + k-mer table bytes by rank "
        f"{s['index_bytes']}; mapped {s['mapped']}; total {s['total']}, "
        f"overflow {s['overflow']}; {s['occurrences']} pairs, "
        f"{'the same set' if same else 'a DIFFERENT set'} as dist_shards; "
        f"launches by rank {s['launches']}; {time.time() - t0:.1f} s with "
        f"the processes' start")
    missing = [(r, k) for r, ln in enumerate(s["launches"])
               for k in DIST_KERNELS if ln[k] == 0]
    if not s["ok"] or not same or missing:
        raise AssertionError(f"{path}: ok {s['ok']}, same set {same}, not "
                             f"launched (rank, kernel) {missing}")


def se_key(q, rn, rev):
    """A single-end record's or a sampled read's key: read, sequence,
    strand."""
    return q * 8 + rn * 2 + rev


def all_locus_check(wd, sample, tag, label, n_reads, k, trim=None,
                    exact=False):
    """ALL mode: every read among the first ``n_reads`` of ``sample`` =
    (sequence starts, begins, substitutions, reverse-complemented flags)
    with <= k substitutions has a record at its locus. On edit distance
    within k of its begin: an error at a read end has equal-cost alignments
    that begin up to k bases away, and the traceback may pick one.
    ``exact`` (Hamming): at its begin, with NM at most its substitutions.
    ``trim``: the reads' -T (start, end); a trimmed read begins ``start``
    after its locus, or ``READ_LEN - end`` where it is reverse-complemented.
    Returns the records (``parse_sam``)."""
    starts, pos, nsub, flip = sample
    recs = parse_sam(os.path.join(wd, tag + ".sam"))
    q, rn, p1, fl, nm = recs
    want = np.nonzero(nsub[:n_reads] <= k)[0]
    seq = np.searchsorted(starts, pos[want], side="right") - 1
    shift = (0 if trim is None else
             np.where(flip[want], READ_LEN - trim[1], trim[0]))
    want_key = se_key(want, seq, flip[want])
    want_p1 = pos[want] - starts[seq] + 1 + shift
    key = se_key(q, rn - 1, (fl & 16) > 0)
    if exact:                 # the least NM of the records at each locus
        code = key * (1 << 33) + p1
        order = np.lexsort((nm, code))
        code, nm = code[order], nm[order]
        wcode = want_key * (1 << 33) + want_p1
        at = np.minimum(np.searchsorted(code, wcode), len(code) - 1)
        lost = want[(code[at] != wcode) | (nm[at] > nsub[want])]
        log(f"{label} lossless check: {len(want)} reads with <= {k} "
            f"substitutions; {len(want) - len(lost)} at their begin with NM "
            f"at most their substitutions, {len(lost)} missing; "
            f"{len(q)} records")
    else:
        dist, _ = nearest((key, p1, nm), want_key, want_p1)
        lost = want[dist > k]
        log(f"{label} lossless check: {len(want)} reads with <= {k} "
            f"substitutions; {int((dist == 0).sum())} at their exact "
            f"begin, {int(((dist > 0) & (dist <= k)).sum())} within {k} "
            f"(end errors), {len(lost)} missing")
    if len(lost):
        raise AssertionError(f"{label}: reads not found at their "
                             f"locus: {lost[:10].tolist()}")
    return recs


def best_locus_check(wd, sample, tag, label, n_reads, cut) -> None:
    """BEST mode: every read among the first ``n_reads`` of ``sample``
    with n <= cut substitutions has a record, its best NM is <= n, and
    where it equals n the record at its locus is there."""
    starts, pos, nsub, flip = sample
    q, rn, p1, fl, nm = parse_sam(os.path.join(wd, tag + ".sam"))
    best_nm = np.full(n_reads, 1 << 40, np.int64)
    np.minimum.at(best_nm, q, nm)
    want = np.nonzero(nsub[:n_reads] <= cut)[0]
    unmapped = want[best_nm[want] > cut]
    worse = want[best_nm[want] > nsub[want]]
    at_n = want[best_nm[want] == nsub[want]]
    seq = np.searchsorted(starts, pos[at_n], side="right") - 1
    dist, _ = nearest((se_key(q, rn - 1, (fl & 16) > 0), p1, nm),
                      se_key(at_n, seq, flip[at_n]),
                      pos[at_n] - starts[seq] + 1)
    lost = at_n[dist > nsub[at_n]]
    log(f"{label} check: {len(want)} reads with <= {cut} "
        f"substitutions; {len(unmapped)} without a record, "
        f"{len(worse)} with best NM above their substitutions, "
        f"{len(at_n)} with best NM equal to them of which "
        f"{len(lost)} miss their locus; "
        f"{len(want) - len(at_n) - len(worse)} have a better hit "
        f"elsewhere; {len(q)} records")
    if len(unmapped) or len(worse) or len(lost):
        raise AssertionError(
            f"{label}: unmapped {unmapped[:5].tolist()}, worse "
            f"{worse[:5].tolist()}, lost {lost[:5].tolist()}")


def same_sam(path, twin, wd) -> None:
    """A path's records, sorted, equal its twin's on the same reads (the
    -p dynamic paths: both lossless, so the same records)."""
    a, b = (sam_body(os.path.join(wd, p + ".sam"), ordered=False)
            for p in (path, twin))
    log(f"{path} against {twin} on the same FASTQ: {len(a[1])} and "
        f"{len(b[1])} records, sorted "
        f"{'the same' if a == b else 'DIFFERENT'}")
    if a != b:
        raise AssertionError(f"{path} reports other records than {twin}")


def plain_records(wd, idx, path, reads, argv) -> None:
    """``reads`` (a path's first) through ``cli align`` with the plain
    versions swapped in (``plain_patch``) give the path's own records for
    them, sorted."""
    from columba_tpu_torch import cli
    from columba_tpu_torch.tools import workload

    plain_fq = os.path.join(wd, f"{path}_plain.fq")
    workload.write_fastq(plain_fq, reads, "r")
    out = os.path.join(wd, f"{path}_plain.sam")
    t0 = time.time()
    restore = plain_patch()
    try:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["align", "-r", idx, "-b", str(BATCH), "-f",
                           plain_fq, "-o", out, *argv])
    finally:
        restore()
    same = rc == 0 and (
        sam_body(out, ordered=False) == sam_body(
            os.path.join(wd, path + ".sam"), len(reads), ordered=False))
    log(f"plain versions on the card, {path}'s first {len(reads)} reads: "
        f"{'the same records' if same else 'DIFFERENT records'} "
        f"({time.time() - t0:.1f} s)")
    if not same:
        raise AssertionError(f"{path} through the plain versions gives "
                             f"other records")


def readme_section(wd, idx, index, table, text, runs, reads100, sample100,
                   drive, files, warm, argv_of, n_of, smi, record) -> None:
    """The README's two ``align`` commands on this index: ``-S columba`` on
    150 bp reads (BEST: cutoff 7, the stratum ladder's rungs 0, 1, 3, 5 and
    7; ALL at -e 5) and Hamming ``-S pigeon`` (ALL at -e 2, BEST at cutoff
    5) on SE ALL's first reads, each through ``drive``. Kernel B's static
    instances at kb 5, 6 and 7 and its generic entry at the same shapes
    against the plain version on the 150 bp reads first; after the paths,
    their lossless checks, kernel B's launches at kb 5 and 7 through the
    templated instances, each path's first reads again through the plain
    versions (the same records), and the conformance fuzz on the card.
    ``sample100``: SE ALL's reads' (sequence starts, begins, substitutions,
    reverse-complemented flags)."""
    from columba_tpu_torch import native
    from columba_tpu_torch.index.kmer import lookup
    from columba_tpu_torch.search import pipeline
    from columba_tpu_torch.search.scheme import get_scheme
    from columba_tpu_torch.tools import fuzz_conformance, path_inputs, workload

    starts = sample100[0]
    rng = np.random.default_rng(SEED + 7)
    at_runs = workload.reads_at_runs(text, starts, *runs, COL_RUN_READS, rng,
                                     COL_LEN, COL_RUN_ERR)
    uni = workload.sample_reads(text, starts, N_COL_READS - len(at_runs[0]),
                                rng, COL_LEN)
    reads, pos, nsub, flip = (np.concatenate(v) for v in zip(at_runs, uni))
    log(f"readme: {N_COL_READS} reads x {COL_LEN} bp, the first "
        f"{len(at_runs[0])} at the {len(runs[0])} runs of N with "
        f"{COL_RUN_ERR} substitutions a base, the rest uniform with "
        f"{workload.ERR_RATE}; {int((nsub <= COL_CUT).sum())} with <= "
        f"{COL_CUT} substitutions")

    # kernel B at kb 5, 6 and 7 (columba at 150 bp: W 2), templated and
    # through the generic entry, on the reads' 10-mer seed ranges
    batch = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [reads[:BATCH], reads[:BATCH, ::-1] ^ 3]))).to(index.device)
    seeds = lookup(table, batch[:, 30:40])
    seeds = seeds[seeds[:, 1] > seeds[:, 0]]
    seeds = seeds[torch.from_numpy(rng.integers(
        0, seeds.shape[0], 12_288)).to(index.device)]
    for kb in (5, 6, 7):
        sc = pipeline.compile_cached(get_scheme("columba", kb), COL_LEN,
                                     "edit", kmer_k=10)
        args = path_inputs.band_args(index, sc, batch, seeds, rng, 4,
                                     C=12_288)
        ms = {}
        for generic in (False, True):
            rep, b, n, _ = check_fused(args[0], list(args[1:5]), *args[5:],
                                       generic=generic)
            ms[generic] = rep["ms"]
        log(f"kernel band_step at kb={kb}, W={sc.W} (columba k={kb} at "
            f"{COL_LEN} bp, C=12288, {n} children kept; {smi}): templated "
            f"and generic entry each equal to plain ({rep['plain_ms']:.4f} "
            f"ms); events, the wrapper's host time included: templated "
            f"{ms[False]:.4f} ms, generic {ms[True]:.4f} ms; bound "
            f"{b['bound_ms']:.5f} ms by {b['bound_by']}")

    def fq(tag, codes, prefix="r"):
        path = os.path.join(wd, tag + ".fq")
        workload.write_fastq(path, codes, prefix)
        return path

    files["col150_se_best"] = files["col150_se_best_dyn"] = (
        fq("col150", reads), None)
    files["col150_se_all_e5"] = (fq("col150a", reads[:N_COL_ALL_READS]),
                                 None)
    files["ham_se_all"] = files["ham_se_best"] = (
        fq("ham", reads100[:N_HAM_READS]), None)
    warm["col150_se_best"] = warm["col150_se_all_e5"] = \
        warm["col150_se_best_dyn"] = (fq("wcol", reads[:README_WARMUP], "w"),
                                      None)
    warm["ham_se_all"] = warm["ham_se_best"] = (
        fq("wham", reads100[:README_WARMUP], "w"), None)
    argv_of.update(
        col150_se_best=["-a", "best", "-S", "columba"],
        col150_se_all_e5=["-a", "all", "-e", str(COL_E), "-S", "columba"],
        ham_se_all=["-a", "all", "-e", str(HAM_E), "-m", "hamming", "-S",
                    "pigeon"],
        ham_se_best=["-a", "best", "-m", "hamming", "-S", "pigeon"],
        # the reference's default run: BEST, -p dynamic, 150 bp
        col150_se_best_dyn=["-a", "best", "-S", "columba", "-p", "dynamic"])
    n_of.update(col150_se_best=N_COL_READS, col150_se_all_e5=N_COL_ALL_READS,
                ham_se_all=N_HAM_READS, ham_se_best=N_HAM_READS,
                col150_se_best_dyn=N_COL_READS)
    for path in README_PATHS:
        drive(path, f"genome {workload.GENOME_N} bp")

    # -- what came out: the sampled loci, by the metric's own rule
    col = (starts, pos, nsub, flip)
    best_locus_check(wd, col, "col150_se_best", "col150_se_best",
                     N_COL_READS, COL_CUT)
    all_locus_check(wd, col, "col150_se_all_e5", "col150_se_all_e5",
                    N_COL_ALL_READS, COL_E)
    all_locus_check(wd, sample100, "ham_se_all", "ham_se_all", N_HAM_READS,
                    HAM_E, exact=True)
    best_locus_check(wd, sample100, "ham_se_best", "ham_se_best",
                     N_HAM_READS, HAM_CUT)
    best_locus_check(wd, col, "col150_se_best_dyn", "col150_se_best_dyn",
                     N_COL_READS, COL_CUT)
    same_sam("col150_se_best_dyn", "col150_se_best", wd)

    # each path's first reads again through the plain versions
    for path in README_PATHS:
        src = reads if path.startswith("col150") else reads100
        n = N_DEFAULT_PLAIN if path.endswith("_dyn") else N_README_PLAIN
        plain_records(wd, idx, path, src[:n], argv_of[path])

    # the conformance fuzz on the card: 80 trials against brute force
    for k in native.KERNELS.values():
        k.reset()
    t0 = time.time()
    trials, fails, crashes = fuzz_conformance.main([])
    dt = time.time() - t0
    launches = {k: v.launches for k, v in native.KERNELS.items()}
    record("conformance", launches,
           {f"{k}.{e}": n for k, v in native.KERNELS.items()
            for e, n in v.by_entry.items()})
    log(f"path conformance: {trials} trials, {fails} failures, {crashes} "
        f"crashes in {dt:.1f} s ({smi}); kernel launches {launches}; kernel "
        f"B by entry, radius, registers and instance "
        f"{native.KERNELS['band_step'].by_shape}")
    missing = [k for k in ("extend", "band_step", "locate", "verify")
               if launches[k] == 0]
    if fails or crashes or trials != FUZZ_TRIALS or missing:
        raise AssertionError(f"conformance fuzz: {trials} trials, {fails} "
                             f"failures, {crashes} crashes; kernels not "
                             f"launched {missing}")


def col250_section(wd, idx, index, table, text, runs, starts, drive, files,
                   warm, argv_of, n_of, smi, report) -> None:
    """The reference's default run on 250 bp reads (``-a best -S columba``,
    cutoff 12: the ladder's rungs 0, 1, 3, 5, 9 and 12), on this index
    through ``drive``. First kernel B's quad body against its plain version
    and the forced generic entry, in turns (quad, generic, generic, quad),
    at C = 12,288 lanes from the reads' 10-mer seed ranges at kb 8-13 (the
    columba scheme's W at 250 bp; kb 9 and 12 on the schedule's own step
    tables), the per-lane entry at kb 9 on kernel G's tables, and a kb 12
    step that overflows both buffers; then ``col250_se_best`` and its ``-p
    dynamic`` twin ``col250_se_best_dyn`` (its sorted records must be the
    uniform run's), each with its lossless check at cutoff 12 and its first
    reads again through the plain versions."""
    from columba_tpu_torch.index.kmer import lookup
    from columba_tpu_torch.search import dynschedule, pipeline
    from columba_tpu_torch.search.scheme import get_scheme
    from columba_tpu_torch.tools import path_inputs, workload

    rng = np.random.default_rng(SEED + 9)
    reads, pos, nsub, flip = workload.ladder_reads(
        text, starts, runs, N_COL250_READS, N_COL250_HARD, COL250_RUN_READS,
        COL250_ERR, rng, COL250_LEN)
    log(f"col250: {N_COL250_READS} reads x {COL250_LEN} bp, the first "
        f"{N_COL250_HARD} with {COL250_ERR} substitutions a base "
        f"({COL250_RUN_READS * len(runs[0])} of them at the {len(runs[0])} "
        f"runs of N), the rest with {workload.ERR_RATE}; "
        f"{int((nsub <= COL250_CUT).sum())} with <= {COL250_CUT} "
        f"substitutions, {int((nsub >= 9).sum())} with 9 or more")

    # kernel B's quad body at kb 8..13, the generic entry in turns
    dev = index.device
    C = 12_288
    batch = torch.from_numpy(np.ascontiguousarray(np.concatenate(
        [reads[:BATCH], reads[:BATCH, ::-1] ^ 3]))).to(dev)
    seeds = lookup(table, batch[:, 30:40])
    seeds = seeds[seeds[:, 1] > seeds[:, 0]]
    seeds = seeds[torch.from_numpy(rng.integers(0, seeds.shape[0], C)).to(
        dev)]
    for kb, (W, S) in COL250_STEPS.items():
        if kb in (9, COL250_CUT):
            sc = pipeline.compile_cached(get_scheme("columba", kb),
                                         COL250_LEN, "edit", kmer_k=10)
            assert (sc.W, sc.num_searches) == (W, S)
            args = path_inputs.band_args(index, sc, batch, seeds, rng, 4, C=C)
            what = f"columba k={kb} at {COL250_LEN} bp, its step tables"
        else:
            args = path_inputs.random_band_args(index, batch, seeds, rng, kb,
                                                W, S, 260, 4)
            what = (f"random step tables, {S} searches: the columba "
                    f"scheme's at {COL250_LEN} bp")
        ms = {False: [], True: []}
        for generic in (False, True, True, False):
            rep, b, n, rows = check_fused(args[0], list(args[1:5]),
                                          *args[5:], generic=generic)
            ms[generic].append(rep["ms"])
            if not generic and len(ms[False]) == 1:
                first = rep
        log(f"kernel band_step (quad body) at kb={kb}, W={W} ({what}; "
            f"C={C}, {n} children kept, {rows} in-text rows; {smi}): quad "
            f"body and generic entry each equal to plain "
            f"({first['plain_ms']:.4f} ms); events, the wrapper's host time "
            f"included, in turns: quad {ms[False]} ms, generic {ms[True]} "
            f"ms; bound {b['bound_ms']:.5f} ms by {b['bound_by']}")
        if kb == COL250_CUT:
            note_kernel(report, "band_step.quad",
                        f"quad body, static entry, kb={kb}, W={W}, C={C} "
                        f"lanes live, columba k={kb} at {COL250_LEN} bp; {n} "
                        f"children kept", first, b)
            check_overflow(f"band_step (quad body, kb {kb}, W {W})",
                           args[0], list(args[1:5]), *args[5:9], 30)
    # the per-lane entry at kb 9 on kernel G's tables of 4,096 of the reads
    scheme = get_scheme("columba", 9)
    lb = batch[:4096].contiguous()
    st = dynschedule.scheme_static(scheme, COL250_LEN, "edit")
    dyn = dynschedule.build_tables(st, dynschedule.dynamic_partition(
        index, lb, scheme, table), lb)
    S, T, bw = st.num_searches, st.t_max, 2 * st.kb + 1
    state = [seeds, torch.from_numpy(rng.integers(0, 4096 * S, C).astype(
                 np.int32)).to(dev),
             torch.from_numpy(rng.integers(0, 4, (C, 2, bw)).astype(
                 np.int8)).to(dev),
             torch.from_numpy(rng.integers(0, 3, (C, 2, 1)).astype(
                 np.int8)).to(dev)]
    ms = {False: [], True: []}
    for generic in (False, True, True, False):
        rep, b, n, _ = check_fused(index, state, None, dyn["pchars"], T,
                                   T - COL250_LEN // 3, 4,
                                   dyn["meta"].reshape(-1), generic=generic)
        ms[generic].append(rep["ms"])
    log(f"kernel band_step.per_lane (quad body) at kb=9 (kernel G's tables "
        f"of 4,096 reads, C={C}, {n} children kept; {smi}): quad body and "
        f"generic entry each equal to plain; events in turns: quad "
        f"{ms[False]} ms, generic {ms[True]} ms; bound {b['bound_ms']:.5f} "
        f"ms by {b['bound_by']}")
    del batch, seeds, lb, dyn, state

    def fq(tag, codes, prefix="r"):
        path = os.path.join(wd, tag + ".fq")
        workload.write_fastq(path, codes, prefix)
        return path

    files["col250_se_best"] = files["col250_se_best_dyn"] = (
        fq("col250", reads), None)
    warm["col250_se_best"] = warm["col250_se_best_dyn"] = (
        fq("wcol250", reads[:COL250_WARMUP], "w"), None)
    best = ["-a", "best", "-S", "columba"]
    argv_of.update(col250_se_best=best,
                   col250_se_best_dyn=best + ["-p", "dynamic"])
    n_of.update({p: N_COL250_READS for p in COL250_PATHS})
    for path in COL250_PATHS:
        drive(path, f"genome {workload.GENOME_N} bp")
    col = (starts, pos, nsub, flip)
    for path in COL250_PATHS:
        best_locus_check(wd, col, path, path, N_COL250_READS, COL250_CUT)
    same_sam("col250_se_best_dyn", "col250_se_best", wd)
    for path in COL250_PATHS:
        plain_records(wd, idx, path, reads[:N_COL250_PLAIN], argv_of[path])


def pan_best_check(wd, tag, pos, nsub, flip, cut) -> None:
    """BEST mode on the pan-genome (one sequence): every read with n <= cut
    substitutions has a record, its best NM is <= n, and where it equals n
    the record at its locus is there (another haplotype may hold a better
    hit)."""
    q, _, p1, fl, nm = parse_sam(os.path.join(wd, tag + ".sam"), {"pan": 0})
    best_nm = np.full(len(nsub), 1 << 40, np.int64)
    np.minimum.at(best_nm, q, nm)
    want = np.nonzero(nsub <= cut)[0]
    unmapped = want[best_nm[want] > cut]
    worse = want[best_nm[want] > nsub[want]]
    at_n = want[best_nm[want] == nsub[want]]
    dist, _ = nearest((q * 2 + ((fl & 16) > 0), p1, nm),
                      at_n * 2 + flip[at_n], pos[at_n] + 1)
    lost = at_n[dist > nsub[at_n]]
    log(f"{tag} check: {len(want)} reads with <= {cut} substitutions; "
        f"{len(unmapped)} without a record, {len(worse)} with best NM above "
        f"their substitutions, {len(at_n)} with best NM equal to them of "
        f"which {len(lost)} miss their locus; {len(q)} records")
    if len(unmapped) or len(worse) or len(lost):
        raise AssertionError(
            f"{tag}: unmapped {unmapped[:5].tolist()}, worse "
            f"{worse[:5].tolist()}, lost {lost[:5].tolist()}")


def rlc_default_run(wd, pan, idx_of, drive, files, warm, argv_of, n_of,
                    index_of) -> None:
    """The reference's default run (BEST, ``-S columba``, 150 bp) on the
    b-move indexes, through ``drive``: ``rlc_col150_se_best`` (uniform),
    ``rlc_col150_se_best_dyn`` (-p dynamic: kernel F's RLC entry, kernel B's
    per-lane RLC entry; its sorted records must be the uniform twin's) and
    ``tl_col150_se_best`` (the textless index; its ladder reaches kb 5 and
    7 too). Each path's BEST check on the sampled loci (cutoff 7) and its
    first reads again through the plain versions (the same records)."""
    from columba_tpu_torch.tools import workload

    rng = np.random.default_rng(SEED + 8)
    starts = np.array([0, len(pan)], np.int64)
    hard = workload.sample_reads(pan, starts, N_RLC_COL_HARD, rng, COL_LEN,
                                 COL_RUN_ERR)
    rest = workload.sample_reads(pan, starts,
                                 N_RLC_COL_READS - N_RLC_COL_HARD, rng,
                                 COL_LEN)
    reads, pos, nsub, flip = (np.concatenate(v) for v in zip(hard, rest))
    log(f"default run: {N_RLC_COL_READS} pan-genome reads x {COL_LEN} bp, "
        f"the first {N_RLC_COL_HARD} with {COL_RUN_ERR} substitutions a "
        f"base, the rest with {workload.ERR_RATE}; "
        f"{int((nsub <= COL_CUT).sum())} with <= {COL_CUT} substitutions")
    fq, wq = (os.path.join(wd, f"{t}.fq") for t in ("pan_col", "pan_wcol"))
    workload.write_fastq(fq, reads, "r")
    workload.write_fastq(wq, reads[:README_WARMUP], "w")
    best = ["-a", "best", "-S", "columba"]
    argv_of.update(rlc_col150_se_best=best,
                   rlc_col150_se_best_dyn=best + ["-p", "dynamic"],
                   tl_col150_se_best=best)
    for path in RLC_COL_PATHS:
        index_of[path] = idx_of["textless" if path.startswith("tl")
                                else "rlc"]
        files[path], warm[path] = (fq, None), (wq, None)
        n_of[path] = N_RLC_COL_READS
        drive(path, f"pan-genome {len(pan)} bp, "
              f"{'textless' if path.startswith('tl') else 'rlc'} index")
    for path in RLC_COL_PATHS:
        pan_best_check(wd, path, pos, nsub, flip, COL_CUT)
    same_sam("rlc_col150_se_best_dyn", "rlc_col150_se_best", wd)
    for path in RLC_COL_PATHS:
        plain_records(wd, index_of[path], path, reads[:N_DEFAULT_PLAIN],
                      argv_of[path])


def rlc_section(wd, dev, smi, vanilla_idx, drive, record, collection, files,
                warm, argv_of, n_of, index_of) -> dict:
    """The RLC and textless indexes: the pan-genome's FASTA, both ``cli
    build`` runs (two processes at once), index bytes, the RLC entries'
    kernel checks, the k-mer table build on the RLC index (kernel A's
    per-step RLC entry; its launches go to ``record``), the eight RLC paths
    through ``drive`` (which fills the launch tables; ``collection`` is the
    -d path's folder), their output checks and one batch of each flavor
    through the plain versions. Returns the kernel records."""
    from columba_tpu_torch import native
    from columba_tpu_torch.index.bmove import BMoveIndex, load_bmove
    from columba_tpu_torch.index.kmer import (build_kmer_table,
                                              build_kmer_table_plain)
    from columba_tpu_torch.ops import extend
    from columba_tpu_torch.search import pipeline
    from columba_tpu_torch.search.scheme import get_multi_scheme, get_scheme
    from columba_tpu_torch.tools import workload

    t0 = time.time()
    pan = workload.pan_genome()
    n = len(pan)
    pan_fa = os.path.join(wd, "pan.fa")
    workload.write_fasta(pan_fa, pan, "pan")
    log(f"pan-genome: {n} bp in one sequence, {workload.PAN_HAPLOTYPES} "
        f"haplotypes of one base at {workload.PAN_SNP_RATE} SNP divergence "
        f"(seed {workload.PAN_SEED}), FASTA in {time.time() - t0:.1f} s")
    idx_of = {"rlc": os.path.join(wd, "pan_rlc.cidx"),
              "textless": os.path.join(wd, "pan_tl.cidx")}
    t0 = time.time()
    procs = {}
    try:
        for f, extra in (("rlc", ["--rlc"]),
                         ("textless", ["--rlc", "--textless"])):
            procs[f] = subprocess.Popen(
                [sys.executable, "-m", "columba_tpu_torch.cli", "build",
                 "-r", idx_of[f], "-f", pan_fa, *extra],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for f, proc in procs.items():
            _, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise AssertionError(f"cli build ({f}) failed:\n{err[-4000:]}")
            log(f"  {err.strip().splitlines()[-1]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"cli build --rlc and --rlc --textless (two processes at once): "
        f"{time.time() - t0:.1f} s")

    def disk(path):
        return sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))

    log(f"index bytes on disk: Vanilla (-s 4, the random genome of the same "
        f"length) {disk(vanilla_idx)}, rlc {disk(idx_of['rlc'])}, textless "
        f"{disk(idx_of['textless'])}")
    arrays = {f: load_bmove(idx_of[f]) for f in idx_of}
    bm = BMoveIndex.from_arrays(arrays["rlc"], dev)
    tl = BMoveIndex.from_arrays(arrays["textless"], dev)
    phi = arrays["textless"].phi_fwd.nbytes + arrays["textless"].phi_rev.nbytes
    log(f"pan-genome runs: fwd {bm.r_fwd} (r/n {bm.r_fwd / n:.4f}), rev "
        f"{bm.r_rev}; index bytes on the card: rlc {bm.nbytes()}, textless "
        f"{tl.nbytes()} (its phi tables stay on the host: {phi} bytes)")
    for name, ix in (("rlc", bm), ("textless", tl)):
        tab = ix.starts.nbytes + ix.run_at.nbytes + ix.run_at_rev.nbytes
        log(f"run tables of kernels A, B, E and F on the card, {name}: "
            f"starts {ix.starts.nbytes} + buckets {ix.run_at.nbytes} + "
            f"{ix.run_at_rev.nbytes} bytes "
            f"({tab / (ix.r_fwd + ix.r_rev):.2f} B a run; kernel C's walk "
            f"table {ix.walk.nbytes} bytes)")

    rng = np.random.default_rng(SEED + 2)
    starts = np.array([0, n], np.int64)
    reads, pos, nsub, flip = workload.sample_reads(pan, starts, N_RLC_READS,
                                                   rng, READ_LEN)
    m1, m2, pos_f, pos_r, nsub1, nsub2, swapped = workload.sample_pairs(
        pan, starts, N_RLC_PAIRS, rng, READ_LEN, frag_min=250, frag_max=450)
    batch = torch.from_numpy(np.concatenate(
        [reads[:BATCH], reads[:BATCH, ::-1] ^ 3])).to(dev)
    report = rlc_kernel_checks(bm, tl, batch)
    del batch

    # kernel A on the RLC index's 10-mer seed table (index/kmer.py; cli
    # align builds none on RLC, a library caller may pass one to
    # match_all): its table entry, one launch of 4^10 quads; then a library
    # caller's ten extend_char calls over the same 4^10 lanes (kernel A's
    # per-step RLC entry), which must leave the same table; 65,536 sampled
    # rows held to the plain exact match of their k-mers
    tables = {}
    for path, build, entry, n in (
            ("rlc_kmer_table", build_kmer_table, "table_rlc", 1),
            ("rlc_kmer_steps", build_kmer_table_plain, "rlc", 10)):
        for k in native.KERNELS.values():
            k.reset()
        torch.cuda.synchronize()
        t0 = time.time()
        tables[path] = build(bm, 10)
        torch.cuda.synchronize()
        dt = time.time() - t0
        entries = {f"{k}.{e}": c for k, v in native.KERNELS.items()
                   for e, c in v.by_entry.items()}
        record(path, {k: v.launches for k, v in native.KERNELS.items()},
               entries)
        log(f"path {path}: 10-mer table of the RLC index ({4 ** 10} lanes "
            f"x 8) in {dt:.3f} s; kernel A launches by entry {entries}")
        if entries != {f"extend.{entry}": n}:
            raise AssertionError(f"{path}: launched {entries}, not {n} of "
                                 f"extend.{entry}")
    table = tables["rlc_kmer_table"]
    codes = torch.from_numpy(rng.integers(0, 4 ** 10, 65_536)).to(dev)
    kmers = ((codes[:, None] >> (2 * torch.arange(9, -1, -1, device=dev)))
             & 3).to(torch.uint8).contiguous()
    want = extend.zero_empty(extend.exact_match_plain(bm, kmers))
    if (not torch.equal(table, tables["rlc_kmer_steps"])
            or not torch.equal(table[codes], want)):
        raise AssertionError("the RLC k-mer table differs from the ten "
                             "extend_char steps' or from the plain exact "
                             "match of its k-mers")
    log(f"rlc k-mer tables: {int((table[:, 1] > table[:, 0]).sum())} "
        f"k-mers occur; the table entry's equals the ten steps'; 65,536 "
        f"sampled rows equal the plain exact match")
    del table, tables, codes, kmers, want

    def fq(tag, codes, prefix="r"):
        path = os.path.join(wd, tag + ".fq")
        workload.write_fastq(path, codes, prefix)
        return path

    se = (fq("pan_se", reads), None)
    se_warm = (fq("pan_w", reads[:RLC_WARMUP], "w"), None)
    for path in RLC_PATHS:
        index_of[path] = idx_of["textless" if path.startswith("tl")
                                else "rlc"]
        files[path], warm[path], n_of[path] = se, se_warm, N_RLC_READS
    files["rlc_pe_best"] = files["rlc_pe_best_c"] = (
        fq("pan_p1", m1), fq("pan_p2", m2))
    warm["rlc_pe_best"] = warm["rlc_pe_best_c"] = (
        fq("pan_w1", m1[:RLC_WARMUP], "w"), fq("pan_w2", m2[:RLC_WARMUP], "w"))
    n_of["rlc_pe_best"] = n_of["rlc_pe_best_c"] = N_RLC_PAIRS
    files["rlc_se_all_rhs"] = (fq("pan_rhs", reads[:N_REC_READS]), None)
    n_of["rlc_se_all_rhs"] = N_REC_READS
    all_k = ["-a", "all", "-e", str(K), "-nD"]   # the JAX package's bench
    argv_of.update(rlc_se_all=all_k, tl_se_all=all_k,
                   rlc_se_best=["-a", "best"], tl_se_best=["-a", "best"],
                   rlc_pe_best=["-a", "best"],
                   rlc_se_all_dynamic=all_k + ["-p", "dynamic"],
                   rlc_se_best_d=["-a", "best", "-d", collection],
                   rlc_pe_best_c=["-a", "best", "-c",
                                  os.path.join(SCHEMES, "kuch_k+1")],
                   rlc_se_all_rhs=all_k)
    for path in RLC_PATHS:
        drive(path, f"pan-genome {n} bp, {path.split('_')[0]} index")

    # -- checks of what came out: the pan-genome is one sequence --
    seq_ids = {"pan": 0}

    def key(q, rev):
        return q * 2 + rev

    want_p1 = pos + 1
    occ_sets = {}
    for tag in ("rlc_se_all", "tl_se_all", "rlc_se_all_dynamic"):
        q, _, p1, fl, nm = parse_sam(os.path.join(wd, tag + ".sam"), seq_ids)
        want = np.nonzero(nsub <= K)[0]
        dist, _ = nearest((key(q, (fl & 16) > 0), p1, nm),
                          key(want, flip[want]), want_p1[want])
        lost = want[dist > K]
        log(f"{tag} lossless check: {len(want)} reads with <= {K} "
            f"substitutions; {int((dist == 0).sum())} at their exact begin, "
            f"{int(((dist > 0) & (dist <= K)).sum())} within {K} (end "
            f"errors), {len(lost)} missing; {len(q)} records")
        if len(lost):
            raise AssertionError(f"{tag}: reads not found at their locus: "
                                 f"{lost[:10].tolist()}")
        occ_sets[tag] = np.unique(np.stack([q, p1, fl & 16, nm], axis=1),
                                  axis=0)
    # both runs are lossless at k: -p dynamic reports the same occurrences
    a, b = occ_sets["rlc_se_all"], occ_sets["rlc_se_all_dynamic"]
    same = a.shape == b.shape and bool((a == b).all())
    log(f"rlc_se_all_dynamic against rlc_se_all on the same FASTQ: {len(b)} "
        f"and {len(a)} distinct (read, position, strand, NM) records, "
        f"{'the same set' if same else 'DIFFERENT sets'}")
    if not same:
        raise AssertionError("rlc_se_all_dynamic reports another occurrence "
                             "set than rlc_se_all")
    # the read-hit summary: every read with <= K substitutions lists the
    # pan-genome at a distance of at most its substitutions, and the reads
    # with a hit are the reads rlc_se_all maps
    hits = rhs_hits(os.path.join(wd, "rlc_se_all_rhs.rhs"))
    want = np.nonzero(nsub[:N_REC_READS] <= K)[0]
    lost = [int(i) for i in want
            if not any(d <= nsub[i] for _, d in hits.get(int(i), []))]
    q = parse_sam(os.path.join(wd, "rlc_se_all.sam"), seq_ids)[0]
    sam_mapped = set(np.unique(q[q < N_REC_READS]).tolist())
    rhs_mapped = {r for r, h in hits.items() if h}
    log(f"rlc_se_all_rhs check: {len(hits)} read lines of {N_REC_READS}; "
        f"{len(want)} reads with <= {K} substitutions, {len(lost)} without "
        f"a hit at most that far; {len(rhs_mapped)} reads with hits, "
        f"{len(sam_mapped)} mapped by rlc_se_all "
        f"({'the same reads' if rhs_mapped == sam_mapped else 'DIFFERENT'})")
    if lost or len(hits) != N_REC_READS or rhs_mapped != sam_mapped:
        raise AssertionError(f"rlc_se_all_rhs: lost {lost[:10]}, "
                             f"{len(hits)} lines, mapped sets differ: "
                             f"{rhs_mapped != sam_mapped}")
    for tag in ("rlc_se_best", "tl_se_best", "rlc_se_best_d"):
        pan_best_check(wd, tag, pos, nsub, flip, BEST_CUT)
    # PE BEST reports the pairs of least total distance; on the pan-genome
    # another haplotype may hold a better pair than the sampled one, so a
    # pair is missing when its best reported total is above its
    # substitutions, or equal to them without the sampled loci among the
    # pairs at that total
    want = np.nonzero((nsub1 <= 2) & (nsub2 <= 2))[0]
    t1 = np.where(swapped, pos_r, pos_f) + 1      # mate 1's sampled pos1
    t2 = np.where(swapped, pos_f, pos_r) + 1
    for tag in ("rlc_pe_best", "rlc_pe_best_c"):
        pairs = proper_pairs(os.path.join(wd, tag + ".sam"))
        missing, better = [], 0
        for i in want:
            got = pairs.get(int(i), [])
            best = min((tot for *_, tot in got), default=1 << 30)
            true_tot = int(nsub1[i] + nsub2[i])
            if best < true_tot:
                better += 1
            elif best > true_tot or not any(
                    tot == best and abs(a - t1[i]) <= 2
                    and abs(b - t2[i]) <= 2 for a, b, tot in got):
                missing.append(int(i))
        log(f"{tag} check: {len(want)} pairs with <= 2 substitutions in "
            f"each mate; {len(want) - better - len(missing)} reported as a "
            f"proper pair at both sampled loci, {better} with a better pair "
            f"elsewhere, {len(missing)} missing; {len(pairs)} pairs with a "
            f"proper pair")
        if missing:
            raise AssertionError(f"{tag}: pairs not found: {missing[:10]}")

    # one batch of each flavor again through the plain versions on the
    # card, and on the RLC index with dynamic partitioning and with scheme
    # selection (kuch1 and its mirror)
    for what, index, kw, nr in (
            ("the RLC index, switchpoint 4", bm, dict(switchpoint=4), BATCH),
            ("the textless index", tl, dict(host_arrays=arrays["textless"]),
             PLAIN_TL_READS),
            ("the RLC index, dynamic partitioning", bm,
             dict(switchpoint=4, partitioning="dynamic"), PLAIN_TL_READS),
            ("the RLC index, scheme selection", bm,
             dict(switchpoint=4, selection=True), PLAIN_TL_READS)):
        scheme = (get_multi_scheme("kuch1", K) if kw.pop("selection", False)
                  else get_scheme("kuch1", K))
        occ_k, _ = pipeline.match_all(index, reads[:nr], scheme, **kw)
        restore = plain_patch()
        try:
            occ_p, _ = pipeline.match_all(index, reads[:nr], scheme, **kw)
        finally:
            restore()
        for f in ("read_id", "strand", "begin", "end", "distance"):
            if not np.array_equal(getattr(occ_k, f), getattr(occ_p, f)):
                raise AssertionError(f"plain-path OccArray differs in {f} "
                                     f"on {what}")
        log(f"plain versions on the card, {what}, k = {K}: identical "
            f"OccArray for one batch of {nr} reads ({len(occ_k)} "
            f"occurrences)")
    # the reference's default run on the b-move indexes
    t_col = time.time()
    rlc_default_run(wd, pan, idx_of, drive, files, warm, argv_of, n_of,
                    index_of)
    log(f"default run on the b-move indexes: {time.time() - t_col:.1f} s")
    # the dist phase on the RLC index
    t_dist = time.time()
    dist_shards("rlc_dist_shards", bm, reads[:N_RLC_DIST_READS], nsub, pos,
                smi, record, regrow=True)
    log(f"dist phase on the RLC index: {time.time() - t_dist:.1f} s")
    return report


def blocked_section(wd, blk_idx, drive, launches_by_path, chk) -> None:
    """The blocked index (``cli build -B``, the smoke's genome in
    ``N_BLOCKS`` blocks of whole sequences; the > 4.29 Gbp regime the
    format exists for is out of the smoke's time): the four blocked paths
    through ``drive`` (each block's device memory held to its value before
    the block loaded), the lossless checks on their sampled loci, and their
    records against the monolithic index's runs of the same reads and
    flags (sorted, without @PG)."""
    from columba_tpu_torch.tools import workload

    with open(os.path.join(blk_idx, "meta.json")) as f:
        meta = json.load(f)
    log(f"blocked index: {meta['n']} bp, {meta['num_seqs']} sequences in "
        f"{len(meta['blocks'])} blocks "
        f"{[(b['dir'], b['n'], b['num_seqs']) for b in meta['blocks']]}")
    if len(meta["blocks"]) != N_BLOCKS:
        raise AssertionError(f"cli build -B {BLOCK_BP}: "
                             f"{len(meta['blocks'])} blocks, not {N_BLOCKS}")
    for path in BLOCKED_PATHS:
        drive(path, f"genome {workload.GENOME_N} bp in {N_BLOCKS} blocks")
    band = sum(launches_by_path[p]["band_step"] for p in BLOCKED_PATHS)
    log(f"kernel B on the blocked paths: {band} launches")
    if band == 0:
        raise AssertionError("kernel B launched on no blocked path")

    chk["se_all_check"]("blk_se_all", "blocked SE ALL", N_BLK_READS)
    chk["se_best_check"]("blk_se_best", "blocked SE BEST", N_BLK_READS)
    nsub, seq_of = chk["nsub"], chk["seq_of"]
    hits = rhs_hits(os.path.join(wd, "blk_se_rhs.rhs"))
    want = np.nonzero(nsub[:N_BLK_READS] <= K)[0]
    lost = [int(i) for i in want if not any(
        name == f"chr{seq_of[i] + 1}" and d <= nsub[i]
        for name, d in hits.get(int(i), []))]
    q = parse_sam(os.path.join(wd, "blk_se_all.sam"))[0]
    sam_mapped = set(np.unique(q).tolist())
    rhs_mapped = {r for r, h in hits.items() if h}
    log(f"blocked .rhs check: {len(hits)} read lines of {N_BLK_READS}; "
        f"{len(want)} reads with <= {K} substitutions, {len(lost)} without "
        f"their sequence at most that far; {len(rhs_mapped)} reads with "
        f"hits, {len(sam_mapped)} mapped by blk_se_all "
        f"({'the same reads' if rhs_mapped == sam_mapped else 'DIFFERENT'})")
    if lost or len(hits) != N_BLK_READS or rhs_mapped != sam_mapped:
        raise AssertionError(f"blk_se_rhs: lost {lost[:10]}, {len(hits)} "
                             f"lines, mapped sets differ: "
                             f"{rhs_mapped != sam_mapped}")
    want = np.nonzero((chk["nsub1"][:N_BLK_PAIRS] <= 2)
                      & (chk["nsub2"][:N_BLK_PAIRS] <= 2))[0]
    found, n_proper = chk["pe_check"](os.path.join(wd, "blk_pe_best.sam"),
                                      want, want, 2)
    log(f"blocked PE BEST check: {len(want)} pairs with <= 2 substitutions "
        f"in each mate; {int(found.sum())} reported as a proper pair at "
        f"both true loci, {int((~found).sum())} missing; {n_proper} "
        f"proper-pair records")
    if not found.all():
        raise AssertionError(f"blocked PE BEST: pairs not found: "
                             f"{want[~found][:10].tolist()}")
    # the blocked records are the monolithic index's
    for blk, mono, n in (("blk_se_all", "se_all", N_BLK_READS),
                         ("blk_se_best", "se_best", N_BLK_READS),
                         ("blk_pe_best", "pe_best_mono", None)):
        got = sam_body(os.path.join(wd, blk + ".sam"), ordered=False)
        ref = sam_body(os.path.join(wd, mono + ".sam"), n, ordered=False)
        log(f"{blk} against {mono} (monolithic index, the same reads and "
            f"flags): {len(got[1])} and {len(ref[1])} records, "
            f"{'the same sorted body' if got == ref else 'DIFFERENT'}")
        if got != ref:
            raise AssertionError(f"{blk}: records differ from the "
                                 f"monolithic index's ({mono})")

@contextlib.contextmanager
def smoke_dir():
    """The smoke's work directory, and the big build's state: the children
    that :func:`start_big_build` started are stopped on the way out,
    whatever happened."""
    with tempfile.TemporaryDirectory(prefix="columba_smoke_") as wd:
        st = dict(procs=[], lock=threading.Lock())
        try:
            yield wd, st
        finally:
            stop_children(st)


def start_big_build(wd: str, st: dict) -> None:
    """The big genome's FASTA (``workload.write_genome``, ``BIG_N`` bp in
    sequences of 2^27 bp with 40 runs of N) and its ``cli build`` (the CLI
    defaults, SA sparseness 4), two child processes one after the other in
    a thread of this process, so that both overlap the other sections.
    Fills ``st`` (from :func:`smoke_dir`) for :func:`finish_big_build`."""
    repo = os.path.dirname(os.path.abspath(__file__))
    st.update(fa=os.path.join(wd, "big.fa"), idx=os.path.join(wd, "big.cidx"),
              ns=os.path.join(wd, "big_n.npy"), t0=time.time())
    free = shutil.disk_usage(wd).free
    log(f"big genome: {BIG_N} bp; {free} bytes free on the work directory's "
        f"disk (FASTA about {BIG_N * 81 // 80} bytes, index about "
        f"{int(BIG_N * 2.41)} bytes)")

    def child(argv):
        with st["lock"]:
            if st.get("stopped"):
                raise RuntimeError("stopped")
            proc = subprocess.Popen(argv, cwd=repo, stdout=subprocess.DEVNULL,
                                    stderr=subprocess.PIPE)
            st["procs"].append(proc)
        # the children write little to stderr: one read after the exit
        _, status, ru = os.wait4(proc.pid, 0)
        proc.returncode = os.waitstatus_to_exitcode(status)
        return proc.returncode, proc.stderr.read().decode(errors="replace"), ru

    def run():
        try:
            t = time.time()
            rc, err, _ = child([sys.executable, "-c", BIG_FASTA, st["fa"],
                                str(BIG_SEED), str(BIG_N), st["ns"]])
            st["fasta_s"] = time.time() - t
            if rc != 0:
                raise RuntimeError(f"big FASTA failed:\n{err[-4000:]}")
            t = time.time()
            rc, err, ru = child([sys.executable, "-m",
                                 "columba_tpu_torch.cli", "build", "-v",
                                 "-r", st["idx"], "-f", st["fa"]])
            st.update(build_s=time.time() - t, maxrss_kib=ru.ru_maxrss,
                      build_err=err)
            if rc != 0:
                raise RuntimeError(f"big cli build failed:\n{err[-4000:]}")
        except BaseException as e:  # raised again by finish_big_build
            st["error"] = e

    st["thread"] = threading.Thread(target=run, daemon=True)
    st["thread"].start()


def stop_children(st: dict) -> None:
    with st["lock"]:
        st["stopped"] = True
        for proc in st["procs"]:
            if proc.returncode is None and proc.poll() is None:
                proc.kill()
                proc.wait()


def finish_big_build(st: dict) -> None:
    """Waits for :func:`start_big_build`'s thread; raises its failure."""
    t = time.time()
    st["thread"].join(timeout=max(BIG_BUILD_TIMEOUT - (t - st["t0"]), 1))
    if st["thread"].is_alive():
        stop_children(st)
        raise AssertionError(f"the big FASTA and cli build took more than "
                             f"{BIG_BUILD_TIMEOUT} s")
    if "error" in st:
        raise st["error"]
    log(f"big genome FASTA in {st['fasta_s']:.1f} s; cli build (-s 4, a "
        f"process beside the other sections) in {st['build_s']:.1f} s = "
        f"{BIG_N / st['build_s'] / 1e6:.2f} Mbp/s, peak host RSS "
        f"{st['maxrss_kib'] * 1024} bytes; waited {time.time() - t:.1f} s "
        f"for it; its steps (-v):")
    for line in st["build_err"].strip().splitlines():
        log(f"  {line}")


def big_section(wd, smi, st, drive, files, warm, argv_of, n_of, index_of,
                launches_by_path) -> None:
    """One index past 2^31 bases: the three big paths through ``drive``
    (reads sampled over every sequence, a third of them past 2^31), their
    lossless checks with the count of reads past 2^31 and of records on
    chr17 and later, big_se_all's first reads again through the plain
    versions (the same records), and kernels C and D against their plain
    versions on rows and windows of this index past 2^31."""
    from columba_tpu_torch import cli
    from columba_tpu_torch.index.build import decoded_text, load_index
    from columba_tpu_torch.index.kmer import build_kmer_table_cached
    from columba_tpu_torch.ops import locate, verify
    from columba_tpu_torch.search import pipeline
    from columba_tpu_torch.tools import bounds, workload

    t_sec = time.time()
    cli._DEVICE_INDEX_CACHE.clear()      # every earlier index released
    torch.cuda.empty_cache()
    idx = st["idx"]
    arrays = load_index(idx)
    starts = arrays.seq_starts
    n_seqs = len(starts) - 1
    rng = np.random.default_rng(BIG_SEED + 1)
    text = decoded_text(arrays)
    # at 3.1 Gbp no uniform read of 65,536 meets one of the 40 runs of N (a
    # repeat: every run holds the same seed cycle), and only those reads
    # need band steps; so the first reads begin at the runs, inside their
    # sequence, and the rest are uniform over every sequence
    ns = np.load(st["ns"])
    run_lo = ns[np.r_[True, np.diff(ns) > 1]]
    run_hi = ns[np.r_[np.diff(ns) > 1, True]] + 1
    runs = workload.reads_at_runs(text, starts, run_lo, run_hi,
                                  N_BIG_RUN_READS, rng, READ_LEN)
    at = runs[1]
    uni = workload.sample_reads(text, starts, N_BIG_READS - len(at), rng,
                                READ_LEN)
    reads, pos, nsub, flip = (np.concatenate(v) for v in zip(runs, uni))
    m1, m2, pos_f, pos_r, nsub1, nsub2, swapped = workload.sample_pairs(
        text, starts, N_BIG_PAIRS, rng, READ_LEN)
    del text, arrays
    log(f"big index: {n_seqs} sequences, chr17 begins at {starts[16]}; "
        f"{len(run_lo)} runs of N, {len(at)} reads at them; "
        f"{int((pos >= TWO31).sum())} of {N_BIG_READS} reads and "
        f"{int((pos_f >= TWO31).sum())} of {N_BIG_PAIRS} pairs begin past "
        f"2^31")

    def fq(tag, codes, prefix="r"):
        path = os.path.join(wd, tag + ".fq")
        workload.write_fastq(path, codes, prefix)
        return path

    files["big_se_all"] = files["big_se_best"] = (fq("big", reads), None)
    files["big_pe_best"] = (fq("bigp1", m1), fq("bigp2", m2))
    warm["big_se_all"] = warm["big_se_best"] = (
        fq("bigw", reads[:BIG_WARMUP], "w"), None)
    warm["big_pe_best"] = (fq("bigw1", m1[:BIG_WARMUP], "w"),
                           fq("bigw2", m2[:BIG_WARMUP], "w"))
    argv_of.update(big_se_all=["-a", "all", "-e", str(K)],
                   big_se_best=["-a", "best"], big_pe_best=["-a", "best"])
    n_of.update(big_se_all=N_BIG_READS, big_se_best=N_BIG_READS,
                big_pe_best=N_BIG_PAIRS)
    for path in BIG_PATHS:
        index_of[path] = idx
        drive(path, f"genome {BIG_N} bp in {n_seqs} sequences")
    (big_arrays, index), = cli._DEVICE_INDEX_CACHE.values()
    table = build_kmer_table_cached(index, 10, idx)
    log(f"big index on the card: {index.nbytes()} bytes + k-mer table "
        f"{table.nbytes} bytes")

    # -- what came out: every sampled read with few enough substitutions
    seq_of = np.searchsorted(starts, pos, side="right") - 1
    want_p1 = pos - starts[seq_of] + 1

    def key(q, rn, rev):               # up to 32 sequences
        return q * 64 + rn * 2 + rev

    def records(tag):
        recs = parse_sam(os.path.join(wd, tag + ".sam"))
        late = int((recs[1] >= 17).sum())
        log(f"{tag}: {len(recs[0])} records, {late} on chr17 or later")
        if late == 0:
            raise AssertionError(f"{tag}: no record on chr17 or later")
        return recs

    q, rn, p1, fl, nm = records("big_se_all")
    want = np.nonzero(nsub <= K)[0]
    dist, _ = nearest((key(q, rn - 1, (fl & 16) > 0), p1, nm),
                      key(want, seq_of[want], flip[want]), want_p1[want])
    lost = want[dist > K]
    past = want[pos[want] >= TWO31]
    lost_past = lost[pos[lost] >= TWO31]
    log(f"big SE ALL lossless check: {len(want)} reads with <= {K} "
        f"substitutions, {len(past)} of them past 2^31; {len(lost)} "
        f"missing, {len(lost_past)} of them past 2^31")
    if len(lost) or len(past) == 0:
        raise AssertionError(f"big SE ALL: reads not found "
                             f"{lost[:10].tolist()} (or none past 2^31)")

    q, rn, p1, fl, nm = records("big_se_best")
    best_nm = np.full(N_BIG_READS, 1 << 40, np.int64)
    np.minimum.at(best_nm, q, nm)
    want = np.nonzero(nsub <= BEST_CUT)[0]
    unmapped = want[best_nm[want] > BEST_CUT]
    worse = want[best_nm[want] > nsub[want]]
    at_n = want[best_nm[want] == nsub[want]]
    dist, _ = nearest((key(q, rn - 1, (fl & 16) > 0), p1, nm),
                      key(at_n, seq_of[at_n], flip[at_n]), want_p1[at_n])
    lost = at_n[dist > nsub[at_n]]
    bad = np.concatenate([unmapped, worse, lost])
    log(f"big SE BEST check: {len(want)} reads with <= {BEST_CUT} "
        f"substitutions ({int((pos[want] >= TWO31).sum())} past 2^31); "
        f"{len(unmapped)} without a record, {len(worse)} with best NM above "
        f"their substitutions, {len(lost)} missing their locus at best NM "
        f"({int((pos[bad] >= TWO31).sum())} of these past 2^31)")
    if len(bad) or not (pos[want] >= TWO31).any():
        raise AssertionError(f"big SE BEST: unmapped {unmapped[:5].tolist()}"
                             f", worse {worse[:5].tolist()}, lost "
                             f"{lost[:5].tolist()} (or none past 2^31)")

    q, rn, p1, fl, nm = records("big_pe_best")
    proper = (fl & 2) > 0
    ids = np.nonzero((nsub1 <= 2) & (nsub2 <= 2))[0]
    seq_f = np.searchsorted(starts, pos_f[ids], side="right") - 1
    found = np.ones(len(ids), bool)
    for mate_bit, is_fwd in ((64, ~swapped[ids]), (128, swapped[ids])):
        sel = proper & ((fl & mate_bit) > 0)
        true_pos = np.where(is_fwd, pos_f[ids], pos_r[ids])
        d, _ = nearest((key(q[sel], rn[sel] - 1, (fl[sel] & 16) > 0),
                        p1[sel], nm[sel]),
                       key(ids, seq_f, ~is_fwd), true_pos - starts[seq_f] + 1)
        found &= d <= 2
    past = pos_f[ids] >= TWO31
    log(f"big PE BEST check: {len(ids)} pairs with <= 2 substitutions in "
        f"each mate ({int(past.sum())} past 2^31); {int((~found).sum())} "
        f"missing ({int((~found & past).sum())} past 2^31); "
        f"{int(proper.sum())} proper-pair records")
    if not found.all() or not past.any():
        raise AssertionError(f"big PE BEST: pairs not found "
                             f"{ids[~found][:10].tolist()}")

    # big_se_all's first reads once more, through the plain versions
    plain_fq = fq("bigplain", reads[:N_BIG_PLAIN])
    out = os.path.join(wd, "big_plain.sam")
    restore = plain_patch()
    t0 = time.time()
    try:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main(["align", "-r", idx, "-S", "kuch1", "-b",
                           str(BATCH), "-f", plain_fq, "-o", out,
                           *argv_of["big_se_all"]])
    finally:
        restore()
    same = (rc == 0 and sam_body(out)
            == sam_body(os.path.join(wd, "big_se_all.sam"), N_BIG_PLAIN))
    past = int((pos[:N_BIG_PLAIN] >= TWO31).sum())
    log(f"plain versions on the card, big_se_all's first {N_BIG_PLAIN} "
        f"reads ({past} past 2^31): "
        f"{'the same records' if same else 'DIFFERENT records'} "
        f"({time.time() - t0:.1f} s)")
    if not same or past < N_BIG_PLAIN // 4:
        raise AssertionError("big_se_all through the plain versions gives "
                             "other records (or a quarter of the reads do "
                             "not lie past 2^31)")

    # kernels C and D on this index's rows and windows past 2^31
    dev = index.device
    g = torch.Generator(device="cpu").manual_seed(BIG_SEED)
    ml = pipeline.batch_max_locate(2 * BATCH)
    rows = torch.randint(0, index.n + 1, (4 * ml,), generator=g).to(dev)
    rows = rows[locate.locate_rows_plain(index, rows) >= TWO31][:ml]
    rows = rows.contiguous()
    out, rep = check_kernel("locate", lambda: locate.locate_rows(index, rows),
                            lambda: locate.locate_rows_plain(index, rows))
    _, steps = locate.locate_rows_plain(index, rows, return_steps=True)
    b = bounds.locate(rows, steps, out)
    log(f"kernel locate on the big index ({rows.numel()} rows whose "
        f"positions lie in [{int(out.min())}, {int(out.max())}]): equal to "
        f"plain; {rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} ms; "
        f"bound {b['bound_ms']:.5f} ms by {b['bound_by']} ({b['bytes']} "
        f"bytes), share {b['bound_ms'] / rep['ms']:.4f} ({smi})")
    text = decoded_text(big_arrays)
    R = 2 * BATCH
    rs = np.random.default_rng(BIG_SEED + 2)
    true_pos = np.where(
        rs.random(R) < 0.25,
        rs.integers(TWO31 - READ_LEN - 4, TWO31 + 4, R),   # across 2^31
        rs.integers(TWO31, index.n - READ_LEN - 4, R))
    pats = torch.from_numpy(np.ascontiguousarray(
        text[true_pos[:, None] + np.arange(READ_LEN)])).to(dev)
    rid_np = rs.integers(0, R, ml)
    rid = torch.from_numpy(rid_np).to(dev)
    for kb in (K, BEST_CUT):
        ws = torch.from_numpy(true_pos[rid_np] - kb
                              + rs.integers(-2, 3, ml)).to(dev)
        out, rep = check_kernel(
            "verify", lambda: verify.verify_window(index, pats, rid, ws, kb),
            lambda: verify.verify_window_plain(index, pats, rid, ws, kb))
        b = bounds.verify(pats, rid, ws, kb, out)
        log(f"kernel verify on the big index ({ml} candidates, kb={kb}, "
            f"window starts in [{int(ws.min())}, {int(ws.max())}], "
            f"{int((ws < TWO31).sum())} across 2^31): equal to plain; "
            f"{rep['ms']:.4f} ms vs plain {rep['plain_ms']:.4f} ms; bound "
            f"{b['bound_ms']:.5f} ms by {b['bound_by']} ({b['bytes']} bytes, "
            f"{b['operations']} operations), share "
            f"{b['bound_ms'] / rep['ms']:.4f} ({smi})")
    launches = {p: launches_by_path[p] for p in BIG_PATHS}
    log(f"big section: {time.time() - t_sec:.1f} s; launches {launches}")
    del table, index, text, big_arrays
    cli._DEVICE_INDEX_CACHE.clear()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available"
                         "() is false); this script runs only on the card")
    from columba_tpu_torch import cli, native
    from columba_tpu_torch.index.build import decoded_text, load_index
    from columba_tpu_torch.index.fmindex import FMIndex
    from columba_tpu_torch.index.kmer import build_kmer_table_cached
    from columba_tpu_torch.search import executor, pipeline
    from columba_tpu_torch.search.scheme import get_multi_scheme, get_scheme
    from columba_tpu_torch.tools import path_inputs, workload

    t_all = time.time()
    sections = Sections()
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    log(smi)

    t0 = time.time()
    # built from the checkout's sources on every run (a library left by an
    # earlier run would skip nvcc, and with it ptxas's report below)
    lib = os.path.join(native.BUILD_DIR, "libcolumba_kernels.so")
    if os.path.exists(lib):
        os.remove(lib)
    native.load_kernels()
    log(f"kernels built in {time.time() - t0:.1f} s "
        f"(nvcc {native.build_seconds.get('kernels', 0.0):.1f} s; by "
        f"source, all started together: " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(native.build_seconds.items())
            if k.endswith(".cu")) + ")")
    quad = 0
    for ln in native.ptxas_report(native.build_log.get("kernels", "")):
        log(f"  ptxas {ln}")
        if (ln.startswith(NO_FRAME) and not ln.startswith(GENERIC_B)
                and "stack frame" in ln):
            raise AssertionError(f"local memory in {ln}")
        quad += ln.startswith("band_step_quad_kernel<")
    # the quad body: every static (kb, W <= QUAD_MAX_W[kb]) and per-lane kb
    want = sum(executor.QUAD_MAX_W.values()) + len(executor.QUAD_MAX_W)
    log(f"  kernel B's quad body: {quad} instances in ptxas's report, none "
        f"with a stack frame (want {want})")
    if quad != want:
        raise AssertionError(f"ptxas reports {quad} quad-body instances, "
                             f"not {want}")
    sections.done("kernels build")

    with smoke_dir() as (wd, big):
        # the big genome's FASTA and index build beside every other section
        start_big_build(wd, big)
        rng = np.random.default_rng(SEED)
        fa, idx = os.path.join(wd, "genome.fa"), os.path.join(wd, "g.cidx")
        t0 = time.time()
        n_runs = workload.runs_of_n(workload.write_genome(fa, rng)[0])
        log(f"genome: {workload.GENOME_N} bp in {workload.N_SEQS} sequences "
            f"with N runs (seed {SEED}), FASTA in {time.time() - t0:.1f} s")
        t0 = time.time()
        assert cli.main(["build", "-r", idx, "-f", fa]) == 0
        log(f"cli build (-s 4) in {time.time() - t0:.1f} s")

        arrays = load_index(idx)
        text = decoded_text(arrays)
        starts = arrays.seq_starts
        reads, pos, nsub, flip = workload.sample_reads(text, starts, N_READS,
                                                       rng, READ_LEN)
        m1, m2, pos_f, pos_r, nsub1, nsub2, swapped = workload.sample_pairs(
            text, starts, N_READS, rng, READ_LEN)
        exact_pairs = np.nonzero((nsub1 == 0) & (nsub2 == 0))[0]

        def fq(tag, codes, prefix="r"):
            path = os.path.join(wd, tag + ".fq")
            workload.write_fastq(path, codes, prefix)
            return path

        files = {
            "se_all": (fq("all", reads[:N_READS_ALL]), None),
            "se_best": (fq("best", reads), None),
            "pe_best": (fq("p1", m1), fq("p2", m2)),
            "pe_all_e0": (fq("e1", m1[exact_pairs]), fq("e2", m2[exact_pairs])),
            "pe_all_e2": (fq("b1", m1[:N_PAIRS_E2]), fq("b2", m2[:N_PAIRS_E2])),
            "pe_best_static": (fq("s1", m1[:N_PAIRS_STATIC]),
                               fq("s2", m2[:N_PAIRS_STATIC])),
        }
        # the dynamic and the collection path read the SE ALL path's FASTQ
        files["se_all_dynamic"] = files["se_best_d"] = files["se_all"]
        # the record path: -T on FASTQ, and the same reads as FASTA
        fasta_reads = os.path.join(wd, "rec.fa")
        workload.write_fasta_reads(fasta_reads, reads[:N_REC_READS], "r")
        files["se_all_trim"] = (fq("rec", reads[:N_REC_READS]), None)
        files["se_all_fasta"] = (fasta_reads, None)
        # the blocked paths: SE ALL's first reads, the -p static path's pairs
        files["blk_se_all"] = files["blk_se_best"] = files["blk_se_rhs"] = (
            fq("blk", reads[:N_BLK_READS]), None)
        files["blk_pe_best"] = files["pe_best_static"]
        warm = {
            "se_all": (fq("w", reads[:WARMUP_READS], "w"), None),
            "pe_best": (fq("w1", m1[:WARMUP_READS], "w"),
                        fq("w2", m2[:WARMUP_READS], "w")),
        }
        warm["se_best"] = warm["se_all"]
        warm["pe_all_e0"] = (fq("we1", m1[exact_pairs[:4096]], "w"),
                             fq("we2", m2[exact_pairs[:4096]], "w"))
        warm["pe_all_e2"] = warm["pe_best_static"] = warm["pe_best"]
        warm["se_all_dynamic"] = warm["se_best_d"] = warm["se_all"]
        warm["se_all_trim"] = (fq("wr", reads[:REC_WARMUP], "w"), None)
        fasta_warm = os.path.join(wd, "wr.fa")
        workload.write_fasta_reads(fasta_warm, reads[:REC_WARMUP], "w")
        warm["se_all_fasta"] = (fasta_warm, None)
        warm["blk_se_all"] = warm["blk_se_best"] = warm["blk_se_rhs"] = (
            fq("wb", reads[:BLK_WARMUP], "w"), None)
        warm["blk_pe_best"] = (fq("wb1", m1[:BLK_WARMUP], "w"),
                               fq("wb2", m2[:BLK_WARMUP], "w"))
        # a collection of two schemes per k: kuch_k+1's searches and their
        # mirror, in the layout -d reads (<dir>/<k>/scheme<x>.txt)
        multi = os.path.join(wd, "collection")
        for k in range(1, BEST_CUT + 1):
            os.makedirs(os.path.join(multi, str(k)))
            base = get_scheme("kuch1", k)
            for x, sc in enumerate((base, base.mirrored()), 1):
                with open(os.path.join(multi, str(k), f"scheme{x}.txt"),
                          "w") as f:
                    f.write(str(sc) + "\n")
        argv_of = {
            "se_all": ["-a", "all", "-e", str(K)],
            "se_best": ["-a", "best"],
            "pe_best": ["-a", "best"],
            "pe_all_e0": ["-a", "all", "-e", "0"],
            "pe_all_e2": ["-a", "all", "-e", str(K)],
            "se_all_dynamic": ["-a", "all", "-e", str(K), "-p", "dynamic"],
            "se_best_d": ["-a", "best", "-d", multi],
            "pe_best_static": ["-a", "best", "-p", "static", "-nD", "-c",
                               os.path.join(SCHEMES, "kuch_k+1")],
            "se_all_trim": ["-a", "all", "-e", str(K), "-T",
                            f"{TRIM[0]}-{TRIM[1]}"],
            "se_all_fasta": ["-a", "all", "-e", str(K)],
            "blk_se_all": ["-a", "all", "-e", str(K)],
            "blk_se_best": ["-a", "best"],
            "blk_se_rhs": ["-a", "all", "-e", str(K)],
            # the blocked PE path infers on block 0 and the monolithic one on
            # all of the genome: both take the same fixed insert window
            "blk_pe_best": ["-a", "best", "--no-inferring"],
        }
        argv_of["pe_best_mono"] = argv_of["blk_pe_best"]
        n_of = {"se_all": N_READS_ALL, "se_best": N_READS,
                "pe_best": N_READS, "pe_all_e0": len(exact_pairs),
                "pe_all_e2": N_PAIRS_E2, "se_all_dynamic": N_READS_ALL,
                "se_best_d": N_READS_ALL, "pe_best_static": N_PAIRS_STATIC,
                "se_all_trim": N_REC_READS, "se_all_fasta": N_REC_READS,
                "blk_se_all": N_BLK_READS, "blk_se_best": N_BLK_READS,
                "blk_se_rhs": N_BLK_READS, "blk_pe_best": N_BLK_PAIRS}

        index = FMIndex.from_arrays(arrays, dev)
        # kernel A's table entry: the 10-mer seed table, built through the
        # cached table build that cli align calls, in one launch
        for k in native.KERNELS.values():
            k.reset()
        t0 = time.time()
        table = build_kmer_table_cached(index, 10, idx)
        torch.cuda.synchronize()
        kmer_launches = {k: v.launches for k, v in native.KERNELS.items()}
        kmer_entries = {f"{k}.{e}": n for k, v in native.KERNELS.items()
                        for e, n in v.by_entry.items()}
        log(f"index on device: {index.nbytes()} bytes + k-mer table "
            f"{table.nbytes} bytes, built in {time.time() - t0:.2f} s with "
            f"{kmer_launches['extend']} launch of kernel A ({kmer_entries})")
        if kmer_launches["extend"] != 1 or kmer_entries != {
                "extend.table": 1}:
            raise AssertionError(f"the k-mer table build launched "
                                 f"{kmer_entries}, not one extend.table")
        sections.done("Vanilla genome, build and k-mer table")
        report = kernel_checks(index, arrays, reads, table)
        sections.done("kernel checks")

        index_of = {}                # path -> index dir (default: idx)
        blk_idx = os.path.join(wd, "g_blocked.cidx")
        for path in BLOCKED_PATHS:
            index_of[path] = blk_idx

        def align(path, files_, out_tag, extra=()):
            suffix = ".rhs" if path in RHS_PATHS else ".sam"
            argv = ["align", "-r", index_of.get(path, idx), "-S", "kuch1",
                    "-b", str(BATCH), "-f", files_[0],
                    "-o", os.path.join(wd, out_tag + suffix),
                    *argv_of[path], *extra]
            if files_[1] is not None:
                argv += ["-F", files_[1]]
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = cli.main(argv)
            assert rc == 0
            return err.getvalue()

        launches_by_path = {"kmer_table": kmer_launches}
        entries_by_path = {"kmer_table": kmer_entries}

        def record(path, launches, entries):
            launches_by_path[path] = launches
            entries_by_path[path] = entries

        shapes_by_path: dict = {}    # kernel B's launch census (by_shape)
        runs = [0]                   # run_scheme calls of a path
        run_scheme = executor.run_scheme
        frontier_seed = executor.frontier_seed
        # per kernel I seed launch: device bytes it allocated, the lanes'
        # ranges' bytes, and the (L x T, BW) cell array's bytes at its
        # run_scheme's shape (the array seeds wrote before the cells were
        # read at use)
        seeds: list = []
        cells_of = [0]

        def counted_run_scheme(*a, **kw):
            runs[0] += 1
            reads = a[1] if len(a) > 1 else kw["reads"]
            sched = a[2] if len(a) > 2 else kw["sched"]
            cells_of[0] = (reads.shape[0] * sched.num_searches * sched.t_max
                           * sched.bw if kw.get("dyn") is None else 0)
            return run_scheme(*a, **kw)

        def measured_seed(*a, **kw):
            before = torch.cuda.memory_allocated()
            out = frontier_seed(*a, **kw)
            seeds.append((torch.cuda.memory_allocated() - before,
                          out.numel() * out.element_size(), cells_of[0]))
            return out

        def drive(path, genome_what):
            """One path: a warm-up align, then the counted and timed one
            with every launch count reset just before. On the paths of
            ``CAPTURE_PATHS`` the warm-up's inputs to kernels C and D are
            kept, and those kernels are timed on them after the path."""
            t0 = time.time()
            warm_up = lambda: align(path, warm[path], "warm")  # noqa: E731
            il_calls: dict = {}
            captured = (path_inputs.capture(lambda: il_calls.update(
                path_inputs.capture_entries(warm_up)))
                if path in CAPTURE_PATHS else warm_up())
            t_warm = time.time() - t0
            for k in native.KERNELS.values():
                k.reset()
            runs[0] = 0
            log_path = os.path.join(wd, path + ".log")
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            executor.run_scheme = counted_run_scheme
            executor.frontier_seed = measured_seed
            seeds.clear()
            blocks: list = []
            t0 = time.time()
            try:
                with (block_memory(blocks) if path in BLOCKED_PATHS
                      else contextlib.nullcontext()):
                    err = align(path, files[path], path,
                                ("-v", "-l", log_path))
                torch.cuda.synchronize()
            finally:
                executor.run_scheme = run_scheme
                executor.frontier_seed = frontier_seed
            dt = time.time() - t0
            launches = {k: v.launches for k, v in native.KERNELS.items()}
            launches_by_path[path] = launches
            entries = {f"{k}.{e}": n for k, v in native.KERNELS.items()
                       for e, n in v.by_entry.items()}
            entries_by_path[path] = entries
            peak = torch.cuda.max_memory_allocated()
            with open(log_path) as f:
                retries = int(re.search(
                    r"Lossless spill retries[^:]*: (\d+)", f.read()).group(1))
            unit = "pairs" if files[path][1] else "reads"
            what = ("FASTA" if files[path][0].endswith(".fa") else "FASTQ")
            what += " -> " + (".rhs" if path in RHS_PATHS else "SAM")
            m = (TRIM[1] - TRIM[0] if "-T" in argv_of[path]
                 else READ_LEN_OF.get(path, READ_LEN))
            shapes_by_path[path] = {k: dict(v.by_shape)
                                    for k, v in native.KERNELS.items()
                                    if v.by_shape}
            band_shapes = shapes_by_path[path].get("band_step", {})
            quads = sum(n for sh, n in band_shapes.items()
                        if sh.endswith(" quad"))
            if quads:                # kernel B's quad body, for the record
                entries["band_step.quad"] = quads
            log(f"path {path}: {n_of[path]} {unit} x {m} bp in "
                f"{dt:.3f} s = {n_of[path] / dt:.1f} {unit}/s ({what}, "
                f"{genome_what}, {smi}; warm-up "
                f"{t_warm:.1f} s); lossless retries {retries}; peak device "
                f"memory {peak} bytes ({base} allocated before the run); "
                f"kernel launches {launches}"
                + (f", of them by entry {entries}" if entries else ""))
            for ln in err.splitlines():
                if "inferred" in ln:
                    log(f"  {ln}")
            for bdir, before, ixb, tb, after in blocks:
                log(f"  block {bdir}: index {ixb} bytes + k-mer table {tb} "
                    f"bytes on the card; allocated {before} bytes before it "
                    f"loaded, {after} after it was released "
                    f"({after - before:+d})")
                if after - before > BLOCK_MEM_SLACK or ixb == 0:
                    raise AssertionError(
                        f"path {path}: block {bdir} left {after - before} "
                        f"bytes on the card (or loaded no index)")
            if path in BLOCKED_PATHS and len(blocks) != N_BLOCKS:
                raise AssertionError(f"path {path}: {len(blocks)} blocks "
                                     f"loaded, not {N_BLOCKS}")
            loops = sum(v for e, v in entries.items()
                        if e in ("extend.loop", "extend.loop_rlc"))
            log(f"  kernel A's loop: {loops} launches in {runs[0]} "
                f"run_scheme calls"
                + (f" ({loops / runs[0]:.2f} per call)" if runs[0] else "")
                + f"; kernel B: {launches['band_step']} launches"
                + (f", by entry, radius, registers and instance "
                   f"{band_shapes}" if band_shapes else "")
                + "".join(f"; kernel {k} by shape {v}"
                          for k, v in shapes_by_path[path].items()
                          if k != "band_step"))
            # kb 5..7 with one or two registers: a templated instance in
            # every entry, never the generic one; kb 8..13 with a W of the
            # quad body's in the Vanilla entries: the quad body
            generic = [k for k in band_shapes if k.endswith(" generic")
                       and (re.search(r" kb[5-7] W[12] ", k) or quad_shape(k))]
            if generic:
                raise AssertionError(f"path {path}: kernel B's generic "
                                     f"entry at {generic}")
            missing_shapes = [
                f"{k} {sh}" for k, need in PATH_SHAPES.get(
                    path, {}).items() for sh in need
                if shapes_by_path[path].get(k, {}).get(sh, 0) == 0]
            if missing_shapes:
                raise AssertionError(f"path {path}: no launch of "
                                     f"{missing_shapes}")
            if loops > 2 * runs[0]:
                raise AssertionError(f"path {path}: more than two exact "
                                     "loop launches per run_scheme call")
            missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
            missing += [e for e in PATH_ENTRIES.get(path, ())
                        if entries.get(e, 0) == 0]
            if missing:
                raise AssertionError(f"kernels not launched on path {path}: "
                                     f"{missing}")
            if seeds:
                got = max(b for b, _, _ in seeds)
                lanes = max(n for _, n, _ in seeds)
                cells = max(c for _, _, c in seeds)
                log(f"  kernel I's seed: at most {got} device bytes "
                    f"allocated a run_scheme call ({len(seeds)} calls): the "
                    f"lanes' ranges ({lanes} bytes); no (L x T, BW) cell "
                    f"array" + (f" (it would take {cells} bytes at this "
                                f"path's widest call)" if cells else ""))
                # other threads (a re-run on the emitter's) may allocate
                # beside a seed call, so the check is against the array
                if cells and got >= cells:
                    raise AssertionError(f"path {path}: kernel I's seed "
                                         f"allocated {got} bytes, as much "
                                         f"as the cell array's {cells}")
            if path in DYNAMIC_PATHS:
                batches = -(-n_of[path] // BATCH)
                log(f"  kernel F: {launches['dynpart']} launches for "
                    f"{batches} batches, {retries} lossless re-runs")
                if launches["dynpart"] != batches:
                    raise AssertionError(f"path {path}: kernel F launched "
                                         f"{launches['dynpart']} times for "
                                         f"{batches} batches")
            if path in CAPTURE_PATHS:
                path_input_times(path, captured, smi)
                entry_checks(f"{path}'s own inputs, {smi}", il_calls,
                             prof=path == "se_all")

        for path in PATH_KERNELS:
            if path not in (*RLC_PATHS, *RLC_COL_PATHS, *BLOCKED_PATHS,
                            *BIG_PATHS, *README_PATHS, *COL250_PATHS):
                drive(path, f"genome {workload.GENOME_N} bp")
        # the monolithic reference of the blocked PE path: its pairs and
        # flags on this index
        align("pe_best_mono", files["blk_pe_best"], "pe_best_mono")

        # kernel H's path: the gather bench, its entry point, at one size
        from columba_tpu_torch.tools import gather_bench

        for k in native.KERNELS.values():
            k.reset()
        gather_rows = gather_bench.run(lanes=(GATHER_LANES,),
                                       row_words=(16, 4), reps=5)
        launches = {k: v.launches for k, v in native.KERNELS.items()}
        launches_by_path["gather_bench"] = launches
        entries_by_path["gather_bench"] = {}
        for r in gather_rows:
            log(f"path gather_bench: {r['impl']}, {r['row_bytes']} B rows, "
                f"{r['lanes']} lanes, chain of {gather_bench.CHAIN}: "
                f"{r['chain_ms']:.4f} ms = {r['mrows_per_s']:.1f} M rows/s, "
                f"{r['gbps']:.2f} GB/s; one gather alone "
                f"{r['alone_ms']:.4f} ms = {r['alone_mrows_per_s']:.1f} M "
                f"rows/s ({smi})")
        if launches["gather"] == 0:
            raise AssertionError("kernel gather not launched by its bench")

        # -- checks of what came out --
        sample = (starts, pos, nsub, flip)
        seq_of = np.searchsorted(starts, pos, side="right") - 1

        def se_all_check(tag, label, n_reads=N_READS_ALL, trim=None):
            return all_locus_check(wd, sample, tag, label, n_reads, K, trim)

        uni = se_all_check("se_all", "SE ALL")
        dyn = se_all_check("se_all_dynamic", "SE ALL -p dynamic")
        # both runs are lossless at k, so they report the same occurrences
        occ_sets = [np.unique(np.stack([q, rn, p1, fl & 16, nm], axis=1),
                              axis=0) for q, rn, p1, fl, nm in (uni, dyn)]
        same = (occ_sets[0].shape == occ_sets[1].shape
                and bool((occ_sets[0] == occ_sets[1]).all()))
        log(f"SE ALL -p dynamic against SE ALL (uniform) on the same FASTQ: "
            f"{len(occ_sets[1])} and {len(occ_sets[0])} distinct (read, "
            f"sequence, position, strand, NM) records, "
            f"{'the same set' if same else 'DIFFERENT sets'}")
        if not same:
            raise AssertionError("SE ALL -p dynamic reports another "
                                 "occurrence set than the uniform run")

        def se_best_check(tag, label, n_reads):
            best_locus_check(wd, sample, tag, label, n_reads, BEST_CUT)

        se_best_check("se_best", "SE BEST", N_READS)
        se_best_check("se_best_d", "SE BEST -d (two-scheme collection)",
                      N_READS_ALL)

        # the record path: -T on FASTQ, and FASTA input
        se_all_check("se_all_trim", f"SE ALL -T {TRIM[0]}-{TRIM[1]}",
                     N_REC_READS, TRIM)
        se_all_check("se_all_fasta", "SE ALL, FASTA reads", N_REC_READS)
        same = (sam_body(os.path.join(wd, "se_all_fasta.sam"))
                == sam_body(os.path.join(wd, "se_all.sam"), N_REC_READS))
        log(f"SE ALL on FASTA reads against SE ALL on the same reads as "
            f"FASTQ (native parser and emitter): "
            f"{'the same records' if same else 'DIFFERENT records'}")
        if not same:
            raise AssertionError("FASTA reads give other records than the "
                                 "same reads as FASTQ")

        # PE: a pair is found when both mates have a proper-pair record at
        # their true loci. Mate 1 is the forward-strand mate unless swapped.
        # ``ids`` are the pairs' rows in the sample, ``names`` their record
        # names' numbers in this FASTQ.
        def pe_check(sam_path, ids, names, tol):
            q, rn, p1, fl, nm = parse_sam(sam_path)
            proper = (fl & 2) > 0
            seq_f = np.searchsorted(starts, pos_f[ids], side="right") - 1
            found = np.ones(len(ids), bool)
            for mate_bit, is_fwd in ((64, ~swapped[ids]), (128, swapped[ids])):
                sel = proper & ((fl & mate_bit) > 0)
                true_pos = np.where(is_fwd, pos_f[ids], pos_r[ids])
                d, _ = nearest(
                    (se_key(q[sel], rn[sel] - 1, (fl[sel] & 16) > 0),
                     p1[sel], nm[sel]),
                    se_key(names, seq_f, ~is_fwd),
                    true_pos - starts[seq_f] + 1)
                found &= d <= tol
            return found, int(proper.sum())

        want = np.nonzero((nsub1 <= 2) & (nsub2 <= 2))[0]
        found, n_proper = pe_check(os.path.join(wd, "pe_best.sam"), want,
                                   want, 2)
        log(f"PE BEST check: {len(want)} pairs with <= 2 substitutions in "
            f"each mate; {int(found.sum())} reported as a proper pair at "
            f"both true loci, {int((~found).sum())} missing; {n_proper} "
            f"proper-pair records")
        if not found.all():
            raise AssertionError(f"PE BEST: pairs not found: "
                                 f"{want[~found][:10].tolist()}")
        found, n_proper = pe_check(
            os.path.join(wd, "pe_all_e0.sam"), exact_pairs,
            np.arange(len(exact_pairs)), 0)
        log(f"PE ALL -e 0 check: {len(exact_pairs)} pairs sampled without a "
            f"substitution; {int(found.sum())} reported as a proper pair at "
            f"both exact loci, {int((~found).sum())} missing; {n_proper} "
            f"proper-pair records; kernel E launches "
            f"{launches_by_path['pe_all_e0']['exact']}")
        if not found.all():
            raise AssertionError(f"PE ALL -e 0: pairs not found: "
                                 f"{exact_pairs[~found][:10].tolist()}")
        want = want[want < N_PAIRS_E2]
        found, n_proper = pe_check(os.path.join(wd, "pe_all_e2.sam"), want,
                                   want, K)
        log(f"PE ALL -e {K} check (band-only path): {len(want)} pairs with "
            f"<= {K} substitutions in each mate; {int(found.sum())} reported "
            f"as a proper pair at both true loci, {int((~found).sum())} "
            f"missing; {n_proper} proper-pair records")
        if not found.all():
            raise AssertionError(f"PE ALL -e {K}: pairs not found: "
                                 f"{want[~found][:10].tolist()}")
        want = want[want < N_PAIRS_STATIC]
        found, n_proper = pe_check(os.path.join(wd, "pe_best_static.sam"),
                                   want, want, 2)
        log(f"PE BEST -p static -c -nD check: {len(want)} pairs with <= 2 "
            f"substitutions in each mate; {int(found.sum())} reported as a "
            f"proper pair at both true loci, {int((~found).sum())} missing; "
            f"{n_proper} proper-pair records")
        if not found.all():
            raise AssertionError(f"PE BEST -p static: pairs not found: "
                                 f"{want[~found][:10].tolist()}")

        # one batch again through the plain versions on the card: the scheme
        # path at k = 2, the exact pass at k = 0, dynamic partitioning, and
        # scheme selection over kuch1 and its mirror
        for k, kw in ((K, dict(kmer_table=table, switchpoint=4)), (0, {}),
                      (K, dict(kmer_table=table, switchpoint=4,
                               partitioning="dynamic")),
                      (K, dict(kmer_table=table, switchpoint=4,
                               selection=True))):
            scheme = get_scheme("kuch1", k)
            if kw.pop("selection", False):
                scheme = get_multi_scheme("kuch1", k)
            occ_k, _ = pipeline.match_all(index, reads[:BATCH], scheme, **kw)
            restore = plain_patch()
            try:
                occ_p, _ = pipeline.match_all(index, reads[:BATCH], scheme,
                                              **kw)
            finally:
                restore()
            for f in ("read_id", "strand", "begin", "end", "distance"):
                if not np.array_equal(getattr(occ_k, f), getattr(occ_p, f)):
                    raise AssertionError(
                        f"plain-path OccArray differs in {f} at k = {k}")
            what = ("scheme selection" if isinstance(scheme, list) else
                    kw.get("partitioning", "uniform") + " partitioning")
            log(f"plain versions on the card, k = {k}, {what}: identical "
                f"OccArray for one batch ({len(occ_k)} occurrences)")

        sections.done("Vanilla paths and checks")

        # the README's two align commands, and the conformance fuzz
        readme_section(wd, idx, index, table, text, n_runs, reads, sample,
                       drive, files, warm, argv_of, n_of, smi, record)
        sections.done("readme")
        # the default run on 250 bp reads: kernel B's quad body
        col250_section(wd, idx, index, table, text, n_runs, starts, drive,
                       files, warm, argv_of, n_of, smi, report)
        sections.done("col250")

        # the dist phase at the headline width (SE ALL's reads from
        # DIST_FIRST, the 10-mer table, switchpoint 4): shards in this
        # process, then rank processes joined by gloo on the one card
        t_dist = time.time()
        d = slice(DIST_FIRST, DIST_FIRST + DIST_SHARDS * DIST_READS)
        occ = dist_shards("dist_shards", index, reads[d], nsub[d], pos[d],
                          smi, record, kmer_table=table, plain=True)
        dist_ranks("dist_ranks", idx, fq("dist", reads[d]), occ, smi, record)
        log(f"dist phase on the Vanilla index: {time.time() - t_dist:.1f} s")
        sections.done("dist")

        del index, table         # card memory for the RLC indexes
        # the blocked build runs beside the RLC section's builds
        t_blk = time.time()
        blk_build = subprocess.Popen(
            [sys.executable, "-m", "columba_tpu_torch.cli", "build", "-r",
             blk_idx, "-f", fa, "-B", str(BLOCK_BP)],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        try:
            report.update(rlc_section(
                wd, dev, smi, idx, drive, record, multi, files, warm,
                argv_of, n_of, index_of))
            _, err = blk_build.communicate(timeout=900)
        finally:
            if blk_build.poll() is None:
                blk_build.kill()
                blk_build.wait()
        if blk_build.returncode != 0:
            raise AssertionError(f"cli build -B failed:\n{err[-4000:]}")
        log(f"cli build -B {BLOCK_BP} (a process beside the RLC section, "
            f"done {time.time() - t_blk:.1f} s after its start): "
            f"{err.strip().splitlines()[-1]}")
        sections.done("RLC, the blocked build beside it")
        blocked_section(wd, blk_idx, drive, launches_by_path, dict(
            starts=starts, seq_of=seq_of, nsub=nsub, flip=flip,
            se_all_check=se_all_check, se_best_check=se_best_check,
            pe_check=pe_check, nsub1=nsub1, nsub2=nsub2))
        sections.done("blocked")
        # last, with every other index released: one index past 2^31 bases
        finish_big_build(big)
        sections.done("wait for the big build")
        big_section(wd, smi, big, drive, files, warm, argv_of, n_of,
                    index_of, launches_by_path)
        sections.done("big")

    # one record per kernel, and one more for each named entry of kernels
    # A, B, C, E and I-L (its launches are a share of its kernel's)
    replaces = {"band_step.per_lane": "columba_tpu/search/executor.py:600",
                "exact.lengths": "columba_tpu/search/pipeline.py:381",
                "extend.loop": "columba_tpu/search/executor.py:437",
                "extend.loop_rlc": "columba_tpu/search/executor.py:437",
                "band_step.rlc": "columba_tpu/search/executor.py:587",
                "band_step.textless": "columba_tpu/search/pipeline.py:770",
                "exact.rlc": "columba_tpu/ops/bextend.py:259",
                "locate.rlc": "columba_tpu/ops/blocate.py:40",
                "extend.rlc": "columba_tpu/ops/bextend.py:259",
                "extend.table": "columba_tpu/index/kmer.py:48",
                "extend.table_rlc": "columba_tpu/index/kmer.py:48",
                "exact.rlc_lengths": "columba_tpu/search/pipeline.py:381",
                "dynpart.rlc": "columba_tpu/search/dynschedule.py:283",
                "band_step.per_lane_rlc":
                    "columba_tpu/search/executor.py:600",
                "frontier.drain": "columba_tpu/search/executor.py:349",
                "frontier.init": "columba_tpu/search/executor.py:521",
                "frontier.ex_compact": "columba_tpu/search/executor.py:468",
                "frontier.ex_back": "columba_tpu/search/executor.py:468",
                "frontier.tail": "columba_tpu/search/executor.py:880",
                "expand.frontier_tail": "columba_tpu/search/pipeline.py:132",
                "expand.ranges": "columba_tpu/search/pipeline.py:169",
                "expand.rows": "columba_tpu/search/pipeline.py:169",
                "dedup.windows": "columba_tpu/search/pipeline.py:268",
                "dedup.keys": "columba_tpu/search/pipeline.py:194",
                "dedup.pass": "columba_tpu/search/pipeline.py:210",
                "dedup.compact": "columba_tpu/search/pipeline.py:194"}
    sources = {"band_step.quad": "columba_tpu_torch/csrc/band_step_wide.cuh"}
    replaces["band_step.quad"] = "columba_tpu/search/executor.py:587"
    kernels = []
    for k in native.KERNELS.values():
        entries = [k.name] + [n for n in report if n.startswith(k.name + ".")]
        for entry in entries:
            r = report[entry]
            counts = launches_by_path if entry == k.name else entries_by_path
            by_path = {p: ln.get(entry, 0) for p, ln in counts.items()}
            if sum(by_path.values()) == 0:
                raise AssertionError(f"kernel {entry} launched on no path")
            kernels.append(dict(
                name=entry, route="cuda",
                source=sources.get(entry,
                                   k.source_of(entry.partition(".")[2])),
                replaces=replaces.get(entry, k.replaces),
                launches=sum(by_path.values()), launches_by_path=by_path,
                max_abs_err=r["max_abs_err"], ms=r["ms"],
                prof_ms=r.get("prof_ms"),
                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], library_ms=r["library_ms"],
                sort_ms=r.get("sort_ms"),
                bound_bytes=r["bound_bytes"],
                bound_operations=r["bound_operations"]))
    log("sections: " + "; ".join(f"{n} {t:.1f} s" for n, t in sections.rows))
    log(f"total smoke time {time.time() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
