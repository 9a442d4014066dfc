"""Command-line interface of the PyTorch port: ``build`` and ``align``.

The counterpart of ``columba_tpu/cli.py`` with the same option names. The
port covers the Vanilla and RLC index builds (``--rlc``, ``--rlc
--textless``) and the alignment of FASTQ input to SAM in ALL and BEST(+x)
mode, single-end and paired-end, with uniform, static or dynamic
partitioning, builtin schemes, scheme folders (``-c``) and scheme
collections with per-read selection (``-d``), on the Vanilla and the
with-text RLC index; the textless index aligns single-end only, without
CIGARs and without in-text verification, as in the JAX package. What is
still missing raises ``NotImplementedError`` naming its ROADMAP item.

Alignment runs on the CUDA device (``--device cuda``, the default) and
raises if there is none; ``--device cpu`` runs the plain PyTorch versions
of the kernels instead, which is how the CPU tests run it.

Usage: python -m columba_tpu_torch.cli <build|align> ...
"""

from __future__ import annotations

import argparse
import os
import sys
import time

PROGRAM = "ColumbaTorch"


def main(argv=None):
    parser = argparse.ArgumentParser(prog="columba_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build an index from FASTA file(s)")
    b.add_argument("-r", "--index", required=True, help="output index dir")
    b.add_argument("-f", "--fasta", nargs="+", default=None)
    b.add_argument("-F", "--fasta-list", default=None,
                   help="text file listing FASTA paths, one per line")
    b.add_argument("-s", "--sa-sparseness", type=int, default=4)
    b.add_argument("-a", "--all-sa-sparseness", action="store_true",
                   help="sample the full SA (sparseness 1)")
    b.add_argument("-l", "--seed-length", type=int, default=100,
                   help="seed string length for non-ACGT replacement, 0 = "
                        "random")
    b.add_argument("--seed", type=int, default=42,
                   help="RNG seed for non-ACGT replacement (seed-length 0)")
    b.add_argument("--write-preprocessed", action="store_true")
    b.add_argument("--rlc", action="store_true",
                   help="build the run-length-compressed (b-move) flavor")
    b.add_argument("--textless", action="store_true",
                   help="with --rlc: drop the packed text and the strided "
                        "SA samples, so the index scales with the BWT run "
                        "count; alignment then reports positions without "
                        "CIGARs and forces -i 0")
    b.add_argument("-B", "--max-block-bp", type=int, default=None,
                   help="block-partitioned index (not ported yet)")
    b.add_argument("--log-file", default=None)
    b.add_argument("-v", "--verbose", action="store_true")

    a = sub.add_parser("align", help="map reads against an index")
    a.add_argument("-r", "--index", required=True)
    a.add_argument("-f", "--reads", required=True)
    a.add_argument("-F", "--reads2", default=None,
                   help="second reads file (paired-end)")
    a.add_argument("-O", "--orientation", choices=["fr", "rf", "ff"],
                   default="fr")
    a.add_argument("-X", "--max-insert-size", type=int, default=500)
    a.add_argument("-N", "--min-insert-size", type=int, default=0)
    a.add_argument("--no-inferring", action="store_true")
    a.add_argument("-o", "--output", required=True)
    a.add_argument("-e", "--max-distance", type=int, default=0,
                   help="ALL-mode max distance")
    a.add_argument("-a", "--mode", choices=["all", "best"], default="best")
    a.add_argument("-m", "--metric", choices=["edit", "hamming"],
                   default="edit")
    a.add_argument("-S", "--scheme", default="kuch1")
    a.add_argument("-c", "--custom", default=None, metavar="DIR",
                   help="custom search scheme folder (reference -c; "
                        "dynamic selection via mirror unless -nD)")
    a.add_argument("-d", "--dynamic-selection-path", default=None,
                   metavar="DIR",
                   help="folder of scheme<x>.txt collections per k for "
                        "dynamic selection (reference -d)")
    a.add_argument("-x", "--best-plus-x", type=int, default=0)
    a.add_argument("-I", "--min-identity", type=int, default=95)
    a.add_argument("-K", "--kmer-size", type=int, default=10,
                   help="seed k-mer length, 0 disables (dense table caps at "
                        "13)")
    a.add_argument("-b", "--batch-size", type=int, default=512)
    a.add_argument("-t", "--threads", type=int, default=None,
                   help="accepted for compatibility")
    a.add_argument("-l", "--log-file", default=None)
    a.add_argument("-v", "--verbose", action="store_true")
    a.add_argument("-R", "--reorder", action="store_true",
                   help="accepted for compatibility; output is always in "
                        "input order")
    a.add_argument("-nC", "--no-CIGAR", dest="no_cigar", action="store_true",
                   help="do not output CIGAR strings")
    a.add_argument("-aC", "--activate-CIGAR", dest="activate_cigar",
                   action="store_true",
                   help="force CIGAR output (the RLC flavor defaults to "
                        "none)")
    a.add_argument("-D", "--discordant", nargs="?", type=int, const=100000,
                   default=None, metavar="N",
                   help="allow discordant pairs, optionally at most N per "
                        "pair")
    a.add_argument("--capacity", type=int, default=None)
    a.add_argument("--no-kmer-table", action="store_true",
                   help="disable the dense k-mer seed table")
    a.add_argument("-XA", "--xa-tag", action="store_true",
                   help="fold secondary alignments into the XA tag")
    a.add_argument("-nU", "--no-unmapped", action="store_true",
                   help="do not output unmapped reads")
    a.add_argument("-nD", "--no-dynamic-selection", action="store_true",
                   help="disable per-read dynamic scheme selection")
    a.add_argument("--probe-selection", action="store_true",
                   help="force the per-read exact-range probe for the "
                        "builtin 'columba' set (identical output)")
    # Partitioning does not change the reported occurrences, only the shape
    # of the search. The reference defaults to dynamic; here, as in the JAX
    # package, the compiled uniform schedule is the default and dynamic and
    # static are options.
    a.add_argument("-p", "--partitioning",
                   choices=["uniform", "static", "dynamic"],
                   default="uniform",
                   help="read partitioning strategy (default: uniform)")
    a.add_argument("-T", "--trim", default=None, metavar="START-END",
                   help="trim reads to bases [START, END) before aligning "
                        "(not ported yet)")
    a.add_argument("-i", "--in-text", type=int, default=4,
                   help="in-text verification switchpoint (0 disables)")
    a.add_argument("-s", "--sa-sparseness", type=int, default=None,
                   help="SA sampling factor to align with (a multiple of "
                        "the built factor)")
    a.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where alignment runs: the CUDA device (raises if "
                        "there is none) or the CPU with the kernels' plain "
                        "PyTorch versions")

    args = parser.parse_args(argv)
    if args.cmd == "build":
        return cmd_build(args)
    return cmd_align(args)


def cmd_build(args):
    from columba_tpu_torch.index.build import build_index
    from columba_tpu_torch.logger import logger

    logger.verbose = args.verbose
    if args.log_file:
        logger.set_log_file(args.log_file)
    if args.max_block_bp is not None:
        raise NotImplementedError(
            "blocked indexes are not ported yet (ROADMAP queue 1, item 12)")
    fastas = list(args.fasta or [])
    if args.fasta_list:
        with open(args.fasta_list) as f:
            fastas += [ln.strip() for ln in f if ln.strip()]
    if not fastas:
        raise SystemExit("build: provide FASTA files via -f and/or -F")
    t0 = time.time()
    extra = ""
    if args.rlc:
        from columba_tpu_torch.index.bmove import build_bmove

        arrays = build_bmove(fastas, out_dir=args.index, seed=args.seed,
                             textless=args.textless)
        extra = (f" runs={arrays.meta['runs_fwd']}"
                 f" (r/n={arrays.meta['runs_fwd'] / max(arrays.n, 1):.3f})"
                 + (" textless" if args.textless else ""))
    elif args.textless:
        raise SystemExit("build: --textless requires --rlc")
    else:
        arrays = build_index(
            fastas, out_dir=args.index,
            sa_sparseness=1 if args.all_sa_sparseness else args.sa_sparseness,
            seed=args.seed, write_preprocessed_fasta=args.write_preprocessed,
            seed_length=args.seed_length,
        )
    print(f"[{PROGRAM} build] n={arrays.n} seqs={len(arrays.seq_names)}"
          f"{extra} in {time.time() - t0:.1f}s -> {args.index}",
          file=sys.stderr)
    return 0


def _unsupported(args, flavor: str) -> str | None:
    """The ROADMAP item of an option the port does not run yet on this
    index flavor, or None."""
    if args.trim:
        return "-T trim (ROADMAP queue 1, item 9)"
    if args.output.endswith(".rhs"):
        return "read-hit-summary output (ROADMAP queue 1, item 9)"
    if flavor not in ("vanilla", "rlc"):
        return f"{flavor} indexes (ROADMAP queue 1, item 12)"
    return None


# (path, meta mtime, flavor, sa_sparseness, device) -> (arrays, device
# index): a repeated in-process align reuses the resident index. One entry.
_DEVICE_INDEX_CACHE: dict = {}


def cmd_align(args):
    import json

    import torch

    from columba_tpu_torch.index.bmove import BMoveIndex, load_bmove
    from columba_tpu_torch.index.build import load_index, subsample_sa
    from columba_tpu_torch.index.fmindex import FMIndex
    from columba_tpu_torch.io import emit, fastq
    from columba_tpu_torch.logger import logger
    from columba_tpu_torch.search.strategy import MappingConfig

    logger.verbose = args.verbose
    if args.log_file:
        logger.set_log_file(args.log_file)
    with open(os.path.join(args.index, "meta.json")) as f:
        meta = json.load(f)
    flavor = meta.get("flavor", "vanilla")
    rlc = flavor == "rlc"
    textless = rlc and bool(meta.get("textless", False))
    if textless:
        # as columba_tpu/cli.py:271-284
        if args.activate_cigar:
            raise SystemExit(
                "align: -aC needs the genome text; this RLC index was "
                "built --textless")
        if args.reads2 is not None:
            raise SystemExit(
                "align: paired-end needs in-text windows; use a with-text "
                "RLC or Vanilla index (textless index given)")
        if args.in_text:
            logger.verbose_msg("textless index: in-text verification "
                               "disabled (-i 0)")
            args.in_text = 0
    missing = _unsupported(args, flavor)
    if missing is None and not (
            emit.available() and emit.pe_available()
            and fastq.native_reader_available()
            and _sniff_fastq(args.reads)
            and (args.reads2 is None or _sniff_fastq(args.reads2))):
        missing = ("FASTA read input or a host without the native parser "
                   "and emitter (ROADMAP queue 1, item 9)")
    if missing is not None:
        raise NotImplementedError(f"not ported yet: {missing}")

    device = torch.device(args.device)
    if device.type == "cuda":
        try:
            torch.zeros(1, device=device)
        except (RuntimeError, AssertionError) as e:
            raise RuntimeError(
                "align --device cuda: no usable CUDA device; the port never "
                "falls back to the CPU by itself (--device cpu runs the "
                "kernels' plain versions)") from e
    key = (os.path.realpath(args.index),
           os.path.getmtime(os.path.join(args.index, "meta.json")),
           flavor, textless, args.sa_sparseness, str(device))
    ent = _DEVICE_INDEX_CACHE.get(key)
    if ent is None:
        _DEVICE_INDEX_CACHE.clear()      # one resident index at a time
        if rlc:
            arrays = load_bmove(args.index)
            ent = (arrays, BMoveIndex.from_arrays(arrays, device))
        else:
            arrays = load_index(args.index)
            if args.sa_sparseness is not None:
                arrays = subsample_sa(arrays, args.sa_sparseness)
            ent = (arrays, FMIndex.from_arrays(arrays, device))
        _DEVICE_INDEX_CACHE[key] = ent
    arrays, index = ent
    # CIGAR defaults as in the reference: on for Vanilla (-nC disables),
    # off for RLC (-aC enables), src/parameters/alignparameters.cpp:131-160
    args.with_cigar = args.activate_cigar if rlc else not args.no_cigar
    # scheme source precedence mirrors Parameters::createStrategy
    # (src/parameters/alignparameters.cpp:1313-1345): -d > -c > -S
    dynamic_selection = (args.scheme == "columba"
                         and not args.no_dynamic_selection)
    if args.dynamic_selection_path:
        args.scheme = args.dynamic_selection_path
        dynamic_selection = True
    elif args.custom:
        args.scheme = args.custom
        dynamic_selection = not args.no_dynamic_selection
    kmer_table = None
    kmer_k = max(0, min(int(args.kmer_size), 13))
    if kmer_k != args.kmer_size:
        logger.warning(f"kmer-size clamped to {kmer_k} (dense table)")
    if not args.no_kmer_table and not rlc and kmer_k > 0:
        from columba_tpu_torch.index.kmer import build_kmer_table_cached

        kmer_table = build_kmer_table_cached(index, kmer_k, args.index)
    cfg = MappingConfig(
        scheme_name=args.scheme, metric=args.metric, mode=args.mode,
        max_distance=args.max_distance, best_plus_x=args.best_plus_x,
        min_identity=args.min_identity, capacity=args.capacity,
        kmer_table=kmer_table, dynamic_selection=dynamic_selection,
        probe_selection=args.probe_selection,
        partitioning=args.partitioning, switchpoint=args.in_text,
        arrays=arrays)
    if args.reads2 is not None:
        return _align_paired(args, arrays, index, cfg, kmer_table)
    if textless:
        return _align_textless(args, arrays, index, cfg)
    return _align_single_fast(args, arrays, index, cfg)


def _sniff_fastq(path: str) -> bool:
    from columba_tpu_torch.io.fastq import open_maybe_gz

    try:
        with open_maybe_gz(path) as f:
            return f.read(1) == "@"
    except OSError:
        return False


def _align_single_fast(args, arrays, index, cfg):
    """Pipelined SE engine: native FASTQ parse (producer thread) -> device
    dispatch (main thread) -> fetch + occurrence extraction + native SAM
    emission (emitter thread), with bounded queues and in-order writes.
    The emitter's fetch waits on the CUDA event recorded after its batch's
    dispatch, so it never waits for later batches."""
    import queue
    import threading

    import numpy as np

    from columba_tpu_torch.counters import Counters
    from columba_tpu_torch.index.build import decoded_text
    from columba_tpu_torch.io import emit, fastq, sam
    from columba_tpu_torch.logger import logger
    from columba_tpu_torch.search import strategy

    genome = decoded_text(arrays)
    seq_lengths = list(np.diff(arrays.seq_starts))
    ctrs = Counters()
    t0 = time.time()
    state = dict(n_reads=0, n_mapped=0, n_aln=0)
    in_q: queue.Queue = queue.Queue(maxsize=6)
    disp_q: queue.Queue = queue.Queue(maxsize=3)
    errors: list = []

    def _producer():
        try:
            for b in fastq.batches_native(args.reads, args.batch_size):
                in_q.put(b)
        except BaseException as e:  # surfaced after the joins
            errors.append(e)
        finally:
            in_q.put(None)

    def _emitter(out):
        try:
            while True:
                item = disp_q.get()
                if item is None:
                    return
                batch, payload, kb = item
                if args.mode == "all":
                    occs, _ = strategy.map_batch_all_finish(
                        payload, index, batch.codes, cfg, counters=ctrs)
                else:
                    occs = strategy.map_batch_best_finish(
                        payload, index, batch.codes, cfg, counters=ctrs)
                nv = batch.n_valid
                if nv < batch.codes.shape[0]:
                    occs = occs.take(occs.read_id < nv)
                data = emit.emit_sam_native(
                    batch.codes[:nv], batch.names_buf, batch.name_offs,
                    batch.quals_buf, batch.qual_offs, occs, arrays, genome,
                    kb, xa_tag=args.xa_tag,
                    unmapped_records=not args.no_unmapped,
                    with_cigar=args.with_cigar, n_threads=3, counters=ctrs)
                out.write(data)
                n_mapped = int(np.unique(occs.read_id).size)
                state["n_reads"] += nv
                state["n_mapped"] += n_mapped
                state["n_aln"] += len(occs)
                ctrs.number_of_reads += nv
                ctrs.mapped_reads += n_mapped
                ctrs.total_unique_matches += len(occs)
                ctrs.total_reported_positions += len(occs)
                rate = state["n_reads"] / max(time.time() - t0, 1e-9)
                print(f"[{PROGRAM}] {state['n_reads']} reads, "
                      f"{state['n_mapped']} mapped ({rate:,.0f} reads/s)",
                      file=sys.stderr)
        except BaseException as e:
            errors.append(e)
            while disp_q.get() is not None:  # drain so the main loop
                pass                         # cannot block on a dead emitter

    with open(args.output, "wb") as out:
        out.write(sam.header(arrays.seq_names, seq_lengths,
                             program_name=PROGRAM,
                             command_line=" ".join(sys.argv)).encode())
        prod = threading.Thread(target=_producer, daemon=True)
        emt = threading.Thread(target=_emitter, args=(out,), daemon=True)
        prod.start()
        emt.start()
        try:
            while True:
                batch = in_q.get()
                if batch is None:
                    break
                if args.mode == "all":
                    payload = strategy.map_batch_all_start(
                        index, batch.codes, cfg)
                    k = cfg.max_distance
                else:
                    payload = strategy.map_batch_best_start(
                        index, batch.codes, cfg, counters=ctrs)
                    k = strategy.best_cutoff_for(cfg, batch.codes.shape[1])
                disp_q.put((batch, payload,
                            k if args.metric == "edit" else 0))
        finally:
            disp_q.put(None)
            emt.join()
            while prod.is_alive():   # unblock a producer stuck on put
                try:
                    in_q.get(timeout=0.1)
                except queue.Empty:
                    pass
            prod.join()
        if errors:
            raise errors[0]
    pct = 100.0 * state["n_mapped"] / max(state["n_reads"], 1)
    summary = (
        f"done: {state['n_reads']} reads, {pct:.2f}% mapped, "
        f"{state['n_aln']} alignments, "
        f"{state['n_aln'] / max(state['n_reads'], 1):.2f} per read, "
        f"total {time.time() - t0:.1f}s"
    )
    print(f"[{PROGRAM}] {summary}", file=sys.stderr)
    if args.log_file:
        logger.info(summary)
    ctrs.report(logger, paired=False)
    return 0


def _align_textless(args, arrays, index, cfg):
    """Single-end alignment on the textless RLC index: batches from the
    native FASTQ parser in input order, each mapped (the frontier pass on
    the device, phi locate on the host) and written by the textless
    emitter ('*' CIGARs, no genome text), one after another."""
    import numpy as np

    from columba_tpu_torch.counters import Counters
    from columba_tpu_torch.io import fastq, sam
    from columba_tpu_torch.logger import logger
    from columba_tpu_torch.search import strategy

    seq_lengths = list(np.diff(arrays.seq_starts))
    ctrs = Counters()
    t0 = time.time()
    n_reads = n_mapped = n_aln = 0
    with open(args.output, "w") as out:
        out.write(sam.header(arrays.seq_names, seq_lengths,
                             program_name=PROGRAM,
                             command_line=" ".join(sys.argv)))
        for batch in fastq.batches_native(args.reads, args.batch_size):
            if args.mode == "all":
                occs = strategy.map_batch_all_finish(
                    strategy.map_batch_all_start(index, batch.codes, cfg),
                    index, batch.codes, cfg, counters=ctrs)[0]
            else:
                occs = strategy.map_batch_best_arr(index, batch.codes, cfg,
                                                   counters=ctrs)
            nv = batch.n_valid
            occs = occs.take(occs.read_id < nv)
            out.write(strategy.emit_sam_textless(
                batch, occs, arrays, unmapped_records=not args.no_unmapped))
            mapped = int(np.unique(occs.read_id).size)
            n_reads += nv
            n_mapped += mapped
            n_aln += len(occs)
            ctrs.number_of_reads += nv
            ctrs.mapped_reads += mapped
            ctrs.total_unique_matches += len(occs)
            ctrs.total_reported_positions += len(occs)
            rate = n_reads / max(time.time() - t0, 1e-9)
            print(f"[{PROGRAM}] {n_reads} reads, {n_mapped} mapped "
                  f"({rate:,.0f} reads/s)", file=sys.stderr)
    pct = 100.0 * n_mapped / max(n_reads, 1)
    summary = (f"done: {n_reads} reads, {pct:.2f}% mapped, {n_aln} "
               f"alignments, {n_aln / max(n_reads, 1):.2f} per read, total "
               f"{time.time() - t0:.1f}s")
    print(f"[{PROGRAM}] {summary}", file=sys.stderr)
    if args.log_file:
        logger.info(summary)
    ctrs.report(logger, paired=False)
    return 0


def _align_paired(args, arrays, index, cfg, kmer_table):
    """Paired-end engine: both FASTQ files stream in lockstep chunks; the
    main thread maps a chunk (every sub-batch of both sides is dispatched
    before any is finished, so batch i's fetch and pairing overlap batch
    i+1's device work) while a writer thread emits the chunk before."""
    import itertools
    import queue
    import threading

    import numpy as np

    from columba_tpu_torch.counters import Counters
    from columba_tpu_torch.index.build import decoded_text
    from columba_tpu_torch.io import emit, fastq, sam
    from columba_tpu_torch.logger import logger
    from columba_tpu_torch.search import paired, pairing
    from columba_tpu_torch.search.strategy import best_cutoff_for

    pcfg = paired.PairedConfig(
        orientation=args.orientation,
        min_insert=args.min_insert_size,
        max_insert=args.max_insert_size,
        infer=not args.no_inferring,
        discordant=args.discordant is not None,
        max_discordant=(args.discordant if args.discordant is not None
                        else 100000),
    )
    B = args.batch_size
    # Pairs are bucketed by (len1, len2) per chunk so that device batches
    # have one shape with mixed-length input; emission walks each chunk in
    # original order in maximal same-shape runs, so output order matches
    # the input. Host memory stays bounded by the chunk.
    CHUNK = max(8 * B, 65536)

    def group_k(m):
        if args.mode == "all":
            return cfg.max_distance
        return best_cutoff_for(cfg, m)

    def pair_keys(c1, c2):
        """(len1 << 32 | len2) per pair: the shape-group key."""
        return (c1["lens"].astype(np.int64) << 32) | c2["lens"]

    chunks = fastq.pe_soa_chunks(args.reads, args.reads2, CHUNK)
    pending = []
    if pcfg.infer:
        # infer from the first chunk's dominant shape group (the reference
        # caps its inference sample anyway, src/parallel.cpp:402-465)
        first = next(chunks, None)
        if first is not None:
            pending.append(first)
            c1, c2 = first
            keys = pair_keys(c1, c2)
            vals, counts = np.unique(keys, return_counts=True)
            key = int(vals[np.argmax(counts)])
            idxs = np.nonzero(keys == key)[0]
            g1 = fastq.soa_gather_codes(c1, idxs, key >> 32)
            g2 = fastq.soa_gather_codes(c2, idxs, key & 0xffffffff)
            pcfg = paired.infer_parameters(
                index, g1, g2, cfg, arrays.seq_starts, kmer_table,
                pcfg_in=pcfg)
            print(f"[{PROGRAM}] inferred orientation={pcfg.orientation} "
                  f"insert=[{pcfg.min_insert},{pcfg.max_insert}]",
                  file=sys.stderr)

    seq_lengths = list(np.diff(arrays.seq_starts))
    ctrs = Counters()
    t0 = time.time()
    done = 0

    def chunk_rows_mode(c1, c2) -> bool:
        """The array-native result path applies when every shape group
        stays on the rung path (cutoffs <= 6) and discordant pairing is
        off (see paired.PERowsBest)."""
        if args.mode != "best" or pcfg.discordant:
            return False
        return all(best_cutoff_for(cfg, int(m)) <= 6
                   for m in np.unique(np.concatenate(
                       [c1["lens"], c2["lens"]])))

    def map_chunk(c1, c2):
        """Map one chunk; returns (result, kb_of) for its emission: a
        PERowsBest (array-native path) or a MappedPair list. Two-phase:
        dispatch every sub-batch, then finish them in order. The
        deep-cutoff ladder is synchronous and runs inside start."""
        nonlocal done
        keys = pair_keys(c1, c2)
        n = c1["n"]
        rows_mode = chunk_rows_mode(c1, c2)
        mapped_all: list = [None] * n
        cres = (paired.PERowsBest(
            n=n, rows=None,
            u_end1=np.full(n, -1, np.int64), u_st1=np.zeros(n, np.uint8),
            u_mq1=np.zeros(n, np.int32),
            u_end2=np.full(n, -1, np.int64), u_st2=np.zeros(n, np.uint8),
            u_mq2=np.zeros(n, np.int32)) if rows_mode else None)
        row_parts: list = []
        kb_of: dict = {}
        launches = []
        for keyv in np.unique(keys):
            idxs = np.nonzero(keys == keyv)[0]
            m1, m2 = int(keyv >> 32), int(keyv & 0xffffffff)
            k = group_k(m1)
            kb_of[(m1, m2)] = k if cfg.metric == "edit" else 0
            g1 = fastq.soa_gather_codes(c1, idxs, m1)
            g2 = fastq.soa_gather_codes(c2, idxs, m2)
            for off in range(0, len(idxs), B):
                if args.mode == "best":
                    h = paired.map_pairs_best_start(
                        index, g1[off:off + B], g2[off:off + B],
                        cfg, pcfg, arrays.seq_starts, kmer_table,
                        counters=ctrs)
                else:
                    h = paired.map_pairs_all_start(
                        index, g1[off:off + B], g2[off:off + B],
                        cfg.scheme_name, k, cfg.metric, kmer_table)
                launches.append((idxs, off, h))
        for idxs, off, h in launches:
            gidx = idxs[off:off + B]
            if rows_mode:
                rr = paired.map_pairs_best_finish(
                    h, cfg, pcfg, arrays.seq_starts, counters=ctrs,
                    as_rows=True)
                rows = rr.rows
                has_rows = np.zeros(rr.n, dtype=bool)
                has_rows[rows.pair_id] = True
                u1, u2 = rr.u_end1 >= 0, rr.u_end2 >= 0
                pl = ~has_rows
                ctrs.number_of_reads += 2 * len(gidx)
                ctrs.total_unique_pairs += len(rows)
                ctrs.mapped_pairs += int(has_rows.sum())
                ctrs.unpaired_but_mapped_pairs += int((pl & u1 & u2).sum())
                ctrs.mapped_half_pairs += int((pl & (u1 ^ u2)).sum())
                rows.pair_id = gidx[rows.pair_id]
                row_parts.append(rows)
                for src, dst in ((rr.u_end1, cres.u_end1),
                                 (rr.u_st1, cres.u_st1),
                                 (rr.u_mq1, cres.u_mq1),
                                 (rr.u_end2, cres.u_end2),
                                 (rr.u_st2, cres.u_st2),
                                 (rr.u_mq2, cres.u_mq2)):
                    dst[gidx] = src
            else:
                if args.mode == "best":
                    mapped = paired.map_pairs_best_finish(
                        h, cfg, pcfg, arrays.seq_starts, counters=ctrs)
                else:
                    mapped = paired.map_pairs_all_finish(
                        h, pcfg, arrays.seq_starts, arrays=arrays,
                        counters=ctrs)
                for j, mp in zip(gidx, mapped):
                    mapped_all[j] = mp
                    ctrs.number_of_reads += 2
                    ctrs.total_unique_pairs += len(mp.pairs)
                    if mp.pairs:
                        ctrs.mapped_pairs += 1
                    elif mp.discordant:
                        ctrs.discordantly_mapped_pairs += 1
                    elif mp.unpaired1 and mp.unpaired2:
                        ctrs.unpaired_but_mapped_pairs += 1
                    elif mp.unpaired1 or mp.unpaired2:
                        ctrs.mapped_half_pairs += 1
            done += len(gidx)
            rate = done / max(time.time() - t0, 1e-9)
            print(f"[{PROGRAM}] {done} pairs ({rate:,.0f} pairs/s)",
                  file=sys.stderr)
        if rows_mode:
            allr = pairing.PairRows.concat(row_parts)
            order = np.argsort(allr.pair_id, kind="stable")
            cres.rows = allr.take(order)
            return cres, kb_of
        return mapped_all, kb_of

    # writer thread: emission (traceback DP + SAM) of chunk i overlaps the
    # device work of chunk i+1
    out_q: queue.Queue = queue.Queue(maxsize=2)
    errors: list = []
    genome = decoded_text(arrays)

    def _writer(out):
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                c1, c2, result, kb_of = item
                rows_mode = isinstance(result, paired.PERowsBest)
                keys = pair_keys(c1, c2)
                n = c1["n"]
                i = 0
                while i < n:
                    keyv = keys[i]
                    j = i + 1
                    # run cap bounds the native output buffer
                    while j < n and j - i < 65536 and keys[j] == keyv:
                        j += 1
                    kb = kb_of[(int(keyv >> 32), int(keyv & 0xffffffff))]
                    soa = (emit.pe_soa_from_rows(result, i, j)
                           if rows_mode else
                           emit.pe_soa_from_mapped(result[i:j]))
                    out.write(emit.emit_sam_pe_soa(
                        c1["codes"],
                        c1["names"], c1["name_offs"][i:j + 1],
                        c1["quals"], c1["qual_offs"][i:j + 1],
                        c2["codes"],
                        c2["names"], c2["name_offs"][i:j + 1],
                        c2["quals"], c2["qual_offs"][i:j + 1],
                        soa, arrays, genome, kb, counters=ctrs,
                        seq_offs1=c1["seq_offs"][i:j + 1],
                        seq_offs2=c2["seq_offs"][i:j + 1]))
                    i = j
        except BaseException as e:
            errors.append(e)
            while out_q.get() is not None:  # drain so the main loop
                pass                        # cannot block on a dead writer

    with open(args.output, "wb") as out:
        out.write(sam.header(arrays.seq_names, seq_lengths,
                             program_name=PROGRAM).encode())
        wrt = threading.Thread(target=_writer, args=(out,), daemon=True)
        wrt.start()
        try:
            for c1, c2 in itertools.chain(pending, chunks):
                result, kb_of = map_chunk(c1, c2)
                out_q.put((c1, c2, result, kb_of))
        finally:
            out_q.put(None)
            wrt.join()
        if errors:
            raise errors[0]
    ctrs.report(logger, paired=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
