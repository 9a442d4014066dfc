"""Command-line interface of the PyTorch port: ``build`` and ``align``.

The counterpart of ``columba_tpu/cli.py`` with the same option names. The
port covers the Vanilla index build and single-end ALL-mode alignment of
FASTQ input to SAM (``align -a all``); every other mode raises
``NotImplementedError`` naming its ROADMAP item.

Alignment runs on the first CUDA device when there is one, else on the CPU
(the plain PyTorch versions of the kernels).

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
                   help="run-length-compressed flavor (not ported yet)")
    b.add_argument("--textless", action="store_true",
                   help="textless RLC flavor (not ported yet)")
    b.add_argument("-B", "--max-block-bp", type=int, default=None,
                   help="block-partitioned index (not ported yet)")
    b.add_argument("--log-file", default=None)
    b.add_argument("-v", "--verbose", action="store_true")

    a = sub.add_parser("align", help="map reads against an index")
    a.add_argument("-r", "--index", required=True)
    a.add_argument("-f", "--reads", required=True)
    a.add_argument("-F", "--reads2", default=None,
                   help="second reads file (paired-end; not ported yet)")
    a.add_argument("-o", "--output", required=True)
    a.add_argument("-e", "--max-distance", type=int, default=0,
                   help="ALL-mode max distance")
    a.add_argument("-a", "--mode", choices=["all", "best"], default="best")
    a.add_argument("-m", "--metric", choices=["edit", "hamming"],
                   default="edit")
    a.add_argument("-S", "--scheme", default="kuch1")
    a.add_argument("-c", "--custom", default=None, metavar="DIR",
                   help="custom search scheme folder (not ported yet)")
    a.add_argument("-d", "--dynamic-selection-path", default=None,
                   metavar="DIR", help="scheme collection (not ported yet)")
    a.add_argument("-K", "--kmer-size", type=int, default=10,
                   help="seed k-mer length, 0 disables (dense table caps at "
                        "13)")
    a.add_argument("-b", "--batch-size", type=int, default=512)
    a.add_argument("-t", "--threads", type=int, default=None,
                   help="accepted for compatibility")
    a.add_argument("-l", "--log-file", default=None)
    a.add_argument("-v", "--verbose", action="store_true")
    a.add_argument("-nC", "--no-CIGAR", dest="no_cigar", action="store_true",
                   help="do not output CIGAR strings")
    a.add_argument("--capacity", type=int, default=None)
    a.add_argument("--no-kmer-table", action="store_true",
                   help="disable the dense k-mer seed table")
    a.add_argument("-XA", "--xa-tag", action="store_true",
                   help="fold secondary alignments into the XA tag")
    a.add_argument("-nU", "--no-unmapped", action="store_true",
                   help="do not output unmapped reads")
    a.add_argument("-p", "--partitioning",
                   choices=["uniform", "static", "dynamic"],
                   default="uniform",
                   help="read partitioning (only uniform is ported)")
    a.add_argument("-i", "--in-text", type=int, default=4,
                   help="in-text verification switchpoint (0 disables)")
    a.add_argument("-s", "--sa-sparseness", type=int, default=None,
                   help="SA sampling factor to align with (a multiple of "
                        "the built factor)")

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
    if args.rlc or args.textless:
        raise NotImplementedError(
            "RLC / textless indexes are not ported yet (ROADMAP queue 1, "
            "item 13)")
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
    arrays = build_index(
        fastas, out_dir=args.index,
        sa_sparseness=1 if args.all_sa_sparseness else args.sa_sparseness,
        seed=args.seed, write_preprocessed_fasta=args.write_preprocessed,
        seed_length=args.seed_length,
    )
    print(f"[{PROGRAM} build] n={arrays.n} seqs={len(arrays.seq_names)} in "
          f"{time.time() - t0:.1f}s -> {args.index}", file=sys.stderr)
    return 0


def _unsupported(args) -> str | None:
    """The ROADMAP item of an option the port does not run yet, or None."""
    if args.mode != "all":
        return "-a best (ROADMAP queue 1, item 9)"
    if args.reads2 is not None:
        return "paired-end -F (ROADMAP queue 1, item 9)"
    if args.partitioning != "uniform":
        return f"-p {args.partitioning} (ROADMAP queue 1, item 11)"
    if args.custom or args.dynamic_selection_path:
        return "scheme folders and collections -c/-d (ROADMAP queue 1, " \
               "item 11)"
    if args.output.endswith(".rhs"):
        return "read-hit-summary output (ROADMAP queue 1, item 9)"
    return None


# (path, meta mtime, sa_sparseness, device) -> (arrays, device index): a
# repeated in-process align reuses the resident index. One entry.
_DEVICE_INDEX_CACHE: dict = {}


def cmd_align(args):
    import json

    import torch

    from columba_tpu_torch.index.build import load_index, subsample_sa
    from columba_tpu_torch.index.fmindex import FMIndex
    from columba_tpu_torch.io import emit, fastq
    from columba_tpu_torch.logger import logger
    from columba_tpu_torch.search.strategy import MappingConfig

    logger.verbose = args.verbose
    if args.log_file:
        logger.set_log_file(args.log_file)
    missing = _unsupported(args)
    with open(os.path.join(args.index, "meta.json")) as f:
        flavor = json.load(f).get("flavor", "vanilla")
    if flavor != "vanilla":
        missing = f"{flavor} indexes (ROADMAP queue 1, items 12-13)"
    if missing is None and not (
            emit.available() and fastq.native_reader_available()
            and _sniff_fastq(args.reads)):
        missing = ("FASTA read input or a host without the native parser "
                   "and emitter (ROADMAP queue 1, item 9)")
    if missing is not None:
        raise NotImplementedError(f"not ported yet: {missing}")

    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    key = (os.path.realpath(args.index),
           os.path.getmtime(os.path.join(args.index, "meta.json")),
           args.sa_sparseness, str(device))
    ent = _DEVICE_INDEX_CACHE.get(key)
    if ent is None:
        arrays = load_index(args.index)
        if args.sa_sparseness is not None:
            arrays = subsample_sa(arrays, args.sa_sparseness)
        _DEVICE_INDEX_CACHE.clear()
        ent = (arrays, FMIndex.from_arrays(arrays, device))
        _DEVICE_INDEX_CACHE[key] = ent
    arrays, index = ent
    kmer_table = None
    kmer_k = max(0, min(int(args.kmer_size), 13))
    if kmer_k != args.kmer_size:
        logger.warning(f"kmer-size clamped to {kmer_k} (dense table)")
    if not args.no_kmer_table and kmer_k > 0:
        from columba_tpu_torch.index.kmer import build_kmer_table_cached

        kmer_table = build_kmer_table_cached(index, kmer_k, args.index)
    cfg = MappingConfig(
        scheme_name=args.scheme, metric=args.metric,
        max_distance=args.max_distance, capacity=args.capacity,
        kmer_table=kmer_table, switchpoint=args.in_text, arrays=arrays)
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
    kb = cfg.max_distance if args.metric == "edit" else 0
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
                batch, payload = item
                occs, _ = strategy.map_batch_all_finish(
                    payload, index, batch.codes, cfg, counters=ctrs)
                nv = batch.n_valid
                if nv < batch.codes.shape[0]:
                    occs = occs.take(occs.read_id < nv)
                data = emit.emit_sam_native(
                    batch.codes[:nv], batch.names_buf, batch.name_offs,
                    batch.quals_buf, batch.qual_offs, occs, arrays, genome,
                    kb, xa_tag=args.xa_tag,
                    unmapped_records=not args.no_unmapped,
                    with_cigar=not args.no_cigar, n_threads=3, counters=ctrs)
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
                payload = strategy.map_batch_all_start(index, batch.codes,
                                                       cfg)
                disp_q.put((batch, payload))
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


if __name__ == "__main__":
    sys.exit(main())
