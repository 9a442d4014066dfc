"""FASTQ/FASTA read input: parsing, cleanup, fixed-shape batching.

The counterpart of ``columba_tpu/io/fastq.py``: reads are parsed (in C++,
``csrc/host/parse.cpp``, built by ``columba_tpu_torch.native``, or by the
Python record parser for FASTA input and hosts without the native parser),
uppercased with non-ACGT -> N, and grouped into fixed-shape (B, m) code
batches per read length (single-end), or streamed as lockstep
struct-of-arrays chunks of two files (paired-end).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass

import numpy as np

from columba_tpu_torch.core import alphabet


@dataclass
class ReadRecord:
    name: str
    codes: np.ndarray  # uint8, 0..3 + 4 for N
    qual: str


def open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def parse_reads(path: str):
    """Yield ReadRecord from FASTQ or FASTA (sniffed by first char)."""
    with open_maybe_gz(path) as f:
        first = f.read(1)
        f.seek(0)
        if first == "@":
            while True:
                h = f.readline()
                if not h:
                    return
                seq = f.readline().strip()
                f.readline()
                qual = f.readline().strip()
                yield ReadRecord(h[1:].split()[0].strip(), alphabet.encode(seq), qual)
        elif first == ">":
            name, parts = None, []
            for line in f:
                line = line.strip()
                if line.startswith(">"):
                    if name is not None:
                        seq = "".join(parts)
                        yield ReadRecord(name, alphabet.encode(seq), "I" * len(seq))
                    name = line[1:].split()[0]
                    parts = []
                else:
                    parts.append(line)
            if name is not None:
                seq = "".join(parts)
                yield ReadRecord(name, alphabet.encode(seq), "I" * len(seq))
        else:
            raise ValueError(f"unrecognized read file format: {path}")


def batches_by_length(records, batch_size: int):
    """Group records into fixed-shape batches per read length.

    Yields (records_list, codes (B, m)) with the final partial batch padded
    by repeating the last read (padding rows are dropped by the caller via
    len(records_list)).
    """
    buckets: dict[int, list[ReadRecord]] = {}
    for rec in records:
        m = len(rec.codes)
        buckets.setdefault(m, []).append(rec)
        bucket = buckets[m]
        if len(bucket) == batch_size:
            yield bucket, np.stack([r.codes for r in bucket])
            buckets[m] = []
    for m, bucket in sorted(buckets.items()):
        if not bucket:
            continue
        pad = [bucket[-1]] * (batch_size - len(bucket))
        yield bucket, np.stack([r.codes for r in bucket + pad])


def trim_records(records, start: int, end: int):
    """Trim reads to [start, end) (reference -T option,
    src/parameters/alignparameters.cpp TrimOption)."""
    for rec in records:
        yield ReadRecord(rec.name, rec.codes[start:end], rec.qual[start:end])


# ---------------------------------------------------------------------------
# Native (C++) chunked reader: SoA batches for the fast emission path
# ---------------------------------------------------------------------------

class RecordBatch:
    """Struct-of-arrays batch of same-length reads.

    codes is (B, m) uint8 padded to the full batch size by repeating the
    last read (the device needs fixed shapes); only the first ``n_valid``
    records are real and have name/qual entries.
    """

    __slots__ = ("codes", "n_valid", "names_buf", "name_offs",
                 "quals_buf", "qual_offs")

    def __init__(self, codes, n_valid, names_buf, name_offs,
                 quals_buf, qual_offs):
        self.codes = codes
        self.n_valid = n_valid
        self.names_buf = names_buf
        self.name_offs = name_offs
        self.quals_buf = quals_buf
        self.qual_offs = qual_offs

    def __len__(self):
        return self.n_valid


_PARSE_LIB = None
_PARSE_TRIED = False


def _parse_lib():
    global _PARSE_LIB, _PARSE_TRIED
    if not _PARSE_TRIED:
        _PARSE_TRIED = True
        import ctypes

        from columba_tpu_torch import native

        lib = native.load("parse", ["parse.cpp"])
        if lib is not None:
            lib.parse_fastq.restype = ctypes.c_int32
            lib.parse_fastq.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
            ]
        _PARSE_LIB = lib
    return _PARSE_LIB


def native_reader_available() -> bool:
    return _parse_lib() is not None


def _parse_chunk(lib, data: bytes, is_final: bool):
    """Parse one byte chunk; returns (soa dict, consumed bytes)."""
    import ctypes

    n_max = max(1, len(data) // 32)  # >= minimal record size "@\nA\n+\nI\n"
    codes = np.empty(len(data), np.uint8)
    seq_offs = np.zeros(n_max + 1, np.int64)
    names = np.empty(len(data), np.uint8)
    name_offs = np.zeros(n_max + 1, np.int64)
    quals = np.empty(len(data), np.uint8)
    qual_offs = np.zeros(n_max + 1, np.int64)
    consumed = ctypes.c_int64(0)
    n = lib.parse_fastq(
        data, len(data),
        codes.ctypes.data, codes.size, seq_offs.ctypes.data,
        names.ctypes.data, names.size, name_offs.ctypes.data,
        quals.ctypes.data, quals.size, qual_offs.ctypes.data,
        n_max, int(is_final), ctypes.byref(consumed))
    if n < 0:
        raise ValueError(f"native FASTQ parse failed (rc={n})")
    return dict(
        n=n,
        codes=codes, seq_offs=seq_offs[:n + 1],
        names=names, name_offs=name_offs[:n + 1],
        quals=quals, qual_offs=qual_offs[:n + 1],
    ), consumed.value


def _gather_bytes(buf: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """Gather variable-length byte slices; returns (bytes, int64 offsets)."""
    offs = np.zeros(len(starts) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    total = int(offs[-1])
    idx = np.repeat(starts - offs[:-1], lens) + np.arange(total)
    return buf[idx].tobytes(), offs


class _Bucket:
    __slots__ = ("pieces", "count")

    def __init__(self):
        self.pieces = []  # (soa, idx array into that chunk)
        self.count = 0


def batches_native(path: str, batch_size: int, chunk_bytes: int = 8 << 20):
    """Yield RecordBatch from a FASTQ file via the native parser.

    Groups records into fixed-shape same-length batches exactly like
    batches_by_length (full buckets as they fill; leftovers at EOF padded,
    in ascending length order). Works for plain and gzipped FASTQ; raises
    ValueError for FASTA input (caller falls back to the Python reader).
    """
    lib = _parse_lib()
    if lib is None:
        raise ValueError("native parser unavailable")
    import gzip

    f = (gzip.open(path, "rb") if path.endswith(".gz")
         else open(path, "rb"))
    with f:
        buckets: dict[int, _Bucket] = {}

        def assemble(m: int, parts, total: int, pad_to: int):
            codes = np.empty((pad_to, m), np.uint8)
            row = 0
            nb_parts, qb_parts = [], []
            nlens, qlens = [], []
            for soa, idx in parts:
                base = soa["seq_offs"][idx]
                codes[row:row + len(idx)] = (
                    soa["codes"][base[:, None] + np.arange(m)[None, :]])
                row += len(idx)
                nb, no = _gather_bytes(
                    soa["names"], soa["name_offs"][idx],
                    (soa["name_offs"][idx + 1]
                     - soa["name_offs"][idx]).astype(np.int64))
                qb, qo = _gather_bytes(
                    soa["quals"], soa["qual_offs"][idx],
                    (soa["qual_offs"][idx + 1]
                     - soa["qual_offs"][idx]).astype(np.int64))
                nb_parts.append(nb)
                nlens.append(np.diff(no))
                qb_parts.append(qb)
                qlens.append(np.diff(qo))
            codes[total:] = codes[max(total - 1, 0)]
            name_offs = np.zeros(total + 1, np.int64)
            np.cumsum(np.concatenate(nlens), out=name_offs[1:])
            qual_offs = np.zeros(total + 1, np.int64)
            np.cumsum(np.concatenate(qlens), out=qual_offs[1:])
            return RecordBatch(codes, total, b"".join(nb_parts), name_offs,
                               b"".join(qb_parts), qual_offs)

        tail = b""
        eof = False
        while not eof:
            data = f.read(chunk_bytes)
            eof = not data
            buf = tail + data
            if not buf:
                break
            if not tail and buf[:1] == b">":
                raise ValueError("FASTA input: use the generic reader")
            soa, consumed = _parse_chunk(lib, buf, eof)
            tail = buf[consumed:]
            if soa["n"] == 0:
                if eof and tail:
                    raise ValueError("trailing malformed FASTQ record")
                continue
            lens = np.diff(soa["seq_offs"])
            for m in np.unique(lens):
                bk = buckets.setdefault(int(m), _Bucket())
                idx = np.nonzero(lens == m)[0]
                bk.pieces.append((soa, idx))
                bk.count += len(idx)
                while bk.count >= batch_size:
                    take, parts, left = batch_size, [], []
                    for psoa, pidx in bk.pieces:
                        if take <= 0:
                            left.append((psoa, pidx))
                        elif len(pidx) <= take:
                            parts.append((psoa, pidx))
                            take -= len(pidx)
                        else:
                            parts.append((psoa, pidx[:take]))
                            left.append((psoa, pidx[take:]))
                            take = 0
                    bk.pieces = left
                    bk.count -= batch_size
                    yield assemble(int(m), parts, batch_size, batch_size)
        if eof and tail:
            raise ValueError("trailing malformed FASTQ record")
        for m in sorted(buckets):
            bk = buckets[m]
            if bk.count:
                yield assemble(m, bk.pieces, bk.count, batch_size)


class SoaReader:
    """Streaming native FASTQ parser with exact-count takes.

    ``take(n)`` returns the next n records (fewer at EOF, None when
    drained) as ONE flat struct-of-arrays dict — codes buffer +
    seq_offs, names/name_offs, quals/qual_offs, lens — in file order.
    The paired-end reader uses two of these in lockstep so pairs stay
    aligned without building per-record Python objects (the reference
    streams bounded PE blocks the same way, src/fastq.cpp:283-424).
    """

    def __init__(self, path: str, chunk_bytes: int = 8 << 20):
        lib = _parse_lib()
        if lib is None:
            raise ValueError("native parser unavailable")
        self._lib = lib
        self._f = (gzip.open(path, "rb") if path.endswith(".gz")
                   else open(path, "rb"))
        self._chunk_bytes = chunk_bytes
        self._tail = b""
        self._eof = False
        self._pieces: list = []   # (soa, lo) records [lo, soa["n"]) pending
        self._avail = 0
        self._first = True

    def close(self):
        self._f.close()

    def _fill_once(self) -> bool:
        """Parse one more byte chunk; False when the file is drained."""
        if self._eof:
            return False
        data = self._f.read(self._chunk_bytes)
        if not data:
            self._eof = True
        buf = self._tail + data
        if not buf:
            return False
        if self._first and buf[:1] == b">":
            raise ValueError("FASTA input: use the generic reader")
        self._first = False
        soa, consumed = _parse_chunk(self._lib, buf, self._eof)
        self._tail = buf[consumed:]
        if self._eof and self._tail:
            raise ValueError("trailing malformed FASTQ record")
        if soa["n"]:
            self._pieces.append((soa, 0))
            self._avail += soa["n"]
        return True

    def take(self, n: int):
        while self._avail < n and self._fill_once():
            pass
        if self._avail == 0:
            return None
        k = min(n, self._avail)
        spans = []                # (soa, lo, hi)
        need = k
        while need:
            soa, lo = self._pieces[0]
            cnt = min(need, soa["n"] - lo)
            spans.append((soa, lo, lo + cnt))
            need -= cnt
            if lo + cnt == soa["n"]:
                self._pieces.pop(0)
            else:
                self._pieces[0] = (soa, lo + cnt)
        self._avail -= k
        return _merge_spans(spans, k)


def _merge_spans(spans, total: int) -> dict:
    """Concatenate record spans of parse chunks into one flat SoA."""
    def cat(buf_key, off_key):
        parts, offs = [], np.zeros(total + 1, np.int64)
        row, base = 0, 0
        for soa, lo, hi in spans:
            o = soa[off_key]
            b0, b1 = int(o[lo]), int(o[hi])
            parts.append(soa[buf_key][b0:b1])
            offs[row + 1: row + 1 + (hi - lo)] = (o[lo + 1: hi + 1] - b0
                                                  + base)
            row += hi - lo
            base += b1 - b0
        return (parts[0] if len(parts) == 1
                else np.concatenate(parts)), offs

    codes, seq_offs = cat("codes", "seq_offs")
    names, name_offs = cat("names", "name_offs")
    quals, qual_offs = cat("quals", "qual_offs")
    return dict(n=total, codes=codes, seq_offs=seq_offs,
                names=names, name_offs=name_offs,
                quals=quals, qual_offs=qual_offs,
                lens=np.diff(seq_offs))


def soa_gather_codes(soa: dict, idx: np.ndarray, m: int) -> np.ndarray:
    """(len(idx), m) codes matrix for same-length records ``idx``."""
    base = soa["seq_offs"][idx]
    return np.ascontiguousarray(
        soa["codes"][base[:, None] + np.arange(m)[None, :]])


def records_to_soa(recs: list) -> dict:
    """ReadRecord list -> flat SoA chunk (generic-reader fallback for the
    paired-end SoA pipeline)."""
    from columba_tpu_torch.io import emit as _emit

    seq_offs = np.zeros(len(recs) + 1, np.int64)
    np.cumsum([len(r.codes) for r in recs], out=seq_offs[1:])
    codes = (np.concatenate([r.codes for r in recs])
             if recs else np.zeros(0, np.uint8))
    names, name_offs = _emit.pack_strings([r.name for r in recs])
    quals, qual_offs = _emit.pack_strings([r.qual for r in recs])
    return dict(n=len(recs), codes=codes.astype(np.uint8, copy=False),
                seq_offs=seq_offs,
                names=np.frombuffer(names, np.uint8),
                name_offs=name_offs,
                quals=np.frombuffer(quals, np.uint8),
                qual_offs=qual_offs, lens=np.diff(seq_offs))


def pe_soa_chunks(path1: str, path2: str, chunk: int):
    """Yield lockstep (soa1, soa2) chunks of ``chunk`` pairs, in file
    order — native chunked parsing when available, ReadRecord fallback
    for FASTA / no toolchain. Deterministic across passes (the blocked
    aligner re-runs it once per block)."""
    import itertools

    def is_fasta(path):
        f = (gzip.open(path, "rb") if path.endswith(".gz")
             else open(path, "rb"))
        with f:
            return f.read(1) == b">"

    if (native_reader_available() and not is_fasta(path1)
            and not is_fasta(path2)):
        r1, r2 = SoaReader(path1), SoaReader(path2)
        try:
            while True:
                c1 = r1.take(chunk)
                c2 = r2.take(chunk)
                if c1 is None and c2 is None:
                    return
                if c1 is None or c2 is None or c1["n"] != c2["n"]:
                    raise ValueError("read files must pair up")
                yield c1, c2
        finally:
            r1.close()
            r2.close()
        return
    it1 = parse_reads(path1)
    it2 = parse_reads(path2)
    while True:
        c1 = list(itertools.islice(it1, chunk))
        c2 = list(itertools.islice(it2, chunk))
        if len(c1) != len(c2):
            raise ValueError("read files must pair up")
        if not c1:
            return
        yield records_to_soa(c1), records_to_soa(c2)


def soa_records(soa: dict, lo: int, hi: int) -> list:
    """ReadRecord list for records [lo, hi) (Python-emitter fallback)."""
    out = []
    for i in range(lo, hi):
        name = soa["names"][soa["name_offs"][i]:soa["name_offs"][i + 1]]
        qual = soa["quals"][soa["qual_offs"][i]:soa["qual_offs"][i + 1]]
        out.append(ReadRecord(
            name.tobytes().decode(),
            soa["codes"][soa["seq_offs"][i]:soa["seq_offs"][i + 1]],
            qual.tobytes().decode()))
    return out


def batch_from_records(records: list, batch_size: int) -> RecordBatch:
    """RecordBatch from a list of same-length ReadRecords (fallback path
    and paired-end glue)."""
    n = len(records)
    codes = np.stack([r.codes for r in records]
                     + [records[-1].codes] * (batch_size - n))
    nb = b"".join(r.name.encode() for r in records)
    qb = b"".join(r.qual.encode() for r in records)
    name_offs = np.zeros(n + 1, np.int64)
    np.cumsum([len(r.name.encode()) for r in records], out=name_offs[1:])
    qual_offs = np.zeros(n + 1, np.int64)
    np.cumsum([len(r.qual) for r in records], out=qual_offs[1:])
    return RecordBatch(codes, n, nb, name_offs, qb, qual_offs)
