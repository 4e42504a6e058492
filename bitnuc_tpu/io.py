"""Persistence and sequence-file ingestion.

The reference crate has no I/O of any kind (SURVEY.md §5: no serde, no file
handles) — callers bring their own. A framework needs both ends of the pipe:

  * checkpoint/resume: PackedReads persist as .npz of the packed uint32 word
    array + lengths (2 bits/base on disk, the same 4x-smaller-than-ASCII
    claim as the reference, README.md:124-136). Deterministic kernels make
    re-runs from a checkpoint trivially safe.
  * ingestion: FASTA/FASTQ -> PackedReads batches. Parsing is host-side
    numpy (byte-level, vectorized); packing happens on device in one jitted
    call per batch. The native C++ path (bitnuc_tpu/native) covers per-call
    host packing.
"""

from __future__ import annotations

import io as _stdio
import os
from typing import Iterator, List, Optional, Tuple, Union

import numpy as np

from .sequence import PackedReads

PathLike = Union[str, os.PathLike]


# -- checkpoint / resume ------------------------------------------------------


def save_packed(path: PathLike, reads: PackedReads) -> None:
    """Persist a PackedReads batch as .npz (packed words + lengths)."""
    np.savez_compressed(
        path,
        words=np.asarray(reads.words, dtype=np.uint32),
        lengths=np.asarray(reads.lengths, dtype=np.int32),
    )


def load_packed(path: PathLike) -> PackedReads:
    """Load a PackedReads batch saved by save_packed."""
    import jax.numpy as jnp

    with np.load(path) as z:
        return PackedReads(
            words=jnp.asarray(z["words"]), lengths=jnp.asarray(z["lengths"])
        )


# -- FASTA / FASTQ parsing ----------------------------------------------------


def _split_records_fasta(data: bytes) -> Tuple[List[bytes], List[bytes]]:
    """(names, sequences) from FASTA bytes; sequences may span lines."""
    names: List[bytes] = []
    seqs: List[bytes] = []
    if not data:
        return names, seqs
    # records start with '>' at a line beginning only — '>' is legal inside
    # header descriptions, so split on the line-start delimiter
    body = data[1:] if data.startswith(b">") else data
    chunks = body.split(b"\n>")
    for chunk in chunks:
        if not chunk.strip():
            continue
        nl = chunk.find(b"\n")
        if nl < 0:
            names.append(chunk.strip())
            seqs.append(b"")
            continue
        names.append(chunk[:nl].strip())
        seqs.append(chunk[nl + 1 :].replace(b"\n", b"").replace(b"\r", b""))
    return names, seqs


def split_records_fastq_full(
    data: bytes,
) -> Tuple[List[bytes], List[bytes], List[bytes]]:
    """(headers-with-@, sequences, quality lines) from FASTQ bytes,
    blank-line tolerant — the qual-preserving record parser shared by the
    CLI commands that re-emit records verbatim (sample/demux/subseq/...)."""
    import io as _io

    names: List[bytes] = []
    seqs: List[bytes] = []
    quals: List[bytes] = []
    f = _io.BytesIO(data)
    while True:
        h = f.readline()
        if not h:
            break
        if not h.strip():
            continue
        names.append(h.strip())
        seqs.append(f.readline().strip())
        f.readline()
        quals.append(f.readline().strip())
    return names, seqs, quals


def _split_records_fastq(data: bytes) -> Tuple[List[bytes], List[bytes]]:
    """(names, sequences) from FASTQ bytes (4-line records)."""
    lines = data.split(b"\n")
    names: List[bytes] = []
    seqs: List[bytes] = []
    n_full = len(lines) // 4
    for i in range(n_full):
        h = lines[4 * i]
        if not h.startswith(b"@"):
            raise ValueError(f"malformed FASTQ header at record {i}: {h[:40]!r}")
        names.append(h[1:].strip())
        seqs.append(lines[4 * i + 1].strip())
    return names, seqs


def _read_bytes(path_or_data) -> bytes:
    if isinstance(path_or_data, (bytes, bytearray)):
        return bytes(path_or_data)
    if isinstance(path_or_data, _stdio.IOBase):
        return path_or_data.read()
    p = os.fspath(path_or_data)
    if p.endswith(".gz"):
        import gzip

        with gzip.open(p, "rb") as f:
            return f.read()
    with open(p, "rb") as f:
        return f.read()


def sniff_format(path: PathLike) -> str:
    """'fasta' | 'fastq' from the extension, falling back to the first byte
    ('>' FASTA, '@' FASTQ); .gz-transparent. Raises ValueError when neither
    signal identifies the file."""
    p = os.fspath(path)
    low = p.lower()
    for ext, fmt in (
        (".fa", "fasta"), (".fasta", "fasta"), (".fna", "fasta"),
        (".fq", "fastq"), (".fastq", "fastq"),
    ):
        if low.endswith(ext) or low.endswith(ext + ".gz"):
            return fmt
    if low.endswith(".gz"):
        import gzip

        with gzip.open(p, "rb") as f:
            first = f.read(1)
    else:
        with open(p, "rb") as f:
            first = f.read(1)
    if first == b">":
        return "fasta"
    if first == b"@":
        return "fastq"
    raise ValueError(f"{p}: cannot sniff format (first byte {first!r})")


def read_fasta(
    path_or_data, max_len: Optional[int] = None, validate: bool = True
) -> Tuple[List[bytes], PackedReads]:
    """Parse FASTA (path, .gz path, bytes, or file object) -> (names, reads)."""
    names, seqs = _split_records_fasta(_read_bytes(path_or_data))
    return names, PackedReads.from_ascii(seqs, max_len=max_len, validate=validate)


def read_fastq(
    path_or_data, max_len: Optional[int] = None, validate: bool = True
) -> Tuple[List[bytes], PackedReads]:
    """Parse FASTQ (path, .gz path, bytes, or file object) -> (names, reads)."""
    names, seqs = _split_records_fastq(_read_bytes(path_or_data))
    return names, PackedReads.from_ascii(seqs, max_len=max_len, validate=validate)


def read_fastq_fast(
    path_or_data, max_len: Optional[int] = None, validate: bool = True
) -> PackedReads:
    """Name-free FASTQ ingestion on the native C++ parser: two passes fill
    the rectangular batch buffer with no per-record Python. Falls back to
    read_fastq when the native library is absent."""
    from . import native

    data = _read_bytes(path_or_data)
    if not native.available():
        return read_fastq(data, max_len=max_len, validate=validate)[1]
    ascii_arr, lens = native.fastq_to_batch(data, max_len or 0)
    return PackedReads.from_ascii(ascii_arr, lengths=lens, validate=validate)


def iter_fastq_batches(
    path: PathLike,
    batch_size: int,
    max_len: Optional[int] = None,
    validate: bool = True,
    staged: Optional[bool] = None,
    prefetch: int = 0,
    with_validity: bool = False,
    with_offsets: bool = False,
    start_offset: int = 0,
) -> Iterator[PackedReads]:
    """Stream a FASTQ file in fixed-size PackedReads batches (the data-loader
    shape for device pipelines: host parses batch i+1 while the device
    processes batch i thanks to JAX async dispatch).

    When the native C++ library is built (staged=None auto-detects; True
    forces, False disables), each chunk goes through the STAGED fast path:
    the two-pass native scanner (bn_fastq_scan/fill) frames records with no
    per-record Python, the multithreaded native codec packs on host
    (bn_encode_batch_mt), and the device upload is the packed words —
    0.25 B/base on the wire instead of 1 B ASCII. Pass max_len for stable
    batch shapes (one device compilation instead of one per distinct width).

    prefetch > 0 runs parsing/packing on a producer thread that keeps up to
    `prefetch` batches ready (true double buffering: the native parser and
    packer release the GIL, so host ingestion of batch i+1 overlaps device
    compute on batch i even when the consumer blocks on device results).

    with_validity=True yields (PackedReads, base_valid bool[B, L]) pairs
    instead — the per-base validity computed at parse time (N info is
    unrecoverable after 2-bit packing). Pair with
    count_kmers_reads(base_valid=...) to skip N-containing windows;
    usually combined with validate=False.

    with_offsets=True appends the (uncompressed-stream) byte offset just
    past each batch's last record as the item's final element; feeding it
    back as start_offset resumes framing at that exact boundary in O(1)
    file work — the crash-resume fast path (pipeline.count_fastq). For .gz
    files offsets are decompressed-stream positions (seek decompresses and
    discards the prefix — still no re-parse/re-pack).
    """
    from . import native

    use_native = native.available() if staged is None else bool(staged)
    if use_native and not native.available():
        # a forced path must fail loudly, not silently benchmark the
        # wrong one
        raise RuntimeError(
            "staged=True but the native library is not built "
            "(make -C bitnuc_tpu/native); use staged=None for auto-fallback"
        )
    if use_native:
        gen = _iter_fastq_batches_staged(
            path, batch_size, max_len, validate, with_validity,
            with_offsets, start_offset,
        )
    else:
        gen = _iter_fastq_batches_py(
            path, batch_size, max_len, validate, with_validity,
            with_offsets, start_offset,
        )
    yield from _prefetched(gen, prefetch) if prefetch > 0 else gen


def _emit_batch_py(buf, max_len, validate, with_validity, offset):
    from .sequence import _rectangularize

    ascii_arr, lens = _rectangularize(buf, None, max_len)
    reads = PackedReads.from_ascii(ascii_arr, lengths=lens, validate=validate)
    item = (reads,)
    if with_validity:
        in_range = np.arange(ascii_arr.shape[1])[None, :] < lens[:, None]
        item = item + (_VALID_BASE[ascii_arr] & in_range,)
    if offset is not None:
        item = item + (offset,)
    return item[0] if len(item) == 1 else item


def _iter_fastq_batches_py(
    path: PathLike,
    batch_size: int,
    max_len: Optional[int],
    validate: bool,
    with_validity: bool = False,
    with_offsets: bool = False,
    start_offset: int = 0,
) -> Iterator[PackedReads]:
    """Line-reader fallback (no native library): per-record Python, device
    packing via PackedReads.from_ascii."""
    buf: List[bytes] = []
    with _fastq_opener(path)(path, "rb") as f:
        if start_offset:
            f.seek(start_offset)
        end_pos = start_offset
        while True:
            header = f.readline()
            if not header:
                break
            if not header.strip():
                continue  # tolerate blank lines between records
            if not header.startswith(b"@"):
                raise ValueError(f"malformed FASTQ header: {header[:40]!r}")
            seq = f.readline().strip()
            f.readline()  # '+'
            f.readline()  # quality
            buf.append(seq)
            if len(buf) == batch_size:
                end_pos = f.tell() if with_offsets else 0
                yield _emit_batch_py(
                    buf, max_len, validate, with_validity,
                    end_pos if with_offsets else None,
                )
                buf = []
        if buf:
            end_pos = f.tell() if with_offsets else 0
            yield _emit_batch_py(
                buf, max_len, validate, with_validity,
                end_pos if with_offsets else None,
            )


def _prefetched(gen: Iterator, depth: int) -> Iterator:
    """Drain `gen` on a daemon thread into a bounded queue (data-loader
    double buffering). Preserves order; exceptions re-raise at the
    consumer's next pull. An abandoned consumer (break / exception /
    GeneratorExit) stops the worker and closes the source generator —
    otherwise the thread would block forever on the full queue, pinning the
    open file handle and the buffered batches."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    DONE = object()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            try:
                for item in gen:
                    if not _put(item):
                        return
                _put(DONE)
            except BaseException as e:  # propagate into the consumer
                _put(e)
        finally:
            gen.close()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def _fastq_opener(path: PathLike):
    if os.fspath(path).endswith(".gz"):
        import gzip

        return gzip.open
    return open


_STREAM_BLOCK = 4 << 20  # bytes read per file chunk in the staged path

# validity LUT for host-side validation on the staged path (device never
# sees the ASCII there; reference contract src/utils/packing/naive.rs:10-15)
_VALID_BASE = np.zeros(256, dtype=bool)
_VALID_BASE[np.frombuffer(b"ACGTacgt", np.uint8)] = True


def _staged_to_packed(
    ascii_arr: np.ndarray,
    lens: np.ndarray,
    validate: bool,
    with_validity: bool = False,
    offset=None,
):
    """Host-pack a rectangular ASCII batch with the native codec and upload
    the 2-bit words (4x fewer transfer bytes than ASCII)."""
    from . import native
    from .errors import InvalidBase

    B, L = ascii_arr.shape
    valid = None
    if (validate or with_validity) and B:
        in_range = np.arange(L)[None, :] < lens[:, None]
        valid = _VALID_BASE[ascii_arr] & in_range
        if validate:
            bad = in_range & ~valid
            if bad.any():
                r, c = np.argwhere(bad)[0]  # row-major: first bad read first
                raise InvalidBase(int(ascii_arr[r, c]))
    words_u64 = native.encode_batch(ascii_arr, max(1, -(-L // 32)))
    reads = PackedReads.from_u64(words_u64, lens)
    item = (reads,)
    if with_validity:
        if valid is None:  # B == 0
            valid = np.zeros((B, L), dtype=bool)
        item = item + (valid,)
    if offset is not None:
        item = item + (offset,)
    return item[0] if len(item) == 1 else item


def _iter_fastq_record_blocks(path: PathLike, batch_size: int,
                              start_offset: int = 0):
    """Shared framing core: yield (record_bytes, end_byte_offset) chunks of
    exactly `batch_size` FASTQ records (the trailing partial group comes
    last). Chunked numpy newline scan groups non-blank lines into 4-line
    records; the trailing incomplete record of each block carries into the
    next. Validates headers; no record-level Python."""
    carry = b""
    abs_base = start_offset  # file offset of data[0] (uncompressed stream)
    read_size = _STREAM_BLOCK
    with _fastq_opener(path)(path, "rb") as f:
        if start_offset:
            f.seek(start_offset)
        while True:
            # adaptive: when batch_size records exceed one block, grow the
            # read so the carry+block concat cannot go quadratic
            block = f.read(max(read_size, 2 * len(carry)) if carry else read_size)
            if not block:
                break
            data = carry + block
            arr = np.frombuffer(data, np.uint8)
            nl = np.flatnonzero(arr == 10)
            if nl.size:
                starts = np.concatenate([[0], nl[:-1] + 1])
                line_len = nl - starts
                # blank lines (incl. lone \r) don't advance record framing,
                # matching the tolerant line reader above
                blank = (line_len == 0) | ((line_len == 1) & (arr[starts] == 13))
                nb = np.flatnonzero(~blank)
            else:
                nb = np.zeros(0, np.int64)
            n_rec = nb.size // 4
            if n_rec:
                hdr = arr[starts[nb[0 : 4 * n_rec : 4]]]
                if not np.all(hdr == ord("@")):
                    r = int(np.argmax(hdr != ord("@")))
                    off = starts[nb[4 * r]]
                    raise ValueError(
                        f"malformed FASTQ header: {data[off:off + 40]!r}"
                    )
            emitted = 0
            for b in range(n_rec // batch_size):
                end = int(nl[nb[4 * (b + 1) * batch_size - 1]]) + 1
                yield data[emitted:end], abs_base + end
                emitted = end
            carry = data[emitted:]
            abs_base += emitted  # carry[0] now sits at abs_base
    if carry.strip():
        yield carry, abs_base + len(carry)


def iter_fastq_ascii_batches(
    path: PathLike,
    batch_size: int,
    max_len: Optional[int] = None,
    start_offset: int = 0,
):
    """HOST-level streaming parse (native two-pass scanner, no device work):
    yields (ascii uint8[B, L], lengths int32[B], end_byte_offset) per batch.

    The framing core of the staged loader, exposed so host-side consumers
    (PackedDB.from_fastq) can parse+pack without shipping batches through
    the device. Requires the native library.
    """
    from . import native

    for data, end in _iter_fastq_record_blocks(path, batch_size, start_offset):
        ascii_arr, lens = native.fastq_to_batch(data, max_len or 0)
        if len(lens):
            yield ascii_arr, lens, end


def iter_fastq_record_batches(
    path: PathLike,
    batch_size: int,
    max_len: Optional[int] = None,
):
    """Full-record native streaming parse for the preprocessing tier:
    yields (raw bytes, ascii uint8[B, L], quals uint8[B, L], lens int32[B],
    name_off int64[B], name_len int64[B]) per batch — header spans index
    into `raw` (past the '@'). Requires the native library; filters/qc
    fall back to the per-record Python reader when it is absent."""
    from . import native

    for data, _ in _iter_fastq_record_blocks(path, batch_size):
        ascii_arr, quals, lens, name_off, name_len = native.fastq_to_batch_sq(
            data, max_len or 0
        )
        if len(lens):
            yield data, ascii_arr, quals, lens, name_off, name_len


def _iter_fastq_batches_staged(
    path: PathLike,
    batch_size: int,
    max_len: Optional[int],
    validate: bool,
    with_validity: bool = False,
    with_offsets: bool = False,
    start_offset: int = 0,
) -> Iterator[PackedReads]:
    """Staged device loader: host ascii batches -> host pack -> 2-bit upload."""
    for ascii_arr, lens, end in iter_fastq_ascii_batches(
        path, batch_size, max_len, start_offset
    ):
        yield _staged_to_packed(
            ascii_arr, lens, validate, with_validity,
            end if with_offsets else None,
        )
