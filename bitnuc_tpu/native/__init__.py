"""Native C++ host library loader (ctypes).

The reference is native end-to-end (Rust + SIMD intrinsics); in this framework
the device compute path is JAX/XLA, and this module provides the native
host-side runtime: fast single-call codec/hdist/split for the PackedSequence
tier and host staging (packing on the host sends 4x fewer bytes to the
device than ASCII).

Build with `make -C bitnuc_tpu/native`. When the shared library is absent,
`available()` returns False and callers fall back to the numpy oracle —
the same graceful-degradation shape as the reference's runtime SIMD dispatch
(src/utils/packing/mod.rs:81-110).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from .. import oracle
from ..errors import IndexOutOfBounds, InvalidBase, InvalidLength, SequenceTooLong

_LIB_PATH = os.path.join(os.path.dirname(__file__), "libbitnuc_host.so")
_TAG_PATH = _LIB_PATH + ".cputag"
_lib: Optional[ctypes.CDLL] = None
_tried = False

# status codes shared with bitnuc_host.cpp
_OK = 0
_ERR_INVALID_BASE = 1
_ERR_TOO_LONG = 2
_ERR_INVALID_LENGTH = 3
_ERR_OOB = 4


def _isa_compatible() -> bool:
    """False when the .so was built on a host with a DIFFERENT CPU-feature
    set than the one we are running on now.

    The library is compiled -march=native and this container migrates
    across physical hosts (config.host_cpu_tag's docstring records the
    observed XLA:CPU analog of the same hazard): on a lesser host a stale
    binary SIGILLs mid-call instead of erroring. The build writes the
    build host's tag to libbitnuc_host.so.cputag (Makefile / build());
    a mismatch here flips available() to False so every caller takes the
    numpy-oracle fallback — the same runtime feature re-check the
    reference does per call (src/utils/packing/mod.rs:81-110). A missing
    tag file (foreign build system) is accepted for compatibility.
    """
    try:
        with open(_TAG_PATH) as f:
            built = f.read().strip()
    except OSError:
        return True
    if not built:
        return True
    from ..config import host_cpu_tag

    if built == host_cpu_tag():
        return True
    import warnings

    warnings.warn(
        "bitnuc_tpu native library was built on a host with different CPU "
        f"features (built {built}, running {host_cpu_tag()}); falling back "
        "to the numpy oracle. Rebuild with `make -C bitnuc_tpu/native`.",
        RuntimeWarning,
        stacklevel=3,
    )
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        return None
    if not _isa_compatible():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.bn_encode.restype = ctypes.c_int
    lib.bn_encode.argtypes = [u8p, ctypes.c_size_t, u64p, ctypes.POINTER(ctypes.c_uint8)]
    lib.bn_decode.restype = ctypes.c_int
    lib.bn_decode.argtypes = [u64p, ctypes.c_size_t, ctypes.c_size_t, u8p]
    lib.bn_hdist.restype = ctypes.c_int
    lib.bn_hdist.argtypes = [u64p, u64p, ctypes.c_size_t, ctypes.c_size_t,
                             ctypes.POINTER(ctypes.c_uint64)]
    lib.bn_split.restype = ctypes.c_int
    lib.bn_split.argtypes = [u64p, ctypes.c_size_t, ctypes.c_size_t,
                             ctypes.c_size_t, u64p, u64p]
    lib.bn_encode_batch.restype = ctypes.c_int
    lib.bn_encode_batch.argtypes = [u8p, ctypes.c_size_t, ctypes.c_size_t,
                                    u64p, ctypes.c_size_t]
    lib.bn_encode_batch_mt.restype = ctypes.c_int
    lib.bn_encode_batch_mt.argtypes = [u8p, ctypes.c_size_t, ctypes.c_size_t,
                                       u64p, ctypes.c_size_t, ctypes.c_int]
    lib.bn_count_kmers.restype = ctypes.c_int
    lib.bn_count_kmers.argtypes = [u64p, ctypes.c_size_t, ctypes.c_size_t,
                                   ctypes.c_size_t, u64p]
    szp = ctypes.POINTER(ctypes.c_size_t)
    lib.bn_fastq_scan.restype = ctypes.c_int
    lib.bn_fastq_scan.argtypes = [u8p, ctypes.c_size_t, szp, szp]
    lib.bn_fastq_fill.restype = ctypes.c_int
    lib.bn_fastq_fill.argtypes = [u8p, ctypes.c_size_t, u8p,
                                  ctypes.POINTER(ctypes.c_int32),
                                  ctypes.c_size_t, ctypes.c_size_t]
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.bn_fastq_fill_sq.restype = ctypes.c_int
    lib.bn_fastq_fill_sq.argtypes = [u8p, ctypes.c_size_t, u8p, u8p,
                                     ctypes.POINTER(ctypes.c_int32),
                                     i64p, i64p,
                                     ctypes.c_size_t, ctypes.c_size_t]
    if hasattr(lib, "bn_filter_emit"):
        lib.bn_filter_emit.restype = ctypes.c_int64
        lib.bn_filter_emit.argtypes = [u8p, u8p, u8p,
                                       ctypes.c_size_t, ctypes.c_size_t,
                                       i64p, i64p, u8p, i64p, i64p, u8p]
    i32p_ = ctypes.POINTER(ctypes.c_int32)
    if hasattr(lib, "bn_merge_join"):
        lib.bn_merge_join.restype = ctypes.c_int
        lib.bn_merge_join.argtypes = [u64p, ctypes.c_size_t, u64p,
                                      ctypes.c_size_t, u8p, i32p_]
    if hasattr(lib, "bn_list_rank"):
        lib.bn_list_rank.restype = ctypes.c_int
        lib.bn_list_rank.argtypes = [i32p_, ctypes.c_size_t, i32p_, i32p_,
                                     ctypes.c_int]
    if hasattr(lib, "bn_graph_edges"):
        lib.bn_graph_edges.restype = ctypes.c_int
        lib.bn_graph_edges.argtypes = [u64p, ctypes.c_size_t, ctypes.c_int,
                                       u8p, i32p_, i32p_, i32p_, i32p_,
                                       i32p_, i32p_, i32p_]
    if hasattr(lib, "bn_argsort_u64"):
        lib.bn_argsort_u64.restype = ctypes.c_int
        lib.bn_argsort_u64.argtypes = [u64p, ctypes.c_size_t, i32p_]
    if hasattr(lib, "bn_qc_fold"):
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.bn_qc_fold.restype = ctypes.c_int
        lib.bn_qc_fold.argtypes = [u8p, u8p, i32p,
                                   ctypes.c_size_t, ctypes.c_size_t,
                                   ctypes.c_int, i64p, i64p, i64p, i64p,
                                   ctypes.c_int]
    if hasattr(lib, "bn_spectrum"):
        i32p = ctypes.POINTER(ctypes.c_int32)
        u32p_ = ctypes.POINTER(ctypes.c_uint32)
        lib.bn_spectrum.restype = ctypes.c_int
        lib.bn_spectrum.argtypes = [
            u32p_, ctypes.c_size_t, ctypes.c_size_t, i32p,
            ctypes.c_int, ctypes.c_int, u8p,
            u64p, i32p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build(quiet: bool = True) -> bool:
    """Invoke make to build the shared library; returns availability."""
    global _tried
    import subprocess

    try:
        subprocess.run(
            ["make", "-C", os.path.dirname(__file__)],
            check=True,
            capture_output=quiet,
        )
    except (subprocess.CalledProcessError, FileNotFoundError):
        return False
    # stamp the build host's CPU tag even if make's own python hook was
    # unavailable (see _isa_compatible)
    try:
        from ..config import host_cpu_tag

        with open(_TAG_PATH, "w") as f:
            f.write(host_cpu_tag())
    except OSError:
        pass
    _tried = False
    return available()


def _as_u8(seq) -> np.ndarray:
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    if isinstance(seq, (bytes, bytearray)):
        return np.frombuffer(bytes(seq), dtype=np.uint8)
    return np.ascontiguousarray(np.asarray(seq, dtype=np.uint8))


def encode(seq) -> np.ndarray:
    lib = _load()
    s = _as_u8(seq)
    n = len(s)
    if n == 0:
        return np.zeros(0, dtype=np.uint64)
    out = np.zeros(-(-n // 32), dtype=np.uint64)
    bad = ctypes.c_uint8(0)
    rc = lib.bn_encode(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.byref(bad),
    )
    if rc == _ERR_INVALID_BASE:
        raise InvalidBase(bad.value)
    return out


def as_2bit(seq) -> int:
    s = _as_u8(seq)
    if len(s) > 32:
        raise SequenceTooLong(len(s))
    if len(s) == 0:
        return 0
    return int(encode(s)[0])


def decode(ebuf, n_bases: int) -> bytes:
    lib = _load()
    words = np.ascontiguousarray(np.asarray(ebuf, dtype=np.uint64))
    if n_bases > 32 * len(words):
        raise InvalidLength(n_bases)
    out = np.zeros(n_bases, dtype=np.uint8)
    rc = lib.bn_decode(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(words),
        n_bases,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != _OK:
        raise InvalidLength(n_bases)
    return bytes(out)


def from_2bit(packed: int, n_bases: int) -> bytes:
    if n_bases > 32:
        raise InvalidLength(n_bases)
    return decode(np.array([packed], dtype=np.uint64), n_bases)


def hdist(ebuf1, ebuf2, n_bases: int) -> int:
    lib = _load()
    e1 = np.ascontiguousarray(np.asarray(ebuf1, dtype=np.uint64))
    e2 = np.ascontiguousarray(np.asarray(ebuf2, dtype=np.uint64))
    expected = -(-n_bases // 32)
    if len(e1) < expected or len(e2) < expected:
        raise InvalidLength(n_bases)
    out = ctypes.c_uint64(0)
    rc = lib.bn_hdist(
        e1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        e2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        min(len(e1), len(e2)),
        n_bases,
        ctypes.byref(out),
    )
    if rc != _OK:
        raise InvalidLength(n_bases)
    return int(out.value)


def hdist_scalar(u: int, v: int, length: int) -> int:
    if length > 32:
        raise InvalidLength(length)
    return hdist(
        np.array([u], dtype=np.uint64), np.array([v], dtype=np.uint64), length
    )


def split_packed(ebuf, slen: int, idx: int) -> Tuple[np.ndarray, np.ndarray]:
    lib = _load()
    words = np.ascontiguousarray(np.asarray(ebuf, dtype=np.uint64))
    if idx > slen:
        raise IndexOutOfBounds(idx, slen)
    if idx == 0:
        return np.zeros(0, dtype=np.uint64), words.copy()
    if idx == slen:
        return words.copy(), np.zeros(0, dtype=np.uint64)
    if len(words) == 0:
        return np.zeros(0, dtype=np.uint64), np.zeros(0, dtype=np.uint64)
    n_left = idx // 32 + 1
    n_right = -(-(slen - idx) // 32)
    lbuf = np.zeros(n_left, dtype=np.uint64)
    rbuf = np.zeros(n_right, dtype=np.uint64)
    rc = lib.bn_split(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(words),
        slen,
        idx,
        lbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        rbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc != _OK:
        raise IndexOutOfBounds(idx, slen)
    return lbuf, rbuf


def encode_batch(
    ascii_rect: np.ndarray, out_words_per_read: int, n_threads: int = 0
) -> np.ndarray:
    """Host staging path: rectangular uint8 [B, L] -> u64 words [B, Wp]
    (no validation; invalid bytes produce garbage codes). Used to feed the
    device with packed words instead of ASCII, 4x fewer transfer bytes.
    n_threads=0 uses all hardware threads; 1 forces single-threaded."""
    lib = _load()
    a = np.ascontiguousarray(ascii_rect, dtype=np.uint8)
    B, L = a.shape
    out = np.zeros((B, out_words_per_read), dtype=np.uint64)
    if n_threads == 0:
        n_threads = os.cpu_count() or 1
    lib.bn_encode_batch_mt(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        B,
        L,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_words_per_read,
        int(n_threads),
    )
    return out


def count_kmers(seq, k: int) -> dict:
    """Host k-mer counting: native O(n) rolling window over the packed words
    for k <= 12 (dense bins), else the numpy oracle."""
    if not 1 <= k <= 32:
        from ..errors import InvalidLength

        raise InvalidLength(k)
    if k > 12 or not available():
        return oracle.count_kmers(seq, k)
    lib = _load()
    words = encode(seq)
    n = len(_as_u8(seq))
    # fresh calloc each call: lazily-zeroed pages beat fill(0) on a cached
    # buffer, and a shared buffer would be thread-unsafe
    counts = np.zeros(4**k, dtype=np.uint64)
    lib.bn_count_kmers(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(words),
        n,
        k,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    nz = np.nonzero(counts)[0]
    return {int(i): int(counts[i]) for i in nz}


def filter_emit(raw, ascii_arr, quals, name_off, name_len, keep, start, end):
    """Assemble the kept/trimmed FASTQ records into ONE bytes buffer
    (native memcpy per record — the write-side twin of fastq_to_batch_sq).
    Returns None when the .so lacks the entry point (stale build)."""
    lib = _load()
    if lib is None or not hasattr(lib, "bn_filter_emit"):
        return None
    raw_b = np.frombuffer(raw, dtype=np.uint8)
    a = np.ascontiguousarray(ascii_arr, dtype=np.uint8)
    q = np.ascontiguousarray(quals, dtype=np.uint8)
    B, L = a.shape
    keep = np.ascontiguousarray(keep, dtype=np.uint8)
    start = np.ascontiguousarray(start, dtype=np.int64)
    end = np.ascontiguousarray(np.minimum(end, L), dtype=np.int64)
    noff = np.ascontiguousarray(name_off, dtype=np.int64)
    nlen = np.ascontiguousarray(name_len, dtype=np.int64)
    spans = np.where(keep.astype(bool), np.maximum(end - np.maximum(start, 0), 0), 0)
    names = np.where(keep.astype(bool), nlen, 0)
    total = int(spans.sum() * 2 + names.sum()) + 6 * int(keep.sum())
    out = np.empty(total, dtype=np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i64 = ctypes.POINTER(ctypes.c_int64)
    n = lib.bn_filter_emit(
        raw_b.ctypes.data_as(u8), a.ctypes.data_as(u8), q.ctypes.data_as(u8),
        B, L, noff.ctypes.data_as(i64), nlen.ctypes.data_as(i64),
        keep.ctypes.data_as(u8), start.ctypes.data_as(i64),
        end.ctypes.data_as(i64), out.ctypes.data_as(u8),
    )
    assert n == total, (n, total)
    return out.tobytes()


def merge_join(sorted_keys, sorted_q):
    """(present bool[m], lower-bound idx int32[m]) of sorted queries in a
    sorted unique key array — ONE linear merge instead of m binary
    searches (the de Bruijn graph build's joins stage). Returns None when
    the .so lacks the entry point."""
    lib = _load()
    if lib is None or not hasattr(lib, "bn_merge_join"):
        return None
    keys = np.ascontiguousarray(sorted_keys, dtype=np.uint64)
    q = np.ascontiguousarray(sorted_q, dtype=np.uint64)
    ok = np.zeros(len(q), np.uint8)
    idx = np.zeros(len(q), np.int32)
    if len(keys) and len(q):
        u64 = ctypes.POINTER(ctypes.c_uint64)
        lib.bn_merge_join(
            keys.ctypes.data_as(u64), len(keys), q.ctypes.data_as(u64),
            len(q), ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    return ok.astype(bool), idx


def list_rank(prev, n_threads: int = 0):
    """Threaded pointer-doubling list ranking (assemble._wyllie_rank
    semantics: (rank, jump); cycle nodes rank >= n). Returns None when
    the .so lacks the entry point."""
    lib = _load()
    if lib is None or not hasattr(lib, "bn_list_rank"):
        return None
    p = np.ascontiguousarray(prev, dtype=np.int32)
    n = len(p)
    rank = np.zeros(n, np.int32)
    jump = np.zeros(n, np.int32)
    if n:
        if n_threads == 0:
            n_threads = os.cpu_count() or 1
        i32 = ctypes.POINTER(ctypes.c_int32)
        lib.bn_list_rank(
            p.ctypes.data_as(i32), n, rank.ctypes.data_as(i32),
            jump.ctypes.data_as(i32), int(n_threads),
        )
    return rank, jump


def graph_edges(sorted_keys, k: int):
    """One-pass de Bruijn edge structure over a sorted unique key set:
    (succ_ok bool[4,n], succ_idx i32[4,n], outdeg i32[n], indeg i32[n],
    succ1 i32[n], pred1 i32[n], nxt i32[n], prev i32[n]) — bit-matching
    assemble._Graph.__init__'s numpy construction. None when the .so
    lacks the entry point."""
    lib = _load()
    if lib is None or not hasattr(lib, "bn_graph_edges"):
        return None
    keys = np.ascontiguousarray(sorted_keys, dtype=np.uint64)
    n = len(keys)
    if n >= (1 << 31):
        return None
    succ_ok = np.zeros((4, n), np.uint8)
    succ_idx = np.zeros((4, n), np.int32)
    outdeg = np.zeros(n, np.int32)
    indeg = np.zeros(n, np.int32)
    succ1 = np.zeros(n, np.int32)
    pred1 = np.zeros(n, np.int32)
    nxt = np.zeros(n, np.int32)
    prev = np.zeros(n, np.int32)
    if n:
        u64 = ctypes.POINTER(ctypes.c_uint64)
        u8 = ctypes.POINTER(ctypes.c_uint8)
        i32 = ctypes.POINTER(ctypes.c_int32)
        lib.bn_graph_edges(
            keys.ctypes.data_as(u64), n, int(k),
            succ_ok.ctypes.data_as(u8), succ_idx.ctypes.data_as(i32),
            outdeg.ctypes.data_as(i32), indeg.ctypes.data_as(i32),
            succ1.ctypes.data_as(i32), pred1.ctypes.data_as(i32),
            nxt.ctypes.data_as(i32), prev.ctypes.data_as(i32),
        )
    return (succ_ok.astype(bool), succ_idx, outdeg, indeg, succ1, pred1,
            nxt, prev)


def argsort_u64(keys):
    """Stable u64 argsort (LSD radix) -> int32 permutation; None when the
    .so lacks the entry point. Bit-compatible with
    np.argsort(keys, kind='stable')."""
    lib = _load()
    if lib is None or not hasattr(lib, "bn_argsort_u64"):
        return None
    ks = np.ascontiguousarray(keys, dtype=np.uint64)
    n = len(ks)
    if n >= (1 << 31):
        return None
    order = np.zeros(n, np.int32)
    if n:
        lib.bn_argsort_u64(
            ks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n,
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
    return order


def qc_fold(ascii_arr, quals, lens, qmax, base_by_cycle, qual_by_cycle,
            mean_q_hist, gc_hist, n_threads: int = 0) -> bool:
    """One-pass native QC fold (the fastqc-class batch accumulator):
    accumulates IN PLACE into the caller's int64 arrays. Returns False
    when the .so lacks the entry point (stale build) — callers fall back
    to the numpy fold. Bit-exact with qc._Acc.fold's numpy path (same
    symbol map, phred clipping, and round-half-to-even)."""
    lib = _load()
    if lib is None or not hasattr(lib, "bn_qc_fold"):
        return False
    a = np.ascontiguousarray(ascii_arr, dtype=np.uint8)
    q = np.ascontiguousarray(quals, dtype=np.uint8)
    R, L = a.shape
    ln = np.ascontiguousarray(lens, dtype=np.int32)
    assert base_by_cycle.flags.c_contiguous and qual_by_cycle.flags.c_contiguous
    if n_threads == 0:
        n_threads = os.cpu_count() or 1
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i32 = ctypes.POINTER(ctypes.c_int32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    lib.bn_qc_fold(
        a.ctypes.data_as(u8), q.ctypes.data_as(u8), ln.ctypes.data_as(i32),
        R, L, int(qmax),
        base_by_cycle.ctypes.data_as(i64), qual_by_cycle.ctypes.data_as(i64),
        mean_q_hist.ctypes.data_as(i64), gc_hist.ctypes.data_as(i64),
        int(n_threads),
    )
    return True


def fastq_to_batch(data: bytes, max_len: int = 0):
    """Parse FASTQ bytes into (ascii uint8[B, L], lengths int32[B]) with two
    native passes (no per-record Python). max_len=0 sizes L to the longest
    read; longer reads are truncated otherwise."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    n_reads = ctypes.c_size_t(0)
    longest = ctypes.c_size_t(0)
    lib.bn_fastq_scan(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        ctypes.byref(n_reads), ctypes.byref(longest),
    )
    B = n_reads.value
    L = int(max_len) if max_len else max(int(longest.value), 1)
    ascii_arr = np.zeros((B, L), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    if B:
        lib.bn_fastq_fill(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
            ascii_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), B, L,
        )
    return ascii_arr, lens


def fastq_to_batch_sq(data: bytes, max_len: int = 0):
    """Full-record FASTQ parse: (ascii uint8[B, L], quals uint8[B, L],
    lengths int32[B], name_off int64[B], name_len int64[B]) — seq AND
    quality rectangles plus header byte spans into `data` (past the '@').
    The quality-aware twin of fastq_to_batch for the preprocessing tier
    (filters/qc), replacing the per-record Python readline loop."""
    lib = _load()
    buf = np.frombuffer(data, dtype=np.uint8)
    n_reads = ctypes.c_size_t(0)
    longest = ctypes.c_size_t(0)
    lib.bn_fastq_scan(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
        ctypes.byref(n_reads), ctypes.byref(longest),
    )
    B = n_reads.value
    L = int(max_len) if max_len else max(int(longest.value), 1)
    ascii_arr = np.zeros((B, L), dtype=np.uint8)
    quals = np.zeros((B, L), dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    name_off = np.zeros(B, dtype=np.int64)
    name_len = np.zeros(B, dtype=np.int64)
    if B:
        lib.bn_fastq_fill_sq(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(buf),
            ascii_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            quals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            name_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            name_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            B, L,
        )
    return ascii_arr, quals, lens, name_off, name_len


def _pad_valid(valid, B, L):
    """[B, Lv] base-validity mask -> [B, L] bool, padded True (positions
    past a read's length are already masked by the length test)."""
    v = np.asarray(valid, dtype=bool)
    if v.shape[1] < L:
        v = np.pad(v, ((0, 0), (0, L - v.shape[1])), constant_values=True)
    return v[:, :L]


def _np_spectrum(words, lens, k, canonical, valid):
    """Vectorized numpy twin of bn_spectrum (the fallback when the .so is
    absent/stale): same contract, ~k vector passes over the batch."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    lens = np.asarray(lens, dtype=np.int32)
    B, W = words.shape
    L = W * 16
    j = np.arange(L)
    bases = ((words[:, j // 16] >> (2 * (j % 16))) & 3).astype(np.uint64)
    nwin = L - k + 1
    if nwin <= 0 or B == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int32)
    key = np.zeros((B, nwin), np.uint64)
    rck = np.zeros((B, nwin), np.uint64)
    for t in range(k):
        key |= bases[:, t : t + nwin] << np.uint64(2 * t)
        rck |= (np.uint64(3) - bases[:, t : t + nwin]) << np.uint64(
            2 * (k - 1 - t)
        )
    if canonical:
        key = np.minimum(key, rck)
    ok = (np.arange(nwin)[None, :] + k) <= lens[:, None]
    if valid is not None:
        v = _pad_valid(valid, B, L)
        allv = v[:, :nwin].copy()
        for t in range(1, k):
            allv &= v[:, t : t + nwin]
        ok &= allv
    keys, counts = np.unique(key[ok], return_counts=True)
    return keys.astype(np.uint64), counts.astype(np.int32)


def spectrum(words, lens, k: int, canonical: bool = False, valid=None,
             n_threads: int = 0):
    """K-mer spectrum of a packed read batch ON HOST: (sorted distinct u64
    keys, int32 counts) — semantics of ops.kmer.count_kmers_runs compacted
    (canonical = count min(kmer, revcomp); windows touching an invalid
    base dropped). The assembly spectrum path that skips the device->host
    download entirely (docs/DESIGN.md 15c: the packed reads are
    coverage/48 of the spectrum's D2H bytes). Falls back to a vectorized
    numpy twin when the .so is absent/stale."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    # contiguity matters: ctypes hands the RAW buffer to C, and a strided
    # lengths view read densely yields garbage window counts (OOB hazard)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    lib = _load()
    if lib is None or not hasattr(lib, "bn_spectrum"):
        return _np_spectrum(words, lens, k, canonical, valid)
    B, W = words.shape
    total = int(np.maximum(lens - k + 1, 0).sum())
    if total == 0 or B == 0:
        return np.zeros(0, np.uint64), np.zeros(0, np.int32)
    out_keys = np.zeros(total, np.uint64)
    out_counts = np.zeros(total, np.int32)
    n_out = ctypes.c_int64(0)
    if n_threads == 0:
        n_threads = os.cpu_count() or 1
    v_arr = None
    v_ptr = ctypes.POINTER(ctypes.c_uint8)()
    if valid is not None:
        v_arr = np.ascontiguousarray(
            _pad_valid(valid, B, W * 16), dtype=np.uint8
        )
        v_ptr = v_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    rc = lib.bn_spectrum(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), B, W,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        int(k), int(bool(canonical)), v_ptr,
        out_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        out_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(n_out), int(n_threads),
    )
    if rc != _OK:
        raise InvalidLength(k)
    m = int(n_out.value)
    return out_keys[:m].copy(), out_counts[:m].copy()
