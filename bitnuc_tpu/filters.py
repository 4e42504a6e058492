"""Quality-aware read trimming and filtering (the fastp/Trimmomatic-style
preprocessing pass; north-star surface — the reference codec has no quality
concept, src/lib.rs).

Two implementations of the same math:

  * numpy reference (adapter_positions / trim_bounds / ... below) — the
    oracle, runs without JAX;
  * ONE fused jitted kernel (_filter_core) that filter_reads dispatches to
    by default. Round-2 profiling showed the numpy adapter scan dominating
    (85% of filter_fastq wall, mostly bool->int32 temporaries across the
    m shifted passes); XLA fuses the whole decision — adapter mismatch
    accumulation, trim spans, mean-q / N-count / complexity / entropy —
    into one pass over the [R, L] byte planes with no materialized
    temporaries. Reductions use masked min/max, not argmax (single-value
    reduces, docs/DESIGN.md §2).

The stage still runs on the HOST-resident byte planes on purpose: it
consumes the quality lines (which never enter the packed 2-bit domain) and
exists to shrink reads BEFORE the upload.

Semantics (phred+33 qualities):
  1. 3' adapter removal: cut at the leftmost position where the adapter
     (or its prefix at the read end) matches within max_error_rate
     (cutadapt-style; adapter_positions).
  2. leading/trailing trim: drop bases from each end with quality < trim_q
     (Trimmomatic LEADING/TRAILING).
  3. filter: keep reads with trimmed length >= min_len, mean trimmed
     quality >= min_mean_q, and at most max_n N/ambiguous bases.
"""

from __future__ import annotations

import contextlib
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np

_ACGT = np.zeros(256, bool)
for _b in b"ACGTacgt":
    _ACGT[_b] = True


def trim_bounds(
    quals: np.ndarray, lengths: np.ndarray, trim_q: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-read [start, end) spans after leading/trailing trim at quality
    < trim_q. quals: uint8 [R, L] phred+33 ASCII; start == end when every
    base is below threshold."""
    R, L = quals.shape
    lengths = np.asarray(lengths, np.int64)
    pos = np.arange(L, dtype=np.int64)[None, :]
    in_read = pos < lengths[:, None]
    good = in_read & (quals >= (33 + int(trim_q)))
    any_good = good.any(axis=1)
    start = np.where(any_good, good.argmax(axis=1), lengths)
    # last good index + 1 via reversed argmax
    last = L - 1 - good[:, ::-1].argmax(axis=1)
    end = np.where(any_good, last + 1, lengths)
    return start.astype(np.int64), end.astype(np.int64)


def adapter_positions(
    ascii_arr: np.ndarray,
    lengths: np.ndarray,
    adapter: bytes,
    max_error_rate: float = 0.1,
    min_overlap: int = 3,
) -> np.ndarray:
    """Per-read 3' adapter start positions (== read length when absent).

    Cutadapt-style 3' semantics: the adapter (or a prefix of it, when the
    read ends mid-adapter) starts at position p if the overlapping bases
    mismatch at a rate <= max_error_rate and the overlap is at least
    min_overlap; the LEFTMOST qualifying p wins and the read is trimmed to
    [0, p). Vectorized over the batch with one [R, L] pass per adapter
    base (m passes total), no per-read python."""
    R, L = ascii_arr.shape
    lengths = np.asarray(lengths, np.int64)
    a = np.frombuffer(bytes(adapter).upper(), np.uint8)
    m = len(a)
    if m == 0:
        return lengths.copy()
    pos = np.arange(L, dtype=np.int64)[None, :]
    mism = np.zeros((R, L), np.int32)
    upper = ascii_arr & 0xDF  # case-fold: 'a'..'t' -> 'A'..'T'
    for j in range(m):
        cmp = np.zeros((R, L), bool)
        if j < L:
            cmp[:, : L - j] = upper[:, j:] != a[j]
        in_read = (pos + j) < lengths[:, None]
        mism += (cmp & in_read).astype(np.int32)
    overlap = np.minimum(m, lengths[:, None] - pos)
    ok = (
        (overlap >= max(int(min_overlap), 1))
        & (mism <= (overlap * max_error_rate).astype(np.int64))
    )
    any_ok = ok.any(axis=1)
    first = np.where(any_ok, ok.argmax(axis=1), lengths)
    return first.astype(np.int64)


def complexity_fraction(
    ascii_arr: np.ndarray, start: np.ndarray, end: np.ndarray
) -> np.ndarray:
    """fastp's low-complexity measure per read: the fraction of positions
    in [start, end) whose base differs from the NEXT base (fastp
    -y/--low_complexity_filter, default threshold 0.30). Homopolymers
    score 0.0, random sequence ~0.75. Reads with fewer than 2 spanned
    bases score 1.0 (never complexity-filtered; the length filter owns
    them)."""
    R, L = ascii_arr.shape
    pos = np.arange(L - 1, dtype=np.int64)[None, :]
    in_pair = (pos >= start[:, None]) & (pos + 1 < end[:, None])
    diff = ascii_arr[:, :-1] != ascii_arr[:, 1:]
    n_pairs = in_pair.sum(axis=1)
    frac = (in_pair & diff).sum(axis=1) / np.maximum(n_pairs, 1)
    return np.where(n_pairs > 0, frac, 1.0)


def triplet_entropy(
    ascii_arr: np.ndarray, start: np.ndarray, end: np.ndarray
) -> np.ndarray:
    """Shannon entropy (bits, 0..6) of the trinucleotide distribution in
    [start, end) — the DUST-class complexity signal. Windows touching
    non-ACGT bases are skipped; reads with no valid triplet score 6.0
    (maximally complex: never filtered on entropy alone)."""
    R, L = ascii_arr.shape
    code = np.full(256, -1, np.int8)
    for i, b in enumerate(b"ACGT"):
        code[b] = i
        code[b + 32] = i
    c = code[ascii_arr].astype(np.int64)
    if L < 3:
        return np.full(R, 6.0)
    k0, k1, k2 = c[:, :-2], c[:, 1:-1], c[:, 2:]
    key = k0 * 16 + k1 * 4 + k2
    pos = np.arange(L - 2, dtype=np.int64)[None, :]
    ok = (
        (pos >= start[:, None])
        & (pos + 3 <= end[:, None])
        & (k0 >= 0)
        & (k1 >= 0)
        & (k2 >= 0)
    )
    # one flat bincount over row*64 + key (a [R, L, 64] one-hot would cost
    # 64x the memory at fastq batch sizes)
    rows = np.broadcast_to(np.arange(R, dtype=np.int64)[:, None], key.shape)
    flat = (rows * 64 + key)[ok]
    counts = np.bincount(flat, minlength=R * 64).reshape(R, 64).astype(np.float64)
    n = counts.sum(axis=1)
    p = counts / np.maximum(n, 1)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        h = -(p * np.log2(np.where(p > 0, p, 1))).sum(axis=1)
    return np.where(n > 0, h, 6.0)


@lru_cache(maxsize=None)
def _filter_core(m: int, has_trim: bool, has_meanq: bool, has_maxn: bool,
                 has_cplx: bool, has_ent: bool):
    """Build (and cache) the fused jitted filter kernel for a given
    adapter length / enabled-filter combination. Thresholds stay traced
    (tuning them never recompiles); returns a jitted fn
    (ascii, quals, lengths, adapter, params...) -> (keep, start, end)."""
    import jax
    import jax.numpy as jnp

    def core(ascii_arr, quals, lengths, adapter_a, min_len, min_mean_q,
             trim_q, max_n, a_err, a_minov, min_cplx, min_ent):
        R, L = ascii_arr.shape
        lengths = lengths.astype(jnp.int32)
        pos = jnp.arange(L, dtype=jnp.int32)[None, :]
        big = jnp.int32(L)

        if m:
            upper = ascii_arr & jnp.uint8(0xDF)
            mism = jnp.zeros((R, L), jnp.int32)
            for j in range(m):
                s = jnp.pad(upper[:, j:], ((0, 0), (0, j)))
                in_read = (pos + j) < lengths[:, None]
                mism = mism + (jnp.not_equal(s, adapter_a[j]) & in_read)
            overlap = jnp.minimum(jnp.int32(m), lengths[:, None] - pos)
            ok = (overlap >= jnp.maximum(a_minov, 1)) & (
                mism
                <= jnp.floor(overlap.astype(jnp.float32) * a_err).astype(
                    jnp.int32
                )
            )
            # leftmost qualifying position via a masked min (no argmax)
            first = jnp.min(jnp.where(ok, pos, big), axis=1)
            lengths = jnp.minimum(lengths, first)

        if has_trim:
            in_read = pos < lengths[:, None]
            good = in_read & (quals.astype(jnp.int32) >= 33 + trim_q)
            start = jnp.min(jnp.where(good, pos, big), axis=1)
            last = jnp.max(jnp.where(good, pos, -1), axis=1)
            any_good = last >= 0
            start = jnp.where(any_good, start, lengths)
            end = jnp.where(any_good, last + 1, lengths)
        else:
            start = jnp.zeros((R,), jnp.int32)
            end = lengths

        span = end - start
        in_span = (pos >= start[:, None]) & (pos < end[:, None])
        keep = span >= jnp.maximum(min_len, 1)
        if has_meanq:
            qsum = jnp.sum(
                jnp.where(in_span, quals.astype(jnp.int32) - 33, 0), axis=1
            )
            keep &= qsum.astype(jnp.float32) >= min_mean_q * jnp.maximum(
                span, 1
            ).astype(jnp.float32)
        lower = ascii_arr | jnp.uint8(0x20)
        is_acgt = (
            (lower == ord("a")) | (lower == ord("c"))
            | (lower == ord("g")) | (lower == ord("t"))
        )
        if has_maxn:
            n_bad = jnp.sum(in_span & ~is_acgt, axis=1)
            keep &= n_bad <= max_n
        if has_cplx:
            in_pair = in_span[:, :-1] & (pos[:, 1:] < end[:, None])
            diff = ascii_arr[:, :-1] != ascii_arr[:, 1:]
            n_pairs = jnp.sum(in_pair, axis=1)
            frac = jnp.sum(in_pair & diff, axis=1).astype(
                jnp.float32
            ) / jnp.maximum(n_pairs, 1)
            frac = jnp.where(n_pairs > 0, frac, 1.0)
            keep &= frac >= min_cplx
        if has_ent and L >= 3:
            code = ((ascii_arr >> 1) ^ (ascii_arr >> 2)) & jnp.uint8(3)
            c = code.astype(jnp.int32)
            v = is_acgt
            k0, k1, k2 = c[:, :-2], c[:, 1:-1], c[:, 2:]
            key = k0 * 16 + k1 * 4 + k2
            p2 = pos[:, : L - 2]
            okw = (
                (p2 >= start[:, None]) & (p2 + 3 <= end[:, None])
                & v[:, :-2] & v[:, 1:-1] & v[:, 2:]
            )
            # [R, 64] histogram as a fused one-hot reduce (no scatter)
            onehot = (key[:, :, None] == jnp.arange(64, dtype=jnp.int32)) & (
                okw[:, :, None]
            )
            counts = jnp.sum(onehot, axis=1).astype(jnp.float32)
            n = jnp.sum(counts, axis=1)
            p = counts / jnp.maximum(n, 1)[:, None]
            h = -jnp.sum(p * jnp.log2(jnp.where(p > 0, p, 1)), axis=1)
            h = jnp.where(n > 0, h, 6.0)
            keep &= h >= min_ent
        elif has_ent:
            keep &= jnp.float32(6.0) >= min_ent
        return keep, start, end

    return jax.jit(core)


def _filter_reads_jax(ascii_arr, quals, lengths, min_len, min_mean_q, trim_q,
                      max_n, adapter, adapter_max_error, adapter_min_overlap,
                      min_complexity, min_entropy):
    import jax
    import jax.numpy as jnp

    a = np.frombuffer(bytes(adapter or b"").upper(), np.uint8)
    fn = _filter_core(
        len(a), trim_q > 0, min_mean_q > 0, max_n is not None,
        min_complexity is not None, min_entropy is not None,
    )
    # Pin the kernel to the HOST backend: the quality bytes are
    # host-resident and the keep/trim outputs are host-consumed, so on an
    # accelerator every batch pays dispatch + H2D + D2H for trivially
    # cheap math. Whether a local GPU over PCIe flips this is not measured
    # yet (ROADMAP); the jit itself is backend-agnostic.
    cpus = jax.devices("cpu")
    ctx = jax.default_device(cpus[0]) if cpus else contextlib.nullcontext()
    with ctx:
        keep, start, end = _filter_call(fn, ascii_arr, quals, lengths, a,
                                        min_len, min_mean_q, trim_q, max_n,
                                        adapter_max_error, adapter_min_overlap,
                                        min_complexity, min_entropy)
    return (
        np.asarray(keep),
        np.asarray(start, np.int64),
        np.asarray(end, np.int64),
    )


def _filter_call(fn, ascii_arr, quals, lengths, a, min_len, min_mean_q,
                 trim_q, max_n, adapter_max_error, adapter_min_overlap,
                 min_complexity, min_entropy):
    import jax.numpy as jnp

    keep, start, end = fn(
        jnp.asarray(ascii_arr),
        jnp.asarray(quals),
        jnp.asarray(np.asarray(lengths, np.int32)),
        jnp.asarray(a),
        jnp.int32(min_len),
        jnp.float32(min_mean_q),
        jnp.int32(trim_q),
        jnp.int32(-1 if max_n is None else max_n),
        jnp.float32(adapter_max_error),
        jnp.int32(adapter_min_overlap),
        jnp.float32(min_complexity or 0.0),
        jnp.float32(min_entropy or 0.0),
    )
    return keep, start, end


def filter_reads(
    ascii_arr: np.ndarray,
    quals: np.ndarray,
    lengths: np.ndarray,
    min_len: int = 1,
    min_mean_q: float = 0.0,
    trim_q: int = 0,
    max_n: Optional[int] = None,
    adapter: Optional[bytes] = None,
    adapter_max_error: float = 0.1,
    adapter_min_overlap: int = 3,
    min_complexity: Optional[float] = None,
    min_entropy: Optional[float] = None,
    use_jax: Optional[bool] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(keep [R] bool, start [R], end [R]) for a rectangular read batch.

    Dispatches to the fused jitted kernel (_filter_core) by default —
    measured 13x the numpy path end-to-end in filter_fastq (the numpy
    adapter scan's bool->int temporaries dominated). use_jax=False forces
    the numpy reference path (the parity oracle; also the fallback when
    JAX is unavailable). Both compute: 3' adapter removal first (the
    adapter and everything after it goes), then quality trim spans, then
    mean-quality / length / N-count / complexity filters on the trimmed
    span only."""
    if use_jax is None:
        try:
            import jax  # noqa: F401

            use_jax = True
        except ImportError:  # pragma: no cover
            use_jax = False
    if use_jax:
        return _filter_reads_jax(
            ascii_arr, quals, lengths, min_len, min_mean_q, trim_q, max_n,
            adapter, adapter_max_error, adapter_min_overlap, min_complexity,
            min_entropy,
        )
    R, L = ascii_arr.shape
    lengths = np.asarray(lengths, np.int64)
    if adapter:
        lengths = adapter_positions(
            ascii_arr, lengths, adapter, adapter_max_error, adapter_min_overlap
        )
    if trim_q > 0:
        start, end = trim_bounds(quals, lengths, trim_q)
    else:
        start = np.zeros(R, np.int64)
        end = lengths.copy()
    span = end - start
    pos = np.arange(L, dtype=np.int64)[None, :]
    in_span = (pos >= start[:, None]) & (pos < end[:, None])
    keep = span >= max(int(min_len), 1)
    if min_mean_q > 0:
        qsum = np.where(in_span, quals.astype(np.int64) - 33, 0).sum(axis=1)
        keep &= qsum >= min_mean_q * np.maximum(span, 1)
    if max_n is not None:
        n_bad = (in_span & ~_ACGT[ascii_arr]).sum(axis=1)
        keep &= n_bad <= int(max_n)
    if min_complexity is not None:
        keep &= complexity_fraction(ascii_arr, start, end) >= float(
            min_complexity
        )
    if min_entropy is not None:
        keep &= triplet_entropy(ascii_arr, start, end) >= float(min_entropy)
    return keep, start, end


def _iter_record_batches(path, batch_reads):
    """(names, seqs, quals) list-batches from a FASTQ path (.gz ok)."""
    from . import io as bnio

    names, seqs, quals = [], [], []
    with bnio._fastq_opener(path)(path, "rb") as f:
        while True:
            h = f.readline()
            if not h:
                break
            if not h.strip():
                continue
            s = f.readline().strip()
            f.readline()
            q = f.readline().strip()
            names.append(h[1:].strip())
            seqs.append(s)
            quals.append(q)
            if len(names) >= batch_reads:
                yield names, seqs, quals
                names, seqs, quals = [], [], []
    if names:
        yield names, seqs, quals


def _batch_filter(seqs, quals, min_len, min_mean_q, trim_q, max_n, adapter,
                  min_complexity=None, min_entropy=None):
    """(keep, start, end) for one list-batch."""
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    L = max(int(lens.max()), 1) if len(seqs) else 1
    a = np.zeros((len(seqs), L), np.uint8)
    q = np.zeros((len(seqs), L), np.uint8)
    for i, (s, qq) in enumerate(zip(seqs, quals)):
        a[i, : len(s)] = np.frombuffer(s, np.uint8)
        q[i, : len(qq)] = np.frombuffer(qq, np.uint8)
    return filter_reads(
        a, q, lens, min_len, min_mean_q, trim_q, max_n, adapter=adapter,
        min_complexity=min_complexity, min_entropy=min_entropy,
    )


def filter_fastq(
    in_path,
    out_path,
    min_len: int = 1,
    min_mean_q: float = 0.0,
    trim_q: int = 0,
    max_n: Optional[int] = None,
    adapter: Optional[bytes] = None,
    batch_reads: int = 65536,
    min_complexity: Optional[float] = None,
    min_entropy: Optional[float] = None,
) -> dict:
    """Stream FASTQ -> trimmed/filtered FASTQ; returns summary stats.

    Records stream in `batch_reads` batches (bounded memory at any file
    size); kept reads are written with their trimmed sequence AND quality
    line, preserving headers. Parsing uses the native full-record scanner
    when built (bn_fastq_fill_sq — the per-record Python readline loop was
    the measured bottleneck once the filter math was jitted); the Python
    reader is the fallback."""
    from . import native

    n_in = n_out = bases_in = bases_out = 0
    with open(out_path, "wb") as out:
        if native.available():
            from . import io as bnio

            for raw, a, q, lens, noff, nlen in bnio.iter_fastq_record_batches(
                in_path, batch_reads
            ):
                keep, start, end = filter_reads(
                    a, q, lens.astype(np.int64), min_len, min_mean_q, trim_q,
                    max_n, adapter=adapter, min_complexity=min_complexity,
                    min_entropy=min_entropy,
                )
                n_in += len(lens)
                bases_in += int(lens.sum())
                n_out += int(keep.sum())
                bases_out += int(np.where(keep, end - start, 0).sum())
                # native record assembly: one memcpy pass over the batch
                # (the per-read Python formatting loop was the measured
                # bottleneck once parse + filter math were fast)
                buf = native.filter_emit(raw, a, q, noff, nlen, keep, start, end)
                if buf is not None:
                    out.write(buf)
                else:  # stale .so without bn_filter_emit
                    parts = []
                    for i in np.nonzero(keep)[0]:
                        s0, e0 = int(start[i]), int(end[i])
                        parts.append(
                            b"@%s\n%s\n+\n%s\n"
                            % (
                                raw[noff[i] : noff[i] + nlen[i]],
                                a[i, s0:e0].tobytes(),
                                q[i, s0:e0].tobytes(),
                            )
                        )
                    out.write(b"".join(parts))
        else:
            for names, seqs, quals in _iter_record_batches(
                in_path, batch_reads
            ):
                keep, start, end = _batch_filter(
                    seqs, quals, min_len, min_mean_q, trim_q, max_n, adapter,
                    min_complexity, min_entropy,
                )
                n_in += len(seqs)
                bases_in += sum(len(s) for s in seqs)
                for i in np.nonzero(keep)[0]:
                    s0, e0 = int(start[i]), int(end[i])
                    out.write(
                        b"@%s\n%s\n+\n%s\n"
                        % (names[i], seqs[i][s0:e0], quals[i][s0:e0])
                    )
                    n_out += 1
                    bases_out += e0 - s0
    return {
        "reads_in": n_in,
        "reads_out": n_out,
        "bases_in": bases_in,
        "bases_out": bases_out,
    }


def filter_fastq_paired(
    in1,
    in2,
    out1,
    out2,
    min_len: int = 1,
    min_mean_q: float = 0.0,
    trim_q: int = 0,
    max_n: Optional[int] = None,
    adapter: Optional[bytes] = None,
    batch_reads: int = 65536,
    min_complexity: Optional[float] = None,
    min_entropy: Optional[float] = None,
) -> dict:
    """Paired-end twin of filter_fastq: R1/R2 stream in lockstep and a pair
    survives only if BOTH mates pass (trimming is per-mate) — the standard
    Illumina contract that keeps the two output files index-aligned.
    Raises ValueError if the inputs have different record counts."""
    n_in = n_out = 0
    it2 = _iter_record_batches(in2, batch_reads)
    with open(out1, "wb") as o1, open(out2, "wb") as o2:
        for (names1, seqs1, quals1) in _iter_record_batches(in1, batch_reads):
            try:
                names2, seqs2, quals2 = next(it2)
            except StopIteration:
                raise ValueError("R2 has fewer records than R1")
            if len(names2) != len(names1):
                raise ValueError("paired inputs have different record counts")
            k1, s1, e1 = _batch_filter(
                seqs1, quals1, min_len, min_mean_q, trim_q, max_n, adapter,
                min_complexity, min_entropy,
            )
            k2, s2, e2 = _batch_filter(
                seqs2, quals2, min_len, min_mean_q, trim_q, max_n, adapter,
                min_complexity, min_entropy,
            )
            keep = k1 & k2
            n_in += len(seqs1)
            for i in np.nonzero(keep)[0]:
                a0, a1 = int(s1[i]), int(e1[i])
                b0, b1 = int(s2[i]), int(e2[i])
                o1.write(
                    b"@%s\n%s\n+\n%s\n"
                    % (names1[i], seqs1[i][a0:a1], quals1[i][a0:a1])
                )
                o2.write(
                    b"@%s\n%s\n+\n%s\n"
                    % (names2[i], seqs2[i][b0:b1], quals2[i][b0:b1])
                )
                n_out += 1
    for _ in it2:
        raise ValueError("R2 has more records than R1")
    return {"pairs_in": n_in, "pairs_out": n_out}
