"""Headline benchmark: bases encoded/sec on one chip vs the CPU baseline.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

The reference publishes no numbers and its Rust toolchain is not
in this image, so the baseline is measured live: the single-core native C++
host codec in bitnuc_tpu/native (same SIMD-class algorithm as the reference's
AVX2 path, src/utils/packing/avx.rs). vs_baseline = device bases/sec divided
by that single-core CPU bases/sec; the BASELINE.json target is >= 10x.

Device timing uses the elision-proof harness (bitnuc_tpu/utils/timing.py):
one jit applies the op to K distinct device-generated inputs and sums every
result element, so neither dead-code elimination nor hoisting can shrink
the work (see the module docstring for the compiler cheats it defeats).

Run `python bench.py --all` for the full suite (encode, decode, hdist scan,
k-mer histograms, memcpy calibration) as one JSON line per workload.

It needs a GPU: without one it exits nonzero before any row. The card's
name and power limit (nvidia-smi) are printed before the first row.
"""

from __future__ import annotations

import json
import sys
import time
from functools import partial

import numpy as np


def _cpu_encode_rate(n_bytes: int, iters: int) -> float:
    """Best-of-3 single-core native C++ encode rate on an n_bytes input."""
    from bitnuc_tpu import native

    if not native.available():
        native.build()
    if not native.available():
        return float("nan")
    rng = np.random.default_rng(0)
    seq = bytes(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n_bytes))
    native.encode(seq)  # warmup
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            native.encode(seq)
        best = min(best, (time.perf_counter() - t0) / iters)
    return len(seq) / best


def _cpu_baseline_bases_per_sec() -> float:
    """Single-core native C++ encode throughput at the HEADLINE WORKLOAD
    SIZE (512 MiB per pass — the same traffic the device call moves).

    The same core measures 2.5 Gbases/s on a 1 MiB buffer (L2-resident,
    the size class of the reference's criterion benches) and 1.26 on a
    256 MiB stream (DRAM-bound): the small-buffer figure measures the
    cache, not what a core delivers on the at-scale streaming workload
    the headline claims, so the divisor matches traffic; both numbers are
    reported in the JSON."""
    return _cpu_encode_rate(1 << 29, 1)


def _cpu_cache_hot_bases_per_sec() -> float:
    """Reference-criterion-style small-buffer (1 MiB, cache-resident) rate,
    reported alongside for transparency."""
    return _cpu_encode_rate(1 << 20, 8)


def _encode_make(batch, read_len):
    import jax
    import jax.numpy as jnp

    from bitnuc_tpu.utils import bitops

    def make(key):
        codes = jax.random.randint(key, (batch, read_len), 0, 4, jnp.int32)
        return (
            bitops.code_to_ascii(codes),
            jnp.full((batch,), read_len, jnp.int32),
        )

    return make


def bench_encode(batch=16384, read_len=32768):
    """537M bases/call (512 MiB ascii in + 128 MiB words out): large enough
    that fixed per-call overhead does not dominate. Headline runs pair this
    with a size-matched copy calibration AND a code-independent floor probe
    (bench_encode_floor)."""
    from bitnuc_tpu.ops import codec
    from bitnuc_tpu.utils.timing import amortized_seconds_per_call

    t = amortized_seconds_per_call(
        codec.encode_reads, _encode_make(batch, read_len), k=2
    )
    return batch * read_len / t


def bench_encode_floor(batch=16384, read_len=32768):
    """Code-independent floor for the headline: identical byte streams
    ([B, L] u8 in, [B, L/16] u32 out) with the pack fold replaced by the
    cheapest correct-traffic op (SWAR codes + single-value max fold) — any
    encode formulation with this traffic pattern is bounded by this rate
    on this machine, so headline_rate / floor_rate reads off how much of
    the achievable ceiling the shipping op captures."""
    import jax.numpy as jnp

    from bitnuc_tpu.utils.timing import amortized_seconds_per_call

    W = read_len // 16

    def floor(a, l):
        c = (((a >> 1) ^ (a >> 2)) & 3).reshape(batch, W, 16)
        return jnp.max(c, axis=-1).astype(jnp.uint32)

    t = amortized_seconds_per_call(floor, _encode_make(batch, read_len), k=2)
    return batch * read_len / t


def bench_decode_floor(batch=8192, read_len=32768):
    """Write-side floor for the decode row: identical byte streams
    ([B, W] u32 in, [B, 16W] u8 out) with the per-base code extraction
    replaced by a broadcast repeat (the cheapest correct-traffic program).
    decode_rate / floor_rate reads off how much of the achievable ceiling
    the shipping decode captures."""
    import jax
    import jax.numpy as jnp

    from bitnuc_tpu.utils.bitops import n_words_for
    from bitnuc_tpu.utils.timing import amortized_seconds_per_call

    W = n_words_for(read_len)

    def make(key):
        return (jax.random.bits(key, (batch, W), jnp.uint32),)

    def floor(w):
        w8 = (w & jnp.uint32(0xFF)).astype(jnp.uint8)
        return jnp.broadcast_to(
            w8[:, :, None], (batch, W, 16)
        ).reshape(batch, W * 16)

    t = amortized_seconds_per_call(floor, make, k=2)
    return batch * read_len / t


def bench_decode(batch=8192, read_len=32768):
    import jax
    import jax.numpy as jnp

    from bitnuc_tpu.ops import codec

    from bitnuc_tpu.utils.bitops import n_words_for
    from bitnuc_tpu.utils.timing import amortized_seconds_per_call

    W = n_words_for(read_len)

    def make(key):
        w = jax.random.bits(key, (batch, W), jnp.uint32)
        return (w, jnp.full((batch,), read_len, jnp.int32))

    t = amortized_seconds_per_call(codec.decode_reads, make)
    return batch * read_len / t


def bench_hdist(db=1 << 22, read_len=512):
    """PackedDB scan + exact top-16: reports base-comparisons/sec.

    Uses the shipping search path: word-major layout, the XLA scan."""
    import jax
    import jax.numpy as jnp

    from bitnuc_tpu.database import PackedDB

    from bitnuc_tpu.utils.bitops import n_words_for
    from bitnuc_tpu.utils.timing import amortized_seconds_per_call

    W = n_words_for(read_len)

    def make(key):
        k1, k2 = jax.random.split(key)
        return (
            jax.random.bits(k1, (W,), jnp.uint32),
            jax.random.bits(k2, (W, db), jnp.uint32),
        )

    t = amortized_seconds_per_call(
        lambda q, wm: PackedDB(words_wm=wm, n_bases=read_len).search(q, 16),
        make,
    )
    return db * read_len / t


def bench_hdist_batch(q=64, db=1 << 20, read_len=512):
    """Multi-query scan + per-query exact top-16: Q queries against the
    word-major database (on a GPU the Triton batch kernel). Reports
    base-comparisons/sec (q * db * read_len / t)."""
    import jax
    import jax.numpy as jnp

    from bitnuc_tpu.database import PackedDB

    from bitnuc_tpu.utils.bitops import n_words_for
    from bitnuc_tpu.utils.timing import amortized_seconds_per_call

    W = n_words_for(read_len)

    def make(key):
        k1, k2 = jax.random.split(key)
        return (
            jax.random.bits(k1, (q, W), jnp.uint32),
            jax.random.bits(k2, (W, db), jnp.uint32),
        )

    t = amortized_seconds_per_call(
        lambda qs, wm: PackedDB(words_wm=wm, n_bases=read_len).search_batch(qs, 16),
        make,
    )
    return q * db * read_len / t


def bench_kmer(batch=1024, read_len=16384, k=8, mode="mxu"):
    import jax
    import jax.numpy as jnp

    from bitnuc_tpu.ops import kmer

    from bitnuc_tpu.utils.bitops import n_words_for
    from bitnuc_tpu.utils.timing import amortized_seconds_per_call

    W = n_words_for(read_len)

    def make(key):
        w = jax.random.bits(key, (batch, W), jnp.uint32)
        return (w, jnp.full((batch,), read_len, jnp.int32))

    t = amortized_seconds_per_call(
        lambda w, l: kmer.count_kmers_reads(w, l, k, mode=mode), make
    )
    return batch * (read_len - k + 1) / t


def _synth_fastq(path, n_reads, read_len):
    """Synthesize a uniform-read FASTQ once (cached by size)."""
    import os

    want = None
    if os.path.exists(path):
        with open(path, "rb") as f:
            head = f.readline()
        want = head.startswith(b"@bench_%d_%d" % (n_reads, read_len))
    if want:
        return path
    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", np.uint8)
    qual = b"I" * read_len
    with open(path, "wb") as f:
        CHUNK = 8192
        for s in range(0, n_reads, CHUNK):
            n = min(CHUNK, n_reads - s)
            block = rng.choice(bases, size=(n, read_len))
            f.write(
                b"".join(
                    b"@bench_%d_%d.%d\n%s\n+\n%s\n"
                    % (n_reads, read_len, s + i, block[i].tobytes(), qual)
                    for i in range(n)
                )
            )
    return path


def bench_dedupe(batch=1 << 20, read_len=150):
    """mark_duplicates reads/s on a short-read-sized batch (W=10 words).
    Random content makes nearly every read unique — the multi-key sort
    dominates either way, so this is the worst-case (most live keys)."""
    import jax
    import jax.numpy as jnp

    from bitnuc_tpu.ops.dedupe import mark_duplicates
    from bitnuc_tpu.utils.bitops import n_words_for
    from bitnuc_tpu.utils.timing import amortized_seconds_per_call

    W = n_words_for(read_len)

    def make(key):
        w = jax.random.bits(key, (batch, W), jnp.uint32)
        return (w, jnp.full((batch,), read_len, jnp.int32))

    t = amortized_seconds_per_call(mark_duplicates, make)
    return batch / t


def bench_setop(n=1 << 23, mode="intersect_min"):
    """combine_counts keys/s over two n-row counted lists (random keys:
    ~all distinct at 2^64, overlap negligible — the two sorts dominate)."""
    import jax
    import jax.numpy as jnp

    from bitnuc_tpu.ops.setops import combine_counts
    from bitnuc_tpu.utils.timing import amortized_seconds_per_call

    def make(key):
        # combine_counts' contract is SORTED counted lists (built outside
        # the timed call, like every producer in the codebase does) — the
        # (the setops contract)
        ks = jax.random.split(key, 4)
        a_hi, a_lo = jax.lax.sort(
            (jax.random.bits(ks[0], (n,), jnp.uint32),
             jax.random.bits(ks[1], (n,), jnp.uint32)), num_keys=2
        )
        b_hi, b_lo = jax.lax.sort(
            (jax.random.bits(ks[2], (n,), jnp.uint32),
             jax.random.bits(ks[3], (n,), jnp.uint32)), num_keys=2
        )
        return (
            a_lo, a_hi, jnp.ones((n,), jnp.int32),
            b_lo, b_hi, jnp.ones((n,), jnp.int32),
        )

    t = amortized_seconds_per_call(
        lambda *a: combine_counts(*a, mode=mode), make
    )
    return 2 * n / t


def bench_pipeline(mbytes=192, read_len=300, k=8, staged=None, batch=16384):
    """End-to-end ingestion pipeline: FASTQ file -> (native scan + host pack
    + packed upload when staged) -> device k-mer histogram, host parse of
    batch i+1 overlapped with device compute on batch i via JAX async
    dispatch. Reports bases/sec wall (one sync at the end — legitimate here
    because the result is a real data-dependent reduction over every batch).
    """
    import jax.numpy as jnp

    from bitnuc_tpu import io as bnio
    from bitnuc_tpu.ops import kmer

    n_reads = mbytes * (1 << 20) // (2 * read_len + 32)
    path = _synth_fastq("/tmp/bitnuc_bench.fastq", n_reads, read_len)

    def run():
        total = None
        nb = 0
        for b in bnio.iter_fastq_batches(
            path, batch, max_len=read_len, validate=False, staged=staged, prefetch=2
        ):
            hist = kmer.count_kmers_reads(b.words, b.lengths, k)
            total = hist if total is None else total + hist
            nb += len(b) * read_len
        float(jnp.sum(total))  # host sync drains the async queue
        return nb

    run()  # warm: file cache + compilations
    best = 0.0
    for _ in range(2):
        t0 = time.perf_counter()
        nb = run()
        best = max(best, nb / (time.perf_counter() - t0))
    return best


def bench_loader_only(mbytes=192, read_len=300, batch=65536, staged=True):
    """Calibration row for the pipeline bench: drain the staged loader
    (native scan + host pack + packed upload) WITHOUT any device compute —
    the same-run ceiling any FASTQ->device workload can reach on this
    host state. Reported next to pipeline/fastq_staged so the artifact
    distinguishes code from transfer state."""
    import jax

    from bitnuc_tpu import io as bnio

    n_reads = mbytes * (1 << 20) // (2 * read_len + 32)
    path = _synth_fastq("/tmp/bitnuc_bench.fastq", n_reads, read_len)

    def run():
        nb = 0
        last = None
        for b in bnio.iter_fastq_batches(
            path, batch, max_len=read_len, validate=False, staged=staged,
            prefetch=2,
        ):
            nb += len(b) * read_len
            last = b
        jax.block_until_ready(last.words)
        return nb

    run()
    best = 0.0
    for _ in range(2):
        t0 = time.perf_counter()
        nb = run()
        best = max(best, nb / (time.perf_counter() - t0))
    return best


def bench_parse_only(mbytes=192, read_len=300, batch=65536):
    """Second calibration row: the native FASTQ scan + host ASCII batching
    alone (no packing, no upload) — the parser-side ceiling."""
    from bitnuc_tpu import io as bnio

    n_reads = mbytes * (1 << 20) // (2 * read_len + 32)
    path = _synth_fastq("/tmp/bitnuc_bench.fastq", n_reads, read_len)

    def run():
        nb = 0
        for ascii_arr, lens, _ in bnio.iter_fastq_ascii_batches(
            path, batch, max_len=read_len
        ):
            nb += int(lens.sum())
        return nb

    run()
    best = 0.0
    for _ in range(2):
        t0 = time.perf_counter()
        nb = run()
        best = max(best, nb / (time.perf_counter() - t0))
    return best


def bench_filter(mbytes=96, read_len=300):
    """filter_fastq wall rate (bases/s in): quality trim + adapter +
    complexity, the full fastp-style pass (asked for
    this measurement — filters are host numpy by design; this row says
    whether they keep up with the staged-ingest ceiling)."""
    import os
    import tempfile

    from bitnuc_tpu import filters

    n_reads = mbytes * (1 << 20) // (2 * read_len + 32)
    path = _synth_fastq("/tmp/bitnuc_bench.fastq", n_reads, read_len)
    out = tempfile.mktemp(suffix=".fq", dir="/tmp")
    try:
        best = 0.0
        for rep in range(2):  # first pass warms the jitted filter kernel
            t0 = time.perf_counter()
            filters.filter_fastq(
                path, out, min_len=30, trim_q=5, min_mean_q=10,
                adapter=b"AGATCGGAAGAGC", min_complexity=0.1,
            )
            best = max(best, n_reads * read_len / (time.perf_counter() - t0))
    finally:
        if os.path.exists(out):
            os.unlink(out)
    return best


def bench_qc(mbytes=96, read_len=300):
    """qc_profile wall rate (bases/s): the fastqc-class per-cycle pass."""
    from bitnuc_tpu import qc

    n_reads = mbytes * (1 << 20) // (2 * read_len + 32)
    path = _synth_fastq("/tmp/bitnuc_bench.fastq", n_reads, read_len)
    best = 0.0
    for _ in range(2):  # first pass warms the file cache
        t0 = time.perf_counter()
        qc.qc_profile(path)
        best = max(best, n_reads * read_len / (time.perf_counter() - t0))
    return best


def bench_align(batch=1024, qlen=256, tlen=256):
    """Batched affine-gap Smith-Waterman (anti-diagonal wavefront):
    DP cell updates/sec across the batch (GCUPS * 1e9)."""
    import jax
    import jax.numpy as jnp

    from bitnuc_tpu.ops import align
    from bitnuc_tpu.utils.bitops import n_words_for
    from bitnuc_tpu.utils.timing import amortized_seconds_per_call

    Wq, Wt = n_words_for(qlen), n_words_for(tlen)

    def make(key):
        k1, k2 = jax.random.split(key)
        return (
            jax.random.bits(k1, (batch, Wq), jnp.uint32),
            jnp.full((batch,), qlen, jnp.int32),
            jax.random.bits(k2, (batch, Wt), jnp.uint32),
            jnp.full((batch,), tlen, jnp.int32),
        )

    t = amortized_seconds_per_call(align.sw_score, make)
    return batch * qlen * tlen / t


def bench_map(batch=4096, read_len=150, genome_mb=4):
    """Minimizer read mapping (seed -> vote -> fit extension): reads
    mapped/sec against a random genome (planted reads, so the hot path —
    vote + fit extension — is fully exercised)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bitnuc_tpu import mapper
    from bitnuc_tpu.utils.timing import amortized_seconds_per_call

    rng = np.random.default_rng(11)
    n = genome_mb << 20
    ref = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n))
    idx = mapper.MinimizerIndex.build(ref, k=15, w=10)
    starts = rng.integers(0, n - read_len, size=batch)
    arr = np.stack(
        [np.frombuffer(ref[s : s + read_len], np.uint8) for s in starts]
    )
    from bitnuc_tpu.sequence import PackedReads

    reads = PackedReads.from_ascii(arr, lengths=np.full(batch, read_len, np.int32))
    t_keys = jnp.asarray(idx.keys)
    t_hi = jnp.asarray(idx.keys_hi)
    t_pos = jnp.asarray(idx.pos)
    ref_words = jnp.asarray(idx.ref_words)

    def make(key):
        # distinct per-copy inputs (row permutation): loop-invariant
        # operands are one of the compiler cheats the timing harness
        # exists to defeat (utils/timing.py docstring)
        perm = jax.random.permutation(key, batch)
        return (reads.words[perm], reads.lengths[perm], t_keys, t_hi, t_pos,
                ref_words, jnp.full((), idx.ref_len, jnp.int32))

    fn = partial(
        mapper._map_core, k=idx.k, w=idx.w, bin_bits=5, pad=32, mismatch=1, gap=1
    )
    t = amortized_seconds_per_call(fn, make)
    return batch / t


def bench_merge(batch=16384, read_len=150, frag_len=250):
    """Paired-end overlap merging: pairs merged/sec (offset scan + fragment
    construction; planted overlapping pairs so every pair takes the full
    qualifying path)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bitnuc_tpu.ops import merge_pairs
    from bitnuc_tpu.sequence import PackedReads
    from bitnuc_tpu.utils.timing import amortized_seconds_per_call

    rng = np.random.default_rng(13)
    frag = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(batch, frag_len))
    comp = frag[:, ::-1]
    comp = np.frombuffer(b"ACGT", np.uint8)[
        3 - np.searchsorted(np.frombuffer(b"ACGT", np.uint8), comp)
    ]
    r1 = PackedReads.from_ascii(frag[:, :read_len],
                                lengths=np.full(batch, read_len, np.int32))
    r2 = PackedReads.from_ascii(comp[:, :read_len],
                                lengths=np.full(batch, read_len, np.int32))

    def make(key):
        perm = jax.random.permutation(key, batch)
        return (r1.words[perm], r1.lengths, r2.words[perm], r2.lengths)

    t = amortized_seconds_per_call(
        lambda w1, l1, w2, l2: merge_pairs.merge_pairs(w1, l1, w2, l2), make
    )
    return batch / t


def bench_orf(batch=16384, read_len=512):
    """Six-frame ORF detection: bases scanned/sec (both strands)."""
    import jax
    import jax.numpy as jnp

    from bitnuc_tpu.ops import orf
    from bitnuc_tpu.utils.bitops import n_words_for
    from bitnuc_tpu.utils.timing import amortized_seconds_per_call

    W = n_words_for(read_len)

    def make(key):
        return (
            jax.random.bits(key, (batch, W), jnp.uint32),
            jnp.full((batch,), read_len, jnp.int32),
        )

    t = amortized_seconds_per_call(orf.longest_orf, make)
    return batch * read_len / t


def bench_assemble(genome_mb=2, read_len=150, step=30, k=31):
    """De Bruijn unitig assembly end-to-end (device canonical spectrum +
    host sorted-join graph compaction): read bases consumed/sec. The wall
    clock is host-synced by construction — the result is a materialized
    python list of unitig byte strings. In-bench oracle: the random genome
    must come back as exactly ONE unitig (strand-normalized)."""
    import time

    import numpy as np

    from bitnuc_tpu import assemble
    from bitnuc_tpu.sequence import PackedReads

    rng = np.random.default_rng(17)
    n = genome_mb << 20
    g = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    starts = np.unique(np.append(np.arange(0, n - read_len + 1, step),
                                 n - read_len))
    reads = PackedReads.from_ascii(
        g[starts[:, None] + np.arange(read_len)],
        lengths=np.full(len(starts), read_len, np.int32),
    )
    best = float("inf")
    seqs = []
    for _ in range(3):
        t0 = time.perf_counter()
        seqs, _circ = assemble.assemble_reads(reads, k, min_count=1)
        best = min(best, time.perf_counter() - t0)
    gb = g.tobytes()
    assert len(seqs) == 1 and seqs[0] in (gb, assemble.rc_ascii(gb)), (
        len(seqs),
        len(seqs[0]) if seqs else 0,
    )
    return len(starts) * read_len / best


def bench_assemble_stages(genome_mb=2, read_len=150, step=30, k=31):
    """Assembly stage split: one timed pass per stage, same workload as
    bench_assemble, along the engine assemble_reads(engine='auto') resolves
    to ('device': count_kmers_runs + download of the distinct keys).
    Returns stage -> ms plus an 'engine' tag.
    """
    import time as _t

    import jax
    import numpy as np

    from bitnuc_tpu import assemble, native
    from bitnuc_tpu.ops import kmer as kmer_ops
    from bitnuc_tpu.sequence import PackedReads

    rng = np.random.default_rng(17)
    n = genome_mb << 20
    g = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n)
    starts = np.unique(np.append(np.arange(0, n - read_len + 1, step),
                                 n - read_len))
    reads = PackedReads.from_ascii(
        g[starts[:, None] + np.arange(read_len)],
        lengths=np.full(len(starts), read_len, np.int32),
    )
    assemble.assemble_reads(reads, k, min_count=1)  # warm compiles
    out = {"engine": "device"}
    t0 = _t.perf_counter()
    lo, hi, cts, _ = kmer_ops.count_kmers_runs(
        reads.words, reads.lengths, k, canonical=True
    )
    keys, kc = assemble._runs_to_keys(lo, hi, cts, 1)
    out["spectrum_and_download"] = (_t.perf_counter() - t0) * 1e3
    t0 = _t.perf_counter()
    pk, pc = assemble.prepare_keys(keys, kc, k, both_strands=True)
    out["prepare"] = (_t.perf_counter() - t0) * 1e3
    t0 = _t.perf_counter()
    graph = assemble._Graph(pk, k)
    out["graph"] = (_t.perf_counter() - t0) * 1e3
    t0 = _t.perf_counter()
    seqs, circ = assemble.unitigs_from_keys(pk, k, _graph=graph)
    seqs, circ = assemble.dedupe_strand_twins(seqs, circ, k)
    seqs, circ = assemble._sort_longest_first(seqs, circ)
    out["emit"] = (_t.perf_counter() - t0) * 1e3
    gb = g.tobytes()
    assert len(seqs) == 1 and seqs[0] in (gb, assemble.rc_ascii(gb))
    return out


def bench_memcpy(mbytes=128):
    """Device xor-copy calibration: effective GB/s (read+write)."""
    import jax
    import jax.numpy as jnp

    rows = mbytes * (1 << 20) // 4 // 2048

    from bitnuc_tpu.utils.timing import amortized_seconds_per_call

    def make(key):
        return (jax.random.bits(key, (rows, 2048), jnp.uint32),)

    t = amortized_seconds_per_call(lambda x: x ^ jnp.uint32(0x9E3779B9), make)
    return 2 * mbytes / 1024 / t


def _require_gpu() -> None:
    """Exit nonzero unless JAX sees a GPU; print the card line first."""
    import subprocess

    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"bench: no GPU (platform {jax.devices()[0].platform!r})",
              file=sys.stderr)
        raise SystemExit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    )
    print("card:", smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi gave no card line", flush=True)


def main():
    _require_gpu()
    from bitnuc_tpu import config

    config.enable_compilation_cache()
    cpu = _cpu_baseline_bases_per_sec()
    cpu_hot = _cpu_cache_hot_bases_per_sec()
    # Sample the headline several times and keep the best. Each sample is
    # PAIRED with (a) an xor-copy calibration and (b) a code-independent
    # floor probe from the same moment, so the JSON records both the
    # delivered bandwidth (roofline_frac) and what fraction of the
    # achievable ceiling for this exact byte-traffic pattern the shipping
    # op captures (floor_frac). The calibration burst matches the encode
    # call's ~671MB of traffic.
    dev, cal, floor = 0.0, float("nan"), float("nan")
    for attempt in range(4):
        c = bench_memcpy(336)
        f = bench_encode_floor()
        e = bench_encode()
        if e > dev:
            dev, cal, floor = e, c, f
    vs = dev / cpu if cpu == cpu else float("nan")
    # encode moves 1.25 B/base minimum (1 B ascii in + 0.25 B packed out);
    # the xor-copy calibration counts read+write bytes, so the same-run
    # memory-bound ceiling is cal GB/s / 1.25 B/base.
    roofline_bases = cal * 1e9 / 1.25
    print(
        json.dumps(
            {
                "metric": "bases_encoded_per_sec_chip",
                "value": round(dev, 1),
                "unit": "bases/s",
                "vs_baseline": round(vs, 2),
                "calibration_GBs": round(cal, 2),
                "roofline_frac": round(dev / roofline_bases, 3),
                "floor_bases_per_sec": round(floor, 1),
                "floor_frac": round(dev / floor, 3) if floor == floor else None,
                "cpu_baseline_streaming_512MiB": round(cpu, 1),
                "cpu_cache_hot_1MiB": round(cpu_hot, 1),
                "vs_cpu_cache_hot": round(dev / cpu_hot, 2)
                if cpu_hot == cpu_hot else None,
            }
        )
    )
    if "--all" in sys.argv:
        # Every row is SELF-CONTAINED: it carries the minimum bytes its
        # workload must move per metric unit, an xor-copy calibration taken
        # immediately before and after the measurement, the roofline
        # fraction value*bytes/calibration where a bandwidth ceiling is
        # the right model, and a `bound` tag naming the actual
        # limiting resource. Rows whose wall is host/sort/compute-side
        # carry bytes=None — a device-bandwidth roofline would be the
        # wrong ceiling and a fake fraction is worse than none.
        # (name, fn, unit, bytes_per_unit, bound, cal_mb): cal_mb sizes the
        # xor-copy calibration burst to ~the row's own per-call traffic.
        rows = [
            # decode moves 0.25 B/base in + 1 B/base out; floor below
            # (268M bases/call -> ~335 MB traffic)
            ("bases_decoded_per_sec_chip", lambda: bench_decode(), "bases/s",
             1.25, "memory", 168),
            # packed db scan: 0.25 B per base compared (query amortized);
            # db = 4M x 32 words = 537 MB/call
            ("hdist_base_comparisons_per_sec_chip", lambda: bench_hdist(),
             "base-cmp/s", 0.25, "memory", 268),
            # 64 queries share each db word: 0.25/64 B per comparison;
            # db = 1M x 32 words = 134 MB/call
            ("hdist_batch_q64_base_comparisons_per_sec_chip",
             lambda: bench_hdist_batch(), "base-cmp/s", 0.25 / 64, "memory",
             67),
            # serving regime: the blocked one-pass top-k (DESIGN 18)
            ("hdist_batch_q256_base_comparisons_per_sec_chip",
             lambda: bench_hdist_batch(q=256), "base-cmp/s", 0.25 / 256,
             "compute", 67),
            # counting reads each base once: 0.25 B/kmer (k-overlap), but
            # the one-hot matrix product is FLOP-bound at 4^k/key
            ("kmers_counted_per_sec_chip_k8_mxu",
             lambda: bench_kmer(k=8, mode="mxu"), "kmers/s", 0.25,
             "compute", 64),
            ("kmers_counted_per_sec_chip_k9_mxu",
             lambda: bench_kmer(k=9, mode="mxu"), "kmers/s", 0.25,
             "compute", 64),
            # auto_layout at k=9 and k=12 resolves to the dense scatter
            ("kmers_counted_per_sec_chip_k9_auto",
             lambda: bench_kmer(k=9, mode="auto_layout"), "kmers/s", 0.25,
             "scatter", 256),
            ("kmers_counted_per_sec_chip_k12_auto",
             lambda: bench_kmer(k=12, mode="auto_layout"), "kmers/s", 0.25,
             "scatter", 256),
            ("kmers_counted_per_sec_chip_k21_sorted",
             lambda: bench_kmer(k=21, mode="runs"), "kmers/s", 0.25,
             "sort", 256),
            # wavefront DP: ~0 fresh bytes/cell — scan-step-overhead-bound
            # (DESIGN 12c), a bandwidth roofline would be meaningless
            ("sw_align_cells_per_sec_chip", lambda: bench_align(), "cells/s",
             None, "scan-depth", 64),
            ("reads_mapped_per_sec_chip", lambda: bench_map(), "reads/s",
             None, "sort+scan-depth", 64),
            # merge_pairs: the offset scan (~141 steps) is
            # step-overhead-bound (DESIGN 16)
            ("pairs_merged_per_sec_chip", lambda: bench_merge(), "pairs/s",
             None, "scan-depth", 64),
            # orf: traffic = unpack write+read (1+1 B/base) per strand +
            # packed revcomp (~0.5) ~= 4.5 B/base
            # (8.4M bases/call -> ~38 MB)
            ("orf_bases_scanned_per_sec_chip", lambda: bench_orf(),
             "bases/s", 4.5, "memory", 19),
            ("assembly_read_bases_per_sec", lambda: bench_assemble(),
             "bases/s", None, "host-graph", 64),
            # pipeline/preprocessing rows: ~2.15 B of FASTQ file per base
            # (seq + qual + headers); the wall is host IO/parse, calibrated
            # by the loader/parse rows below, not by device bandwidth
            ("fastq_pipeline_staged_bases_per_sec",
             lambda: bench_pipeline(staged=True), "bases/s", None,
             "host-io", 64),
            ("fastq_pipeline_python_bases_per_sec",
             lambda: bench_pipeline(staged=False), "bases/s", None,
             "host-io", 64),
            ("fastq_loader_only_bases_per_sec", lambda: bench_loader_only(),
             "bases/s", None, "host-io", 64),
            ("fastq_parse_only_bases_per_sec", lambda: bench_parse_only(),
             "bases/s", None, "host-io", 64),
            ("filter_fastq_bases_per_sec", lambda: bench_filter(), "bases/s",
             None, "host-io", 64),
            ("qc_profile_bases_per_sec", lambda: bench_qc(), "bases/s",
             None, "host-io", 64),
        ]
        for name, fn, unit, bytes_per_unit, bound, cal_mb in rows:
            # matched triplet: bracket the measurement with traffic-matched
            # calibrations and take the max (the delivered ceiling around
            # the run); if the fraction still exceeds 1.1, resample the
            # whole triplet once, then annotate rather than report a fake
            # ceiling. The decode floor probe rides inside the same
            # bracket so floor_frac is same-window too.
            fl = None
            for attempt in range(2):
                c0 = bench_memcpy(cal_mb)
                val = fn()
                if name == "bases_decoded_per_sec_chip":
                    fl = bench_decode_floor()
                c1 = bench_memcpy(cal_mb)
                cal = max(c0, c1)
                frac = (
                    val * bytes_per_unit / (cal * 1e9)
                    if bytes_per_unit is not None
                    else None
                )
                if (frac is None or frac <= 1.1) and (
                    fl is None or val / fl <= 1.1
                ):
                    break
            row = {
                "metric": name,
                "value": round(val, 1),
                "unit": unit,
                "vs_baseline": None,
                "calibration_GBs": round(cal, 2),
                "calibration_GBs_pre": round(c0, 2),
                "calibration_GBs_post": round(c1, 2),
                "bytes_per_unit": bytes_per_unit,
                "bound": bound,
            }
            if frac is not None:
                row["roofline_frac"] = round(frac, 3)
                if frac > 1.1:
                    row["cal_note"] = (
                        "bandwidth surged inside the measurement window on "
                        "both samples; fraction not a valid ceiling"
                    )
            if fl is not None:
                row["floor_bases_per_sec"] = round(fl, 1)
                row["floor_frac"] = round(val / fl, 3)
                if val / fl > 1.1:
                    # the op outran its "cheapest correct-traffic program"
                    # twice in-bracket: the floor PROBE lost its floor
                    # status at this window (layout/fusion drift), the op
                    # did not break physics — read the roofline_frac
                    row["floor_note"] = (
                        "floor probe slower than the op at this window; "
                        "floor_frac not a capture ratio here"
                    )
            if name == "assembly_read_bases_per_sec":
                row["stages_ms"] = {
                    s: (round(v, 1) if isinstance(v, float) else v)
                    for s, v in bench_assemble_stages().items()
                }
            print(json.dumps(row), flush=True)
        print(json.dumps({
            "metric": "device_xor_copy_bandwidth",
            "value": round(bench_memcpy(), 1), "unit": "GB/s",
            "vs_baseline": None,
        }), flush=True)
        print(json.dumps({
            "metric": "cpu_baseline_bases_encoded_per_sec",
            "value": round(cpu, 1), "unit": "bases/s", "vs_baseline": None,
        }), flush=True)


if __name__ == "__main__":
    main()
