"""Per-base Hamming distance on packed words.

Analog of the reference hdist family
(src/utils/functions/hamming/scalar.rs:11-48, multi.rs:122-160): XOR the
packed streams, collapse each 2-bit group to one bit (lower | upper>>1,
scalar.rs:40-44), mask to the valid length, popcount, reduce over words.
Batched over reads and database entries — the reference processes one pair
per call.

The XLA formulation keeps an optimization_barrier between the popcount and
the word-axis reduction, and extracts exact top-k iteratively with
single-value reduces (k rounds of min, index-of-min, mask-out; ties resolve
to the lowest index, deterministically). Both were chosen for a compiler
that serialized fused reduces and variadic reduces; whether the GPU still
needs either is an open measurement (ROADMAP 3.5).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils import bitops


def _popcount_diff(words1: jax.Array, words2: jax.Array, mask: jax.Array) -> jax.Array:
    """Per-word per-base difference counts, barriered against reduce fusion."""
    diff = bitops.basewise_diff(words1, words2) & mask
    return jax.lax.optimization_barrier(bitops.popcount32(diff))


def _sum_words(p: jax.Array) -> jax.Array:
    """Sum over the trailing word axis as a dot with a ones vector.

    Exact: every operand is an integer <= 16 and every partial sum is an
    integer <= 16 W, which f32 holds exactly for W < 2^20 (2^24 / 16).
    TF32 operands would also be exact (11-bit significands hold integers up
    to 2048), but precision=HIGHEST keeps the claim off TF32 entirely."""
    W = p.shape[-1]
    s = jax.lax.dot_general(
        p.astype(jnp.float32),
        jnp.ones((W,), jnp.float32),
        dimension_numbers=(((p.ndim - 1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    return s.astype(jnp.int32)


@jax.jit
def hdist_words(words1: jax.Array, words2: jax.Array, n_bases: jax.Array) -> jax.Array:
    """Per-base Hamming distance between paired packed reads.

    words1, words2: [..., W] uint32 packed words.
    n_bases: [...] int32 (or scalar) number of leading bases to compare.
    Returns [...] int32 distances.
    """
    W = words1.shape[-1]
    n_bases = jnp.asarray(n_bases, jnp.int32)
    mask = bitops.word_valid_mask(W, n_bases)
    return _sum_words(_popcount_diff(words1, words2, mask))


@jax.jit
def hdist_one_to_many(query: jax.Array, database: jax.Array, n_bases) -> jax.Array:
    """Distance from one packed query [W] to every database row [D, W].

    The building block of the hdist database scan (BASELINE.json config 5)."""
    return hdist_words(query[None, :], database, jnp.asarray(n_bases, jnp.int32))


@partial(jax.jit, static_argnames=("k",))
def topk_smallest(values: jax.Array, k: int):
    """Exact k smallest of a 1-D int array with their indices, ascending;
    ties broken by lowest index. If k > n, the tail is sentinel-filled
    (distance 2^30, index -1) rather than phantom zeros. Uses only
    single-value reduces (see module docstring)."""
    n = values.shape[0]
    big = jnp.int32(2**30)
    idx_range = jnp.arange(n, dtype=jnp.int32)

    def body(i, st):
        vals, outd, outi = st
        m = jnp.min(vals)
        im = jnp.min(jnp.where(vals == m, idx_range, big))
        vals = vals.at[im].set(big)
        return vals, outd.at[i].set(m), outi.at[i].set(im)

    # derive the accumulators from `values` so they carry the same varying
    # manual axes under shard_map (a fresh zeros() would be unvarying and
    # fail the fori_loop carry type check)
    zero = (values[0] & 0).astype(jnp.int32)
    outd0 = jnp.full(k, big, jnp.int32) + zero
    outi0 = jnp.full(k, -1, jnp.int32) + zero
    _, outd, outi = jax.lax.fori_loop(
        0, min(k, n), body, (values.astype(jnp.int32), outd0, outi0)
    )
    return outd, outi


@partial(jax.jit, static_argnames=("k", "chunk"))
def topk_smallest_batch(values: jax.Array, k: int, chunk: int = 512):
    """Exact per-row k smallest of [Q, D] NON-NEGATIVE int values with
    indices, each row ascending, ties by lowest index — the batched twin
    of topk_smallest with ONE full pass over the matrix instead of k.
    Negative inputs wrap in the u32 packing and sort LAST — callers with
    signed scores must use the iterative topk_smallest (distances are
    >= 0 by construction everywhere this is dispatched).

    The vmapped iterative top-k makes k sequential masked-min+scatter
    passes over the [Q, D] matrix. Here (value, index)
    pack into one u32 key (value in the high bits, so a u32 min IS the
    (value, lowest-index) lexicographic winner); stage 1 reduces each
    C-column chunk to its packed min in one pass, stage 2 extracts the
    global min k times, each time re-deriving ONLY the winning chunk's
    next-best from a [Q, C] gather. Caller must guarantee
    max(values) < 2^(32 - ceil(log2(D_padded))) (hdist callers: n_bases
    bits + index bits <= 32) — hdist_topk_batch checks and falls back.
    """
    Q, D = values.shape
    big = jnp.int32(2**30)
    C = chunk
    nC = -(-D // C)
    Dp = nC * C
    ib = max(1, (Dp - 1).bit_length())  # index bits
    SENT = jnp.uint32(0xFFFFFFFF)

    vals = jnp.pad(
        values.astype(jnp.int32), ((0, 0), (0, Dp - D)),
        constant_values=2**30,
    )
    # clamp pad to the packable max (real values must fit by contract)
    vmax = (1 << (32 - ib)) - 1
    vals_c = jnp.minimum(vals, vmax).astype(jnp.uint32)
    idx = jnp.arange(Dp, dtype=jnp.uint32)
    packed = (vals_c << jnp.uint32(ib)) | idx  # [Q, Dp]
    p3 = packed.reshape(Q, nC, C)
    cmin = jnp.min(p3, axis=-1)  # [Q, nC] — the ONE full pass

    rowq = jnp.arange(Q)

    # Extraction state: the [Q, k] list of already-won packed keys (all
    # globally unique, since the index rides in the key) — re-deriving a
    # chunk's next-best masks at most k prior winners with k broadcast
    # compares over the [Q, C] gathered chunk.
    def body2(i, st):
        cmin, won, outd, outi = st
        g = jnp.min(cmin, axis=-1)
        gi = (g & jnp.uint32((1 << ib) - 1)).astype(jnp.int32)
        gv = (g >> jnp.uint32(ib)).astype(jnp.int32)
        # vmax marks both the clamped padding and fully-won-out chunks
        # (SENT >> ib == vmax); real values are < vmax by contract
        dead = gv >= jnp.int32(vmax)
        outd = outd.at[:, i].set(jnp.where(dead, big, gv))
        outi = outi.at[:, i].set(jnp.where(dead, -1, gi))
        won = won.at[:, i].set(jnp.where(dead, SENT, g))
        c_q = jnp.where(dead, 0, gi // C)
        chunk_p = jnp.take_along_axis(
            p3, c_q[:, None, None].astype(jnp.int32), axis=1
        )[:, 0, :]  # [Q, C]
        # mask every previously-extracted key of THIS chunk (all k won
        # keys are globally unique packed values; comparing against the
        # full won list is k broadcasts over [Q, C])
        masked = chunk_p
        for j_ in range(k):
            masked = jnp.where(masked == won[:, j_ : j_ + 1], SENT, masked)
        newmin = jnp.min(masked, axis=-1)  # [Q]
        cmin = cmin.at[rowq, c_q].set(
            jnp.where(dead, cmin[rowq, c_q], newmin)
        )
        return cmin, won, outd, outi

    won0 = jnp.full((Q, k), SENT, jnp.uint32)
    outd0 = jnp.full((Q, k), big, jnp.int32)
    outi0 = jnp.full((Q, k), -1, jnp.int32)
    _, _, outd, outi = jax.lax.fori_loop(
        0, min(k, D), body2, (cmin, won0, outd0, outi0)
    )
    return outd, outi


@partial(jax.jit, static_argnames=("k",))
def hdist_topk(query: jax.Array, database: jax.Array, n_bases, k: int):
    """Top-k nearest database rows by Hamming distance.

    Returns (distances [k], indices [k]) sorted ascending by distance
    (ties by index)."""
    d = hdist_one_to_many(query, database, n_bases)
    return topk_smallest(d, k)


def hdist_topk_batch(queries: jax.Array, database: jax.Array, n_bases, k: int):
    """Per-query top-k nearest database rows: [Q, W] x [D, W] ->
    (distances [Q, k], indices [Q, k]), each row ascending (ties by index).

    The batched analog of hdist_topk — reference semantics are hdist
    (src/utils/functions/hamming/multi.rs:122-160) applied per (query, row)
    pair with the caller looping. The sharded version with one collective
    merge lives in parallel/search.py::hdist_search_batch_sharded.

    NOT itself jitted: the blocked-top-k dispatch needs a CONCRETE
    n_bases to check the u32 packing bound (a jit here would trace n_bases
    and lock every caller onto the k-pass iterative path). The pieces it
    composes are jitted.
    """
    d = hdist_many_to_many(queries, database, n_bases)
    return topk_batch_dispatch(d, k, n_bases)


def topk_batch_dispatch(d: jax.Array, k: int, n_bases):
    """Per-row top-k of a [Q, D] distance matrix: the blocked one-pass
    extractor when (value bits + index bits) fit a u32 key, else the
    iterative per-row loop. n_bases must be CONCRETE to qualify (inside
    jit it traces, and the packing bound can't be checked — fall back).
    Values must be non-negative (Hamming distances are); see
    topk_smallest_batch's contract."""
    D = d.shape[-1]
    Dp = -(-D // 512) * 512
    ib = max(1, (Dp - 1).bit_length())
    try:
        nb = int(n_bases)
    except Exception:  # traced value: bound uncheckable at trace time
        nb = None
    if nb is not None and nb < (1 << (32 - ib)) - 1:
        return topk_smallest_batch(d, k)
    return jax.vmap(lambda row: topk_smallest(row, k))(d)


@jax.jit
def hdist_many_to_many(
    queries: jax.Array, database: jax.Array, n_bases
) -> jax.Array:
    """All-pairs distance matrix: [Q, W] x [D, W] -> [Q, D] int32.

    Scans over queries so the barriered popcount intermediate stays [D, W]
    (one query row at a time) instead of [Q, D, W] — the full broadcast
    would materialize Q x D x W x 4 bytes. One database pass per query;
    for database-bound workloads shard D instead (parallel/search.py)."""
    n_bases = jnp.asarray(n_bases, jnp.int32)
    return jax.lax.map(
        lambda q: hdist_one_to_many(q, database, n_bases), queries
    )


def hdist_one_to_many_wm(
    query: jax.Array, db_word_major: jax.Array, n_bases: int
) -> jax.Array:
    """Distances [D] from one packed query [W] to a WORD-MAJOR database
    [W, D]: the batch scan below at Q=1 (on a GPU the Triton kernel, which
    reads the database once instead of transposing it first)."""
    return hdist_many_to_many_wm(query[None, :], db_word_major, n_bases)[0]


def hdist_many_to_many_wm(
    queries: jax.Array, db_word_major: jax.Array, n_bases: int
) -> jax.Array:
    """All-pairs distance matrix against a WORD-MAJOR database:
    [Q, W] x [W, D] -> [Q, D] int32. n_bases must be concrete.

    On a GPU this is the Triton batch kernel (ops/hamming_triton.py), which
    reads each database tile once per block of queries; elsewhere the XLA
    scan above on the row-major view, one database pass per query."""
    if jax.default_backend() == "gpu":
        from . import hamming_triton

        return hamming_triton.hdist_scan_batch(
            queries, db_word_major, int(n_bases)
        )
    return hdist_many_to_many(queries, jnp.transpose(db_word_major), n_bases)
