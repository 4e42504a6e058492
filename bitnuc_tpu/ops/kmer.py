"""K-mer extraction and counting on packed reads.

The reference documents k-mer counting as caller-side: re-pack every ASCII
window with as_2bit and count into a HashMap (README.md:164-180,
src/lib.rs:160-180) — O(n*k) repacking and a hash table. This
design extracts every window key from the 2-bit code stream in O(n log k)
vector ops (position-doubling: key_{2m}[p] = key_m[p] | key_m[p+m] << 2m),
then replaces the HashMap with either

  * a dense device histogram (scatter-add into 4^k bins) for small k, or
  * sort-based counting (lexicographic sort of (hi, lo) u32 key pairs +
    segment reduction) for k up to 32,

both psum-mergeable across a device mesh (see bitnuc_tpu/parallel/).

Key layout matches the reference exactly: window at position p has value
sum_j code[p+j] << 2j, i.e. as_2bit of the window (src/utils/packing/naive.rs:17),
split into lo = bits [0,32) and hi = bits [32,64) u32 lanes.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..utils import bitops

MAX_DENSE_K = 12  # 4^12 = 16.7M int32 bins = 64 MiB


def _shift_positions(x: jax.Array, m: int) -> jax.Array:
    """out[..., p] = x[..., p+m], zero-filled at the tail. m is static."""
    if m == 0:
        return x
    pad = [(0, 0)] * (x.ndim - 1) + [(0, m)]
    return jnp.pad(x[..., m:], pad)


def _keys_u32(codes: jax.Array, k: int) -> jax.Array:
    """Window keys for k <= 16 bases: [..., L] uint32 where position p holds
    the packed value of bases [p, p+k). Positions past L-k are garbage —
    callers mask. O(L log k) work via position-doubling."""
    assert 1 <= k <= 16
    pows = {1: codes.astype(jnp.uint32)}
    m = 1
    while 2 * m <= k:
        cur = pows[m]
        pows[2 * m] = cur | (_shift_positions(cur, m) << jnp.uint32(2 * m))
        m *= 2
    acc = None
    acc_len = 0
    m = 1
    while m <= k:
        if k & m:
            part = pows[m]
            if acc is None:
                acc, acc_len = part, m
            else:
                acc = acc | (_shift_positions(part, acc_len) << jnp.uint32(2 * acc_len))
                acc_len += m
        m *= 2
    return acc


@partial(jax.jit, static_argnames=("k",))
def kmer_keys(codes: jax.Array, k: int) -> Tuple[jax.Array, jax.Array]:
    """All window keys of width k over a 2-bit code array.

    codes: [..., L] integer codes (from bitops.unpack_words or ascii_to_code).
    Returns (lo, hi): two [..., L] uint32 arrays; window p's packed u64 value
    is hi[p] << 32 | lo[p] (identical to the reference's as_2bit of the
    window). For k <= 16, hi is all zeros. Positions past L-k are garbage.
    """
    if not 1 <= k <= 32:
        raise ValueError(f"k must be in [1, 32], got {k}")
    if k <= 16:
        lo = _keys_u32(codes, k)
        return lo, jnp.zeros_like(lo)
    lo = _keys_u32(codes, 16)
    hi = _shift_positions(_keys_u32(codes, k - 16), 16)
    return lo, hi


def window_valid_mask(L: int, lengths: jax.Array, k: int) -> jax.Array:
    """[..., L] bool: window position p valid iff p + k <= length."""
    pos = jnp.arange(L, dtype=jnp.int32)
    return pos <= (jnp.asarray(lengths, jnp.int32)[..., None] - k)


def sliding_all(valid: jax.Array, k: int) -> jax.Array:
    """out[..., p] = all(valid[..., p:p+k]) — O(L log k) doubling ANDs.

    The window-level lift of a per-base validity mask: a window counts only
    if every base in it is valid (how k-mer engines skip N/ambiguous bases
    — the reference instead refuses the whole sequence, src/error.rs:5).
    Tail positions conservatively False; they are length-masked anyway.
    """
    assert k >= 1
    pows = {1: valid}
    m = 1
    while 2 * m <= k:
        pows[2 * m] = pows[m] & _shift_positions(pows[m], m)
        m *= 2
    acc = pows[m]
    return acc & _shift_positions(acc, k - m) if k > m else acc


def _window_keys(words, lengths, k: int, canonical: bool, base_valid=None):
    """(lo, hi, valid) window keys over a packed batch; canonical=True maps
    each key to min(key, revcomp(key)) (strand-insensitive counting);
    base_valid [..., L] bool restricts to windows of all-valid bases."""
    codes = bitops.unpack_words(words)
    L = codes.shape[-1]
    lo, hi = kmer_keys(codes, k)
    if canonical:
        from . import revcomp

        lo, hi = revcomp.canonical_keys(lo, hi, k)
    valid = window_valid_mask(L, lengths, k)
    if base_valid is not None:
        bv = jnp.asarray(base_valid)
        if bv.shape[-1] < L:  # pad to the word-aligned code length
            pad = [(0, 0)] * (bv.ndim - 1) + [(0, L - bv.shape[-1])]
            bv = jnp.pad(bv, pad)
        valid = valid & sliding_all(bv, k)
    return lo, hi, valid


@partial(jax.jit, static_argnames=("k", "canonical"))
def count_kmers_dense(
    words: jax.Array,
    lengths: jax.Array,
    k: int,
    canonical: bool = False,
    base_valid=None,
) -> jax.Array:
    """Dense k-mer histogram over a batch: [B, W] packed words -> [4^k] int32.

    Device analog of the README HashMap loop (README.md:164-180); bin i holds
    the count of windows whose as_2bit value is i. k <= MAX_DENSE_K.
    """
    assert k <= MAX_DENSE_K, f"dense histogram capped at k={MAX_DENSE_K}"
    lo, _, valid = _window_keys(words, lengths, k, canonical, base_valid)
    keys = jnp.where(valid, lo, 0).reshape(-1).astype(jnp.int32)
    wts = valid.astype(jnp.int32).reshape(-1)
    return jnp.zeros(4**k, jnp.int32).at[keys].add(wts)


MAX_MXU_K = 8  # one-hot matmul histogram: FLOPs scale as 4^k per window


def auto_dense_max_k() -> int:
    """Largest k for which the MANAGED PIPELINE uses the dense engine:
    MAX_DENSE_K on every platform. The pipeline's sparse accumulator is
    int32-window-bounded (~2.1e9 windows/job) while a dense histogram
    folds into an unbounded host int64 array, so dense is kept wherever
    it fits."""
    return MAX_DENSE_K


@partial(jax.jit, static_argnames=("k", "canonical"))
def count_kmers_dense_mxu(
    words: jax.Array,
    lengths: jax.Array,
    k: int,
    canonical: bool = False,
    base_valid=None,
) -> jax.Array:
    """Dense k-mer histogram as a one-hot matrix product (scatter-free).

    Split each key into hi/lo digits and count every (hi, lo) pair with
    one matmul over the window axis:

        hist2d = onehot(hi)^T @ onehot(lo)        # [n_hi, n_lo], f32 accum

    The one-hots are comparison-generated and fused into the matmul by XLA.
    Bin i of the flattened result counts windows whose packed value is i —
    identical to the README HashMap semantics (README.md:164-180).
    """
    assert k <= MAX_MXU_K, f"matmul histogram capped at k={MAX_MXU_K}"
    lo_keys, _, valid = _window_keys(words, lengths, k, canonical, base_valid)
    keys = jnp.where(valid, lo_keys, 0).astype(jnp.int32).reshape(-1)
    wts = valid.reshape(-1)

    lo_bits = k  # 2k key bits split evenly
    n_lo = 1 << lo_bits
    n_hi = (4**k) >> lo_bits
    hi_d = keys >> lo_bits
    lo_d = keys & (n_lo - 1)

    CHUNK = 1 << 22
    N = keys.shape[0]
    hist2d = jnp.zeros((n_hi, n_lo), jnp.int32)
    for s in range(0, N, CHUNK):
        h = hi_d[s : s + CHUNK]
        l = lo_d[s : s + CHUNK]
        w = wts[s : s + CHUNK]
        a = ((h[:, None] == jnp.arange(n_hi, dtype=jnp.int32)[None, :]) & w[:, None])
        b = l[:, None] == jnp.arange(n_lo, dtype=jnp.int32)[None, :]
        # exact: the bf16 operands are 0/1 (bf16 holds both exactly), each
        # product is 0 or 1, and every bin's f32 sum is an integer <= CHUNK
        # = 2^22 < 2^24, below which f32 holds every integer exactly
        part = jax.lax.dot_general(
            a.astype(jnp.bfloat16),
            b.astype(jnp.bfloat16),
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        hist2d = hist2d + part.astype(jnp.int32)
    return hist2d.reshape(-1)


def segment_count(hi_s: jax.Array, lo_s: jax.Array, w_s: jax.Array):
    """Aggregate sorted (hi, lo) key pairs into unique keys + summed weights.

    Returns (u_lo, u_hi, counts, n_unique) in the count_kmers_sorted layout;
    the trailing segment is dropped from n_unique if its total weight is 0
    (the all-invalid sentinel run — a real key's segment always carries
    positive weight). Shared by the local and the all_gather-merged
    (parallel/kmer.py) counting paths.
    """
    N = lo_s.shape[0]
    first = jnp.concatenate(
        [
            jnp.ones((1,), bool),
            (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1]),
        ]
    )
    seg = jnp.cumsum(first.astype(jnp.int32)) - 1
    counts = jnp.zeros(N, jnp.int32).at[seg].add(w_s)
    # all rows of a segment share the key, so duplicate-index set is benign
    u_lo = jnp.zeros(N, jnp.uint32).at[seg].set(lo_s)
    u_hi = jnp.zeros(N, jnp.uint32).at[seg].set(hi_s)
    n_unique = seg[-1] + 1 - (counts[seg[-1]] == 0).astype(jnp.int32)
    return u_lo, u_hi, counts, n_unique


def sorted_count_from_keys(
    lo: jax.Array, hi: jax.Array, valid: jax.Array, k: int
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Sort-count raw window keys: the body of count_kmers_sorted, exposed
    so sharded paths (parallel/kmer.py seq-sharding) can feed their own
    halo-extended key streams through the identical aggregation."""
    sent = jnp.uint32(0xFFFFFFFF)
    n_invalid = jnp.sum((~valid).astype(jnp.int32))

    if k <= 15:
        # keys fit one u32 with headroom (max key 4^15-1 < 2^32-1), so a
        # single-array sort suffices: invalid slots take the sentinel, sort
        # last, and their count is subtracted analytically — 3x less sort
        # traffic than the (hi, lo, weight) triple sort.
        keys = jnp.where(valid, lo, sent).reshape(-1)
        keys_s = jax.lax.sort(keys)
        N = keys_s.shape[0]
        first = jnp.concatenate(
            [jnp.ones((1,), bool), keys_s[1:] != keys_s[:-1]]
        )
        seg = jnp.cumsum(first.astype(jnp.int32)) - 1
        counts = jnp.zeros(N, jnp.int32).at[seg].add(1)
        u_lo = jnp.zeros(N, jnp.uint32).at[seg].set(keys_s)
        u_hi = jnp.zeros(N, jnp.uint32)
        # the sentinel (if present) is the last segment; remove its count
        last = seg[-1]
        has_sent = keys_s[-1] == sent
        counts = counts.at[last].add(
            jnp.where(has_sent, -n_invalid, 0).astype(jnp.int32)
        )
        u_lo = u_lo.at[last].set(jnp.where(has_sent, 0, u_lo[last]))
        n_unique = last + 1 - has_sent.astype(jnp.int32)
        return u_lo, u_hi, counts, n_unique

    # k >= 16: pair sort; weights disambiguate the genuine all-T key from the
    # sentinel (possible at k = 16 and k = 32)
    lo = jnp.where(valid, lo, sent).reshape(-1)
    hi = jnp.where(valid, hi, sent).reshape(-1)
    wts = valid.astype(jnp.int32).reshape(-1)

    hi_s, lo_s, w_s = jax.lax.sort((hi, lo, wts), num_keys=2)
    return segment_count(hi_s, lo_s, w_s)


@partial(jax.jit, static_argnames=("k", "canonical"))
def count_kmers_sorted(
    words: jax.Array,
    lengths: jax.Array,
    k: int,
    canonical: bool = False,
    base_valid=None,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Sort-based k-mer counting for any k <= 32 (the large-k HashMap analog).

    Returns (keys_lo [N], keys_hi [N], counts [N], n_unique scalar) where
    N = total window slots; entries [0, n_unique) are the distinct k-mers in
    ascending (hi, lo) order with their counts; the tail is zero-count
    padding. Invalid window slots sort to the end under an all-ones sentinel
    and carry zero weight.

    This is the compacted REFERENCE layout; its segment aggregation
    scatters. The throughput engine is count_kmers_runs (same counts,
    run-start layout, no scatters).
    """
    lo, hi, valid = _window_keys(words, lengths, k, canonical, base_valid)
    return sorted_count_from_keys(lo, hi, valid, k)


def _run_start_counts(first: jax.Array) -> jax.Array:
    """Run lengths at run starts (0 elsewhere) for a boundary mask over a
    sorted array — scatter-free: next-boundary indices come from one reverse
    cummin."""
    N = first.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    bpos = jnp.where(first, idx, jnp.int32(N))
    nb = jnp.flip(jax.lax.cummin(jnp.flip(bpos)))  # min boundary index >= i
    nb_excl = jnp.concatenate([nb[1:], jnp.full((1,), N, jnp.int32)])
    return jnp.where(first, nb_excl - idx, 0)


def runs_from_keys(
    lo: jax.Array, hi: jax.Array, valid: jax.Array, k: int
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Sort-count raw window keys into RUN-START layout, scatter-free.

    Returns (lo_s [N], hi_s [N], counts [N], n_unique): keys sorted
    ascending by (hi, lo); counts[i] holds the multiplicity of key i exactly
    at the first slot of each distinct key's run and 0 elsewhere; sentinel
    (invalid-window) slots sort last with count 0. n_unique = number of
    slots with counts > 0. Identical (key -> count) mapping as
    count_kmers_sorted; only the layout differs.

    Invalid windows carry the all-ones sentinel (single word for k <= 15,
    pair above), which exceeds every real key except at k = 32 where the
    genuine all-T key shares the sentinel value; there the analytically
    known invalid count is subtracted from the final run — the trick the
    round-1 single-word path used, now for every k, eliminating the weight
    payload from the sort entirely (2 sorted arrays instead of 3).
    """
    sent = jnp.uint32(0xFFFFFFFF)
    n_invalid = jnp.sum((~valid).astype(jnp.int32))

    if k <= 15:
        keys_s = jax.lax.sort(jnp.where(valid, lo, sent).reshape(-1))
        lo_s, hi_s = keys_s, jnp.zeros_like(keys_s)
        first = jnp.concatenate(
            [jnp.ones((1,), bool), keys_s[1:] != keys_s[:-1]]
        )
        is_sent = keys_s[-1] == sent
    else:
        lo_f = jnp.where(valid, lo, sent).reshape(-1)
        hi_f = jnp.where(valid, hi, sent).reshape(-1)
        hi_s, lo_s = jax.lax.sort((hi_f, lo_f), num_keys=2)
        first = jnp.concatenate(
            [
                jnp.ones((1,), bool),
                (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1]),
            ]
        )
        is_sent = (lo_s[-1] == sent) & (hi_s[-1] == sent)

    counts = _run_start_counts(first)
    # subtract the invalid-slot tail from the final run (merged with a
    # genuine all-ones key only where that key is representable)
    N = counts.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    last_start = jnp.max(jnp.where(first, idx, -1))
    counts = counts.at[last_start].add(
        jnp.where(is_sent, -n_invalid, 0).astype(jnp.int32)
    )
    n_unique = jnp.sum((counts > 0).astype(jnp.int32))
    return lo_s, hi_s, counts, n_unique


@partial(jax.jit, static_argnames=("k", "canonical"))
def raw_window_keys(
    words: jax.Array,
    lengths: jax.Array,
    k: int,
    canonical: bool = False,
    base_valid=None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """UNSORTED flat window keys (lo [N], hi [N], weight [N] int32) of a
    packed batch — weight 1 for valid windows, 0 for invalid/padding slots
    (whose key lanes are garbage and must be ignored).

    The streaming accumulator's input: merge_sorted_runs pushes weight-0
    rows to the sentinel and aggregates, so feeding raw keys straight into a
    deferred merge skips the per-batch count_kmers_runs sort entirely —
    one sort per merged superbatch instead of one per batch
    (docs/DESIGN.md §6; the single-batch result is still bit-identical to
    count_kmers_runs' key -> count content)."""
    lo, hi, valid = _window_keys(words, lengths, k, canonical, base_valid)
    return (
        lo.reshape(-1),
        hi.reshape(-1),
        valid.astype(jnp.int32).reshape(-1),
    )


@partial(jax.jit, static_argnames=("k", "canonical"))
def count_kmers_runs(
    words: jax.Array,
    lengths: jax.Array,
    k: int,
    canonical: bool = False,
    base_valid=None,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Scatter-free sort-based k-mer counting, any k <= 32 — the large-k
    throughput engine (run-start layout; see runs_from_keys for the
    contract). Bit-identical (key -> count) content vs count_kmers_sorted
    (docs/DESIGN.md §4)."""
    lo, hi, valid = _window_keys(words, lengths, k, canonical, base_valid)
    return runs_from_keys(lo, hi, valid, k)


def weighted_runs_from_sorted(
    hi_s: jax.Array, lo_s: jax.Array, w_s: jax.Array
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Aggregate sorted (hi, lo) keys with int32 weights into run-start
    totals — scatter- AND gather-free (two scans, DESIGN.md §4).

    The trick: with S = exclusive prefix sum of weights (nondecreasing),
    the weight total of the run starting at i is S[next_boundary] - S[i],
    and S[next_boundary] is recovered WITHOUT a gather as a reverse cummin
    of S masked to boundary positions (monotonicity makes min-over-future-
    boundaries pick exactly the next one), clamped to the grand total for
    the final run.

    Returns (lo_s, hi_s, totals, n_unique) in run-start layout; zero-weight
    runs (sentinel / padding tails) get total 0 and drop out of n_unique.
    """
    N = w_s.shape[0]
    first = jnp.concatenate(
        [jnp.ones((1,), bool), (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1])]
    )
    w_s = w_s.astype(jnp.int32)
    incl = jnp.cumsum(w_s)
    total = incl[-1]
    S = incl - w_s  # exclusive prefix sum
    big = jnp.int32(2**31 - 1)
    V = jnp.where(first, S, big)
    m = jnp.flip(jax.lax.cummin(jnp.flip(V)))  # S at first boundary >= i
    m_excl = jnp.concatenate([m[1:], jnp.full((1,), big, jnp.int32)])
    totals = jnp.where(first, jnp.minimum(m_excl, total) - S, 0)
    n_unique = jnp.sum((totals > 0).astype(jnp.int32))
    return lo_s, hi_s, totals, n_unique


def merge_sorted_runs(lo, hi, counts):
    """Merge CONCATENATED run-start lists into one global run-start list:
    push dead (count 0) rows to the all-ones sentinel, sort, aggregate with
    the gather-free weighted-run scheme. The shared core of the collective
    merge (parallel/kmer.py) and the streaming accumulator (pipeline.py).
    """
    sent = jnp.uint32(0xFFFFFFFF)
    counts = counts.astype(jnp.int32)
    dead = counts == 0
    lo = jnp.where(dead, sent, lo)
    hi = jnp.where(dead, sent, hi)
    hi_s, lo_s, ct_s = jax.lax.sort((hi, lo, counts), num_keys=2)
    return weighted_runs_from_sorted(hi_s, lo_s, ct_s)


@jax.jit
def pack_runs_front(lo, hi, counts):
    """Push live runs (count > 0) to the FRONT in ascending (hi, lo) order,
    dead slots to the back — one extra device sort pass that lets hosts
    download O(n_unique) rows instead of O(window slots) (assemble.py's
    spectrum ingest pulls a power-of-two slice of this). The dead flag is
    the primary sort key, so a live all-ones key (e.g. the k=32 poly-T
    k-mer) still lands inside the live prefix."""
    counts = counts.astype(jnp.int32)
    dead = (counts == 0).astype(jnp.uint8)
    _, hi_s, lo_s, ct_s = jax.lax.sort((dead, hi, lo, counts), num_keys=3)
    return lo_s, hi_s, ct_s


def compact_runs(lo, hi, counts):
    """Host helper: run-start layout (count_kmers_runs) -> dense numpy
    (keys_lo, keys_hi, counts) of just the distinct k-mers, ascending."""
    import numpy as np

    lo, hi, counts = np.asarray(lo), np.asarray(hi), np.asarray(counts)
    m = counts > 0
    return lo[m], hi[m], counts[m]


def count_kmers_reads(
    words: jax.Array,
    lengths: jax.Array,
    k: int,
    mode: str = "auto",
    canonical: bool = False,
    base_valid=None,
):
    """Count k-mers over a batch of packed reads.

    mode='dense'/'mxu' -> [4^k] histogram (scatter / one-hot matmul
    lowering; 'mxu' above MAX_MXU_K takes the scatter);
    mode='sorted' -> sparse compacted (keys, counts, n_unique);
    mode='runs' -> same content in run-start layout, scatter-free (the
    large-k engine, see count_kmers_runs).
    mode='auto' returns a dense [4^k] histogram (the scatter engine) for
    every k <= MAX_DENSE_K and the runs 4-tuple beyond. mode='auto_layout'
    is the name for "fastest engine, native layout"; today it resolves
    exactly as 'auto' on every platform.
    canonical=True counts min(kmer, revcomp(kmer)) — strand-insensitive.
    base_valid [B, L] bool (e.g. codec.validity_mask) drops every window
    containing an invalid/ambiguous base (N handling) instead of erroring.
    """
    if mode in ("auto", "auto_layout"):
        mode = "runs" if k > MAX_DENSE_K else "dense"
    if mode == "mxu":
        if k > MAX_MXU_K:  # the one-hot product outgrows the scatter
            return count_kmers_dense(words, lengths, k, canonical, base_valid)
        return count_kmers_dense_mxu(words, lengths, k, canonical, base_valid)
    if mode == "dense":
        return count_kmers_dense(words, lengths, k, canonical, base_valid)
    if mode == "sorted":
        return count_kmers_sorted(words, lengths, k, canonical, base_valid)
    if mode == "runs":
        return count_kmers_runs(words, lengths, k, canonical, base_valid)
    raise ValueError(f"unknown mode {mode!r}")


@partial(jax.jit, static_argnames=("n",))
def top_kmers(hist: jax.Array, n: int) -> Tuple[jax.Array, jax.Array]:
    """(counts, packed k-mer values) of the n most frequent k-mers,
    descending; ties broken by lowest key.

    Extracted iteratively (n rounds of single-value max reduces, as
    ops.hamming.topk_smallest; docs/DESIGN.md §2); 4^k histograms reach
    16.7M bins at MAX_DENSE_K. If n exceeds the
    histogram size, the tail is (count=-2^30, key=-1) sentinels.
    """
    from .hamming import topk_smallest

    neg, keys = topk_smallest(-hist.astype(jnp.int32), n)
    return -neg, keys


@partial(jax.jit, static_argnames=("max_mult",))
def spectrum(counts: jax.Array, max_mult: int = 255) -> jax.Array:
    """K-mer abundance spectrum: out[m] = number of distinct k-mers occurring
    exactly m times (m in [1, max_mult)); out[max_mult] pools every k-mer at
    or above max_mult; out[0] is always 0. The KMC-`histogram` / GenomeScope
    primitive built on the reference's count semantics (README.md:164-180 —
    a spectrum is the value-histogram of that HashMap).

    `counts` is any counting layout — a dense 4^k histogram, the compacted
    count_kmers_sorted counts, or the run-start count_kmers_runs counts —
    because zero entries (absent keys / non-run slots / padding) are ignored.
    Scatter-free: multiplicities are clipped, one-hot encoded, and contracted
    against ones as a matrix product; bf16 one-hots accumulate exactly in
    f32 below 2^24 per bin, guaranteed by the <=2^22-row chunking.
    """
    assert 1 <= max_mult <= 4096
    c = jnp.minimum(counts, max_mult).astype(jnp.int32).reshape(-1)
    bins = max_mult + 1
    CHUNK = 1 << 22
    N = c.shape[0]
    out = jnp.zeros((bins,), jnp.int32)
    for s in range(0, N, CHUNK):
        cc = c[s : s + CHUNK]
        oh = (cc[:, None] == jnp.arange(1, bins, dtype=jnp.int32)[None, :])
        part = jax.lax.dot_general(
            oh.astype(jnp.bfloat16),
            jnp.ones((cc.shape[0],), jnp.bfloat16),
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        out = out.at[1:].add(part.astype(jnp.int32))
    return out


def _shift_tail(x: jax.Array, m: int, fill) -> jax.Array:
    """out[..., p] = x[..., p+m], `fill` past the end."""
    if m == 0:
        return x
    if m >= x.shape[-1]:  # whole window shifted out (w >= L edge)
        return jnp.full_like(x, fill)
    return jnp.full_like(x, fill).at[..., : x.shape[-1] - m].set(x[..., m:])


def _sliding_min(x: jax.Array, w: int, fill) -> jax.Array:
    """out[..., p] = min(x[..., p : p+w]) via log-step doubling (the sparse-
    table scheme — O(L log w) vector mins, no data-dependent control flow).
    Tail positions use `fill` for out-of-range elements."""
    assert w >= 1
    pows = {1: x}
    m = 1
    while 2 * m <= w:
        cur = pows[m]
        pows[2 * m] = jnp.minimum(cur, _shift_tail(cur, m, fill))
        m *= 2
    # cover [p, p+w) with two (possibly overlapping) power-of-two blocks
    half = m  # largest power of two <= w
    a = pows[half]
    return jnp.minimum(a, _shift_tail(a, w - half, fill))


def _sliding_argmin(keys: jax.Array, w: int, fill) -> Tuple[jax.Array, jax.Array]:
    """(min value, GLOBAL position of the leftmost min) over each w-window,
    by the same doubling scheme with a lexicographic (value, position) min."""
    L = keys.shape[-1]
    pos0 = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32), keys.shape)

    def combine(v1, p1, v2, p2):
        take2 = (v2 < v1) | ((v2 == v1) & (p2 < p1))
        return jnp.where(take2, v2, v1), jnp.where(take2, p2, p1)

    pows = {1: (keys, pos0)}
    m = 1
    while 2 * m <= w:
        v, p = pows[m]
        pows[2 * m] = combine(
            v, p, _shift_tail(v, m, fill), _shift_tail(p, m, jnp.int32(2**30))
        )
        m *= 2
    half = m
    v, p = pows[half]
    off = w - half
    return combine(
        v, p, _shift_tail(v, off, fill), _shift_tail(p, off, jnp.int32(2**30))
    )


@partial(jax.jit, static_argnames=("k", "w", "canonical"))
def minimizer_positions(
    words: jax.Array,
    lengths: jax.Array,
    k: int,
    w: int,
    canonical: bool = False,
    base_valid=None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Like `minimizers`, additionally returning the position of each
    window's (leftmost) minimizer — the seed anchor used by minimap2-style
    pipelines. Returns (vals, positions, valid).

    base_valid [..., L] bool (minimap2's N handling, also the mapper's
    contig-separator mask): k-mers touching an invalid base can never be
    selected; a window whose k-mers are ALL masked is invalid."""
    assert 1 <= k <= 16
    lo, _, valid_k = _window_keys(words, lengths, k, canonical, base_valid)
    sent = jnp.uint32(0xFFFFFFFF)
    keys = jnp.where(valid_k, lo, sent)
    vals, pos = _sliding_argmin(keys, w, sent)
    L = keys.shape[-1]
    p_idx = jnp.arange(L, dtype=jnp.int32)
    valid = p_idx <= (jnp.asarray(lengths, jnp.int32)[..., None] - (k + w - 1))
    valid = valid & (vals != sent)
    return (
        jnp.where(valid, vals, sent),
        jnp.where(valid, pos, -1),
        valid,
    )


@partial(jax.jit, static_argnames=("k", "w", "canonical"))
def minimizers(
    words: jax.Array,
    lengths: jax.Array,
    k: int,
    w: int,
    canonical: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """(w,k)-minimizers over packed reads: for every window of w consecutive
    k-mers, the minimum k-mer value — the sketching/partitioning primitive of
    modern k-mer engines (KMC2/Gerbil-style super-k-mer binning, minimap2
    seeding). k <= 16 (u32 keys).

    Returns (vals [..., L] uint32, valid [..., L] bool): position p holds the
    minimizer of windows starting at p, valid iff p + k + w - 1 <= length.
    Consecutive equal vals belong to the same super-k-mer run.
    """
    assert 1 <= k <= 16, "minimizer keys are u32 (k <= 16)"
    lo, _, valid_k = _window_keys(words, lengths, k, canonical)
    sent = jnp.uint32(0xFFFFFFFF)
    keys = jnp.where(valid_k, lo, sent)
    vals = _sliding_min(keys, w, sent)
    L = keys.shape[-1]
    pos = jnp.arange(L, dtype=jnp.int32)
    valid = pos <= (jnp.asarray(lengths, jnp.int32)[..., None] - (k + w - 1))
    return jnp.where(valid, vals, sent), valid


@partial(jax.jit, static_argnames=("k", "w", "canonical"))
def minimizer_sketch(
    words: jax.Array,
    lengths: jax.Array,
    k: int,
    w: int,
    canonical: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """The DISTINCT (w,k)-minimizer values of a packed batch, sorted
    ascending — a MinHash-class sketch of the sequence content (the
    Mash/sourmash comparison primitive, built on the reference's k-mer
    value semantics).

    Returns (vals [N] uint32, n_unique): entries [0, n_unique) are the
    distinct minimizer values; the tail is the all-ones sentinel. Compare
    sketches with sketch_jaccard / sketch_containment.

    k <= 15: at k = 16 the genuine all-T key equals the 0xFFFFFFFF
    sentinel (4^16 - 1 == 2^32 - 1) and would be indistinguishable from
    padding in the value-only sketch arrays.
    """
    assert 1 <= k <= 15, "sketch keys must leave sentinel headroom (k <= 15)"
    vals, valid = minimizers(words, lengths, k, w, canonical)
    sent = jnp.uint32(0xFFFFFFFF)
    s = jax.lax.sort(vals.reshape(-1))  # invalid slots already sentinel
    first = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    live = first & (s != sent)
    # duplicates -> sentinel, then one more sort compacts the distinct
    # values ascending at the front (real keys < sentinel for k <= 15)
    compact = jax.lax.sort(jnp.where(live, s, sent))
    return compact, jnp.sum(live.astype(jnp.int32))


def _sketch_overlap(a_vals: jax.Array, b_vals: jax.Array):
    """(intersection, union) sizes of two sorted-distinct sketches
    (sentinel-padded). Scatter/gather-free: concat + sort; a value present
    in both sketches forms a run of length exactly 2."""
    merged = jax.lax.sort(jnp.concatenate([a_vals, b_vals]))
    sent = jnp.uint32(0xFFFFFFFF)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), merged[1:] != merged[:-1]]
    )
    counts = _run_start_counts(first)
    live = first & (merged != sent)
    inter = jnp.sum((live & (counts == 2)).astype(jnp.int32))
    union = jnp.sum(live.astype(jnp.int32))
    return inter, union


@jax.jit
def sketch_jaccard(a_vals: jax.Array, b_vals: jax.Array) -> jax.Array:
    """Jaccard similarity |A n B| / |A u B| of two minimizer_sketch outputs
    (0.0 when both sketches are empty)."""
    inter, union = _sketch_overlap(a_vals, b_vals)
    return jnp.where(
        union > 0, inter.astype(jnp.float32) / jnp.maximum(union, 1), 0.0
    )


@jax.jit
def sketch_containment(a_vals: jax.Array, b_vals: jax.Array) -> jax.Array:
    """Containment |A n B| / |A| of sketch A within sketch B (0.0 for an
    empty A) — the asymmetric variant used for contig-in-genome queries."""
    inter, _ = _sketch_overlap(a_vals, b_vals)
    sent = jnp.uint32(0xFFFFFFFF)
    n_a = jnp.sum((a_vals != sent).astype(jnp.int32))
    return jnp.where(
        n_a > 0, inter.astype(jnp.float32) / jnp.maximum(n_a, 1), 0.0
    )


def _sliding_min2(hi: jax.Array, lo: jax.Array, w: int, fill) -> Tuple[jax.Array, jax.Array]:
    """Lexicographic (hi, lo) sliding minimum over each w-window — the
    64-bit-key sibling of _sliding_min, same doubling scheme."""
    assert w >= 1

    def combine(h1, l1, h2, l2):
        take2 = (h2 < h1) | ((h2 == h1) & (l2 < l1))
        return jnp.where(take2, h2, h1), jnp.where(take2, l2, l1)

    pows = {1: (hi, lo)}
    m = 1
    while 2 * m <= w:
        h, l = pows[m]
        pows[2 * m] = combine(
            h, l, _shift_tail(h, m, fill), _shift_tail(l, m, fill)
        )
        m *= 2
    half = m
    h, l = pows[half]
    off = w - half
    return combine(h, l, _shift_tail(h, off, fill), _shift_tail(l, off, fill))


def _sliding_argmin2(
    hi: jax.Array, lo: jax.Array, w: int, fill
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(min hi, min lo, GLOBAL position of the leftmost min) per w-window
    under lexicographic (hi, lo, pos) order — the pair-key twin of
    _sliding_argmin."""
    L = hi.shape[-1]
    pos0 = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32), hi.shape)

    def combine(h1, l1, p1, h2, l2, p2):
        take2 = (
            (h2 < h1)
            | ((h2 == h1) & (l2 < l1))
            | ((h2 == h1) & (l2 == l1) & (p2 < p1))
        )
        return (
            jnp.where(take2, h2, h1),
            jnp.where(take2, l2, l1),
            jnp.where(take2, p2, p1),
        )

    pows = {1: (hi, lo, pos0)}
    m = 1
    big = jnp.int32(2**30)
    while 2 * m <= w:
        h, l, p = pows[m]
        pows[2 * m] = combine(
            h, l, p,
            _shift_tail(h, m, fill), _shift_tail(l, m, fill),
            _shift_tail(p, m, big),
        )
        m *= 2
    half = m
    h, l, p = pows[half]
    off = w - half
    return combine(
        h, l, p,
        _shift_tail(h, off, fill), _shift_tail(l, off, fill),
        _shift_tail(p, off, big),
    )


@partial(jax.jit, static_argnames=("k", "w", "canonical"))
def minimizer_positions64(
    words: jax.Array,
    lengths: jax.Array,
    k: int,
    w: int,
    canonical: bool = False,
    base_valid=None,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """minimizer_positions for the large-k regime (keys as (lo, hi) u32
    pairs, 16 <= k <= 31 — the all-T 32-mer collides with the sentinel):
    (lo, hi, positions, valid). Semantics mirror minimizer_positions
    exactly, including base_valid masking."""
    assert 1 <= k <= 31, "minimizer keys must leave sentinel headroom"
    lo, hi, valid_k = _window_keys(words, lengths, k, canonical, base_valid)
    sent = jnp.uint32(0xFFFFFFFF)
    lo = jnp.where(valid_k, lo, sent)
    hi = jnp.where(valid_k, hi, sent)
    hi_m, lo_m, pos = _sliding_argmin2(hi, lo, w, sent)
    L = lo.shape[-1]
    p_idx = jnp.arange(L, dtype=jnp.int32)
    valid = p_idx <= (jnp.asarray(lengths, jnp.int32)[..., None] - (k + w - 1))
    valid = valid & ((hi_m != sent) | (lo_m != sent))
    return (
        jnp.where(valid, lo_m, sent),
        jnp.where(valid, hi_m, sent),
        jnp.where(valid, pos, -1),
        valid,
    )


@partial(jax.jit, static_argnames=("k", "w", "canonical"))
def minimizers64(
    words: jax.Array,
    lengths: jax.Array,
    k: int,
    w: int,
    canonical: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(w,k)-minimizers for the large-k regime (16 <= k <= 31): 64-bit
    keys carried as (lo, hi) u32 pairs, lexicographic (hi, lo) window
    minima. Returns (lo [..., L], hi [..., L], valid [..., L]); invalid
    slots carry the all-ones sentinel in both halves. k caps at 31: the
    all-T 32-mer equals the sentinel pair and would vanish from windows.
    """
    assert 1 <= k <= 31, "minimizer keys must leave sentinel headroom"
    lo, hi, valid_k = _window_keys(words, lengths, k, canonical)
    sent = jnp.uint32(0xFFFFFFFF)
    lo = jnp.where(valid_k, lo, sent)
    hi = jnp.where(valid_k, hi, sent)
    hi_m, lo_m = _sliding_min2(hi, lo, w, sent)
    L = lo.shape[-1]
    pos = jnp.arange(L, dtype=jnp.int32)
    valid = pos <= (jnp.asarray(lengths, jnp.int32)[..., None] - (k + w - 1))
    valid = valid & ((hi_m != sent) | (lo_m != sent))
    return (
        jnp.where(valid, lo_m, sent),
        jnp.where(valid, hi_m, sent),
        valid,
    )


@partial(jax.jit, static_argnames=("k", "w", "canonical"))
def minimizer_sketch64(
    words: jax.Array,
    lengths: jax.Array,
    k: int,
    w: int,
    canonical: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """minimizer_sketch for 16 <= k <= 31 (Mash's default k=21 lives
    here): distinct minimizer keys as sorted (lo, hi) u32 pairs.

    Returns (lo [N], hi [N], n_unique): entries [0, n_unique) are the
    distinct keys ascending by (hi, lo); the tail is all-ones sentinel
    padding. Compare with sketch_jaccard64 / sketch_containment64.

    k <= 31 keeps the all-T key below the sentinel (4^31 - 1 < 2^64 - 1).
    """
    assert 1 <= k <= 31, "sketch keys must leave sentinel headroom (k <= 31)"
    lo_m, hi_m, _ = minimizers64(words, lengths, k, w, canonical)
    sent = jnp.uint32(0xFFFFFFFF)
    hi_s, lo_s = jax.lax.sort(
        (hi_m.reshape(-1), lo_m.reshape(-1)), num_keys=2
    )
    first = jnp.concatenate(
        [jnp.ones((1,), bool), (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])]
    )
    live = first & ((hi_s != sent) | (lo_s != sent))
    hi_c, lo_c = jax.lax.sort(
        (jnp.where(live, hi_s, sent), jnp.where(live, lo_s, sent)), num_keys=2
    )
    return lo_c, hi_c, jnp.sum(live.astype(jnp.int32))


def _sketch_overlap64(a_lo, a_hi, b_lo, b_hi):
    """(intersection, union) of two sorted-distinct 64-bit sketches —
    the pair-keyed twin of _sketch_overlap."""
    sent = jnp.uint32(0xFFFFFFFF)
    hi, lo = jax.lax.sort(
        (jnp.concatenate([a_hi, b_hi]), jnp.concatenate([a_lo, b_lo])),
        num_keys=2,
    )
    first = jnp.concatenate(
        [jnp.ones((1,), bool), (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])]
    )
    counts = _run_start_counts(first)
    live = first & ((hi != sent) | (lo != sent))
    inter = jnp.sum((live & (counts == 2)).astype(jnp.int32))
    union = jnp.sum(live.astype(jnp.int32))
    return inter, union


@jax.jit
def sketch_jaccard64(a_lo, a_hi, b_lo, b_hi) -> jax.Array:
    """Jaccard similarity of two minimizer_sketch64 outputs."""
    inter, union = _sketch_overlap64(a_lo, a_hi, b_lo, b_hi)
    return jnp.where(
        union > 0, inter.astype(jnp.float32) / jnp.maximum(union, 1), 0.0
    )


@jax.jit
def sketch_containment64(a_lo, a_hi, b_lo, b_hi) -> jax.Array:
    """Containment |A n B| / |A| of 64-bit sketch A within B."""
    inter, _ = _sketch_overlap64(a_lo, a_hi, b_lo, b_hi)
    sent = jnp.uint32(0xFFFFFFFF)
    n_a = jnp.sum(((a_hi != sent) | (a_lo != sent)).astype(jnp.int32))
    return jnp.where(
        n_a > 0, inter.astype(jnp.float32) / jnp.maximum(n_a, 1), 0.0
    )


@jax.jit
def minimizer_sketch_mask(positions: jax.Array, valid: jax.Array) -> jax.Array:
    """Select one window per distinct minimizer occurrence: True where a
    window's minimizer position differs from the previous valid window's
    (the standard minimizer-sketch construction — each selected index is a
    seed anchor). positions/valid from minimizer_positions."""
    prev = jnp.concatenate(
        [jnp.full_like(positions[..., :1], -2), positions[..., :-1]], axis=-1
    )
    return valid & (positions != prev)
