"""K-mer table lookup: per-window counts of query k-mers in a counted list.

The downstream half of every counting workflow — read screening /
contamination checks (does this read's k-mer content appear in the
reference?), spectrum-based weak-k-mer trimming (Lighter/BFC-style), and
abundance annotation. The reference stops at the HashMap itself
(/root/reference/README.md:164-180, counts queried by `map[&kmer]`); here
the lookup is a device op over the counted-list layout the counting
engines emit (count_kmers_sorted / count_kmers_runs / merge_sorted_runs).

Formulation (no scatter, no gather, docs/DESIGN.md §7): one sort groups table + query rows by key, a
segment-sum broadcast hands every row its segment's table count, and a
second sort on the carried original index un-permutes the answers. The
segment total is order-independent (query rows carry value 0, the table
contributes the single positive count per key segment), so no tag ordering
tricks are needed, and duplicate query keys — the common case: every
window of a read — all receive the same answer. Segment totals come from
the cumsum + boundary-masked reverse-cummin/forward-cummax scans
(docs/DESIGN.md §6-7, ~450-590 Mel/s) rather than segment scatters.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# numpy scalars, NOT jnp: module-level jnp constants initialize the XLA
# backend at import time, which breaks jax.distributed.initialize ordering
_SENT = np.uint32(0xFFFFFFFF)
_BIG = np.int32(2**31 - 1)


@jax.jit
def lookup_counts(
    q_lo: jax.Array,
    q_hi: jax.Array,
    q_valid: jax.Array,
    t_lo: jax.Array,
    t_hi: jax.Array,
    t_ct: jax.Array,
) -> jax.Array:
    """Per-query table counts: out[i] = table count of query key i (0 when
    absent or q_valid[i] is False).

    q_lo/q_hi: [Nq] uint32 packed query keys (reference as_2bit values,
      lo = bits [0,32), hi = bits [32,64)).
    q_valid: [Nq] bool; invalid rows answer 0 regardless of key bits.
    t_lo/t_hi/t_ct: counted list — rows with t_ct > 0 are the distinct
      table keys (count_kmers_sorted / count_kmers_runs / merge_sorted_runs
      layouts all qualify; run-start zeros and sentinel padding are
      ignored). Should a key appear in several positive rows their counts
      sum, matching merge_sorted_runs semantics.

    Total table count must stay below 2^31 (int32 prefix sums; the
    counting engines share the same bound).
    """
    q_lo, q_hi = jnp.asarray(q_lo, jnp.uint32), jnp.asarray(q_hi, jnp.uint32)
    q_valid = jnp.asarray(q_valid, bool)
    t_ct = jnp.asarray(t_ct, jnp.int32)
    Nq = q_lo.shape[0]

    dead = t_ct <= 0
    lo = jnp.concatenate([jnp.where(dead, _SENT, t_lo), q_lo])
    hi = jnp.concatenate([jnp.where(dead, _SENT, t_hi), q_hi])
    val = jnp.concatenate([jnp.where(dead, 0, t_ct), jnp.zeros(Nq, jnp.int32)])
    idx = jnp.concatenate(
        [
            jnp.full(t_ct.shape[0], Nq, jnp.int32),  # table rows unsort last
            jnp.arange(Nq, dtype=jnp.int32),
        ]
    )

    hi_s, lo_s, val_s, idx_s = jax.lax.sort((hi, lo, val, idx), num_keys=2)

    first = jnp.concatenate(
        [jnp.ones((1,), bool), (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1])]
    )
    incl = jnp.cumsum(val_s)
    total = incl[-1]
    S = incl - val_s  # exclusive prefix sum, nondecreasing
    # S at the first boundary AFTER i (reverse cummin over boundary-masked S)
    nb = jnp.flip(jax.lax.cummin(jnp.flip(jnp.where(first, S, _BIG))))
    nb_excl = jnp.minimum(
        jnp.concatenate([nb[1:], jnp.full((1,), _BIG, jnp.int32)]), total
    )
    # S at the last boundary AT OR BEFORE i (cummax works: S >= 0 ascending)
    sb = jax.lax.cummax(jnp.where(first, S, jnp.int32(-1)))
    seg_total = nb_excl - sb  # every row: its key segment's table count

    idx_u, ans_u = jax.lax.sort((idx_s, seg_total), num_keys=1)
    return jnp.where(q_valid, ans_u[:Nq], 0)


@partial(jax.jit, static_argnames=("k", "canonical"))
def kmer_hits_reads(
    words: jax.Array,
    lengths: jax.Array,
    k: int,
    t_lo: jax.Array,
    t_hi: jax.Array,
    t_ct: jax.Array,
    canonical: bool = False,
    base_valid=None,
) -> Tuple[jax.Array, jax.Array]:
    """Table count of every k-mer window of a packed read batch.

    Returns (counts [B, L] int32, valid [B, L] bool): counts[b, p] is the
    table count of read b's window starting at base p (0 at invalid /
    out-of-range windows). Window keys and validity follow the counting
    engines exactly (ops.kmer._window_keys), so screening agrees
    base-for-base with what count_kmers_* would have counted.
    """
    from .kmer import _window_keys

    lo, hi, valid = _window_keys(words, lengths, k, canonical, base_valid)
    ans = lookup_counts(
        lo.reshape(-1), hi.reshape(-1), valid.reshape(-1), t_lo, t_hi, t_ct
    )
    return ans.reshape(lo.shape), valid


@partial(jax.jit, static_argnames=("k", "canonical", "min_count"))
def screen_reads(
    words: jax.Array,
    lengths: jax.Array,
    k: int,
    t_lo: jax.Array,
    t_hi: jax.Array,
    t_ct: jax.Array,
    min_count: int = 1,
    canonical: bool = False,
    base_valid=None,
) -> Tuple[jax.Array, jax.Array]:
    """Per-read containment vs a counted k-mer table (Mash Screen-style).

    Returns (n_windows [B] int32, n_solid [B] int32): valid window count
    and how many of those have table count >= min_count. The containment
    fraction n_solid / n_windows is the host-side division (callers decide
    the 0-window convention).
    """
    counts, valid = kmer_hits_reads(
        words, lengths, k, t_lo, t_hi, t_ct,
        canonical=canonical, base_valid=base_valid,
    )
    n_windows = jnp.sum(valid.astype(jnp.int32), axis=-1)
    n_solid = jnp.sum(
        (valid & (counts >= min_count)).astype(jnp.int32), axis=-1
    )
    return n_windows, n_solid


@partial(jax.jit, static_argnames=("k", "min_count"))
def solid_prefix_len(
    counts: jax.Array,
    valid: jax.Array,
    lengths: jax.Array,
    k: int,
    min_count: int = 1,
) -> jax.Array:
    """Spectrum-trimming lengths: longest prefix of each read whose k-mer
    windows are all solid (table count >= min_count).

    counts/valid: [B, L] from kmer_hits_reads. Returns keep [B] int32:
      * no valid windows (len < k)      -> full length (nothing to judge)
      * first weak window at w == 0     -> 0 (no trusted prefix)
      * first weak window at w > 0      -> w + k - 1 bases (windows 0..w-1
                                           are solid; base w+k-1 is the
                                           first touched only by weak ones)
      * all windows solid               -> full length

    The Lighter/BFC trimming rule expressed as one masked argmin — no
    per-read python.
    """
    lengths = jnp.asarray(lengths, jnp.int32)
    weak = valid & (counts < min_count)
    L = counts.shape[-1]
    pos = jnp.arange(L, dtype=jnp.int32)
    first_weak = jnp.min(jnp.where(weak, pos, jnp.int32(L)), axis=-1)
    any_weak = jnp.any(weak, axis=-1)
    trimmed = jnp.where(first_weak > 0, first_weak + (k - 1), 0)
    return jnp.where(any_weak, jnp.minimum(trimmed, lengths), lengths)


def table_from_dense(hist) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Host adapter: dense 4^k histogram -> counted-list arrays
    (lo, hi, ct) of the nonzero bins, for feeding the lookup ops when the
    table came from the dense small-k engine."""
    h = np.asarray(hist)
    keys = np.nonzero(h)[0]
    return (
        jnp.asarray(keys & 0xFFFFFFFF, jnp.uint32),
        jnp.asarray(keys >> 32, jnp.uint32),
        jnp.asarray(np.minimum(h[keys], 2**31 - 1), jnp.int32),
    )


def table_from_dict(counts: dict) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Host adapter: {packed_key: count} (pipeline large-k layout) ->
    counted-list arrays (lo, hi, ct)."""
    keys = np.fromiter(counts.keys(), np.uint64, len(counts))
    vals = np.fromiter(counts.values(), np.int64, len(counts))
    return (
        jnp.asarray(keys & np.uint64(0xFFFFFFFF), jnp.uint32),
        jnp.asarray(keys >> np.uint64(32), jnp.uint32),
        jnp.asarray(np.minimum(vals, 2**31 - 1), jnp.int32),
    )
