"""Exact-duplicate read detection over packed batches.

North-star surface (no reference analog — the reference is a codec crate,
src/lib.rs): PCR/optical duplicate marking is the standard first pass of
any read-processing pipeline, and the packed 2-bit domain makes it a pure
word-compare problem — no decode needed.

Formulation: a multi-key `lax.sort` over the word columns groups
identical reads into adjacent runs; run starts and lengths come from
adjacent-compare + the reverse-cummin run-length primitive
(ops.kmer._run_start_counts, scatter-free — docs/DESIGN.md §4), and results return to original read order with a
second sort keyed on the carried iota instead of a gather/scatter.
Within a duplicate group the stable sort keeps original
order, so the kept (count-carrying) occurrence is always the FIRST
appearance in the batch.

Zero-padding guarantees word-equality == sequence-equality: encode pads
tail words with code 0 beyond `lengths`, and `lengths` itself is the
leading sort key, so equal words + equal length <=> equal bases.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from .kmer import _run_start_counts


@jax.jit
def mark_duplicates(
    words: jax.Array, lengths: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """(keep [R] bool, counts [R] int32) in ORIGINAL read order.

    keep[i] is True iff read i is the first occurrence of its sequence;
    counts[i] is the total multiplicity of that sequence for kept reads and
    0 for duplicates (run-start layout over the batch axis). Sum of counts
    == R; sum of keep == number of distinct sequences.
    """
    R, W = words.shape
    if R == 0:
        return jnp.zeros((0,), bool), jnp.zeros((0,), jnp.int32)
    iota = jnp.arange(R, dtype=jnp.int32)
    operands = (
        jnp.asarray(lengths, jnp.int32),
        *(words[:, j] for j in range(W)),
        iota,
    )
    *skeys, perm = jax.lax.sort(operands, num_keys=W + 1, is_stable=True)
    same = skeys[0][1:] == skeys[0][:-1]
    for col in skeys[1:]:
        same = same & (col[1:] == col[:-1])
    first = jnp.concatenate([jnp.ones((1,), bool), ~same])
    counts_sorted = _run_start_counts(first)
    # back to original order: one more sort on the permutation (gather-free)
    _, keep, counts = jax.lax.sort(
        (perm, first.astype(jnp.int32), counts_sorted), num_keys=1
    )
    return keep.astype(bool), counts


def dedupe_reads(reads) -> Tuple[jax.Array, jax.Array]:
    """mark_duplicates over a PackedReads batch -> (keep, counts)."""
    return mark_duplicates(reads.words, reads.lengths)
