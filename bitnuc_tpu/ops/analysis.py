"""Sequence analytics computed directly on packed words.

The reference decodes to ASCII first and counts bytes
(src/utils/analysis.rs:8-16, :23-39 — via to_vec -> per-base get). We compute
the same results 16 bases per lane without decoding, using three popcounts:

  lo = word & 0x5555...   (low bit of each 2-bit group)
  hi = (word >> 1) & 0x5555...
  T = popcount(lo & hi); C = popcount(lo) - T; G = popcount(hi) - T
  A = length - C - G - T

since A=00, C=01, G=10, T=11 (src/utils/packing/naive.rs:10-15).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from ..utils import bitops


@jax.jit
def base_counts_reads(words: jax.Array, lengths: jax.Array) -> jax.Array:
    """Counts of A,C,G,T per read: [..., W] uint32 -> [..., 4] int32.

    Bit-identical to the reference's decoded byte counts
    (src/utils/analysis.rs:23-39).
    """
    W = words.shape[-1]
    lengths = jnp.asarray(lengths, jnp.int32)
    valid = bitops.word_valid_mask(W, lengths)
    lo = words & bitops.LOWER_BITS_32 & valid
    hi = (words >> 1) & bitops.LOWER_BITS_32 & valid

    t = jnp.sum(bitops.popcount32(lo & hi), axis=-1)
    c = jnp.sum(bitops.popcount32(lo), axis=-1) - t
    g = jnp.sum(bitops.popcount32(hi), axis=-1) - t
    a = lengths - c - g - t
    return jnp.stack([a, c, g, t], axis=-1)


@jax.jit
def gc_content_reads(words: jax.Array, lengths: jax.Array) -> jax.Array:
    """GC percentage (0-100) per read; 0.0 for empty reads
    (src/utils/analysis.rs:8-16). float32 on device (the host PackedSequence
    path keeps the reference's f64)."""
    counts = base_counts_reads(words, lengths)
    lengths = jnp.asarray(lengths, jnp.int32)
    gc = (counts[..., 1] + counts[..., 2]).astype(jnp.float32)
    denom = jnp.maximum(lengths, 1).astype(jnp.float32)
    return jnp.where(lengths > 0, gc / denom * 100.0, 0.0)


@partial(jax.jit, static_argnames=("window", "step"))
def windowed_gc(
    words: jax.Array,
    lengths: jax.Array,
    window: int,
    step: int = 0,
) -> Tuple[jax.Array, jax.Array]:
    """Sliding-window GC percentage over packed reads/contigs — the genome-
    browser GC track. Returns (gc_pct f32 [..., NW], valid bool [..., NW])
    where NW = (16W - window)//step + 1 and valid marks windows fully
    inside each sequence (start + window <= length). step=0 means
    non-overlapping (step = window).

    Packed-domain formulation: the GC bit of each 2-bit code is lo XOR hi
    (C=01, G=10 vs A=00, T=11), expanded 16 bases/word, prefix-summed once,
    and window sums read as two strided slices of the cumsum — no gather
    (docs/DESIGN.md). Extends the reference's whole-sequence gc_content
    (src/utils/analysis.rs:8-16) to positional tracks.
    """
    step = step or window
    assert window >= 1 and step >= 1
    W = words.shape[-1]
    L = 16 * W
    assert window <= L, f"window {window} exceeds capacity {L}"
    lengths = jnp.asarray(lengths, jnp.int32)
    shifts = (jnp.arange(16, dtype=jnp.uint32) * 2)[None, :]
    codes = (words[..., :, None] >> shifts) & jnp.uint32(3)
    codes = codes.reshape(*words.shape[:-1], L)
    lo = (codes & 1).astype(jnp.int32)
    hi = ((codes >> 1) & 1).astype(jnp.int32)
    gc = lo ^ hi
    pos = jnp.arange(L, dtype=jnp.int32)
    gc = jnp.where(pos < lengths[..., None], gc, 0)
    c = jnp.cumsum(gc, axis=-1)
    zero = jnp.zeros((*c.shape[:-1], 1), c.dtype)
    c = jnp.concatenate([zero, c], axis=-1)  # c[p] = gc bases in [0, p)
    nw = (L - window) // step + 1
    lo_s = jax.lax.slice_in_dim(c, 0, (nw - 1) * step + 1, step, axis=-1)
    hi_s = jax.lax.slice_in_dim(
        c, window, window + (nw - 1) * step + 1, step, axis=-1
    )
    sums = hi_s - lo_s
    starts = jnp.arange(nw, dtype=jnp.int32) * step
    valid = (starts + window) <= lengths[..., None]
    pct = jnp.where(valid, sums.astype(jnp.float32) * (100.0 / window), 0.0)
    return pct, valid
