"""Packed-domain split / slice / random access, batched.

The reference's split_packed does a cross-word shift-with-carry loop
(src/utils/functions/split.rs:80-94) one word at a time; its slice decodes
per-base through get() (src/sequence.rs:198-212). Here the whole batch moves
at once: a vectorized funnel shift over uint32 lanes relocates any packed
substream to bit origin in O(W) gathers + shifts, with per-read dynamic
offsets.

Note on split semantics: the reference's right-shift carry propagates from the
wrong side for multi-word unaligned splits (latent bug, split.rs:83-94); we
implement the correct funnel (see oracle.split_packed for the full note).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..utils import bitops


@jax.jit
def shift_reads_down(words: jax.Array, n_bases: jax.Array) -> jax.Array:
    """Shift each read's packed stream toward the origin by n_bases bases.

    words: [..., W] uint32; n_bases: [...] int32 (>= 0). Returns [..., W]
    uint32 where base i of the output is base i + n_bases of the input;
    vacated high positions are zero. This is the batched funnel shift —
    the batched analog of split.rs:80-94's carry loop.
    """
    W = words.shape[-1]
    n = jnp.asarray(n_bases, jnp.int32)
    q = (n // bitops.BASES_PER_WORD)[..., None]  # word offset
    s = (2 * (n % bitops.BASES_PER_WORD))[..., None].astype(jnp.uint32)  # bits

    idx = jnp.arange(W, dtype=jnp.int32)
    i0 = idx + q
    i1 = i0 + 1

    def gather(i):
        g = jnp.take_along_axis(
            words, jnp.clip(i, 0, W - 1), axis=-1, mode="clip"
        )
        return jnp.where(i < W, g, jnp.uint32(0))

    src0, src1 = gather(i0), gather(i1)
    # s == 0 makes the (32 - s) shift UB; select instead.
    funnel = (src0 >> s) | jnp.where(
        s == 0, jnp.uint32(0), src1 << (jnp.uint32(32) - s)
    )
    return jnp.where(s == 0, src0, funnel)


@jax.jit
def split_reads(
    words: jax.Array, lengths: jax.Array, idx: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Split each packed read at base idx (scalar or per-read array).

    Returns (left, right) word arrays of the same [..., W] shape:
    left keeps bases [0, idx) in place (zero past idx); right holds bases
    [idx, length) relocated to origin. Decoding left with idx bases and right
    with length-idx bases reproduces the two halves (split.rs contract).
    """
    W = words.shape[-1]
    lengths = jnp.asarray(lengths, jnp.int32)
    idx = jnp.broadcast_to(jnp.asarray(idx, jnp.int32), lengths.shape)
    left = words & bitops.word_valid_mask(W, idx)
    right = shift_reads_down(words, idx) & bitops.word_valid_mask(
        W, jnp.maximum(lengths - idx, 0)
    )
    return left, right


@jax.jit
def slice_reads(
    words: jax.Array, lengths: jax.Array, start: jax.Array, size: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Extract bases [start, start+size) of each read as packed words at
    origin. start/size may be scalars or per-read arrays. Returns
    (sliced_words [..., W], out_lengths [...]) where out_lengths is
    clip(min(size, length-start), 0) — the batched analog of
    src/sequence.rs:198-212 without the per-base decode.
    """
    W = words.shape[-1]
    lengths = jnp.asarray(lengths, jnp.int32)
    start = jnp.broadcast_to(jnp.asarray(start, jnp.int32), lengths.shape)
    size = jnp.broadcast_to(jnp.asarray(size, jnp.int32), lengths.shape)
    out_len = jnp.clip(jnp.minimum(size, lengths - start), 0)
    shifted = shift_reads_down(words, start)
    return shifted & bitops.word_valid_mask(W, out_len), out_len


@jax.jit
def get_reads(words: jax.Array, lengths: jax.Array, index: jax.Array) -> jax.Array:
    """ASCII byte of base `index` in each read (src/sequence.rs:116-135
    batched). Out-of-range indices return 0; host wrappers raise
    IndexOutOfBounds."""
    lengths = jnp.asarray(lengths, jnp.int32)
    index = jnp.broadcast_to(jnp.asarray(index, jnp.int32), lengths.shape)
    word_idx = (index // bitops.BASES_PER_WORD)[..., None]
    w = jnp.take_along_axis(words, jnp.clip(word_idx, 0, words.shape[-1] - 1), axis=-1)
    shift = (2 * (index % bitops.BASES_PER_WORD)).astype(jnp.uint32)
    code = (w[..., 0] >> shift) & jnp.uint32(3)
    ascii_b = bitops.code_to_ascii(code)
    return jnp.where(index < lengths, ascii_b, jnp.uint8(0))
