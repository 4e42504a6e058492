"""Batched encode/decode between ASCII nucleotides and packed 2-bit words.

This is the batched analog of the reference's codec tier
(encode: src/utils/mod.rs:22, decode: src/utils/mod.rs:60, single-word
as_2bit/from_2bit: src/utils/packing/mod.rs:81 / src/utils/unpacking/mod.rs:119).
Where the reference packs one sequence per call with the caller looping, we
pack [batch, length] arrays of reads in one jitted call — per-call dispatch is
the enemy on an accelerator.

Error semantics: device code cannot raise, so encode returns a per-read
``first_bad`` index (-1 = valid). Host wrappers (bitnuc_tpu/api.py) translate
that into the reference's typed errors (InvalidBase, src/error.rs:5).

Outputs are bit-exact with the reference: viewing each read's uint32 word pairs
as little-endian u64 reproduces the reference word stream, including the
zero-padded final word (src/utils/packing/naive.rs:39-42).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..utils import bitops


def _pad_minor(x: jax.Array, target: int) -> jax.Array:
    """Zero-pad the last axis to `target` columns."""
    L = x.shape[-1]
    if L == target:
        return x
    assert L < target
    pad = [(0, 0)] * (x.ndim - 1) + [(0, target - L)]
    return jnp.pad(x, pad)


def _tree_fold(parts, op):
    """Balanced binary fold — shallow dependency chains on the VPU."""
    while len(parts) > 1:
        parts = [
            op(parts[i], parts[i + 1]) if i + 1 < len(parts) else parts[i]
            for i in range(0, len(parts), 2)
        ]
    return parts[0]


@partial(jax.jit, static_argnames=("n_words",))
def encode_reads_xla(
    ascii_u8: jax.Array,
    lengths: jax.Array,
    n_words: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Pure-XLA encode of a batch of reads.

    Args:
      ascii_u8: [..., L] uint8 ASCII bases, padded arbitrarily past each
        read's length (padding bytes are ignored).
      lengths: [...] int32 per-read base counts (<= L).
      n_words: output words per read; defaults to the u64-pair-padded count
        for L. Must be even so the u64 view is exact.

    Returns:
      words: [..., n_words] uint32, bit-exact reference layout.
      first_bad: [...] int32 index of the first invalid base, or -1.

    Formulation: 16 strided byte-lane slices a[..., j::16], each SWAR-coded
    and OR-folded into its 2-bit position. first_bad via ONE single-value
    max reduce per lane-tree instead of argmax/any (variadic reduces):
    encoding the leftmost invalid position as max(Lp - pos) keeps
    validation nearly free (docs/DESIGN.md §5).
    """
    L = ascii_u8.shape[-1]
    W = bitops.n_words_for(L) if n_words is None else int(n_words)
    assert W % 2 == 0, "word count must pair into u64s"
    lengths = lengths.astype(jnp.int32)
    Lp = W * bitops.BASES_PER_WORD
    a = _pad_minor(ascii_u8, Lp)
    lens = lengths[..., None]

    shifted = []
    bad_enc = []
    for j in range(bitops.BASES_PER_WORD):
        s = a[..., j::16]  # [..., W] byte lane j of every word
        pos = jnp.arange(W, dtype=jnp.int32) * 16 + j
        in_range = pos < lens
        shifted.append(bitops.ascii_to_code(s) << jnp.uint32(2 * j))
        invalid = ~bitops.ascii_is_valid(s) & in_range
        bad_enc.append(jnp.where(invalid, Lp - pos, 0))
    # out-of-range garbage codes cleared by ONE final word mask instead of
    # 16 per-lane wheres
    words = _tree_fold(shifted, jnp.bitwise_or) & bitops.word_valid_mask(
        W, lengths
    )
    enc = jnp.max(_tree_fold(bad_enc, jnp.maximum), axis=-1)
    first_bad = jnp.where(enc > 0, Lp - enc, -1).astype(jnp.int32)
    return words, first_bad


@partial(jax.jit, static_argnames=("max_len",))
def decode_reads_xla(
    words: jax.Array,
    lengths: jax.Array,
    max_len: Optional[int] = None,
) -> jax.Array:
    """Pure-XLA decode: [..., W] uint32 words -> [..., max_len] uint8 ASCII.

    Positions past each read's length are 0. Mirrors from_2bit_multi
    (src/utils/unpacking/mod.rs:10-48) batched.
    """
    W = words.shape[-1]
    L = W * bitops.BASES_PER_WORD if max_len is None else int(max_len)
    lengths = lengths.astype(jnp.int32)

    codes = bitops.unpack_words(words)[..., :L]
    ascii_out = bitops.code_to_ascii(codes)
    cap = codes.shape[-1]
    if L > cap:  # max_len beyond word capacity zero-pads (Pallas twin parity)
        pad = [(0, 0)] * (ascii_out.ndim - 1) + [(0, L - cap)]
        ascii_out = jnp.pad(ascii_out, pad)
    pos = jnp.arange(L, dtype=jnp.int32)
    return jnp.where(pos < lengths[..., None], ascii_out, jnp.uint8(0))


def encode_reads(
    ascii_u8: jax.Array,
    lengths: jax.Array,
    n_words: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Batched encode: the fused XLA lowering (encode_reads_xla). This
    elementwise, memory-bound op needs no hand-written kernel."""
    return encode_reads_xla(ascii_u8, lengths, n_words)


def decode_reads(
    words: jax.Array,
    lengths: jax.Array,
    max_len: Optional[int] = None,
) -> jax.Array:
    """Batched decode: the fused XLA lowering (decode_reads_xla)."""
    return decode_reads_xla(words, lengths, max_len)


@jax.jit
def validity_mask(ascii_u8: jax.Array, lengths: jax.Array) -> jax.Array:
    """[..., L] bool: True where the byte is an in-range ACGT/acgt base.

    Pair with count_kmers_reads(base_valid=...) to DROP windows containing
    N/ambiguous bases instead of raising — the reference can only refuse
    the whole sequence (InvalidBase, src/error.rs:5); a streaming engine
    needs the skip policy."""
    L = ascii_u8.shape[-1]
    pos = jnp.arange(L, dtype=jnp.int32)
    in_range = pos < jnp.asarray(lengths, jnp.int32)[..., None]
    return in_range & bitops.ascii_is_valid(ascii_u8)


@jax.jit
def pack_kmers(ascii_u8: jax.Array, lengths: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Batched as_2bit (src/utils/packing/mod.rs:81): [..., k<=32] ASCII ->
    [..., 2] uint32 (one u64 pair per k-mer) + first_bad."""
    assert ascii_u8.shape[-1] <= 32
    return encode_reads_xla(ascii_u8, lengths, n_words=2)


@partial(jax.jit, static_argnames=("max_len",))
def unpack_kmers(words: jax.Array, lengths: jax.Array, max_len: int = 32) -> jax.Array:
    """Batched from_2bit (src/utils/unpacking/mod.rs:119)."""
    return decode_reads_xla(words, lengths, max_len)
