"""Low-level bit utilities shared by the XLA and Pallas paths.

Device words are uint32 (accelerator vector units are 32-bit-lane
hardware). One reference u64 word (32 bases,
src/utils/packing/naive.rs:17) is represented as two consecutive
little-endian uint32 lanes: lane 2j holds bases [32j, 32j+16), lane 2j+1
holds bases [32j+16, 32j+32). The bitstreams are identical, so all
packed-domain math (XOR, masks, funnel shifts) carries over unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

BASES_PER_WORD = 16  # per uint32 lane
WORDS_PER_U64 = 2

# numpy scalar, NOT jnp: a module-level jnp constant would initialize the XLA
# backend at import time, breaking the jax.distributed init ordering contract
# (parallel/runtime.py; regression-tested by tests/test_runtime.py)
LOWER_BITS_32 = np.uint32(0x55555555)

# ASCII decode LUT order matches the 2-bit code map A=00 C=01 G=10 T=11
ASCII_A, ASCII_C, ASCII_G, ASCII_T = 65, 67, 71, 84


def n_words_for(n_bases: int) -> int:
    """uint32 word count for n bases, padded to whole u64 pairs so the
    device array views exactly as the reference u64 layout."""
    return 2 * (-(-int(n_bases) // 32))


def ascii_to_code(ascii_u8: jax.Array) -> jax.Array:
    """Branch-free ASCII->2bit: ((b>>1) ^ (b>>2)) & 3.

    This arithmetic identity (used by the reference's NEON path,
    src/utils/packing/aarch64.rs:136-138) maps A/a->0, C/c->1, G/g->2,
    T/t->3 and is case-insensitive for ACGT bytes. Garbage for other bytes —
    pair with ascii_is_valid.
    """
    b = ascii_u8.astype(jnp.uint32)
    return ((b >> 1) ^ (b >> 2)) & 3


def ascii_is_valid(ascii_u8: jax.Array) -> jax.Array:
    """True where the byte is one of ACGTacgt (reference validity contract,
    src/utils/packing/naive.rs:10-15; lowercase trick aarch64.rs:156-164)."""
    lower = ascii_u8 | jnp.uint8(0x20)
    return (
        (lower == jnp.uint8(ord("a")))
        | (lower == jnp.uint8(ord("c")))
        | (lower == jnp.uint8(ord("g")))
        | (lower == jnp.uint8(ord("t")))
    )


def code_to_ascii(codes: jax.Array) -> jax.Array:
    """2-bit code -> uppercase ASCII via a 3-select chain (VPU-friendly,
    no gather). Matches src/utils/unpacking/naive.rs:14-19."""
    c = codes.astype(jnp.int32)
    out = jnp.where(
        c == 0,
        ASCII_A,
        jnp.where(c == 1, ASCII_C, jnp.where(c == 2, ASCII_G, ASCII_T)),
    )
    return out.astype(jnp.uint8)


def pack_codes(codes: jax.Array) -> jax.Array:
    """Pack 2-bit codes into uint32 words, 16 per word, LSB-first.

    codes: [..., L] integer array with values in [0,4); L must be a multiple
    of 16. Returns [..., L//16] uint32.
    """
    *lead, L = codes.shape
    assert L % BASES_PER_WORD == 0, L
    c = codes.astype(jnp.uint32).reshape(*lead, L // BASES_PER_WORD, BASES_PER_WORD)
    shifts = (2 * jnp.arange(BASES_PER_WORD, dtype=jnp.uint32)).reshape(
        (1,) * (c.ndim - 1) + (BASES_PER_WORD,)
    )
    return jnp.sum(c << shifts, axis=-1).astype(jnp.uint32)


def unpack_words(words: jax.Array) -> jax.Array:
    """Inverse of pack_codes: [..., W] uint32 -> [..., W*16] 2-bit codes
    (uint8), LSB-first per word."""
    *lead, W = words.shape
    w = words.reshape(*lead, W, 1)
    shifts = (2 * jnp.arange(BASES_PER_WORD, dtype=jnp.uint32)).reshape(
        (1,) * (w.ndim - 1) + (BASES_PER_WORD,)
    )
    codes = (w >> shifts) & jnp.uint32(3)
    return codes.reshape(*lead, W * BASES_PER_WORD).astype(jnp.uint8)


def word_valid_mask(W: int, lengths: jax.Array) -> jax.Array:
    """Per-word uint32 masks selecting only in-range base bits.

    lengths: [...] base counts. Returns [..., W] uint32 where word j has its
    low 2*clamp(len-16j, 0, 16) bits set (the zero-padded last-word contract,
    src/utils/packing/naive.rs:39-42).
    """
    word_idx = jnp.arange(W, dtype=jnp.int32)
    valid = jnp.clip(lengths[..., None] - 16 * word_idx, 0, 16).astype(jnp.uint32)
    # (1 << 2v) - 1 with v in [0,16]: shift of 32 is UB, so build from v==16.
    full = valid == 16
    mask = (jnp.uint32(1) << (2 * jnp.where(full, 0, valid))) - jnp.uint32(1)
    return jnp.where(full, jnp.uint32(0xFFFFFFFF), mask)


def popcount32(x: jax.Array) -> jax.Array:
    """Population count on uint32 lanes via lax.population_count."""
    return jax.lax.population_count(x.astype(jnp.uint32)).astype(jnp.int32)


def basewise_diff(x: jax.Array, y: jax.Array) -> jax.Array:
    """Collapse a 2-bit XOR diff to one bit per base (low bit of each pair),
    the reference's lower|upper>>1 trick (hamming/scalar.rs:40-44)."""
    d = x ^ y
    return (d | (d >> 1)) & LOWER_BITS_32


def words_u32_to_u64_np(words_u32: np.ndarray) -> np.ndarray:
    """Host-side view of device uint32 lanes as reference u64 words."""
    a = np.ascontiguousarray(np.asarray(words_u32, dtype=np.uint32))
    assert a.shape[-1] % 2 == 0
    return a.view(np.uint64)


def words_u64_to_u32_np(words_u64: np.ndarray) -> np.ndarray:
    """Host-side inverse: reference u64 words -> device uint32 lanes."""
    return np.ascontiguousarray(np.asarray(words_u64, dtype=np.uint64)).view(
        np.uint32
    )
