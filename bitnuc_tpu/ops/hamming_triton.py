"""Batched Hamming scan on the GPU: a Pallas kernel through Triton.

The plain XLA path (ops.hamming.hdist_many_to_many) maps over the queries:
every query makes its own pass over the database and materialises a [D, W]
popcount array on the way. This kernel gives each program a [TQ, TD] block
of the [Q, D] distance matrix: it walks the W words of a word-major
database tile [W, TD] once, loading each word row along D (coalesced), and
serves all TQ queries of its block from that one read. The accumulator
lives in registers; only the int32 distances are written.

Per word pair, the 2-bit XOR diffs are collapsed to one bit per base (the
even bits) and the second word's bits are shifted onto the odd positions,
so one popcount serves two words. Per-word valid-base masks are Python ints
baked into the kernel (n_bases is static), which also drops words that lie
wholly past n_bases.

Semantics are ops.hamming.hdist_many_to_many's on the same data; the
reference is hdist per (query, entry) pair
(src/utils/functions/hamming/multi.rs:122-160).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# [TQ, TD] = [32, 128] with 4 warps measured fastest of the tiles tried on
# an H100 at Q=256 over 1e7 x 512 bases (PERF.md)
TILE_Q = 32  # queries per program (rows of the output block)
TILE_D = 128  # database entries per program (columns, coalesced loads)
NUM_WARPS = 4
NUM_STAGES = 2

_EVEN = 0x55555555


def word_masks(n_words: int, n_bases: int) -> tuple:
    """Per-word valid-bit masks as Python ints (the zero-padded last-word
    contract, src/utils/packing/naive.rs:39-42); 0 for words past n_bases."""
    out = []
    for w in range(n_words):
        v = min(max(int(n_bases) - 16 * w, 0), 16)
        out.append(0xFFFFFFFF if v == 16 else (1 << (2 * v)) - 1)
    return tuple(out)


def _make_kernel(masks: tuple, tq: int, td: int, n_db: int):
    live = [w for w, m in enumerate(masks) if m]

    def kernel(q_ref, db_ref, out_ref):
        i = pl.program_id(1)  # query block (fast axis: blocks share a tile)
        j = pl.program_id(0)  # database tile
        cols = j * td + jnp.arange(td, dtype=jnp.int32)
        in_db = cols < n_db

        def collapsed(w):
            q = q_ref[w, pl.ds(i * tq, tq)]  # [TQ]
            d = plgpu.load(
                db_ref.at[w, pl.ds(j * td, td)], mask=in_db, other=0
            )  # [TD]
            x = q[:, None] ^ d[None, :]
            if masks[w] != 0xFFFFFFFF:
                x = x & jnp.uint32(masks[w])
            return (x | (x >> 1)) & jnp.uint32(_EVEN)

        acc = jnp.zeros((tq, td), jnp.int32)
        for p in range(0, len(live), 2):
            bits = collapsed(live[p])
            if p + 1 < len(live):
                bits = bits | (collapsed(live[p + 1]) << 1)
            # popcount on int32: the Triton route lowers it to __nv_popc
            acc = acc + jax.lax.population_count(
                jax.lax.bitcast_convert_type(bits, jnp.int32)
            )
        plgpu.store(
            out_ref.at[pl.ds(i * tq, tq), pl.ds(j * td, td)],
            acc,
            mask=in_db[None, :],
        )

    return kernel


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@partial(
    jax.jit,
    static_argnames=(
        "n_bases", "tile_q", "tile_d", "num_warps", "num_stages", "interpret",
    ),
)
def hdist_scan_batch(
    queries: jax.Array,
    db_word_major: jax.Array,
    n_bases: int,
    *,
    tile_q: int = TILE_Q,
    tile_d: int = TILE_D,
    num_warps: int = NUM_WARPS,
    num_stages: int = NUM_STAGES,
    interpret: bool = False,
) -> jax.Array:
    """Distances from Q packed queries [Q, W] to a word-major database
    [W, D]: [Q, D] int32. n_bases is static (the per-word masks are baked
    into the kernel). Query blocks are padded to a power of two; the
    database is read in place, its ragged last tile masked."""
    Q, W = queries.shape
    W2, D = db_word_major.shape
    assert W == W2, (W, W2)
    tq = min(tile_q, _pow2_at_least(Q))
    Qp = -(-Q // tq) * tq
    # word-major queries: word w of a query block is one contiguous row
    q_wm = jnp.pad(jnp.transpose(queries), ((0, 0), (0, Qp - Q)))
    out = pl.pallas_call(
        _make_kernel(word_masks(W, n_bases), tq, tile_d, D),
        grid=(pl.cdiv(D, tile_d), Qp // tq),
        out_shape=jax.ShapeDtypeStruct((Qp, D), jnp.int32),
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name="hdist_scan_batch",
    )(q_wm, db_word_major)
    return out if Qp == Q else out[:Q]
