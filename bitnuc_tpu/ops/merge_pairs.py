"""Paired-end overlap merging (PEAR/FLASH-class) on packed reads.

A sequenced fragment shorter than the two read lengths combined leaves
R1's tail overlapping rc(R2)'s head; merging recovers the full fragment.
The reference library has no pairing concept (north-star toolkit
surface; its closest primitive is the fixed-frame hdist,
/root/reference/src/utils/functions/hamming/multi.rs).

Formulation: the offset search is a `lax.scan` over the STATIC range
of candidate overlaps — each step shifts the rc(R2) code plane with one
`dynamic_slice` of a padded array and does a masked elementwise compare
plus a row reduce, so the whole search compiles to a fixed-shape loop
with no data-dependent control flow (the gapless sibling of the
alignment wavefront, ops/align.py). Winner selection is masked
single-value updates (fewest mismatches, ties to the LONGEST overlap).
Fragment construction uses one bounded take_along_axis per batch
(docs/DESIGN.md §2's gather budget: B x L_frag elements).

Offset convention: o = fragment_length - len2 is rc(R2)'s start within
the fragment, searched over [0, L1 - min_overlap] (tail overlaps;
read-through cases with o < 0 need adapter awareness — out of scope).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import revcomp as revcomp_ops
from ..utils import bitops

_BIG = np.int32(2**30)


def _packed_offset_scan(words1, lens1, rc2w, lens2, min_overlap, mmf):
    """(best_mm, best_o, best_ov) of the offset search in the PACKED domain.

    The unpacked scan re-reads two [B, L] i32 code planes per offset
    (~20 MB/step at B=16k, L=150 of redundant traffic). Here each step reads two [B, W1] u32
    planes (16 bases/word, ~7x less): rc(R2) and its validity mask are
    pre-shifted by r = 0..15 bases ONCE (funnel shifts, the split_packed
    machinery), a step at offset o = 16q + r takes one word-granular
    dynamic_slice of the r-th copy, and mismatches are XOR + 2-bit
    collapse + popcount (reference hamming/scalar.rs:40-44 trick at batch
    scale). Overlap counts come analytically from the length vectors.
    Bit-exact with the code-plane scan by construction (same o order,
    same strict-< winner rule)."""
    B, W1 = words1.shape
    W2 = rc2w.shape[-1]
    L1 = W1 * bitops.BASES_PER_WORD
    n_off = max(L1 - int(min_overlap) + 1, 0)
    qmax = max((n_off - 1) // 16, 0)

    m1 = bitops.word_valid_mask(W1, lens1)  # [B, W1] both-bits-per-base
    c1 = words1 & m1
    m2 = bitops.word_valid_mask(W2, lens2)
    c2 = rc2w & m2

    def up(x, r):
        # shift a packed row UP by r bases: word w <- (x[w] << 2r) |
        # (x[w-1] >> (32-2r)); r is a python constant (no UB shift at r=0)
        if r == 0:
            return x
        carry = jnp.pad(x, ((0, 0), (1, 0)))[:, :-1] >> jnp.uint32(32 - 2 * r)
        return (x << jnp.uint32(2 * r)) | carry

    ext = jnp.pad(c2, ((0, 0), (0, 1)))  # carry-out word
    mext = jnp.pad(m2, ((0, 0), (0, 1)))
    # slice [qmax - q, qmax - q + W1) must fit at q = 0 for any W1/W2:
    # back >= W1 - (W2 + 1). (Round-5 review bug: subtracting qmax here
    # under-padded whenever W1 > W2 + 1, and lax.dynamic_slice CLAMPS the
    # start — every small offset silently compared rc(R2) at the wrong
    # word shift and dropped real merges; regression test
    # test_merge_r2_much_shorter_small_offset.)
    back = max(0, W1 - (W2 + 1))
    # [16, B, qmax + W2 + 1 + back]: rc2 shifted up by o bases is words
    # [qmax - q, qmax - q + W1) of copy r
    stk = jnp.stack([up(ext, r) for r in range(16)])
    stk = jnp.pad(stk, ((0, 0), (0, 0), (qmax, back)))
    mstk = jnp.stack([up(mext, r) for r in range(16)])
    mstk = jnp.pad(mstk, ((0, 0), (0, 0), (qmax, back)))

    def step(carry, o):
        best_mm, best_o, best_ov = carry
        q = o // 16
        r = o % 16
        rs = jax.lax.dynamic_slice(stk, (r, 0, qmax - q), (1, B, W1))[0]
        ms = jax.lax.dynamic_slice(mstk, (r, 0, qmax - q), (1, B, W1))[0]
        diff = bitops.basewise_diff(c1, rs) & m1 & ms
        mm = jnp.sum(bitops.popcount32(diff), axis=-1)
        ov = jnp.maximum(jnp.minimum(lens1 - o, lens2), 0)
        allowed = jnp.floor(mmf * ov.astype(jnp.float32)).astype(jnp.int32)
        mm_q = jnp.where((ov >= min_overlap) & (mm <= allowed), mm, _BIG)
        better = mm_q < best_mm
        return (
            jnp.where(better, mm_q, best_mm),
            jnp.where(better, o, best_o),
            jnp.where(better, ov, best_ov),
        ), None

    init = (
        jnp.full((B,), _BIG, jnp.int32),
        jnp.zeros((B,), jnp.int32),
        jnp.zeros((B,), jnp.int32),
    )
    (best_mm, best_o, best_ov), _ = jax.lax.scan(
        step, init, jnp.arange(n_off, dtype=jnp.int32), unroll=8
    )
    return best_mm, best_o, best_ov


@partial(jax.jit, static_argnames=("min_overlap", "scan"))
def merge_pairs(
    words1: jax.Array,
    lens1: jax.Array,
    words2: jax.Array,
    lens2: jax.Array,
    min_overlap: int = 10,
    max_mismatch_frac=0.1,
    scan: str = "packed",
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Merge R1/R2 pairs whose fragment is shorter than lens1 + lens2.

    words1/words2: packed reads, R2 in its AS-SEQUENCED orientation (the
    op reverse-complements it). Returns (merged_words [B, Wm],
    merged_lens [B], merged [B] bool, best_overlap [B], mismatches [B],
    with mismatches = -1 on unmerged rows): rows with merged=False carry
    R1 unchanged (callers keep the pair separate).

    A pair merges when some overlap >= min_overlap has
    mismatches <= floor(max_mismatch_frac * overlap); among qualifying
    offsets the fewest-mismatch one wins, ties to the LONGEST overlap.
    Overlap bases take R1's call (no qualities in the packed domain).
    max_mismatch_frac is traced — tuning it does not recompile.
    scan: 'packed' (default — the 16x-less-traffic word-domain search,
    _packed_offset_scan) or 'codes' (the code-plane formulation, kept as
    the cross-implementation oracle; bit-exact with each other, asserted
    by tests/test_merge_pairs.py).
    """
    assert scan in ("packed", "codes"), scan
    lens1 = jnp.asarray(lens1, jnp.int32)
    lens2 = jnp.asarray(lens2, jnp.int32)
    c1 = bitops.unpack_words(words1).astype(jnp.int32)  # [B, L1]
    rc2w = revcomp_ops.reverse_complement_reads(words2, lens2)
    c2 = bitops.unpack_words(rc2w).astype(jnp.int32)  # [B, L2]
    B, L1 = c1.shape
    L2 = c2.shape[-1]
    pos1 = jnp.arange(L1, dtype=jnp.int32)
    in1 = pos1 < lens1[:, None]
    mmf = jnp.asarray(max_mismatch_frac, jnp.float32)
    n_off = max(L1 - int(min_overlap) + 1, 0)

    if scan == "packed":
        best_mm, best_o, best_ov = _packed_offset_scan(
            words1, lens1, rc2w, lens2, min_overlap, mmf
        )
    else:
        in2 = jnp.arange(L2, dtype=jnp.int32) < lens2[:, None]

        # pad BOTH sides so "shift right by o" is one dynamic_slice at
        # start L1 - o for every o in [0, L1] — right padding matters when
        # R2's padded width is smaller than R1's (L2 < L1), where an
        # unpadded slice would clamp and silently evaluate the wrong offset
        c2p = jnp.pad(c2, ((0, 0), (L1, L1)), constant_values=-1)
        in2p = jnp.pad(in2, ((0, 0), (L1, L1)))

        def step(carry, o):
            best_mm, best_o, best_ov = carry
            a2 = jax.lax.dynamic_slice_in_dim(c2p, L1 - o, L1, axis=-1)
            v2 = jax.lax.dynamic_slice_in_dim(in2p, L1 - o, L1, axis=-1)
            both = in1 & v2
            ov = jnp.sum(both.astype(jnp.int32), axis=-1)
            mm = jnp.sum((both & (c1 != a2)).astype(jnp.int32), axis=-1)
            allowed = jnp.floor(mmf * ov.astype(jnp.float32)).astype(jnp.int32)
            mm_q = jnp.where((ov >= min_overlap) & (mm <= allowed), mm, _BIG)
            # o ascends and overlap shrinks with o, so strict < keeps the
            # longest qualifying overlap among equal-mismatch offsets
            better = mm_q < best_mm
            return (
                jnp.where(better, mm_q, best_mm),
                jnp.where(better, o, best_o),
                jnp.where(better, ov, best_ov),
            ), None

        init = (
            jnp.full((B,), _BIG, jnp.int32),
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), jnp.int32),
        )
        # unroll: each offset step touches a few [B] vectors — the scan is
        # loop-overhead-bound like the alignment wavefront
        (best_mm, best_o, best_ov), _ = jax.lax.scan(
            step, init, jnp.arange(n_off, dtype=jnp.int32), unroll=8
        )

    merged = best_mm < _BIG
    # containment (rc(R2) inside R1, best_o + lens2 < lens1): the fragment
    # is all of R1 — R1's 3' tail must not be truncated
    frag_len = jnp.where(
        merged, jnp.maximum(best_o + lens2, lens1), lens1
    )

    Lm = L1 + L2
    Wm = bitops.n_words_for(Lm)
    if scan == "packed":
        # packed fragment construction: the code-plane path's [B, Lm]
        # take_along_axis + pack_codes dominates the op (DESIGN 16).
        # Build the fragment in the word domain: rc(R2)
        # funnel-shifted up by best_o bases per row (two [B, Wm]
        # word-granular gathers, 16x fewer gathered elements), OR-combined
        # with R1 under its length mask.
        W1w = words1.shape[-1]
        m2w = bitops.word_valid_mask(rc2w.shape[-1], lens2)
        ext = jnp.pad(rc2w & m2w, ((0, 0), (0, Wm - rc2w.shape[-1])))
        q = best_o // 16
        rb = (2 * (best_o % 16)).astype(jnp.uint32)[:, None]
        widx = jnp.arange(Wm, dtype=jnp.int32)[None, :] - q[:, None]
        cur = jnp.take_along_axis(ext, jnp.clip(widx, 0, Wm - 1), axis=-1)
        cur = jnp.where(widx >= 0, cur, jnp.uint32(0))
        prv = jnp.take_along_axis(ext, jnp.clip(widx - 1, 0, Wm - 1), axis=-1)
        prv = jnp.where(widx - 1 >= 0, prv, jnp.uint32(0))
        # (cur << rb) | (prv >> (32 - rb)); rb == 0 must not shift by 32
        rc2s = jnp.where(
            rb == 0, cur, (cur << rb) | (prv >> (jnp.uint32(32) - rb))
        )
        m1w = bitops.word_valid_mask(Wm, lens1)
        r1p = jnp.pad(words1, ((0, 0), (0, Wm - W1w))) & m1w
        mwords = (r1p | (rc2s & ~m1w)) & bitops.word_valid_mask(Wm, frag_len)
    else:
        # fragment codes: R1 verbatim, rc(R2)'s tail from lane lens1 on
        posm = jnp.arange(Lm, dtype=jnp.int32)
        take2 = jnp.clip(posm[None, :] - best_o[:, None], 0, L2 - 1)
        c2m = jnp.take_along_axis(
            jnp.pad(c2, ((0, 0), (0, Lm - L2))), take2, axis=-1
        )  # the one bounded gather
        cm = jnp.where(
            posm[None, :] < lens1[:, None],
            jnp.pad(c1, ((0, 0), (0, Lm - L1))),
            c2m,
        )
        cm = jnp.where(posm[None, :] < frag_len[:, None], cm, 0)
        cm = jnp.pad(cm, ((0, 0), (0, Wm * bitops.BASES_PER_WORD - Lm)))
        mwords = bitops.pack_codes(cm)
    out_words = jnp.where(
        merged[:, None],
        mwords,
        jnp.pad(words1, ((0, 0), (0, Wm - words1.shape[-1]))),
    )
    return out_words, frag_len, merged, best_ov, jnp.where(merged, best_mm, -1)
