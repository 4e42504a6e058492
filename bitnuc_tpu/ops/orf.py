"""Open-reading-frame detection on packed reads (getorf/ORFfinder-class).

The reference stops at base-level ops; a nucleotide toolkit also reads
codons (north-star surface). Semantics: an ORF starts at ATG and runs
in-frame to the first stop codon (TAA/TAG/TGA, excluded from the span);
with no in-frame stop it stays OPEN and runs to the last whole codon.
All six frames are scanned (three forward, three on the reverse
complement); coordinates are reported on the FORWARD strand.

Formulation: zero scatter, zero gather, no per-frame python loops —
the per-frame "next in-frame stop at or after p" is ONE reverse `cummin`
over a [B, L/3, 3] view of the stop-position array (the reshape IS the
frame split: column r holds frame r's codons in order), and winners are
masked single-value reduces (docs/DESIGN.md §2). The reverse strand
reuses the forward machinery on `reverse_complement_reads` with a
coordinate flip.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import revcomp as revcomp_ops
from ..utils import bitops

_BIG = np.int32(2**30)
# codon value = c0*16 + c1*4 + c2 with A=0 C=1 G=2 T=3
_ATG = np.int32(0 * 16 + 3 * 4 + 2)
_STOPS = (
    np.int32(3 * 16 + 0 * 4 + 0),  # TAA
    np.int32(3 * 16 + 0 * 4 + 2),  # TAG
    np.int32(3 * 16 + 2 * 4 + 0),  # TGA
)

# standard genetic code (table 1), indexed by the codon value above
_CODON_AA = {
    "TTT": "F", "TTC": "F", "TTA": "L", "TTG": "L",
    "CTT": "L", "CTC": "L", "CTA": "L", "CTG": "L",
    "ATT": "I", "ATC": "I", "ATA": "I", "ATG": "M",
    "GTT": "V", "GTC": "V", "GTA": "V", "GTG": "V",
    "TCT": "S", "TCC": "S", "TCA": "S", "TCG": "S",
    "CCT": "P", "CCC": "P", "CCA": "P", "CCG": "P",
    "ACT": "T", "ACC": "T", "ACA": "T", "ACG": "T",
    "GCT": "A", "GCC": "A", "GCA": "A", "GCG": "A",
    "TAT": "Y", "TAC": "Y", "TAA": "*", "TAG": "*",
    "CAT": "H", "CAC": "H", "CAA": "Q", "CAG": "Q",
    "AAT": "N", "AAC": "N", "AAA": "K", "AAG": "K",
    "GAT": "D", "GAC": "D", "GAA": "E", "GAG": "E",
    "TGT": "C", "TGC": "C", "TGA": "*", "TGG": "W",
    "CGT": "R", "CGC": "R", "CGA": "R", "CGG": "R",
    "AGT": "S", "AGC": "S", "AGA": "R", "AGG": "R",
    "GGT": "G", "GGC": "G", "GGA": "G", "GGG": "G",
}
_BASE_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
_AA_LUT = np.zeros(64, np.int32)
for _codon, _aa in _CODON_AA.items():
    _AA_LUT[
        _BASE_CODE[_codon[0]] * 16 + _BASE_CODE[_codon[1]] * 4 + _BASE_CODE[_codon[2]]
    ] = ord(_aa)


def _best_orf_one_strand(words, lengths):
    """(length [B], start [B], stopped [B]) of the longest ATG..stop ORF
    over the three same-strand frames. length counts coding bases
    (excluding the stop codon); 0 when no ATG exists. Ties prefer the
    smallest start.

    The strided reverse cummin below is an associative scan of
    ~log2(L/3) materialized [B, L] passes."""
    codes = bitops.unpack_words(words).astype(jnp.int32)
    B, L = codes.shape
    lengths = jnp.asarray(lengths, jnp.int32)
    pos = jnp.arange(L, dtype=jnp.int32)
    c1 = jnp.concatenate([codes[:, 1:], jnp.zeros((B, 1), jnp.int32)], -1)
    c2 = jnp.concatenate([codes[:, 2:], jnp.zeros((B, 2), jnp.int32)], -1)
    codon = codes * 16 + c1 * 4 + c2
    cvalid = pos + 3 <= lengths[:, None]

    is_stop = (
        (codon == _STOPS[0]) | (codon == _STOPS[1]) | (codon == _STOPS[2])
    ) & cvalid
    is_start = (codon == _ATG) & cvalid

    # next in-frame stop at-or-after p: pad L to a multiple of 3, view as
    # [B, L3//3, 3] (column r == frame r's codon sequence), one reverse
    # cummin along the codon axis
    L3 = -(-L // 3) * 3
    stop_pos = jnp.where(is_stop, pos, _BIG)
    stop_pos = jnp.pad(stop_pos, ((0, 0), (0, L3 - L)), constant_values=_BIG)
    v3 = stop_pos.reshape(B, L3 // 3, 3)
    nxt3 = jnp.flip(jax.lax.cummin(jnp.flip(v3, 1), axis=1), 1)
    nxt = nxt3.reshape(B, L3)[:, :L]

    # open ORFs end at the last whole in-frame codon: p + 3*floor((len-p)/3)
    open_end = pos + ((lengths[:, None] - pos) // 3) * 3
    stopped_here = nxt < _BIG
    end = jnp.where(stopped_here, nxt, open_end)
    olen = jnp.where(is_start, end - pos, 0)

    best = jnp.max(olen, axis=-1)
    at_best = (olen == best[:, None]) & is_start
    start = jnp.min(jnp.where(at_best, pos, _BIG), axis=-1)
    # stopped flag of the winning start (single-value reduce on the mask)
    stopped = (
        jnp.max(
            jnp.where(at_best & (pos == start[:, None]), stopped_here, False),
            axis=-1,
        )
        & (best > 0)
    )
    return best, jnp.where(best > 0, start, 0), stopped


@jax.jit
def translate_reads(
    words: jax.Array, lengths: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Translate frame 0 of each read with the standard genetic code.

    Returns (aa [B, L//3] uint8 ASCII amino acids, '*' for stops, 0 past
    each read's last whole codon; n_aa [B] int32). The 64-entry codon ->
    AA map applies as a one-hot contraction (no gather,
    docs/DESIGN.md §2); slice an ORF first with ops.split.slice_reads to
    translate arbitrary frames/strands.
    """
    codes = bitops.unpack_words(words).astype(jnp.int32)
    B, L = codes.shape
    lengths = jnp.asarray(lengths, jnp.int32)
    L3 = (L // 3) * 3
    v = codes[:, :L3].reshape(B, L3 // 3, 3)
    codon = v[..., 0] * 16 + v[..., 1] * 4 + v[..., 2]
    onehot = codon[..., None] == jnp.arange(64, dtype=jnp.int32)
    aa = jnp.sum(
        onehot * jnp.asarray(_AA_LUT)[None, None, :], axis=-1
    ).astype(jnp.uint8)
    n_aa = lengths // 3
    idx = jnp.arange(L3 // 3, dtype=jnp.int32)
    aa = jnp.where(idx[None, :] < n_aa[:, None], aa, 0)
    return aa, n_aa


@jax.jit
def longest_orf(
    words: jax.Array, lengths: jax.Array
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """Longest ORF per read across all six frames.

    Returns (length [B], start [B], end [B], is_rc [B] bool,
    stopped [B] bool): length in coding bases (stop codon excluded, 0 =
    no ATG anywhere), [start, end) in FORWARD-strand coordinates (for a
    reverse-strand ORF these bracket the reverse-complement span), and
    stopped = the ORF ends at a stop codon rather than the read edge.
    Ties prefer the forward strand, then the smallest start on that
    strand's own coordinates.
    """
    lengths = jnp.asarray(lengths, jnp.int32)
    rc = revcomp_ops.reverse_complement_reads(words, lengths)
    len_f, start_f, stop_f = _best_orf_one_strand(words, lengths)
    len_r, start_r, stop_r = _best_orf_one_strand(rc, lengths)

    use_rc = len_r > len_f  # strict: forward wins ties
    length = jnp.where(use_rc, len_r, len_f)
    stopped = jnp.where(use_rc, stop_r, stop_f)
    # reverse-strand [s, s+len) maps to forward [L-s-len, L-s)
    fwd_start = jnp.where(
        use_rc, lengths - start_r - len_r, start_f
    )
    return (
        length,
        jnp.where(length > 0, fwd_start, 0),
        jnp.where(length > 0, fwd_start + length, 0),
        use_rc & (length > 0),
        stopped,
    )
