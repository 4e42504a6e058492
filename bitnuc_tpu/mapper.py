"""Minimizer-index read mapping (seed -> vote -> extend) on device.

The reference library stops at fixed-frame comparison — `hdist` over
equal-length packed buffers (/root/reference/src/utils/functions/
hamming/multi.rs:122-160). A complete nucleotide toolkit also needs the
workload those primitives exist FOR: placing reads on a reference. This
module is a minimap2-class short-read mapper built entirely from the
codebase's device idioms — no scatter, no variadic reduce, no
data-dependent control flow, one gather whose cost is bounded by design:

1. SEEDS — (w,k)-minimizers with positions (`ops.kmer.minimizer_positions`
   / `minimizer_positions64` + `minimizer_sketch_mask`), the same sketch
   construction the sketching ops use. Keys are (lo, hi) u32 pairs
   throughout — hi is identically 0 for k <= 15, real for 16 <= k <= 31
   (sentinel headroom caps k at 31).
2. INDEX — one device pass builds a table of DISTINCT minimizer keys with
   up to `max_occ` reference positions per key. Occurrence columns come
   from STATIC left-shifts of the (key, pos)-sorted seed array (the rank-i
   occurrence of a run sits exactly i slots after the run start), run
   lengths from the scan-free boundary machinery (docs/DESIGN.md §4);
   keys occurring more than `max_occ` times are dropped whole (repeat
   masking, as in minimap2's frequency filter). No scatter anywhere.
3. JOIN — queries meet the table through ONE sort of
   [table keys ++ query keys] with a tag tiebreak. Because table keys are
   distinct and ascending, the matching table ROW INDEX is a monotone
   sequence recoverable by `lax.cummax` (a pointer forward-fill, validated
   by run membership: the fill is a hit iff the last table position is at
   or after the query row's run start) — the general segmented
   value-broadcast problem never arises. A second sort un-permutes, then a single bounded gather
   ([B, L] rows x max_occ contiguous columns) fetches candidate
   positions. Everything else is elementwise.
4. VOTE — candidate diagonals (ref_pos - read_pos) are sorted row-wise
   and the longest run of equal diagonal BINS wins (two half-shifted
   quantization phases so bands straddling a bin edge are not split).
   Run lengths reuse the reverse-cummin trick; winners are extracted with
   masked single-value reduces only (no argmax, docs/DESIGN.md §2).
5. EXTEND — the winning strand's read is aligned to a word-aligned
   reference window around the winning diagonal with the wavefront
   fitting alignment (`ops.align.fit_distance`, free ends in the window
   absorb the word-alignment slack): one forward pass gives the exact
   end + cost, one pass on reversed operands gives the exact start.

Strand handling: seeds+votes run for the read and its reverse complement
(`ops.revcomp.reverse_complement_reads`); the higher-support strand is
extended. Coordinates are always forward-reference (PAF convention).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .ops import align as align_ops
from .ops import kmer as kmer_ops
from .ops import revcomp as revcomp_ops
from .utils import bitops

_SENT = np.uint32(0xFFFFFFFF)
_BIG = np.int32(2**30)
_DOFF = np.int32(1 << 20)  # makes diagonals nonnegative before binning


# --------------------------------------------------------------------------
# index build
# --------------------------------------------------------------------------


def _shift_head(x: jax.Array, m: int, fill) -> jax.Array:
    """x[i + m] with `fill` past the end (static left shift)."""
    if m == 0:
        return x
    return jnp.concatenate([x[m:], jnp.full((m,), fill, x.dtype)])


@partial(jax.jit, static_argnames=("k", "w", "max_occ"))
def _build_table(words, length, k: int, w: int, max_occ: int, base_valid=None):
    """Distinct-key minimizer table from one packed sequence.

    Returns (lo [N] u32, hi [N] u32, pos [N, max_occ] i32 with -1
    padding, nocc [N] i32): distinct keys sorted ascending by (hi, lo)
    first, sentinel padding after; hi is identically 0 for k <= 15.
    Keys with more than max_occ reference occurrences are dropped whole.
    base_valid masks k-mers touching N / contig-separator bases out of
    seed selection entirely.
    """
    vlo, vhi, pos, valid = _seed_keys(words, length, k, w, base_valid)
    sel = kmer_ops.minimizer_sketch_mask(pos, valid)
    lo = jnp.where(sel, vlo, _SENT).reshape(-1)
    hi = jnp.where(sel, vhi, _SENT).reshape(-1)
    rpos = jnp.where(sel, pos, _BIG).reshape(-1).astype(jnp.int32)

    hi_s, lo_s, pos_s = jax.lax.sort((hi, lo, rpos), num_keys=3)
    N = lo_s.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32)
    first = jnp.concatenate(
        [jnp.ones((1,), bool), (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1])]
    )
    # next boundary strictly after i == run end for every row of the run
    at_or_after = jnp.flip(
        jax.lax.cummin(jnp.flip(jnp.where(first, idx, jnp.int32(N))))
    )
    run_end = jnp.concatenate([at_or_after[1:], jnp.full((1,), N, jnp.int32)])
    run_start = jax.lax.cummax(jnp.where(first, idx, 0))
    run_len = run_end - run_start

    keep = ((lo_s != _SENT) | (hi_s != _SENT)) & (run_len <= max_occ)
    start = first & keep
    cols = [
        jnp.where(start & (i < run_len), _shift_head(pos_s, i, _BIG), -1)
        for i in range(max_occ)
    ]
    shi = jnp.where(start, hi_s, _SENT)
    slo = jnp.where(start, lo_s, _SENT)
    nocc = jnp.where(start, run_len, 0)
    out = jax.lax.sort(tuple([shi, slo] + cols + [nocc]), num_keys=2)
    return out[1], out[0], jnp.stack(out[2:-1], axis=-1), out[-1]


def _seed_keys(words, lengths, k: int, w: int, base_valid=None):
    """(lo, hi, pos, valid) minimizer seeds for any k <= 31: pair keys,
    with hi identically 0 for k <= 15 (one mapper code path — the extra
    all-zero sort column costs little and removes a key-width fork)."""
    if k > 15:
        return kmer_ops.minimizer_positions64(
            words, lengths, k, w, base_valid=base_valid
        )
    vals, pos, valid = kmer_ops.minimizer_positions(
        words, lengths, k, w, base_valid=base_valid
    )
    return vals, jnp.zeros_like(vals), pos, valid


class MinimizerIndex:
    """Reference minimizer index: distinct sorted keys, <= max_occ forward
    positions each, plus the packed reference for extension windows."""

    def __init__(
        self,
        keys,
        pos,
        nocc,
        ref_words,
        ref_len,
        k,
        w,
        max_occ,
        contig_starts=None,
        keys_hi=None,
    ):
        self.keys = np.asarray(keys, np.uint32)  # [Nk] low key words
        # high key words ([Nk]; zeros for k <= 15) — sorted by (hi, lo)
        self.keys_hi = (
            np.zeros_like(self.keys)
            if keys_hi is None
            else np.asarray(keys_hi, np.uint32)
        )
        self.pos = np.asarray(pos, np.int32)  # [Nk, max_occ], -1 padded
        self.nocc = np.asarray(nocc, np.int32)  # [Nk]
        self.ref_words = np.asarray(ref_words, np.uint32)  # [Wr]
        self.ref_len = int(ref_len)
        self.k, self.w, self.max_occ = int(k), int(w), int(max_occ)
        # build_multi: concat-coordinate start of each contig (None = single)
        self.contig_starts = (
            None if contig_starts is None else np.asarray(contig_starts, np.int64)
        )

    @classmethod
    def build(
        cls,
        ref: Union[bytes, np.ndarray],
        k: int = 15,
        w: int = 10,
        max_occ: int = 8,
        ref_len: Optional[int] = None,
        base_valid: Optional[np.ndarray] = None,
        contig_starts=None,
    ) -> "MinimizerIndex":
        """Build from an ASCII reference (bytes) or packed words + ref_len.

        bytes input auto-masks non-ACGT bases (N handling): masked k-mers
        never become seeds, and the bases pack via the arithmetic ASCII map
        (so alignment windows treat them as ordinary mismatching bases).
        Pass base_valid to extend the mask (e.g. contig separators —
        build_multi)."""
        assert 1 <= k <= 31, "minimizer keys must leave sentinel headroom"
        assert w >= 1 and max_occ >= 1
        if isinstance(ref, (bytes, bytearray)):
            from . import io as bnio
            from .sequence import PackedReads

            ref = bytes(ref).upper()
            packed = PackedReads.from_ascii([ref], validate=False)
            words = packed.words
            n = int(packed.lengths[0])
            bv = bnio._VALID_BASE[np.frombuffer(ref, np.uint8)]
            if base_valid is not None:
                bv = bv & np.asarray(base_valid, bool)
            base_valid = bv
        else:
            words = jnp.asarray(ref, jnp.uint32).reshape(1, -1)
            n = int(ref_len)
        if base_valid is not None:
            base_valid = jnp.asarray(np.asarray(base_valid, bool))[None, :]
        lo, hi, pos, nocc = _build_table(
            words, jnp.array([n], jnp.int32), k, w, max_occ, base_valid
        )
        lo, hi = np.asarray(lo), np.asarray(hi)
        live = int(((lo != _SENT) | (hi != _SENT)).sum())
        return cls(
            lo[:live],
            np.asarray(pos)[:live],
            np.asarray(nocc)[:live],
            np.asarray(words)[0],
            n,
            k,
            w,
            max_occ,
            contig_starts,
            keys_hi=hi[:live],
        )

    @classmethod
    def build_multi(
        cls,
        contigs,
        k: int = 15,
        w: int = 10,
        max_occ: int = 8,
    ) -> "MinimizerIndex":
        """Multi-contig build: contigs join with one masked separator base,
        so no seed's k-mer ever spans a junction. contig_starts records each
        contig's offset in the concatenated coordinate system (contig c
        covers [contig_starts[c], contig_starts[c] + len(contigs[c]))."""
        contigs = [bytes(c).upper() for c in contigs]
        genome = b"A".join(contigs)  # content arbitrary: masked below
        starts, bad, off = [], [], 0
        for i, c in enumerate(contigs):
            if i:
                bad.append(off)
                off += 1
            starts.append(off)
            off += len(c)
        bv = np.ones(len(genome), bool)
        bv[np.array(bad, np.int64)] = False
        return cls.build(
            genome, k, w, max_occ, base_valid=bv,
            contig_starts=np.array(starts, np.int64),
        )

    def save(self, path) -> None:
        extra = {}
        if self.contig_starts is not None:
            extra["contig_starts"] = self.contig_starts
        np.savez_compressed(
            path,
            keys=self.keys,
            keys_hi=self.keys_hi,
            pos=self.pos,
            nocc=self.nocc,
            ref_words=self.ref_words,
            meta=np.array(
                [self.ref_len, self.k, self.w, self.max_occ], np.int64
            ),
            **extra,
        )

    @classmethod
    def load(cls, path) -> "MinimizerIndex":
        z = np.load(path)
        ref_len, k, w, max_occ = (int(v) for v in z["meta"])
        return cls(
            z["keys"],
            z["pos"],
            z["nocc"],
            z["ref_words"],
            ref_len,
            k,
            w,
            max_occ,
            z["contig_starts"] if "contig_starts" in z.files else None,
            keys_hi=z["keys_hi"] if "keys_hi" in z.files else None,
        )

    def __len__(self) -> int:
        return int(self.keys.shape[0])


# --------------------------------------------------------------------------
# query
# --------------------------------------------------------------------------


def _seed_cap(L: int, w: int) -> int:
    """Compacted seed slots per read: ~2x the expected minimizer count
    2L/(w+1) (a +7-sigma cap for random sequence — the practical analog
    of minimap2's seed caps), 32-aligned, never above L."""
    want = 4 * L // (w + 1) + 8
    return max(32, min(L, -(-want // 32) * 32))


def _seed_anchors(words, lengths, t_lo, t_hi, t_pos, k: int, w: int):
    """Seed anchors for every read: (rpos [B, S, max_occ] int32 with -1
    where there is no hit, qpos [B, S] int32, hit [B, S, max_occ] bool),
    S = _seed_cap(L, w). Pair keys throughout (hi == 0 for k <= 15).

    Selected minimizer slots COMPACT to the front of each row first (one
    [B, L] row sort keyed on slot index — selected positions are strictly
    increasing, so query-position order survives for the chaining DP):
    ~91%% of slots are non-minimizer sentinels at (k=15, w=10), and the
    compaction shrinks everything downstream — the join sort, the cummax
    fills, the unsort, the occurrence gather, and the vote — by L/S."""
    B = words.shape[0]
    vlo, vhi, pos, valid = _seed_keys(words, lengths, k, w)
    sel = kmer_ops.minimizer_sketch_mask(pos, valid)
    qlo = jnp.where(sel, vlo, _SENT)  # [B, L]
    qhi = jnp.where(sel, vhi, _SENT)
    qp = jnp.where(sel, pos, 0).astype(jnp.int32)
    L = qlo.shape[-1]
    S = _seed_cap(L, w)
    if S < L:
        okey = jnp.where(sel, jnp.arange(L, dtype=jnp.int32), jnp.int32(L))
        _, qlo, qhi, qp = jax.lax.sort(
            (okey, qlo, qhi, qp), num_keys=1
        )
        qlo, qhi, qp = qlo[:, :S], qhi[:, :S], qp[:, :S]
        sel = qlo != _SENT
    L = qlo.shape[-1]
    Q = B * L
    Nk = t_lo.shape[0]

    lo_all = jnp.concatenate([t_lo, qlo.reshape(-1)])
    hi_all = jnp.concatenate([t_hi, qhi.reshape(-1)])
    tag = jnp.concatenate(
        [jnp.zeros(Nk, jnp.uint32), jnp.ones(Q, jnp.uint32)]
    )
    orig = jnp.concatenate(
        [jnp.full(Nk, Q, jnp.int32), jnp.arange(Q, dtype=jnp.int32)]
    )
    # The table-row pointer does NOT ride the sort: table keys
    # are distinct and ascending, so in sorted order the table rows are
    # exactly rows 0..Nk-1 in id order and ptr_s is derivable as
    # cumsum(is_table) - 1 — the dominant join sort sheds one payload
    # array (3 -> 2 for narrow keys, 5 -> 4 wide).
    if k <= 15:
        # narrow keys (< 4^15 = 2^30) leave a spare bit: fold the
        # table/query tag into it so the dominant join sort shrinks
        # further to 2 arrays / 1 key (the sort is the seed stage's main
        # cost). The sentinel (no-minimizer slot)
        # keeps its all-ones value and still sorts last.
        key_all = jnp.where(
            lo_all == _SENT, _SENT, (lo_all << jnp.uint32(1)) | tag
        )
        key_s, orig_s = jax.lax.sort((key_all, orig), num_keys=1)
        is_table = (key_s & jnp.uint32(1)) == 0  # _SENT is odd
        lo_s = jnp.where(key_s == _SENT, _SENT, key_s >> jnp.uint32(1))
        hi_s = jnp.zeros_like(lo_s)
    else:
        hi_s, lo_s, tag_s, orig_s = jax.lax.sort(
            (hi_all, lo_all, tag, orig), num_keys=3
        )
        is_table = tag_s == 0  # sentinel query rows carry tag 1

    # table rows are distinct and ascending by (hi, lo), so "my key's
    # table row" is a monotone pointer forward-fill; it is a real hit iff
    # that table row is inside MY key run (table rows sort before query
    # rows of the same key), i.e. tptr >= run_start — cumsum/cummax
    # fills, no gather and no key compare. Sentinel query rows form
    # table-free runs and fail the test automatically.
    N = Nk + Q
    idx = jnp.arange(N, dtype=jnp.int32)
    first = jnp.concatenate(
        [
            jnp.ones((1,), bool),
            (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1]),
        ]
    )
    run_start = jax.lax.cummax(jnp.where(first, idx, 0))
    # position (in sorted order) of the last table row at or before i —
    # same index space as run_start, unlike the table-row id in tptr
    tpos = jax.lax.cummax(jnp.where(is_table, idx, -1))
    tptr = jnp.cumsum(is_table.astype(jnp.int32)) - 1  # last table id <= i
    tptr = jnp.where(tpos >= run_start, tptr, Nk)  # Nk = all-miss dummy

    _, tptr_u = jax.lax.sort((orig_s, tptr), num_keys=1)
    tq = tptr_u[:Q].reshape(B, L)

    pos_pad = jnp.concatenate(
        [t_pos, jnp.full((1, t_pos.shape[1]), -1, jnp.int32)]
    )
    cand = jnp.take(pos_pad, tq, axis=0)  # [B, L, max_occ] — THE one gather
    hit = (cand >= 0) & sel[..., None]
    return cand, qp, hit


def _seed_candidates(words, lengths, t_lo, t_hi, t_pos, k: int, w: int):
    """Candidate diagonals for every read: [B, L * max_occ] int32
    (ref_pos - read_pos + _DOFF; _BIG where there is no candidate)."""
    B = words.shape[0]
    cand, qp, hit = _seed_anchors(words, lengths, t_lo, t_hi, t_pos, k, w)
    diag = jnp.where(hit, cand - qp[..., None] + _DOFF, _BIG)
    return diag.reshape(B, -1)


def _vote(diag: jax.Array, bin_bits: int) -> Tuple[jax.Array, jax.Array]:
    """Longest same-bin run per read over two half-shifted quantization
    phases. diag [B, M] (_BIG = no candidate). Returns (support [B],
    best_diag [B] — the smallest raw diagonal inside the winning bin;
    _BIG when a read has no candidates at all)."""
    d = jnp.sort(diag, axis=-1)
    B, M = d.shape
    idx = jnp.arange(M, dtype=jnp.int32)
    half = np.int32(1 << (bin_bits - 1)) if bin_bits > 0 else np.int32(0)

    best_sup = jnp.zeros((B,), jnp.int32)
    best_lo = jnp.full((B,), _BIG, jnp.int32)
    for off in (np.int32(0), half):
        q = (d + off) >> bin_bits  # monotone in d: one sort serves both
        first = jnp.concatenate(
            [jnp.ones((B, 1), bool), q[:, 1:] != q[:, :-1]], axis=-1
        )
        run_end = jnp.flip(
            jax.lax.cummin(
                jnp.flip(
                    jnp.where(
                        jnp.concatenate(
                            [first[:, 1:], jnp.ones((B, 1), bool)], axis=-1
                        ),
                        idx + 1,
                        jnp.int32(M),
                    ),
                    axis=-1,
                ),
                axis=1,
            ),
            axis=-1,
        )
        run_len = jnp.where(first & (d != _BIG), run_end - idx, 0)
        sup = jnp.max(run_len, axis=-1)
        # winning bin = smallest bin attaining sup (masked-min, no argmax)
        win_bin = jnp.min(
            jnp.where(run_len == sup[:, None], q, _BIG), axis=-1
        )
        lo = jnp.min(
            jnp.where((q == win_bin[:, None]) & (d != _BIG), d, _BIG), axis=-1
        )
        better = sup > best_sup
        best_lo = jnp.where(better, lo, best_lo)
        best_sup = jnp.maximum(best_sup, sup)
    return best_sup, best_lo


def _reverse_reads(words: jax.Array, lengths: jax.Array) -> jax.Array:
    """Reverse WITHOUT complement: complement-then-revcomp (both bit-local)."""
    W = words.shape[-1]
    comp = words ^ bitops.word_valid_mask(W, jnp.asarray(lengths, jnp.int32))
    return revcomp_ops.reverse_complement_reads(comp, lengths)


@partial(
    jax.jit,
    static_argnames=("k", "w", "bin_bits", "pad", "mismatch", "gap", "band"),
)
def _map_core(
    words,
    lengths,
    t_lo,
    t_hi,
    t_pos,
    ref_words,
    ref_len,
    k: int,
    w: int,
    bin_bits: int,
    pad: int,
    mismatch: int,
    gap: int,
    band: bool = True,
):
    B, W = words.shape
    lengths = jnp.asarray(lengths, jnp.int32)

    rc_words = revcomp_ops.reverse_complement_reads(words, lengths)
    # both strands through ONE join: the table sort is the dominant cost
    # for genome-scale indexes, so stacking fwd+rc reads halves it
    diag2 = _seed_candidates(
        jnp.concatenate([words, rc_words]),
        jnp.concatenate([lengths, lengths]),
        t_lo,
        t_hi,
        t_pos,
        k,
        w,
    )
    sup2, lo2 = _vote(diag2, bin_bits)
    sup_f, sup_r = sup2[:B], sup2[B:]
    lo_f, lo_r = lo2[:B], lo2[B:]

    use_rc = sup_r > sup_f
    support = jnp.maximum(sup_f, sup_r)
    d0 = jnp.where(use_rc, lo_r, lo_f) - _DOFF  # est. forward ref start
    q_words = jnp.where(use_rc[:, None], rc_words, words)

    # word-aligned window around the diagonal; fit alignment's free ends
    # absorb the <=15-base alignment slack
    Lb = W * bitops.BASES_PER_WORD
    Wwin = (Lb + 2 * pad) // bitops.BASES_PER_WORD + 1
    ws = jnp.clip(d0 - pad, 0, jnp.maximum(ref_len - 1, 0)) // 16
    cost, ref_start, ref_end = _fit_extend(
        q_words, lengths, ws, ref_words, ref_len, Wwin, mismatch, gap,
        start_slack=(pad + 16 + (1 << bin_bits)) if band else None,
        band_gap=_BAND_GAP if band else None,
    )
    return support, use_rc, ref_start, ref_end, cost


# gap-drift budget of the banded fit: paths whose diagonal wanders more
# than this many net indels from the seeded start diagonal fall outside the
# band (their cost becomes an achievable upper bound — such reads are
# either unmapped or wildly indel-rich, the long-read tier's regime)
_BAND_GAP = 32


def _fit_extend(
    q_words, lengths, ws, ref_words, ref_len, Wwin, mismatch, gap,
    start_slack=None, band_gap=None,
):
    """Base-exact (cost, ref_start, ref_end) of each read fitted into the
    word-aligned reference window starting at word ws (Wwin words wide).

    ONE span-carrying fit pass (ops.align.fit_distance_span): start and
    end come from the same optimal path by construction, so a stacked
    forward+reversed double fit over 2B rows is not needed, and
    tandem-repeat interval coherence needs no tie_late coupling (spans
    are single-path by construction).

    start_slack + band_gap (both static) select the BANDED wavefront
    (ops.align.fit_distance_span_banded): the window construction puts
    each read's start diagonal within [0, start_slack] of the window
    origin (seed diagonal accuracy + word alignment), so the live band is
    j - i in [-band_gap, start_slack + band_gap] — exact for every
    alignment within band_gap net gap drift, an upper bound beyond.
    """
    ref_pad = jnp.concatenate([ref_words, jnp.zeros((Wwin,), jnp.uint32)])
    win = jax.vmap(
        lambda s: jax.lax.dynamic_slice(ref_pad, (s,), (Wwin,))
    )(ws)
    wlen = jnp.clip(ref_len - ws * 16, 0, Wwin * 16).astype(jnp.int32)
    if start_slack is not None and band_gap is not None:
        # the band is widened to a multiple of 8 diagonals (_band_k8; a
        # superset of the requested band — never less exact)
        off_lo = -int(band_gap)
        _, off_hi = align_ops._band_k8(
            off_lo, int(start_slack) + int(band_gap)
        )
        cost, startj, endj = align_ops.fit_distance_span_banded(
            q_words, lengths, win, wlen, mismatch, gap,
            off_lo=off_lo, off_hi=off_hi,
        )
    else:
        cost, startj, endj = align_ops.fit_distance_span(
            q_words, lengths, win, wlen, mismatch, gap
        )
    return cost, ws * 16 + startj, ws * 16 + endj


def map_reads(
    index: MinimizerIndex,
    reads,
    min_seeds: int = 2,
    bin_bits: int = 5,
    pad: int = 32,
    mismatch: int = 1,
    gap: int = 1,
    mesh=None,
    axis: str = "data",
) -> dict:
    """Map a PackedReads batch against a MinimizerIndex.

    Returns numpy arrays (one entry per read):
      mapped    bool  — at least min_seeds diagonal votes agreed
      strand    bytes '+'/'-' — reverse-complement reads map to '-'
      ref_start int32 — forward-reference start (exact, from reversed fit)
      ref_end   int32 — forward-reference end (one past; exact)
      cost      int32 — fitting-alignment cost of the full read
      support   int32 — seed votes on the winning diagonal band

    Unmapped rows carry support/cost from the attempt but should be
    ignored (ref coordinates are meaningless without seeds).
    mesh: optional jax Mesh — reads shard over `axis` (index replicated);
    the batch is zero-padded to a device multiple and results sliced back,
    so any batch size works and output matches the single-device run.
    """
    if mesh is not None:
        from .parallel.mesh import pad_batch

        B = int(reads.words.shape[0])
        padded = pad_batch(reads, int(mesh.shape[axis]))
        res = map_reads_sharded(
            index, padded, mesh, axis, min_seeds=min_seeds,
            bin_bits=bin_bits, pad=pad, mismatch=mismatch, gap=gap,
        )
        return {f: v[:B] for f, v in res.items()}
    support, use_rc, ref_start, ref_end, cost = _map_core(
        reads.words,
        reads.lengths,
        jnp.asarray(index.keys),
        jnp.asarray(index.keys_hi),
        jnp.asarray(index.pos),
        jnp.asarray(index.ref_words),
        np.int32(index.ref_len),
        index.k,
        index.w,
        bin_bits,
        pad,
        mismatch,
        gap,
    )
    support = np.asarray(support)
    return {
        "mapped": support >= min_seeds,
        "strand": np.where(np.asarray(use_rc), b"-", b"+"),
        "ref_start": np.asarray(ref_start),
        "ref_end": np.asarray(ref_end),
        "cost": np.asarray(cost),
        "support": support,
    }


def map_reads_sharded(
    index: MinimizerIndex,
    reads,
    mesh,
    axis: str = "data",
    min_seeds: int = 2,
    bin_bits: int = 5,
    pad: int = 32,
    mismatch: int = 1,
    gap: int = 1,
) -> dict:
    """Data-parallel map_reads: reads sharded over `axis`, index replicated
    on every device (the standard mapping fleet layout — the index is the
    genome-sized constant, reads are the stream). Batch must divide the
    mesh axis; results match map_reads exactly."""
    from jax.sharding import PartitionSpec as P

    n = mesh.shape[axis]
    B = reads.words.shape[0]
    assert B % n == 0, f"mesh axis size {n} must divide batch {B}"

    core = partial(
        _map_core,
        k=index.k,
        w=index.w,
        bin_bits=bin_bits,
        pad=pad,
        mismatch=mismatch,
        gap=gap,
    )
    fn = jax.shard_map(
        lambda wd, ln, tl, th, tp, rw, rl: core(wd, ln, tl, th, tp, rw, rl),
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P(), P(), P(), P()),
        out_specs=P(axis),
        check_vma=False,
    )
    support, use_rc, ref_start, ref_end, cost = fn(
        reads.words,
        jnp.asarray(reads.lengths, jnp.int32),
        jnp.asarray(index.keys),
        jnp.asarray(index.keys_hi),
        jnp.asarray(index.pos),
        jnp.asarray(index.ref_words),
        jnp.full((), index.ref_len, jnp.int32),
    )
    support = np.asarray(support)
    return {
        "mapped": support >= min_seeds,
        "strand": np.where(np.asarray(use_rc), b"-", b"+"),
        "ref_start": np.asarray(ref_start),
        "ref_end": np.asarray(ref_end),
        "cost": np.asarray(cost),
        "support": support,
    }


# --------------------------------------------------------------------------
# per-base alignment traceback (CIGAR) for mapped reads
# --------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("win_width", "band"))
def _traceback_core(
    words,
    lengths,
    ref_words,
    ref_start,
    ref_end,
    use_rc,
    win_width: int,
    mismatch,
    gap,
    band: int = 0,
):
    """Global alignment ops of each read (in its mapped orientation)
    against its exact reference window [ref_start, ref_end).

    The window codes are ONE bounded gather from the unpacked reference
    (B * win_width elements — an output-path cost, not the mapping hot
    loop); the wavefront+traceback runs batched (ops.align.align_ops_codes).
    Returns (cost [B], ops [B, T] uint8 forward order).
    """
    from .ops import align as align_mod

    lengths = jnp.asarray(lengths, jnp.int32)
    rc_words = revcomp_ops.reverse_complement_reads(words, lengths)
    w = jnp.where(jnp.asarray(use_rc, bool)[:, None], rc_words, words)
    codes_a = bitops.unpack_words(w).astype(jnp.int32)

    ref_codes = bitops.unpack_words(ref_words.reshape(1, -1)).reshape(-1)
    Rn = ref_codes.shape[0]
    start = jnp.asarray(ref_start, jnp.int32)
    wlen = jnp.clip(
        jnp.asarray(ref_end, jnp.int32) - start, 0, win_width
    )
    gidx = jnp.clip(
        start[:, None] + jnp.arange(win_width, dtype=jnp.int32)[None, :],
        0,
        Rn - 1,
    )
    codes_b = jnp.take(ref_codes, gidx).astype(jnp.int32)
    if band:
        # banded traceback: the recorded direction plane shrinks from
        # (M+N)(N+1) to (M+N)K bytes per read — O(L*band), the long-read
        # regime's memory wall. Exact whenever the alignment's diagonal
        # drift (net indels at any prefix) stays within +-band.
        cost, _, ops = align_mod.align_ops_codes_banded(
            codes_a, lengths, codes_b, wlen, mismatch, gap,
            ends_free_b=False, off_lo=-int(band), off_hi=int(band),
        )
    else:
        cost, _, ops = align_mod.align_ops_codes(
            codes_a, lengths, codes_b, wlen, mismatch, gap, ends_free_b=False
        )
    return cost, ops


def traceback_cigars(
    index: MinimizerIndex,
    reads,
    map_result: dict,
    mismatch: int = 1,
    gap: int = 1,
    pad: int = 32,
    chunk: int = 1024,
    eqx: bool = True,
    band: int = 0,
) -> dict:
    """Per-read CIGAR strings for a map_reads result (the minimap2 -c /
    --eqx analog the reference tier lacked through round 2).

    band > 0 routes the per-read alignment through the BANDED traceback
    (ops.align.align_ops_codes_banded, diagonal drift limited to +-band):
    the recorded plane drops from (M+N)(N+1) to (M+N)(band+2) bytes per
    read — the memory wall of the long-read SAM path. Exact whenever the
    alignment's net-indel excursion stays within the band (the CLI passes
    the same tb_pad budget its window already assumes).

    Re-derives the full per-base alignment of each mapped read against its
    exact window [ref_start, ref_end) — the same cost model the mapper's
    fit used. With band=0 (full plane) tb_cost <= map_result['cost'] and
    they are EQUAL whenever the map fit's own band (_BAND_GAP net indels)
    contained the optimal path — i.e. for every read the banded fit scored
    exactly; a read that exceeded that drift budget maps with an
    upper-bound cost and can report tb_cost < cost here (the traceback is
    the tighter of the two). Runs in `chunk`-read slabs: the traceback's
    direction planes are O(L * window) bytes per read and this is the
    metadata output path, not the mapping hot loop.

    Returns {"cigar": [B] list (None for unmapped rows), "tb_cost" [B]
    int32, "ops" [B, T] uint8 forward-order op codes (ops.align.OP_*)} —
    feed "ops" to ops.pileup.pileup_counts_ops for indel-aware pileups.
    """
    from .ops import align as align_mod

    B = int(reads.words.shape[0])
    L = int(reads.words.shape[1]) * 16
    win_width = L + 2 * int(pad)
    T = L + win_width
    costs = np.zeros(B, np.int32)
    ops_all = np.zeros((B, T), np.uint8)
    use_rc = np.asarray(map_result["strand"] == b"-")
    rs = np.asarray(map_result["ref_start"], np.int32)
    re_ = np.asarray(map_result["ref_end"], np.int32)
    mapped = np.asarray(map_result["mapped"], bool)
    # unmapped rows: empty window, zero-length handled by masks; clamp the
    # coordinates so the gather indices stay sane
    rs = np.where(mapped, rs, 0)
    re_ = np.where(mapped, re_, 0)
    rw = jnp.asarray(index.ref_words)
    for s in range(0, B, chunk):
        e = min(B, s + chunk)
        cost, ops = _traceback_core(
            jnp.asarray(reads.words[s:e]),
            jnp.asarray(reads.lengths[s:e]),
            rw,
            jnp.asarray(rs[s:e]),
            jnp.asarray(re_[s:e]),
            jnp.asarray(use_rc[s:e]),
            win_width,
            np.int32(mismatch),
            np.int32(gap),
            band=int(band),
        )
        costs[s:e] = np.asarray(cost)
        ops_np = np.asarray(ops)
        ops_all[s:e, : ops_np.shape[1]] = ops_np
    cig = [
        align_mod.cigar_string(ops_all[i], eqx) if mapped[i] else None
        for i in range(B)
    ]
    return {"cigar": cig, "tb_cost": costs, "ops": ops_all}


# --------------------------------------------------------------------------
# long-read mode: chain instead of vote (minimap2 --no-align analog)
# --------------------------------------------------------------------------


@partial(
    jax.jit, static_argnames=("k", "w", "lookback", "extend", "pad", "mismatch", "gap")
)
def _map_long_core(
    words,
    lengths,
    t_lo,
    t_hi,
    t_pos,
    ref_words,
    ref_len,
    k: int,
    w: int,
    max_gap,
    gap_unit,
    lookback: int,
    extend: bool = False,
    pad: int = 32,
    mismatch: int = 1,
    gap: int = 1,
):
    from .ops import chain as chain_ops

    B = words.shape[0]
    lengths = jnp.asarray(lengths, jnp.int32)
    rc_words = revcomp_ops.reverse_complement_reads(words, lengths)
    cand, qp, hit = _seed_anchors(
        jnp.concatenate([words, rc_words]),
        jnp.concatenate([lengths, lengths]),
        t_lo,
        t_hi,
        t_pos,
        k,
        w,
    )
    M = cand.shape[1] * cand.shape[2]
    rpos = jnp.where(hit, cand, -1).reshape(2 * B, M)
    qpos = jnp.broadcast_to(qp[:, :, None], cand.shape).reshape(2 * B, M)
    score, sr, er, sq, eq = chain_ops.chain_anchors(
        rpos, qpos, rpos >= 0, max_gap, gap_unit, lookback
    )
    use_rc = score[B:] > score[:B]  # forward wins ties

    def pick(x):
        return jnp.where(use_rc, x[B:], x[:B])

    score, sr, er, sq, eq = map(pick, (score, sr, er, sq, eq))
    # reverse-strand query span (rc k-mer starts) -> forward k-mer starts:
    # the k-mer at rc position p spans forward [L - p - k, L - p)
    q_start = jnp.where(use_rc, lengths - eq - k, sq)
    q_end = jnp.where(use_rc, lengths - sq - k, eq)
    if not extend:
        z = jnp.zeros_like(score)
        return score, use_rc, sr, er, q_start, q_end, z
    # base-exact extension: fit the whole read into the chain's reference
    # window (window width caps at 1.25x the read + padding, so reads
    # whose chains imply more net deletion get clamped — their cost rises
    # instead of the shapes growing unboundedly)
    W = words.shape[-1]
    Lb = W * bitops.BASES_PER_WORD
    Wwin = (Lb + Lb // 4 + 2 * pad) // bitops.BASES_PER_WORD + 1
    q_words = jnp.where(use_rc[:, None], rc_words, words)
    ws = jnp.clip(sr - pad, 0, None) // 16
    cost, rs, re = _fit_extend(
        q_words, lengths, ws, ref_words, ref_len, Wwin, mismatch, gap
    )
    return score, use_rc, rs, re, q_start, q_end, cost


def map_reads_long(
    index: MinimizerIndex,
    reads,
    min_chain: int = 3,
    max_gap: int = 2048,
    gap_unit: int = 16,
    lookback: int = 64,
    extend: bool = False,
    pad: int = 32,
    mismatch: int = 1,
    gap: int = 1,
    mesh=None,
    axis: str = "data",
) -> dict:
    """Chain-based mapping for long / indel-rich reads (the minimap2
    --no-align regime): anchors from the same minimizer join, placement
    from collinear chaining (ops.chain) instead of the short-read
    diagonal vote — diagonal drift up to max_gap per link is tolerated,
    where the vote's fixed bins are not.

    Returns numpy arrays per read: mapped (chain score >= min_chain),
    strand, ref_start/ref_end and q_start/q_end — the INCLUSIVE first and
    last chained anchor coordinates (anchor granularity) — and
    chain_score (anchor count net of gap penalties).

    extend=True additionally fits the WHOLE read into the chain's
    reference window with the wavefront alignment, replacing
    ref_start/ref_end with base-exact coordinates and adding "cost"
    (total edit cost). The window caps at 1.25x the read length + 2*pad;
    wavefront work grows with read length squared — right for reads up
    to a few kb, not 100kb (chunk longer reads by their chain spans).

    mesh: optional jax Mesh — reads shard over `axis` with the index
    replicated (same fleet layout as map_reads_sharded); the batch is
    zero-padded to a device multiple and sliced back, so results match
    the single-device run exactly. Long reads are where one chip runs
    out of memory first, so this is the scale-out path.
    """
    if mesh is not None:
        from .parallel.mesh import pad_batch

        B = int(reads.words.shape[0])
        padded = pad_batch(reads, int(mesh.shape[axis]))
        res = map_reads_long_sharded(
            index, padded, mesh, axis, min_chain=min_chain, max_gap=max_gap,
            gap_unit=gap_unit, lookback=lookback, extend=extend, pad=pad,
            mismatch=mismatch, gap=gap,
        )
        return {f: v[:B] for f, v in res.items()}
    score, use_rc, sr, er, q_start, q_end, cost = _map_long_core(
        reads.words,
        reads.lengths,
        jnp.asarray(index.keys),
        jnp.asarray(index.keys_hi),
        jnp.asarray(index.pos),
        jnp.asarray(index.ref_words),
        np.int32(index.ref_len),
        index.k,
        index.w,
        np.int32(max_gap),
        np.int32(gap_unit),
        lookback,
        extend,
        pad,
        mismatch,
        gap,
    )
    score = np.asarray(score)
    out = {
        "mapped": score >= min_chain,
        "strand": np.where(np.asarray(use_rc), b"-", b"+"),
        "ref_start": np.asarray(sr),
        "ref_end": np.asarray(er),
        "q_start": np.asarray(q_start),
        "q_end": np.asarray(q_end),
        "chain_score": score,
    }
    if extend:
        out["cost"] = np.asarray(cost)
    return out


def map_reads_long_sharded(
    index: MinimizerIndex,
    reads,
    mesh,
    axis: str = "data",
    min_chain: int = 3,
    max_gap: int = 2048,
    gap_unit: int = 16,
    lookback: int = 64,
    extend: bool = False,
    pad: int = 32,
    mismatch: int = 1,
    gap: int = 1,
) -> dict:
    """Data-parallel map_reads_long: reads sharded over `axis`, index
    replicated (the long-read twin of map_reads_sharded). Batch must
    divide the mesh axis; results match map_reads_long exactly."""
    from jax.sharding import PartitionSpec as P

    n = mesh.shape[axis]
    B = reads.words.shape[0]
    assert B % n == 0, f"mesh axis size {n} must divide batch {B}"

    core = partial(
        _map_long_core,
        k=index.k,
        w=index.w,
        lookback=lookback,
        extend=extend,
        pad=pad,
        mismatch=mismatch,
        gap=gap,
    )
    fn = jax.shard_map(
        lambda wd, ln, tl, th, tp, rw, rl, mg, gu: core(
            wd, ln, tl, th, tp, rw, rl, max_gap=mg, gap_unit=gu
        ),
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P(), P(), P(), P(), P(), P()),
        out_specs=P(axis),
        check_vma=False,
    )
    score, use_rc, sr, er, q_start, q_end, cost = fn(
        reads.words,
        jnp.asarray(reads.lengths, jnp.int32),
        jnp.asarray(index.keys),
        jnp.asarray(index.keys_hi),
        jnp.asarray(index.pos),
        jnp.asarray(index.ref_words),
        jnp.full((), index.ref_len, jnp.int32),
        jnp.full((), max_gap, jnp.int32),
        jnp.full((), gap_unit, jnp.int32),
    )
    score = np.asarray(score)
    out = {
        "mapped": score >= min_chain,
        "strand": np.where(np.asarray(use_rc), b"-", b"+"),
        "ref_start": np.asarray(sr),
        "ref_end": np.asarray(er),
        "q_start": np.asarray(q_start),
        "q_end": np.asarray(q_end),
        "chain_score": score,
    }
    if extend:
        out["cost"] = np.asarray(cost)
    return out


def map_pairs(
    index: MinimizerIndex,
    reads1,
    reads2,
    min_insert: int = 0,
    max_insert: int = 1000,
    min_seeds: int = 2,
    mesh=None,
    axis: str = "data",
    **kw,
) -> dict:
    """Map R1/R2 mates and annotate proper pairs (FR orientation within
    the insert-size window — the aligner-standard concordance check).

    Both mates map through ONE stacked map_reads dispatch (one dispatch
    over the whole batch instead of two halves); a pair is PROPER when both map, on
    opposite strands, with the leftmost mate on '+', and the outer span
    (insert) inside [min_insert, max_insert]. Returns {"r1", "r2",
    "proper" [B] bool, "insert" [B] int32 — -1 for non-proper pairs}.
    mesh: optional jax Mesh — the stacked mate batch maps through
    map_reads_sharded (auto-padded to a device multiple); the pairing
    logic is host-side metadata either way.
    """
    from .sequence import PackedReads

    B = reads1.words.shape[0]
    if reads2.words.shape[0] != B:
        raise ValueError(
            f"mate batches differ: {B} R1 reads vs "
            f"{reads2.words.shape[0]} R2 reads"
        )
    W = max(reads1.words.shape[1], reads2.words.shape[1])

    def widen(r):
        w = jnp.asarray(r.words)
        if w.shape[1] < W:
            w = jnp.pad(w, ((0, 0), (0, W - w.shape[1])))
        return w

    stacked = PackedReads(
        words=jnp.concatenate([widen(reads1), widen(reads2)]),
        lengths=jnp.concatenate(
            [jnp.asarray(reads1.lengths), jnp.asarray(reads2.lengths)]
        ),
    )
    both_res = map_reads(
        index, stacked, min_seeds=min_seeds, mesh=mesh, axis=axis, **kw
    )
    r1 = {f: v[:B] for f, v in both_res.items()}
    r2 = {f: v[B:] for f, v in both_res.items()}
    both = r1["mapped"] & r2["mapped"]
    opposite = r1["strand"] != r2["strand"]
    # forward-strand mate must be leftmost (FR orientation)
    fwd_is_1 = r1["strand"] == b"+"
    left_start = np.where(fwd_is_1, r1["ref_start"], r2["ref_start"])
    right_end = np.where(fwd_is_1, r2["ref_end"], r1["ref_end"])
    insert = right_end - left_start
    fr = left_start <= np.where(fwd_is_1, r2["ref_start"], r1["ref_start"])
    proper = (
        both
        & opposite
        & fr
        & (insert >= min_insert)
        & (insert <= max_insert)
    )
    return {
        "r1": r1,
        "r2": r2,
        "proper": proper,
        "insert": np.where(proper, insert, -1).astype(np.int32),
    }
