"""Batched pairwise alignment on device: edit distance, global / fitting
(semi-global) distance, and affine-gap Smith-Waterman scores.

The reference library's only sequence-comparison primitive is Hamming
distance over equal-length packed words
(/root/reference/src/utils/functions/hamming/multi.rs:122-160); a complete
nucleotide toolkit also needs alignment, where insertions/deletions shift
the frame. None of the classic CPU formulations survive contact with XLA:
row-by-row DP is a data-dependent double loop, WFA's frontier is
dynamically sized, and Myers' bit-parallel automaton needs per-row
carry propagation. The batched shape is the ANTI-DIAGONAL WAVEFRONT:

- cells on one anti-diagonal d = i + j have no data dependence on each
  other, so each scan step updates a whole [batch, N+1] vector of lanes;
- `lax.scan` over d = 1..M+N carries the two previous diagonals — static
  shapes, no data-dependent control flow, one fused elementwise kernel
  per step;
- the per-step substitution costs need a[d-1-j] vs b[j-1] for every j —
  a diagonal GATHER of `a` (docs/DESIGN.md §8).
  Reversing `a` ONCE turns every diagonal of the equality matrix into a
  contiguous slice: a[d-1-j] == reversed(a)[La-d+j], so each step does
  one `dynamic_slice` instead of a gather;
- per-pair ragged lengths are handled by masking: `a` pads with code 4,
  `b` pads with code 5 (never equal, never match), and answers are
  extracted with exact (i == m, j == n) masks — so one compilation
  serves every length mix in the padded batch.

Scores are int32 lanes (the VPU is 32-bit hardware; docs/DESIGN.md §1).
Oracle parity: tests/test_align.py mirrors every mode, including the
Smith-Waterman tie-break contract (max score, then smallest i+j, then
smallest j).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import bitops

_BIG = np.int32(2**30)
_PAD_A = np.int32(4)  # sentinel codes: pads never equal each other or ACGT
_PAD_B = np.int32(5)


def _codes(words: jax.Array, lengths: jax.Array, pad: np.int32) -> jax.Array:
    """[B, W] packed words -> [B, L] int32 codes with `pad` past each length."""
    c = bitops.unpack_words(words).astype(jnp.int32)
    pos = jnp.arange(c.shape[-1], dtype=jnp.int32)
    return jnp.where(pos < lengths[..., None], c, pad)


def _rev_padded(codes_a: jax.Array, n_lanes: int) -> jax.Array:
    """Reverse `a` and pad both ends so every diagonal slice is in bounds."""
    B = codes_a.shape[0]
    pad = jnp.full((B, n_lanes), _PAD_A, jnp.int32)
    return jnp.concatenate([pad, codes_a[:, ::-1], pad], axis=-1)


def _shift1(x: jax.Array, fill) -> jax.Array:
    """x[j-1] with `fill` at j=0 (lane shift via pad+slice, no roll)."""
    return jnp.concatenate(
        [jnp.full(x.shape[:-1] + (1,), fill, x.dtype), x[..., :-1]], axis=-1
    )


def _b_shifted(codes_b: jax.Array) -> jax.Array:
    """[B, N+1] vector with b[j-1] at lane j (sentinel at j=0)."""
    return jnp.concatenate(
        [jnp.full((codes_b.shape[0], 1), _PAD_B, jnp.int32), codes_b], axis=-1
    )


@partial(jax.jit, static_argnames=("ends_free_b",))
def _distance_wavefront(
    words_a: jax.Array,
    lens_a: jax.Array,
    words_b: jax.Array,
    lens_b: jax.Array,
    mismatch,
    gap,
    ends_free_b: bool = False,
    tie_late=None,
) -> Tuple[jax.Array, jax.Array]:
    """Min-cost alignment DP. Global (Needleman-Wunsch distance form) when
    ends_free_b=False; fitting alignment (all of `a` inside a substring of
    `b`: D[0, j] = 0, answer = min_j D[m, j]) when True.

    Returns (cost [B] int32, end_j [B] int32). end_j is the b-offset one
    past the best fit's end (== lens_b for global). Equal-cost fits tie to
    the SMALLEST end_j; rows where tie_late [B] bool is True tie to the
    LARGEST instead (traced, so both policies share one compilation — the
    mapper needs opposite policies for its stacked forward/reversed
    passes to pick the same placement in tandem repeats).
    """
    lens_a = jnp.asarray(lens_a, jnp.int32)
    lens_b = jnp.asarray(lens_b, jnp.int32)
    mismatch = jnp.asarray(mismatch, jnp.int32)
    gap = jnp.asarray(gap, jnp.int32)
    a = _codes(words_a, lens_a, _PAD_A)
    b = _codes(words_b, lens_b, _PAD_B)
    B, M = a.shape
    N = b.shape[-1]
    pos = jnp.arange(N + 1, dtype=jnp.int32)  # lane j on the diagonal
    arp = _rev_padded(a, N + 1)
    bsh = _b_shifted(b)
    m, n = lens_a[:, None], lens_b[:, None]

    # diag_0: D[0,0] = 0 at j=0
    prev = jnp.where(pos == 0, 0, _BIG) * jnp.ones((B, 1), jnp.int32)
    prev2 = jnp.full((B, N + 1), _BIG, jnp.int32)
    # m + n == 0: the scan never reaches d == m+n, so seed the answer
    ans0 = jnp.where((lens_a + lens_b) == 0, 0, _BIG)
    fit0 = jnp.where(lens_a == 0, 0, _BIG)  # D[0, 0] for the fit running-min
    endj0 = jnp.zeros((B,), jnp.int32)
    late = (
        jnp.zeros((B,), bool) if tie_late is None else jnp.asarray(tie_late, bool)
    )

    def step(carry, d):
        prev, prev2, ans, fit, endj = carry
        a_diag = jax.lax.dynamic_slice_in_dim(arp, N + 1 + M - d, N + 1, -1)
        sub = jnp.where(a_diag == bsh, 0, mismatch)
        diag = jnp.minimum(
            jnp.minimum(prev + gap, _shift1(prev, _BIG) + gap),
            _shift1(prev2, _BIG) + sub,
        )
        # boundaries: D[d, 0] = d*gap; D[0, d] = d*gap (0 when ends_free_b)
        diag = jnp.where(pos == 0, d * gap, diag)
        row0 = jnp.int32(0) if ends_free_b else d * gap
        diag = jnp.where(pos == d, row0, diag)
        if ends_free_b:
            # cell (i=m, j=d-m) lives on this diagonal once
            jm = d - m
            at = (pos == jm) & (jm >= 0) & (pos <= n)
            v = jnp.min(jnp.where(at, diag, _BIG), axis=-1)
            # d (hence j = d - m) ascends, so strict < keeps the earliest
            # (smallest) end_j; tie_late rows also take equal costs,
            # keeping the latest (largest) end_j
            better = (v < fit) | (late & (v == fit) & (v < _BIG))
            fit = jnp.minimum(fit, v)
            endj = jnp.where(better, jnp.squeeze(jm, -1), endj)
        else:
            at = (pos == n) & (d == (m + n))
            v = jnp.min(jnp.where(at, diag, _BIG), axis=-1)
            ans = jnp.minimum(ans, v)
        return (diag, prev, ans, fit, endj), None

    # unroll=8: each diagonal step touches only [B, N+1] lanes, so the
    # scan is loop-overhead-bound and unrolling amortizes the per-step
    # overhead (whether 8 is best on the GPU is ROADMAP 1.6)
    (prev, prev2, ans, fit, endj), _ = jax.lax.scan(
        step,
        (prev, prev2, ans0, fit0, endj0),
        jnp.arange(1, M + N + 1, dtype=jnp.int32),
        unroll=8,
    )
    if ends_free_b:
        return fit, endj
    return ans, lens_b


def edit_distance(
    words_a: jax.Array,
    lens_a: jax.Array,
    words_b: jax.Array,
    lens_b: jax.Array,
) -> jax.Array:
    """Levenshtein distance per pair (a[i] vs b[i]): [B] int32."""
    d, _ = _distance_wavefront(words_a, lens_a, words_b, lens_b, 1, 1)
    return d


def global_distance(
    words_a: jax.Array,
    lens_a: jax.Array,
    words_b: jax.Array,
    lens_b: jax.Array,
    mismatch=1,
    gap=1,
) -> jax.Array:
    """Weighted global alignment cost (Needleman-Wunsch in distance form)."""
    d, _ = _distance_wavefront(words_a, lens_a, words_b, lens_b, mismatch, gap)
    return d


def fit_distance(
    words_a: jax.Array,
    lens_a: jax.Array,
    words_b: jax.Array,
    lens_b: jax.Array,
    mismatch=1,
    gap=1,
    tie_late=None,
) -> Tuple[jax.Array, jax.Array]:
    """Fitting alignment: all of `a` against the best-matching substring of
    `b` (free start/end in `b` only). Returns (cost [B], end_j [B]) where
    end_j is one past the substring's end; ties prefer the smallest end_j,
    or the largest on rows where tie_late [B] bool is True (traced).
    """
    return _distance_wavefront(
        words_a,
        lens_a,
        words_b,
        lens_b,
        mismatch,
        gap,
        ends_free_b=True,
        tie_late=tie_late,
    )


@jax.jit
def fit_distance_span(
    words_a: jax.Array,
    lens_a: jax.Array,
    words_b: jax.Array,
    lens_b: jax.Array,
    mismatch=1,
    gap=1,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Fitting alignment returning BOTH span ends in one pass:
    (cost [B], start_j [B], end_j [B]).

    Carries the path's row-0 entry column through the DP (the same
    carry-the-origin trick as ops/chain.py), so start and end come from
    ONE optimal path by construction — the stacked forward+reversed
    double fit this replaces paid the wavefront scan twice and could
    pick its end and start from different co-optimal paths without the
    tie_late coupling. Ties: end_j = smallest optimal end (earliest
    diagonal wins strictly); start_j = smallest start among optimal
    paths to that end (min-propagation is exact DP). Mirrored by the
    oracle in tests/test_align.py.
    """
    lens_a = jnp.asarray(lens_a, jnp.int32)
    lens_b = jnp.asarray(lens_b, jnp.int32)
    mismatch = jnp.asarray(mismatch, jnp.int32)
    gap = jnp.asarray(gap, jnp.int32)
    a = _codes(words_a, lens_a, _PAD_A)
    b = _codes(words_b, lens_b, _PAD_B)
    B, M = a.shape
    N = b.shape[-1]
    pos = jnp.arange(N + 1, dtype=jnp.int32)
    arp = _rev_padded(a, N + 1)
    bsh = _b_shifted(b)
    m, n = lens_a[:, None], lens_b[:, None]

    prev = jnp.where(pos == 0, 0, _BIG) * jnp.ones((B, 1), jnp.int32)
    prev2 = jnp.full((B, N + 1), _BIG, jnp.int32)
    s_prev = jnp.broadcast_to(pos, (B, N + 1))  # S[0, j] = j
    s_prev2 = jnp.zeros((B, N + 1), jnp.int32)
    fit0 = jnp.where(lens_a == 0, 0, _BIG)
    endj0 = jnp.zeros((B,), jnp.int32)
    startj0 = jnp.zeros((B,), jnp.int32)

    def step(carry, d):
        prev, prev2, s_prev, s_prev2, fit, endj, startj = carry
        a_diag = jax.lax.dynamic_slice_in_dim(arp, N + 1 + M - d, N + 1, -1)
        sub = jnp.where(a_diag == bsh, 0, mismatch)
        c_diag = _shift1(prev2, _BIG) + sub
        c_up = prev + gap
        c_left = _shift1(prev, _BIG) + gap
        diag = jnp.minimum(jnp.minimum(c_diag, c_up), c_left)
        s_diag = _shift1(s_prev2, _BIG)
        s_up = s_prev
        s_left = _shift1(s_prev, _BIG)
        # min start over ALL candidates achieving the optimum
        S = jnp.minimum(
            jnp.minimum(
                jnp.where(c_diag == diag, s_diag, _BIG),
                jnp.where(c_up == diag, s_up, _BIG),
            ),
            jnp.where(c_left == diag, s_left, _BIG),
        )
        diag = jnp.where(pos == 0, d * gap, diag)
        S = jnp.where(pos == 0, 0, S)
        diag = jnp.where(pos == d, 0, diag)  # free b-prefix: D[0, j] = 0
        S = jnp.where(pos == d, pos, S)  # a path entering at (0, j): S = j
        jm = d - m
        at = (pos == jm) & (jm >= 0) & (pos <= n)
        v = jnp.min(jnp.where(at, diag, _BIG), axis=-1)
        st = jnp.min(jnp.where(at, S, _BIG), axis=-1)
        better = v < fit  # strict: earliest (smallest) end wins ties
        fit = jnp.minimum(fit, v)
        endj = jnp.where(better, jnp.squeeze(jm, -1), endj)
        startj = jnp.where(better, st, startj)
        return (diag, prev, S, s_prev, fit, endj, startj), None

    (prev, prev2, s_prev, s_prev2, fit, endj, startj), _ = jax.lax.scan(
        step,
        (prev, prev2, s_prev, s_prev2, fit0, endj0, startj0),
        jnp.arange(1, M + N + 1, dtype=jnp.int32),
        unroll=8,  # loop-overhead-bound
    )
    startj = jnp.where(fit < _BIG, jnp.minimum(startj, endj), 0)
    return fit, startj, endj


# ---------------------------------------------------------------------------
# banded wavefront
# ---------------------------------------------------------------------------
#
# The full wavefront updates every lane j in [0, N] each diagonal step, but
# an alignment path only visits cells whose diagonal offset o = j - i drifts
# by one per gap. When the caller can bound o to [off_lo, off_hi] (the mapper
# window construction puts the read's start at o ~ pad..pad+vote-slack, and
# drift beyond that costs gap each), the live cells on anti-diagonal d are
# j in [ceil((d+off_lo)/2), floor((d+off_hi)/2)] — a BAND of
# K = (off_hi-off_lo)/2 + 2 lanes whose start base(d) slides half a lane per
# step. Carrying [B, K] lanes instead of [B, N+1] cuts per-step VPU work by
# N/K; the band alignment between steps is one dynamic_slice of the
# (BIG-padded) carried diagonals at delta = base(d) - base(d-1) in {0, 1}
# (base(d-2): {0, 1, 2}) — the same traced-offset lane slice the full
# wavefront already pays for its a-diagonal.
#
# Contract: EXACT equality with the unbanded result whenever some optimal
# path keeps j - i within [off_lo, off_hi] (ends with end_j - m outside the
# band are never candidates); otherwise the banded cost is an achievable
# upper bound. tests/test_align.py asserts exactness for in-band cases and
# the >= property in general.


def _band_geometry(off_lo: int, off_hi: int, N: int):
    """(K, base_fn) for a band covering j - i in [off_lo, off_hi]."""
    assert off_lo <= 0 <= off_hi, (off_lo, off_hi)
    K = (off_hi - off_lo + 1) // 2 + 2
    top = max(0, N + 1 - K)

    def base(d):
        return jnp.clip((d + off_lo + 1) // 2, 0, top)

    return K, base


def _band_k8(off_lo: int, off_hi: int, sa: int = 8) -> Tuple[int, int]:
    """(K, effective off_hi): widen the band so its lane count K is a
    multiple of sa (the widened band is a superset — never less exact).
    The mapper's banded fit runs at this band, so its cost/start/end are
    pinned to it."""
    K, _ = _band_geometry(off_lo, off_hi, 1 << 30)
    K8 = -(-K // sa) * sa
    return K8, off_lo + 2 * (K8 - 2)


def _band_shift(x: jax.Array, delta, lag: int, K: int, fill) -> jax.Array:
    """Band-local lane alignment: out[t] = x[t + delta - lag] (fill outside).

    delta is the traced base() step between diagonals; lag=0 reads the same
    j (up-move), lag=1 reads j-1 (left/diag moves)."""
    B = x.shape[0]
    lead = jnp.full((B, lag), fill, x.dtype)
    tail = jnp.full((B, 3 - lag), fill, x.dtype)
    padded = jnp.concatenate([lead, x, tail], axis=-1)
    return jax.lax.dynamic_slice_in_dim(padded, delta, K, axis=-1)


@partial(jax.jit, static_argnames=("off_lo", "off_hi"))
def fit_distance_span_banded(
    words_a: jax.Array,
    lens_a: jax.Array,
    words_b: jax.Array,
    lens_b: jax.Array,
    mismatch=1,
    gap=1,
    off_lo: int = -16,
    off_hi: int = 96,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """fit_distance_span restricted to the diagonal band
    j - i in [off_lo, off_hi] (see the band contract above). Same return
    contract: (cost [B], start_j [B], end_j [B]), single-path spans,
    earliest-end / smallest-start ties."""
    lens_a = jnp.asarray(lens_a, jnp.int32)
    lens_b = jnp.asarray(lens_b, jnp.int32)
    mismatch = jnp.asarray(mismatch, jnp.int32)
    gap = jnp.asarray(gap, jnp.int32)
    a = _codes(words_a, lens_a, _PAD_A)
    b = _codes(words_b, lens_b, _PAD_B)
    B, M = a.shape
    N = b.shape[-1]
    K, base = _band_geometry(off_lo, off_hi, N)
    if K >= N + 1:  # band wider than the window: the full scan is cheaper
        return fit_distance_span(words_a, lens_a, words_b, lens_b, mismatch, gap)
    t = jnp.arange(K, dtype=jnp.int32)
    arp = _rev_padded(a, N + 1)
    bsh = _b_shifted(b)
    m, n = lens_a[:, None], lens_b[:, None]

    # d = 0: band starts at j = 0; D[0, 0] = 0, S[0, j] = j
    prev = jnp.where(t == 0, 0, _BIG) * jnp.ones((B, 1), jnp.int32)
    prev2 = jnp.full((B, K), _BIG, jnp.int32)
    s_prev = jnp.broadcast_to(t, (B, K))
    s_prev2 = jnp.zeros((B, K), jnp.int32)
    fit0 = jnp.where(lens_a == 0, 0, _BIG)
    endj0 = jnp.zeros((B,), jnp.int32)
    startj0 = jnp.zeros((B,), jnp.int32)

    def step(carry, d):
        prev, prev2, s_prev, s_prev2, fit, endj, startj = carry
        bd = base(d)
        d1 = bd - base(d - 1)
        d2 = bd - base(d - 2)
        jj = bd + t
        a_diag = jax.lax.dynamic_slice_in_dim(arp, N + 1 + M - d + bd, K, -1)
        b_diag = jax.lax.dynamic_slice_in_dim(bsh, bd, K, -1)
        sub = jnp.where(a_diag == b_diag, 0, mismatch)
        c_diag = _band_shift(prev2, d2, 1, K, _BIG) + sub
        c_up = _band_shift(prev, d1, 0, K, _BIG) + gap
        c_left = _band_shift(prev, d1, 1, K, _BIG) + gap
        diag = jnp.minimum(jnp.minimum(c_diag, c_up), c_left)
        s_diag = _band_shift(s_prev2, d2, 1, K, _BIG)
        s_up = _band_shift(s_prev, d1, 0, K, _BIG)
        s_left = _band_shift(s_prev, d1, 1, K, _BIG)
        S = jnp.minimum(
            jnp.minimum(
                jnp.where(c_diag == diag, s_diag, _BIG),
                jnp.where(c_up == diag, s_up, _BIG),
            ),
            jnp.where(c_left == diag, s_left, _BIG),
        )
        diag = jnp.where(jj == 0, d * gap, diag)
        S = jnp.where(jj == 0, 0, S)
        diag = jnp.where(jj == d, 0, diag)  # free b-prefix: D[0, j] = 0
        S = jnp.where(jj == d, jj, S)
        diag = jnp.where(jj > d, _BIG, diag)  # i < 0: no such cell
        jm = d - m
        at = (jj == jm) & (jm >= 0) & (jj <= n)
        v = jnp.min(jnp.where(at, diag, _BIG), axis=-1)
        st = jnp.min(jnp.where(at, S, _BIG), axis=-1)
        better = v < fit
        fit = jnp.minimum(fit, v)
        endj = jnp.where(better, jnp.squeeze(jm, -1), endj)
        startj = jnp.where(better, st, startj)
        return (diag, prev, S, s_prev, fit, endj, startj), None

    (prev, prev2, s_prev, s_prev2, fit, endj, startj), _ = jax.lax.scan(
        step,
        (prev, prev2, s_prev, s_prev2, fit0, endj0, startj0),
        jnp.arange(1, M + N + 1, dtype=jnp.int32),
        unroll=8,  # loop-overhead-bound, like the full wavefront
    )
    startj = jnp.where(fit < _BIG, jnp.minimum(startj, endj), 0)
    return fit, startj, endj


# ---------------------------------------------------------------------------
# traceback: alignment operations + CIGAR
# ---------------------------------------------------------------------------

# op codes in traceback output (0 terminates a row's op list)
OP_STOP, OP_EQ, OP_X, OP_INS, OP_DEL = 0, 1, 2, 3, 4
_OP_CHARS = {OP_EQ: "=", OP_X: "X", OP_INS: "I", OP_DEL: "D"}


def _wavefront_tb_codes(
    a: jax.Array,
    lens_a: jax.Array,
    b: jax.Array,
    lens_b: jax.Array,
    mismatch,
    gap,
    ends_free_b: bool,
    tie_late,
):
    """Distance wavefront that additionally RECORDS per-cell directions and
    tracebacks on device.

    The forward scan is _distance_wavefront with a uint8 CANDIDATE-MASK
    plane emitted per diagonal (bit0 diag ties, bit1 up ties, bit2 left
    ties, bit3 diag-is-match); the traceback is a second lax.scan of M+N
    steps whose only data-dependent memory access is ONE take_along_axis
    row gather per step (the traceback
    touches M+N cells per pair vs the forward pass's (M+N)(N+1) — it is
    never the dominant cost). Tie policy: CONTINUE the current op when it
    ties (gap runs coalesce — unit gap costs otherwise legally split a
    planted indel around coincidental matches, which downstream indel
    calling would report as two events), else diag > up > left. Mirrored
    exactly by the full-DP oracle in tests/test_align.py.

    Returns (cost [B], end_j [B], ops [B, M+N] uint8): ops in FORWARD
    order (alignment start -> end), OP_STOP-padded at the tail;
    OP_EQ/OP_X consume one base of each, OP_INS one of a (insertion to
    the reference), OP_DEL one of b.
    """
    mismatch = jnp.asarray(mismatch, jnp.int32)
    gap = jnp.asarray(gap, jnp.int32)
    B, M = a.shape
    N = b.shape[-1]
    T = M + N
    pos = jnp.arange(N + 1, dtype=jnp.int32)
    arp = _rev_padded(a, N + 1)
    bsh = _b_shifted(b)
    m, n = lens_a[:, None], lens_b[:, None]

    prev = jnp.where(pos == 0, 0, _BIG) * jnp.ones((B, 1), jnp.int32)
    prev2 = jnp.full((B, N + 1), _BIG, jnp.int32)
    ans0 = jnp.where((lens_a + lens_b) == 0, 0, _BIG)
    fit0 = jnp.where(lens_a == 0, 0, _BIG)
    endj0 = jnp.zeros((B,), jnp.int32)
    late = (
        jnp.zeros((B,), bool) if tie_late is None else jnp.asarray(tie_late, bool)
    )

    def step(carry, d):
        prev, prev2, ans, fit, endj = carry
        a_diag = jax.lax.dynamic_slice_in_dim(arp, N + 1 + M - d, N + 1, -1)
        is_eq = a_diag == bsh
        cand_diag = _shift1(prev2, _BIG) + jnp.where(is_eq, 0, mismatch)
        cand_up = prev + gap  # D[i-1, j]
        cand_left = _shift1(prev, _BIG) + gap  # D[i, j-1]
        diag = jnp.minimum(jnp.minimum(cand_diag, cand_up), cand_left)
        # candidate mask: EVERY tying predecessor, so the traceback can
        # apply its op-continuation tie policy
        dirv = (
            (diag == cand_diag) * 1
            + (diag == cand_up) * 2
            + (diag == cand_left) * 4
            + is_eq * 8
        )
        # boundaries: D[d, 0] = d*gap (all-up); D[0, d] = d*gap or free
        diag = jnp.where(pos == 0, d * gap, diag)
        dirv = jnp.where(pos == 0, 2, dirv)
        row0_val = jnp.int32(0) if ends_free_b else d * gap
        row0_dir = 0 if ends_free_b else 4
        diag = jnp.where(pos == d, row0_val, diag)
        dirv = jnp.where(pos == d, row0_dir, dirv)
        if ends_free_b:
            jm = d - m
            at = (pos == jm) & (jm >= 0) & (pos <= n)
            v = jnp.min(jnp.where(at, diag, _BIG), axis=-1)
            better = (v < fit) | (late & (v == fit) & (v < _BIG))
            fit = jnp.minimum(fit, v)
            endj = jnp.where(better, jnp.squeeze(jm, -1), endj)
        else:
            at = (pos == n) & (d == (m + n))
            v = jnp.min(jnp.where(at, diag, _BIG), axis=-1)
            ans = jnp.minimum(ans, v)
        return (diag, prev, ans, fit, endj), dirv.astype(jnp.uint8)

    (prev, prev2, ans, fit, endj), dirs = jax.lax.scan(
        step,
        (prev, prev2, ans0, fit0, endj0),
        jnp.arange(1, T + 1, dtype=jnp.int32),
    )
    cost, end_j = (fit, endj) if ends_free_b else (ans, lens_b)

    # -- traceback --------------------------------------------------------
    flat = jnp.moveaxis(dirs, 0, 1).reshape(B, T * (N + 1))

    def tb_step(carry, _):
        i, j, prev_op = carry
        active = (i > 0) if ends_free_b else ((i > 0) | (j > 0))
        d = i + j
        idx = jnp.clip((d - 1) * (N + 1) + j, 0, T * (N + 1) - 1)
        mask = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0].astype(
            jnp.int32
        )
        diag_op = jnp.where((mask & 8) != 0, OP_EQ, OP_X)
        # op-continuation first (coalesces gap runs), else diag > up > left
        op = jnp.where(
            (prev_op == OP_INS) & ((mask & 2) != 0),
            OP_INS,
            jnp.where(
                (prev_op == OP_DEL) & ((mask & 4) != 0),
                OP_DEL,
                jnp.where(
                    (mask & 1) != 0,
                    diag_op,
                    jnp.where((mask & 2) != 0, OP_INS, OP_DEL),
                ),
            ),
        )
        op = jnp.where(active, op, OP_STOP)
        di = ((op == OP_EQ) | (op == OP_X) | (op == OP_INS)).astype(jnp.int32)
        dj = ((op == OP_EQ) | (op == OP_X) | (op == OP_DEL)).astype(jnp.int32)
        return (i - di, j - dj, op), op.astype(jnp.uint8)

    (_, _, _), ops_rev = jax.lax.scan(
        tb_step, (lens_a, end_j, jnp.zeros_like(lens_a)), None, length=T
    )
    ops_rev = jnp.transpose(ops_rev)  # [B, T], end -> start order
    nsteps = jnp.sum((ops_rev != OP_STOP).astype(jnp.int32), axis=1)
    tidx = nsteps[:, None] - 1 - jnp.arange(T, dtype=jnp.int32)[None, :]
    ops_fwd = jnp.where(
        tidx >= 0,
        jnp.take_along_axis(ops_rev, jnp.clip(tidx, 0, T - 1), axis=1),
        jnp.uint8(OP_STOP),
    )
    return cost, end_j, ops_fwd


def _wavefront_tb_codes_banded(
    a: jax.Array,
    lens_a: jax.Array,
    b: jax.Array,
    lens_b: jax.Array,
    mismatch,
    gap,
    ends_free_b: bool,
    off_lo: int,
    off_hi: int,
):
    """_wavefront_tb_codes restricted to the diagonal band
    j - i in [off_lo, off_hi] (band contract above fit_distance_span_banded).

    The recorded direction plane shrinks from (M+N)·(N+1) to (M+N)·K
    bytes per pair — the long-read SAM path's traceback memory goes from
    quadratic in read length to O(L·band). Same candidate-mask encoding
    and op-continuation tie policy as the full-plane version; the
    traceback's row gather addresses band-local lanes (j - base(d))."""
    mismatch = jnp.asarray(mismatch, jnp.int32)
    gap = jnp.asarray(gap, jnp.int32)
    B, M = a.shape
    N = b.shape[-1]
    T = M + N
    K, base = _band_geometry(off_lo, off_hi, N)
    if K >= N + 1:
        return _wavefront_tb_codes(
            a, lens_a, b, lens_b, mismatch, gap, ends_free_b, None
        )
    t = jnp.arange(K, dtype=jnp.int32)
    arp = _rev_padded(a, N + 1)
    bsh = _b_shifted(b)
    m, n = lens_a[:, None], lens_b[:, None]

    prev = jnp.where(t == 0, 0, _BIG) * jnp.ones((B, 1), jnp.int32)
    prev2 = jnp.full((B, K), _BIG, jnp.int32)
    ans0 = jnp.where((lens_a + lens_b) == 0, 0, _BIG)
    fit0 = jnp.where(lens_a == 0, 0, _BIG)
    endj0 = jnp.zeros((B,), jnp.int32)

    def step(carry, d):
        prev, prev2, ans, fit, endj = carry
        bd = base(d)
        d1 = bd - base(d - 1)
        d2 = bd - base(d - 2)
        jj = bd + t
        a_diag = jax.lax.dynamic_slice_in_dim(arp, N + 1 + M - d + bd, K, -1)
        b_diag = jax.lax.dynamic_slice_in_dim(bsh, bd, K, -1)
        is_eq = a_diag == b_diag
        cand_diag = _band_shift(prev2, d2, 1, K, _BIG) + jnp.where(
            is_eq, 0, mismatch
        )
        cand_up = _band_shift(prev, d1, 0, K, _BIG) + gap
        cand_left = _band_shift(prev, d1, 1, K, _BIG) + gap
        diag = jnp.minimum(jnp.minimum(cand_diag, cand_up), cand_left)
        dirv = (
            (diag == cand_diag) * 1
            + (diag == cand_up) * 2
            + (diag == cand_left) * 4
            + is_eq * 8
        )
        diag = jnp.where(jj == 0, d * gap, diag)
        dirv = jnp.where(jj == 0, 2, dirv)
        row0_val = jnp.int32(0) if ends_free_b else d * gap
        row0_dir = 0 if ends_free_b else 4
        diag = jnp.where(jj == d, row0_val, diag)
        dirv = jnp.where(jj == d, row0_dir, dirv)
        diag = jnp.where(jj > d, _BIG, diag)  # i < 0: no such cell
        if ends_free_b:
            jm = d - m
            at = (jj == jm) & (jm >= 0) & (jj <= n)
            v = jnp.min(jnp.where(at, diag, _BIG), axis=-1)
            better = v < fit
            fit = jnp.minimum(fit, v)
            endj = jnp.where(better, jnp.squeeze(jm, -1), endj)
        else:
            at = (jj == n) & (d == (m + n))
            v = jnp.min(jnp.where(at, diag, _BIG), axis=-1)
            ans = jnp.minimum(ans, v)
        return (diag, prev, ans, fit, endj), dirv.astype(jnp.uint8)

    (prev, prev2, ans, fit, endj), dirs = jax.lax.scan(
        step,
        (prev, prev2, ans0, fit0, endj0),
        jnp.arange(1, T + 1, dtype=jnp.int32),
    )
    cost, end_j = (fit, endj) if ends_free_b else (ans, lens_b)

    # -- traceback over the banded plane -----------------------------------
    flat = jnp.moveaxis(dirs, 0, 1).reshape(B, T * K)

    def tb_step(carry, _):
        i, j, prev_op = carry
        active = (i > 0) if ends_free_b else ((i > 0) | (j > 0))
        d = i + j
        lane = j - base(d)
        idx = jnp.clip((d - 1) * K + jnp.clip(lane, 0, K - 1), 0, T * K - 1)
        mask = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0].astype(
            jnp.int32
        )
        diag_op = jnp.where((mask & 8) != 0, OP_EQ, OP_X)
        op = jnp.where(
            (prev_op == OP_INS) & ((mask & 2) != 0),
            OP_INS,
            jnp.where(
                (prev_op == OP_DEL) & ((mask & 4) != 0),
                OP_DEL,
                jnp.where(
                    (mask & 1) != 0,
                    diag_op,
                    jnp.where((mask & 2) != 0, OP_INS, OP_DEL),
                ),
            ),
        )
        op = jnp.where(active, op, OP_STOP)
        di = ((op == OP_EQ) | (op == OP_X) | (op == OP_INS)).astype(jnp.int32)
        dj = ((op == OP_EQ) | (op == OP_X) | (op == OP_DEL)).astype(jnp.int32)
        return (i - di, j - dj, op), op.astype(jnp.uint8)

    (_, _, _), ops_rev = jax.lax.scan(
        tb_step, (lens_a, end_j, jnp.zeros_like(lens_a)), None, length=T
    )
    ops_rev = jnp.transpose(ops_rev)
    nsteps = jnp.sum((ops_rev != OP_STOP).astype(jnp.int32), axis=1)
    tidx = nsteps[:, None] - 1 - jnp.arange(T, dtype=jnp.int32)[None, :]
    ops_fwd = jnp.where(
        tidx >= 0,
        jnp.take_along_axis(ops_rev, jnp.clip(tidx, 0, T - 1), axis=1),
        jnp.uint8(OP_STOP),
    )
    return cost, end_j, ops_fwd


@partial(jax.jit, static_argnames=("ends_free_b", "off_lo", "off_hi"))
def align_ops_codes_banded(
    codes_a: jax.Array,
    lens_a: jax.Array,
    codes_b: jax.Array,
    lens_b: jax.Array,
    mismatch=1,
    gap=1,
    ends_free_b: bool = False,
    off_lo: int = -64,
    off_hi: int = 64,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """align_ops_codes restricted to the diagonal band j - i in
    [off_lo, off_hi]: identical (cost, end_j, ops) whenever some optimal
    path stays in the band (for a GLOBAL alignment that requires
    off_lo <= min(0, n-m) and off_hi >= max(0, n-m) plus gap-excursion
    slack); traceback plane is O((M+N)·band) instead of O((M+N)·N)."""
    lens_a = jnp.asarray(lens_a, jnp.int32)
    lens_b = jnp.asarray(lens_b, jnp.int32)
    pa = jnp.arange(codes_a.shape[-1], dtype=jnp.int32)
    pb = jnp.arange(codes_b.shape[-1], dtype=jnp.int32)
    a = jnp.where(pa < lens_a[:, None], codes_a.astype(jnp.int32), _PAD_A)
    b = jnp.where(pb < lens_b[:, None], codes_b.astype(jnp.int32), _PAD_B)
    return _wavefront_tb_codes_banded(
        a, lens_a, b, lens_b, mismatch, gap, ends_free_b, off_lo, off_hi
    )


@partial(jax.jit, static_argnames=("ends_free_b",))
def align_ops(
    words_a: jax.Array,
    lens_a: jax.Array,
    words_b: jax.Array,
    lens_b: jax.Array,
    mismatch=1,
    gap=1,
    ends_free_b: bool = False,
    tie_late=None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Min-cost alignment WITH per-base operations (the CIGAR source).

    Same cost model and modes as _distance_wavefront (global when
    ends_free_b=False, fitting otherwise; identical tie rules for end_j).
    Returns (cost [B], end_j [B], ops [B, M+N] uint8): forward-order op
    codes (OP_EQ/OP_X/OP_INS/OP_DEL, OP_STOP-padded); within equal-cost
    alignments ties prefer diagonal over a-gap over b-gap at each cell.
    Compress with `cigars` / `cigar_string` on host.
    """
    lens_a = jnp.asarray(lens_a, jnp.int32)
    lens_b = jnp.asarray(lens_b, jnp.int32)
    a = _codes(words_a, lens_a, _PAD_A)
    b = _codes(words_b, lens_b, _PAD_B)
    return _wavefront_tb_codes(
        a, lens_a, b, lens_b, mismatch, gap, ends_free_b, tie_late
    )


@partial(jax.jit, static_argnames=("ends_free_b",))
def align_ops_codes(
    codes_a: jax.Array,
    lens_a: jax.Array,
    codes_b: jax.Array,
    lens_b: jax.Array,
    mismatch=1,
    gap=1,
    ends_free_b: bool = False,
    tie_late=None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """align_ops over raw int32 code arrays (mapper windows are gathered
    as codes, not packed words). Positions past each length are re-padded
    with the never-equal sentinels, so callers may pass garbage there."""
    lens_a = jnp.asarray(lens_a, jnp.int32)
    lens_b = jnp.asarray(lens_b, jnp.int32)
    pa = jnp.arange(codes_a.shape[-1], dtype=jnp.int32)
    pb = jnp.arange(codes_b.shape[-1], dtype=jnp.int32)
    a = jnp.where(pa < lens_a[:, None], codes_a.astype(jnp.int32), _PAD_A)
    b = jnp.where(pb < lens_b[:, None], codes_b.astype(jnp.int32), _PAD_B)
    return _wavefront_tb_codes(
        a, lens_a, b, lens_b, mismatch, gap, ends_free_b, tie_late
    )


def cigar_string(ops_row, eqx: bool = True) -> str:
    """Gap-compressed CIGAR of one ops row (host). eqx=True emits =/X
    (minimap2 --eqx style); False merges them into M."""
    out = []
    prev_c, run = None, 0
    for op in np.asarray(ops_row):
        if op == OP_STOP:
            break
        c = _OP_CHARS[int(op)]
        if not eqx and c in "=X":
            c = "M"
        if c == prev_c:
            run += 1
        else:
            if prev_c is not None:
                out.append(f"{run}{prev_c}")
            prev_c, run = c, 1
    if prev_c is not None:
        out.append(f"{run}{prev_c}")
    return "".join(out)


def cigars(ops, eqx: bool = True) -> list:
    """cigar_string over a [B, T] ops batch."""
    ops = np.asarray(ops)
    return [cigar_string(ops[i], eqx) for i in range(ops.shape[0])]


@jax.jit
def sw_score(
    words_a: jax.Array,
    lens_a: jax.Array,
    words_b: jax.Array,
    lens_b: jax.Array,
    match=2,
    mismatch=-3,
    gap_open=-5,
    gap_extend=-2,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Affine-gap Smith-Waterman (Gotoh) local alignment score per pair.

    Returns (score [B], end_i [B], end_j [B]): the best local score and the
    1-based end offsets of the optimal local alignment in a and b. Empty
    alignment scores 0 with ends (0, 0). Ties: smallest i+j, then smallest
    j (mirrored exactly by the oracle in tests/test_align.py).

    gap_open is the cost of a gap's FIRST base (a length-1 gap costs
    gap_open), gap_extend each additional base — all four params traced,
    so changing them does not recompile.
    """
    lens_a = jnp.asarray(lens_a, jnp.int32)
    lens_b = jnp.asarray(lens_b, jnp.int32)
    match = jnp.asarray(match, jnp.int32)
    mismatch = jnp.asarray(mismatch, jnp.int32)
    gap_open = jnp.asarray(gap_open, jnp.int32)
    gap_extend = jnp.asarray(gap_extend, jnp.int32)
    a = _codes(words_a, lens_a, _PAD_A)
    b = _codes(words_b, lens_b, _PAD_B)
    B, M = a.shape
    N = b.shape[-1]
    pos = jnp.arange(N + 1, dtype=jnp.int32)
    arp = _rev_padded(a, N + 1)
    bsh = _b_shifted(b)
    m, n = lens_a[:, None], lens_b[:, None]

    h_prev = jnp.zeros((B, N + 1), jnp.int32)  # H[0, j] = 0
    h_prev2 = jnp.zeros((B, N + 1), jnp.int32)
    e_prev = jnp.full((B, N + 1), -_BIG, jnp.int32)
    f_prev = jnp.full((B, N + 1), -_BIG, jnp.int32)
    best = jnp.zeros((B,), jnp.int32)
    end_i = jnp.zeros((B,), jnp.int32)
    end_j = jnp.zeros((B,), jnp.int32)

    def step(carry, d):
        h_prev, h_prev2, e_prev, f_prev, best, end_i, end_j = carry
        a_diag = jax.lax.dynamic_slice_in_dim(arp, N + 1 + M - d, N + 1, -1)
        s = jnp.where(a_diag == bsh, match, mismatch)
        e = jnp.maximum(
            _shift1(h_prev, -_BIG) + gap_open, _shift1(e_prev, -_BIG) + gap_extend
        )
        f = jnp.maximum(h_prev + gap_open, f_prev + gap_extend)
        h = jnp.maximum(
            jnp.maximum(_shift1(h_prev2, -_BIG) + s, jnp.int32(0)),
            jnp.maximum(e, f),
        )
        # boundary rows/columns: H = 0, no inherited gap state
        edge = (pos == 0) | (pos == d)
        h = jnp.where(edge, 0, h)
        e = jnp.where(edge, -_BIG, e)
        f = jnp.where(edge, -_BIG, f)

        i = d - pos
        in_range = (pos >= 1) & (pos <= n) & (i >= 1) & (i <= m)
        hm = jnp.where(in_range, h, -1)
        row_best = jnp.max(hm, axis=-1)
        # smallest j on this diagonal attaining row_best (masked-min idiom)
        row_j = jnp.min(
            jnp.where(hm == row_best[:, None], pos, jnp.int32(N + 1)), axis=-1
        )
        upd = row_best > best  # strict: earlier d wins ties
        best = jnp.maximum(best, row_best)
        end_j = jnp.where(upd, row_j, end_j)
        end_i = jnp.where(upd, d - row_j, end_i)
        return (h, h_prev, e, f, best, end_i, end_j), None

    (h_prev, h_prev2, e_prev, f_prev, best, end_i, end_j), _ = jax.lax.scan(
        step,
        (h_prev, h_prev2, e_prev, f_prev, best, end_i, end_j),
        jnp.arange(1, M + N + 1, dtype=jnp.int32),
        unroll=8,  # loop-overhead-bound
    )
    return best, end_i, end_j
