"""K-mer count-set algebra: intersect / subtract / union over two counted
k-mer lists (the `kmc_tools simple` operation family, built on the
reference's packed k-mer value semantics, /root/reference/README.md:164-180).

Inputs are "counted lists": (lo [N] uint32, hi [N] uint32, ct [N] int32)
where every row with ct > 0 carries a DISTINCT packed k-mer key — exactly
what count_kmers_sorted, count_kmers_runs, and merge_sorted_runs produce
(run-start zeros and sentinel padding rows are ct == 0 and are ignored).

Formulation (no scatter, no gather, docs/DESIGN.md §7):
tag each row with its source (A=0, B=1, dead=2), push dead rows' keys to
the all-ones sentinel, and sort once on (hi, lo, src, -ct). Every key then
occupies 1-2 adjacent rows with A first, so the combine is a pure
neighbor-compare; a second sort on (sentineled key, -ct) compacts live
results ascending. The genuine k=32 all-T key (equal to the sentinel) stays
correct because dead rows sort AFTER any live row of the same key (src=2)
and the compaction orders by negated count, the same guarantee the
streaming accumulator relies on (pipeline._merge_runs_device).

Count semantics (KMC parity):
  intersect_min: keys in both, count = min(a, b)
  subtract:      A counts minus B counts, clamped at 0 (key dropped at 0)
  union_sum:     all keys, counts added (== merge_sorted_runs content)
  union_max:     all keys, count = max(a, b)
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

MODES = ("intersect_min", "subtract", "union_sum", "union_max")


def combine_counts(
    a_lo: jax.Array,
    a_hi: jax.Array,
    a_ct: jax.Array,
    b_lo: jax.Array,
    b_hi: jax.Array,
    b_ct: jax.Array,
    mode: str = "intersect_min",
    compact: bool = True,
    validate: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Combine two counted SORTED k-mer lists -> (lo, hi, ct, n_unique).

    CONTRACT: each input's live rows are ascending by (hi, lo) — the
    layout every producer in this package emits (count_kmers_sorted,
    count_kmers_runs, compact_runs, this function's own outputs). The
    full sort absorbs an unsorted input today, but a merge of the two
    sorted halves would not, so callers must keep it. validate=True checks
    both inputs host-side first (one pass + a device sync — for debugging, not
    hot loops) and raises ValueError on a violation.

    The output has static length len(A) + len(B). compact=True (default):
    entries [0, n_unique) are the distinct result keys ascending by
    (hi, lo) with positive counts, the tail is all-ones-key / zero-count
    padding. compact=False skips the compaction sort: keys are still
    ascending but zero-count rows INTERLEAVE with live ones (the run-start
    convention, ops.kmer) — a legal input to further combine_counts calls
    and to ops.kmer.compact_runs, and the form for combine CHAINS: it
    skips the compaction sort (docs/DESIGN.md 6b).
    """
    if validate:
        import numpy as np

        for lo, hi, ct, nm in (
            (a_lo, a_hi, a_ct, "A"),
            (b_lo, b_hi, b_ct, "B"),
        ):
            key = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | (
                np.asarray(lo).astype(np.uint64)
            )
            live = np.nonzero(np.asarray(ct) > 0)[0]
            end = int(live[-1]) + 1 if live.size else 0
            # sorted through the last live row (the all-dead suffix may
            # carry arbitrary padding keys — it remaps to the sentinel)
            if end > 1 and not bool(np.all(key[1:end] >= key[: end - 1])):
                raise ValueError(
                    f"combine_counts input {nm} is not sorted by (hi, lo) "
                    "through its live rows — the sorted-input contract is "
                    "load-bearing on the merge-engine backend"
                )
    return _combine_counts(a_lo, a_hi, a_ct, b_lo, b_hi, b_ct, mode, compact)


@partial(jax.jit, static_argnames=("mode", "compact"))
def _combine_counts(
    a_lo: jax.Array,
    a_hi: jax.Array,
    a_ct: jax.Array,
    b_lo: jax.Array,
    b_hi: jax.Array,
    b_ct: jax.Array,
    mode: str = "intersect_min",
    compact: bool = True,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    assert mode in MODES, f"mode must be one of {MODES}"
    sent = jnp.uint32(0xFFFFFFFF)

    a_ct = jnp.asarray(a_ct, jnp.int32)
    b_ct = jnp.asarray(b_ct, jnp.int32)
    n_ab = a_ct.shape[0] + b_ct.shape[0]

    # Dead-row handling that keeps the raw output arrays independent of
    # dead rows' keys (tests/test_setops.py). Dead rows
    # (ct <= 0) come in two shapes, both kept sorted here: an all-dead
    # SUFFIX (the compact layouts' padding, whose keys are arbitrary)
    # remaps to the all-ones sentinel; INTERIOR dead rows (the run-start
    # layout: a dead slot duplicates its run's key) keep their keys and
    # ride behind their key's live rows via the src key word
    # (A-live 0 < B-live 1 < dead 2). A list that is unsorted even
    # counting its dead rows violates the function's sorted-input
    # contract either way.
    def _side(hi_x, lo_x, ct_x, live_src):
        dead = ct_x <= 0
        sfx = (
            jnp.flip(jax.lax.cummin(jnp.flip(dead.astype(jnp.int32))))
            == 1
        )
        return (
            jnp.where(sfx, sent, hi_x),
            jnp.where(sfx, sent, lo_x),
            jnp.where(dead, jnp.uint32(2), jnp.uint32(live_src)),
            jnp.where(dead, 0, ct_x),
        )

    a_side = _side(a_hi, a_lo, a_ct, 0)
    b_side = _side(b_hi, b_lo, b_ct, 1)
    hi_s, lo_s, src_w, ct_s = jax.lax.sort(
        tuple(jnp.concatenate([x, y]) for x, y in zip(a_side, b_side)),
        num_keys=3,
    )
    src_s = src_w.astype(jnp.int32)

    # neighbor pairing: a live A row whose successor is a live B row with
    # the same key holds that key's (a, b) count pair
    nxt = lambda x: jnp.concatenate([x[1:], x[:1]])  # last row pads itself;
    # it can never pair (same_key forces src transition 0 -> 1)
    same_key = (hi_s == nxt(hi_s)) & (lo_s == nxt(lo_s))
    pair = same_key & (src_s == 0) & (nxt(src_s) == 1)
    consumed = jnp.concatenate([jnp.zeros((1,), bool), pair[:-1]])
    b_ct_here = jnp.where(pair, nxt(ct_s), 0)

    if mode == "intersect_min":
        out = jnp.where(pair, jnp.minimum(ct_s, b_ct_here), 0)
        out = jnp.where(src_s == 0, out, 0)
    elif mode == "subtract":
        out = jnp.where(src_s == 0, jnp.maximum(ct_s - b_ct_here, 0), 0)
    elif mode == "union_sum":
        out = jnp.where(src_s == 0, ct_s + b_ct_here, ct_s)
        out = jnp.where((src_s == 1) & consumed, 0, out)
        out = jnp.where(src_s == 2, 0, out)
    else:  # union_max
        out = jnp.where(src_s == 0, jnp.maximum(ct_s, b_ct_here), ct_s)
        out = jnp.where((src_s == 1) & consumed, 0, out)
        out = jnp.where(src_s == 2, 0, out)

    out_dead = out <= 0
    if not compact:
        # merged order already has keys ascending with dead rows
        # interleaved (pad rows sort strictly last: their src key word is
        # all-ones); zero the dead counts and slice the real rows
        return (
            lo_s[:n_ab],
            hi_s[:n_ab],
            jnp.where(out_dead, 0, out)[:n_ab],
            jnp.sum((~out_dead).astype(jnp.int32)),
        )
    # compact live rows ascending (dead -> sentinel key, negated counts as
    # the tiebreak so a live all-T row beats dead rows at the cap boundary)
    hi_c, lo_c, neg_c = jax.lax.sort(
        (
            jnp.where(out_dead, sent, hi_s),
            jnp.where(out_dead, sent, lo_s),
            -out,
        ),
        num_keys=3,
    )
    # engine path works on pow2-padded arrays; live rows <= len(A)+len(B)
    # always, so the contract's static length survives the slice
    return (
        lo_c[:n_ab],
        hi_c[:n_ab],
        -neg_c[:n_ab],
        jnp.sum((~out_dead).astype(jnp.int32)),
    )


# tests toggle backends and re-trace: expose the impl's cache control on
# the public wrapper (the wrapper itself is not jitted)
combine_counts.clear_cache = _combine_counts.clear_cache


def combine_dicts(a: dict, b: dict, mode: str = "intersect_min") -> dict:
    """Host-dict reference/convenience twin of combine_counts (the layout
    pipeline.count_fastq returns for large k)."""
    assert mode in MODES, f"mode must be one of {MODES}"
    if mode == "intersect_min":
        return {
            k: min(a[k], b[k]) for k in a.keys() & b.keys()
        }
    if mode == "subtract":
        out = {k: v - b.get(k, 0) for k, v in a.items()}
        return {k: v for k, v in out.items() if v > 0}
    if mode == "union_sum":
        out = dict(a)
        for k, v in b.items():
            out[k] = out.get(k, 0) + v
        return out
    out = dict(a)
    for k, v in b.items():
        out[k] = max(out.get(k, 0), v)
    return out
