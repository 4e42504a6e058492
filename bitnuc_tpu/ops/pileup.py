"""Gapless pileup, consensus, and SNP calling over mapped reads.

Completes the resequencing workflow the mapper opens (map -> pile ->
call): per-reference-position base counts, a consensus sequence, and
substitution calls. The reference library has no analog (its comparison
surface stops at fixed-frame hdist, /root/reference/src/utils/functions/
hamming/multi.rs); this is north-star toolkit surface.

Formulation notes:

- The pileup is ONE dense scatter-add into a [ref_len, 4] int32 grid with
  keys (ref_start + read_offset) * 4 + code. Scatter is normally avoided
  in this codebase, but the at-scale measurement behind that rule
  (docs/DESIGN.md §4b: ~137 Mkeys/s on chip) makes it the right tool
  here — a pileup batch is a few Mbases, and the sort-based alternative
  would still need a scatter to densify per-position output. Out-of-range
  contributions (reads hanging off the reference) drop via scatter
  mode='drop'.
- Reverse-strand reads contribute their reverse complement
  (`ops.revcomp.reverse_complement_reads`), i.e. forward-reference bases,
  selected per read with a mask — no data-dependent control flow.
- Consensus/calls are elementwise over the 4 count planes with masked
  single-value reduces (ties -> smallest code; no argmax,
  docs/DESIGN.md §2).

GAPLESS: each read is laid down at its mapped start without gap
projection, the classic fast-pileup compromise — reads with indels
mis-pile downstream of the event. Callers filter those with the mapper's
alignment cost (`max_cost`), which bounds how wrong a kept read can be.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import revcomp as revcomp_ops
from ..utils import bitops


@partial(jax.jit, static_argnames=("ref_len",))
def pileup_counts(
    words: jax.Array,
    lengths: jax.Array,
    ref_start: jax.Array,
    use_rc: jax.Array,
    keep: jax.Array,
    ref_len: int,
) -> jax.Array:
    """Base counts per forward-reference position: [ref_len, 4] int32.

    words/lengths: the reads AS READ (forward orientation); reads with
    use_rc[i] True contribute their reverse complement, matching
    mapper.map_reads' strand convention. keep masks reads out entirely
    (unmapped / cost-filtered). ref_start may be negative or beyond the
    reference (clamped contributions drop).
    """
    lengths = jnp.asarray(lengths, jnp.int32)
    rc_words = revcomp_ops.reverse_complement_reads(words, lengths)
    w = jnp.where(jnp.asarray(use_rc, bool)[:, None], rc_words, words)
    codes = bitops.unpack_words(w).astype(jnp.int32)  # [B, L]
    L = codes.shape[-1]
    pos = jnp.arange(L, dtype=jnp.int32)
    gpos = jnp.asarray(ref_start, jnp.int32)[:, None] + pos
    valid = (
        jnp.asarray(keep, bool)[:, None]
        & (pos < lengths[:, None])
        & (gpos >= 0)
        & (gpos < ref_len)
    )
    key = jnp.where(valid, gpos * 4 + codes, 4 * ref_len)  # OOB -> dropped
    flat = jnp.zeros((4 * ref_len,), jnp.int32)
    flat = flat.at[key.reshape(-1)].add(
        valid.reshape(-1).astype(jnp.int32), mode="drop"
    )
    return flat.reshape(ref_len, 4)


@jax.jit
def consensus_calls(
    counts: jax.Array,
    ref_words: jax.Array,
    min_depth=1,
    min_frac=0.5,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Consensus + substitution calls from a pileup grid.

    counts: [ref_len, 4] int32 (pileup_counts). ref_words: packed
    reference covering ref_len bases. min_depth/min_frac are traced
    (no recompile when tuning).

    Returns (cons [ref_len] int32, depth [ref_len] int32,
    is_variant [ref_len] bool, support [ref_len] int32):
      cons — the majority base code where depth >= min_depth and the
        winner's fraction >= min_frac, else the reference code (ties
        break to the smallest code, deterministically);
      support — the winning base's count.
    """
    ref_len = counts.shape[0]
    refc = (
        bitops.unpack_words(ref_words.reshape(1, -1))
        .astype(jnp.int32)
        .reshape(-1)[:ref_len]
    )
    depth = jnp.sum(counts, axis=-1)
    best = jnp.max(counts, axis=-1)
    code = jnp.arange(4, dtype=jnp.int32)
    winner = jnp.min(
        jnp.where(counts == best[:, None], code, jnp.int32(4)), axis=-1
    )
    confident = (depth >= jnp.asarray(min_depth, jnp.int32)) & (
        best.astype(jnp.float32)
        >= jnp.asarray(min_frac, jnp.float32) * depth.astype(jnp.float32)
    )
    cons = jnp.where(confident, winner, refc)
    is_variant = confident & (winner != refc)
    return cons, depth, is_variant, best


@partial(jax.jit, static_argnames=("ref_len",))
def pileup_counts_ops(
    words: jax.Array,
    lengths: jax.Array,
    ref_start: jax.Array,
    use_rc: jax.Array,
    keep: jax.Array,
    ops: jax.Array,
    ref_len: int,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Indel-aware pileup: project each read through its ALIGNMENT OPS
    (mapper.traceback_cigars' forward-order op codes) instead of laying it
    down gaplessly.

    Per op t of read r the reference coordinate is ref_start[r] plus the
    count of reference-consuming ops before t (one exclusive cumsum), and
    the query base is the read's oriented code at the count of query-
    consuming ops before t (one bounded row gather). Three scatter-adds:
      counts [ref_len, 4] — aligned bases (OP_EQ/OP_X), matching
        pileup_counts for indel-free reads exactly;
      dels [ref_len]      — reads deleting that reference base (OP_DEL);
      ins  [ref_len]      — insertion events anchored BEFORE that
        reference position (OP_INS runs count once per base).
    """
    from . import align as align_mod

    lengths = jnp.asarray(lengths, jnp.int32)
    rc_words = revcomp_ops.reverse_complement_reads(words, lengths)
    w = jnp.where(jnp.asarray(use_rc, bool)[:, None], rc_words, words)
    codes = bitops.unpack_words(w).astype(jnp.int32)  # [B, L]
    L = codes.shape[-1]

    op = jnp.asarray(ops, jnp.int32)  # [B, T]
    is_base = (op == align_mod.OP_EQ) | (op == align_mod.OP_X)
    q_cons = (is_base | (op == align_mod.OP_INS)).astype(jnp.int32)
    r_cons = (is_base | (op == align_mod.OP_DEL)).astype(jnp.int32)
    q_idx = jnp.cumsum(q_cons, axis=1) - q_cons  # exclusive
    r_pos = (
        jnp.asarray(ref_start, jnp.int32)[:, None]
        + jnp.cumsum(r_cons, axis=1)
        - r_cons
    )
    base = jnp.take_along_axis(codes, jnp.clip(q_idx, 0, L - 1), axis=1)

    live = jnp.asarray(keep, bool)[:, None] & (r_pos >= 0) & (r_pos < ref_len)
    bvalid = live & is_base
    key = jnp.where(bvalid, r_pos * 4 + base, 4 * ref_len)
    flat = jnp.zeros((4 * ref_len,), jnp.int32)
    flat = flat.at[key.reshape(-1)].add(
        bvalid.reshape(-1).astype(jnp.int32), mode="drop"
    )

    dvalid = live & (op == align_mod.OP_DEL)
    dels = jnp.zeros((ref_len,), jnp.int32)
    dels = dels.at[jnp.where(dvalid, r_pos, ref_len).reshape(-1)].add(
        dvalid.reshape(-1).astype(jnp.int32), mode="drop"
    )

    # one event per insertion RUN: the run's first op (previous op differs)
    prev_op = jnp.concatenate([jnp.zeros_like(op[:, :1]), op[:, :-1]], axis=1)
    ivalid = live & (op == align_mod.OP_INS) & (prev_op != align_mod.OP_INS)
    ins = jnp.zeros((ref_len,), jnp.int32)
    ins = ins.at[jnp.where(ivalid, r_pos, ref_len).reshape(-1)].add(
        ivalid.reshape(-1).astype(jnp.int32), mode="drop"
    )
    return flat.reshape(ref_len, 4), dels, ins


def _insertion_consensus(reads, map_result, ops_np, keep, anchors):
    """Majority inserted sequence per called anchor, from host replays of
    the supporting reads' op rows (metadata scale: only reads with any
    insertion op are touched)."""
    from collections import Counter

    from . import align as align_mod
    from . import codec as codec_mod
    from . import revcomp as revcomp_ops2

    anchors = set(int(a) for a in anchors)
    if not anchors:
        return {}
    has_ins = (ops_np == align_mod.OP_INS).any(axis=1) & np.asarray(keep)
    rows = np.nonzero(has_ins)[0]
    if rows.size == 0:
        return {}
    import jax.numpy as jnp2

    rc_words = revcomp_ops2.reverse_complement_reads(
        jnp2.asarray(reads.words[rows]), jnp2.asarray(reads.lengths[rows])
    )
    use_rc = np.asarray(map_result["strand"] == b"-")[rows]
    w = np.where(use_rc[:, None], np.asarray(rc_words), np.asarray(reads.words[rows]))
    from ..utils import bitops as bitops2

    codes = np.asarray(bitops2.unpack_words(jnp2.asarray(w)))
    rs = np.asarray(map_result["ref_start"], np.int64)[rows]
    seqs_at = {}
    base = b"ACGT"
    for rr, row in enumerate(rows):
        op = ops_np[row]
        qc = np.cumsum(
            (op == align_mod.OP_EQ) | (op == align_mod.OP_X)
            | (op == align_mod.OP_INS)
        )
        rc = np.cumsum((op == align_mod.OP_EQ) | (op == align_mod.OP_X)
                       | (op == align_mod.OP_DEL))
        t = 0
        T = len(op)
        while t < T and op[t] != align_mod.OP_STOP:
            if op[t] == align_mod.OP_INS:
                # rc is inclusive; ops before t consumed rc[t-1] ref bases
                anchor = int(rs[rr] + (rc[t - 1] if t else 0))
                t0 = t
                while t < T and op[t] == align_mod.OP_INS:
                    t += 1
                if anchor in anchors:
                    q0 = int(qc[t0 - 1] if t0 else 0)
                    seq = bytes(base[c] for c in codes[rr, q0 : q0 + (t - t0)])
                    seqs_at.setdefault(anchor, Counter())[seq] += 1
            else:
                t += 1
    return {
        a: cnt.most_common(1)[0][0] for a, cnt in seqs_at.items()
    }


def call_variants(
    index,
    reads,
    map_result: dict,
    max_cost: int = 8,
    min_depth: int = 2,
    min_frac: float = 0.5,
    cigar: bool = False,
    ops=None,
) -> dict:
    """Host convenience: pileup + calls from mapper outputs.

    index: MinimizerIndex (supplies ref_words/ref_len). reads: the
    PackedReads that were mapped. map_result: mapper.map_reads(...) dict.
    Returns numpy arrays {counts [ref_len,4], depth, consensus (codes),
    variant_pos, variant_ref, variant_alt, variant_depth,
    variant_support} — the variant_* arrays list only called sites.

    cigar=True projects reads through their per-base alignment ops
    (mapper.traceback_cigars — pass `ops` to reuse an existing traceback)
    instead of the gapless layout, and ADDITIONALLY calls indels:
      del_pos/del_len/del_support/del_depth — deletion events (0-based
        start of the deleted run, merged across consecutive positions);
      ins_pos/ins_seq/ins_support/ins_depth — insertion events (0-based
        anchor = reference position the insertion precedes; ins_seq is
        the majority inserted sequence among supporting reads).
    """
    keep = map_result["mapped"] & (map_result["cost"] <= max_cost)
    dels = ins = ops_np = None
    if cigar:
        if ops is None:
            from .. import mapper as mapper_mod

            ops = mapper_mod.traceback_cigars(index, reads, map_result)["ops"]
        ops_np = np.asarray(ops)
        counts, dels, ins = pileup_counts_ops(
            reads.words,
            reads.lengths,
            jnp.asarray(map_result["ref_start"], jnp.int32),
            jnp.asarray(map_result["strand"] == b"-"),
            jnp.asarray(keep),
            jnp.asarray(ops_np),
            index.ref_len,
        )
        dels = np.asarray(dels)
        ins = np.asarray(ins)
    else:
        counts = pileup_counts(
            reads.words,
            reads.lengths,
            jnp.asarray(map_result["ref_start"], jnp.int32),
            jnp.asarray(map_result["strand"] == b"-"),
            jnp.asarray(keep),
            index.ref_len,
        )
    cons, depth, is_var, support = consensus_calls(
        counts,
        jnp.asarray(index.ref_words),
        np.int32(min_depth),
        np.float32(min_frac),
    )
    counts = np.asarray(counts)
    cons = np.asarray(cons)
    depth = np.asarray(depth)
    support = np.asarray(support)
    vpos = np.nonzero(np.asarray(is_var))[0]
    rw = np.asarray(index.ref_words, np.uint32)
    shifts = np.arange(16, dtype=np.uint32) * 2
    refc = ((rw[:, None] >> shifts[None, :]) & 3).reshape(-1)[
        : index.ref_len
    ].astype(np.int32)
    out = {
        "counts": counts,
        "depth": depth,
        "consensus": cons,
        "variant_pos": vpos.astype(np.int64),
        "variant_ref": refc[vpos],
        "variant_alt": cons[vpos],
        "variant_depth": depth[vpos],
        "variant_support": support[vpos],
    }
    if cigar:
        md = int(min_depth)
        # deletion: a read spanning the position either contributes a base
        # (depth) or a deletion (dels); call when the deletion allele wins
        cover_d = depth + dels
        del_call = (dels >= md) & (
            dels.astype(np.float64) >= min_frac * np.maximum(cover_d, 1)
        )
        # merge consecutive called positions into events
        starts = np.nonzero(del_call & ~np.concatenate([[False], del_call[:-1]]))[0]
        d_pos, d_len, d_sup, d_dep = [], [], [], []
        for p0 in starts:
            p1 = p0
            while p1 + 1 < del_call.shape[0] and del_call[p1 + 1]:
                p1 += 1
            d_pos.append(int(p0))
            d_len.append(int(p1 - p0 + 1))
            d_sup.append(int(dels[p0:p1 + 1].min()))
            d_dep.append(int(cover_d[p0:p1 + 1].max()))
        out["del_pos"] = np.asarray(d_pos, np.int64)
        out["del_len"] = np.asarray(d_len, np.int64)
        out["del_support"] = np.asarray(d_sup, np.int64)
        out["del_depth"] = np.asarray(d_dep, np.int64)

        # insertion: supporting reads carry an OP_INS run at the anchor
        cover_i = depth + ins
        ins_call = (ins >= md) & (
            ins.astype(np.float64) >= min_frac * np.maximum(cover_i, 1)
        )
        anchors = np.nonzero(ins_call)[0]
        seqs = _insertion_consensus(reads, map_result, ops_np, keep, anchors)
        i_pos = [int(a) for a in anchors if int(a) in seqs]
        out["ins_pos"] = np.asarray(i_pos, np.int64)
        out["ins_seq"] = [seqs[a] for a in i_pos]
        out["ins_support"] = np.asarray([int(ins[a]) for a in i_pos], np.int64)
        out["ins_depth"] = np.asarray(
            [int(cover_i[a]) for a in i_pos], np.int64
        )
        out["dels"] = dels
        out["ins"] = ins
    return out


def pileup_counts_sharded(
    words,
    lengths,
    ref_start,
    use_rc,
    keep,
    ref_len: int,
    mesh,
    axis: str = "data",
):
    """Data-parallel pileup: reads sharded over `axis`, ONE psum of the
    [ref_len, 4] grid per batch (the same merge shape as the sharded
    k-mer histograms — traffic independent of batch size). Results match
    pileup_counts exactly."""
    from jax.sharding import PartitionSpec as P

    n = mesh.shape[axis]
    B = words.shape[0]
    assert B % n == 0, f"mesh axis size {n} must divide batch {B}"

    def local(wd, ln, rs, rc_, kp):
        grid = pileup_counts(wd, ln, rs, rc_, kp, ref_len)
        return jax.lax.psum(grid, axis)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(),
        check_vma=False,
    )(
        words,
        jnp.asarray(lengths, jnp.int32),
        jnp.asarray(ref_start, jnp.int32),
        jnp.asarray(use_rc, bool),
        jnp.asarray(keep, bool),
    )
