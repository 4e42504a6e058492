"""Distributed k-mer counting.

Two sharding regimes, both producing histograms identical to the single-device
result (and to the reference README's HashMap semantics, README.md:164-180):

  * batch-sharded (DP): each device counts its slab of reads into a local
    dense histogram, merged with one psum. The merge is O(4^k)
    per device regardless of batch size, so scaling is linear in reads.

  * sequence-sharded (SP analog): one very long sequence's packed words are
    sharded along the word axis; windows crossing a shard edge need the first
    ceil((k-1)/16) words of the right neighbor — a halo exchange via
    ppermute (the device analog of the reference's cross-word carry handling,
    src/utils/functions/split.rs:83-94, lifted to the device level).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import kmer as kmer_ops
from ..utils import bitops

HALO_WORDS = 2  # ceil((k-1)/16) for k <= 32


@partial(jax.jit, static_argnames=("k", "mesh", "axis", "mode", "canonical"))
def count_kmers_sharded(
    words: jax.Array,
    lengths: jax.Array,
    k: int,
    mesh: Mesh,
    axis: str = "data",
    mode: str = "auto",
    canonical: bool = False,
    base_valid=None,
) -> jax.Array:
    """Dense k-mer histogram over a batch sharded on `axis`.

    words: [B, W] uint32 (B divisible by mesh axis size), lengths: [B].
    Returns a replicated [4^k] int32 histogram == the single-device result.
    mode: 'auto' (MXU histogram for k <= MAX_MXU_K, scatter-dense above),
    'mxu', or 'dense'; k <= MAX_DENSE_K (dense merge via one psum — use
    count_kmers_sorted_sharded beyond). base_valid: optional [B, L] bool
    (sharded alongside the batch) dropping windows that touch an
    N/ambiguous base — the distributed on_invalid='skip' path.
    """
    assert k <= kmer_ops.MAX_DENSE_K
    if mode == "auto":
        mode = "mxu" if k <= kmer_ops.MAX_MXU_K else "dense"

    def local(words_loc, lengths_loc, *bv_loc):
        hist = kmer_ops.count_kmers_reads(
            words_loc, lengths_loc, k, mode=mode, canonical=canonical,
            base_valid=bv_loc[0] if bv_loc else None,
        )
        return jax.lax.psum(hist, axis)

    in_specs = [P(axis, None), P(axis)]
    args = [words, lengths]
    if base_valid is not None:
        in_specs.append(P(axis, None))
        args.append(base_valid)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=P(),
        check_vma=False,
    )(*args)


def _allgather_merge_sorted(lo, hi, counts, axis):
    """Merge per-device sorted (key, count) lists into the replicated global
    list: all_gather, push zero-count padding rows to the sentinel so they
    fold into the tail, then one more sort + gather-free weighted run
    aggregation (ops.kmer.weighted_runs_from_sorted, scatter-free). Output is RUN-START layout:
    keys ascending, each distinct key's total at its first slot, zeros
    elsewhere; dead (sentinel) runs total 0."""
    lo_g = jax.lax.all_gather(lo, axis).reshape(-1)
    hi_g = jax.lax.all_gather(hi, axis).reshape(-1)
    ct_g = jax.lax.all_gather(counts, axis).reshape(-1)
    return kmer_ops.merge_sorted_runs(lo_g, hi_g, ct_g)


@partial(jax.jit, static_argnames=("k", "mesh", "axis", "canonical"))
def count_kmers_sorted_sharded(
    words: jax.Array,
    lengths: jax.Array,
    k: int,
    mesh: Mesh,
    axis: str = "data",
    canonical: bool = False,
    base_valid=None,
):
    """Sparse (sorted) k-mer counting over a sharded batch, any k <= 32.

    Each device sort-counts its slab (the scatter-free runs engine); the
    per-device lists are all-gathered and merged with one more sort +
    weighted run aggregation. Traffic is O(devices * windows_per_device)
    keys — the dense psum path is cheaper whenever 4^k fits in memory.
    Returns replicated (lo, hi, counts, n_unique) in RUN-START layout
    (ops.kmer.count_kmers_runs contract; ops.kmer.compact_runs densifies).
    base_valid: optional [B, L] bool sharded alongside (N-skip windows).
    """

    def local(words_loc, lengths_loc, *bv_loc):
        # scatter-free runs engine locally; run-start layout merges fine
        # because zero-count (non-start / sentinel) rows fold into the tail
        lo, hi, counts, _ = kmer_ops.count_kmers_runs(
            words_loc, lengths_loc, k, canonical,
            base_valid=bv_loc[0] if bv_loc else None,
        )
        return _allgather_merge_sorted(lo, hi, counts, axis)

    in_specs = [P(axis, None), P(axis)]
    args = [words, lengths]
    if base_valid is not None:
        in_specs.append(P(axis, None))
        args.append(base_valid)

    # every device computes the identical merge from the all_gathered lists;
    # that replication isn't statically inferable, hence check_vma=False
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )(*args)


@partial(jax.jit, static_argnames=("k", "mesh", "axis", "canonical"))
def raw_window_keys_sharded(
    words: jax.Array,
    lengths: jax.Array,
    k: int,
    mesh: Mesh,
    axis: str = "data",
    canonical: bool = False,
    base_valid=None,
):
    """Per-device raw window keys of a sharded batch, kept SHARDED on `axis`.

    The streaming-accumulator feed for distributed large-k counting
    (pipeline.count_fastq(mesh=...) at k > MAX_DENSE_K): each device
    extracts its own slab's keys with zero communication; the LSM merge
    (merge_runs_sharded) and the single end-of-job gather
    (gather_runs_sharded) do the rest. Returns (lo, hi, weight) flat
    arrays sharded on `axis`; weight 0 marks invalid/padding slots.
    base_valid: optional [B, L] bool, sharded alongside — drops windows
    touching N/ambiguous bases (distributed on_invalid='skip')."""

    def local(words_loc, lengths_loc, *bv_loc):
        return kmer_ops.raw_window_keys(
            words_loc, lengths_loc, k, canonical,
            bv_loc[0] if bv_loc else None,
        )

    in_specs = [P(axis, None), P(axis)]
    args = [words, lengths]
    if base_valid is not None:
        in_specs.append(P(axis, None))
        args.append(base_valid)
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=tuple(in_specs),
        out_specs=(P(axis), P(axis), P(axis)),
        check_vma=False,
    )(*args)


def sparse_state_sharded(cap: int, mesh: Mesh, axis: str = "data"):
    """Empty per-device run-list accumulator state: 3 arrays of global
    length n_devices * cap sharded on `axis` (every device owns `cap`
    sentinel rows). The distributed twin of pipeline._SparseAcc's state."""
    import jax.numpy as jnp

    n = mesh.shape[axis] * int(cap)
    shd = NamedSharding(mesh, P(axis))

    @partial(jax.jit, out_shardings=(shd, shd, shd))
    def mk():
        return (
            jnp.full(n, 0xFFFFFFFF, jnp.uint32),
            jnp.full(n, 0xFFFFFFFF, jnp.uint32),
            jnp.zeros(n, jnp.int32),
        )

    return mk()


@partial(jax.jit, static_argnames=("cap", "mesh", "axis"))
def merge_runs_sharded(parts, cap: int, mesh: Mesh, axis: str = "data"):
    """One LSM merge step, independently per device (NO communication):
    each device concatenates its local slices of every (lo, hi, count)
    part, merges them with the scan-free weighted-run scheme
    (ops.kmer.merge_sorted_runs), compacts live runs to its first `cap`
    rows, and reports its unique-run count. Returns (new_state 3-tuple
    sharded on `axis`, replicated max per-device n_unique — the capacity-
    doubling signal). Mirrors pipeline._merge_runs_device per shard."""
    import jax.numpy as jnp

    def local(*flat):
        ps = [flat[i : i + 3] for i in range(0, len(flat), 3)]
        lo = jnp.concatenate([p[0] for p in ps])
        hi = jnp.concatenate([p[1] for p in ps])
        ct = jnp.concatenate([p[2].astype(jnp.int32) for p in ps])
        lo_u, hi_u, tot, n_u = kmer_ops.merge_sorted_runs(lo, hi, ct)
        sent = jnp.uint32(0xFFFFFFFF)
        dead = tot == 0
        # compaction sort with NEGATED totals as the third key: live runs
        # order ascending by key; a genuine all-ones key (k=32 poly-T)
        # sorts ahead of dead sentinel rows (see pipeline._merge_runs_device)
        hi_c, lo_c, neg_c = jax.lax.sort(
            (jnp.where(dead, sent, hi_u), jnp.where(dead, sent, lo_u), -tot),
            num_keys=3,
        )
        n_max = jax.lax.pmax(n_u, axis)
        return lo_c[:cap], hi_c[:cap], -neg_c[:cap], n_max

    flat = [a for p in parts for a in p]
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=tuple(P(axis) for _ in flat),
        out_specs=(P(axis), P(axis), P(axis), P()),
        check_vma=False,
    )(*flat)


@partial(jax.jit, static_argnames=("new_cap", "mesh", "axis"))
def grow_state_sharded(state, new_cap: int, mesh: Mesh, axis: str = "data"):
    """Double a sharded accumulator's PER-DEVICE capacity: each device pads
    its own rows with sentinels (padding the global array would hand all
    the new space to the last device)."""
    import jax.numpy as jnp

    def local(lo, hi, ct):
        pad = new_cap - lo.shape[0]
        return (
            jnp.concatenate([lo, jnp.full(pad, 0xFFFFFFFF, jnp.uint32)]),
            jnp.concatenate([hi, jnp.full(pad, 0xFFFFFFFF, jnp.uint32)]),
            jnp.concatenate([ct, jnp.zeros(pad, jnp.int32)]),
        )

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis),) * 3,
        out_specs=(P(axis),) * 3,
        check_vma=False,
    )(*state)


@partial(jax.jit, static_argnames=("mesh", "axis"))
def gather_runs_sharded(lo, hi, counts, mesh: Mesh, axis: str = "data"):
    """Final fold of a sharded sparse accumulator: ONE all_gather + sort +
    weighted run aggregation merges every device's run list into the
    replicated global (lo, hi, counts, n_unique) run-start list — the
    only communication the distributed large-k streaming path ever does."""

    def local(lo_l, hi_l, ct_l):
        return _allgather_merge_sorted(lo_l, hi_l, ct_l, axis)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis),) * 3,
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )(lo, hi, counts)


@partial(jax.jit, static_argnames=("k", "mesh", "axis"))
def count_kmers_seqsharded(
    words: jax.Array,
    total_len: jax.Array,
    k: int,
    mesh: Mesh,
    axis: str = "seq",
) -> jax.Array:
    """Dense k-mer histogram of ONE long sequence sharded along its words.

    words: [Wtot] uint32, Wtot divisible by the mesh axis size; total_len:
    scalar int32 total bases. Windows crossing shard boundaries are covered by
    a (k-1)-base halo fetched from the right neighbor (ppermute).
    Returns a replicated [4^k] int32 histogram.
    """
    # dense bins (and u32 lo keys) cap this path at MAX_DENSE_K
    assert k <= kmer_ops.MAX_DENSE_K, f"seq-sharded dense capped at k={kmer_ops.MAX_DENSE_K}"
    n_shards = mesh.shape[axis]

    def local(words_loc):
        # words_loc: [W_loc] on each shard
        W_loc = words_loc.shape[0]
        me = jax.lax.axis_index(axis)
        # halo: first HALO_WORDS words of the right neighbor (wraps at the
        # end; the wrapped halo is masked out by the validity window below)
        perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
        halo = jax.lax.ppermute(words_loc[:HALO_WORDS], axis, perm)
        ext = jnp.concatenate([words_loc, halo])  # [W_loc + HALO_WORDS]

        codes = bitops.unpack_words(ext[None, :])  # [1, 16*(W_loc+H)]
        L_ext = codes.shape[-1]
        lo, _ = kmer_ops.kmer_keys(codes, k)

        base0 = me.astype(jnp.int32) * (W_loc * bitops.BASES_PER_WORD)
        pos = jnp.arange(L_ext, dtype=jnp.int32)
        # window must start in my shard and fit within the global sequence
        valid = (pos < W_loc * bitops.BASES_PER_WORD) & (
            base0 + pos <= jnp.asarray(total_len, jnp.int32) - k
        )
        keys = jnp.where(valid[None, :], lo, 0).reshape(-1).astype(jnp.int32)
        wts = valid.astype(jnp.int32).reshape(-1)
        hist = jnp.zeros(4**k, jnp.int32).at[keys].add(wts)
        return jax.lax.psum(hist, axis)

    return jax.shard_map(
        local, mesh=mesh, in_specs=P(axis), out_specs=P(), check_vma=False
    )(words)


@partial(jax.jit, static_argnames=("k", "mesh", "axis"))
def count_kmers_seqsharded_sorted(
    words: jax.Array,
    total_len: jax.Array,
    k: int,
    mesh: Mesh,
    axis: str = "seq",
):
    """Sparse (sorted) k-mer counting of ONE long sequence sharded along its
    words — the large-k (k <= 32) twin of count_kmers_seqsharded, covering
    the headline k=21 workload at pod scale.

    words: [Wtot] uint32, Wtot divisible by the mesh axis size; total_len:
    scalar int32 total bases. Windows crossing shard boundaries are covered
    by the same (k-1)-base ppermute halo (HALO_WORDS = 2 words = 32 bases
    suffices for k <= 32); each shard sort-counts its own windows and the
    per-shard lists merge with one all_gather + sort + weighted run
    aggregation. Returns replicated (lo, hi, counts, n_unique) in RUN-START
    layout (ops.kmer.count_kmers_runs contract), same (key -> count)
    content as the unsharded result.
    """
    n_shards = mesh.shape[axis]

    def local(words_loc):
        W_loc = words_loc.shape[0]
        me = jax.lax.axis_index(axis)
        perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
        halo = jax.lax.ppermute(words_loc[:HALO_WORDS], axis, perm)
        ext = jnp.concatenate([words_loc, halo])  # [W_loc + HALO_WORDS]

        codes = bitops.unpack_words(ext[None, :])
        L_ext = codes.shape[-1]
        lo, hi = kmer_ops.kmer_keys(codes, k)

        base0 = me.astype(jnp.int32) * (W_loc * bitops.BASES_PER_WORD)
        pos = jnp.arange(L_ext, dtype=jnp.int32)
        # window must start in my shard and fit within the global sequence
        valid = (pos < W_loc * bitops.BASES_PER_WORD) & (
            base0 + pos <= jnp.asarray(total_len, jnp.int32) - k
        )
        lo_u, hi_u, counts, _ = kmer_ops.runs_from_keys(
            lo, hi, valid[None, :], k
        )
        return _allgather_merge_sorted(lo_u, hi_u, counts, axis)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P(axis),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )(words)
