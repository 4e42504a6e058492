"""Distributed Hamming-distance database search.

The BASELINE.json headline workload (config 5): a query k-mer/read scanned
against a packed database of up to 1e8 entries, sharded across devices.
Each device scans its slab (XOR + popcount, ops/hamming.py; query batches
on a GPU through the Triton kernel, ops/hamming_triton.py), takes a local
top-k, and the per-device candidates are merged with one all_gather + final
top-k. Traffic between devices is O(devices * k), independent of database
size.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import hamming


@partial(jax.jit, static_argnames=("topk", "mesh", "axis"))
def hdist_search_sharded(
    query: jax.Array,
    db_words: jax.Array,
    n_bases,
    topk: int,
    mesh: Mesh,
    axis: str = "data",
) -> Tuple[jax.Array, jax.Array]:
    """Top-k nearest database rows to `query` by per-base Hamming distance.

    query: [W] uint32 packed query — pass an unsharded/replicated array
    (e.g. a row of the host-side PackedReads, not of the sharded copy:
    indexing a sharded batch raises a ShardingTypeError under explicit
    sharding). db_words: [D, W] uint32 sharded on `axis` (D divisible by
    the axis size); n_bases: compare length.
    Returns replicated (distances [topk], global_indices [topk]) ascending.
    Padding rows (all-zero words) rank by their true distance; pad the
    database with sentinel rows of distance > n_bases if exclusion matters.
    """

    def local(q, db_loc):
        D_loc = db_loc.shape[0]
        d = hamming.hdist_one_to_many(q, db_loc, n_bases)
        dd, idx = hamming.topk_smallest(d, min(topk, D_loc))
        me = jax.lax.axis_index(axis).astype(jnp.int32)
        return dd, idx + me * D_loc

    # per-device candidate lists stay sharded on `axis`; the final merge is a
    # tiny top-k over n_dev * topk entries that GSPMD gathers for us.
    cand_d, cand_i = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis, None)),
        out_specs=(P(axis), P(axis)),
    )(query, db_words)
    from jax.sharding import NamedSharding

    repl = NamedSharding(mesh, P())
    cand_d = jax.sharding.reshard(cand_d, repl)
    cand_i = jax.sharding.reshard(cand_i, repl)
    dd, sel = hamming.topk_smallest(cand_d, min(topk, cand_d.shape[0]))
    return dd, cand_i[sel]


def _merge_candidates_batch(cand_d, cand_i, mesh, topk):
    """Replicate per-device per-query candidate lists and take the final
    per-query top-k. cand_d/cand_i: [Q, n_dev * topk_local]."""
    from jax.sharding import NamedSharding

    repl = NamedSharding(mesh, P())
    cand_d = jax.sharding.reshard(cand_d, repl)
    cand_i = jax.sharding.reshard(cand_i, repl)
    k = min(topk, cand_d.shape[1])
    dd, sel = jax.vmap(lambda row: hamming.topk_smallest(row, k))(cand_d)
    return dd, jnp.take_along_axis(cand_i, sel, axis=1)


@partial(jax.jit, static_argnames=("topk", "mesh", "axis"))
def hdist_search_batch_sharded(
    queries: jax.Array,
    db_words: jax.Array,
    n_bases,
    topk: int,
    mesh: Mesh,
    axis: str = "data",
) -> Tuple[jax.Array, jax.Array]:
    """Per-query top-k over a sharded ROW-MAJOR database: queries [Q, W]
    replicated, db_words [D, W] sharded on `axis` (D divisible by the axis
    size). Returns replicated (distances [Q, topk], global_indices [Q, topk])
    each row ascending — exactly hamming.hdist_topk_batch on the unsharded
    database (tests/test_parallel.py). Reference semantics: hdist
    (src/utils/functions/hamming/multi.rs:122-160) per (query, row) pair.
    Traffic between devices is O(devices * Q * topk), independent of
    database size."""

    def local(qs, db_loc):
        D_loc = db_loc.shape[0]
        dd, idx = hamming.hdist_topk_batch(qs, db_loc, n_bases, min(topk, D_loc))
        me = jax.lax.axis_index(axis).astype(jnp.int32)
        return dd, idx + me * D_loc

    cand_d, cand_i = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis, None)),
        out_specs=(P(None, axis), P(None, axis)),
    )(queries, db_words)
    return _merge_candidates_batch(cand_d, cand_i, mesh, topk)


@partial(jax.jit, static_argnames=("n_bases", "topk", "mesh", "axis", "d_valid"))
def hdist_search_batch_db_sharded(
    queries: jax.Array,
    db_words_wm: jax.Array,
    n_bases: int,
    topk: int,
    mesh: Mesh,
    axis: str = "data",
    d_valid=None,
) -> Tuple[jax.Array, jax.Array]:
    """Per-query top-k over a sharded WORD-MAJOR database [W, D] (PackedDB
    layout) — the scan-optimal twin of hdist_search_batch_sharded. Each
    device scans its slab with hamming.hdist_many_to_many_wm (on a GPU the
    Triton kernel, which reads each db tile once per block of queries).
    d_valid: with a database zero-padded to a device multiple, the count of
    REAL columns — padding columns rank at distance n_bases + 1 so they can
    never displace genuine entries from the top-k."""

    def local(qs, db_loc_wm):
        D_loc = db_loc_wm.shape[1]
        me = jax.lax.axis_index(axis).astype(jnp.int32)
        d = hamming.hdist_many_to_many_wm(qs, db_loc_wm, n_bases)
        if d_valid is not None:
            gidx = me * D_loc + jnp.arange(D_loc, dtype=jnp.int32)
            d = jnp.where(gidx[None, :] < d_valid, d, n_bases + 1)
        k_loc = min(topk, D_loc)
        dd, idx = jax.vmap(lambda row: hamming.topk_smallest(row, k_loc))(d)
        return dd, idx + me * D_loc

    # check_vma=False: the kernel's out_shape carries no varying-axis
    # metadata, which trips the static replication check
    cand_d, cand_i = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(None, axis)),
        out_specs=(P(None, axis), P(None, axis)),
        check_vma=False,
    )(queries, db_words_wm)
    return _merge_candidates_batch(cand_d, cand_i, mesh, topk)


@partial(jax.jit, static_argnames=("n_bases", "topk", "mesh", "qaxis", "daxis"))
def hdist_search_grid(
    queries: jax.Array,
    db_words_wm: jax.Array,
    n_bases: int,
    topk: int,
    mesh: Mesh,
    qaxis: str = "data",
    daxis: str = "model",
    d_valid=None,
) -> Tuple[jax.Array, jax.Array]:
    """2-D sharded search: queries sharded over `qaxis`, WORD-MAJOR
    database columns sharded over `daxis` — the 2D tensor-parallel grid
    regime. Every device scans (its query slab x its database slab); the
    candidate merge is one all_gather ALONG THE DATABASE AXIS only
    (O(n_daxis * topk) per query), queries never move, and the result
    stays sharded over `qaxis` (replicated over `daxis`).

    queries: [Q, W] with Q divisible by the qaxis size; db_words_wm:
    [W, D] with D divisible by the daxis size. Returns
    (distances [Q, topk], global_indices [Q, topk]) — each row identical
    to the single-device hamming.hdist_topk_batch. d_valid: real column
    count when the database was zero-padded (padding ranks last)."""
    n_d = mesh.shape[daxis]

    def local(qs_loc, db_loc_wm):
        D_loc = db_loc_wm.shape[1]
        me = jax.lax.axis_index(daxis).astype(jnp.int32)
        d = hamming.hdist_many_to_many_wm(qs_loc, db_loc_wm, n_bases)
        if d_valid is not None:
            gidx = me * D_loc + jnp.arange(D_loc, dtype=jnp.int32)
            d = jnp.where(gidx[None, :] < d_valid, d, n_bases + 1)
        k_loc = min(topk, D_loc)
        dd, idx = jax.vmap(lambda row: hamming.topk_smallest(row, k_loc))(d)
        idx = idx + me * D_loc
        # merge along the database axis only: [n_d, Qloc, k] -> per-query
        # final top-k; tiled=False keeps the axis explicit
        dd_g = jax.lax.all_gather(dd, daxis)
        ii_g = jax.lax.all_gather(idx, daxis)
        Qloc = dd.shape[0]
        dd_f = jnp.moveaxis(dd_g, 0, 1).reshape(Qloc, n_d * k_loc)
        ii_f = jnp.moveaxis(ii_g, 0, 1).reshape(Qloc, n_d * k_loc)
        k = min(topk, dd_f.shape[1])
        out_d, sel = jax.vmap(lambda row: hamming.topk_smallest(row, k))(dd_f)
        return out_d, jnp.take_along_axis(ii_f, sel, axis=1)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(qaxis, None), P(None, daxis)),
        out_specs=(P(qaxis, None), P(qaxis, None)),
        check_vma=False,
    )(queries, db_words_wm)


@partial(jax.jit, static_argnames=("mesh", "axis"))
def hdist_many_to_many_sharded(
    queries: jax.Array,
    db_words: jax.Array,
    n_bases,
    mesh: Mesh,
    axis: str = "data",
) -> jax.Array:
    """All-pairs distance matrix [Q, D] with the database sharded on `axis`
    and queries replicated. Output is sharded on its D column axis."""

    def local(q, db_loc):
        return hamming.hdist_many_to_many(q, db_loc, n_bases)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(axis, None)),
        out_specs=P(None, axis),
    )(queries, db_words)


@partial(jax.jit, static_argnames=("n_bases", "topk", "mesh", "axis", "d_valid"))
def hdist_search_db_sharded(
    query: jax.Array,
    db_words_wm: jax.Array,
    n_bases: int,
    topk: int,
    mesh: Mesh,
    axis: str = "data",
    d_valid=None,
) -> Tuple[jax.Array, jax.Array]:
    """Sharded top-k search over a WORD-MAJOR database [W, D] (PackedDB
    layout, D divisible by the axis size) — the scan-optimal twin of
    hdist_search_sharded: each device scans its slab in place
    (hamming.hdist_one_to_many_wm); the candidate merge is identical. d_valid: count
    of real columns when the database was zero-padded to a device multiple
    (padding ranks at distance n_bases + 1)."""

    def local(q, db_loc_wm):
        D_loc = db_loc_wm.shape[1]
        me = jax.lax.axis_index(axis).astype(jnp.int32)
        d = hamming.hdist_one_to_many_wm(q, db_loc_wm, n_bases)
        if d_valid is not None:
            gidx = me * D_loc + jnp.arange(D_loc, dtype=jnp.int32)
            d = jnp.where(gidx < d_valid, d, n_bases + 1)
        dd, idx = hamming.topk_smallest(d, min(topk, D_loc))
        return dd, idx + me * D_loc

    # check_vma=False: the kernel's out_shape carries no varying-axis
    # metadata, which trips the static replication check
    cand_d, cand_i = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(None, axis)),
        out_specs=(P(axis), P(axis)),
        check_vma=False,
    )(query, db_words_wm)
    from jax.sharding import NamedSharding

    repl = NamedSharding(mesh, P())
    cand_d = jax.sharding.reshard(cand_d, repl)
    cand_i = jax.sharding.reshard(cand_i, repl)
    dd, sel = hamming.topk_smallest(cand_d, min(topk, cand_d.shape[0]))
    return dd, cand_i[sel]
