"""Device mesh and sharding helpers.

The reference is single-threaded (SURVEY.md §2.3: no parallelism of any kind);
this layer is new: a jax.sharding.Mesh over devices, NamedSharding
annotations, collectives inserted by XLA. Axis convention:

  * "data"  — batch of reads (DP): each device owns a slab of reads
  * "seq"   — words of one long sequence (SP analog): halo exchange for
              windows crossing shard edges (see parallel/kmer.py)

Across several hosts, call runtime.initialize() first; meshes made here
then span all hosts' devices.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..sequence import PackedReads


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data",),
) -> Mesh:
    """Mesh over all visible devices. Default: 1-D 'data' mesh."""
    if shape is None:
        shape = (len(jax.devices()),) + (1,) * (len(axis_names) - 1)
    return jax.make_mesh(tuple(shape), tuple(axis_names))


def pad_batch(reads: PackedReads, multiple: int) -> PackedReads:
    """Zero-pad the batch so its size divides the mesh axis. Padded reads have
    length 0, so every op treats them as empty (masks make them no-ops)."""
    B = reads.batch_size
    rem = (-B) % multiple
    if rem == 0:
        return reads
    import jax.numpy as jnp

    words = jnp.pad(reads.words, ((0, rem), (0, 0)))
    lengths = jnp.pad(reads.lengths, (0, rem))
    return PackedReads(words=words, lengths=lengths)


def shard_reads(reads: PackedReads, mesh: Mesh, axis: str = "data") -> PackedReads:
    """Place a PackedReads batch with its reads sharded over a mesh axis
    (words and lengths sharded along the batch dim, replicated elsewhere)."""
    reads = pad_batch(reads, int(np.prod([mesh.shape[axis]])))
    words = jax.device_put(reads.words, NamedSharding(mesh, P(axis, None)))
    lengths = jax.device_put(reads.lengths, NamedSharding(mesh, P(axis)))
    return PackedReads(words=words, lengths=lengths)


def replicate(x, mesh: Mesh):
    """Fully replicate an array over the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P()))
