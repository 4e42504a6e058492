"""PackedDB — a fixed-length packed-sequence database in scan layout.

The hdist database scan (BASELINE.json config 5) is the framework's search
workload: queries against up to 1e8 packed entries. The database is stored
WORD-MAJOR [W, D] (structure-of-arrays), so a scan reads each word row
contiguously along the entry axis; PackedDB stores that layout once, so
repeated queries never re-transpose it.

Queries go through ops.hamming.hdist_many_to_many_wm (on a GPU the Triton
batch kernel, ops/hamming_triton.py, single queries at Q=1; elsewhere the
XLA scan). Both are bit-exact with the reference hdist semantics
(src/utils/functions/hamming/multi.rs:122-160).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .utils import bitops


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class PackedDB:
    """words_wm: uint32[W, D] word-major packed entries; n_bases: entry
    length in bases (static — all entries share it, like a k-mer or
    fixed-length read index)."""

    words_wm: jax.Array
    n_bases: int

    def tree_flatten(self):
        return (self.words_wm,), self.n_bases

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(words_wm=children[0], n_bases=aux)

    @classmethod
    def from_reads(cls, reads, n_bases=None) -> "PackedDB":
        """Build from a PackedReads batch (entries assumed equal-length;
        pass n_bases to override)."""
        nb = int(n_bases) if n_bases is not None else int(np.asarray(reads.lengths)[0])
        return cls(words_wm=jnp.transpose(reads.words), n_bases=nb)

    @classmethod
    def from_fastq(
        cls,
        path,
        n_bases: int,
        batch_size: int = 8192,
        validate: bool = True,
    ) -> "PackedDB":
        """Stream a FASTQ file straight into the word-major search layout.

        Entries are truncated/zero-padded to exactly n_bases (fixed-length
        index semantics). With the native library the build is HOST-side end
        to end — native parse + multithreaded host pack into word-major
        slabs, ONE device upload at the end (2 bits/base over the link; a
        1e8 x 512-base database uploads 12.8 GB once, vs 51 GB as ASCII or
        per-batch round trips). Host peak is ~2x the packed size (slabs +
        final concatenate). Falls back to the device loader when the
        native library is absent.
        """
        from . import io as bnio, native
        from .utils.bitops import n_words_for

        W = n_words_for(n_bases)
        slabs = []
        if native.available():
            for ascii_arr, lens, _ in bnio.iter_fastq_ascii_batches(
                path, batch_size, max_len=int(n_bases)
            ):
                if validate and len(lens):
                    in_range = (
                        np.arange(ascii_arr.shape[1])[None, :] < lens[:, None]
                    )
                    bad = in_range & ~bnio._VALID_BASE[ascii_arr]
                    if bad.any():
                        from .errors import InvalidBase

                        r, c = np.argwhere(bad)[0]
                        raise InvalidBase(int(ascii_arr[r, c]))
                # zero padding bytes encode as code 0 (((0>>1)^(0>>2))&3),
                # reproducing the zero-padded-word contract for short reads
                w64 = native.encode_batch(ascii_arr, max(1, W // 2))
                lanes = bitops.words_u64_to_u32_np(w64)
                slabs.append(np.ascontiguousarray(lanes[:, :W].T))
        else:
            for batch in bnio.iter_fastq_batches(
                path, batch_size, max_len=int(n_bases), validate=validate
            ):
                w = np.asarray(batch.words, np.uint32)
                if w.shape[1] < W:
                    w = np.pad(w, ((0, 0), (0, W - w.shape[1])))
                slabs.append(np.ascontiguousarray(w[:, :W].T))
        if not slabs:
            return cls(
                words_wm=jnp.zeros((W, 0), jnp.uint32), n_bases=int(n_bases)
            )
        return cls(
            words_wm=jnp.asarray(np.concatenate(slabs, axis=1)),
            n_bases=int(n_bases),
        )

    @classmethod
    def from_u64(cls, words_u64: np.ndarray, n_bases: int) -> "PackedDB":
        """From host reference-layout u64 words [D, n_u64]."""
        lanes = bitops.words_u64_to_u32_np(np.asarray(words_u64, np.uint64))
        return cls(words_wm=jnp.asarray(lanes.T.copy()), n_bases=int(n_bases))

    @property
    def size(self) -> int:
        return self.words_wm.shape[1]

    @property
    def n_words(self) -> int:
        return self.words_wm.shape[0]

    def __len__(self) -> int:
        return self.size

    # -- persistence ----------------------------------------------------------

    def save(self, path) -> None:
        """Persist as .npz (word-major words + n_bases), 2 bits/base."""
        np.savez_compressed(
            path,
            words_wm=np.asarray(self.words_wm, dtype=np.uint32),
            n_bases=np.int64(self.n_bases),
        )

    @classmethod
    def load(cls, path) -> "PackedDB":
        with np.load(path) as z:
            return cls(
                words_wm=jnp.asarray(z["words_wm"]), n_bases=int(z["n_bases"])
            )

    # -- queries --------------------------------------------------------------

    def distances(self, query: jax.Array) -> jax.Array:
        """Per-entry Hamming distances [D] for one packed query [W]."""
        from .ops import hamming

        return hamming.hdist_one_to_many_wm(query, self.words_wm, self.n_bases)

    def _sharded_wm(self, mesh, axis: str):
        """words_wm zero-padded to a device multiple on D and sharded
        column-wise; returns (sharded_wm, true_D)."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        n = mesh.shape[axis]
        D = self.size
        pad = (-D) % n
        wm = self.words_wm
        if pad:
            wm = jnp.pad(wm, ((0, 0), (0, pad)))
        return (
            jax.device_put(wm, NamedSharding(mesh, P(None, axis))),
            D,
        )

    def search(
        self, query: jax.Array, k: int, mesh=None, axis: str = "data"
    ) -> Tuple[jax.Array, jax.Array]:
        """Exact top-k nearest entries: (distances [k], indices [k]).

        mesh: optional jax Mesh — the database shards column-wise over the
        mesh (each device scans its slab, candidates merge with one
        collective top-k; parallel.search.hdist_search_db_sharded).
        Results are identical to the single-device scan."""
        from .ops import hamming

        if mesh is not None:
            from .parallel import search as psearch

            wm, D = self._sharded_wm(mesh, axis)
            return psearch.hdist_search_db_sharded(
                query, wm, self.n_bases, min(k, D), mesh, axis, d_valid=D
            )
        return hamming.topk_smallest(self.distances(query), k)

    def distances_batch(self, queries: jax.Array) -> jax.Array:
        """All-pairs distances [Q, D] for a packed query batch [Q, W]."""
        from .ops import hamming

        return hamming.hdist_many_to_many_wm(
            queries, self.words_wm, self.n_bases
        )

    def search_batch(
        self, queries: jax.Array, k: int, mesh=None, axis: str = "data"
    ) -> Tuple[jax.Array, jax.Array]:
        """Per-query exact top-k: (distances [Q, k], indices [Q, k]).
        mesh: optional — column-sharded distributed scan (see search)."""
        from .ops import hamming

        if mesh is not None:
            from .parallel import search as psearch

            wm, D = self._sharded_wm(mesh, axis)
            return psearch.hdist_search_batch_db_sharded(
                queries, wm, self.n_bases, min(k, D), mesh, axis, d_valid=D
            )
        # blocked one-pass top-k when (n_bases, D) pack into a u32 key;
        # the iterative per-row extractor makes k full passes over [Q, D]
        return hamming.topk_batch_dispatch(
            self.distances_batch(queries), k, self.n_bases
        )
