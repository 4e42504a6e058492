"""Sequence containers.

``PackedReads`` is the device-native batch container — the batch-first analog of
the reference's ``PackedSequence`` (src/sequence.rs:5-9). Where the reference
holds one sequence per object with the caller looping, PackedReads holds a
whole batch as rectangular device arrays: ``words: uint32[batch, W]``,
``lengths: int32[batch]``. It is a registered pytree, so it flows through
jit/vmap/pjit and shards over meshes.

``PackedSequence`` is the host-side single-sequence convenience type matching
the reference API surface one-for-one: new/len/is_empty/get/slice/to_vec
(src/sequence.rs:40-262), equality and hashability (src/sequence.rs:319-338),
plus gc_content/base_counts (src/utils/analysis.rs). Single-sequence ops run
on host (numpy oracle or native C++ when built) because per-call device
dispatch would dominate at this granularity; convert to PackedReads for batch
work on device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from . import oracle
from .errors import IndexOutOfBounds, InvalidBase, InvalidRange
from .utils import bitops


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class PackedReads:
    """A batch of 2-bit packed reads on device.

    words: uint32[..., batch, W] with W even; word pairs (2j, 2j+1) of a read
      view as the reference's little-endian u64 word j.
    lengths: int32[..., batch] per-read base counts.
    """

    words: jax.Array
    lengths: jax.Array

    def tree_flatten(self):
        return (self.words, self.lengths), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        words, lengths = children
        return cls(words=words, lengths=lengths)

    # -- construction ---------------------------------------------------------

    @classmethod
    def from_ascii(
        cls,
        seqs: Union[Sequence[bytes], np.ndarray],
        lengths: np.ndarray = None,
        max_len: int = None,
        validate: bool = True,
    ) -> "PackedReads":
        """Build from host ASCII. `seqs` is a list of bytes-like reads or an
        already-rectangular uint8 array [batch, L] with `lengths`.

        Raises InvalidBase on the first invalid byte when validate=True,
        matching the reference contract (src/utils/packing/naive.rs:15).
        """
        ascii_arr, lens = _rectangularize(seqs, lengths, max_len)
        from .ops import codec

        words, first_bad = codec.encode_reads(
            jnp.asarray(ascii_arr), jnp.asarray(lens)
        )
        if validate:
            fb = np.asarray(first_bad)
            bad = np.nonzero(fb >= 0)[0]
            if bad.size:
                r = int(bad[0])
                raise InvalidBase(int(ascii_arr[r, int(fb[r])]))
        return cls(words=words, lengths=jnp.asarray(lens))

    @classmethod
    def from_u64(cls, words_u64: np.ndarray, lengths: np.ndarray) -> "PackedReads":
        """Build from host reference-layout u64 words [batch, n_u64]."""
        lanes = bitops.words_u64_to_u32_np(np.asarray(words_u64, dtype=np.uint64))
        return cls(words=jnp.asarray(lanes), lengths=jnp.asarray(lengths, jnp.int32))

    # -- host views -----------------------------------------------------------

    def to_u64(self) -> np.ndarray:
        """Host u64 words [batch, W//2], bit-exact reference layout."""
        return bitops.words_u32_to_u64_np(np.asarray(self.words))

    def to_ascii(self) -> List[bytes]:
        """Decode all reads to host bytes."""
        from .ops import codec

        out = np.asarray(codec.decode_reads(self.words, self.lengths))
        lens = np.asarray(self.lengths)
        return [bytes(out[i, : lens[i]]) for i in range(out.shape[0])]

    # -- shape ----------------------------------------------------------------

    @property
    def batch_size(self) -> int:
        return self.words.shape[-2]

    @property
    def n_words(self) -> int:
        return self.words.shape[-1]

    @property
    def max_bases(self) -> int:
        return self.n_words * bitops.BASES_PER_WORD

    def __len__(self) -> int:
        return self.batch_size

    def __getitem__(self, i: int) -> "PackedSequence":
        """Extract one read as a host PackedSequence (one-row device->host
        copy, O(W) — not a whole-batch transfer)."""
        if not -self.batch_size <= i < self.batch_size:
            raise IndexError(i)
        row = bitops.words_u32_to_u64_np(np.asarray(self.words[i]))
        n = int(self.lengths[i])
        return PackedSequence.from_packed(row[: (n + 31) // 32], n)

    def __iter__(self):
        for i in range(self.batch_size):
            yield self[i]


def _rectangularize(seqs, lengths=None, max_len=None) -> Tuple[np.ndarray, np.ndarray]:
    """Normalize host input into (uint8[batch, L], int32[batch]).

    ndarray inputs are COPIED: JAX's CPU backend zero-copy-aliases small
    host arrays into device buffers, so handing a caller-owned array to
    the device makes any later in-place mutation by the caller a data
    race with still-queued computations (the count_fasta flake). A private
    copy makes PackedReads.from_ascii safe by construction.
    """
    if isinstance(seqs, np.ndarray) and seqs.ndim == 2:
        arr = np.array(seqs, dtype=np.uint8)
        if max_len is not None and arr.shape[1] > int(max_len):
            arr = arr[:, : int(max_len)]
        if lengths is None:
            lens = np.full(arr.shape[0], arr.shape[1], dtype=np.int32)
        else:
            lens = np.asarray(lengths, dtype=np.int32)
        return arr, np.minimum(lens, arr.shape[1]).astype(np.int32)
    seq_bytes = [bytes(s) if not isinstance(s, (bytes, bytearray)) else s for s in seqs]
    lens = np.array([len(s) for s in seq_bytes], dtype=np.int32)
    L = int(max_len) if max_len is not None else (int(lens.max()) if len(lens) else 0)
    # pad L to a whole number of u64 pairs so encode needs no extra padding
    L = max(L, 1)
    arr = np.zeros((len(seq_bytes), L), dtype=np.uint8)
    for i, s in enumerate(seq_bytes):
        n = min(len(s), L)  # max_len truncates (matches the native path)
        arr[i, :n] = np.frombuffer(s[:n], dtype=np.uint8)
    return arr, np.minimum(lens, L)


class PackedSequence:
    """Host single-sequence type mirroring the reference PackedSequence
    (src/sequence.rs). Stores reference-layout u64 words + length; hashable
    and comparable so it works as a dict/set key (src/sequence.rs:329-338).

    >>> s = PackedSequence(b"ACGTACGT")
    >>> (len(s), s.is_empty(), chr(s.get(2)))
    (8, False, 'G')
    >>> s.slice(1, 5)
    b'CGTA'
    >>> (s.gc_content(), s.base_counts())
    (50.0, (2, 2, 2, 2))
    >>> PackedSequence(b"ACGT") == PackedSequence("ACGT")
    True
    """

    __slots__ = ("_data", "_length")

    def __init__(self, seq: Union[bytes, str, "PackedSequence"] = b""):
        if isinstance(seq, PackedSequence):
            self._data = seq._data
            self._length = seq._length
            return
        s = seq.encode("ascii") if isinstance(seq, str) else bytes(seq)
        self._data = oracle.encode(s) if s else np.zeros(0, dtype=np.uint64)
        self._length = len(s)

    # construction from packed words
    @classmethod
    def from_packed(cls, words_u64, length: int) -> "PackedSequence":
        obj = cls.__new__(cls)
        data = np.asarray(words_u64, dtype=np.uint64).copy()
        # normalize to exactly ceil(length/32) words so equality/hash see one
        # canonical form (split_packed can emit a trailing zero word)
        nw = -(-int(length) // 32)
        if len(data) > nw:
            data = data[:nw].copy()
        elif len(data) < nw:
            data = np.concatenate([data, np.zeros(nw - len(data), np.uint64)])
        obj._data = data
        obj._length = int(length)
        return obj

    @property
    def data(self) -> np.ndarray:
        """Packed u64 words (reference layout)."""
        return self._data

    def __len__(self) -> int:
        return self._length

    def len(self) -> int:  # reference-name alias (src/sequence.rs:67)
        return self._length

    def is_empty(self) -> bool:
        return self._length == 0

    def get(self, index: int) -> int:
        """ASCII byte at index (src/sequence.rs:116-135)."""
        return oracle.get(self._data, self._length, index)

    def slice(self, start: int, end: int) -> bytes:
        """Subsequence [start, end) (src/sequence.rs:198-212)."""
        if start < 0 or start > end or end > self._length:
            raise InvalidRange(start, end, self._length)
        if start == end:
            return b""
        # decode only the covering words then trim: O(end-start), not O(n)
        lo_word = start // 32
        n_dec = min(end - lo_word * 32, self._length - lo_word * 32)
        covered = oracle.decode(self._data[lo_word:], n_dec)
        off = start - lo_word * 32
        return covered[off : off + (end - start)]

    def to_vec(self) -> bytes:
        """Full decode (src/sequence.rs:260-262)."""
        return oracle.decode(self._data, self._length)

    def gc_content(self) -> float:
        """GC percent 0-100 (src/utils/analysis.rs:8-16)."""
        return oracle.gc_content(self._data, self._length)

    def base_counts(self) -> Tuple[int, int, int, int]:
        """(A, C, G, T) counts (src/utils/analysis.rs:23-39)."""
        return oracle.base_counts(self._data, self._length)

    def split(self, idx: int) -> Tuple["PackedSequence", "PackedSequence"]:
        """Split into (left, right) at base idx (split_packed analog)."""
        l, r = oracle.split_packed(self._data, self._length, idx)
        return (
            PackedSequence.from_packed(l, idx),
            PackedSequence.from_packed(r, self._length - idx),
        )

    def __getitem__(self, key):
        if isinstance(key, slice):
            start, stop, step = key.indices(self._length)
            if step != 1:
                raise InvalidRange(start, stop, self._length)
            return self.slice(start, stop)
        if key < 0:
            key += self._length
        return self.get(key)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, PackedSequence)
            and self._length == other._length
            and np.array_equal(self._data, other._data)
        )

    def __hash__(self) -> int:
        return hash((self._length, self._data.tobytes()))

    def __repr__(self) -> str:
        shown = self.to_vec() if self._length <= 40 else self.to_vec()[:37] + b"..."
        return f"PackedSequence({shown.decode('ascii')!r}, len={self._length})"

    # device interop
    def to_reads(self) -> PackedReads:
        """Lift to a batch-of-one PackedReads on device."""
        return PackedReads.from_u64(self._data[None, :], np.array([self._length]))


def stack_sequences(seqs: Iterable[PackedSequence]) -> PackedReads:
    """Stack host PackedSequences into one device batch (zero-padded)."""
    seq_list = list(seqs)
    lens = np.array([len(s) for s in seq_list], dtype=np.int32)
    n_u64 = max((len(s.data) for s in seq_list), default=0)
    n_u64 = max(n_u64, 1)
    words = np.zeros((len(seq_list), n_u64), dtype=np.uint64)
    for i, s in enumerate(seq_list):
        words[i, : len(s.data)] = s.data
    return PackedReads.from_u64(words, lens)
