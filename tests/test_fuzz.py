"""Randomized cross-implementation equivalence — the analog of the
reference's property tests (random roundtrips over every length,
src/utils/mod.rs:114-133) plus its simd/nosimd CI matrix, but diffing the
implementations directly in one process:

    numpy oracle  ==  native C++ (per sequence and batched)  ==  XLA batch ops
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import bitnuc_tpu as bn  # noqa: E402
from bitnuc_tpu import native, oracle  # noqa: E402
from bitnuc_tpu.ops import codec  # noqa: E402

from conftest import random_seq  # noqa: E402


@pytest.mark.parametrize("trial", range(4))
def test_codec_four_way(rng, trial):
    lens = rng.integers(0, 700, size=24).astype(np.int32)
    seqs = [random_seq(rng, int(n)) for n in lens]
    L = max(1, int(lens.max()))
    arr = np.zeros((len(seqs), L), np.uint8)
    arr[:] = ord("A")
    for i, s in enumerate(seqs):
        arr[i, : len(s)] = np.frombuffer(s, np.uint8)

    # oracle + native per sequence
    for backend in [oracle] + ([native] if native.available() else []):
        for s in seqs:
            w = backend.encode(s)
            assert backend.decode(w, len(s)) == s.upper()

    # XLA batch
    wx, fbx = codec.encode_reads_xla(jnp.asarray(arr), jnp.asarray(lens))
    assert np.all(np.asarray(fbx) == -1)
    u64 = np.asarray(wx).view(np.uint64)
    for i, s in enumerate(seqs):
        ref = oracle.encode(s)
        np.testing.assert_array_equal(u64[i, : len(ref)], ref)

    # native batched host packer (the staged loader's path)
    if native.available():
        masked = np.where(np.arange(L)[None, :] < lens[:, None], arr, 0)
        wn = native.encode_batch(masked.astype(np.uint8), u64.shape[1])
        np.testing.assert_array_equal(wn, u64)
    dx = np.asarray(codec.decode_reads_xla(wx, jnp.asarray(lens), L))
    for i, s in enumerate(seqs):
        assert dx[i, : len(s)].tobytes() == s.upper()
        assert not dx[i, len(s):].any()


@pytest.mark.parametrize("trial", range(3))
def test_hdist_three_way(rng, trial):
    n = int(rng.integers(1, 400))
    s1, s2 = random_seq(rng, n), random_seq(rng, n)
    byte_d = sum(a != b for a, b in zip(s1.upper(), s2.upper()))
    e1, e2 = oracle.encode(s1), oracle.encode(s2)
    assert oracle.hdist(e1, e2, n) == byte_d
    if native.available():
        assert native.hdist(e1, e2, n) == byte_d
    from bitnuc_tpu.ops import hamming
    from bitnuc_tpu.utils import bitops

    w1 = jnp.asarray(bitops.words_u64_to_u32_np(e1))
    w2 = jnp.asarray(bitops.words_u64_to_u32_np(e2))
    assert int(hamming.hdist_words(w1, w2, n)) == byte_d


@pytest.mark.parametrize("trial", range(3))
def test_kmer_modes_agree(rng, trial):
    from bitnuc_tpu.ops import kmer

    k = int(rng.integers(1, 9))
    B = int(rng.integers(1, 6))
    L = int(rng.integers(k, 120))
    arr = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    w, _ = codec.encode_reads_xla(jnp.asarray(arr), jnp.asarray(lens))
    dense = np.asarray(kmer.count_kmers_dense(w, jnp.asarray(lens), k))
    mxu = np.asarray(kmer.count_kmers_dense_mxu(w, jnp.asarray(lens), k))
    np.testing.assert_array_equal(dense, mxu)
    lo, hi, counts, n_u = kmer.count_kmers_sorted(w, jnp.asarray(lens), k)
    sparse = {
        int(np.asarray(lo)[i]): int(np.asarray(counts)[i]) for i in range(int(n_u))
    }
    dense_nz = {int(i): int(dense[i]) for i in np.nonzero(dense)[0]}
    assert sparse == dense_nz
    # host reference: aggregate oracle counts over the batch
    from collections import Counter

    want = Counter()
    for i in range(B):
        seq = bytes(arr[i, : lens[i]])
        want.update(oracle.count_kmers(seq, k))
    assert dense_nz == {k_: v for k_, v in want.items() if v}


@pytest.mark.parametrize("trial", range(3))
def test_split_roundtrip_random(rng, trial):
    n = int(rng.integers(1, 300))
    s = random_seq(rng, n).upper()
    e = oracle.encode(s)
    idx = int(rng.integers(0, n + 1))
    l1, r1 = oracle.split_packed(e, n, idx)
    assert oracle.decode(l1, idx) == s[:idx]
    assert oracle.decode(r1, n - idx) == s[idx:]
    if native.available():
        l2, r2 = native.split_packed(e, n, idx)
        assert oracle.decode(l2, idx) == s[:idx]
        assert oracle.decode(r2, n - idx) == s[idx:]


def test_fuzz_counting_engines_agree(rng):
    """All counting formulations (dense scatter, MXU, Pallas fused/keys,
    sorted, runs) agree with each other and the oracle across random
    shapes, k, canonical, and N-masked inputs."""
    import jax.numpy as jnp

    from bitnuc_tpu import oracle
    from bitnuc_tpu.ops import codec, kmer
    from bitnuc_tpu.sequence import PackedReads

    for trial in range(6):
        B = int(rng.integers(1, 9))
        L = int(rng.integers(2, 200))
        k = int(rng.integers(1, 33))
        canonical = bool(rng.integers(2)) and k <= 16
        seqs = [
            bytes(rng.choice(np.frombuffer(b"ACGTacgt", np.uint8), size=int(n)))
            for n in rng.integers(1, L + 1, B)
        ]
        r = PackedReads.from_ascii(seqs, max_len=L)

        lo, hi, cnt, nu = kmer.count_kmers_runs(r.words, r.lengths, k, canonical)
        glo, ghi, gct = kmer.compact_runs(lo, hi, cnt)
        got = {
            (int(ghi[i]) << 32) | int(glo[i]): int(gct[i])
            for i in range(len(gct))
        }
        def py_revcomp(key, kk):
            out = 0
            for _ in range(kk):
                out = (out << 2) | ((key & 3) ^ 3)
                key >>= 2
            return out

        expect = {}
        for s in seqs:
            for key, c in oracle.count_kmers(s, k).items():
                if canonical:
                    key = min(key, py_revcomp(key, k))
                expect[key] = expect.get(key, 0) + c
        assert got == expect, (trial, B, L, k, canonical)

        # cross-engine agreement (content)
        lo2, hi2, c2, n2 = kmer.count_kmers_sorted(r.words, r.lengths, k, canonical)
        ref = {
            (int(np.asarray(hi2)[i]) << 32)
            | int(np.asarray(lo2)[i]): int(np.asarray(c2)[i])
            for i in range(int(n2))
        }
        assert got == ref, (trial, B, L, k, canonical)
        if k <= kmer.MAX_DENSE_K and not canonical:
            hist = np.asarray(kmer.count_kmers_dense(r.words, r.lengths, k))
            assert {i: int(c) for i, c in enumerate(hist) if c} == got


@pytest.mark.parametrize("trial", range(3))
def test_merge_pairs_scans_agree(rng, trial):
    """Packed-domain vs code-plane merge_pairs on fully random ragged
    pairs (round 5: the packed scan + word-domain fragment construction
    must stay bit-exact with the code-plane oracle path)."""
    from bitnuc_tpu.ops import merge_pairs
    from bitnuc_tpu.sequence import PackedReads

    B = 48
    s1 = [random_seq(rng, int(rng.integers(12, 180))).upper() for _ in range(B)]
    s2 = [random_seq(rng, int(rng.integers(12, 180))).upper() for _ in range(B)]
    p1, p2 = PackedReads.from_ascii(s1), PackedReads.from_ascii(s2)
    a = merge_pairs.merge_pairs(
        p1.words, p1.lengths, p2.words, p2.lengths, scan="packed"
    )
    b = merge_pairs.merge_pairs(
        p1.words, p1.lengths, p2.words, p2.lengths, scan="codes"
    )
    for x, y, nm in zip(a, b, ("words", "lens", "merged", "ov", "mm")):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), nm)


@pytest.mark.parametrize("trial", range(3))
def test_orf_kernel_fuzz(rng, trial):
    """longest_orf vs the 6-frame python oracle on random ragged batches
    (the ORF analog of test_codec_four_way)."""
    from bitnuc_tpu.ops import orf
    from bitnuc_tpu.sequence import PackedReads
    from test_orf import naive_longest

    seqs = [
        random_seq(rng, int(n)).upper() for n in rng.integers(1, 300, 32)
    ]
    reads = PackedReads.from_ascii(seqs)
    got = [np.asarray(x) for x in orf.longest_orf(reads.words, reads.lengths)]
    for i, q in enumerate(seqs):
        g = (int(got[0][i]), int(got[1][i]), int(got[2][i]), bool(got[3][i]),
             bool(got[4][i]))
        assert g == naive_longest(q), (i, q)
