"""Parity of the batched device paths against the host oracle, at the
shapes the reference sweeps (per-length SIMD tier boundaries,
src/utils/unpacking/avx.rs:172-182): the XLA codec, the dense counting
lowerings (scatter and one-hot product), the Triton batch Hamming kernel
(Pallas interpret mode on CPU) with its wrapper's padding and dispatch,
and the banded wavefront at the mapper's widened band."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from bitnuc_tpu import oracle  # noqa: E402
from bitnuc_tpu.ops import codec  # noqa: E402

from conftest import random_seq  # noqa: E402


CASES = [(1, 1), (3, 50), (7, 2048), (33, 2049), (300, 5000), (17, 33)]


def _oracle_words(seqs, n_words):
    """[B, n_words] u32 lanes of oracle.encode per sequence, zero-padded."""
    out = np.zeros((len(seqs), n_words), np.uint32)
    for i, s in enumerate(seqs):
        w = oracle.u64_to_u32(oracle.encode(s)) if s else np.zeros(0, np.uint32)
        out[i, : len(w)] = w
    return out


def _first_bad(arr, lens):
    ok = np.isin(arr, np.frombuffer(b"ACGTacgt", np.uint8))
    out = np.full(len(lens), -1, np.int64)
    for i, n in enumerate(lens):
        bad = np.nonzero(~ok[i, :n])[0]
        if len(bad):
            out[i] = bad[0]
    return out


@pytest.mark.parametrize("B,L", CASES)
def test_pack_parity(rng, B, L):
    ascii_np = rng.choice(np.frombuffer(b"ACGTacgt", dtype=np.uint8), size=(B, L))
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    w, fb = codec.encode_reads_xla(jnp.asarray(ascii_np), jnp.asarray(lens))
    w = np.asarray(w)
    seqs = [ascii_np[i, : lens[i]].tobytes() for i in range(B)]
    np.testing.assert_array_equal(w, _oracle_words(seqs, w.shape[1]))
    np.testing.assert_array_equal(np.asarray(fb), np.full(B, -1))


@pytest.mark.parametrize("B,L", CASES)
def test_pack_parity_invalid_bytes(rng, B, L):
    ascii_np = rng.choice(np.frombuffer(b"ACGTacgt", dtype=np.uint8), size=(B, L))
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    bad = ascii_np.copy()
    bad[0, L // 2] = ord("N")
    if B > 1 and L > 1:
        bad[1, 0] = ord("x")
        bad[-1, L - 1] = 0
    w, fb = codec.encode_reads_xla(jnp.asarray(bad), jnp.asarray(lens))
    want_fb = _first_bad(bad, lens)
    np.testing.assert_array_equal(np.asarray(fb), want_fb)
    ok = want_fb < 0
    seqs = [bad[i, : lens[i]].tobytes() for i in range(B)]
    want_w = _oracle_words([s if k else b"" for s, k in zip(seqs, ok)],
                           np.asarray(w).shape[1])
    np.testing.assert_array_equal(np.asarray(w)[ok], want_w[ok])


@pytest.mark.parametrize("B,L", CASES)
def test_unpack_parity(rng, B, L):
    ascii_np = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(B, L))
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    words, _ = codec.encode_reads_xla(jnp.asarray(ascii_np), jnp.asarray(lens))
    want = np.where(np.arange(L)[None, :] < lens[:, None], ascii_np, 0)
    d = np.asarray(codec.decode_reads_xla(words, jnp.asarray(lens), max_len=L))
    np.testing.assert_array_equal(d, want)
    # default max_len: the whole word capacity, zero past each length
    d = np.asarray(codec.decode_reads_xla(words, jnp.asarray(lens)))
    assert d.shape[1] == np.asarray(words).shape[1] * 16
    np.testing.assert_array_equal(d[:, :L], want)
    assert not d[:, L:].any()
    for i in range(B):
        assert d[i, : lens[i]].tobytes() == oracle.decode(
            oracle.encode(ascii_np[i, : lens[i]].tobytes()), int(lens[i])
        )


def test_pack_golden_acgt():
    """README example through the device codec: ACGT -> 0b11100100."""
    a = jnp.asarray(np.frombuffer(b"ACGT", np.uint8)[None, :])
    w, fb = codec.encode_reads(a, jnp.asarray([4], jnp.int32))
    u64 = np.asarray(w).view(np.uint64)
    assert u64[0, 0] == 0b11100100
    assert int(fb[0]) == -1


def test_roundtrip_codec(rng):
    seqs = [random_seq(rng, n) for n in (1, 31, 32, 33, 100, 1000)]
    L = max(len(s) for s in seqs)
    arr = np.zeros((len(seqs), L), np.uint8)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        arr[i, : len(s)] = np.frombuffer(s, np.uint8)
        lens[i] = len(s)
    w, fb = codec.encode_reads(jnp.asarray(arr), jnp.asarray(lens))
    assert np.all(np.asarray(fb) == -1)
    out_np = np.asarray(codec.decode_reads(w, jnp.asarray(lens)))
    for i, s in enumerate(seqs):
        assert bytes(out_np[i, : lens[i]]) == s.upper()


def _oracle_hist(seqs, k):
    h = np.zeros(4**k, np.int64)
    for s in seqs:
        for key, c in oracle.count_kmers(s, k).items():
            h[key] += c
    return h


@pytest.mark.parametrize("B,L,k", [(4, 100, 4), (8, 64, 8), (3, 40, 6), (2, 33, 1)])
def test_histogram_kernel_parity(rng, B, L, k):
    """The one-hot bf16 product histogram == the host oracle."""
    from bitnuc_tpu.ops import kmer

    a = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=(B, L))
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    w, _ = codec.encode_reads_xla(jnp.asarray(a), jnp.asarray(lens))
    h = np.asarray(kmer.count_kmers_dense_mxu(w, jnp.asarray(lens), k))
    want = _oracle_hist([a[i, : lens[i]].tobytes() for i in range(B)], k)
    np.testing.assert_array_equal(h, want)


def test_histogram_kernel_sentinel():
    """Invalid windows (reads shorter than k, padding) count nowhere, in
    both dense lowerings."""
    from bitnuc_tpu.ops import kmer
    from bitnuc_tpu.sequence import PackedReads

    r = PackedReads.from_ascii([b"AC", b"ACGTA", b""])
    for fn in (kmer.count_kmers_dense, kmer.count_kmers_dense_mxu):
        h = np.asarray(fn(r.words, r.lengths, 3))
        assert h.sum() == 3
        assert h[oracle.as_2bit(b"ACG")] == 1 and h[oracle.as_2bit(b"GTA")] == 1


@pytest.mark.parametrize("D,W,nb", [(100, 32, 512), (5000, 4, 50), (1, 2, 7)])
def test_hdist_scan_kernel_parity(rng, D, W, nb):
    """The Triton kernel at Q=1 (interpret mode) == the XLA single scan
    and the host oracle, and its top-k matches."""
    from bitnuc_tpu.ops import hamming, hamming_triton

    db = rng.integers(0, 2**32, size=(D, W), dtype=np.uint32)
    q = rng.integers(0, 2**32, size=(W,), dtype=np.uint32)
    want = np.asarray(hamming.hdist_one_to_many(jnp.asarray(q), jnp.asarray(db), nb))
    got = np.asarray(hamming_triton.hdist_scan_batch(
        jnp.asarray(q[None, :]), jnp.asarray(db.T.copy()), nb, interpret=True
    ))[0]
    np.testing.assert_array_equal(want, got)
    qo = oracle.u32_to_u64(q)
    for i in range(min(D, 40)):
        assert got[i] == oracle.hdist(qo, oracle.u32_to_u64(db[i]), nb)
    d1, i1 = hamming.hdist_topk(jnp.asarray(q), jnp.asarray(db), nb, 5)
    d2, i2 = hamming.topk_smallest(jnp.asarray(got), 5)
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_histogram_kernel_exact_past_f32_slab():
    """The one-hot product stays exact when one bin takes more than one
    2^22-window chunk (poly-A): the per-chunk f32 sums fold into int32."""
    from bitnuc_tpu.ops import kmer

    n_bases = (1 << 21) + 12345
    W = -(-n_bases // 16)
    words = jnp.zeros((2, W), jnp.uint32)  # all A
    lens = jnp.asarray([n_bases, n_bases], jnp.int32)
    h = np.asarray(kmer.count_kmers_dense_mxu(words, lens, 2))
    n = 2 * (n_bases - 1)
    assert n > (1 << 22)
    assert h[0] == n and h.sum() == n


@pytest.mark.parametrize("shape", [(2, 3, 40), (50,)])
def test_pallas_dispatch_any_rank(rng, shape):
    """encode_reads / decode_reads take any leading rank, row for row
    equal to the oracle."""
    ascii_np = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=shape)
    lens = np.full(shape[:-1], shape[-1], np.int32)
    w, fb = codec.encode_reads(jnp.asarray(ascii_np), jnp.asarray(lens))
    out = codec.decode_reads(w, jnp.asarray(lens), shape[-1])
    assert w.shape[:-1] == shape[:-1] and fb.shape == shape[:-1]
    flat_a = ascii_np.reshape(-1, shape[-1])
    flat_w = np.asarray(w).reshape(len(flat_a), -1)
    want = _oracle_words([r.tobytes() for r in flat_a], flat_w.shape[1])
    np.testing.assert_array_equal(flat_w, want)
    np.testing.assert_array_equal(np.asarray(out), ascii_np)


@pytest.mark.parametrize(
    "Q,D,n_bases", [(1, 16, 32), (5, 100, 77), (64, 300, 512), (70, 513, 200)]
)
def test_hdist_scan_batch_parity(rng, Q, D, n_bases):
    """Triton batch kernel (interpret) == XLA many-to-many: ragged query
    blocks (Q padded to the block), ragged last database tile, partial
    last word."""
    from bitnuc_tpu.ops import hamming, hamming_triton
    from bitnuc_tpu.utils import bitops

    W = bitops.n_words_for(n_bases)
    db = rng.integers(0, 2**32, size=(D, W), dtype=np.uint32)
    qs = rng.integers(0, 2**32, size=(Q, W), dtype=np.uint32)
    want = np.asarray(hamming.hdist_many_to_many(jnp.asarray(qs), jnp.asarray(db), n_bases))
    got = np.asarray(hamming_triton.hdist_scan_batch(
        jnp.asarray(qs), jnp.asarray(db.T.copy()), n_bases, tile_d=128,
        interpret=True,
    ))
    assert got.shape == (Q, D)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B,L,k", [(3, 40, 4), (9, 700, 8), (1, 16, 1), (20, 33, 6)])
def test_fused_words_histogram_parity(rng, B, L, k):
    """One-hot product == scatter on mixed lengths incl. reads shorter
    than k, canonical and strand-specific."""
    from bitnuc_tpu.ops import kmer
    from bitnuc_tpu.sequence import PackedReads

    seqs = [
        bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=int(n)))
        for n in rng.integers(1, L + 1, B)
    ]
    r = PackedReads.from_ascii(seqs, max_len=L)
    for canonical in (False, True):
        want = np.asarray(kmer.count_kmers_dense(r.words, r.lengths, k, canonical))
        got = np.asarray(kmer.count_kmers_dense_mxu(r.words, r.lengths, k, canonical))
        np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(
        np.asarray(kmer.count_kmers_dense_mxu(r.words, r.lengths, k)),
        _oracle_hist(seqs, k),
    )


def test_fused_words_histogram_column_slabbing(rng):
    """Long reads (many words, ragged tail): windows crossing word
    boundaries count the same in both lowerings and the oracle."""
    from bitnuc_tpu.ops import kmer
    from bitnuc_tpu.sequence import PackedReads

    n = 16 * 40 - 3
    seqs = [
        bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=n))
        for _ in range(3)
    ]
    r = PackedReads.from_ascii(seqs)
    for k in (2, 8):
        want = _oracle_hist(seqs, k)
        np.testing.assert_array_equal(
            np.asarray(kmer.count_kmers_dense(r.words, r.lengths, k)), want)
        np.testing.assert_array_equal(
            np.asarray(kmer.count_kmers_dense_mxu(r.words, r.lengths, k)), want)


@pytest.mark.parametrize("k", [9])
@pytest.mark.parametrize("canonical", [False, True])
def test_histogram_k9_parity(rng, k, canonical):
    """mode='mxu' beyond MAX_MXU_K takes the scatter: identical to
    count_kmers_dense, canonical keys and N-skip masks included."""
    from bitnuc_tpu.ops import kmer

    assert k > kmer.MAX_MXU_K
    words = jnp.asarray(rng.integers(0, 2**32, (24, 12), np.uint32))
    lens = jnp.asarray(rng.integers(0, 192, 24).astype(np.int32))
    bv = rng.random((24, 192)) < 0.97
    got = kmer.count_kmers_reads(
        words, lens, k, mode="mxu", canonical=canonical, base_valid=bv
    )
    want = kmer.count_kmers_dense(words, lens, k, canonical, base_valid=bv)
    assert np.array_equal(np.asarray(got), np.asarray(want))


def _planted_fits(rng, n, max_lead, max_edits, la_range):
    seqs_a, seqs_b = [], []
    for _ in range(n):
        a = random_seq(rng, int(rng.integers(*la_range))).upper()
        lead = random_seq(rng, int(rng.integers(0, max_lead))).upper()
        mm = bytearray(a)
        for _ in range(int(rng.integers(0, max_edits + 1))):
            p = int(rng.integers(0, max(len(mm), 1)))
            op = int(rng.integers(0, 3))
            ch = random_seq(rng, 1).upper()
            if op == 0 and mm:
                mm[p : p + 1] = ch
            elif op == 1 and mm:
                del mm[p]
            else:
                mm.insert(p, ch[0])
        seqs_a.append(a)
        seqs_b.append(lead + bytes(mm) + random_seq(rng, 30).upper())
    return seqs_a, seqs_b


def test_wavefront_fit_parity(rng):
    """The banded span fit at the mapper's widened band (_band_k8) ==
    the unbanded fit, bit-exact: costs, starts, ends — planted fits with
    edits, empty reads, ragged lengths."""
    from bitnuc_tpu.ops import align
    from bitnuc_tpu.sequence import PackedReads

    K8, off_hi_eff = align._band_k8(-16, 96)
    assert K8 % 8 == 0 and off_hi_eff >= 96
    assert align._band_k8(-16, off_hi_eff) == (K8, off_hi_eff)  # idempotent
    seqs_a, seqs_b = _planted_fits(rng, 24, 60, 3, (0, 140))
    ra = PackedReads.from_ascii(seqs_a)
    rb = PackedReads.from_ascii(seqs_b)
    full = align.fit_distance_span(ra.words, ra.lengths, rb.words, rb.lengths, 1, 1)
    got = align.fit_distance_span_banded(
        ra.words, ra.lengths, rb.words, rb.lengths, 1, 1,
        off_lo=-16, off_hi=off_hi_eff,
    )
    for name, (f, g) in zip(("cost", "start", "end"), zip(full, got)):
        np.testing.assert_array_equal(np.asarray(f), np.asarray(g), err_msg=name)


def test_wavefront_fit_weights_parity(rng):
    """Non-unit (mismatch, gap) costs through the widened band."""
    from bitnuc_tpu.ops import align
    from bitnuc_tpu.sequence import PackedReads

    _, off_hi_eff = align._band_k8(-8, 40)
    seqs_a, seqs_b = _planted_fits(rng, 8, 30, 2, (4, 60))
    ra = PackedReads.from_ascii(seqs_a)
    rb = PackedReads.from_ascii(seqs_b)
    full = align.fit_distance_span(ra.words, ra.lengths, rb.words, rb.lengths, 3, 2)
    got = align.fit_distance_span_banded(
        ra.words, ra.lengths, rb.words, rb.lengths, 3, 2,
        off_lo=-8, off_hi=off_hi_eff,
    )
    for name, (f, g) in zip(("cost", "start", "end"), zip(full, got)):
        np.testing.assert_array_equal(np.asarray(f), np.asarray(g), err_msg=name)


def test_sw_pallas_parity(rng):
    """The XLA Smith-Waterman wavefront == the host Gotoh oracle: scores
    and tie-ruled end coordinates, ragged lengths, two parameter sets."""
    from bitnuc_tpu.ops import align
    from bitnuc_tpu.sequence import PackedReads

    seqs_a, seqs_b = [], []
    for _ in range(12):
        seqs_a.append(random_seq(rng, int(rng.integers(0, 50))).upper())
        seqs_b.append(random_seq(rng, int(rng.integers(0, 70))).upper())
    base = random_seq(rng, 60).upper()
    seqs_a.append(base[10:50])  # planted local hit
    seqs_b.append(random_seq(rng, 20).upper() + base + random_seq(rng, 15).upper())
    ra = PackedReads.from_ascii(seqs_a)
    rb = PackedReads.from_ascii(seqs_b)
    for params in ((2, -3, -5, -2), (1, -1, -2, -1)):
        got = [np.asarray(x) for x in align.sw_score(
            ra.words, ra.lengths, rb.words, rb.lengths, *params)]
        for i, (a, b) in enumerate(zip(seqs_a, seqs_b)):
            want = oracle.sw_score(a, b, *params)
            assert tuple(int(g[i]) for g in got) == want, (i, params)


def test_mxu_batch_scan_parity(rng):
    """Triton batch kernel (interpret) at serving batch sizes (Q >= 128,
    several query blocks) and non-default tiles == XLA many-to-many."""
    from bitnuc_tpu.ops import hamming, hamming_triton

    for Q, W, D, nb, tq, td in ((5, 4, 200, 64, 32, 64),
                                (130, 9, 700, 137, 64, 256),
                                (64, 32, 600, 512, 16, 128)):
        qs = jnp.asarray(rng.integers(0, 2**32, (Q, W)).astype(np.uint32))
        db = jnp.asarray(rng.integers(0, 2**32, (W, D)).astype(np.uint32))
        want = np.asarray(hamming.hdist_many_to_many(qs, jnp.transpose(db), nb))
        got = np.asarray(hamming_triton.hdist_scan_batch(
            qs, db, nb, tile_q=tq, tile_d=td, interpret=True))
        assert np.array_equal(got, want), (Q, W, D, nb)


def test_batch_scan_dispatch_by_platform(monkeypatch):
    """hdist_many_to_many_wm takes the Triton kernel on a GPU platform and
    the XLA scan elsewhere — never the interpreter."""
    from bitnuc_tpu.ops import hamming, hamming_triton

    calls = []

    def fake_kernel(queries, db_wm, n_bases, **kw):
        calls.append((queries.shape, db_wm.shape, n_bases, kw))
        return jnp.zeros((queries.shape[0], db_wm.shape[1]), jnp.int32)

    monkeypatch.setattr(hamming_triton, "hdist_scan_batch", fake_kernel)
    qs = jnp.zeros((3, 2), jnp.uint32)
    wm = jnp.ones((2, 10), jnp.uint32)
    out = hamming.hdist_many_to_many_wm(qs, wm, 20)
    assert not calls and int(out[0, 0]) == 2  # CPU: XLA, base 0 of each word
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    hamming.hdist_many_to_many_wm(qs, wm, 20)
    assert calls == [((3, 2), (2, 10), 20, {})]


def test_word_masks_match_device_masks():
    """The kernel's baked per-word masks == bitops.word_valid_mask."""
    from bitnuc_tpu.ops import hamming_triton
    from bitnuc_tpu.utils import bitops

    for W, nb in ((1, 0), (1, 7), (2, 16), (3, 33), (32, 512), (4, 200)):
        want = np.asarray(bitops.word_valid_mask(W, jnp.asarray(nb)))
        assert tuple(int(x) for x in want) == hamming_triton.word_masks(W, nb)


def test_topk_smallest_batch_parity(rng):
    """Blocked one-pass batch top-k == the iterative per-row extractor
    (values, indices, tie rule, k > D sentinel tail)."""
    from bitnuc_tpu.ops import hamming

    for trial in range(5):
        Q = int(rng.integers(1, 9))
        D = int(rng.integers(1, 3000))
        k = int(rng.integers(1, 40))
        vals = jnp.asarray(rng.integers(0, 300, (Q, D)).astype(np.int32))
        want = jax.vmap(lambda row: hamming.topk_smallest(row, k))(vals)
        got = hamming.topk_smallest_batch(vals, k)
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w)), (trial, Q, D, k)
    # all-ties: index tiebreak must hold across chunk boundaries
    vals = jnp.zeros((3, 1500), jnp.int32)
    want = jax.vmap(lambda row: hamming.topk_smallest(row, 20))(vals)
    got = hamming.topk_smallest_batch(vals, 20)
    assert np.array_equal(np.asarray(got[0]), np.asarray(want[0]))
    assert np.array_equal(np.asarray(got[1]), np.asarray(want[1]))
