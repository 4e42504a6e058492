"""Packed-domain ops (hamming, analysis, split/slice/get, kmer) vs the oracle."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from bitnuc_tpu import oracle
from bitnuc_tpu.ops import analysis, hamming, kmer, split
from bitnuc_tpu.sequence import PackedReads
from conftest import random_seq


def make_batch(rng, lens, upper=True):
    seqs = [random_seq(rng, n) for n in lens]
    if upper:
        seqs = [s.upper() for s in seqs]
    return seqs, PackedReads.from_ascii(seqs)


# --- hamming -------------------------------------------------------------------

def test_hdist_golden_pairs():
    a = PackedReads.from_ascii([b"AAAA", b"AAAA", b"ACTGACTG"])
    b = PackedReads.from_ascii([b"AAAA", b"TTTT", b"TGCATGCA"])
    d = hamming.hdist_words(a.words, b.words, a.lengths)
    np.testing.assert_array_equal(np.asarray(d), [0, 4, 8])


@pytest.mark.parametrize("n", [1, 16, 31, 32, 33, 64, 100, 256])
def test_hdist_vs_oracle(rng, n):
    s1, s2 = random_seq(rng, n).upper(), random_seq(rng, n).upper()
    r = PackedReads.from_ascii([s1, s2])
    d = hamming.hdist_words(r.words[0:1], r.words[1:2], jnp.asarray([n]))
    expect = oracle.hdist(oracle.encode(s1), oracle.encode(s2), n)
    assert int(np.asarray(d)[0]) == expect


def test_hdist_ignores_padding(rng):
    # identical prefixes, different junk beyond length -> distance 0
    a = PackedReads.from_ascii([b"ACGTACGTACGTACGTACGT"])          # 20 bases
    b = PackedReads.from_ascii([b"ACGTACGTACGTACGTACGTTTTTTTTT"])  # 28 bases
    d = hamming.hdist_words(a.words, b.words[:, : a.n_words], jnp.asarray([20]))
    assert int(np.asarray(d)[0]) == 0


def test_hdist_topk(rng):
    q = random_seq(rng, 64).upper()
    db_seqs = [q]  # exact match present
    for i in range(1, 20):
        s = bytearray(q)
        for j in range(i):  # i mutations
            s[j] = ord("A") if s[j] != ord("A") else ord("C")
        db_seqs.append(bytes(s))
    db = PackedReads.from_ascii(db_seqs)
    qr = PackedReads.from_ascii([q])
    dists, idxs = hamming.hdist_topk(qr.words[0], db.words, 64, 3)
    assert int(idxs[0]) == 0 and int(dists[0]) == 0
    assert list(np.asarray(dists)) == sorted(np.asarray(dists))


# --- analysis ------------------------------------------------------------------

@pytest.mark.parametrize("s,counts", [
    (b"ACGT", (1, 1, 1, 1)), (b"AAAA", (4, 0, 0, 0)),
    (b"CCCC", (0, 4, 0, 0)), (b"AACG", (2, 1, 1, 0)),
    (b"ACGTA", (2, 1, 1, 1)),
])
def test_base_counts_golden(s, counts):
    r = PackedReads.from_ascii([s])
    got = np.asarray(analysis.base_counts_reads(r.words, r.lengths))[0]
    assert tuple(got) == counts


def test_analysis_vs_oracle_batch(rng):
    lens = [1, 31, 32, 33, 100, 555]
    seqs, r = make_batch(rng, lens)
    bc = np.asarray(analysis.base_counts_reads(r.words, r.lengths))
    gc = np.asarray(analysis.gc_content_reads(r.words, r.lengths))
    for i, s in enumerate(seqs):
        e = oracle.encode(s)
        assert tuple(bc[i]) == oracle.base_counts(e, len(s))
        assert abs(gc[i] - oracle.gc_content(e, len(s))) < 1e-3


def test_gc_empty_read():
    r = PackedReads(words=jnp.zeros((1, 2), jnp.uint32), lengths=jnp.asarray([0]))
    assert float(analysis.gc_content_reads(r.words, r.lengths)[0]) == 0.0


# --- split / slice / get --------------------------------------------------------

def test_split_reads_vs_oracle(rng):
    n = 100
    s = random_seq(rng, n).upper()
    r = PackedReads.from_ascii([s] * (n + 1))
    idx = jnp.asarray(np.arange(n + 1, dtype=np.int32))
    left, right = split.split_reads(r.words, r.lengths, idx)
    from bitnuc_tpu.ops import codec

    left_ascii = np.asarray(codec.decode_reads_xla(left, idx))
    right_ascii = np.asarray(codec.decode_reads_xla(right, r.lengths - idx))
    for i in range(n + 1):
        assert bytes(left_ascii[i, :i]) == s[:i], i
        assert bytes(right_ascii[i, : n - i]) == s[i:], i


def test_slice_reads_vs_oracle(rng):
    n = 200
    s = random_seq(rng, n).upper()
    r = PackedReads.from_ascii([s] * 6)
    starts = jnp.asarray([0, 1, 31, 32, 150, 190], jnp.int32)
    sizes = jnp.asarray([10, 33, 40, 16, 50, 50], jnp.int32)
    out, out_len = split.slice_reads(r.words, r.lengths, starts, sizes)
    from bitnuc_tpu.ops import codec

    dec = np.asarray(codec.decode_reads_xla(out, out_len))
    ol = np.asarray(out_len)
    st, sz = np.asarray(starts), np.asarray(sizes)
    for i in range(6):
        expect = s[st[i] : min(st[i] + sz[i], n)]
        assert ol[i] == len(expect)
        assert bytes(dec[i, : ol[i]]) == expect, i


def test_get_reads(rng):
    s = random_seq(rng, 70).upper()
    r = PackedReads.from_ascii([s] * 70)
    idx = jnp.asarray(np.arange(70, dtype=np.int32))
    got = np.asarray(split.get_reads(r.words, r.lengths, idx))
    assert bytes(got) == s


def test_get_reads_out_of_range():
    r = PackedReads.from_ascii([b"ACGT"])
    assert int(split.get_reads(r.words, r.lengths, jnp.asarray([4]))[0]) == 0


# --- kmer ----------------------------------------------------------------------

def test_kmer_keys_match_as_2bit(rng):
    s = random_seq(rng, 64).upper()
    r = PackedReads.from_ascii([s])
    from bitnuc_tpu.utils import bitops

    codes = bitops.unpack_words(r.words)
    for k in [1, 2, 3, 4, 7, 8, 15, 16, 17, 21, 31, 32]:
        lo, hi = kmer.kmer_keys(codes, k)
        lo_np, hi_np = np.asarray(lo)[0], np.asarray(hi)[0]
        for p in range(0, 64 - k + 1, 5):
            expect = oracle.as_2bit(s[p : p + k])
            got = (int(hi_np[p]) << 32) | int(lo_np[p])
            assert got == expect, (k, p)


def test_count_kmers_dense_readme():
    r = PackedReads.from_ascii([b"ACGTACGT"])
    hist = np.asarray(kmer.count_kmers_dense(r.words, r.lengths, 4))
    assert hist[oracle.as_2bit(b"ACGT")] == 2
    assert hist.sum() == 5  # 8 - 4 + 1 windows


@pytest.mark.parametrize("k", [1, 3, 4, 8, 11])
def test_count_kmers_dense_vs_oracle(rng, k):
    lens = [k, k + 1, 50, 100, 333]
    seqs, r = make_batch(rng, lens)
    hist = np.asarray(kmer.count_kmers_dense(r.words, r.lengths, k))
    expect = {}
    for s in seqs:
        for key, c in oracle.count_kmers(s, k).items():
            expect[key] = expect.get(key, 0) + c
    assert hist.sum() == sum(expect.values())
    for key, c in expect.items():
        assert hist[key] == c


@pytest.mark.parametrize("k", [4, 8, 15, 16, 17, 21, 31, 32])
def test_count_kmers_sorted_vs_oracle(rng, k):
    lens = [k, 100, 500]
    seqs, r = make_batch(rng, lens)
    lo, hi, counts, n_unique = kmer.count_kmers_sorted(r.words, r.lengths, k)
    lo, hi, counts = np.asarray(lo), np.asarray(hi), np.asarray(counts)
    n_unique = int(n_unique)
    got = {}
    for i in range(n_unique):
        key = (int(hi[i]) << 32) | int(lo[i])
        if counts[i] > 0:
            got[key] = int(counts[i])
    expect = {}
    for s in seqs:
        for key, c in oracle.count_kmers(s, k).items():
            expect[key] = expect.get(key, 0) + c
    assert got == expect


def test_count_kmers_shorter_than_k():
    r = PackedReads.from_ascii([b"ACG"])  # shorter than k=4
    hist = np.asarray(kmer.count_kmers_dense(r.words, r.lengths, 4))
    assert hist.sum() == 0


def test_top_kmers():
    r = PackedReads.from_ascii([b"AAAAAAAAAA"])  # 7 windows of AAAA
    hist = kmer.count_kmers_dense(r.words, r.lengths, 4)
    counts, keys = kmer.top_kmers(hist, 1)
    assert int(counts[0]) == 7 and int(keys[0]) == 0


def test_top_kmers_order_and_ties():
    # AAAA x3 windows, CCCC x2, plus singles; descending counts, ties by key
    r = PackedReads.from_ascii([b"AAAAAA", b"CCCCC"])
    hist = np.asarray(kmer.count_kmers_dense(r.words, r.lengths, 4))
    counts, keys = kmer.top_kmers(jnp.asarray(hist), 4)
    counts, keys = np.asarray(counts), np.asarray(keys)
    order = np.lexsort((np.arange(hist.size), -hist))[:4]
    assert np.array_equal(keys, order)
    assert np.array_equal(counts, hist[order])
    # n > histogram size: sentinel tail, not phantom entries
    tiny = jnp.asarray(np.array([5, 0, 0, 2], np.int32))
    c2, k2 = kmer.top_kmers(tiny, 6)
    assert list(np.asarray(k2[:2])) == [0, 3] and list(np.asarray(c2[:2])) == [5, 2]
    assert all(np.asarray(k2[4:]) == -1)


def test_packed_db_search(rng):
    import bitnuc_tpu as bn
    from bitnuc_tpu.ops import hamming

    D, L = 500, 96
    bases = np.frombuffer(b"ACGT", np.uint8)
    db_ascii = rng.choice(bases, size=(D, L))
    reads = bn.PackedReads.from_ascii(db_ascii, lengths=np.full(D, L, np.int32))
    db = bn.PackedDB.from_reads(reads)
    assert len(db) == D and db.n_bases == L

    q = reads.words[7]
    want = np.asarray(hamming.hdist_one_to_many(q, reads.words, L))
    got = np.asarray(db.distances(q))
    np.testing.assert_array_equal(want, got)
    d, i = db.search(q, 3)
    assert int(d[0]) == 0 and int(i[0]) == 7

    # u64 roundtrip construction
    db2 = bn.PackedDB.from_u64(reads.to_u64(), L)
    np.testing.assert_array_equal(
        np.asarray(db2.words_wm), np.asarray(db.words_wm)
    )

    # pytree: flows through jit
    import jax

    d2 = jax.jit(lambda db, q: db.distances(q))(db, q)
    np.testing.assert_array_equal(np.asarray(d2), want)


@pytest.mark.parametrize("k,w", [(5, 1), (5, 4), (8, 7), (13, 10), (3, 16)])
def test_minimizers_vs_naive(rng, k, w):
    import bitnuc_tpu as bn
    from bitnuc_tpu.ops import kmer

    B, L = 3, 80
    arr = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    reads = bn.PackedReads.from_ascii(arr, lengths=lens)
    vals, valid = kmer.minimizers(reads.words, reads.lengths, k, w)
    vals, valid = np.asarray(vals), np.asarray(valid)
    for b in range(B):
        n = int(lens[b])
        seq = bytes(arr[b, :n])
        kmers = [bn.as_2bit(seq[p : p + k]) for p in range(max(0, n - k + 1))]
        for p in range(vals.shape[1]):
            expect_valid = p + k + w - 1 <= n
            assert bool(valid[b, p]) == expect_valid, (b, p)
            if expect_valid:
                assert vals[b, p] == min(kmers[p : p + w]), (b, p)


def test_packed_db_save_load(tmp_path, rng):
    import bitnuc_tpu as bn

    reads = bn.PackedReads.from_ascii(
        rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(20, 64)),
        lengths=np.full(20, 64, np.int32),
    )
    db = bn.PackedDB.from_reads(reads)
    p = tmp_path / "db.npz"
    db.save(p)
    back = bn.PackedDB.load(p)
    assert back.n_bases == db.n_bases
    np.testing.assert_array_equal(np.asarray(back.words_wm), np.asarray(db.words_wm))
    d1, _ = db.search(reads.words[3], 2)
    d2, _ = back.search(reads.words[3], 2)
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))


@pytest.mark.parametrize("k,w", [(5, 4), (8, 7), (3, 16)])
def test_minimizer_positions_vs_naive(rng, k, w):
    import bitnuc_tpu as bn
    from bitnuc_tpu.ops import kmer

    B, L = 2, 70
    arr = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    lens = np.full(B, L, np.int32)
    reads = bn.PackedReads.from_ascii(arr, lengths=lens)
    vals, pos, valid = kmer.minimizer_positions(reads.words, reads.lengths, k, w)
    vals, pos, valid = np.asarray(vals), np.asarray(pos), np.asarray(valid)
    for b in range(B):
        seq = bytes(arr[b])
        kmers = [bn.as_2bit(seq[p : p + k]) for p in range(L - k + 1)]
        for p in range(L - k - w + 2):
            win = kmers[p : p + w]
            mv = min(win)
            mp = p + win.index(mv)
            assert valid[b, p]
            assert vals[b, p] == mv and pos[b, p] == mp, (b, p)


def test_minimizer_sketch_mask(rng):
    import bitnuc_tpu as bn
    from bitnuc_tpu.ops import kmer

    k, w, L = 5, 6, 60
    arr = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(1, L))
    reads = bn.PackedReads.from_ascii(arr, lengths=np.full(1, L, np.int32))
    vals, pos, valid = kmer.minimizer_positions(reads.words, reads.lengths, k, w)
    mask = np.asarray(kmer.minimizer_sketch_mask(pos, valid))
    pos, valid = np.asarray(pos), np.asarray(valid)
    # naive: positions of minimizer changes over the valid prefix
    want = []
    last = -2
    for p in range(L - k - w + 2):
        if pos[0, p] != last:
            want.append(p)
            last = pos[0, p]
    got = list(np.nonzero(mask[0])[0])
    assert got == want
    # each selected window's minimizer is distinct from its predecessor's
    sel = pos[0][mask[0]]
    assert all(sel[i] != sel[i - 1] for i in range(1, len(sel)))


def test_hdist_topk_batch_matches_per_query_loop(rng):
    from bitnuc_tpu.ops import hamming

    Q, D, L, k = 5, 40, 70, 4
    db = rng.integers(0, 2**32, size=(D, 10), dtype=np.uint32)
    qs = rng.integers(0, 2**32, size=(Q, 10), dtype=np.uint32)
    dd, ii = hamming.hdist_topk_batch(jnp.asarray(qs), jnp.asarray(db), L, k)
    for qi in range(Q):
        d1, i1 = hamming.hdist_topk(jnp.asarray(qs[qi]), jnp.asarray(db), L, k)
        np.testing.assert_array_equal(np.asarray(dd[qi]), np.asarray(d1))
        np.testing.assert_array_equal(np.asarray(ii[qi]), np.asarray(i1))


def test_packed_db_search_batch(rng):
    import bitnuc_tpu as bn
    from bitnuc_tpu.ops import hamming

    D, L, Q = 300, 80, 9
    bases = np.frombuffer(b"ACGT", np.uint8)
    db_ascii = rng.choice(bases, size=(D, L))
    reads = bn.PackedReads.from_ascii(db_ascii, lengths=np.full(D, L, np.int32))
    db = bn.PackedDB.from_reads(reads)
    qs = reads.words[:Q]

    want = np.asarray(hamming.hdist_many_to_many(qs, reads.words, L))
    np.testing.assert_array_equal(np.asarray(db.distances_batch(qs)), want)
    d, i = db.search_batch(qs, 3)
    d, i = np.asarray(d), np.asarray(i)
    assert all(d[q, 0] == 0 and i[q, 0] == q for q in range(Q))


def _runs_to_dict(lo, hi, cnt):
    lo, hi, cnt = np.asarray(lo), np.asarray(hi), np.asarray(cnt)
    out = {}
    for i in np.nonzero(cnt > 0)[0]:
        out[(int(hi[i]) << 32) | int(lo[i])] = int(cnt[i])
    return out


@pytest.mark.parametrize("k", [4, 8, 15, 16, 17, 21, 31, 32])
def test_count_kmers_runs_vs_oracle(rng, k):
    lens = [k, 100, 500]
    seqs, r = make_batch(rng, lens)
    lo, hi, cnt, nu = kmer.count_kmers_runs(r.words, r.lengths, k)
    got = _runs_to_dict(lo, hi, cnt)
    assert int(nu) == len(got)
    expect = {}
    for s in seqs:
        for key, c in oracle.count_kmers(s, k).items():
            expect[key] = expect.get(key, 0) + c
    assert got == expect
    # identical content to the compacted reference path
    lo2, hi2, cnt2, nu2 = kmer.count_kmers_sorted(r.words, r.lengths, k)
    assert got == _runs_to_dict(lo2, hi2, cnt2) and int(nu) == int(nu2)


def test_count_kmers_runs_allT_sentinel_ambiguity():
    # k=32: the genuine all-T key equals the invalid-slot sentinel; the
    # analytic subtraction must leave exactly the real windows
    r = PackedReads.from_ascii([b"T" * 40, b"ACG"])  # 9 all-T windows + all-invalid read
    lo, hi, cnt, nu = kmer.count_kmers_runs(r.words, r.lengths, 32)
    got = _runs_to_dict(lo, hi, cnt)
    assert got == {(1 << 64) - 1: 9} and int(nu) == 1


def test_count_kmers_runs_no_valid_windows():
    r = PackedReads.from_ascii([b"ACG"])
    lo, hi, cnt, nu = kmer.count_kmers_runs(r.words, r.lengths, 21)
    assert int(nu) == 0 and _runs_to_dict(lo, hi, cnt) == {}


def test_count_kmers_runs_canonical(rng):
    seqs, r = make_batch(rng, [60, 33])
    lo, hi, cnt, _ = kmer.count_kmers_runs(r.words, r.lengths, 17, canonical=True)
    lo2, hi2, cnt2, _ = kmer.count_kmers_sorted(r.words, r.lengths, 17, canonical=True)
    assert _runs_to_dict(lo, hi, cnt) == _runs_to_dict(lo2, hi2, cnt2)


def test_weighted_runs_from_sorted(rng):
    # random duplicated keys with weights; zero-weight sentinel tail
    n_real, n_dead = 500, 37
    hi = rng.integers(0, 4, n_real).astype(np.uint32)
    lo = rng.integers(0, 10, n_real).astype(np.uint32)
    w = rng.integers(1, 7, n_real).astype(np.int32)
    sent = np.uint32(0xFFFFFFFF)
    hi = np.concatenate([hi, np.full(n_dead, sent)])
    lo = np.concatenate([lo, np.full(n_dead, sent)])
    w = np.concatenate([w, np.zeros(n_dead, np.int32)])
    hi_s, lo_s, w_s = jax.lax.sort(
        (jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(w)), num_keys=2
    )
    lo_o, hi_o, tot, nu = kmer.weighted_runs_from_sorted(hi_s, lo_s, w_s)
    glo, ghi, gct = kmer.compact_runs(lo_o, hi_o, tot)
    got = {(int(ghi[i]), int(glo[i])): int(gct[i]) for i in range(len(gct))}
    expect = {}
    for h, l, ww in zip(hi[:n_real], lo[:n_real], w[:n_real]):
        expect[(int(h), int(l))] = expect.get((int(h), int(l)), 0) + int(ww)
    assert got == expect and int(nu) == len(expect)


@pytest.mark.parametrize("mode,k", [("dense", 4), ("mxu", 5), ("runs", 21), ("sorted", 17)])
def test_count_kmers_skip_invalid_windows(rng, mode, k):
    """base_valid drops exactly the windows containing an N (the reference
    can only refuse the sequence; streaming engines need the skip policy)."""
    from bitnuc_tpu.ops import codec

    B, L = 6, 80
    a = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, L))
    for _ in range(12):
        a[rng.integers(B), rng.integers(L)] = ord("N")
    lens = rng.integers(k, L + 1, size=B).astype(np.int32)
    words, _ = codec.encode_reads(jnp.asarray(a), jnp.asarray(lens))
    bv = codec.validity_mask(jnp.asarray(a), jnp.asarray(lens))

    out = kmer.count_kmers_reads(
        words, jnp.asarray(lens), k, mode=mode, base_valid=bv
    )
    expect = {}
    for r in range(B):
        s = bytes(a[r, : lens[r]])
        for p in range(len(s) - k + 1):
            win = s[p : p + k]
            if b"N" in win:
                continue
            expect[oracle.as_2bit(win)] = expect.get(oracle.as_2bit(win), 0) + 1
    if mode in ("dense", "mxu"):
        hist = np.asarray(out)
        assert hist.sum() == sum(expect.values())
        for key, c in expect.items():
            assert hist[key] == c
    else:
        lo, hi, cnt, nu = out
        if mode == "runs":
            glo, ghi, gct = kmer.compact_runs(lo, hi, cnt)
        else:
            glo = np.asarray(lo)[: int(nu)]
            ghi = np.asarray(hi)[: int(nu)]
            gct = np.asarray(cnt)[: int(nu)]
        got = {
            (int(ghi[i]) << 32) | int(glo[i]): int(gct[i]) for i in range(len(gct))
        }
        assert got == expect


def test_minimizer_sketch_and_jaccard(rng):
    """Sketch = distinct minimizer values; jaccard/containment match python
    set arithmetic on independently computed minimizer sets."""
    k, w = 7, 5

    def py_minimizers(seq):
        keys = [oracle.as_2bit(seq[p : p + k]) for p in range(len(seq) - k + 1)]
        return {min(keys[p : p + w]) for p in range(len(keys) - w + 1)}

    a = random_seq(rng, 300).upper()
    b = bytearray(a)
    for _ in range(30):  # mutate ~10%
        b[rng.integers(len(b))] = ord("ACGT"[rng.integers(4)])
    b = bytes(b)

    ra, rb = PackedReads.from_ascii([a]), PackedReads.from_ascii([b])
    va, na = kmer.minimizer_sketch(ra.words, ra.lengths, k, w)
    vb, nb = kmer.minimizer_sketch(rb.words, rb.lengths, k, w)
    sa, sb = py_minimizers(a), py_minimizers(b)
    assert int(na) == len(sa) and int(nb) == len(sb)
    got_a = set(int(v) for v in np.asarray(va)[: int(na)])
    assert got_a == sa

    jac = float(kmer.sketch_jaccard(va, vb))
    want = len(sa & sb) / len(sa | sb)
    assert abs(jac - want) < 1e-6
    con = float(kmer.sketch_containment(va, vb))
    assert abs(con - len(sa & sb) / len(sa)) < 1e-6
    # identity and empty edges
    assert float(kmer.sketch_jaccard(va, va)) == 1.0
    empty = jnp.full_like(va, 0xFFFFFFFF)
    assert float(kmer.sketch_jaccard(empty, empty)) == 0.0
    assert float(kmer.sketch_containment(empty, va)) == 0.0


def test_minimizer_sketch_rejects_k16():
    r = PackedReads.from_ascii([b"ACGT" * 20])
    with pytest.raises(AssertionError):
        kmer.minimizer_sketch(r.words, r.lengths, 16, 4)


def test_packed_db_from_fastq(tmp_path, rng):
    import bitnuc_tpu as bn

    L, D = 64, 37
    seqs = [
        bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=L))
        for _ in range(D)
    ]
    p = tmp_path / "db.fq"
    with open(p, "wb") as f:
        for i, s in enumerate(seqs):
            f.write(b"@d%d\n%s\n+\n%s\n" % (i, s, b"I" * L))
    db = bn.PackedDB.from_fastq(p, L, batch_size=8)
    assert len(db) == D and db.n_bases == L
    want = bn.PackedDB.from_reads(
        bn.PackedReads.from_ascii(seqs, lengths=np.full(D, L, np.int32))
    )
    np.testing.assert_array_equal(
        np.asarray(db.words_wm), np.asarray(want.words_wm)
    )
    d, i = db.search(want.words_wm[:, 11], 1)
    assert int(d[0]) == 0 and int(i[0]) == 11


# --- abundance spectrum --------------------------------------------------------

def _naive_spectrum(count_dict, max_mult):
    out = [0] * (max_mult + 1)
    for c in count_dict.values():
        out[min(c, max_mult)] += 1
    return out


@pytest.mark.parametrize("k", [4, 8, 17, 21])
def test_spectrum_vs_oracle_all_layouts(rng, k):
    # repeats guaranteed: small alphabet windows over repeated + random reads
    seqs, r = make_batch(rng, [200, 64, k + 3])
    seqs2 = [seqs[0], seqs[0][:150]]  # duplicate content -> multiplicities > 1
    seqs = seqs + seqs2
    r = PackedReads.from_ascii(seqs)
    expect_counts = {}
    for s in seqs:
        for key, c in oracle.count_kmers(s, k).items():
            expect_counts[key] = expect_counts.get(key, 0) + c
    expect = _naive_spectrum(expect_counts, 7)

    lo, hi, cnt, _ = kmer.count_kmers_runs(r.words, r.lengths, k)
    assert list(np.asarray(kmer.spectrum(cnt, 7))) == expect
    lo2, hi2, cnt2, _ = kmer.count_kmers_sorted(r.words, r.lengths, k)
    assert list(np.asarray(kmer.spectrum(cnt2, 7))) == expect
    if k <= kmer.MAX_DENSE_K:
        hist = kmer.count_kmers_dense(r.words, r.lengths, k)
        assert list(np.asarray(kmer.spectrum(hist, 7))) == expect


def test_spectrum_clips_and_ignores_zeros():
    counts = jnp.asarray([0, 1, 1, 5, 9, 200, 0, 3], jnp.int64)
    got = list(np.asarray(kmer.spectrum(counts, 4)))
    # 1:2, 3:1, >=4 pools {5, 9, 200} -> 3
    assert got == [0, 2, 0, 1, 3]


# --- windowed GC ---------------------------------------------------------------

def _naive_windowed_gc(seq, w, step):
    out = []
    for p in range(0, len(seq) - w + 1, step):
        win = seq[p : p + w].upper()
        out.append(100.0 * sum(1 for b in win if b in b"GC") / w)
    return out


@pytest.mark.parametrize("w,step", [(10, 10), (10, 5), (33, 7), (1, 1)])
def test_windowed_gc_vs_oracle(rng, w, step):
    from bitnuc_tpu.ops.analysis import windowed_gc

    seqs = [random_seq(rng, int(n)).upper() for n in (100, 64, 40, 9)]
    r = PackedReads.from_ascii(seqs)
    pct, valid = windowed_gc(r.words, r.lengths, w, step)
    pct, valid = np.asarray(pct), np.asarray(valid)
    for i, s in enumerate(seqs):
        expect = _naive_windowed_gc(s, w, step)
        got = pct[i][valid[i]]
        assert len(got) == len(expect), (i, len(got), len(expect))
        np.testing.assert_allclose(got, expect, atol=1e-4)


def test_windowed_gc_cli(tmp_path, capsys):
    from bitnuc_tpu import cli

    p = tmp_path / "g.fa"
    p.write_bytes(b">c\nGGGGGAAAAA\nCCCCCTTTTT\n")
    assert cli.main(["gc", str(p), "-w", "5"]) == 0
    rows = [ln.split("\t") for ln in capsys.readouterr().out.strip().splitlines()]
    assert [(r[1], r[2]) for r in rows] == [
        ("0", "100.00"), ("5", "0.00"), ("10", "100.00"), ("15", "0.00")
    ]
    assert all(r[0] == "c" for r in rows)


def test_revcomp_cli(tmp_path, capsys):
    from bitnuc_tpu import cli

    p = tmp_path / "r.fa"
    p.write_bytes(b">x\nACGTTT\n")
    assert cli.main(["revcomp", str(p)]) == 0
    assert capsys.readouterr().out == ">x\nAAACGT\n"


@pytest.mark.parametrize("k", [16, 21, 31])
def test_minimizer_sketch64_and_jaccard(rng, k):
    """64-bit-key sketch (the Mash-scale k regime): distinct minimizer
    keys and jaccard/containment match python set arithmetic."""
    w = 5

    def py_minimizers(seq):
        keys = [oracle.as_2bit(seq[p : p + k]) for p in range(len(seq) - k + 1)]
        return {min(keys[p : p + w]) for p in range(len(keys) - w + 1)}

    a = random_seq(rng, 400).upper()
    b = bytearray(a)
    for _ in range(40):
        b[rng.integers(len(b))] = ord("ACGT"[rng.integers(4)])
    b = bytes(b)

    ra, rb = PackedReads.from_ascii([a]), PackedReads.from_ascii([b])
    alo, ahi, na = kmer.minimizer_sketch64(ra.words, ra.lengths, k, w)
    blo, bhi, nb = kmer.minimizer_sketch64(rb.words, rb.lengths, k, w)
    sa, sb = py_minimizers(a), py_minimizers(b)
    assert int(na) == len(sa) and int(nb) == len(sb)
    got_a = {
        (int(h) << 32) | int(l)
        for l, h in zip(np.asarray(alo)[: int(na)], np.asarray(ahi)[: int(na)])
    }
    assert got_a == sa
    # ascending by (hi, lo) at the front
    pairs = [
        (int(h), int(l))
        for l, h in zip(np.asarray(alo)[: int(na)], np.asarray(ahi)[: int(na)])
    ]
    assert pairs == sorted(pairs)

    jac = float(kmer.sketch_jaccard64(alo, ahi, blo, bhi))
    assert abs(jac - len(sa & sb) / len(sa | sb)) < 1e-6
    con = float(kmer.sketch_containment64(alo, ahi, blo, bhi))
    assert abs(con - len(sa & sb) / len(sa)) < 1e-6
    assert float(kmer.sketch_jaccard64(alo, ahi, alo, ahi)) == 1.0
    empty = jnp.full_like(alo, 0xFFFFFFFF)
    assert float(kmer.sketch_jaccard64(empty, empty, empty, empty)) == 0.0


def test_minimizer_sketch64_rejects_k32():
    r = PackedReads.from_ascii([b"ACGT" * 20])
    with pytest.raises(AssertionError):
        kmer.minimizer_sketch64(r.words, r.lengths, 32, 4)


def test_count_kmers_auto_dispatch_contract(monkeypatch):
    """The auto/auto_layout dispatch table is pure python on (mode, k) and
    the same on every platform — pin it so an elif reorder can't silently
    flip a branch."""
    import jax as _jax

    from bitnuc_tpu.ops import kmer as K

    rng = np.random.default_rng(0)
    reads_words = jnp.asarray(rng.integers(0, 2**32, (4, 4), dtype=np.uint32))
    lens = jnp.full((4,), 60, jnp.int32)

    def shapes(mode, k):
        out = K.count_kmers_reads(reads_words, lens, k, mode=mode)
        return "runs" if isinstance(out, tuple) else "dense"

    for platform in (None, "gpu"):
        if platform:  # the decision must not read the platform
            monkeypatch.setattr(_jax, "default_backend", lambda: platform)
        # dense return AND dense engine through MAX_DENSE_K
        for k in (8, 9, 12):
            assert shapes("auto", k) == "dense"
            assert shapes("auto_layout", k) == "dense"
        assert shapes("auto", 13) == "runs"  # beyond MAX_DENSE_K: runs
        assert shapes("auto_layout", 13) == "runs"
        # the pipeline boundary: dense wherever the histogram fits
        assert K.auto_dense_max_k() == K.MAX_DENSE_K
