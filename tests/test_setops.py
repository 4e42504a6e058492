"""combine_counts vs the host-dict oracle across modes, layouts (sorted and
run-start inputs), and the k=32 all-T-equals-sentinel edge."""

import numpy as np
import pytest

from conftest import random_seq

from bitnuc_tpu import oracle
from bitnuc_tpu.ops import kmer, setops
from bitnuc_tpu.sequence import PackedReads


def _count_dict(seqs, k):
    out = {}
    for s in seqs:
        for key, c in oracle.count_kmers(s, k).items():
            out[key] = out.get(key, 0) + c
    return out


def _device_counts(seqs, k, engine):
    r = PackedReads.from_ascii(seqs)
    lo, hi, ct, _ = engine(r.words, r.lengths, k)
    return lo, hi, ct


def _to_dict(lo, hi, ct, n):
    lo, hi, ct = np.asarray(lo), np.asarray(hi), np.asarray(ct)
    n = int(n)
    assert (ct[:n] > 0).all() and (ct[n:] == 0).all()
    keys = (hi[:n].astype(np.uint64) << np.uint64(32)) | lo[:n].astype(np.uint64)
    assert list(keys) == sorted(keys), "result keys must be ascending"
    return {int(k): int(c) for k, c in zip(keys, ct[:n])}


@pytest.mark.parametrize("mode", setops.MODES)
@pytest.mark.parametrize("k", [8, 21])
@pytest.mark.parametrize("engine", [kmer.count_kmers_sorted, kmer.count_kmers_runs])
def test_combine_matches_dict_oracle(rng, mode, k, engine):
    shared = [random_seq(rng, 80).upper() for _ in range(3)]
    a_seqs = shared + [random_seq(rng, 60).upper() for _ in range(4)]
    b_seqs = shared[:2] + [random_seq(rng, 70).upper() for _ in range(4)]
    a = _device_counts(a_seqs, k, engine)
    b = _device_counts(b_seqs, k, engine)
    got = _to_dict(*setops.combine_counts(*a, *b, mode=mode))
    expect = setops.combine_dicts(
        _count_dict(a_seqs, k), _count_dict(b_seqs, k), mode
    )
    assert got == expect


@pytest.mark.parametrize("mode", setops.MODES)
def test_combine_k32_all_t_sentinel(mode):
    # the genuine all-T 32-mer packs to 0xFFFF...F == the dead-row sentinel;
    # it must survive pairing and compaction in every mode
    a_seqs = [b"T" * 40, b"ACGT" * 10]
    b_seqs = [b"T" * 36, b"A" * 40]
    a = _device_counts(a_seqs, 32, kmer.count_kmers_sorted)
    b = _device_counts(b_seqs, 32, kmer.count_kmers_sorted)
    got = _to_dict(*setops.combine_counts(*a, *b, mode=mode))
    expect = setops.combine_dicts(
        _count_dict(a_seqs, 32), _count_dict(b_seqs, 32), mode
    )
    assert got == expect
    assert ((1 << 64) - 1) in expect  # the edge is actually exercised


def test_combine_disjoint_and_empty(rng):
    a_seqs = [b"A" * 30]
    b_seqs = [b"C" * 30]
    a = _device_counts(a_seqs, 21, kmer.count_kmers_sorted)
    b = _device_counts(b_seqs, 21, kmer.count_kmers_sorted)
    inter = _to_dict(*setops.combine_counts(*a, *b, mode="intersect_min"))
    assert inter == {}
    sub = _to_dict(*setops.combine_counts(*a, *b, mode="subtract"))
    assert sub == _count_dict(a_seqs, 21)
    # subtracting a superset empties the result
    sub2 = _to_dict(*setops.combine_counts(*a, *a, mode="subtract"))
    assert sub2 == {}


def test_union_sum_matches_merge_sorted_runs(rng):
    seqs_a = [random_seq(rng, 50).upper() for _ in range(3)]
    seqs_b = [random_seq(rng, 50).upper() for _ in range(3)]
    a = _device_counts(seqs_a, 17, kmer.count_kmers_runs)
    b = _device_counts(seqs_b, 17, kmer.count_kmers_runs)
    got = _to_dict(*setops.combine_counts(*a, *b, mode="union_sum"))
    assert got == setops.combine_dicts(
        _count_dict(seqs_a, 17), _count_dict(seqs_b, 17), "union_sum"
    )


@pytest.mark.parametrize("k", [4, 21])
def test_setop_cli(tmp_path, capsys, k):
    a = tmp_path / "a.fa"
    b = tmp_path / "b.fa"
    a.write_bytes(b">x\nACGTACGTACGTACGTACGTACGT\n>y\nGGGGGGGGGGGGGGGGGGGGGGGG\n")
    b.write_bytes(b">z\nACGTACGTACGTACGTACGTACGT\n")
    from bitnuc_tpu import cli

    assert cli.main(["setop", "subtract", str(a), str(b), "-k", str(k)]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    expect = setops.combine_dicts(
        _count_dict([b"ACGTACGTACGTACGTACGTACGT", b"G" * 24], k),
        _count_dict([b"ACGTACGTACGTACGTACGTACGT"], k),
        "subtract",
    )
    got = {
        oracle.as_2bit(ln.split("\t")[0].encode()): int(ln.split("\t")[1])
        for ln in out
    }
    assert got == expect


@pytest.mark.parametrize("mode", ["intersect_min", "union_sum", "union_max", "subtract"])
def test_combine_compact_false_chains(rng, mode):
    """compact=False output (zero-count rows interleaved) must be a legal
    input to further combines and to compact_runs — the fast chain form."""
    from bitnuc_tpu.ops import kmer as K

    k = 11
    seq_sets = [
        [random_seq(rng, 90).upper() for _ in range(4)] for _ in range(3)
    ]
    shared = random_seq(rng, 120).upper()
    for s in seq_sets:
        s.append(shared)
    devs = [_device_counts(s, k, K.count_kmers_sorted) for s in seq_sets]
    mid = setops.combine_counts(*devs[0], *devs[1], mode=mode, compact=False)
    got_arrays = setops.combine_counts(*mid[:3], *devs[2], mode=mode)
    got = _to_dict(*got_arrays)
    d = [
        _count_dict(s, k) for s in seq_sets
    ]
    expect = setops.combine_dicts(setops.combine_dicts(d[0], d[1], mode), d[2], mode)
    assert got == expect
    # compact_runs densifies the compact=False layout directly
    lo, hi, ct, nu = mid
    clo, chi, cct = K.compact_runs(lo, hi, ct)
    mid_dict = {
        (int(h) << 32) | int(l): int(c) for l, h, c in zip(clo, chi, cct)
    }
    assert mid_dict == setops.combine_dicts(d[0], d[1], mode)


@pytest.mark.parametrize("compact", [True, False])
def test_combine_backend_invariant_arrays(rng, compact):
    """The RAW output arrays (not just the dict semantics) must not depend
    on the keys of dead rows: a dead suffix whose keys are arbitrary gives
    the same arrays as an all-ones one, with interior-dead run-start rows
    present on the other side."""
    import jax.numpy as jnp

    from bitnuc_tpu.ops import kmer as K

    k = 11
    seqs1 = [random_seq(rng, 80).upper() for _ in range(4)]
    seqs2 = [random_seq(rng, 80).upper() for _ in range(4)]
    lo_a, hi_a, ct_a = (np.asarray(x) for x in
                        _device_counts(seqs1, k, K.count_kmers_sorted))
    # run-start layout side: interior zero-count rows
    r = PackedReads.from_ascii(seqs2)
    b = K.count_kmers_runs(r.words, r.lengths, k)[:3]
    dead = ct_a <= 0
    assert dead[-1]  # the compact layout ends in a dead suffix
    outs = []
    for fill in (np.uint32(0xFFFFFFFF), None):
        lo_x, hi_x = lo_a.copy(), hi_a.copy()
        if fill is None:
            lo_x[dead] = rng.integers(0, 2**32, int(dead.sum()), np.uint32)
            hi_x[dead] = rng.integers(0, 2**32, int(dead.sum()), np.uint32)
        else:
            lo_x[dead] = fill
            hi_x[dead] = fill
        a = (jnp.asarray(lo_x), jnp.asarray(hi_x), jnp.asarray(ct_a))
        outs.append([
            np.asarray(x)
            for x in setops.combine_counts(*a, *b, mode="union_sum", compact=compact)
        ])
    for x, y, nm in zip(outs[0], outs[1], ("lo", "hi", "ct", "nu")):
        assert np.array_equal(x, y), nm


def test_setop_cli_chain(tmp_path, capsys):
    """Multi-input left-associative CLI chain: union_sum over three files
    equals the pairwise dict algebra."""
    from bitnuc_tpu.cli import main as cli_main
    from bitnuc_tpu import oracle

    rng = np.random.default_rng(4)
    paths, dicts = [], []
    k = 7
    for i in range(3):
        seqs = [random_seq(rng, 60).upper() for _ in range(3)]
        p = tmp_path / f"s{i}.fa"
        p.write_text("".join(f">r{j}\n{s.decode()}\n" for j, s in enumerate(seqs)))
        paths.append(str(p))
        d = {}
        for s in seqs:
            for key, c in oracle.count_kmers(s, k).items():
                d[key] = d.get(key, 0) + c
        dicts.append(d)
    rc = cli_main(["setop", "union_sum", *paths, "-k", str(k)])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    got = {}
    for ln in out:
        seq, c = ln.split("\t")
        got[oracle.as_2bit(seq.encode())] = int(c)
    expect = setops.combine_dicts(
        setops.combine_dicts(dicts[0], dicts[1], "union_sum"), dicts[2], "union_sum"
    )
    assert got == expect


def test_combine_validate_rejects_unsorted(rng):
    """validate=True must catch a broken sorted-input contract."""
    import jax.numpy as jnp

    lo = jnp.asarray(np.array([5, 3, 9], np.uint32))
    hi = jnp.zeros(3, jnp.uint32)
    ct = jnp.ones(3, jnp.int32)
    with pytest.raises(ValueError, match="not sorted"):
        setops.combine_counts(lo, hi, ct, lo, hi, ct, validate=True)
    # sorted inputs (with a dead suffix of arbitrary keys) pass
    slo = jnp.asarray(np.array([3, 5, 9, 7], np.uint32))
    sct = jnp.asarray(np.array([1, 1, 1, 0], np.int32))
    setops.combine_counts(slo, hi[:1].repeat(4), sct, slo, hi[:1].repeat(4), sct, validate=True)
