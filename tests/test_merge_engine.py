"""Merging two sorted counted k-mer lists: ops.setops.combine_counts (one
lax.sort over the concatenated lists, then neighbour pairing) against the
dict algebra of setops.combine_dicts, across list sizes, key-word ties,
heavy cross-list overlap, dead sentinel rows and lopsided inputs."""

import jax.numpy as jnp
import numpy as np
import pytest

from bitnuc_tpu.ops import setops

SENT = np.uint32(0xFFFFFFFF)


def _counted(rng, n, hi_range=1 << 32, lo_range=1 << 32):
    """A sorted counted list of n distinct (hi, lo) keys, counts 1..99."""
    n_keys = min(n, hi_range * lo_range)
    keys = np.zeros(0, np.uint64)
    while len(keys) < n_keys:
        hi = rng.integers(0, hi_range, 2 * n_keys + 8, dtype=np.uint64)
        lo = rng.integers(0, lo_range, 2 * n_keys + 8, dtype=np.uint64)
        keys = np.unique(np.concatenate([keys, (hi << np.uint64(32)) | lo]))
    keys = np.sort(rng.choice(keys, n_keys, replace=False))
    return (
        (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        (keys >> np.uint64(32)).astype(np.uint32),
        rng.integers(1, 100, n_keys).astype(np.int32),
    )


def _as_dict(lo, hi, ct):
    return {
        (int(h) << 32) | int(l): int(c) for l, h, c in zip(lo, hi, ct) if c > 0
    }


def _check(a, b, mode="union_sum"):
    got = setops.combine_counts(
        *(jnp.asarray(x) for x in a), *(jnp.asarray(x) for x in b), mode=mode
    )
    lo, hi, ct = (np.asarray(x) for x in got[:3])
    nu = int(got[3])
    want = setops.combine_dicts(_as_dict(*a), _as_dict(*b), mode)
    assert nu == len(want)
    assert _as_dict(lo[:nu], hi[:nu], ct[:nu]) == want
    keys = (hi[:nu].astype(np.uint64) << np.uint64(32)) | lo[:nu]
    assert np.all(keys[1:] > keys[:-1])  # live rows ascending, distinct
    assert not ct[nu:].any()
    return got


@pytest.mark.parametrize("na,nb", [(5, 3), (100, 28), (700, 300)])
def test_merge_small(na, nb):
    rng = np.random.default_rng(na * 1000 + nb)
    _check(_counted(rng, na), _counted(rng, nb))


@pytest.mark.parametrize(
    "na,nb", [(600, 424), (1024, 1024), (5000, 3000), (40000, 30000)]
)
def test_merge_single_key(na, nb):
    # single key word: hi = 0 throughout (k <= 16)
    rng = np.random.default_rng(na + nb)
    _check(_counted(rng, na, hi_range=1), _counted(rng, nb, hi_range=1))


def test_merge_beyond_one_block():
    rng = np.random.default_rng(7)
    _check(_counted(rng, 70000), _counted(rng, 70000))


def test_merge_two_key_words():
    # many hi-word ties: the lo word decides
    rng = np.random.default_rng(11)
    _check(
        _counted(rng, 3000, hi_range=4, lo_range=2000),
        _counted(rng, 2000, hi_range=4, lo_range=2000),
        "intersect_min",
    )


def test_merge_three_key_words():
    # both words drawn from tiny ranges: almost every key in both lists
    rng = np.random.default_rng(13)
    _check(
        _counted(rng, 1500, hi_range=3, lo_range=600),
        _counted(rng, 1700, hi_range=3, lo_range=600),
        "union_max",
    )


def test_merge_heavy_duplicates():
    # massive cross-list key overlap: the regime setops/accumulator see
    rng = np.random.default_rng(17)
    _check(
        _counted(rng, 40, hi_range=1, lo_range=50),
        _counted(rng, 45, hi_range=1, lo_range=50),
        "subtract",
    )


def test_merge_with_real_sentinels():
    # dead rows (ct == 0) under the all-ones sentinel key in both inputs,
    # beside a LIVE all-ones key (the k=32 all-T k-mer) in one of them
    rng = np.random.default_rng(19)
    a = [np.concatenate([x, y]) for x, y in zip(
        _counted(rng, 2000, lo_range=1 << 20),
        (np.full(50, SENT), np.full(50, SENT), np.zeros(50, np.int32)))]
    b = [np.concatenate([x, y]) for x, y in zip(
        _counted(rng, 1000, lo_range=1 << 20),
        (np.full(31, SENT), np.full(31, SENT), np.zeros(31, np.int32)))]
    b[2][1000] = 7  # live all-ones key ahead of b's dead rows
    for mode in ("union_sum", "intersect_min"):
        _check(a, b, mode)


def test_merge_empty_and_lopsided():
    rng = np.random.default_rng(23)
    _check(_counted(rng, 0), _counted(rng, 3000))
    _check(_counted(rng, 3000), _counted(rng, 1))


def test_merge_pad_values():
    # compact=False keeps the static length len(A) + len(B): live results
    # first (ascending), every other row dead
    rng = np.random.default_rng(29)
    a, b = _counted(rng, 1000), _counted(rng, 500)
    out = setops.combine_counts(
        *(jnp.asarray(x) for x in a), *(jnp.asarray(x) for x in b),
        mode="union_sum", compact=False,
    )
    lo, hi, ct = (np.asarray(x) for x in out[:3])
    assert lo.shape[0] == 1500
    assert _as_dict(lo, hi, ct) == setops.combine_dicts(
        _as_dict(*a), _as_dict(*b), "union_sum"
    )
    assert int(out[3]) == int((ct > 0).sum())
