"""Checks that need a GPU: the Triton batch Hamming kernel as compiled for
the card (not interpreted) and the float-product reductions that must stay
exact there. Marked `gpu`; each takes the `gpu` fixture and skips on other
platforms. Run on the card: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize(
    "Q,D,n_bases", [(256, 1 << 20, 512), (70, 100_003, 200), (1, 4097, 31)]
)
def test_triton_batch_scan_matches_xla(gpu, Q, D, n_bases):
    from bitnuc_tpu.ops import hamming, hamming_triton
    from bitnuc_tpu.utils import bitops

    W = bitops.n_words_for(n_bases)
    k1, k2 = jax.random.split(jax.random.key(Q + D))
    wm = jax.random.bits(k1, (W, D), jnp.uint32)
    qs = jax.random.bits(k2, (Q, W), jnp.uint32)
    got = hamming_triton.hdist_scan_batch(qs, wm, n_bases)
    want = hamming.hdist_many_to_many(qs, jnp.transpose(wm), n_bases)
    assert bool(jnp.array_equal(got, want))
    # the platform dispatch takes the kernel here
    assert bool(jnp.array_equal(hamming.hdist_many_to_many_wm(qs, wm, n_bases), want))


def test_search_batch_matches_numpy(gpu):
    from bitnuc_tpu.database import PackedDB

    rng = np.random.default_rng(0)
    db = rng.integers(0, 2**32, (50_000, 32), dtype=np.uint32)
    qs = rng.integers(0, 2**32, (40, 32), dtype=np.uint32)
    db[[7, 11, 40_000]] = qs[0]  # exact copies: ties by lowest index
    pdb = PackedDB(words_wm=jnp.asarray(db.T.copy()), n_bases=512)
    d, i = (np.asarray(x) for x in pdb.search_batch(jnp.asarray(qs), 16))
    x = db[None, :, :] ^ qs[:, None, :]
    x = (x | (x >> 1)) & np.uint32(0x55555555)
    want = np.vectorize(lambda v: bin(v).count("1"))(x).sum(-1)
    order = np.argsort(want, axis=1, kind="stable")[:, :16]
    np.testing.assert_array_equal(i, order)
    np.testing.assert_array_equal(d, np.take_along_axis(want, order, 1))
    assert i[0, :3].tolist() == [7, 11, 40_000]


def test_float_product_reductions_exact(gpu):
    """The f32 word-sum dot (HIGHEST precision) and the bf16 one-hot
    histogram product stay integer-exact on the card."""
    from bitnuc_tpu.ops import hamming, kmer

    key = jax.random.key(1)
    q = jax.random.bits(key, (64,), jnp.uint32)
    db = jnp.zeros((1000, 64), jnp.uint32)  # every base differs from q or not
    d = np.asarray(hamming.hdist_one_to_many(q, db, 1024))
    qb = np.asarray(q)
    want = sum(
        bin(int(((w | (w >> 1)) & 0x55555555))).count("1") for w in qb
    )
    assert (d == want).all()
    words = jax.random.bits(key, (1024, 1024), jnp.uint32)
    lens = jnp.full((1024,), 16384, jnp.int32)
    assert bool(jnp.array_equal(
        kmer.count_kmers_dense_mxu(words, lens, 8),
        kmer.count_kmers_dense(words, lens, 8),
    ))
