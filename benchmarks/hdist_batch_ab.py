"""A/B timing on one GPU: the Triton batch Hamming kernel against the plain
XLA scan, plus the two dense k=8 counting lowerings.

    python benchmarks/hdist_batch_ab.py [--reps N] [--out chiprun_out/ab.json]

Search rows time the whole PackedDB.search_batch(k=16) call (distances
plus top-k) both ways:
  xla     hamming.topk_batch_dispatch(hdist_many_to_many(q, wm.T), 16)
  kernel  PackedDB.search_batch on the GPU (hamming_triton.hdist_scan_batch)
in the order xla, kernel, kernel, xla, each with block_until_ready, after
one warm-up call that compiles. Both results are checked equal first.
Shapes: Q=64 and Q=256 over 1M x 512 bases, Q=256 over 1e7 x 512 bases
and Q=1 over 1e7 (single query: the XLA scan vs PackedDB.search, the
kernel at Q=1). A sweep
of the kernel's tile sizes times the distance matrix alone. The counting
rows time count_kmers_dense (scatter) and count_kmers_dense_mxu (one-hot
bf16 product) at k=8 over [1024, 16384].

Every time is host wall seconds around device work; the card's name and
power limit are printed first. Exits nonzero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _times(fn, reps):
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return ts


def _summary(ts):
    return {"median_s": statistics.median(ts), "min_s": min(ts),
            "max_s": max(ts), "all_s": ts}


def ab(name, fa, fb, reps, check=True):
    """Warm both, check equal, then time a, b, b, a."""
    import jax
    import numpy as np

    ra = jax.device_get(fa())
    rb = jax.device_get(fb())
    if check:
        for x, y in zip(jax.tree_util.tree_leaves(ra), jax.tree_util.tree_leaves(rb)):
            if not np.array_equal(np.asarray(x), np.asarray(y)):
                raise AssertionError(f"{name}: results differ")
    del ra, rb
    ta = _times(fa, reps)
    tb = _times(fb, 2 * reps)
    ta += _times(fa, reps)
    row = {"row": name, "a": _summary(ta), "b": _summary(tb)}
    row["b_over_a_median"] = row["b"]["median_s"] / row["a"]["median_s"]
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        print("hdist_batch_ab: no GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print("card:", card, flush=True)

    from bitnuc_tpu import config
    from bitnuc_tpu.database import PackedDB
    from bitnuc_tpu.ops import hamming, hamming_triton, kmer

    config.enable_compilation_cache()
    rows = []
    nb, W = 512, 32
    key = jax.random.key(0)

    for q, d in [(64, 1 << 20), (256, 1 << 20), (256, 10_000_000)]:
        k1, k2, key = jax.random.split(key, 3)
        wm = jax.random.bits(k1, (W, d), jnp.uint32)
        qs = jax.random.bits(k2, (q, W), jnp.uint32)
        db = PackedDB(words_wm=wm, n_bases=nb)

        def xla():
            dist = hamming.hdist_many_to_many(qs, jnp.transpose(wm), nb)
            return hamming.topk_batch_dispatch(dist, 16, nb)

        rows.append(ab(f"search_batch Q={q} D={d}: a=xla b=kernel", xla,
                       lambda: db.search_batch(qs, 16), args.reps))
        if q == 256 and d == 10_000_000:
            for tq, td, nw, ns in [(32, 128, 4, 2), (16, 128, 4, 2),
                                   (32, 64, 4, 2), (64, 128, 8, 2),
                                   (32, 128, 2, 2), (16, 64, 2, 2),
                                   (32, 256, 4, 2)]:
                f = lambda: hamming_triton.hdist_scan_batch(
                    qs, wm, nb, tile_q=tq, tile_d=td, num_warps=nw,
                    num_stages=ns)
                jax.block_until_ready(f())
                r = {"row": f"kernel tiles tq={tq} td={td} warps={nw} "
                     f"stages={ns} Q={q} D={d}", **_summary(_times(f, args.reps))}
                print(json.dumps(r), flush=True)
                rows.append(r)
            q1 = qs[0]
            rows.append(ab(
                f"single query D={d}: a=xla scan b=PackedDB.search (kernel Q=1)",
                lambda: hamming.topk_smallest(hamming.hdist_one_to_many(
                    q1, jnp.transpose(wm), nb), 16),
                lambda: db.search(q1, 16),
                args.reps))
        del wm, qs, db

    k1, key = jax.random.split(key)
    words = jax.random.bits(k1, (1024, 16384 // 16), jnp.uint32)
    lens = jnp.full((1024,), 16384, jnp.int32)
    rows.append(ab("count k=8 [1024, 16384]: a=scatter b=onehot-bf16-dot",
                   lambda: kmer.count_kmers_dense(words, lens, 8),
                   lambda: kmer.count_kmers_dense_mxu(words, lens, 8),
                   args.reps))

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "jax": jax.__version__,
                       "device_kind": jax.devices()[0].device_kind,
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
