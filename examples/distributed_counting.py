"""Distributed k-mer counting over a device mesh.

Runs on real multi-chip hardware or on a simulated CPU mesh:

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python examples/distributed_counting.py

Shows both sharding regimes: batch-sharded reads (one psum merge) and one
very long sequence sharded across devices with a ppermute halo exchange for
windows crossing shard edges. Across several hosts, call
bitnuc_tpu.parallel.runtime.initialize() first.
"""

import os
import sys

sys.path.insert(0, ".")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import jax.numpy as jnp
import numpy as np

import bitnuc_tpu as bn
from bitnuc_tpu.parallel import kmer as pkmer, mesh as pmesh


def main():
    k = 6
    mesh = pmesh.make_mesh()
    n_dev = len(jax.devices())
    print(f"mesh: {n_dev} x {jax.devices()[0].platform}")

    # --- batch-sharded counting (DP) ---
    rng = np.random.default_rng(0)
    reads = bn.PackedReads.from_ascii(
        [bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=500))
         for _ in range(64)]
    )
    sharded = pmesh.shard_reads(reads, mesh)
    hist = pkmer.count_kmers_sharded(sharded.words, sharded.lengths, k, mesh)
    print(f"batch-sharded: {int(jnp.sum(hist))} windows counted "
          f"(expect {64 * (500 - k + 1)})")

    # --- sequence-sharded counting (SP analog, halo exchange) ---
    long_seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=16 * 1024))
    one = bn.PackedSequence(long_seq)
    words_u32 = bn.PackedReads.from_u64(
        np.asarray(one.data)[None, :], np.array([len(one)])
    ).words[0]
    hist_seq = pkmer.count_kmers_seqsharded(
        words_u32, jnp.int32(len(long_seq)), k, mesh, "data"
    )
    print(f"seq-sharded:   {int(jnp.sum(hist_seq))} windows counted "
          f"(expect {len(long_seq) - k + 1})")

    # --- distributed STREAMING large-k counting (file -> counts) ---
    # per batch: zero communication (each device owns its read shard's
    # run-list accumulator); ONE all_gather merge at the end.
    import tempfile

    from bitnuc_tpu import pipeline

    k_big = 21
    with tempfile.NamedTemporaryFile(suffix=".fq", delete=False) as f:
        for i in range(48):
            s = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=200))
            f.write(b"@s%d\n%s\n+\n%s\n" % (i, s, b"I" * len(s)))
        path = f.name
    counts = pipeline.count_fastq(path, k_big, batch_size=16, mesh=mesh)
    os.unlink(path)
    print(f"mesh streaming k={k_big}: {len(counts)} distinct k-mers, "
          f"{sum(counts.values())} windows (expect {48 * (200 - k_big + 1)})")
    assert sum(counts.values()) == 48 * (200 - k_big + 1)


if __name__ == "__main__":
    main()
