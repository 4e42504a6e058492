"""End-to-end k-mer counting pipeline: FASTQ -> packed reads -> histogram.

Usage:
    python examples/kmer_pipeline.py [reads.fastq[.gz]] [k]

Without arguments, generates a synthetic FASTQ in /tmp and counts 8-mers.
Demonstrates the reference README workflow (README.md:164-180) at batch
scale: streaming ingestion, device-side canonical counting, top-k report.
"""

import sys
import time

import numpy as np

sys.path.insert(0, ".")

import bitnuc_tpu as bn
from bitnuc_tpu.ops import kmer


def synth_fastq(path, n_reads=2000, read_len=300, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for i in range(n_reads):
            seq = bytes(
                rng.choice(np.frombuffer(b"ACGT", np.uint8), size=read_len)
            )
            f.write(b"@read%d\n%s\n+\n%s\n" % (i, seq, b"I" * read_len))
    return path


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else synth_fastq("/tmp/example.fastq")
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 8

    t0 = time.perf_counter()
    total = None
    n_reads = 0
    n_bases = 0
    for batch in bn.io.iter_fastq_batches(path, batch_size=4096):
        # mode='dense' pins the [4^k] layout this example accumulates
        # across batches ('auto' hands k > 12 to the runs engine, whose
        # sparse output the managed pipeline below handles for you)
        hist = kmer.count_kmers_reads(
            batch.words, batch.lengths, k, mode="dense", canonical=True
        )
        total = hist if total is None else total + hist
        n_reads += len(batch)
        n_bases += int(np.asarray(batch.lengths).sum())
    dt = time.perf_counter() - t0

    counts, keys = kmer.top_kmers(total, 10)
    print(f"{n_reads} reads, {n_bases} bases, k={k}, {dt:.2f}s")
    print("top canonical k-mers:")
    for c, key in zip(np.asarray(counts), np.asarray(keys)):
        if c == 0:
            break
        print(f"  {bn.from_2bit(int(key), k).decode()}  x{int(c)}")

    # the same job through the managed pipeline: crash-safe checkpointing,
    # N-tolerant windows, double-buffered staged ingestion, progress metrics
    ckpt = path + ".ckpt.npz"
    hist = bn.pipeline.count_fastq(
        path,
        k,
        batch_size=4096,
        on_invalid="skip",
        checkpoint=ckpt,
        checkpoint_every=10,
        on_progress=lambda m: print(
            f"  progress: {m['reads']} reads, "
            f"{m['bases_per_sec'] / 1e6:.0f} Mbases/s"
        ),
        progress_every=5,
    )
    n_win = int(hist.sum()) if not isinstance(hist, dict) else sum(hist.values())
    print(f"pipeline recount: {n_win} windows (checkpoint at {ckpt})")


if __name__ == "__main__":
    main()
