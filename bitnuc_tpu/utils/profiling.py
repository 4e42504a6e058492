"""Profiling helpers (the reference's only perf tooling is criterion micro-
benchmarks, SURVEY.md §5; on the GPU the tool is jax.profiler, which
traces the card).

Usage:
    from bitnuc_tpu.utils.profiling import trace
    with trace("/tmp/bitnuc-trace"):
        reads = PackedReads.from_ascii(seqs)
        hist = count_kmers_reads(reads.words, reads.lengths, 8)
    # inspect with TensorBoard or xprof: tensorboard --logdir /tmp/bitnuc-trace
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def trace(logdir: str, host_tracer_level: int = 2):
    """Capture a jax.profiler trace of the enclosed block (device + host)."""
    import jax

    jax.profiler.start_trace(logdir, create_perfetto_link=False)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named span that shows up in profiler timelines.

    with annotate("pack-batch"): ...
    """
    import jax

    return jax.profiler.TraceAnnotation(name)
