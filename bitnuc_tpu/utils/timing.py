"""Throughput measurement that XLA cannot cheat.

Timing loops inside one jit invite compiler cheats:

  * consume one element of the result -> the rest is dead-code-eliminated;
  * consume a provably-zero reduction (sum & 0) -> the whole op constant-
    folds out of the loop;
  * loop-invariant inputs -> the op hoists out of the loop, XOR-fold
    accumulators self-cancel pairwise under unrolling.

So: no loop. `amortized_seconds_per_call` builds ONE jit that applies the op
to K inputs with DISTINCT data (generated on device from split PRNG keys —
no host uploads) and adds a barriered full sum of every result leaf into one
scalar. Distinct data defeats CSE and hoisting; the sums defeat DCE; the
barrier forces result stores; there is no loop for the compiler to
transform. Completion is synced by transferring the scalar to host.
Reported figures are the best of `reps` repeats.
"""

from __future__ import annotations

import time
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np


def _consume(result) -> jnp.ndarray:
    """Full-sum every leaf, behind an optimization_barrier.

    The barrier forces the op's outputs to actually materialize (honest
    store accounting) and keeps the sum a plain reduce, unfused with the
    op under test."""
    s = jnp.float32(0)
    for leaf in jax.tree_util.tree_leaves(jax.lax.optimization_barrier(result)):
        s = s + jnp.sum(leaf.astype(jnp.float32))
    return s


def amortized_seconds_per_call(
    op: Callable,
    make_args: Callable,
    k: int = 4,
    reps: int = 5,
) -> float:
    """Best (minimum) seconds per `op(*args)` call.

    make_args(key) -> an argument tuple for op, built ON DEVICE from the
    jax.random key (e.g. jax.random.randint words); called under jit with K
    split keys once, outside the timed section. op runs once per copy inside
    one jitted call whose output is the sum of all results.
    """
    keys = jax.random.split(jax.random.key(0), k)
    copies = [
        jax.tree_util.tree_map(jax.device_put, jax.jit(make_args)(key))
        for key in keys
    ]
    for c in copies:
        jax.block_until_ready(c)

    @jax.jit
    def run(all_args):
        return sum(_consume(op(*args)) for args in all_args)

    float(run(copies))  # compile + warm; float() forces a real host sync
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(run(copies))
        times.append((time.perf_counter() - t0) / k)
    # best-of: the minimum is the capability estimate
    return float(np.min(times))

