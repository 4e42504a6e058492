"""Multi-host runtime helpers.

The reference has no distributed runtime (SURVEY.md §2.3). With several
host processes, each calls initialize() once — BEFORE any other JAX API
that touches the backend — then builds meshes; jax.distributed wires the
processes and jax.devices() spans all of them. On one host, one process
drives all its devices and needs no initialize(). Collectives (NCCL
between GPUs) are inserted by XLA from sharding annotations, never
hand-rolled transport; the GPUs of one host are joined all to all, so a
mesh follows the algorithm alone, not a wiring topology.

Ordering is load-bearing: any backend-initializing call (jax.devices(),
jax.process_count(), first trace...) locks in a single-process runtime, after
which jax.distributed.initialize is too late. This module therefore checks
initialization state via the distributed service client handle only, which
does not touch the backend. Enforced by tests/test_runtime.py, which runs a
real 2-process CPU jax.distributed cluster (gloo collectives) and asserts a
cross-process psum.
"""

from __future__ import annotations

import os

import jax


def is_initialized() -> bool:
    """True once jax.distributed.initialize has run in this process.

    Reads the coordination-service client handle directly — calling
    jax.process_count() here would *initialize the local backend* as a side
    effect, self-sabotaging any later multi-process init.
    """
    from jax._src import distributed

    return distributed.global_state.client is not None


def initialize(
    coordinator_address=None,
    num_processes=None,
    process_id=None,
    local_device_ids=None,
    **kwargs,
):
    """Idempotent jax.distributed.initialize wrapper; no-op single-process.

    Call once per host process before building meshes. With no arguments and
    no cluster environment (JAX_COORDINATOR_ADDRESS / managed-cluster
    autodetection), this is a no-op and the process stays single-host.
    Safe to call before any other JAX API; never calls backend-initializing
    APIs itself (see module docstring).
    """
    if is_initialized():
        return
    if (
        coordinator_address is None
        and num_processes is None
        and "JAX_COORDINATOR_ADDRESS" not in os.environ
    ):
        # single-process (incl. single-host multi-chip): nothing to do
        return
    # env-driven cluster spec (the launcher-friendly path): honored when the
    # explicit arguments are absent
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        **kwargs,
    )


def process_info():
    """Topology snapshot; fine to call *after* initialize()."""
    return {"process_index": jax.process_index(), "process_count": jax.process_count(),
            "local_devices": len(jax.local_devices()), "global_devices": len(jax.devices())}
