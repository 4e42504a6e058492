"""Test configuration: CPU with 8 virtual devices unless JAX_PLATFORMS says
otherwise, so sharding/collective paths run without accelerators (the
analog of the reference's simd/nosimd CI matrix,
.github/workflows/ci.yml:29-51). Tests marked `gpu` take the `gpu`
fixture and skip unless the first device is a GPU; run them on the card
with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from bitnuc_tpu.config import host_cpu_tag  # noqa: E402

# Host-keyed cache dir: XLA:CPU loads AOT executables compiled on another
# machine with only a warning and then computes WRONG results (observed as
# flaky scatter double-counting after a container host migration). See
# config.host_cpu_tag.
#
# Round-3 postscript: intermittent SEGFAULTS were observed deep in XLA:CPU
# native code during LONG single-process suite runs — in cache reads, cache
# writes, AND raw backend_compile (i.e. independent of this cache), at
# varying tests, while every crashing file passes in isolation; dmesg shows
# multi-ms hrtimer stalls consistent with VM live-migration mid-run. If a
# full run dies with a faulthandler stack inside jax/_src/compiler.py or
# compilation_cache.py, rerun it (and `rm -rf /tmp/jax_pytest_cache_*` if
# the crash was in a cache path) — it is the environment, not the code.
import tempfile  # noqa: E402

jax.config.update(
    "jax_compilation_cache_dir",
    os.path.join(tempfile.gettempdir(), f"jax_pytest_cache_{host_cpu_tag()}"),
)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

import numpy as np
import pytest


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is a GPU. Decided here, at run time,
    never while a module is imported (xdist workers must collect the same
    tests)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu")


@pytest.fixture
def rng():
    return np.random.default_rng(0xB17)


def random_seq(rng, n: int) -> bytes:
    return bytes(rng.choice(np.frombuffer(b"ACGTacgt", dtype=np.uint8), size=n))
