"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR wins, else a
directory already given to JAX, else the fixed <repo>/.jax_cache."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
sys.path.insert(0, {repo!r})
import jax, jax.numpy as jnp
from bitnuc_tpu import config
print(config.enable_compilation_cache())
jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()
"""


def _probe(env_extra, cwd):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", **env_extra)
    res = subprocess.run(
        [sys.executable, "-c", _PROBE.format(repo=REPO)], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    return res.stdout.strip().splitlines()[-1]


def test_cache_honours_env_dir(tmp_path):
    cache = tmp_path / "cc"
    assert _probe({"JAX_COMPILATION_CACHE_DIR": str(cache)}, tmp_path) == str(cache)
    assert cache.is_dir() and any(cache.iterdir())


def test_cache_defaults_to_checkout_dir(tmp_path):
    from bitnuc_tpu import config

    assert config.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert _probe({}, tmp_path) == config.DEFAULT_CACHE_DIR
    assert os.path.isdir(config.DEFAULT_CACHE_DIR)
    assert not any(tmp_path.iterdir())  # nothing written beside the caller


def test_cache_keeps_configured_dir():
    import jax

    from bitnuc_tpu import config

    before = jax.config.jax_compilation_cache_dir  # set by conftest
    assert before
    assert config.enable_compilation_cache() == before
    assert jax.config.jax_compilation_cache_dir == before
