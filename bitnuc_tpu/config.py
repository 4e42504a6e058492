"""Process-wide configuration: the persistent compilation cache and the
host CPU tag that keys native builds.

Every op has one device path, chosen from what the code can observe
(platform, k, shapes); there is no user-set backend switch.
"""

from __future__ import annotations

import os

# <repo>/.jax_cache: fixed, so a second run of the same checkout finds the
# executables the first one stored (the path is part of the cache key)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def host_cpu_tag() -> str:
    """Fingerprint of the host CPU feature set.

    native/Makefile stamps it beside the -march=native build of the host
    library; the loader refuses a library built for another CPU (a binary
    built for a richer host SIGILLs instead of erroring). Tests also key
    their XLA:CPU compile cache by it: XLA:CPU loads AOT executables built
    on another machine with only a warning and then computes wrong results.
    """
    import hashlib

    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return hashlib.sha1(line).hexdigest()[:12]
    except OSError:
        pass
    import platform

    return hashlib.sha1(platform.processor().encode()).hexdigest()[:12]


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache (idempotent); returns the
    directory in use.

    A directory already given to JAX wins: JAX_COMPILATION_CACHE_DIR (which
    JAX reads itself) or an earlier jax.config update (the test suite's).
    Otherwise the cache goes to DEFAULT_CACHE_DIR inside the checkout.
    Every executable is cached, however small or quick to compile.
    """
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or (
        jax.config.jax_compilation_cache_dir
    )
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
