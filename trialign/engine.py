"""The one place that decides which device and which score engine run.

``platform()`` reads ``jax.devices()[0].platform`` once per process:

* ``"gpu"`` selects the card's engines: the CUDA sweep
  (trialign/cuda/sweep.cu), built and registered on first use.  A library
  that cannot be built or loaded is an error, never a quiet switch to XLA.
* ``"cpu"`` selects the plain-JAX references, for tests and for users who
  set ``JAX_PLATFORMS=cpu``.
* anything else raises.

``setup_compile_cache()`` points JAX's persistent compilation cache at
``$JAX_COMPILATION_CACHE_DIR`` when it is set, else at ``<repo>/.jax_cache``.
"""

from __future__ import annotations

import functools
import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENGINES = {"gpu": "cuda", "cpu": "reference"}


@functools.lru_cache(maxsize=1)
def platform() -> str:
    """Platform of the first JAX device ("gpu" or "cpu")."""
    import jax

    plat = jax.devices()[0].platform
    if plat not in ENGINES:
        raise RuntimeError(
            f"TriAlign runs on an NVIDIA GPU or on the CPU; JAX reports "
            f"platform {plat!r}"
        )
    return plat


def score_engine() -> str:
    """"cuda" on the GPU (library built and registered), "reference" on
    the CPU."""
    engine = ENGINES[platform()]
    if engine == "cuda":
        from trialign import cuda

        cuda.ensure_registered()
    return engine


def device_memory_budget() -> int:
    """Usable device memory of one process, in bytes.

    On the GPU this is the allocator's ``bytes_limit``; a card that
    reports none is an error.  On the CPU there is no device limit, and
    callers' cell caps are the operative gates."""
    if platform() == "cpu":
        return 1 << 62
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    if not stats.get("bytes_limit"):
        raise RuntimeError("the GPU reports no memory bytes_limit")
    return int(stats["bytes_limit"])


def setup_compile_cache() -> str:
    """Enable the persistent compilation cache; returns its directory."""
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache"
    )
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir
