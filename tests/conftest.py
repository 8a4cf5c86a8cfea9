"""Test configuration: run on the CPU with 8 virtual devices so the
multi-device sharding paths (mesh, shard_map, ppermute halo exchange)
execute without a GPU (SURVEY.md section 4: distributed tests runnable on
CPU via xla_force_host_platform_device_count).

A caller that sets JAX_PLATFORMS keeps it: ``JAX_PLATFORMS=cuda python -m
pytest -m gpu`` runs the card-only tests on the GPU.  Tests marked ``gpu``
skip wherever JAX finds no GPU.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")  # before the first backend init
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _gpu_only(request):
    """Skip ``gpu``-marked tests where JAX finds no GPU (decided here, at
    run time, never while modules are collected)."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU: run `JAX_PLATFORMS=cuda "
                        "python -m pytest -m gpu` on the card")


def random_triplet(rng, la, lb, lc, nsym=4):
    return (
        rng.integers(0, nsym, size=la).astype(np.uint8),
        rng.integers(0, nsym, size=lb).astype(np.uint8),
        rng.integers(0, nsym, size=lc).astype(np.uint8),
    )
