"""Device mesh helpers.

The reference is a single chip whose only "communication" is PE-to-PE wires
and SRAM boundary faces (reference: src/TriAlign_1cyc.v:118-140); its host
link (RIFFA PCIe) was never committed (.gitignore:4).  Here jax.sharding
meshes replace all of that: a 'data' axis for independent triplets (batch
data-parallelism) and a 'model' axis for partitioning one long triplet's
grid with halo exchange between cards.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    data: int = 1,
    model: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Create a (data, model) mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    n = data * model
    if n > len(devices):
        raise ValueError(f"mesh wants {n} devices, only {len(devices)} available")
    arr = np.array(devices[:n]).reshape(data, model)
    return Mesh(arr, axis_names=("data", "model"))


def default_mesh() -> Mesh:
    """All local devices on the 'data' axis (throughput mode)."""
    return make_mesh(data=len(jax.devices()), model=1)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize multi-host JAX (DCN) if a cluster is configured.

    Reads the standard JAX env vars (JAX_COORDINATOR_ADDRESS etc.) when
    arguments are omitted; a no-op single-process fallback otherwise.
    Returns True if distributed mode is active.  After this, jax.devices()
    is the GLOBAL device list and make_mesh() spans hosts: put the 'data'
    axis across hosts (DCN carries only independent triplets) and keep the
    'model' axis -- whose halo exchange is latency-sensitive -- within a
    host, whose cards are joined by NVLink (SURVEY.md section 2:
    distributed communication backend)."""
    import os

    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if addr is None:
        return False
    jax.distributed.initialize(
        coordinator_address=addr,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def multihost_mesh(model_per_host: int = 1) -> Mesh:
    """(data, model) mesh over several hosts: model axis within a host,
    data axis spanning hosts over the network."""
    devices = jax.devices()
    model = max(1, model_per_host)
    data = len(devices) // model
    return make_mesh(data=data, model=model, devices=devices)
