"""Worker process for the 2-process DCN test (tests/test_multihost.py).

Run as: python tests/_dist_worker.py <coordinator> <nprocs> <pid>
Initializes jax.distributed on the CPU backend (2 virtual devices per
process), builds the multihost mesh, scores a deterministic batch with
align_batch_multihost and one triplet k-striped across both processes,
and prints the scores as one JSON line.
"""

import json
import os
import sys


def main() -> int:
    coord, nprocs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=2"
    ).strip()
    import jax

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import numpy as np

    from trialign.dist.mesh import init_distributed, multihost_mesh
    from trialign.dist.batch import align_batch_multihost

    assert init_distributed(coord, num_processes=nprocs, process_id=pid)
    assert jax.process_count() == nprocs, jax.process_count()
    mesh = multihost_mesh()
    assert mesh.shape["data"] == 2 * nprocs  # DCN-spanning data axis

    rng = np.random.default_rng(123)
    trips = [
        tuple(
            rng.integers(0, 4, size=int(rng.integers(5, 20))).astype(np.uint8)
            for _ in range(3)
        )
        for _ in range(7)  # deliberately not a multiple of the data axis
    ]
    scores = align_batch_multihost(trips, mesh=mesh)

    # Halo mode across the PROCESS boundary: one triplet k-striped over a
    # 'model' axis spanning both processes, so the per-step column-face
    # ppermute is a real cross-process collective (round-4 VERDICT item 8).
    from trialign.dist.halo import align_sharded_triplet
    from trialign.dist.mesh import make_mesh

    mesh_m = make_mesh(data=1, model=2 * nprocs)
    a, b, c = (
        rng.integers(0, 4, size=d).astype(np.uint8)
        for d in (8, 30, 40 * 2 * nprocs)
    )
    halo_score = align_sharded_triplet(a, b, c, mesh=mesh_m, rows=16)
    print(json.dumps({"pid": pid, "scores": scores,
                      "halo_score": int(halo_score)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
