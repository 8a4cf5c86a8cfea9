"""Executed multi-host (DCN) path: 2 real processes, jax.distributed,
multihost_mesh, sharded batch scoring -- the distributed-backend coverage
the single-chip reference never had (SURVEY.md section 2: the RIFFA host
link was never committed, reference: .gitignore:4).

Runs on CPU (2 virtual devices per process, 4 global) so it needs no GPU.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from trialign.golden import align_planes_numpy

pytestmark = pytest.mark.heavy  # minutes-long on CPU interpret


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_dcn_batch():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "_dist_worker.py")
    coord = f"localhost:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, "2", str(pid)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            env=env,
            cwd=repo,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=480)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
        outs.append(out)

    # Both processes must report identical scores, equal to the oracle on
    # the same deterministic batch.
    rng = np.random.default_rng(123)
    trips = [
        tuple(
            rng.integers(0, 4, size=int(rng.integers(5, 20))).astype(np.uint8)
            for _ in range(3)
        )
        for _ in range(7)
    ]
    want = [align_planes_numpy(a, b, c) for a, b, c in trips]
    # The worker's halo triplet continues the same rng stream.
    ah, bh, ch = (
        rng.integers(0, 4, size=d).astype(np.uint8) for d in (8, 30, 40 * 4)
    )
    want_halo = align_planes_numpy(ah, bh, ch)
    for pid, out in enumerate(outs):
        lines = [l for l in out.splitlines() if l.startswith("{")]
        assert lines, f"no JSON from worker {pid}: {out!r}"
        rec = json.loads(lines[-1])
        assert rec["scores"] == want, (pid, rec["scores"], want)
        # Cross-process ppermute halo: both processes must report the
        # oracle score for the model-axis-striped triplet.
        assert rec["halo_score"] == want_halo, (pid, rec["halo_score"],
                                                want_halo)
