"""Card-only tests: the CUDA sweep (trialign/cuda/sweep.cu) against its
plain-JAX reference and the oracles.  The kernel has no CPU mode, so these
skip on the CPU; chip_smoke.py runs them on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu.py``."""

import numpy as np
import pytest

from trialign.config import Scoring
from trialign.golden import align_planes_numpy

pytestmark = pytest.mark.gpu


def random_triplet(rng, la, lb, lc):
    # Local: on the card this file runs in a child whose import path may
    # hold another package named `tests`.
    return tuple(rng.integers(0, 4, n).astype(np.uint8) for n in (la, lb, lc))

SUB4 = ((2, -1, -1, 0), (-1, 2, 0, -1), (-1, 0, 2, -1), (0, -1, -1, 2))
MODES = {
    "sop": (Scoring(), 0),
    "rtl": (Scoring(s3_mode="rtl"), 0),
    "submatrix4": (Scoring(submatrix=SUB4), 0),
    "bits12": (Scoring(), 12),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("shape", [(1, 1, 1), (40, 33, 65), (64, 100, 31),
                                   (200, 90, 300)])
def test_cuda_contract_matches_reference(rng, shape, mode):
    """Faces, final cell and all: random input faces (zero at i = 0) and
    an interior final cell."""
    import jax

    from trialign.kernels import sweep as S

    scoring, bits = MODES[mode]
    la, lb, lc = shape
    args = S.prep_sequences(*random_triplet(rng, *shape))
    row_shape, col_shape = S.face_shapes(la, lb, lc)
    row = rng.integers(-5, 5, row_shape).astype(np.int32)
    col = rng.integers(-5, 5, col_shape).astype(np.int32)
    row[0] = col[0] = 0
    col[:, :, 0] = row[:, :, 0]
    dims = (la, lb, lc, max(1, lb // 2), max(1, lc - 3))
    outs = [
        jax.jit(lambda *xs, fn=fn: fn(*xs, scoring, bits, dims))(*args, row, col)
        for fn in (S.sweep_cuda, S.sweep_reference)
    ]
    for got, want in zip(*outs):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_cuda_engine_selected():
    from trialign.engine import score_engine

    assert score_engine() == "cuda"


def test_align_sweep_matches_golden_non_tile_shape(rng):
    from trialign.kernels.sweep import align_sweep

    a, b, c = random_triplet(rng, 70, 150, 99)
    assert align_sweep(a, b, c) == align_planes_numpy(a, b, c)
