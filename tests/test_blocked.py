"""Sliced (blocked) sweep parity through its public entry, align_sweep.

On the CPU the sweep runs its plain-JAX reference; the same entry runs
the CUDA kernel on the GPU (tests/test_gpu.py).  Row stripes and padded
block rows are the sweep's blocking; every case must equal the golden
model exactly.
"""

import numpy as np
import pytest

from trialign.config import Scoring
from trialign.golden import align_planes_numpy
from trialign.kernels import sweep as S
from trialign.kernels.sweep import align_sweep, plan_stripes
from tests.conftest import random_triplet


def test_plan_dims_geometry():
    """Stripe plan of a 300^3 grid: whole tiles, covering |B| exactly, and
    one stripe when the budget allows it."""
    stripes = plan_stripes(300, 300, 300, budget=S.call_bytes(300, 160, 300))
    assert sum(stripes) == 300 and len(stripes) == 2
    assert stripes[0] % S.TJ == 0
    assert plan_stripes(300, 300, 300, budget=1 << 40) == (300,)


def test_blocked_multiblock_j(rng, monkeypatch):
    monkeypatch.setattr(S, "stripe_budget", lambda: S.call_bytes(10, 16, 50))
    a, b, c = random_triplet(rng, 10, 40, 50)
    assert align_sweep(a, b, c) == align_planes_numpy(a, b, c)


def test_blocked_plan_lens_parity(rng):
    """Padding rows and columns past the final cell (the halo and
    checkpoint modes pad |B| and |C| to whole block rows / stripes) must
    not change scores: the requested final cell sits inside the padded
    rectangle."""
    import jax.numpy as jnp

    for lens in [(10, 40, 50), (16, 33, 41), (9, 12, 14)]:
        a, b, c = random_triplet(rng, *lens)
        want = align_planes_numpy(a, b, c)
        padded = S.prep_sequences(a, b, c, (lens[0], 48, 64))
        row, col = S.face_shapes(lens[0], 48, 64)
        _, _, final = S.sweep_reference(
            *padded, jnp.zeros(row, jnp.int32), jnp.zeros(col, jnp.int32),
            Scoring(), dims=(lens[0], 48, 64) + lens[1:])
        assert int(final.max()) == want


@pytest.mark.slow
def test_blocked_multiblock_jk(rng):
    a, b, c = random_triplet(rng, 8, 35, 300)
    assert align_sweep(a, b, c) == align_planes_numpy(a, b, c)


@pytest.mark.slow
def test_blocked_nondefault_scoring(rng):
    sc = Scoring(match=2, mismatch=-1, gap_open=3, gap_extend=1, s3_mode="rtl")
    a, b, c = random_triplet(rng, 6, 20, 140)
    assert align_sweep(a, b, c, sc) == align_planes_numpy(a, b, c, sc)


def test_blocked_empty():
    e = np.zeros(0, dtype=np.uint8)
    assert align_sweep(e, e, e) == 0
    assert align_sweep(np.ones(3, np.uint8), e, np.ones(2, np.uint8)) == 0


def test_blocked_nondefault_macro_step(rng, monkeypatch):
    """The stripe height is a plan parameter; any split of |B| must give
    the score of one call."""
    a, b, c = random_triplet(rng, 10, 40, 50)
    want = align_planes_numpy(a, b, c)
    for h in (16, 32):
        monkeypatch.setattr(S, "stripe_budget",
                            lambda h=h: S.call_bytes(10, h, 50))
        assert align_sweep(a, b, c) == want


def test_blocked_chain_parity(rng):
    """Several A's against shared B/C through align_batch: every score
    equals its golden score."""
    from trialign.api import align_batch

    a_list = [random_triplet(rng, 20, 1, 1)[0] for _ in range(5)]
    _, b, c = random_triplet(rng, 1, 30, 300)  # past the batched buckets
    want = [align_planes_numpy(a, b, c) for a in a_list]
    assert [r.score for r in align_batch([(a, b, c) for a in a_list])] == want


def test_blocked_chain_single_and_empty(rng):
    from trialign.api import align_batch

    a, b, c = random_triplet(rng, 12, 18, 25)
    assert [r.score for r in align_batch([(a, b, c)])] == [
        align_planes_numpy(a, b, c)
    ]
    assert align_batch([]) == []
    e = np.zeros(0, dtype=np.uint8)
    assert [r.score for r in align_batch([(a, e, c), (a, e, c)])] == [0, 0]


def test_blocked_chain_nondefault_scoring(rng):
    sc = Scoring(match=2, mismatch=-3, gap_open=4, gap_extend=1, s3_mode="rtl")
    a_list = [random_triplet(rng, 15, 1, 1)[0] for _ in range(3)]
    _, b, c = random_triplet(rng, 1, 22, 35)
    want = [align_planes_numpy(a, b, c, sc) for a in a_list]
    assert [align_sweep(a, b, c, sc) for a in a_list] == want
