"""Batched + data-parallel alignment tests on the virtual 8-device CPU mesh
(the distributed coverage the single-chip reference never had, SURVEY.md §4)."""

import numpy as np
import pytest

from trialign.config import Scoring
from trialign.golden import align_planes_numpy
from tests.conftest import random_triplet


def _trips(rng, n, lo=5, hi=25):
    return [
        tuple(random_triplet(rng, rng.integers(lo, hi), rng.integers(lo, hi), rng.integers(lo, hi)))
        for _ in range(n)
    ]


def test_batch_padded_matches_golden(rng):
    from trialign.dist.batch import align_batch_padded

    trips = _trips(rng, 9)
    want = [align_planes_numpy(a, b, c) for a, b, c in trips]
    assert align_batch_padded(trips) == want


def test_batch_sharded_matches_golden(rng):
    import jax

    from trialign.dist.batch import align_batch_sharded

    assert len(jax.devices()) == 8, "tests expect the 8-device CPU mesh"
    trips = _trips(rng, 13)  # deliberately not a multiple of 8
    want = [align_planes_numpy(a, b, c) for a, b, c in trips]
    assert align_batch_sharded(trips) == want


def test_batch_sharded_submesh(rng):
    from trialign.dist.batch import align_batch_sharded
    from trialign.dist.mesh import make_mesh

    trips = _trips(rng, 6)
    want = [align_planes_numpy(a, b, c) for a, b, c in trips]
    mesh = make_mesh(data=4, model=2)
    assert align_batch_sharded(trips, mesh=mesh) == want


def test_batch_empty():
    from trialign.dist.batch import align_batch_padded, align_batch_sharded

    assert align_batch_padded([]) == []
    assert align_batch_sharded([]) == []


def test_api_align_batch(rng):
    from trialign.api import align_batch

    trips = _trips(rng, 4)
    want = [align_planes_numpy(a, b, c) for a, b, c in trips]
    results = align_batch(trips)
    assert [r.score for r in results] == want
    assert all(r.cells == len(t[0]) * len(t[1]) * len(t[2]) for r, t in zip(results, trips))


def test_api_align_batch_traceback(rng):
    """Batch alignment recovery: every score optimal, every alignment
    rescores to it, gap-stripped rows reproduce the inputs."""
    from trialign.api import align_batch
    from trialign.golden.numpy_model import rescore_alignment

    trips = _trips(rng, 5)
    e = np.zeros(0, dtype=np.uint8)
    trips.append((np.ones(3, dtype=np.uint8), e, np.ones(2, dtype=np.uint8)))
    results = align_batch(trips, return_alignment=True)
    for (a, b, c), r in zip(trips, results):
        assert r.score == align_planes_numpy(a, b, c)
        if min(len(a), len(b), len(c)):
            # A triplet with an empty sequence is ALL unscored leading
            # context (score 0 by the zero-border semantics), so only
            # non-degenerate alignments rescore to their own score.
            assert rescore_alignment(r.alignment) == r.score
        for row, seq in zip(r.alignment, (a, b, c)):
            assert [v for v in row if v != -1] == list(map(int, seq))


def test_batch_long_triplets_route_to_blocked(rng):
    """align_batch beyond the batched buckets' 255 limit goes through the
    sliced sweep instead of raising."""
    from trialign.api import align_batch
    from trialign.golden import align_planes_numpy
    from tests.conftest import random_triplet

    trips = [random_triplet(rng, 8, 20, 300) for _ in range(2)]
    res = align_batch(trips)
    for (a, b, c), r in zip(trips, res):
        assert r.score == align_planes_numpy(a, b, c)


def test_batch_long_a_routes_to_blocked(rng):
    """Triplets with |A| > 4096 exceed the batched buckets even when
    |B|,|C| are small; both batch routers must send them to the sliced
    sweep instead of raising (round-1 advisor finding)."""
    from trialign.dist.batch import align_batch_bucketed, align_batch_padded
    from trialign.golden import align_planes_numpy

    trips = [random_triplet(rng, 5000, 6, 6), random_triplet(rng, 10, 8, 8)]
    want = [align_planes_numpy(a, b, c) for a, b, c in trips]
    assert align_batch_padded(trips) == want
    assert align_batch_bucketed(trips) == want


def test_batch_sharded_mixed_long_triplets(rng):
    """align_batch_sharded on a mixed batch with |C| > 255 members must
    route the long ones through the sliced sweep and return exact scores
    in input order on a 4-device mesh (round-1 VERDICT item 3)."""
    from trialign.dist.batch import align_batch_sharded
    from trialign.dist.mesh import make_mesh

    trips = [
        random_triplet(rng, 10, 12, 14),
        random_triplet(rng, 8, 20, 300),  # beyond the bucket |C| cap
        random_triplet(rng, 15, 9, 11),
        (np.zeros(0, np.uint8), np.zeros(3, np.uint8), np.zeros(3, np.uint8)),
        random_triplet(rng, 6, 18, 290),
    ]
    want = [
        align_planes_numpy(a, b, c) if min(len(a), len(b), len(c)) else 0
        for a, b, c in trips
    ]
    mesh = make_mesh(data=4)
    assert align_batch_sharded(trips, mesh=mesh) == want


def test_batch_bucketed_mixed_lengths(rng):
    """Mixed-length bucketed batching (BASELINE config 3 shape, miniature):
    exact scores in input order across batched buckets and sliced-sweep
    items."""
    from trialign.dist.batch import align_batch_bucketed
    from trialign.golden import align_planes_numpy
    from tests.conftest import random_triplet

    trips = [
        random_triplet(rng, 12, 30, 20),
        random_triplet(rng, 9, 20, 300),   # sliced sweep
        random_triplet(rng, 15, 25, 25),
        random_triplet(rng, 7, 18, 290),   # sliced sweep
    ]
    got = align_batch_bucketed(trips)
    want = [align_planes_numpy(a, b, c) for a, b, c in trips]
    assert got == want


def test_batch_submatrix_padded_and_bucketed(rng):
    """align_batch with a runtime submatrix rides the batched path (padded
    vmap; long triplets through the sliced sweep) and matches the golden
    model; big alphabets go to per-item XLA sweeps (PARITY.md quirk 5)."""
    from trialign.api import align_batch
    from trialign.dist.batch import align_batch_padded

    m = rng.integers(-3, 4, size=(4, 4))
    m = ((m + m.T) // 2).astype(int)
    sc = Scoring(submatrix=tuple(tuple(int(v) for v in row) for row in m))
    trips = [
        tuple(rng.integers(0, 4, int(n)).astype(np.uint8) for n in dims)
        for dims in rng.integers(2, 40, size=(8, 3))
    ]
    # One triplet past the buckets exercises the sliced-sweep leg.
    trips.append(tuple(rng.integers(0, 4, n).astype(np.uint8)
                       for n in (20, 30, 280)))
    want = [align_planes_numpy(*t, sc) for t in trips]
    got = [r.score for r in align_batch(trips, sc)]
    assert got == want
    assert align_batch_padded(trips, sc) == want
    # Big alphabet: still exact, via the XLA sweep.
    big = tuple(tuple(2 if i == j else -1 for j in range(10))
                for i in range(10))
    sc_big = Scoring(submatrix=big)
    small = trips[:3]
    want_big = [align_planes_numpy(*t, sc_big) for t in small]
    assert [r.score for r in align_batch(small, sc_big)] == want_big


def test_batch_bucketed_reports_each_score(rng):
    """on_scores sees every nonempty triplet once, with its final score
    (the feed align_batch_resilient keeps finished work from)."""
    from trialign.dist.batch import align_batch_bucketed

    trips = [random_triplet(rng, 6, 9, 12), random_triplet(rng, 5, 8, 270),
             (np.zeros(0, np.uint8),) * 3, random_triplet(rng, 7, 10, 11)]
    seen = {}
    out = align_batch_bucketed(trips, on_scores=lambda i, s: seen.setdefault(i, s))
    assert out == [align_planes_numpy(*t) if min(map(len, t)) else 0
                   for t in trips]
    assert seen == {i: out[i] for i in (0, 1, 3)}


def test_bucket_dims_ladder():
    from trialign.kernels.plane_math import bucket_dims

    assert bucket_dims(10, 20, 30) == (64, 32, 128)
    assert bucket_dims(65, 255, 255) == (128, 256, 256)
    assert bucket_dims(4096, 1, 127) == (4096, 16, 128)


def test_batch_on_gpu_engine_sweeps_every_item(rng, monkeypatch):
    """With the CUDA engine every triplet, bucket-sized or not, goes
    through the sliced sweep, round-robin over the given devices."""
    import jax
    import jax.numpy as jnp

    import trialign.engine as E
    import trialign.kernels.sweep as S
    from trialign.dist.batch import align_batch_bucketed

    calls = []

    def fake_sweep(a, b, c, scoring, device=None):
        calls.append(device)
        return jnp.int32(align_planes_numpy(a, b, c, scoring))

    monkeypatch.setattr(E, "score_engine", lambda: "cuda")
    monkeypatch.setattr(S, "align_sweep_async", fake_sweep)
    trips = [random_triplet(rng, 6, 9, 12), random_triplet(rng, 5, 8, 270),
             random_triplet(rng, 7, 10, 11)]
    devs = jax.devices()[:2]
    got = align_batch_bucketed(trips, devices=devs)
    assert got == [align_planes_numpy(*t) for t in trips]
    assert calls == [devs[0], devs[1], devs[0]]
