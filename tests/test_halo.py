"""Multi-card single-triplet halo mode on the virtual CPU mesh: the (j, k)
grid k-striped over the 'model' axis, block rows pipelined device to
device, column faces travelling by ppermute.  Exact score parity vs the
golden model is required at every mesh size."""

import pytest

from trialign.dist.halo import align_sharded_triplet
from trialign.dist.mesh import make_mesh
from trialign.golden import align_planes_numpy
from tests.conftest import random_triplet

pytestmark = pytest.mark.heavy  # minutes-long on CPU


@pytest.mark.parametrize("ndev", [2, 4])
def test_halo_matches_golden(rng, ndev):
    a, b, c = random_triplet(rng, 10, 45, 20 * ndev)
    want = align_planes_numpy(a, b, c)
    got = align_sharded_triplet(
        a, b, c, mesh=make_mesh(data=1, model=ndev), rows=16
    )
    assert got == want


@pytest.mark.parametrize("rows", [16, 48])
def test_halo_schedules_match_golden(rng, rows):
    """Block rows shorter and longer than |B|/ndev (a deep and a shallow
    pipeline) both give exact parity."""
    a, b, c = random_triplet(rng, 9, 40, 60)
    want = align_planes_numpy(a, b, c)
    got = align_sharded_triplet(
        a, b, c, mesh=make_mesh(data=1, model=3), rows=rows,
    )
    assert got == want


def test_halo_single_device_degenerates(rng):
    a, b, c = random_triplet(rng, 8, 30, 40)
    want = align_planes_numpy(a, b, c)
    got = align_sharded_triplet(
        a, b, c, mesh=make_mesh(data=1, model=1), rows=16
    )
    assert got == want


@pytest.mark.slow
def test_halo_eight_devices(rng):
    a, b, c = random_triplet(rng, 8, 35, 150)
    want = align_planes_numpy(a, b, c)
    got = align_sharded_triplet(
        a, b, c, mesh=make_mesh(data=1, model=8), rows=16
    )
    assert got == want


def test_scaling_efficiency_model():
    from trialign.dist.halo import scaling_efficiency

    # >= 80% efficiency at 2 stripes once the grid is deep enough
    # (n_jb >= 4 block rows for D=2).
    assert scaling_efficiency(4, 2) == 0.8
    assert scaling_efficiency(32, 2) > 0.96
    assert scaling_efficiency(32, 8) > 0.8
    assert scaling_efficiency(1, 1) == 1.0


def test_halo_planner_geometry(rng):
    """Planner-chosen block rows on a 4-device mesh with |C| not a
    multiple of the device count (padding columns past the final cell)."""
    a, b, c = random_triplet(rng, 12, 70, 43)
    want = align_planes_numpy(a, b, c)
    got = align_sharded_triplet(a, b, c, mesh=make_mesh(data=1, model=4))
    assert got == want


def test_halo_uneven_kb_padding(rng):
    """|B| not a multiple of the block rows: the final cell sits inside
    the last, padded block row."""
    a, b, c = random_triplet(rng, 8, 37, 2 * 19)
    want = align_planes_numpy(a, b, c)
    got = align_sharded_triplet(
        a, b, c, mesh=make_mesh(data=1, model=2), rows=16
    )
    assert got == want


def test_halo_efficiency_model_accounts_padding():
    from trialign.dist.halo import halo_efficiency

    # One block row over 8 stripes: the pipeline ramp dominates.
    eff = halo_efficiency(16, 16, 800, 8, rows=16)
    assert eff["pipeline"] == 1 / 8
    assert eff["total"] < 0.15
    # Deep grids with even stripes approach the pipeline bound.
    eff2 = halo_efficiency(1024, 4096, 8 * 512, 8)
    assert eff2["k_fill"] == 1.0 and eff2["j_fill"] == 1.0
    assert eff2["total"] > 0.7
    # Uneven |C| shows up as k_fill < 1.
    assert halo_efficiency(64, 64, 801, 8)["k_fill"] < 1.0


def test_choose_halo_shape_mesh_aligned():
    """Block rows are whole sweep tiles and give each stripe at least four
    block rows of pipeline depth."""
    from trialign.dist.halo import choose_halo_rows
    from trialign.kernels.sweep import TJ

    for lb, ndev in [(2048, 4), (300, 8), (17, 2), (100000, 4)]:
        rows = choose_halo_rows(lb, ndev)
        assert rows % TJ == 0
        assert -(-lb // rows) >= min(4 * ndev, -(-lb // TJ))


def test_halo_rejects_sharded_traceback(rng):
    a, b, c = random_triplet(rng, 4, 4, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        align_sharded_triplet(a, b, c, mesh=make_mesh(data=1, model=2),
                              return_alignment=True)
