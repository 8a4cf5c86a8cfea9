"""The sliced sweep's contract on its plain-JAX reference, the wrapper's
planning, the engine choice and the CUDA build plumbing.

The CUDA kernel itself has no interpret mode; its tests are marked
``gpu`` (tests/test_gpu.py) and run on the card.  Everything around it --
face layout, splitting a grid into calls, the stripe planner, the choice
of engine, the nvcc command line -- is plain Python checked here.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from trialign.config import NUM_MATRICES, Scoring
from trialign.golden import align_planes_numpy
from trialign.kernels import sweep as S
from tests.conftest import random_triplet

SUB4 = ((2, -1, -1, 0), (-1, 2, 0, -1), (-1, 0, 2, -1), (0, -1, -1, 2))

SHAPES = [(1, 1, 1), (1, 9, 7), (6, 1, 11), (13, 17, 33), (20, 31, 16),
          (9, 40, 70)]
MODES = {
    "sop": (Scoring(), 0),
    "rtl": (Scoring(s3_mode="rtl", match=2, mismatch=-1, gap_open=3), 0),
    "submatrix4": (Scoring(submatrix=SUB4), 0),
    "bits12": (Scoring(), 12),
}


def _zero_faces(la, h, w):
    row, col = S.face_shapes(la, h, w)
    return jnp.zeros(row, jnp.int32), jnp.zeros(col, jnp.int32)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_reference_matches_golden(rng, shape, mode):
    scoring, bits = MODES[mode]
    a, b, c = random_triplet(rng, *shape)
    want = align_planes_numpy(a, b, c, scoring, score_bits=bits)
    args = S.prep_sequences(a, b, c)
    _, _, final = S.sweep_reference(*args, *_zero_faces(*shape), scoring,
                                    bits)
    assert int(final.max()) == want


@pytest.mark.parametrize("cut", [1, 8, 19])
def test_row_split_equals_one_call(rng, cut):
    """Two calls stacked along j, the first's bottom face passed as the
    second's top face, give the faces and final cell of one call."""
    la, lb, lc = 9, 20, 33
    a, b, c = random_triplet(rng, la, lb, lc)
    a_ext, bb, cc = S.prep_sequences(a, b, c)
    sc = Scoring()
    row, col, final = S.sweep_reference(a_ext, bb, cc, *_zero_faces(la, lb, lc), sc)
    r1, _, _ = S.sweep_reference(a_ext, bb[:cut], cc, *_zero_faces(la, cut, lc), sc)
    r2, _, f2 = S.sweep_reference(a_ext, bb[cut:], cc, r1,
                                  _zero_faces(la, lb - cut, lc)[1], sc)
    np.testing.assert_array_equal(r2, row)
    np.testing.assert_array_equal(f2, final)


@pytest.mark.parametrize("cut", [1, 16])
def test_column_split_equals_one_call(rng, cut):
    """Two calls side by side along k, the first's right face passed as
    the second's left face (the halo mode's exchange)."""
    la, lb, lc = 7, 18, 30
    a, b, c = random_triplet(rng, la, lb, lc)
    a_ext, bb, cc = S.prep_sequences(a, b, c)
    sc = Scoring(s3_mode="rtl")
    row, col, final = S.sweep_reference(a_ext, bb, cc, *_zero_faces(la, lb, lc), sc)
    _, c1, _ = S.sweep_reference(a_ext, bb, cc[:cut], *_zero_faces(la, lb, cut), sc)
    _, c2, f2 = S.sweep_reference(a_ext, bb, cc[cut:],
                                  _zero_faces(la, lb, lc - cut)[0], c1, sc)
    np.testing.assert_array_equal(c2, col)
    np.testing.assert_array_equal(f2, final)


def test_faces_carry_corner_and_shapes(rng):
    la, lb, lc = 5, 6, 7
    a, b, c = random_triplet(rng, la, lb, lc)
    row, col, final = S.sweep_reference(*S.prep_sequences(a, b, c),
                                        *_zero_faces(la, lb, lc), Scoring())
    assert row.shape == (la + 1, NUM_MATRICES, lc + 1)
    assert col.shape == (la + 1, NUM_MATRICES, lb + 1)
    # Both high faces meet at the far corner; i = 0 is the zero border.
    np.testing.assert_array_equal(row[:, :, lc], col[:, :, lb])
    np.testing.assert_array_equal(row[la, :, lc], final)
    assert not np.asarray(row[0]).any() and not np.asarray(col[0]).any()


def test_final_cell_inside_rectangle(rng):
    """dims picks an interior final cell: the score of the prefixes."""
    a, b, c = random_triplet(rng, 8, 20, 25)
    _, _, final = S.sweep_reference(*S.prep_sequences(a, b, c),
                                    *_zero_faces(8, 20, 25), Scoring(),
                                    dims=(8, 20, 25, 11, 17))
    assert int(final.max()) == align_planes_numpy(a, b[:11], c[:17])


@pytest.mark.parametrize("fit_rows,expect_stripes", [(700, 1), (240, 3)])
def test_plan_stripes_fits_budget(fit_rows, expect_stripes):
    la, lb, lc = 300, 700, 520
    budget = S.call_bytes(la, fit_rows, lc)
    stripes = S.plan_stripes(la, lb, lc, budget)
    assert sum(stripes) == lb
    assert len(stripes) == expect_stripes
    assert all(h % S.TJ == 0 for h in stripes[:-1])
    assert all(S.call_bytes(la, h, lc) <= budget for h in stripes)


def test_plan_stripes_never_below_one_tile():
    assert S.plan_stripes(100, 40, 50, budget=1) == (16, 16, 8)


@pytest.mark.parametrize("la,h,w,want", [
    (10, 16, 32, 1 + 1),                          # one tile: no inner faces
    (10, 17, 32, (32 + 1) * 11 * 7 + 2 + 1),      # two tile rows
    (10, 16, 33, (16 + 1) * 11 * 7 + 2 + 1),      # two tile columns
])
def test_scratch_ints(la, h, w, want):
    assert S.scratch_ints(la, h, w) == want


def test_align_sweep_stripes_match_golden(rng, monkeypatch):
    """A budget that forces several row stripes gives the golden score."""
    monkeypatch.setattr(S, "stripe_budget", lambda: S.call_bytes(12, 16, 40))
    a, b, c = random_triplet(rng, 12, 45, 40)
    assert len(S.plan_stripes(12, 45, 40, S.stripe_budget())) == 3
    assert S.align_sweep(a, b, c) == align_planes_numpy(a, b, c)


def test_sweep_rejects_big_alphabet(rng):
    big = tuple(tuple(1 if i == j else -1 for j in range(9)) for i in range(9))
    a, b, c = random_triplet(rng, 4, 4, 4)
    with pytest.raises(ValueError, match="symbols"):
        S.align_sweep(a, b, c, Scoring(submatrix=big))


def test_ffi_attrs_layout():
    attrs = S._ffi_attrs(Scoring(submatrix=SUB4), 12)
    assert attrs["weights"].shape == (49,) and attrs["sub"].shape == (64,)
    assert list(attrs["sub"][:4]) == [2, -1, -1, 0]
    assert attrs["nsym"] == 4 and attrs["sub_floor"] == -1
    assert attrs["score_bits"] == 12
    plain = S._ffi_attrs(Scoring(s3_mode="rtl"), 0)
    assert plain["nsym"] == 0 and plain["rtl"] == 1


@pytest.mark.parametrize("real", [(5, 9, 20), (30, 32, 33), (1, 1, 1)])
def test_runtime_dims_inside_extents(rng, real):
    """A rectangle smaller than the arrays, given at run time, gives the
    faces and final cell of a call at its exact shape."""
    la, lb, lc = real
    a, b, c = random_triplet(rng, la, lb, lc)
    sc = Scoring(s3_mode="rtl")
    want = S.sweep_reference(*S.prep_sequences(a, b, c),
                             *_zero_faces(la, lb, lc), sc)
    ext = (32, 48, 64)
    dims = np.array([la, lb, lc, lb, lc], np.int32)
    got = S.sweep_reference(*S.prep_sequences(a, b, c, ext),
                            *_zero_faces(*ext), sc, dims=dims)
    np.testing.assert_array_equal(got[0][: la + 1, :, : lc + 1], want[0])
    np.testing.assert_array_equal(got[1][: la + 1, :, : lb + 1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("n,want", [(1, 32), (33, 64), (255, 256), (512, 512),
                                    (513, 768), (1024, 1024), (2049, 2304)])
def test_extent_ladder(n, want):
    assert S.extent(n) == want


def test_align_sweep_shares_compiles(rng):
    """Problems of nearby sizes share one compiled call."""
    S._score_stripes.clear_cache()
    for shape in [(20, 25, 30), (17, 31, 29), (32, 32, 32)]:
        a, b, c = random_triplet(rng, *shape)
        assert S.align_sweep(a, b, c) == align_planes_numpy(a, b, c)
    assert S._score_stripes._cache_size() == 1


# ---------------------------------------------------------------- engine

def test_engine_cpu_selects_reference():
    from trialign import engine

    assert engine.platform() == "cpu"
    assert engine.score_engine() == "reference"
    assert engine.device_memory_budget() > 2**40


def test_engine_unknown_platform_raises(monkeypatch):
    import jax

    from trialign import engine

    class Dev:
        platform = "rocm"

    engine.platform.cache_clear()
    monkeypatch.setattr(jax, "devices", lambda: [Dev()])
    try:
        with pytest.raises(RuntimeError, match="platform"):
            engine.platform()
    finally:
        engine.platform.cache_clear()


def test_engine_gpu_without_nvcc_raises(monkeypatch, tmp_path):
    """On the GPU a library that cannot be built is an error, never a
    quiet switch to XLA."""
    from trialign import cuda, engine

    monkeypatch.setattr(engine, "platform", lambda: "gpu")
    monkeypatch.setattr(cuda, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda, "_lib", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(cuda.os.path, "isfile",
                        lambda p: False if p.endswith("nvcc") else os.path.isfile(p))
    with pytest.raises(cuda.CudaLibraryError, match="nvcc"):
        engine.score_engine()


def test_engine_gpu_budget_needs_bytes_limit(monkeypatch):
    import jax

    from trialign import engine

    class Dev:
        def memory_stats(self):
            return {}

    monkeypatch.setattr(engine, "platform", lambda: "gpu")
    monkeypatch.setattr(jax, "local_devices", lambda: [Dev()])
    with pytest.raises(RuntimeError, match="bytes_limit"):
        engine.device_memory_budget()


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    import jax

    from trialign import engine

    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert engine.setup_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_defaults_to_repo(monkeypatch):
    import jax

    from trialign import engine

    old = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = engine.setup_compile_cache()
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    assert path == os.path.join(engine.REPO_ROOT, ".jax_cache")


# ------------------------------------------------------------ CUDA build

def test_nvcc_command_line():
    from trialign import cuda

    cmd = cuda.build_command("/x/nvcc", "/inc", "/out/lib.so")
    assert cmd[0] == "/x/nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("-I") + 1] == "/inc"
    assert cmd[cmd.index("-o") + 1] == "/out/lib.so"
    assert cmd[-1] == cuda.SOURCE and "-shared" in cmd


def test_library_path_in_ignored_build_dir():
    from trialign import cuda

    path = cuda.library_path("/inc")
    assert os.path.dirname(path) == cuda.BUILD_DIR
    assert path != cuda.library_path("/other")  # keyed by headers too
    root = os.path.dirname(os.path.dirname(cuda.HERE))
    with open(os.path.join(root, ".gitignore")) as f:
        assert "trialign/cuda/_build/" in f.read().split()


def test_nvcc_path_prefers_cuda_home(monkeypatch, tmp_path):
    from trialign import cuda

    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert cuda.nvcc_path() == str(nvcc)


# -------------------------------------------------------------- smoke

def test_chip_smoke_fails_on_cpu():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=root,
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_last_line_contract():
    import importlib.util
    import json

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    line = mod.last_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "count": 1},
    }
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
