"""Hirschberg divide-and-conquer alignment recovery: scores must equal the
golden DP optimum, recovered alignments must reproduce the sequences and
independently rescore to the optimum."""

import numpy as np
import pytest

import trialign.traceback.hirschberg as H
from trialign.config import Scoring
from trialign.golden import align_planes_numpy, rescore_alignment
from trialign.traceback.engine import backward_slab, forward_sweep
from trialign.traceback.hirschberg import hirschberg_align
from tests.conftest import random_triplet


def _check(a, b, c, scoring=Scoring()):
    want = align_planes_numpy(a, b, c, scoring)
    got, rows = hirschberg_align(a, b, c, scoring)
    assert got == want
    for row, seq in zip(rows, (a, b, c)):
        assert [v for v in row if v != -1] == list(map(int, seq))
    assert rescore_alignment(rows, scoring) == want


def test_small_cases_recursive(rng, monkeypatch):
    # Tiny base budget forces multiple split levels even at small sizes.
    monkeypatch.setattr(H, "BASE_CELLS", 2000)
    for _ in range(8):
        la, lb, lc = (int(x) for x in rng.integers(8, 40, size=3))
        _check(*random_triplet(rng, la, lb, lc))


# Out-of-memory texts of the GPU stack: XLA's allocator, CUDA's error
# codes, and the allocator's limit dialect.  The fallback gate must
# treat every dialect of memory exhaustion as a split trigger.
_REAL_OOM_TEXTS = [
    "RESOURCE_EXHAUSTED: Out of memory while trying to allocate "
    "10737418240 bytes.",
    "INTERNAL: Failed to allocate 10737418240 bytes for new constant: "
    "CUDA_ERROR_OUT_OF_MEMORY: out of memory",
    "INTERNAL: cudaErrorMemoryAllocation while launching a kernel",
    "RESOURCE_EXHAUSTED: while allocating",
    "Allocation of 10737418240 bytes exceeds the limit",
]


@pytest.mark.parametrize("text", _REAL_OOM_TEXTS)
def test_direct_oom_falls_back_to_split(rng, monkeypatch, text):
    """A memory-exhaustion failure from the direct engine above the
    safe-size floor falls through to the Hirschberg split instead of
    failing -- for every dialect the GPU stack produces."""
    import trialign.traceback.direct as D

    calls = []

    def boom(*a, **k):
        calls.append(1)
        raise RuntimeError(text)

    monkeypatch.setattr(H, "BASE_CELLS", 2000)
    monkeypatch.setattr(H, "_DIRECT_SAFE_CELLS", 0)
    monkeypatch.setattr(H, "DIRECT_CELLS", 10**9)
    monkeypatch.setattr(D, "direct_traceback", boom)
    la, lb, lc = 16, 18, 20
    _check(*random_triplet(rng, la, lb, lc))
    assert calls  # the direct engine was attempted and rejected


def test_direct_byte_gate_routes_oversize_proactively(rng, monkeypatch):
    """When the footprint model says the direct engine cannot fit the
    device, _solve must take the split WITHOUT attempting the engine
    (no multi-minute doomed compile on hardware)."""
    import trialign.traceback.direct as D

    def boom(*a, **k):  # pragma: no cover - must not be reached
        raise AssertionError("direct engine attempted despite byte gate")

    monkeypatch.setattr(H, "BASE_CELLS", 2000)
    monkeypatch.setattr(H, "DIRECT_CELLS", 10**9)
    monkeypatch.setattr(D, "direct_traceback", boom)
    monkeypatch.setattr(H, "_direct_fits", lambda la, lb, lc: False)
    _check(*random_triplet(rng, 16, 18, 20))


@pytest.mark.parametrize("n", [128, 256])
def test_direct_memory_model_and_budget(n):
    """The footprint model stays an overestimate of what the compiled
    sweep segment holds (arguments + temporaries + unaliased outputs, from
    the CPU compiler's memory_analysis), without being loose beyond its
    fixed headroom; the device budget is sane."""
    import jax.numpy as jnp

    import trialign.traceback.direct as D
    from trialign.engine import device_memory_budget

    qq, hb, wc = D.direct_shapes(n, n, n)
    z = lambda k: jnp.zeros(k, jnp.int32)  # noqa: E731
    carry = D._init_carry(z(7), hb, wc, "free")
    compiled = D._choices_seg.lower(
        z(4), z(qq - hb - wc + 1), z(hb), z(wc), z(7), carry,
        jnp.zeros((qq, hb * wc), jnp.uint16),
        jnp.zeros((qq, hb * wc), jnp.uint8),
        hb, wc, qq, Scoring(), "free", min(D.SEG_STEPS, qq),
    ).compile()
    m = compiled.memory_analysis()
    peak = (m.argument_size_in_bytes + m.temp_size_in_bytes
            + m.output_size_in_bytes - m.alias_size_in_bytes)
    modeled = D.direct_memory_bytes(n, n, n)
    assert modeled >= peak
    assert modeled - (192 << 20) <= 1.2 * peak
    assert device_memory_budget() > 2**30


def test_direct_small_oom_reraises(rng, monkeypatch):
    """Below the safe-size floor an allocation failure is a real bug and
    must surface, not silently recurse."""
    import trialign.traceback.direct as D

    def boom(*a, **k):
        raise RuntimeError("RESOURCE_EXHAUSTED: while allocating")

    monkeypatch.setattr(H, "BASE_CELLS", 2000)
    monkeypatch.setattr(H, "DIRECT_CELLS", 10**9)
    monkeypatch.setattr(D, "direct_traceback", boom)
    a, b, c = random_triplet(rng, 16, 18, 20)
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
        H.hirschberg_align(a, b, c)


def test_rtl_and_nondefault_scoring(rng, monkeypatch):
    monkeypatch.setattr(H, "BASE_CELLS", 2000)
    sc = Scoring(match=2, mismatch=-1, gap_open=3, gap_extend=1, s3_mode="rtl")
    for _ in range(3):
        la, lb, lc = (int(x) for x in rng.integers(10, 35, size=3))
        _check(*random_triplet(rng, la, lb, lc), scoring=sc)


def test_submatrix_traceback_recursive_and_direct(rng, monkeypatch):
    """Runtime substitution matrix through FULL alignment recovery: the
    recursive Hirschberg split (engine sweeps + argmax walk) and the
    device direct choice-capture engine must both return optimal,
    rescore-exact alignments under a random submatrix (the reference's
    planned score ports, src/TriAlign_tb.sv:220-224,280-290)."""
    for trial in range(3):
        m = rng.integers(-4, 5, size=(4, 4))
        m = ((m + m.T) // 2).astype(int)
        sc = Scoring(submatrix=tuple(tuple(int(v) for v in row) for row in m))
        la, lb, lc = (int(x) for x in rng.integers(12, 30, size=3))
        a, b, c = random_triplet(rng, la, lb, lc)
        # Force the recursive split path (both halves walked).
        monkeypatch.setattr(H, "BASE_CELLS", 800)
        monkeypatch.setattr(H, "DIRECT_CELLS", 900)
        _check(a, b, c, scoring=sc)
        # Direct choice-capture engine.
        monkeypatch.setattr(H, "BASE_CELLS", 500)
        monkeypatch.setattr(H, "DIRECT_CELLS", 10**9)
        _check(a, b, c, scoring=sc)


def test_split_combination_equals_full_score(rng):
    # max(F + G) over the split slab must reproduce the full DP optimum
    # whenever some optimal path crosses i = m by real steps; with the
    # right-half free_jk fallback the max of the two equals the optimum.
    a, b, c = random_triplet(rng, 20, 15, 18)
    want = align_planes_numpy(a, b, c)
    m = 10
    _, f_slab, _ = forward_sweep(a[:m], b, c, capture_m=m)
    g_slab = backward_slab(a[m:], b, c)
    h_final, _, _ = forward_sweep(a[m:], b, c, mode="free_jk")
    combined = max(int((f_slab.astype(np.int64) + g_slab).max()), int(h_final.max()))
    assert combined == want


def test_identical_sequences(monkeypatch):
    monkeypatch.setattr(H, "BASE_CELLS", 500)
    n = 24
    a = np.tile(np.arange(4, dtype=np.uint8), n // 4)
    score, rows = hirschberg_align(a, a, a)
    assert score == 3 * n
    assert rows[0] == rows[1] == rows[2] == list(map(int, a))


def test_empty_sequence():
    e = np.zeros(0, dtype=np.uint8)
    a = np.array([0, 1, 2], dtype=np.uint8)
    score, rows = hirschberg_align(a, e, a)
    assert score == 0
    assert [v for v in rows[0] if v != -1] == [0, 1, 2]
    assert all(v == -1 for v in rows[1])


@pytest.mark.slow
def test_dat_triplet(monkeypatch):
    from trialign.io import load_reference_triplet

    monkeypatch.setattr(H, "BASE_CELLS", 2000)
    a, b, c = load_reference_triplet()
    _check(a, b, c)


def test_xla_engine_matches_numpy_engine(rng):
    """The jitted sweep twins must match the NumPy spec elementwise on all
    three modes and the backward slab."""
    import numpy as np

    from trialign.config import NUM_MATRICES, Scoring
    from trialign.traceback.engine import NEG, backward_slab, forward_sweep
    from trialign.traceback.xla_engine import backward_slab_xla, forward_sweep_xla
    from tests.conftest import random_triplet

    sc = Scoring()
    a, b, c = random_triplet(rng, 14, 11, 9)
    m = 7

    for mode in ("free", "free_jk", "pin"):
        v0 = None
        if mode == "pin":
            v0 = np.full(NUM_MATRICES, NEG, dtype=np.int32)
            v0[0] = 0
        f_np, s_np, _ = forward_sweep(a, b, c, sc, mode=mode, v0=v0, capture_m=m)
        f_x, s_x = forward_sweep_xla(a, b, c, sc, mode=mode, v0=v0, capture_m=m)
        assert np.array_equal(f_np, f_x), mode
        assert np.array_equal(s_np, s_x), mode

    end_v = np.full(NUM_MATRICES, NEG, dtype=np.int32)
    end_v[4] = 0
    g_np = backward_slab(a[m:], b, c, sc, end_v=end_v)
    g_x = backward_slab_xla(a[m:], b, c, sc, end_v=end_v)
    assert np.array_equal(g_np, g_x)


def test_hirschberg_with_xla_slabs(rng, monkeypatch):
    """Force the XLA slab path in the recursion and check exact alignments."""
    import trialign.traceback.hirschberg as H
    from trialign.golden import align_planes_numpy
    from trialign.golden.numpy_model import rescore_alignment
    from tests.conftest import random_triplet

    monkeypatch.setattr(H, "XLA_CELLS", 0)
    monkeypatch.setattr(H, "BASE_CELLS", 1 << 8)
    a, b, c = random_triplet(rng, 24, 18, 15)
    want = align_planes_numpy(a, b, c)
    score, rows = H.hirschberg_align(a, b, c)
    assert score == want
    assert rescore_alignment(rows) == want


def test_dat_triplet_alignment_parity():
    """BASELINE config 1: exact score AND alignment on the reference's
    dat/A_seq,B_seq,C_seq vectors."""
    from trialign.golden import align_planes_numpy
    from trialign.golden.numpy_model import rescore_alignment
    from trialign.io import load_reference_triplet
    from trialign.traceback import hirschberg_align

    a, b, c = load_reference_triplet()
    want = align_planes_numpy(a, b, c)
    score, rows = hirschberg_align(a, b, c)
    assert score == want
    assert rescore_alignment(rows) == want
    # The alignment reproduces the sequences when gaps are stripped.
    import numpy as np

    for row, seq in zip(rows, (a, b, c)):
        assert np.array_equal([v for v in row if v != -1], seq)


def test_alignment_actions(rng):
    """Action-trace export: one code per column, consistent with the column
    consume patterns, and the M-run count matches triple-symbol columns."""
    from trialign.config import CONSUMES
    from trialign.traceback.hirschberg import alignment_actions, hirschberg_align

    a, b, c = random_triplet(rng, 20, 18, 22)
    _, rows = hirschberg_align(a, b, c)
    acts = alignment_actions(rows)
    assert len(acts) == len(rows[0])
    for col, t in zip(zip(*rows), acts):
        assert tuple(int(v != -1) for v in col) == CONSUMES[t]


def test_xla_engine_multi_segment(rng, monkeypatch):
    """Segment-boundary correctness: with a tiny SEG_STEPS the sweep crosses
    many segment boundaries; results must be identical to the NumPy spec."""
    import numpy as np

    import trialign.traceback.xla_engine as X
    from trialign.config import NUM_MATRICES, Scoring
    from trialign.traceback.engine import NEG, backward_slab, forward_sweep

    monkeypatch.setattr(X, "SEG_STEPS", 16)
    sc = Scoring()
    a, b, c = random_triplet(rng, 30, 20, 25)
    m = 13
    for mode in ("free", "free_jk", "pin"):
        v0 = None
        if mode == "pin":
            v0 = np.full(NUM_MATRICES, NEG, dtype=np.int32)
            v0[2] = 0
        f_np, s_np, _ = forward_sweep(a, b, c, sc, mode=mode, v0=v0, capture_m=m)
        f_x, s_x = X.forward_sweep_xla(a, b, c, sc, mode=mode, v0=v0, capture_m=m)
        assert np.array_equal(f_np, f_x), mode
        assert np.array_equal(s_np, s_x), mode
    g_np = backward_slab(a[m:], b, c, sc)
    g_x = X.backward_slab_xla(a[m:], b, c, sc)
    assert np.array_equal(g_np, g_x)


def test_direct_engine_all_modes_via_recursion(rng, monkeypatch):
    """Exercise the direct choice-capture engine (traceback/direct.py) in
    every submode (free top, free_jk restart, pin halves) by shrinking the
    thresholds so the recursion bottoms out in it."""
    monkeypatch.setattr(H, "BASE_CELLS", 400)
    monkeypatch.setattr(H, "DIRECT_CELLS", 6000)
    for trial in range(4):
        la, lb, lc = (int(x) for x in rng.integers(8, 30, 3))
        a, b, c = random_triplet(rng, la, lb, lc)
        want = align_planes_numpy(a, b, c)
        score, rows = H.hirschberg_align(a, b, c)
        assert score == want, trial
        assert rescore_alignment(rows, Scoring()) == want, trial
        for row, seq in zip(rows, (a, b, c)):
            assert [v for v in row if v != -1] == list(map(int, seq)), trial


def test_direct_engine_standalone(rng):
    from trialign.traceback.direct import direct_traceback

    sc = Scoring(match=2, mismatch=-3, gap_open=4, gap_extend=1)
    a, b, c = random_triplet(rng, 25, 30, 35)
    want = align_planes_numpy(a, b, c, sc)
    score, cols = direct_traceback(a, b, c, sc)
    rows = [list(r) for r in zip(*cols)]
    assert score == want
    assert rescore_alignment(rows, sc) == want
