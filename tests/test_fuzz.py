"""Seeded randomized cross-backend parity sweep.

Every compute path must produce the identical integer on every input: the
golden vectorized sweep is itself validated against the O(49 n^3) brute
force (test_golden), so here it serves as the oracle for the compiled
backends across random shapes, scorings, and both S3 modes.
"""

import numpy as np
import pytest

from trialign.config import Scoring
from trialign.golden import align_planes_numpy
from tests.conftest import random_triplet


SCORINGS = [
    Scoring(),
    Scoring(s3_mode="rtl"),
    Scoring(match=2, mismatch=-3, gap_open=4, gap_extend=1),
    Scoring(match=3, mismatch=0, gap_open=1, gap_extend=1),  # go == ge: single group
]


@pytest.mark.slow
def test_fuzz_backends_50_cases(rng):
    from trialign.kernels.sweep import align_sweep
    from trialign.kernels.xla_ref import align_xla
    from trialign.native import score_native

    for trial in range(50):
        la, lb, lc = (int(x) for x in rng.integers(1, 48, size=3))
        a, b, c = random_triplet(rng, la, lb, lc, nsym=int(rng.integers(2, 6)))
        sc = SCORINGS[trial % len(SCORINGS)]
        want = align_planes_numpy(a, b, c, sc)
        assert align_xla(a, b, c, sc) == want, (trial, "xla")
        assert align_sweep(a, b, c, sc) == want, (trial, "sweep")
        assert score_native(a, b, c, sc) == want, (trial, "native")


def test_fuzz_score_bits_xla_matches_golden(rng):
    """RTL bit-parity mode on a compiled backend: the XLA sweep with
    score_bits-wide wrapping registers matches the golden emulation bit for
    bit, including cases where the running scores actually overflow
    (reference: src/TriAlign_1cyc.v:6; PARITY.md quirk 3)."""
    from trialign.kernels.xla_ref import align_xla

    for trial in range(12):
        la, lb, lc = (int(x) for x in rng.integers(4, 28, size=3))
        a, b, c = random_triplet(rng, la, lb, lc, nsym=int(rng.integers(2, 5)))
        sc = SCORINGS[trial % len(SCORINGS)]
        # bits=6 wraps at +/-32 (real overflow at these sizes); bits=12 is
        # the hardware width.
        for bits in (6, 12):
            want = align_planes_numpy(a, b, c, sc, score_bits=bits)
            got = align_xla(a, b, c, sc, score_bits=bits)
            assert got == want, (trial, bits, got, want)
    # An identical-sequence run long enough to overflow 6-bit registers
    # must agree wrapped AND differ from the clean score (wrap really bit).
    n = 30
    seq = np.full(n, 2, np.uint8)
    clean = align_planes_numpy(seq, seq, seq)
    wrapped = align_planes_numpy(seq, seq, seq, score_bits=6)
    assert align_xla(seq, seq, seq, score_bits=6) == wrapped
    assert wrapped != clean


def test_api_score_bits_routing(rng):
    from trialign.api import align

    a, b, c = random_triplet(rng, 10, 10, 10)
    want = align_planes_numpy(a, b, c, score_bits=12)
    res = align(a, b, c, score_bits=12)  # auto -> a wrap-capable backend
    assert res.score == want and res.backend == "sweep"
    with pytest.raises(ValueError, match="score_bits"):
        align(a, b, c, backend="native", score_bits=12)


def test_fuzz_score_bits_blocked_matches_golden(rng):
    """RTL bit-parity mode on the sliced sweep -- the regime where the
    hardware's wraparound actually occurs (scores past 2^11 need long
    sequences; reference: src/TriAlign_1cyc.v:6; PARITY.md quirk 3).
    Wrapped stored planes flow through the faces between row stripes
    too."""
    import trialign.kernels.sweep as S

    for trial in range(4):
        a, b, c = random_triplet(rng, 20, 30, 150,
                                 nsym=int(rng.integers(2, 5)))
        sc = SCORINGS[trial % len(SCORINGS)]
        for bits in (6, 12):
            want = align_planes_numpy(a, b, c, sc, score_bits=bits)
            got = S.align_sweep(a, b, c, sc, score_bits=bits)
            assert got == want, (trial, bits, got, want)
    # Real 6-bit overflow across two row stripes: wrapped matches golden
    # AND differs from the clean score.
    seq = np.full(40, 2, np.uint8)
    clean = align_planes_numpy(seq, seq, seq)
    wrapped = align_planes_numpy(seq, seq, seq, score_bits=6)
    face = S.face_shapes(40, 0, 40)[0]
    row0 = np.zeros(face, np.int32)
    col = np.zeros(S.face_shapes(40, 20, 40)[1], np.int32)
    a_ext, bb, cc = S.prep_sequences(seq, seq, seq)
    row1, _, _ = S.sweep_reference(a_ext, bb[:20], cc, row0, col, Scoring(), 6)
    _, _, final = S.sweep_reference(a_ext, bb[20:], cc, row1, col, Scoring(), 6)
    assert int(final.max()) == wrapped
    assert wrapped != clean


def test_fuzz_score_bits_pallas_matches_golden(rng):
    """RTL bit-parity mode on the production sweep at small shapes
    (round-2 VERDICT item 8): wrapped stored registers, carried max7 from
    wrapped planes, bit-exact vs the golden emulation including real
    overflow."""
    from trialign.kernels.sweep import align_sweep

    for trial in range(12):
        la, lb, lc = (int(x) for x in rng.integers(4, 28, size=3))
        a, b, c = random_triplet(rng, la, lb, lc, nsym=int(rng.integers(2, 5)))
        sc = SCORINGS[trial % len(SCORINGS)]
        for bits in (6, 12):
            want = align_planes_numpy(a, b, c, sc, score_bits=bits)
            got = align_sweep(a, b, c, sc, score_bits=bits)
            assert got == want, (trial, bits, got, want)
    # Real 6-bit overflow: wrapped result must match golden AND differ
    # from the clean score.
    seq = np.full(30, 2, np.uint8)
    clean = align_planes_numpy(seq, seq, seq)
    wrapped = align_planes_numpy(seq, seq, seq, score_bits=6)
    assert align_sweep(seq, seq, seq, score_bits=6) == wrapped
    assert wrapped != clean


@pytest.mark.slow
def test_fuzz_traceback_20_cases(rng):
    from trialign.golden.numpy_model import rescore_alignment
    from trialign.traceback.hirschberg import hirschberg_align

    for trial in range(20):
        la, lb, lc = (int(x) for x in rng.integers(2, 36, size=3))
        a, b, c = random_triplet(rng, la, lb, lc)
        sc = SCORINGS[trial % 2]
        want = align_planes_numpy(a, b, c, sc)
        score, rows = hirschberg_align(a, b, c, sc)
        assert score == want, trial
        assert rescore_alignment(rows, sc) == want, trial
        for row, seq in zip(rows, (a, b, c)):
            assert [v for v in row if v != -1] == list(map(int, seq))


def test_submatrix_scoring_golden_vs_xla(rng):
    """Runtime 4x4 substitution matrix (the testbench's planned-never-
    wired score-matrix ports, src/TriAlign_tb.sv:220-224,280-290): the
    brute force, the golden plane sweep and the compiled XLA backend must
    agree on random matrices; a matrix that replicates match/mismatch
    equality must reproduce default scoring exactly."""
    from trialign.golden import align_bruteforce
    from trialign.kernels.xla_ref import align_xla

    for trial in range(6):
        m = rng.integers(-4, 5, size=(4, 4))
        m = ((m + m.T) // 2).astype(int)  # symmetric, like real sub matrices
        sub = tuple(tuple(int(v) for v in row) for row in m)
        sc = Scoring(submatrix=sub)
        la, lb, lc = (int(x) for x in rng.integers(2, 14, size=3))
        a, b, c = random_triplet(rng, la, lb, lc)
        want = align_planes_numpy(a, b, c, sc)
        assert align_bruteforce(a, b, c, sc) == want, trial
        assert align_xla(a, b, c, sc) == want, trial

    # Degenerate matrix == equality scoring.
    eye = tuple(
        tuple(1 if i == j else -1 for j in range(4)) for i in range(4)
    )
    a, b, c = random_triplet(rng, 10, 11, 9)
    assert align_planes_numpy(a, b, c, Scoring(submatrix=eye)) == \
        align_planes_numpy(a, b, c, Scoring())
    assert align_xla(a, b, c, Scoring(submatrix=eye)) == \
        align_xla(a, b, c, Scoring())


def test_submatrix_validation_and_routing(rng):
    from trialign.api import align
    from trialign.kernels.sweep import align_sweep

    sub = ((2, -1), (-1, 2))
    with pytest.raises(ValueError, match="sop"):
        Scoring(submatrix=sub, s3_mode="rtl")
    with pytest.raises(ValueError, match="square"):
        Scoring(submatrix=((1, 2), (3,)))
    a, b, c = random_triplet(rng, 6, 7, 5, nsym=2)
    sc = Scoring(submatrix=sub)
    # auto routes small alphabets to the sliced sweep.
    res = align(a, b, c, sc)
    assert res.backend == "sweep"
    assert res.score == align_planes_numpy(a, b, c, sc)
    # Alphabets beyond the sweep's cap stay on golden/xla.
    big = tuple(tuple(1 if i == j else -1 for j in range(9)) for i in range(9))
    sc_big = Scoring(submatrix=big)
    res_big = align(a, b, c, sc_big)
    assert res_big.backend == "xla"
    assert res_big.score == align_planes_numpy(a, b, c, sc_big)
    with pytest.raises(ValueError, match="submatrix"):
        align(a, b, c, sc_big, backend="sweep")
    with pytest.raises(ValueError, match="symbols"):
        align_sweep(a, b, c, sc_big)
    # The C++ engine evaluates the matrix via its (256, 256) lookup.
    try:
        from trialign.native import is_available

        native_ok = is_available()
    except Exception:
        native_ok = False  # toolchain missing
    if native_ok:
        res_n = align(a, b, c, sc, backend="native")
        assert res_n.score == align_planes_numpy(a, b, c, sc)
    # Big alphabet + score_bits + auto must route, not raise.
    res_bits = align(a, b, c, sc_big, score_bits=8)
    assert res_bits.backend == "xla"
    assert res_bits.score == align_planes_numpy(a, b, c, sc_big,
                                                score_bits=8)


def test_fuzz_submatrix_pallas_and_blocked_match_golden(rng):
    """Runtime substitution matrix on the production sweep: random
    symmetric matrices, including pads falling through to the clamped
    floor, and a shape with several row stripes (reference capability:
    src/TriAlign_tb.sv:220-224,280-290)."""
    import trialign.kernels.sweep as S

    for trial in range(4):
        nsym = int(rng.integers(2, 6))
        m = rng.integers(-4, 5, size=(nsym, nsym))
        m = ((m + m.T) // 2).astype(int)
        sub = tuple(tuple(int(v) for v in row) for row in m)
        sc = Scoring(submatrix=sub)
        a, b, c = random_triplet(rng, int(rng.integers(3, 20)),
                                 int(rng.integers(3, 16)),
                                 int(rng.integers(3, 16)), nsym=nsym)
        assert S.align_sweep(a, b, c, sc) == align_planes_numpy(a, b, c, sc)
    m = rng.integers(-3, 4, size=(4, 4))
    sub = tuple(tuple(int(v) for v in row) for row in m)
    sc = Scoring(submatrix=sub)
    a, b, c = random_triplet(rng, 18, 40, 60)
    assert len(S.plan_stripes(18, 40, 60, S.call_bytes(18, 16, 60))) == 3
    assert S.align_sweep(a, b, c, sc) == align_planes_numpy(a, b, c, sc)


def test_submatrix_with_score_bits_composes(rng):
    """Runtime submatrix AND RTL register wrap together: every compiled
    backend must reproduce the golden emulation bit-for-bit through real
    overflow (big positive matrix values force it at short lengths)."""
    from trialign.api import align
    from trialign.kernels.sweep import align_sweep
    from trialign.kernels.xla_ref import align_xla

    sub = ((6, -2, -1, 0), (-2, 6, 0, -1), (-1, 0, 6, -1), (0, -1, -1, 6))
    sc = Scoring(submatrix=sub)
    seq = np.full(30, 1, np.uint8)
    clean = align_planes_numpy(seq, seq, seq, sc)
    for bits in (6, 8):
        want = align_planes_numpy(seq, seq, seq, sc, score_bits=bits)
        assert want != clean  # overflow actually occurred
        assert align_xla(seq, seq, seq, sc, score_bits=bits) == want
        assert align_sweep(seq, seq, seq, sc, score_bits=bits) == want
    res = align(seq, seq, seq, sc, score_bits=8)  # auto-routing composes
    assert res.score == align_planes_numpy(seq, seq, seq, sc, score_bits=8)


def test_fuzz_score_bits_chain_matches_golden(rng):
    """RTL bit-parity mode over several A's against shared B/C
    (round-4 VERDICT weak 5): every problem must wrap exactly like the
    golden emulation, including one with real 6-bit overflow."""
    from trialign.kernels.sweep import align_sweep

    a_list = [rng.integers(0, 4, 24).astype(np.uint8) for _ in range(3)]
    a_list.append(np.full(24, 2, np.uint8))  # overflow-prone
    b = np.full(40, 2, np.uint8)
    c = np.concatenate([np.full(30, 2, np.uint8),
                        rng.integers(0, 4, 10).astype(np.uint8)])
    for bits in (6, 12):
        want = [align_planes_numpy(a, b, c, score_bits=bits)
                for a in a_list]
        got = [align_sweep(a, b, c, score_bits=bits) for a in a_list]
        assert got == want, (bits, got, want)
    # The 6-bit case must actually overflow somewhere in the set.
    clean = [align_planes_numpy(a, b, c) for a in a_list]
    assert [align_planes_numpy(a, b, c, score_bits=6) for a in a_list] != clean
