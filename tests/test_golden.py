"""Golden-model tests: the brute-force triple loop is the spec of record;
the vectorized plane sweep must agree with it exactly, and tracebacks must
rescore to the DP optimum (the self-checking the reference testbench lacked,
see SURVEY.md section 4)."""

import numpy as np
import pytest

from trialign.config import Scoring, encode
from trialign.golden import (
    align_bruteforce,
    align_planes_numpy,
    rescore_alignment,
    traceback_from_cuboid,
)
from tests.conftest import random_triplet


def test_weight_matrix_matches_rtl_constants():
    # The 49 constants wired in src/PE_1cyc.v:163-218 with GO=2, GE=1:
    # rows/cols in order M, Ix, Iy, Iz, Ixy, Iyz, Ixz.
    w = Scoring().weight_matrix()
    GO, GE = 2, 1
    GO2, GE2, GOGE = 2 * GO, 2 * GE, GO + GE
    expected = -np.array(
        [
            [0, 0, 0, 0, 0, 0, 0],  # M: no gaps
            [GO2, GE2, GOGE, GOGE, GOGE, GO2, GOGE],  # Ix
            [GO2, GOGE, GE2, GOGE, GOGE, GOGE, GO2],  # Iy
            [GO2, GOGE, GOGE, GE2, GO2, GOGE, GOGE],  # Iz
            [GO, GE, GE, GO, GE, GO, GO],  # Ixy
            [GO, GO, GE, GE, GO, GE, GO],  # Iyz
            [GO, GE, GO, GE, GO, GO, GE],  # Ixz
        ],
        dtype=np.int32,
    )
    np.testing.assert_array_equal(w, expected)


@pytest.mark.parametrize("s3_mode", ["sop", "rtl"])
@pytest.mark.parametrize(
    "dims", [(1, 1, 1), (2, 3, 4), (5, 5, 5), (7, 3, 6), (8, 8, 8), (1, 8, 3)]
)
def test_planes_match_bruteforce_small(rng, dims, s3_mode):
    scoring = Scoring(s3_mode=s3_mode)
    for trial in range(3):
        a, b, c = random_triplet(rng, *dims)
        expected = align_bruteforce(a, b, c, scoring)
        got = align_planes_numpy(a, b, c, scoring)
        assert got == expected, (dims, s3_mode, trial)


def test_planes_match_bruteforce_nondefault_scoring(rng):
    scoring = Scoring(match=3, mismatch=-2, gap_open=4, gap_extend=1)
    for _ in range(3):
        a, b, c = random_triplet(rng, 6, 7, 5)
        assert align_planes_numpy(a, b, c, scoring) == align_bruteforce(a, b, c, scoring)


def test_identical_sequences_score():
    # n identical symbols in all three sequences: n triple matches, zero gaps.
    # Sum-of-pairs S3 of a triple match is 3, so the score is 3n.
    n = 12
    a = np.zeros(n, dtype=np.uint8)
    assert align_planes_numpy(a, a, a) == 3 * n
    assert align_bruteforce(a, a, a) == 3 * n


def test_empty_sequences():
    e = np.zeros(0, dtype=np.uint8)
    a = encode("ACGT")
    assert align_planes_numpy(e, e, e) == 0
    # With zero borders, an empty sequence pins the final cell onto a border
    # face, whose value is 0 by construction.
    assert align_planes_numpy(a, e, e) == 0
    assert align_bruteforce(a, e, e) == 0


def test_permutation_symmetry_sop(rng):
    # Sum-of-pairs scoring is symmetric under permuting the three sequences.
    a, b, c = random_triplet(rng, 6, 8, 7)
    s = align_planes_numpy(a, b, c)
    for p in [(a, c, b), (b, a, c), (b, c, a), (c, a, b), (c, b, a)]:
        assert align_planes_numpy(*p) == s


def test_rtl_s3_quirk_values():
    # RTL quirk (src/PE_1cyc.v:162): S3 = 3 iff a==b==c, 0 if a==b!=c,
    # -3 whenever a!=b even if b==c or a==c (true SOP would give -1 there).
    s = Scoring(s3_mode="rtl")
    assert int(s.triple_score(0, 0, 0)) == 3
    assert int(s.triple_score(0, 0, 1)) == 0
    assert int(s.triple_score(1, 0, 0)) == -3
    assert int(s.triple_score(0, 1, 0)) == -3
    sop = Scoring(s3_mode="sop")
    assert int(sop.triple_score(0, 0, 1)) == -1
    assert int(sop.triple_score(1, 0, 0)) == -1


def test_cuboid_agreement(rng):
    a, b, c = random_triplet(rng, 5, 6, 4)
    s1, d1 = align_bruteforce(a, b, c, return_cuboid=True)
    s2, d2 = align_planes_numpy(a, b, c, return_cuboid=True)
    assert s1 == s2
    np.testing.assert_array_equal(d1, d2)


@pytest.mark.parametrize("dims", [(5, 5, 5), (9, 7, 8), (12, 4, 10)])
def test_traceback_rescores_to_optimum(rng, dims):
    scoring = Scoring()
    for _ in range(5):
        a, b, c = random_triplet(rng, *dims)
        score, cuboid = align_planes_numpy(a, b, c, scoring, return_cuboid=True)
        tb_score, aligned = traceback_from_cuboid(a, b, c, cuboid, scoring)
        assert tb_score == score
        # The alignment must reproduce the sequences when gaps are removed.
        for seq, row in zip((a, b, c), aligned):
            assert [v for v in row if v != -1] == list(map(int, seq))
        assert rescore_alignment(aligned, scoring) == score


def test_reference_dat_vectors_parity():
    # Canonical short triplet: bundled 64-symbol vectors (and, when the
    # read-only reference checkout is mounted, its dat/ vectors too) must
    # give identical scores from both golden implementations.
    import os

    from trialign.io import load_reference_triplet

    triplets = [load_reference_triplet()]
    if os.path.exists("/root/reference/dat/A_seq.dat"):
        triplets.append(load_reference_triplet("/root/reference/dat"))
    for a, b, c in triplets:
        assert len(a) == len(b) == len(c) == 64
        score = align_planes_numpy(a, b, c)
        assert isinstance(score, int)
        # Sanity bounds: at most 3 per column of 64 triple matches.
        assert -1000 < score <= 192


def test_bundled_vectors_are_verbatim_reference_copies():
    # The bundled data/ triplet must be byte-identical to the reference's
    # dat/ vectors (reference: dat/A_seq.dat:1-64 etc.); the alt fixture
    # must be a *different* triplet (an independent second parity case).
    import os

    import numpy as np

    from trialign.io import load_alt_triplet, load_reference_triplet

    if not os.path.exists("/root/reference/dat/A_seq.dat"):
        pytest.skip("reference checkout not mounted")
    bundled = load_reference_triplet()
    upstream = load_reference_triplet("/root/reference/dat")
    for b_seq, u_seq in zip(bundled, upstream):
        assert np.array_equal(b_seq, u_seq)
    alt = load_alt_triplet()
    assert not all(np.array_equal(x, y) for x, y in zip(alt, upstream))


@pytest.mark.slow
def test_reference_dat_vectors_bruteforce_parity():
    from trialign.io import load_reference_triplet

    a, b, c = load_reference_triplet()
    assert align_bruteforce(a, b, c) == align_planes_numpy(a, b, c)


def test_score_bits_wraparound(rng):
    """RTL-parity mode: SCORE_BITS-wide unsaturated registers wrap
    (reference: src/TriAlign_1cyc.v:6, SURVEY.md section 0.3 quirk 3).
    With generous width it matches the clean model; with a tiny width the
    identical-sequence score overflows and wraps, as the hardware would."""
    from trialign.golden import align_planes_numpy

    a, b, c = random_triplet(rng, 20, 20, 20)
    clean = align_planes_numpy(a, b, c)
    assert align_planes_numpy(a, b, c, score_bits=12) == clean

    s = np.full(40, 2, dtype=np.uint8)  # identical triplet: score 3*40 = 120
    assert align_planes_numpy(s, s, s) == 120
    wrapped = align_planes_numpy(s, s, s, score_bits=6)  # range [-32, 31]
    assert wrapped != 120 and -32 <= wrapped <= 31


def test_determinism_across_runs(rng):
    """Determinism audit (SURVEY section 5: race detection): repeated
    evaluation of every backend yields identical integers -- integer
    max-plus has no reassociation hazard and the kernels introduce no
    nondeterministic reductions."""
    from trialign.kernels.sweep import align_sweep
    from trialign.kernels.xla_ref import align_xla

    a, b, c = random_triplet(rng, 12, 22, 30)
    for fn in (align_xla, align_sweep):
        first = fn(a, b, c)
        for _ in range(2):
            assert fn(a, b, c) == first
