"""Scoring configuration for three-sequence alignment.

This module defines the scoring semantics of the 7-matrix affine-gap 3-D
dynamic program computed by the reference RTL accelerator
(reference: src/PE_1cyc.v:55-218, src/TriAlign_1cyc.v:141-181), expressed as
data rather than hard-coded wires so every backend (NumPy golden model, XLA
reference, the CUDA sweep, native C++ engine) derives the identical math
from one place.

The seven DP matrices, in canonical order, track which subset of the three
sequences (A on the i axis, B on j, C on k) consumes a symbol at each step
(reference: src/PE_1cyc.v:46-48 port groups; SURVEY.md section 0.1):

    index  name   consumes  predecessor offset (di, dj, dk)
      0     M      A,B,C     (1, 1, 1)
      1     Ix     A         (1, 0, 0)
      2     Iy     B         (0, 1, 0)
      3     Iz     C         (0, 0, 1)
      4     Ixy    A,B       (1, 1, 0)
      5     Iyz    B,C       (0, 1, 1)
      6     Ixz    A,C       (1, 0, 1)

Transition weights follow the affine-gap rule implemented by the PE's 49
add terms (reference: src/PE_1cyc.v:163-218): for target matrix t, each axis
NOT consumed by t is a gap this step; that gap charges ``gap_extend`` if the
source matrix s also did not consume the axis (continuing an existing gap)
and ``gap_open`` otherwise.  The substitution bonus of t is the sum of
pairwise scores over the axes t consumes (S3 for M, S2 for the two-consume
matrices, 0 for single-consume), see src/PE_1cyc.v:159-162.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np

# Matrix names in canonical order (matches the RTL port naming,
# src/PE_1cyc.v:46-49).
MATRIX_NAMES: Tuple[str, ...] = ("M", "Ix", "Iy", "Iz", "Ixy", "Iyz", "Ixz")
NUM_MATRICES = 7

# consumes[t] = (consumes A, consumes B, consumes C) for matrix t.
CONSUMES: Tuple[Tuple[int, int, int], ...] = (
    (1, 1, 1),  # M
    (1, 0, 0),  # Ix
    (0, 1, 0),  # Iy
    (0, 0, 1),  # Iz
    (1, 1, 0),  # Ixy
    (0, 1, 1),  # Iyz
    (1, 0, 1),  # Ixz
)

# Predecessor cell offset of matrix t is exactly its consume vector:
# matrix t at (i,j,k) extends paths ending at (i-di, j-dj, k-dk).
OFFSETS = CONSUMES

# DNA alphabet encoding used by the reference host testbench
# (reference: src/TriAlign_tb.sv:42-46).
ALPHABET = {"A": 0, "T": 1, "C": 2, "G": 3, "N": 4}
ALPHABET_INV = {v: k for k, v in ALPHABET.items()}

# Value used to pad sequences; never equal to any real symbol so padded
# positions always score as mismatches and never leak into valid cells.
PAD_SYMBOL = 255


@functools.lru_cache(maxsize=32)
def _sub_lookup_cached(submatrix: Tuple[Tuple[int, ...], ...]) -> np.ndarray:
    m = np.asarray(submatrix, dtype=np.int32)
    floor = min(int(m.min()), -1)
    lut = np.full((256, 256), floor, dtype=np.int32)
    n = m.shape[0]
    lut[:n, :n] = m
    lut.flags.writeable = False
    return lut


@dataclasses.dataclass(frozen=True)
class Scoring:
    """Scoring parameters for the 3-sequence affine-gap alignment.

    Defaults replicate the RTL's compile-time constants
    (reference: src/PE_1cyc.v:55-58): MATCH=1, MISMATCH=-1, GO=2, GE=1.

    ``s3_mode`` selects the triple-substitution function:
      * ``"sop"`` (default): true sum-of-pairs,
        S3(a,b,c) = S(a,b) + S(b,c) + S(a,c) in {3, -1, -3} -- the paper's
        stated semantics (pic/Algorithm.png).
      * ``"rtl"``: the function the hardware actually computes due to a
        Verilog operator-precedence quirk (reference: src/PE_1cyc.v:162):
        3 if a==b==c, 0 if a==b!=c, -3 if a!=b (regardless of b==c / a==c).

    Borders: all seven matrices are 0 on the i=0, j=0, k=0 faces, matching
    the RTL's zero-emitting border muxes (reference: src/TriAlign_1cyc.v:157-181
    and the EN_i&&!EN first-column case in src/PE_1cyc.v:164-218).

    ``submatrix``: optional runtime substitution matrix -- a square tuple
    of tuples where submatrix[x][y] is the pairwise score S(x, y) for
    symbol codes x, y (the reference testbench PLANNED this as its
    commented 4x4 score-matrix ports but never wired it upstream,
    src/TriAlign_tb.sv:220-224,280-290).  Requires s3_mode="sop" (the rtl
    quirk function is defined by symbol equality, not scores).  Runs on
    every scoring backend -- the sliced sweep for alphabets <=
    plane_math.SUBMATRIX_NSYM_CAP symbols, golden/xla for any size <= 16
    -- and through full alignment recovery (all traceback engines).  Symbols outside the matrix (sequence padding) score the
    matrix minimum, clamped <= -1, so padded cells keep decaying and
    never leak into valid ones.
    """

    match: int = 1
    mismatch: int = -1
    gap_open: int = 2
    gap_extend: int = 1
    s3_mode: str = "sop"
    submatrix: Tuple[Tuple[int, ...], ...] | None = None

    def __post_init__(self):
        if self.s3_mode not in ("sop", "rtl"):
            raise ValueError(f"s3_mode must be 'sop' or 'rtl', got {self.s3_mode!r}")
        if self.submatrix is not None:
            if self.s3_mode != "sop":
                raise ValueError(
                    "submatrix scoring requires s3_mode='sop' (the rtl "
                    "quirk S3 is defined by symbol equality)"
                )
            n = len(self.submatrix)
            if not (1 <= n <= 16) or any(len(r) != n for r in self.submatrix):
                raise ValueError(
                    f"submatrix must be a square tuple of tuples, <= 16 "
                    f"symbols; got rows {[len(r) for r in self.submatrix]}"
                )
            # frozen dataclass: normalize via object.__setattr__
            object.__setattr__(
                self,
                "submatrix",
                tuple(tuple(int(v) for v in row) for row in self.submatrix),
            )

    def sub_lookup(self) -> np.ndarray:
        """(256, 256) int32 pairwise-score lookup over full symbol space.

        In-alphabet pairs read ``submatrix``; any pair touching an
        out-of-alphabet code (PAD_SYMBOL and friends) scores
        min(matrix minimum, -1) so garbage cells stay bounded exactly as
        the equality scheme's always-mismatching pads do.  Memoized (the
        traceback engines call pair_score per plane step); the returned
        array is read-only."""
        assert self.submatrix is not None
        return _sub_lookup_cached(self.submatrix)

    # ------------------------------------------------------------------
    # Derived tables (NumPy; backends convert as needed).
    # ------------------------------------------------------------------
    def weight_matrix(self) -> np.ndarray:
        """(7, 7) int32 W where W[t, s] is the (non-positive) gap charge
        added when matrix t at a cell extends matrix s at t's predecessor.

        Reproduces the 49 constants wired in src/PE_1cyc.v:163-218.
        """
        w = np.zeros((NUM_MATRICES, NUM_MATRICES), dtype=np.int64)
        for t in range(NUM_MATRICES):
            for s in range(NUM_MATRICES):
                charge = 0
                for axis in range(3):
                    if CONSUMES[t][axis] == 0:  # axis is gapped in target
                        if CONSUMES[s][axis] == 0:  # gap continues
                            charge += self.gap_extend
                        else:  # gap opens
                            charge += self.gap_open
                w[t, s] = -charge
        return w.astype(np.int32)

    def pair_score(self, x, y):
        """Elementwise pairwise substitution score S(x, y); works on arrays."""
        if self.submatrix is not None:
            lut = self.sub_lookup()
            return lut[
                np.asarray(x, dtype=np.int64) & 0xFF,
                np.asarray(y, dtype=np.int64) & 0xFF,
            ]
        return np.where(np.asarray(x) == np.asarray(y), self.match, self.mismatch).astype(
            np.int32
        )

    def triple_score(self, a, b, c):
        """Elementwise triple substitution score S3(a, b, c)."""
        a = np.asarray(a)
        b = np.asarray(b)
        c = np.asarray(c)
        if self.s3_mode == "sop":
            return (
                self.pair_score(a, b) + self.pair_score(b, c) + self.pair_score(a, c)
            ).astype(np.int32)
        # RTL quirk mode (src/PE_1cyc.v:162): nested ternary keyed on a==b
        # then b==c; the two middle branches collapse to 3 and 0 for the
        # default constants, and the a!=b branch is always 3*mismatch.
        eq_ab = a == b
        eq_bc = b == c
        # a==b and b==c  -> 3*match   (a==c is then implied)
        # a==b and b!=c  -> (match + mismatch) << 1 per verilog precedence,
        #                   i.e. (match + mismatch) * 2
        # a!=b           -> 3*mismatch
        return np.where(
            eq_ab,
            np.where(eq_bc, 3 * self.match, (self.match + self.mismatch) * 2),
            3 * self.mismatch,
        ).astype(np.int32)

    def max_cell_delta(self) -> int:
        """Upper bound on per-step score increase (for overflow analysis)."""
        if self.submatrix is not None:
            return 3 * max(abs(v) for row in self.submatrix for v in row)
        return 3 * abs(self.match)


def encode(seq) -> np.ndarray:
    """Encode a DNA string (or iterable of ints) to uint8 codes.

    Uses the testbench's mapping A=0, T=1, C=2, G=3, N=4
    (reference: src/TriAlign_tb.sv:42-46).
    """
    if isinstance(seq, str):
        try:
            return np.array([ALPHABET[ch.upper()] for ch in seq], dtype=np.uint8)
        except KeyError as e:
            raise ValueError(f"unknown symbol {e.args[0]!r} in sequence") from None
    arr = np.asarray(seq)
    return arr.astype(np.uint8)


def decode(codes) -> str:
    """Decode uint8 codes back to a DNA string ('-' for pad/gap sentinel)."""
    arr = np.atleast_1d(np.asarray(list(codes) if not hasattr(codes, "ndim") else codes))
    return "".join(ALPHABET_INV.get(int(v), "-") for v in arr)
