"""Plain XLA backend: the anti-diagonal plane sweep as a ``lax.scan`` over
whole (|B|+1, |C|+1) planes.

This is the portable compiled path -- it runs on CPU and GPU unchanged and
serves as (a) the plain version the CUDA sweep is measured and checked
against, and (b) the backend for alphabets past the sweep's cap.  It is the
software shape of what the PE array does in hardware: one plane of the DP
cuboid per step, predecessors carried in three ring planes
(reference: pic/3DDP.png; control FSM src/TriAlign_1cyc.v:276-347).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from trialign.config import NUM_MATRICES, PAD_SYMBOL, Scoring
from trialign.kernels.plane_math import (
    PLANE_DELTA,
    SHIFTS,
    target_update,
    transition_groups,
)


def _shift(x, dj, dk):
    """out[..., j, k] = x[..., j-dj, k-dk]; wrapped garbage lands only in
    row 0 / col 0, which the border mask overwrites."""
    if dj:
        x = jnp.roll(x, dj, axis=-2)
    if dk:
        x = jnp.roll(x, dk, axis=-1)
    return x


@functools.partial(
    jax.jit, static_argnames=("la", "lb", "lc", "scoring", "score_bits")
)
def _sweep(a_ext, b_col, c_row, la, lb, lc, scoring: Scoring, score_bits: int = 0):
    """Run the full plane sweep; returns the (7,) final-cell score vector.

    a_ext is A padded to length la+1 with a leading dummy so a_ext[i] is the
    i-th (1-based) symbol; b_col is (|B|+1, 1), c_row (1, |C|+1) with
    sentinel at index 0.
    """
    hb, wc = lb + 1, lc + 1
    w = scoring.weight_matrix()
    groups = transition_groups(w)
    match = jnp.int32(scoring.match)
    mismatch = jnp.int32(scoring.mismatch)

    j_grid = jnp.arange(hb, dtype=jnp.int32)[:, None]
    k_grid = jnp.arange(wc, dtype=jnp.int32)[None, :]
    jk = j_grid + k_grid

    if scoring.submatrix is not None:
        # Runtime substitution matrix (the testbench's planned-never-wired
        # 4x4 score ports, src/TriAlign_tb.sv:220-224,280-290): a (256,256)
        # lookup covering pad codes with the clamped matrix minimum.
        lut = jnp.asarray(scoring.sub_lookup())

        def pair(x, y):
            xb = jnp.broadcast_to(x, jnp.broadcast_shapes(jnp.shape(x), jnp.shape(y)))
            yb = jnp.broadcast_to(y, xb.shape)
            return lut[xb & 0xFF, yb & 0xFF]
    else:
        def pair(x, y):
            return jnp.where(x == y, match, mismatch)

    s_bc = pair(jnp.broadcast_to(b_col, (hb, wc)), jnp.broadcast_to(c_row, (hb, wc)))

    def step(carry, q):
        p1, p2, p3 = carry
        i_grid = q - jk
        ai = a_ext[jnp.clip(i_grid, 0, la)]
        s_ab = pair(ai, b_col)
        s_ac = pair(ai, c_row)
        if scoring.s3_mode == "sop":
            s3 = s_ab + s_ac + s_bc
        else:
            s3 = jnp.where(
                ai == b_col,
                jnp.where(b_col == c_row, 3 * match, (match + mismatch) * 2),
                3 * mismatch,
            )
        subs = (s3, 0, 0, 0, s_ab, s_bc, s_ac)

        planes = (None, p1, p2, p3)
        new = []
        for t in range(NUM_MATRICES):
            dj, dk = SHIFTS[t]
            pred = _shift(planes[PLANE_DELTA[t]], dj, dk)
            new.append(target_update(pred, groups[t], jnp.maximum) + subs[t])
        new = jnp.stack(new)
        if score_bits:
            # RTL bit-parity mode: every stored value wraps to a signed
            # score_bits-wide register, exactly the hardware's unsaturated
            # SCORE_BITS registers (reference: src/TriAlign_1cyc.v:6;
            # PARITY.md quirk 3).  Arithmetic stays int32 between stores,
            # matching the golden model's emulation bit for bit.
            m = jnp.int32(1 << score_bits)
            half = jnp.int32(1 << (score_bits - 1))
            new = jnp.mod(new + half, m) - half

        valid = (i_grid >= 1) & (i_grid <= la) & (j_grid >= 1) & (k_grid >= 1)
        new = jnp.where(valid[None], new, 0)
        return (new, p1, p2), None

    p0 = jnp.zeros((NUM_MATRICES, hb, wc), dtype=jnp.int32)
    qmax = la + lb + lc
    (p1, _, _), _ = jax.lax.scan(
        step, (p0, p0, p0), jnp.arange(1, qmax + 1, dtype=jnp.int32)
    )
    return p1[:, lb, lc]


def align_xla(
    a, b, c, scoring: Scoring = Scoring(), score_bits: int = 0
) -> int:
    """Optimal 3-sequence alignment score via the XLA plane sweep.

    ``score_bits`` nonzero enables the RTL bit-parity mode: stored values
    wrap as signed score_bits-wide registers, reproducing the hardware's
    SCORE_BITS=12 overflow behavior on a compiled backend."""
    a = np.asarray(a)
    b = np.asarray(b)
    c = np.asarray(c)
    la, lb, lc = len(a), len(b), len(c)
    if min(la, lb, lc) == 0:
        return 0  # zero borders: a border face holds the final cell
    a_ext = np.full(la + 1, PAD_SYMBOL, dtype=np.int32)
    a_ext[1:] = a
    b_col = np.full((lb + 1, 1), PAD_SYMBOL - 1, dtype=np.int32)
    b_col[1:, 0] = b
    c_row = np.full((1, lc + 1), PAD_SYMBOL - 2, dtype=np.int32)
    c_row[0, 1:] = c
    final = _sweep(
        jnp.asarray(a_ext), jnp.asarray(b_col), jnp.asarray(c_row), la, lb, lc,
        scoring, score_bits
    )
    return int(jax.device_get(final).max())
