"""Compiled (XLA) twins of the traceback sweeps.

The Hirschberg recursion's cost is dominated by its top-level forward and
backward slab sweeps; the NumPy engine (trialign/traceback/engine.py) is the
readable spec but runs at CPU speed.  These jitted twins run the identical
math on the accelerator with runtime lengths inside padded buckets, so the
divide-and-conquer's arbitrary split sizes reuse a small set of compiled
programs.

Semantics mirror engine.forward_sweep / engine.backward_slab exactly
(modes "free" / "free_jk" / "pin", NEG walls, per-state capture slabs);
tests assert elementwise equality between the two engines.

Design notes (none of these is measured on the H100 yet):
* symbol planes come from a sheared (Hankel) array via dynamic_slice
  instead of a per-step (hb, wc) gather;
* the forward combine is combine-then-shift with the max7 carry (exact:
  every shifted-in cell is re-masked because each target's consume set
  covers its shift axes in every mode);
* sweeps run as fixed-size scan segments chained through device-resident
  carries, which bounds the runtime of one execution.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import numpy as np

from trialign.config import CONSUMES, NUM_MATRICES, OFFSETS, Scoring
from trialign.kernels.plane_math import (
    fused_plane_update_m7,
    target_update,
    transition_groups,
)
from trialign.traceback.engine import NEG

# Bucket ladder for padded shapes (one compile per rung; <=14% padding).
_LADDER = (64, 128, 192, 256, 320, 384, 448, 512, 640, 768, 896, 1024, 1152,
           1280, 1536, 1792, 2048, 2304, 2560, 3072, 3584, 4096, 4224, 4608,
           5120, 6144, 7168, 8192)

# Steps per scan segment (bounds single-execution runtime).
SEG_STEPS = 2048


def _bucket(x: int) -> int:
    for v in _LADDER:
        if x <= v:
            return v
    return ((x + 1023) // 1024) * 1024


def _pad_seq(s: np.ndarray, size: int, fill: int) -> np.ndarray:
    out = np.full(size, fill, dtype=np.int32)
    out[: len(s)] = s
    return out


def _subs_jnp(scoring: Scoring, ai, bj, ck):
    import jax.numpy as jnp

    if scoring.submatrix is not None:
        from trialign.kernels.plane_math import submatrix_pair_score

        s_ab = submatrix_pair_score(ai, bj, scoring.submatrix, jnp.where)
        s_ac = submatrix_pair_score(ai, ck, scoring.submatrix, jnp.where)
        s_bc = submatrix_pair_score(bj, ck, scoring.submatrix, jnp.where)
        return (s_ab + s_ac + s_bc, 0, 0, 0, s_ab, s_bc, s_ac)
    m, x = np.int32(scoring.match), np.int32(scoring.mismatch)
    s_ab = jnp.where(ai == bj, m, x)
    s_ac = jnp.where(ai == ck, m, x)
    s_bc = jnp.where(bj == ck, m, x)
    if scoring.s3_mode == "sop":
        s3 = s_ab + s_ac + s_bc
    else:
        s3 = jnp.where(
            ai == bj,
            jnp.where(bj == ck, np.int32(3 * scoring.match),
                      np.int32((scoring.match + scoring.mismatch) * 2)),
            np.int32(3 * scoring.mismatch),
        )
    return (s3, 0, 0, 0, s_ab, s_bc, s_ac)


def _shift_fill_jnp(x, dj, dk, fill):
    import jax.numpy as jnp

    if not dj and not dk:
        return x
    pad = [(0, 0)] * x.ndim
    if dj:
        pad[-2] = (dj, 0)
    if dk:
        pad[-1] = (dk, 0)
    y = jnp.pad(x, pad, constant_values=fill)
    sl = [slice(None)] * x.ndim
    if dj:
        sl[-2] = slice(0, x.shape[-2])
    if dk:
        sl[-1] = slice(0, x.shape[-1])
    return y[tuple(sl)]


# ----------------------------------------------------------------------
# Forward sweep (segmented)
# ----------------------------------------------------------------------
@functools.partial(jax.jit, static_argnames=("hb", "wc", "mode"))
def _forward_init(mcap, v0, hb, wc, mode):
    """Initial scan carry: (p1 tuple, p2 tuple, m7p2, m7p3, slab, final)."""
    import jax.numpy as jnp

    free = mode == "free"
    free_jk = mode == "free_jk"
    fill = np.int32(0 if free else NEG)
    j = np.arange(hb, dtype=np.int32)[:, None]
    k = np.arange(wc, dtype=np.int32)[None, :]
    p0 = jnp.full((NUM_MATRICES, hb, wc), fill, jnp.int32)
    if free_jk:
        p0 = jnp.where(jnp.asarray((j == 0) | (k == 0))[None], 0, p0)
    # Ring planes q=-1/-2 carry NO origin: only plane 0 does (mirrors the
    # NumPy engine's ring initialization).
    pring = p0
    if mode == "pin":
        p0 = jnp.where(
            jnp.asarray((j == 0) & (k == 0))[None], v0[:, None, None], p0
        )
    slab0 = jnp.full((NUM_MATRICES, hb, wc), NEG, jnp.int32)
    # capture_m == 0 cases (callers only use 0 < m < la, but stay faithful):
    slab0 = jnp.where(jnp.equal(mcap, 0), p0, slab0)
    final0 = jnp.zeros((NUM_MATRICES,), jnp.int32)
    p0t = tuple(p0[t] for t in range(NUM_MATRICES))
    pringt = tuple(pring[t] for t in range(NUM_MATRICES))
    m7_0 = pring[0]
    for t in range(1, NUM_MATRICES):
        m7_0 = jnp.maximum(m7_0, pring[t])
    return (p0t, pringt, m7_0, m7_0, slab0, final0)


@functools.partial(
    jax.jit, static_argnames=("hb", "wc", "qq", "scoring", "mode", "seg")
)
def _forward_seg(lens, mcap, a_pad, b_pad, c_pad, carry_in, hb, wc, qq, scoring, mode, seg):
    """One SEG_STEPS-long slice of the forward sweep; lens = (la, lb, lc, q0).

    Steps beyond qmax are harmless: no cell has a valid i there, so the mode
    masks wall every position and the captured slab/final are untouched."""
    import jax.numpy as jnp

    from trialign.kernels.plane_math import build_askew

    la, lb, lc, q0 = lens[0], lens[1], lens[2], lens[3]
    w = scoring.weight_matrix().astype(np.int32)
    groups = transition_groups(w)
    free = mode == "free"
    free_jk = mode == "free_jk"
    fill = np.int32(0 if free else NEG)

    j_grid = jnp.arange(hb, dtype=jnp.int32)[:, None] * jnp.ones((1, wc), jnp.int32)
    k_grid = jnp.ones((hb, 1), jnp.int32) * jnp.arange(wc, dtype=jnp.int32)[None, :]
    jk = j_grid + k_grid

    bj = jnp.broadcast_to(b_pad[:hb, None], (hb, wc))
    ck = jnp.broadcast_to(c_pad[None, :wc], (hb, wc))

    # Symbol planes as row-windows of a sheared (Hankel) array: a per-step
    # dynamic_slice instead of an (hb, wc) gather.  a_pad is 0-based
    # (ai = a_pad[i-1]); askew wants 1-based with the invalid sentinel
    # outside [1, la], which the -9 padding provides.
    a1 = jnp.concatenate([jnp.full((1,), -9, jnp.int32), a_pad])
    askew = build_askew(a1, qq, qq + hb + 1, wc, pad_value=-9)

    def shift1(x, axis):
        # shift-by-one with `fill`; shifted-in cells are always re-masked
        # below (every target's consume set covers its shift axes), so
        # combine-then-shift is exact.
        return _shift_fill_jnp(x, 1 if axis == 0 else 0, 1 if axis == 1 else 0, fill)

    def step(carry, q):
        p1, p2, m7p2, m7p3, slab, final = carry
        i_grid = q - jk
        ap = jax.lax.dynamic_slice(askew, (qq - q, 0), (hb, wc))
        ai = jnp.where((i_grid >= 1) & (i_grid <= la), ap, -9)
        subs = _subs_jnp(scoring, ai, bj, ck)

        cands, m7p1 = fused_plane_update_m7(
            p1, p2, m7p3, subs, groups, jnp.maximum, shift1
        )
        new = jnp.stack([jnp.maximum(c_, NEG) for c_ in cands])

        if free:
            valid = (i_grid >= 1) & (i_grid <= la) & (j_grid >= 1) & (k_grid >= 1)
            new = jnp.where(valid[None], new, 0)
        elif free_jk:
            irange = (i_grid >= 1) & (i_grid <= la)
            new = jnp.where(irange[None], new, NEG)
            border = (j_grid == 0) | (k_grid == 0)
            new = jnp.where(border[None], 0, new)
        else:
            inside = (i_grid >= 0) & (i_grid <= la)
            rows = []
            for t in range(NUM_MATRICES):
                ca, cb, cc = CONSUMES[t]
                ok = inside & (i_grid >= ca) & (j_grid >= cb) & (k_grid >= cc)
                rows.append(jnp.where(ok, new[t], NEG))
            new = jnp.stack(rows)

        slab = jnp.where((i_grid == mcap)[None], new, slab)
        final = jnp.where(q == la + lb + lc, new[:, lb, lc], final)
        newt = tuple(new[t] for t in range(NUM_MATRICES))
        return (newt, p1, m7p1, m7p2, slab, final), None

    carry, _ = jax.lax.scan(
        step, carry_in, q0 + jnp.arange(1, seg + 1, dtype=jnp.int32)
    )
    return carry


def forward_sweep_xla_async(
    a,
    b,
    c,
    scoring: Scoring = Scoring(),
    mode: str = "free",
    v0: Optional[np.ndarray] = None,
    capture_m: Optional[int] = None,
):
    """Dispatch a compiled forward sweep WITHOUT syncing.

    Returns a zero-arg fetch function producing (final (7,), slab or None).
    Dispatching several sweeps before fetching any overlaps the per-call
    round-trip latency (the Hirschberg recursion issues 2-3 per node)."""
    import jax.numpy as jnp

    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    c = np.asarray(c, dtype=np.int32)
    la, lb, lc = len(a), len(b), len(c)
    hb, wc = _bucket(lb + 1), _bucket(lc + 1)
    lap = _bucket(max(la, 1))
    qq = lap + hb + wc

    a_pad = np.full(lap + 2, -9, dtype=np.int32)
    a_pad[:la] = a  # 0-based: ai = a_pad[i-1], mirroring engine.forward_sweep
    b_pad = jnp.asarray(_pad_seq(np.concatenate([[-7], b]), hb, -7))
    c_pad = jnp.asarray(_pad_seq(np.concatenate([[-8], c]), wc, -8))
    a_pad = jnp.asarray(a_pad)
    v0j = jnp.asarray(
        v0.astype(np.int32) if v0 is not None else np.zeros(NUM_MATRICES, np.int32)
    )
    mcap = jnp.int32(capture_m if capture_m is not None else -1)

    carry = _forward_init(mcap, v0j, hb, wc, mode)
    for q0 in range(0, qq, SEG_STEPS):
        lens = jnp.asarray(np.array([la, lb, lc, q0], np.int32))
        carry = _forward_seg(
            lens, mcap, a_pad, b_pad, c_pad, carry, hb, wc, qq, scoring,
            mode, SEG_STEPS,
        )
    slab, final = carry[4], carry[5]

    def fetch():
        f = np.asarray(jax.device_get(final))
        if capture_m is None:
            return f, None
        s = np.asarray(jax.device_get(slab))[:, : lb + 1, : lc + 1]
        return f, s

    return fetch


def forward_sweep_xla(
    a, b, c,
    scoring: Scoring = Scoring(),
    mode: str = "free",
    v0: Optional[np.ndarray] = None,
    capture_m: Optional[int] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Compiled forward sweep; same contract as engine.forward_sweep minus
    the cuboid option.  Returns (final (7,), slab or None)."""
    return forward_sweep_xla_async(a, b, c, scoring, mode, v0, capture_m)()


# ----------------------------------------------------------------------
# Backward sweep (segmented)
# ----------------------------------------------------------------------
@functools.partial(jax.jit, static_argnames=("hb", "wc"))
def _backward_init(end_v, la, hb, wc):
    import jax.numpy as jnp

    j = np.arange(hb, dtype=np.int32)[:, None]
    k = np.arange(wc, dtype=np.int32)[None, :]
    pring = jnp.full((NUM_MATRICES, hb, wc), NEG, jnp.int32)
    p0 = jnp.where(
        jnp.asarray((j == 0) & (k == 0))[None], end_v[:, None, None], pring
    )
    slab0 = jnp.where(jnp.equal(la, 0), p0, pring)
    p0t = tuple(p0[t] for t in range(NUM_MATRICES))
    pringt = tuple(pring[t] for t in range(NUM_MATRICES))
    return (p0t, pringt, pringt, slab0)


@functools.partial(jax.jit, static_argnames=("hb", "wc", "qq", "scoring", "seg"))
def _backward_seg(lens, a_pad, b_pad, c_pad, carry_in, hb, wc, qq, scoring, seg):
    import jax.numpy as jnp

    from trialign.kernels.plane_math import build_askew

    la, lb, lc, q0 = lens[0], lens[1], lens[2], lens[3]
    w = scoring.weight_matrix().astype(np.int32)
    groups_t = transition_groups(np.ascontiguousarray(w.T))

    j_grid = jnp.arange(hb, dtype=jnp.int32)[:, None] * jnp.ones((1, wc), jnp.int32)
    k_grid = jnp.ones((hb, 1), jnp.int32) * jnp.arange(wc, dtype=jnp.int32)[None, :]
    jk = j_grid + k_grid

    bj = jnp.broadcast_to(b_pad[:hb, None], (hb, wc))
    ck = jnp.broadcast_to(c_pad[None, :wc], (hb, wc))

    a1 = jnp.concatenate([jnp.full((1,), -9, jnp.int32), a_pad])
    askew = build_askew(a1, qq, qq + hb + 1, wc, pad_value=-9)

    def step(carry, q):
        p1, p2, p3, slab = carry
        i_grid = q - jk
        ap = jax.lax.dynamic_slice(askew, (qq - q, 0), (hb, wc))
        ai = jnp.where((i_grid >= 1) & (i_grid <= la), ap, -9)
        subs = _subs_jnp(scoring, ai, bj, ck)

        planes_by_delta = (None, p1, p2, p3)
        # E_u: best suffix that next enters state u, seen from this
        # (reversed) cell: u-shifted previous plane's u row + u's
        # substitution (evaluated here, in reversed coordinates).
        e = []
        for u in range(NUM_MATRICES):
            du = OFFSETS[u]
            src = planes_by_delta[du[0] + du[1] + du[2]][u]
            e.append(_shift_fill_jnp(src, du[1], du[2], NEG) + subs[u])
        e = jnp.stack(e)

        new = []
        for t in range(NUM_MATRICES):
            # max over next-state u of E_u + W[u, t]: grouped by the
            # transposed weight column.
            new.append(
                jnp.maximum(target_update(e, groups_t[t], jnp.maximum), NEG)
            )
        new = jnp.stack(new)
        inside = (i_grid >= 0) & (i_grid <= la)
        new = jnp.where(inside[None], new, NEG)

        slab = jnp.where((i_grid == la)[None], new, slab)
        newt = tuple(new[t] for t in range(NUM_MATRICES))
        return (newt, p1, p2, slab), None

    carry, _ = jax.lax.scan(
        step, carry_in, q0 + jnp.arange(1, seg + 1, dtype=jnp.int32)
    )
    return carry


def backward_slab_xla_async(
    a_suffix,
    b,
    c,
    scoring: Scoring = Scoring(),
    end_v: Optional[np.ndarray] = None,
):
    """Dispatch-without-sync twin of engine.backward_slab; returns a
    zero-arg fetch function."""
    import jax.numpy as jnp

    ra = np.asarray(a_suffix, dtype=np.int32)[::-1]
    rb = np.asarray(b, dtype=np.int32)[::-1]
    rc = np.asarray(c, dtype=np.int32)[::-1]
    la, lb, lc = len(ra), len(rb), len(rc)
    hb, wc = _bucket(lb + 1), _bucket(lc + 1)
    lap = _bucket(max(la, 1))
    qq = lap + hb + wc

    a_pad = np.full(lap + 2, -9, dtype=np.int32)
    a_pad[:la] = ra  # 0-based: ai = a_pad[i-1]
    b_pad = jnp.asarray(_pad_seq(np.concatenate([[-7], rb]), hb, -7))
    c_pad = jnp.asarray(_pad_seq(np.concatenate([[-8], rc]), wc, -8))
    a_pad = jnp.asarray(a_pad)
    ev = jnp.asarray(
        end_v.astype(np.int32) if end_v is not None else np.zeros(NUM_MATRICES, np.int32)
    )

    carry = _backward_init(ev, jnp.int32(la), hb, wc)
    for q0 in range(0, qq, SEG_STEPS):
        lens = jnp.asarray(np.array([la, lb, lc, q0], np.int32))
        carry = _backward_seg(
            lens, a_pad, b_pad, c_pad, carry, hb, wc, qq, scoring, SEG_STEPS
        )
    slab_dev = carry[3]

    def fetch():
        s = np.asarray(jax.device_get(slab_dev))[:, : lb + 1, : lc + 1]
        return s[:, ::-1, ::-1].copy()

    return fetch


def backward_slab_xla(
    a_suffix, b, c,
    scoring: Scoring = Scoring(),
    end_v: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Compiled twin of engine.backward_slab."""
    return backward_slab_xla_async(a_suffix, b, c, scoring, end_v)()
