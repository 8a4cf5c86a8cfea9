"""The sliced score sweep: one contract, two implementations.

A call sweeps the rectangle j in (J0, J0+H], k in (K0, K0+W] of the DP
over every i in [0, la].  It takes the faces on the rectangle's low sides
and returns the faces on its high sides and the 7 values of one cell at
i = la (by default the rectangle's far corner):

    in_row  (la+1, 7, W+1)  D(i, t, J0,   K0+k), k in [0, W]
    in_col  (la+1, 7, H+1)  D(i, t, J0+j, K0),   j in [0, H]
    out_row (la+1, 7, W+1)  D(i, t, J0+H, K0+k)
    out_col (la+1, 7, H+1)  D(i, t, J0+j, K0+W)

Index 0 of a face is its corner cell, so in_row[:, :, 0] == in_col[:, :, 0],
and row i = 0 of every face is zero (the i = 0 border).  Faces of the
global borders (J0 = 0 or K0 = 0) are zeros.  This is the
reference ASIC's slicing method with its boundary-face SRAMs
(reference: pic/Memory.png, src/TriAlign_1cyc.v:127-140) as arrays.

* ``sweep_cuda``: the Hopper kernel (trialign/cuda/sweep.cu) through
  ``jax.ffi``, used on the GPU.
* ``sweep_reference``: a ``lax.scan`` over anti-diagonal planes with the
  faces installed as halos, used on the CPU and in every CPU test.

A single-card score (``align_sweep``) is one call over the grid, or a few
row stripes when one call's scratch would not fit; the multi-card halo
mode (dist/halo.py) and checkpoint/resume (checkpoint.py) make one call
per block row.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from trialign.config import NUM_MATRICES, PAD_SYMBOL, Scoring
from trialign.kernels.plane_math import (
    PLANE_DELTA,
    SHIFTS,
    SUBMATRIX_NSYM_CAP,
    target_update,
    transition_groups,
)

# Tile of the CUDA kernel (TJ, TK in sweep.cu): one thread per (j, k).
TJ = 16
TK = 32

# Share of the device memory budget one call's faces and scratch may use.
STRIPE_MEMORY_SHARE = 0.25


def face_shapes(la: int, h: int, w: int):
    """(row face, column face) shapes of an h x w rectangle."""
    return (la + 1, NUM_MATRICES, w + 1), (la + 1, NUM_MATRICES, h + 1)


def scratch_ints(la: int, h: int, w: int) -> int:
    """int32 scratch of one CUDA call: the inner tile faces, one progress
    word per tile and a ticket counter."""
    n_jt, n_kt = -(-h // TJ), -(-w // TK)
    faces = ((n_jt - 1) * (w + 1) + (n_kt - 1) * (h + 1)) * (la + 1)
    return faces * NUM_MATRICES + n_jt * n_kt + 1


def call_bytes(la: int, h: int, w: int) -> int:
    """Device bytes one call holds: its four faces and its scratch."""
    faces = 2 * (la + 1) * NUM_MATRICES * (h + w + 2)
    return 4 * (faces + scratch_ints(la, h, w))


def plan_stripes(la: int, lb: int, lc: int, budget: int) -> Tuple[int, ...]:
    """Row-stripe heights covering lb with every call inside ``budget``
    bytes: as few stripes as fit, of equal height in whole tiles (the last
    one takes the remainder)."""
    n = 1
    while True:
        h = -(-lb // n)
        if n > 1:
            h = -(-h // TJ) * TJ
        if call_bytes(la, h, lc) <= budget or h <= TJ:
            break
        n += 1
    heights = []
    left = lb
    while left > 0:
        heights.append(min(h, left))
        left -= heights[-1]
    return tuple(heights)


def _check_scoring(scoring: Scoring) -> None:
    if scoring.submatrix is not None and len(scoring.submatrix) > SUBMATRIX_NSYM_CAP:
        raise ValueError(
            f"the sweep takes substitution matrices of up to "
            f"{SUBMATRIX_NSYM_CAP} symbols; use the 'golden' or 'xla' backend"
        )


def _ffi_attrs(scoring: Scoring, score_bits: int) -> dict:
    sub = np.zeros(SUBMATRIX_NSYM_CAP ** 2, np.int32)
    nsym, floor = 0, 0
    if scoring.submatrix is not None:
        m = np.asarray(scoring.submatrix, np.int32)
        nsym = m.shape[0]
        sub[: nsym * nsym] = m.reshape(-1)
        floor = min(int(m.min()), -1)
    return dict(
        weights=np.ascontiguousarray(scoring.weight_matrix().reshape(-1), np.int32),
        sub=sub,
        nsym=np.int32(nsym),
        sub_floor=np.int32(floor),
        match=np.int32(scoring.match),
        mismatch=np.int32(scoring.mismatch),
        rtl=np.int32(scoring.s3_mode == "rtl"),
        score_bits=np.int32(score_bits),
    )


def _runtime_dims(dims, la, h, w):
    """int32 (la, H, W, fj, fk): ``dims`` as given, else the whole
    rectangle with its far corner as the final cell."""
    if dims is None:
        dims = np.array([la, h, w, h, w], np.int32)
    return jnp.asarray(dims, jnp.int32)


def sweep_cuda(a_ext, b_seg, c_seg, in_row, in_col, scoring: Scoring,
               score_bits: int = 0, dims=None):
    """The contract on the Hopper kernel; returns (out_row, out_col, final)."""
    from trialign.cuda import TARGET, ensure_registered

    _check_scoring(scoring)
    ensure_registered()
    la, h, w = a_ext.shape[0] - 1, b_seg.shape[0], c_seg.shape[0]
    row_shape, col_shape = face_shapes(la, h, w)
    out_types = (
        jax.ShapeDtypeStruct(row_shape, jnp.int32),
        jax.ShapeDtypeStruct(col_shape, jnp.int32),
        jax.ShapeDtypeStruct((NUM_MATRICES,), jnp.int32),
        jax.ShapeDtypeStruct((scratch_ints(la, h, w),), jnp.int32),
    )
    out_row, out_col, final, _ = jax.ffi.ffi_call(TARGET, out_types)(
        _runtime_dims(dims, la, h, w), a_ext, b_seg, c_seg,
        in_row, in_col, **_ffi_attrs(scoring, score_bits),
    )
    return out_row, out_col, final


def _pair_fn(scoring: Scoring):
    if scoring.submatrix is not None:
        lut = jnp.asarray(scoring.sub_lookup())
        return lambda x, y: lut[x & 0xFF, y & 0xFF]
    match, mismatch = jnp.int32(scoring.match), jnp.int32(scoring.mismatch)
    return lambda x, y: jnp.where(x == y, match, mismatch)


def sweep_reference(a_ext, b_seg, c_seg, in_row, in_col, scoring: Scoring,
                    score_bits: int = 0, dims=None):
    """The contract in plain JAX; returns (out_row, out_col, final).

    Plane q holds cell (i = q - j - k, j, k) of the rectangle at local
    (j, k) in [0, H] x [0, W]; row 0 and column 0 are the input faces
    installed as halos, so one ``lax.scan`` over q sweeps the rectangle."""
    _check_scoring(scoring)
    a_ext, b_seg, c_seg, in_row, in_col = (
        jnp.asarray(x) for x in (a_ext, b_seg, c_seg, in_row, in_col)
    )
    lac, hc, wc = a_ext.shape[0] - 1, b_seg.shape[0], c_seg.shape[0]
    la, h, w, fj, fk = _runtime_dims(dims, lac, hc, wc)
    groups = transition_groups(scoring.weight_matrix())
    pair = _pair_fn(scoring)

    jl = jnp.arange(hc + 1, dtype=jnp.int32)[:, None]
    kl = jnp.arange(wc + 1, dtype=jnp.int32)[None, :]
    jk = jl + kl
    interior = (jl >= 1) & (kl >= 1)
    b_col = jnp.concatenate([jnp.full((1,), PAD_SYMBOL - 1, jnp.int32),
                             b_seg.astype(jnp.int32)])[:, None]
    c_row = jnp.concatenate([jnp.full((1,), PAD_SYMBOL - 2, jnp.int32),
                             c_seg.astype(jnp.int32)])[None, :]
    s_bc = pair(b_col, c_row)
    kk = jnp.arange(wc + 1, dtype=jnp.int32)
    jj = jnp.arange(hc + 1, dtype=jnp.int32)

    def halo(face, idx, q):
        ii = q - idx
        vals = face[jnp.clip(ii, 0, lac), :, idx]  # (n, 7)
        return jnp.where(((ii >= 0) & (ii <= la))[:, None], vals, 0).T

    def shift(x, dj, dk):
        # Wrapped values land in row 0 / column 0, which the halos overwrite.
        if dj:
            x = jnp.roll(x, dj, axis=-2)
        if dk:
            x = jnp.roll(x, dk, axis=-1)
        return x

    def step(carry, q):
        p1, p2, p3, final = carry
        i = q - jk
        ai = a_ext[jnp.clip(i, 0, lac)].astype(jnp.int32)
        s_ab = pair(ai, b_col)
        s_ac = pair(ai, c_row)
        if scoring.s3_mode == "sop":
            s3 = s_ab + s_ac + s_bc
        else:
            m, x = scoring.match, scoring.mismatch
            s3 = jnp.where(ai == b_col,
                           jnp.where(b_col == c_row, 3 * m, (m + x) * 2),
                           3 * x)
        subs = (s3, 0, 0, 0, s_ab, s_bc, s_ac)
        planes = (None, p1, p2, p3)
        new = jnp.stack([
            target_update(shift(planes[PLANE_DELTA[t]], *SHIFTS[t]),
                          groups[t], jnp.maximum) + subs[t]
            for t in range(NUM_MATRICES)
        ])
        if score_bits:
            # RTL bit-parity mode: stored values wrap as signed
            # score_bits-wide registers (src/TriAlign_1cyc.v:6).
            half = jnp.int32(1 << (score_bits - 1))
            new = jnp.mod(new + half, jnp.int32(1 << score_bits)) - half
        new = jnp.where((interior & (i >= 1))[None], new, 0)
        new = new.at[:, :, 0].set(halo(in_col, jj, q))
        new = new.at[:, 0, :].set(halo(in_row, kk, q))
        cell = jax.lax.dynamic_slice(new, (0, fj, fk), (NUM_MATRICES, 1, 1))
        final = jnp.where(q == la + fj + fk, cell[:, 0, 0], final)
        row = jax.lax.dynamic_index_in_dim(new, h, axis=1, keepdims=False)
        col = jax.lax.dynamic_index_in_dim(new, w, axis=2, keepdims=False)
        return (new, p1, p2, final), (row, col)

    z = jnp.zeros((NUM_MATRICES, hc + 1, wc + 1), jnp.int32)
    carry0 = (z, z, z, jnp.zeros((NUM_MATRICES,), jnp.int32))
    nq = lac + hc + wc + 1
    (_, _, _, final), (ys_row, ys_col) = jax.lax.scan(
        step, carry0, jnp.arange(nq, dtype=jnp.int32)
    )
    ii = jnp.arange(lac + 1, dtype=jnp.int32)[:, None]
    out_row = ys_row[jnp.clip(ii + h + kk[None, :], 0, nq - 1), :,
                     kk[None, :]].transpose(0, 2, 1)
    out_col = ys_col[jnp.clip(ii + w + jj[None, :], 0, nq - 1), :,
                     jj[None, :]].transpose(0, 2, 1)
    return out_row, out_col, final


def sweep(a_ext, b_seg, c_seg, in_row, in_col, scoring: Scoring,
          score_bits: int = 0, dims=None, engine: Optional[str] = None):
    """The contract on the engine trialign.engine chose for this device.

    ``dims`` = int32 (la, H, W, fj, fk), which may be traced: the
    rectangle swept (within the arrays' shapes) and the final cell; by
    default the whole rectangle and its far corner."""
    if engine is None:
        from trialign.engine import score_engine

        engine = score_engine()
    fn = sweep_cuda if engine == "cuda" else sweep_reference
    return fn(a_ext, b_seg, c_seg, in_row, in_col, scoring, score_bits, dims)


def prep_sequences(a, b, c, extents=None):
    """int32 device inputs: A with a leading unused slot, B and C; padded
    with pad symbols to ``extents`` = (la, lb, lc) when given."""
    la, lb, lc = extents or (len(a), len(b), len(c))
    a_ext = np.full(la + 1, PAD_SYMBOL, np.int32)
    a_ext[1 : len(a) + 1] = np.asarray(a)
    b_arr = np.full(lb, PAD_SYMBOL - 1, np.int32)
    b_arr[: len(b)] = np.asarray(b)
    c_arr = np.full(lc, PAD_SYMBOL - 2, np.int32)
    c_arr[: len(c)] = np.asarray(c)
    return a_ext, b_arr, c_arr


def extent(n: int) -> int:
    """Static buffer extent serving runtime length n: powers of two up to
    512, multiples of 256 beyond, so a mixed batch compiles a few calls
    and a large problem's faces grow by at most a quarter."""
    if n <= 512:
        return max(32, 1 << (n - 1).bit_length())
    return -(-n // 256) * 256


@functools.partial(
    jax.jit, static_argnames=("stripes", "scoring", "score_bits", "engine")
)
def _score_stripes(a_ext, b, c, lens, stripes, scoring, score_bits, engine):
    """Score of the runtime problem ``lens`` = (la, lb, lc) held in padded
    arrays, swept in row stripes of the static heights ``stripes``."""
    la_c, lc_c = a_ext.shape[0] - 1, c.shape[0]
    la, lb, lc = lens[0], lens[1], lens[2]
    row = jnp.zeros(face_shapes(la_c, 0, lc_c)[0], jnp.int32)
    j0 = 0
    for h in stripes:
        rows = jnp.minimum(h, lb - j0)
        dims = jnp.stack([la, rows, lc, rows, lc])
        col = jnp.zeros(face_shapes(la_c, h, lc_c)[1], jnp.int32)
        row, _, final = sweep(a_ext, b[j0 : j0 + h], c, row, col, scoring,
                              score_bits, dims=dims, engine=engine)
        j0 += h
    return final.max()


def stripe_budget() -> int:
    from trialign.engine import device_memory_budget

    return int(STRIPE_MEMORY_SHARE * device_memory_budget())


def align_sweep_async(a, b, c, scoring: Scoring = Scoring(),
                      score_bits: int = 0, device=None):
    """Optimal score as a 0-d device array, without waiting for it; runs
    on ``device`` when one is given.

    The arrays are padded to static extents (``extent``) and the lengths
    passed at run time, so problems of nearby sizes share one compiled
    call.  A problem whose call would not fit the memory budget is swept
    in row stripes."""
    from trialign.engine import score_engine

    _check_scoring(scoring)
    a, b, c = np.asarray(a), np.asarray(b), np.asarray(c)
    la, lb, lc = len(a), len(b), len(c)
    if min(la, lb, lc) == 0:
        return jnp.int32(0)  # the final cell sits on a zero border face
    engine = score_engine()
    shape = tuple(extent(n) for n in (la, lb, lc))
    stripes = plan_stripes(*shape, stripe_budget())
    # Only the stripes that hold rows of the runtime problem.
    stripes = stripes[: -(-lb // stripes[0])]
    args = prep_sequences(a, b, c, shape) + (np.array([la, lb, lc], np.int32),)
    if device is not None:
        args = jax.device_put(args, device)
    return _score_stripes(*args, stripes, scoring, score_bits, engine)


def align_sweep(a, b, c, scoring: Scoring = Scoring(),
                score_bits: int = 0) -> int:
    """Optimal 3-sequence alignment score via the sliced sweep.

    ``score_bits`` nonzero selects RTL bit-parity mode: stored scores
    wrap as signed score_bits-wide registers (src/TriAlign_1cyc.v:6)."""
    return int(jax.device_get(align_sweep_async(a, b, c, scoring, score_bits)))
