"""Direct device-resident traceback: one choice-capture sweep + one walk.

The Hirschberg recursion (traceback/hirschberg.py) is latency-bound: a
512^3 alignment spawns ~255 subproblems, each costing a host<->device
round trip.  This engine removes the recursion below a size cap:

* a compiled plane sweep records, per cell and per matrix, WHICH source
  matrix achieved the max -- 7 matrices x 3 bits = 21 bits packed into a
  uint16 + uint8 pair (3 B/cell) -- into (qq, hb, wc) device buffers
  (plane q at (j, k) holds cell (i = q-j-k, j, k), so no reshaping is
  ever needed).  ~2x the cost of a score sweep; the buffers stay on
  the device (~1.5 GB at 512^3, ~10 GB at 1k^3 by direct_memory_bytes);
* an on-device while_loop pointer chase over the packed buffer emits the
  action sequence (consuming-matrix index per alignment column) in one
  dispatch.

512^3 full alignment = 2 dispatches + two tiny transfers instead of ~255
recursion nodes.  Bigger problems keep the Hirschberg recursion on top but
bottom out here (hirschberg.DIRECT_CELLS) instead of in NumPy cuboids.

Restores at full speed the capability the reference stubbed out (its
per-PE traceback `act` outputs and action memory are commented out,
reference: src/PE_1cyc.v:12-14,30; dat/Pattern1.dat is the action trace of
its never-committed software model).
"""

from __future__ import annotations

import functools
import threading
from typing import List, Optional, Tuple

import jax
import numpy as np

from trialign.config import CONSUMES, NUM_MATRICES, OFFSETS, Scoring
from trialign.kernels.plane_math import PLANE_DELTA, SHIFTS
from trialign.traceback.engine import NEG

# The packed-choice buffer is qq*hb*wc*3 B (~3 * cells * 3 B: the q axis
# triple-counts (j, k) planes).  Byte-accurate gating lives HERE
# (direct_memory_bytes against engine.device_memory_budget), so callers
# can route to the Hirschberg split PROACTIVELY instead of catching an
# out-of-memory error after a long compile; MEM_BUDGET keeps concurrent
# Hirschberg halves from overcommitting the device.

# Shape ladder (finer than the slab engine's near 512: 520/528 keep the
# 512^3 buffer ~24% smaller than a 640 rung; 1040/1152 do the same for
# the 1k class, 34% under the old 1280 rung).
_LADDER = (16, 32, 64, 96, 128, 192, 256, 320, 384, 448, 512, 520, 576,
           640, 768, 896, 1024, 1040, 1152, 1280, 1536, 2048, 3072, 4096)

SEG_STEPS = 2048  # bound the runtime of one execution


def _bucket(x: int) -> int:
    for v in _LADDER:
        if x <= v:
            return v
    return ((x + 1023) // 1024) * 1024


def direct_shapes(la: int, lb: int, lc: int) -> Tuple[int, int, int]:
    """(qq, hb, wc) the engine would use for this problem."""
    hb, wc = _bucket(lb + 1), _bucket(lc + 1)
    lap = _bucket(max(la, 1))
    return lap + hb + wc, hb, wc


def direct_memory_bytes(la: int, lb: int, lc: int) -> int:
    """TOTAL device-memory footprint model for one direct_traceback call.

    Counts everything material the sweep holds live at its peak: the
    packed-choice buffers (3 B per plane-slot), the scan-carry planes
    (3 ring planes + the freshly produced one, 7 matrices of int32),
    per-step temporaries (the 7x(7,hb,wc) shifted-predecessor/terms
    working set -- XLA fuses most but we budget them), the skewed
    symbol array, and fixed headroom for executable + donation slack.
    Must stay an OVERestimate: a gate that undercounts (choice buffer
    only) lets a program larger than the device through."""
    qq, hb, wc = direct_shapes(la, lb, lc)
    plane = hb * wc
    packed = qq * plane * 3                    # uint16 + uint8 buffers
    carry = 4 * NUM_MATRICES * plane * 4       # p1/p2/p3 + new (int32)
    temps = 3 * NUM_MATRICES * plane * 4       # shifted preds/terms/subs
    askew = 2 * (qq + hb + wc + 2) * wc * 4    # Hankel build + staging
    return packed + carry + temps + askew + (192 << 20)


class _MemBudget:
    """Byte-reservation gate serializing concurrent large direct calls.

    The Hirschberg recursion solves its two halves on worker threads; two
    large direct calls (~10 GB of packed choices each at the 1k class) may
    not fit together.  Reservations block until
    enough budget frees; a request larger than the whole budget is only
    admitted when it runs alone (the proactive byte gate in
    hirschberg._solve should have rerouted it already -- this keeps the
    failure an OOM, not a deadlock)."""

    def __init__(self):
        self._cv = threading.Condition()
        self._limit: Optional[int] = None
        self._used = 0

    def acquire(self, nbytes: int) -> None:
        with self._cv:
            if self._limit is None:
                from trialign.engine import device_memory_budget

                self._limit = device_memory_budget()
            while self._used > 0 and self._used + nbytes > self._limit:
                self._cv.wait()
            self._used += nbytes

    def release(self, nbytes: int) -> None:
        with self._cv:
            self._used -= nbytes
            self._cv.notify_all()


MEM_BUDGET = _MemBudget()


@functools.partial(
    jax.jit,
    static_argnames=("hb", "wc", "qq", "scoring", "mode", "seg"),
    donate_argnums=(5, 6, 7),
)
def _choices_seg(lens, a_pad, b_pad, c_pad, v0, carry, packed_lo, packed_hi,
                 hb, wc, qq, scoring, mode, seg):
    """One <=SEG_STEPS slice of the choice-capture sweep.

    lens = (la, lb, lc, q0); carry = (p1, p2, p3, final); the packed
    choice buffer is SPLIT for memory headroom -- 3 bits x 7 matrices =
    21 bits per cell stored as uint16 (matrices 0-4, bits 0-14) +
    uint8 (matrices 5-6, bits 15-20 shifted down), 3 B/cell instead of
    4 (a 1k^3 buffer is ~10 GB instead of ~13.4).
    Both full buffers are donated and RIDE THE SCAN CARRY, each step
    updating its one plane in place via dynamic_update_slice (XLA's
    in-place while-loop DUS).  They must NOT be scan ys: stacking a
    segment's planes before splicing them in materializes a
    seg*hb*wc*3 B temporary (~6.6 GB at 1k^3) ON TOP of the ~10 GB
    buffers.  The buffers are kept 2-D (qq, hb*wc), NOT (qq, hb, wc):
    on 3-D u8 carries XLA can pick different layouts for the while-loop
    body and the parameter and insert whole-buffer relayout copies at
    loop entry/exit; 2-D rows have one canonical layout end to end.  Packing stays
    int32 compute, 16/8-bit storage only."""
    import jax.numpy as jnp

    from trialign.kernels.plane_math import build_askew

    la, lb, lc, q0 = lens[0], lens[1], lens[2], lens[3]
    w = scoring.weight_matrix().astype(np.int32)
    wj = jnp.asarray(w)
    free = mode == "free"
    free_jk = mode == "free_jk"
    fill = np.int32(0 if free else NEG)
    m, x = np.int32(scoring.match), np.int32(scoring.mismatch)

    j_grid = jnp.arange(hb, dtype=jnp.int32)[:, None] * jnp.ones((1, wc), jnp.int32)
    k_grid = jnp.ones((hb, 1), jnp.int32) * jnp.arange(wc, dtype=jnp.int32)[None, :]
    jk = j_grid + k_grid
    bj = jnp.broadcast_to(b_pad[:hb, None], (hb, wc))
    ck = jnp.broadcast_to(c_pad[None, :wc], (hb, wc))
    cellmask = (j_grid == lb) & (k_grid == lc)

    a1 = jnp.concatenate([jnp.full((1,), -9, jnp.int32), a_pad])
    askew = build_askew(a1, qq, qq + hb + 1, wc, pad_value=-9)

    def shift(v, dj, dk):
        if not dj and not dk:
            return v
        pad = [(0, 0)] * v.ndim
        if dj:
            pad[-2] = (dj, 0)
        if dk:
            pad[-1] = (dk, 0)
        y = jnp.pad(v, pad, constant_values=fill)
        sl = [slice(None)] * v.ndim
        if dj:
            sl[-2] = slice(0, v.shape[-2])
        if dk:
            sl[-1] = slice(0, v.shape[-1])
        return y[tuple(sl)]

    def step(carry, q):
        p1, p2, p3, final, packed_lo, packed_hi = carry
        i_grid = q - jk
        ap = jax.lax.dynamic_slice(askew, (qq - q, 0), (hb, wc))
        ai = jnp.where((i_grid >= 1) & (i_grid <= la), ap, -9)
        if scoring.submatrix is not None:
            from trialign.kernels.plane_math import submatrix_pair_score

            s_ab = submatrix_pair_score(ai, bj, scoring.submatrix, jnp.where)
            s_ac = submatrix_pair_score(ai, ck, scoring.submatrix, jnp.where)
            s_bc = submatrix_pair_score(bj, ck, scoring.submatrix, jnp.where)
        else:
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
        subs = (s3, 0, 0, 0, s_ab, s_bc, s_ac)
        planes = (None, p1, p2, p3)

        packed_q = jnp.zeros((hb, wc), jnp.uint32)
        new = []
        for t in range(NUM_MATRICES):
            dj, dk = SHIFTS[t]
            pred = shift(planes[PLANE_DELTA[t]], dj, dk)  # (7, hb, wc)
            terms = pred + wj[t][:, None, None]
            cand = jnp.max(terms, axis=0)
            choice = jnp.argmax(terms, axis=0).astype(jnp.uint32)
            packed_q = packed_q | (choice << np.uint32(3 * t))
            new.append(jnp.maximum(cand + subs[t], NEG))
        new = jnp.stack(new)

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

        final = jnp.where(
            q == la + lb + lc,
            jnp.sum(jnp.where(cellmask[None], new, 0), axis=(1, 2)),
            final,
        )
        packed_lo = jax.lax.dynamic_update_slice(
            packed_lo,
            packed_q.astype(jnp.uint16).reshape(1, hb * wc),
            (q - 1, 0),
        )
        packed_hi = jax.lax.dynamic_update_slice(
            packed_hi,
            (packed_q >> jnp.uint32(15)).astype(jnp.uint8).reshape(1, hb * wc),
            (q - 1, 0),
        )
        return (new, p1, p2, final, packed_lo, packed_hi), None

    (*carry, packed_lo, packed_hi), _ = jax.lax.scan(
        step,
        (*carry, packed_lo, packed_hi),
        q0 + jnp.arange(1, seg + 1, dtype=jnp.int32),
    )
    return tuple(carry), packed_lo, packed_hi


@functools.partial(jax.jit, static_argnames=("hb", "wc", "mode"))
def _init_carry(v0, hb, wc, mode):
    import jax.numpy as jnp

    free = mode == "free"
    free_jk = mode == "free_jk"
    fill = np.int32(0 if free else NEG)
    j = np.arange(hb, dtype=np.int32)[:, None]
    k = np.arange(wc, dtype=np.int32)[None, :]
    p0 = jnp.full((NUM_MATRICES, hb, wc), fill, jnp.int32)
    if free_jk:
        p0 = jnp.where(jnp.asarray((j == 0) | (k == 0))[None], 0, p0)
    pring = p0
    if mode == "pin":
        p0 = jnp.where(
            jnp.asarray((j == 0) & (k == 0))[None], v0[:, None, None], p0
        )
    final0 = jnp.full((NUM_MATRICES,), NEG, jnp.int32)
    return (p0, pring, pring, final0)


@functools.partial(jax.jit, static_argnames=("qq", "hb", "wc", "mode"))
def _walk_device(packed_lo, packed_hi, t0, lens, qq, hb, wc, mode):
    """On-device pointer chase.  Returns (actions (qq,), count, stop (3,)):
    actions newest-first (matrix indices), count emitted, and the (i, j, k)
    the walk stopped at."""
    import jax.numpy as jnp

    la, lb, lc = lens[0], lens[1], lens[2]
    offs = jnp.asarray(np.array(OFFSETS, np.int32))
    freeish = mode != "pin"

    def cond(state):
        i, j, k, t, n, acts = state
        if freeish:
            return (i > 0) & (j > 0) & (k > 0)
        return (i > 0) | (j > 0) | (k > 0)

    def body(state):
        i, j, k, t, n, acts = state
        q = i + j + k
        lo = jax.lax.dynamic_slice(
            packed_lo, (q - 1, j * wc + k), (1, 1)
        )[0, 0].astype(jnp.uint32)
        hi = jax.lax.dynamic_slice(
            packed_hi, (q - 1, j * wc + k), (1, 1)
        )[0, 0].astype(jnp.uint32)
        tu = t.astype(jnp.uint32)
        word = jnp.where(t < 5, lo, hi)
        shift = jnp.where(t < 5, jnp.uint32(3) * tu,
                          jnp.uint32(3) * tu - jnp.uint32(15))
        s = (word >> shift) & jnp.uint32(7)
        acts = jax.lax.dynamic_update_slice(acts, t[None], (n,))
        di, dj, dk = offs[t, 0], offs[t, 1], offs[t, 2]
        return (i - di, j - dj, k - dk, s.astype(jnp.int32), n + 1, acts)

    acts0 = jnp.full((qq,), -1, jnp.int32)
    i, j, k, t, n, acts = jax.lax.while_loop(
        cond, body, (la, lb, lc, t0, jnp.int32(0), acts0)
    )
    return acts, n, jnp.stack([i, j, k])


def direct_traceback(
    a,
    b,
    c,
    scoring: Scoring = Scoring(),
    mode: str = "free",
    v0: Optional[np.ndarray] = None,
    end_state: Optional[int] = None,
) -> Tuple[int, List[Tuple[int, int, int]]]:
    """(score, columns) via the two-dispatch direct engine.

    Columns (a_code|-1, b_code|-1, c_code|-1) oldest-first; semantics
    identical to hirschberg's cuboid walk, including the free-mode border
    stop and the unscored leading context.  Device memory for the packed
    buffers is reserved via MEM_BUDGET so concurrent Hirschberg halves
    (each ~10 GB at the 1k class) serialize instead of overcommitting."""
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    c = np.asarray(c, dtype=np.int32)
    la, lb, lc = len(a), len(b), len(c)
    nbytes = direct_memory_bytes(la, lb, lc)
    MEM_BUDGET.acquire(nbytes)
    try:
        return _direct_traceback_reserved(
            a, b, c, scoring, mode, v0, end_state
        )
    finally:
        MEM_BUDGET.release(nbytes)


def _direct_traceback_reserved(a, b, c, scoring, mode, v0, end_state):
    import jax.numpy as jnp

    la, lb, lc = len(a), len(b), len(c)
    # direct_shapes is the single source of the engine's shapes: the
    # byte gate (direct_memory_bytes) models exactly what runs here.
    qq, hb, wc = direct_shapes(la, lb, lc)
    lap = qq - hb - wc

    a_pad = np.full(lap + 1, -9, dtype=np.int32)
    a_pad[:la] = a
    b_pad = np.full(hb, -7, dtype=np.int32)
    b_pad[1 : lb + 1] = b
    c_pad = np.full(wc, -8, dtype=np.int32)
    c_pad[1 : lc + 1] = c
    v0j = jnp.asarray(
        v0.astype(np.int32) if v0 is not None else np.zeros(NUM_MATRICES, np.int32)
    )

    carry = _init_carry(v0j, hb, wc, mode)
    packed_lo = jnp.zeros((qq, hb * wc), jnp.uint16)
    packed_hi = jnp.zeros((qq, hb * wc), jnp.uint8)
    apj, bpj, cpj = jnp.asarray(a_pad), jnp.asarray(b_pad), jnp.asarray(c_pad)
    for q0 in range(0, qq, SEG_STEPS):
        seg = min(SEG_STEPS, qq - q0)
        lens = jnp.asarray(np.array([la, lb, lc, q0], np.int32))
        carry, packed_lo, packed_hi = _choices_seg(
            lens, apj, bpj, cpj, v0j, carry, packed_lo, packed_hi, hb, wc,
            qq, scoring, mode, seg,
        )
    final = np.asarray(jax.device_get(carry[3]))
    t0 = int(end_state) if end_state is not None else int(np.argmax(final))
    score = int(final[t0])

    lens3 = jnp.asarray(np.array([la, lb, lc], np.int32))
    acts, n, stop = jax.device_get(
        _walk_device(packed_lo, packed_hi, jnp.int32(t0), lens3, qq, hb, wc,
                     mode)
    )
    n = int(n)
    acts = np.asarray(acts)[:n]
    i, j, k = (int(v) for v in stop)

    # Replay the walk's coordinates to emit columns (newest-first), then
    # the unscored leading context for free modes.
    cols: List[Tuple[int, int, int]] = []
    ii, jj, kk = la, lb, lc
    for t in acts:
        di, dj, dk = OFFSETS[int(t)]
        cols.append(
            (
                int(a[ii - 1]) if di else -1,
                int(b[jj - 1]) if dj else -1,
                int(c[kk - 1]) if dk else -1,
            )
        )
        ii, jj, kk = ii - di, jj - dj, kk - dk
    assert (ii, jj, kk) == (i, j, k)
    if mode != "pin":
        while i > 0 or j > 0 or k > 0:
            cols.append(
                (
                    int(a[i - 1]) if i > 0 else -1,
                    int(b[j - 1]) if j > 0 else -1,
                    int(c[k - 1]) if k > 0 else -1,
                )
            )
            i, j, k = max(i - 1, 0), max(j - 1, 0), max(k - 1, 0)
    cols.reverse()
    return score, cols
