"""Shared plane-update math for the wavefront sweep.

Every plane-sweep engine (the XLA references, the batched sweep, the
traceback engines) performs the same per-plane update: for each of the 7 DP
matrices, a max over the 7 source matrices at one shifted position of an
earlier plane, plus a substitution bonus.  This module holds the
backend-agnostic pieces:

* :func:`transition_groups` -- folds the 7x7 weight matrix into per-target
  groups of sources sharing a weight, cutting the op count from
  49 adds + 42 maxes (the reference PE's datapath, src/PE_1cyc.v:163-218 and
  its MAX7 trees at :139-145) to ~31 adds/maxes-in-group + ~21 combine ops,
  exploiting that each target has at most 3 distinct gap charges.

* :func:`target_update` -- applies one target's grouped max-plus update to a
  stacked (7, ...) predecessor array.  Works on NumPy and jax.numpy alike.

Plane coordinate convention (all backends): plane q is a (|B|+1, |C|+1)
array over (j, k); position (j, k) holds cell (i = q-j-k, j, k).  The
predecessor of matrix t lives in plane q - sum(offset(t)) at position
(j - dj, k - dk).  This is the same skew the PE array realizes with its
diagonal delay registers (reference: src/PE_1cyc.v:80-109).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from trialign.config import NUM_MATRICES, OFFSETS, PAD_SYMBOL

# Largest runtime substitution matrix the sweep kernels take: the CUDA
# sweep keeps it as a table in shared memory, the batched sweep as
# 2*nsym+1 select-chain planes.  Bigger alphabets route to the 'xla' and
# 'golden' backends.
SUBMATRIX_NSYM_CAP = 8

# For target t: which earlier plane (1, 2 or 3 steps back) and which (dj, dk)
# shift its predecessor stack needs.  plane_delta = di + dj + dk.
PLANE_DELTA: Tuple[int, ...] = tuple(sum(o) for o in OFFSETS)
SHIFTS: Tuple[Tuple[int, int], ...] = tuple((o[1], o[2]) for o in OFFSETS)

def transition_groups(
    w: np.ndarray,
) -> List[List[Tuple[int, Tuple[int, ...]]]]:
    """Group each target's sources by shared transition weight.

    Returns groups[t] = [(weight, (source indices...)), ...] sorted by
    weight descending so the cheapest (most likely maximal) group comes
    first.
    """
    groups: List[List[Tuple[int, Tuple[int, ...]]]] = []
    for t in range(NUM_MATRICES):
        by_weight = {}
        for s in range(NUM_MATRICES):
            by_weight.setdefault(int(w[t, s]), []).append(s)
        groups.append(
            [(wt, tuple(srcs)) for wt, srcs in sorted(by_weight.items(), reverse=True)]
        )
    return groups


def target_update(pred_stack, groups_t, maximum):
    """Grouped max-plus update for one target.

    ``pred_stack`` is a (7, ...) array of the target's shifted predecessors;
    ``groups_t`` the target's weight groups; ``maximum`` the elementwise max
    (np.maximum or jnp.maximum).  Returns max_s(pred_stack[s] + W[t, s]).
    """
    acc = None
    for weight, idxs in groups_t:
        g = pred_stack[idxs[0]]
        for s in idxs[1:]:
            g = maximum(g, pred_stack[s])
        term = g if weight == 0 else g + weight
        acc = term if acc is None else maximum(acc, term)
    return acc


def target_update_raw(pred_stack, groups_t, maximum):
    """Like :func:`target_update` but also returns the per-group raw maxes
    (pre-weight), whose overall max is the 7-way plane max -- every target's
    groups partition all 7 sources."""
    acc = None
    raws = []
    for weight, idxs in groups_t:
        g = pred_stack[idxs[0]]
        for s in idxs[1:]:
            g = maximum(g, pred_stack[s])
        raws.append(g)
        term = g if weight == 0 else g + weight
        acc = term if acc is None else maximum(acc, term)
    return acc, raws


def fused_plane_update_m7(p1, p2, m7p3, subs, groups, maximum, roll):
    """All-target update with the M-matrix's predecessor plane carried as a
    single 7-way max.

    M's transition weights are identically zero (it consumes every axis, so
    no gap charge; config.Scoring.weight_matrix row 0), hence
    M(q) = shift(max7(plane q-3)) + S3.  Carrying max7 instead of the seven
    raw generation-3 planes cuts the loop carry from 21 planes to 16 and
    M's combine from 6 maxes to 0; the running max7 of the youngest
    generation comes nearly free as the per-group raw maxes of any
    generation-1 target already partition all 7 sources.

    Returns (new_planes, m7_of_p1).
    """
    planes = (None, p1, p2)
    new = []
    m7p1 = None
    for t in range(NUM_MATRICES):
        if PLANE_DELTA[t] == 3:
            cand = m7p3
        elif PLANE_DELTA[t] == 1 and m7p1 is None:
            cand, raws = target_update_raw(planes[1], groups[t], maximum)
            m7p1 = raws[0]
            for g in raws[1:]:
                m7p1 = maximum(m7p1, g)
        else:
            cand = target_update(planes[PLANE_DELTA[t]], groups[t], maximum)
        dj, dk = SHIFTS[t]
        if dj:
            cand = roll(cand, 0)
        if dk:
            cand = roll(cand, 1)
        s = subs[t]
        if not (isinstance(s, int) and s == 0):
            cand = cand + s
        new.append(cand)
    return new, m7p1


def submatrix_tables(bp, cp, submatrix, dtype, where):
    """Gather-free substitution-plane tables for a runtime score matrix.

    The testbench's planned 4x4 score-matrix ports (reference:
    src/TriAlign_tb.sv:220-224,280-290) as short select chains over the
    (static) B/C symbol planes, built ONCE per sweep instead of a gather
    per plane step:

    * ``sb[v][j,k] = S(v, B_j)`` and ``sc[v][j,k] = S(v, C_k)`` -- one
      plane per A-symbol value, each an nsym-term constant-select chain;
    * ``s_bc[j,k] = S(B_j, C_k)`` -- an nsym-term select over the sb/sc
      stacks.

    Any symbol outside [0, nsym) -- sequence pads, border sentinels --
    falls through every select to ``floor`` = min(matrix minimum, -1),
    matching Scoring.sub_lookup()'s clamped-pad semantics exactly.

    Returns (sb, sc, s_bc, floor).  ``where`` is np.where or jnp.where;
    ``dtype`` the plane scalar type.
    """
    nsym = len(submatrix)
    floor = dtype(min(min(min(r) for r in submatrix), -1))
    sb, sc = [], []
    for v in range(nsym):
        accb = None
        accc = None
        for u in range(nsym):
            cu = dtype(submatrix[v][u])
            accb = where(bp == u, cu, floor if accb is None else accb)
            accc = where(cp == u, cu, floor if accc is None else accc)
        sb.append(accb)
        sc.append(accc)
    s_bc = None
    for v in range(nsym):
        s_bc = where(bp == v, sc[v], floor if s_bc is None else s_bc)
    return sb, sc, s_bc, floor


def submatrix_pair_score(x, y, submatrix, where, dtype=np.int32):
    """Gather-free S(x, y) for two arbitrary symbol arrays: an nsym^2
    constant-select chain.  Out-of-alphabet codes (pads, negative border
    sentinels) fall through to the clamped floor, matching
    Scoring.sub_lookup().  For hot kernels prefer submatrix_tables +
    submatrix_pair (static tables, nsym selects per step); this direct
    form suits the traceback engines' per-step triple of moving planes."""
    nsym = len(submatrix)
    floor = dtype(min(min(min(r) for r in submatrix), -1))
    acc = None
    for u in range(nsym):
        rowv = None
        for v in range(nsym):
            cv = dtype(submatrix[u][v])
            rowv = where(y == v, cv, floor if rowv is None else rowv)
        acc = where(x == u, rowv, floor if acc is None else acc)
    return acc


def submatrix_pair(ap, stack, floor, where):
    """Per-step pairwise score plane S(A_i, X) for the moving symbol plane
    ``ap`` against a per-symbol table ``stack`` from submatrix_tables:
    an nsym-select chain (nsym compares + selects per plane step)."""
    acc = where(ap == 0, stack[0], floor)
    for v in range(1, len(stack)):
        acc = where(ap == v, stack[v], acc)
    return acc


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def bucket_dims(la: int, lb: int, lc: int) -> Tuple[int, int, int]:
    """Padded (lab, hb, wc) buckets of the batched small-problem sweep:
    |A| to multiples of 64, the (|B|+1) plane rows to a short ladder and
    the (|C|+1) columns to multiples of 128, so a mixed batch shares few
    compiles.  Problems past |B|, |C| <= 255 or |A| <= 4096 go to the
    sliced sweep instead."""
    hb = _round_up(max(lb + 1, 16), 16)
    for cand in (16, 32, 64, 96, 128, 192, 256):
        if hb <= cand:
            hb = cand
            break
    wc = _round_up(max(lc + 1, 128), 128)
    lab = _round_up(max(la, 64), 64)
    if hb > 256 or wc > 256 or lab > 4096:
        raise ValueError(
            f"the batched sweep takes |B|,|C| <= 255 and |A| <= 4096; got "
            f"{la}/{lb}/{lc}. Use the sliced sweep."
        )
    return lab, hb, wc


def prepare_compact(a, b, c, lab, hb, wc):
    """Host arrays of one padded problem: lengths, A with a leading pad
    slot, and B/C with a sentinel at index 0."""
    la, lb, lc = len(a), len(b), len(c)
    a_ext = np.full(lab + 2, PAD_SYMBOL, dtype=np.int32)
    a_ext[1 : la + 1] = np.asarray(a, dtype=np.int32)
    b_full = np.full(hb, PAD_SYMBOL - 1, dtype=np.int32)
    b_full[1 : lb + 1] = np.asarray(b, dtype=np.int32)
    c_full = np.full(wc, PAD_SYMBOL - 2, dtype=np.int32)
    c_full[1 : lc + 1] = np.asarray(c, dtype=np.int32)
    lens = np.array([la, lb, lc], dtype=np.int32)
    return lens, a_ext, b_full, c_full


def shear_rows(w, rows, pad_value):
    """T[k, r] = w[k, k + r] over a (ncols, M) row-major array.

    The pad-flatten-reshape shear: element (k, r) of the reshape is
    flat[k*(M+1) + r] = w[k, k + r] whenever k + r < M, which callers
    guarantee by sizing M >= ncols + rows - 1 (they use M = rows + ncols).
    The trailing ncols pad elements only make the reshape size-legal;
    no consumed index ever reaches them.
    """
    import jax.numpy as jnp

    ncols, M = w.shape
    flat = jnp.concatenate(
        [w.reshape(-1), jnp.full((ncols,), pad_value, w.dtype)]
    )
    return flat.reshape(ncols, M + 1)[:, :rows]


def build_askew(a_ext, qq, rows, cols, pad_value: int = PAD_SYMBOL):
    """Skewed symbol array ASKREV[r, k] = A[qq - r - k] without a gather.

    A Hankel matrix of the reversed symbol vector, built by shearing a
    (cols, rows + cols) staging array (shear_rows) and transposing, so
    the materialized intermediate stays cols x (rows + cols).  Row
    qq - q of it, sliced to the plane's rows, is plane q's A symbol at
    (j, k)."""
    import jax.numpy as jnp

    L = qq + 1
    pad = jnp.full((max(0, L - a_ext.shape[0]),), pad_value, a_ext.dtype)
    ae = jnp.concatenate([a_ext, pad])[:L]
    v = jnp.flip(ae, 0)  # v[m] = A[qq - m]
    M = rows + cols
    vp = jnp.concatenate(
        [v, jnp.full((max(0, M - L),), pad_value, v.dtype)]
    )[:M]
    # T[k, r] = vp[k + r] -> transpose is H[r, k] = vp[r + k].
    return shear_rows(jnp.broadcast_to(vp, (cols, M)), rows, pad_value).T
