"""Batched, data-parallel alignment of independent triplets.

The reference aligns one triplet at a time (host FSM S_IDLE->S_ABSW->S_FINISH,
reference: src/TriAlign_tb.sv:313-333); throughput workloads (MSA
pre-alignment) need many.  On the GPU each triplet is one asynchronous
dispatch of the sliced sweep, spread over the devices.  On the CPU a batch
of padded triplets becomes one leading array axis of the batched plane
sweep (vmap), and shard_map splits it across the 'data' axis of a device
mesh; triplets too long for its buckets go through the sliced sweep.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from trialign.config import NUM_MATRICES, Scoring
from trialign.kernels.plane_math import (
    PLANE_DELTA,
    SHIFTS,
    SUBMATRIX_NSYM_CAP,
    bucket_dims,
    build_askew,
    prepare_compact,
    submatrix_pair,
    submatrix_tables,
    target_update,
    transition_groups,
)


def prep_padded(
    triplets: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, int, int]:
    """Stack triplets into compact common-bucket arrays for the batched core.

    Only the three small sequence vectors cross host->device; the skewed
    symbol planes are built on the device (_build_planes)."""
    la = max(len(t[0]) for t in triplets)
    lb = max(len(t[1]) for t in triplets)
    lc = max(len(t[2]) for t in triplets)
    lab, hb, wc = bucket_dims(la, lb, lc)
    lens_l, a_l, b_l, c_l = [], [], [], []
    for a, b, c in triplets:
        lens, a_ext, b_full, c_full = prepare_compact(a, b, c, lab, hb, wc)
        lens_l.append(lens)
        a_l.append(a_ext)
        b_l.append(b_full)
        c_l.append(c_full)
    return (
        np.stack(lens_l),
        np.stack(a_l),
        np.stack(b_l),
        np.stack(c_l),
        lab,
        hb,
        wc,
    )


def _build_planes(a_ext, b_full, c_full, lab, hb, wc):
    """Device-side symbol planes of one padded problem: the skewed A array
    (row qq - q is plane q's A symbol) and the B/C planes."""
    qq = lab + hb + wc
    askew = build_askew(a_ext, qq, qq + hb + 8, wc)
    bp = jnp.broadcast_to(b_full[:, None], (hb, wc))
    cp = jnp.broadcast_to(c_full[None, :], (hb, wc))
    return askew, bp, cp


@functools.partial(jax.jit, static_argnames=("lab", "hb", "wc", "scoring"))
def _batched_scores(lens, a_ext, b_full, c_full, lab, hb, wc, scoring):
    """(B, ...) compact inputs -> (B,) int32 optimal scores."""

    def one(l, a_, b_, c_):
        askew, bp, cp = _build_planes(a_, b_, c_, lab, hb, wc)
        return _sweep_padded(l, askew, bp, cp, lab, hb, wc, scoring)

    return jax.vmap(one)(lens, a_ext, b_full, c_full)


def _sweep_padded(lens, askew, bp, cp, lab, hb, wc, scoring: Scoring):
    """The batched small-problem sweep: a lax.scan plane sweep over one
    padded bucket with runtime lengths and mask-reduce extraction."""
    w = scoring.weight_matrix()
    groups = transition_groups(w)
    match = jnp.int32(scoring.match)
    mismatch = jnp.int32(scoring.mismatch)
    la, lb, lc = lens[0], lens[1], lens[2]
    qmax = la + lb + lc
    qq = lab + hb + wc

    j_grid = jnp.arange(hb, dtype=jnp.int32)[:, None] * jnp.ones((1, wc), jnp.int32)
    k_grid = jnp.ones((hb, 1), jnp.int32) * jnp.arange(wc, dtype=jnp.int32)[None, :]
    jk = j_grid + k_grid
    edge = (j_grid >= 1) & (k_grid >= 1)
    if scoring.submatrix is None:
        sub_t = None
        s_bc = jnp.where(bp == cp, match, mismatch)
    else:
        # Select-chain tables (plane_math.submatrix_tables): pads fall
        # through to the floor.
        sub_t = submatrix_tables(bp, cp, scoring.submatrix, jnp.int32,
                                 jnp.where)
        s_bc = sub_t[2]
    cellmask = (j_grid == lb) & (k_grid == lc)

    def shift(x, dj, dk):
        if dj:
            x = jnp.roll(x, dj, axis=-2)
        if dk:
            x = jnp.roll(x, dk, axis=-1)
        return x

    def step(carry, q):
        p1, p2, p3, captured = carry
        ap = jax.lax.dynamic_slice(askew, (qq - q, 0), (hb, wc))
        if sub_t is not None:
            s_ab = submatrix_pair(ap, sub_t[0], sub_t[3], jnp.where)
            s_ac = submatrix_pair(ap, sub_t[1], sub_t[3], jnp.where)
        else:
            s_ab = jnp.where(ap == bp, match, mismatch)
            s_ac = jnp.where(ap == cp, match, mismatch)
        if scoring.s3_mode == "sop":
            s3 = s_ab + s_ac + s_bc
        else:
            s3 = jnp.where(
                ap == bp,
                jnp.where(bp == cp, 3 * match, (match + mismatch) * 2),
                3 * mismatch,
            )
        subs = (s3, 0, 0, 0, s_ab, s_bc, s_ac)
        planes = (None, p1, p2, p3)
        i_grid = q - jk
        valid = (i_grid >= 1) & (i_grid <= la) & edge
        new = []
        for t in range(NUM_MATRICES):
            pred = shift(planes[PLANE_DELTA[t]], *SHIFTS[t])
            cand = target_update(pred, groups[t], jnp.maximum) + subs[t]
            new.append(jnp.where(valid, cand, 0))
        new = jnp.stack(new)
        cellv = jnp.sum(jnp.where(cellmask[None], new, 0), axis=(1, 2))
        captured = jnp.where(q == qmax, cellv, captured)
        return (new, p1, p2, captured), None

    z = jnp.zeros((NUM_MATRICES, hb, wc), jnp.int32)
    (_, _, _, captured), _ = jax.lax.scan(
        step,
        (z[:], z[:], z[:], jnp.zeros((NUM_MATRICES,), jnp.int32)),
        jnp.arange(1, qq + 1, dtype=jnp.int32),
    )
    return jnp.max(captured)


def _fits_bucket(t) -> bool:
    """True when a triplet fits the batched small-problem sweep."""
    return len(t[1]) <= 255 and len(t[2]) <= 255 and len(t[0]) <= 4096


def _batched_padded(triplets, scoring):
    """Device (B,) scores of nonempty bucket-sized triplets, not waited
    for."""
    lens, a_ext, b_full, c_full, lab, hb, wc = prep_padded(triplets)
    return _batched_scores(
        jnp.asarray(lens), jnp.asarray(a_ext), jnp.asarray(b_full),
        jnp.asarray(c_full), lab, hb, wc, scoring,
    )


def align_batch_padded(
    triplets: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    scoring: Scoring = Scoring(),
) -> List[int]:
    """Align a batch of triplets on the local default device.

    Batches containing triplets beyond the batched sweep's buckets
    (|B|,|C| <= 255, |A| <= 4096) go through the bucketed dispatcher.
    Triplets with an empty sequence score 0 (border-face semantics)."""
    if not triplets:
        return []
    if not all(_fits_bucket(t) and min(map(len, t)) > 0 for t in triplets):
        return align_batch_bucketed(triplets, scoring)
    return [int(s) for s in jax.device_get(_batched_padded(triplets, scoring))]


def align_batch_bucketed(
    triplets: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    scoring: Scoring = Scoring(),
    on_scores: Optional[Callable[[int, int], None]] = None,
    devices: Optional[Sequence] = None,
) -> List[int]:
    """Score a mixed-length batch in input order.

    On the GPU every triplet goes through the sliced sweep
    (kernels/sweep.py): on the H100 it beats the batched XLA sweep on
    bucket-sized problems too (PERF.md).  On the CPU, triplets that fit a
    bucket of the batched sweep are scored one dispatch per bucket and the
    rest through the sweep.  Sweep dispatches go round-robin over
    ``devices`` (default: the local devices), and every dispatch is queued
    before the first result is fetched.  ``on_scores(index, score)`` is
    called for each score as its dispatch drains, so a caller can keep
    what finished if a later one fails."""
    from trialign.engine import score_engine
    from trialign.kernels.sweep import align_sweep_async

    if not triplets:
        return []
    batched = score_engine() == "reference" or (
        scoring.submatrix is not None
        and len(scoring.submatrix) > SUBMATRIX_NSYM_CAP)
    out = [0] * len(triplets)
    buckets: dict = {}
    sweep_idx = []
    for i, t in enumerate(triplets):
        if min(map(len, t)) == 0:
            continue  # final cell on a zero-border face: score 0
        if batched and _fits_bucket(t):
            buckets.setdefault(bucket_dims(*map(len, t)), []).append(i)
        else:
            sweep_idx.append(i)
    pending = []  # (indices, device result)
    for idxs in buckets.values():
        pending.append((idxs, _batched_padded([triplets[i] for i in idxs],
                                              scoring)))
    devices = list(devices or jax.local_devices())
    for n, i in enumerate(sweep_idx):
        pending.append(([i], align_sweep_async(
            *triplets[i], scoring, device=devices[n % len(devices)])))
    for idxs, dev in pending:
        scores = np.atleast_1d(jax.device_get(dev))
        for i, s in zip(idxs, scores):
            out[i] = int(s)
            if on_scores is not None:
                on_scores(i, out[i])
    return out


def _split_long(triplets, scoring, score_short):
    """Score the triplets that do not fit a bucket (or have an empty
    sequence) through the bucketed dispatcher and the rest through
    ``score_short``; returns scores in input order."""
    long_idx = [i for i, t in enumerate(triplets)
                if not _fits_bucket(t) or min(map(len, t)) == 0]
    long_set = set(long_idx)
    short_idx = [i for i in range(len(triplets)) if i not in long_set]
    out = [0] * len(triplets)
    if long_idx:
        for i, s in zip(long_idx, align_batch_bucketed(
                [triplets[i] for i in long_idx], scoring)):
            out[i] = s
    if short_idx:
        for i, s in zip(short_idx, score_short(
                [triplets[i] for i in short_idx])):
            out[i] = s
    return out


def _sharded_core(mesh, lab, hb, wc, scoring):
    spec = P("data")
    core = functools.partial(_batched_scores, lab=lab, hb=hb, wc=wc,
                             scoring=scoring)
    return jax.shard_map(
        lambda l, a_, b_, c_: core(l, a_, b_, c_),
        mesh=mesh,
        in_specs=(spec, spec, spec, spec),
        out_specs=spec,
        check_vma=False,
    )


def _pad_to(triplets, n):
    padded = list(triplets)
    while len(padded) % n:
        padded.append(padded[0])  # harmless duplicates, sliced off later
    return padded


def align_batch_multihost(
    triplets: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    scoring: Scoring = Scoring(),
    mesh: Optional[Mesh] = None,
) -> List[int]:
    """Multi-host (DCN) batch alignment over the global device mesh.

    Every participating process must call this with the SAME triplets (the
    usual SPMD contract).  Inputs become global arrays sharded over the
    'data' axis via make_array_from_callback, the batched core runs under
    shard_map exactly as in :func:`align_batch_sharded`, and the scores are
    allgathered back to every process.  Long triplets are scored on every
    process through the local bucketed dispatcher.  Requires
    jax.distributed to be initialized (trialign.dist.mesh.init_distributed);
    single-process it is align_batch_sharded.

    This is the DCN half of the distributed backend the reference never
    had (its host link, RIFFA PCIe, was never committed --
    reference: .gitignore:4; SURVEY.md section 2)."""
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding

    if not triplets:
        return []
    if mesh is None:
        from trialign.dist.mesh import multihost_mesh

        mesh = multihost_mesh()
    if jax.process_count() == 1:
        return align_batch_sharded(triplets, scoring, mesh)

    def short(trips):
        n = len(trips)
        lens, a_ext, b_full, c_full, lab, hb, wc = prep_padded(
            _pad_to(trips, mesh.shape["data"]))
        sh = NamedSharding(mesh, P("data"))

        def to_global(x):
            return jax.make_array_from_callback(x.shape, sh, lambda idx: x[idx])

        scores = _sharded_core(mesh, lab, hb, wc, scoring)(
            *(to_global(x) for x in (lens, a_ext, b_full, c_full)))
        gathered = multihost_utils.process_allgather(scores, tiled=True)
        return [int(s) for s in np.asarray(gathered)[:n]]

    return _split_long(triplets, scoring, short)


def align_batch_sharded(
    triplets: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    scoring: Scoring = Scoring(),
    mesh: Optional[Mesh] = None,
) -> List[int]:
    """Align a batch data-parallel across the 'data' axis of a mesh --
    N reference accelerators side by side.

    On the GPU the triplets go one by one through the sliced sweep, spread
    round-robin over the mesh's devices.  On the CPU the bucket-sized part
    of the batch is padded to a multiple of the data-axis size, sharded
    along its batch dimension and scored by the batched sweep per device;
    longer triplets go through the bucketed dispatcher."""
    from trialign.engine import score_engine

    if not triplets:
        return []
    if mesh is None:
        from trialign.dist.mesh import default_mesh

        mesh = default_mesh()
    if score_engine() == "cuda":
        return align_batch_bucketed(triplets, scoring,
                                    devices=list(mesh.devices.flat))

    def short(trips):
        n = len(trips)
        lens, a_ext, b_full, c_full, lab, hb, wc = prep_padded(
            _pad_to(trips, mesh.shape["data"]))
        sh = jax.sharding.NamedSharding(mesh, P("data"))
        args = [jax.device_put(x, sh) for x in (lens, a_ext, b_full, c_full)]
        scores = _sharded_core(mesh, lab, hb, wc, scoring)(*args)
        return [int(s) for s in jax.device_get(scores)[:n]]

    return _split_long(triplets, scoring, short)
