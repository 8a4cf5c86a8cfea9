"""Multi-card single-triplet alignment: k-stripes with halo exchange.

One long triplet's (j, k) grid is split into k-stripes across the 'model'
axis of the mesh: device d owns columns (d*W, (d+1)*W].  Block rows of hb
rows pipeline across the devices as a second-level wavefront: at step t
device d sweeps block row jb = t - d of its stripe with one call of the
sliced sweep's contract (kernels/sweep.py), takes its top face from its
own previous block row, and its left face from device d-1's previous step
via lax.ppermute -- the distributed form of the reference's boundary-face
SRAMs (reference: src/TriAlign_1cyc.v:127-140).  D devices finish n_jb
block rows in n_jb + D - 1 steps.  The cards of one host are joined all
to all, so the mesh follows the algorithm only.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from trialign.config import NUM_MATRICES, Scoring
from trialign.kernels.sweep import TJ, face_shapes, prep_sequences, sweep


def scaling_efficiency(n_jb: int, ndev: int) -> float:
    """Pipeline efficiency of n_jb block rows on ``ndev`` stripes: the
    second-level wavefront takes n_jb + ndev - 1 steps for n_jb rows."""
    return n_jb / (n_jb + ndev - 1)


def choose_halo_rows(lb: int, ndev: int) -> int:
    """Block-row height: whole sweep tiles, and at least 4 block rows per
    stripe so the pipeline ramp stays under 1/4 of the steps."""
    rows = -(-lb // (4 * ndev))
    return max(TJ, -(-rows // TJ) * TJ)


def halo_efficiency(la: int, lb: int, lc: int, ndev: int,
                    rows: Optional[int] = None) -> dict:
    """Geometry model of a halo-sharded run: pipeline ramp, and the share
    of real cells in the padded block rows (j_fill) and stripes (k_fill).
    'total' is the fraction of ndev cards' work the partition can use."""
    hb = rows or choose_halo_rows(lb, ndev)
    n_jb = -(-lb // hb)
    w = -(-lc // ndev)
    pipe = scaling_efficiency(n_jb, ndev)
    j_fill = lb / (n_jb * hb)
    k_fill = lc / (ndev * w)
    return {"pipeline": pipe, "j_fill": j_fill, "k_fill": k_fill,
            "rows": hb, "total": pipe * j_fill * k_fill}


def as_global(mesh, *arrays):
    """Inputs replicated on every device of ``mesh``.  Across processes
    (multi-host) each process passes identical host values -- the usual
    SPMD contract -- and the arrays are assembled with
    make_array_from_callback."""
    sharding = NamedSharding(mesh, P())
    if jax.process_count() == 1:
        return tuple(jax.device_put(np.asarray(x), sharding) for x in arrays)
    return tuple(
        jax.make_array_from_callback(np.shape(x), sharding,
                                     lambda idx, x=np.asarray(x): x[idx])
        for x in arrays
    )


@functools.partial(
    jax.jit,
    static_argnames=("hb", "w", "n_jb", "ndev", "target", "scoring", "mesh"),
)
def _halo_core(a_ext, b_pad, c_pad, hb, w, n_jb, ndev, target, scoring, mesh):
    jbstar, dstar, fj, fk = target
    la = a_ext.shape[0] - 1
    row_shape, col_shape = face_shapes(la, hb, w)
    dims = np.array([la, hb, w, fj, fk], np.int32)
    perm = [(i, i + 1) for i in range(ndev - 1)]

    def device_fn(a_ext, b_pad, c_pad):
        d = jax.lax.axis_index("model")
        c_loc = jax.lax.dynamic_slice(c_pad, (d * w,), (w,))
        zero_col = jnp.zeros(col_shape, jnp.int32)

        def step(carry, t):
            row, col_in, res = carry
            jb = t - d
            valid = (jb >= 0) & (jb < n_jb)

            def run(args):
                row, col_in = args
                b_loc = jax.lax.dynamic_slice(
                    b_pad, (jnp.maximum(jb, 0) * hb,), (hb,))
                return sweep(a_ext, b_loc, c_loc, row, col_in, scoring,
                             dims=dims)

            def idle(args):
                return (args[0], zero_col,
                        jnp.zeros((NUM_MATRICES,), jnp.int32))

            row, col_out, final = jax.lax.cond(valid, run, idle, (row, col_in))
            res = jnp.where(valid & (jb == jbstar) & (d == dstar), final, res)
            # Device 0's left face is the zero border: ppermute sends it
            # zeros.
            col_next = jax.lax.ppermute(col_out, "model", perm)
            return (row, col_next, res), None

        carry0 = (jnp.zeros(row_shape, jnp.int32), zero_col,
                  jnp.zeros((NUM_MATRICES,), jnp.int32))
        (_, _, res), _ = jax.lax.scan(
            step, carry0, jnp.arange(n_jb + ndev - 1, dtype=jnp.int32))
        return jax.lax.psum(res, "model")

    fn = jax.shard_map(
        device_fn, mesh=mesh, in_specs=(P(), P(), P()), out_specs=P(),
        check_vma=False,
    )
    return fn(a_ext, b_pad, c_pad)


def align_sharded_triplet(
    a,
    b,
    c,
    scoring: Scoring = Scoring(),
    mesh: Optional[Mesh] = None,
    rows: Optional[int] = None,
    return_alignment: bool = False,
) -> int:
    """Optimal score of one long triplet partitioned across the mesh's
    'model' axis, block rows of ``rows`` rows (chosen by
    choose_halo_rows when None) pipelined with halo exchange of the
    stripes' column faces."""
    if return_alignment:
        raise NotImplementedError(
            "sharded traceback is not implemented on the GPU; align one "
            "triplet with trialign.align(..., return_alignment=True), and "
            "see ROADMAP.md for the sharded traceback item"
        )
    a, b, c = np.asarray(a), np.asarray(b), np.asarray(c)
    la, lb, lc = len(a), len(b), len(c)
    if min(la, lb, lc) == 0:
        return 0
    if mesh is None:
        from trialign.dist.mesh import make_mesh

        mesh = make_mesh(data=1, model=len(jax.devices()))
    ndev = mesh.shape["model"]
    hb = rows or choose_halo_rows(lb, ndev)
    n_jb = -(-lb // hb)
    w = -(-lc // ndev)
    jbstar, dstar = (lb - 1) // hb, (lc - 1) // w
    target = (jbstar, dstar, lb - jbstar * hb, lc - dstar * w)

    # Padding rows and columns sit past the final cell: no real cell reads
    # them.
    a_ext, b_pad, c_pad = prep_sequences(a, b, c, (la, n_jb * hb, ndev * w))
    res = _halo_core(*as_global(mesh, a_ext, b_pad, c_pad), hb, w, n_jb,
                     ndev, target, scoring, mesh)
    return int(jax.device_get(res).max())
