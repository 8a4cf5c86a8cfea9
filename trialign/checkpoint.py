"""Checkpoint / resume for long sliced-sweep alignments.

The reference has no recovery story (SURVEY.md section 5), but its boundary
faces in the y/z SRAMs are a complete intermediate state between blocks
(reference: src/TriAlign_1cyc.v:127-140).  The sliced sweep inherits that
property: the grid is swept in block rows of ``rows`` rows, one call of the
sweep contract (kernels/sweep.py) each, and the bottom face of the last
finished block row plus the next row index fully determine the remaining
computation.  A long run persists them every few block rows and resumes
after preemption.
"""

from __future__ import annotations

import functools
import hashlib
import os
import tempfile
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from trialign.config import NUM_MATRICES, Scoring
from trialign.kernels.sweep import TJ, face_shapes, prep_sequences, sweep

DEFAULT_ROWS = 8 * TJ


@functools.partial(
    jax.jit, static_argnames=("count", "rows", "fj", "n_rows", "scoring")
)
def _segment(a_ext, b_pad, c, row, res, r0, count, rows, fj, n_rows, scoring):
    """Sweep ``count`` block rows starting at block row r0; returns the
    last bottom face and the final cell's 7 values (set once the last
    block row ran)."""
    la, lc = a_ext.shape[0] - 1, c.shape[0]
    col0 = jnp.zeros(face_shapes(la, rows, lc)[1], jnp.int32)
    dims = np.array([la, rows, lc, fj, lc], np.int32)

    def body(carry, off):
        row, res = carry
        r = r0 + off
        b_loc = jax.lax.dynamic_slice(b_pad, (r * rows,), (rows,))
        row, _, final = sweep(a_ext, b_loc, c, row, col0, scoring, dims=dims)
        res = jnp.where(r == n_rows - 1, final, res)
        return (row, res), None

    (row, res), _ = jax.lax.scan(
        body, (row, res), jnp.arange(count, dtype=jnp.int32))
    return row, res


class CheckpointedAligner:
    """Sliced-sweep alignment that persists its face every `every` block
    rows."""

    def __init__(
        self,
        a,
        b,
        c,
        scoring: Scoring = Scoring(),
        ckpt_path: Optional[str] = None,
        every: int = 8,
        rows: int = DEFAULT_ROWS,
    ):
        self.a = np.asarray(a)
        self.b = np.asarray(b)
        self.c = np.asarray(c)
        if min(len(self.a), len(self.b), len(self.c)) == 0:
            raise ValueError("checkpointed alignment needs nonempty sequences")
        self.scoring = scoring
        self.every = every
        self.rows = rows
        self.ckpt_path = ckpt_path or os.path.join(
            tempfile.gettempdir(), "trialign_ckpt.npz"
        )
        la, lb = len(self.a), len(self.b)
        self.n_blocks = -(-lb // rows)
        self.fj = lb - (self.n_blocks - 1) * rows
        # Padding rows lie below the final cell: no real cell reads them.
        self.a_ext, self.b_pad, self.c_arr = prep_sequences(
            self.a, self.b, self.c, (la, self.n_blocks * rows, len(self.c)))

        self.next_idx = 0
        self.row = np.zeros(face_shapes(la, rows, len(self.c))[0], np.int32)
        self.res = np.zeros(NUM_MATRICES, np.int32)

    # ------------------------------------------------------------------
    def _fingerprint(self) -> str:
        """Identity of this exact problem: sequences, scoring, geometry.
        Resuming someone else's checkpoint would silently corrupt scores."""
        h = hashlib.sha256()
        for arr in (self.a, self.b, self.c):
            h.update(np.ascontiguousarray(arr, dtype=np.uint8).tobytes())
        h.update(repr(self.scoring).encode())
        h.update(repr(self.rows).encode())
        return h.hexdigest()

    def save(self) -> None:
        tmp = self.ckpt_path + ".tmp.npz"
        np.savez_compressed(
            tmp, next_idx=self.next_idx, row=self.row, res=self.res,
            fingerprint=np.frombuffer(self._fingerprint().encode(),
                                      dtype=np.uint8),
        )
        os.replace(tmp, self.ckpt_path)

    def resume(self) -> bool:
        """Load checkpoint state if present and it belongs to this exact
        problem (sequence + scoring + geometry fingerprint); returns True
        if resumed."""
        if not os.path.exists(self.ckpt_path):
            return False
        with np.load(self.ckpt_path) as data:
            if "fingerprint" not in data or bytes(
                data["fingerprint"].tobytes()
            ).decode() != self._fingerprint():
                return False
            if data["row"].shape != self.row.shape:
                return False
            self.next_idx = int(data["next_idx"])
            self.row = data["row"]
            self.res = data["res"]
        return True

    def run_segment(self, count: int) -> None:
        """Sweep the next ``count`` block rows."""
        row, res = _segment(
            jnp.asarray(self.a_ext), jnp.asarray(self.b_pad),
            jnp.asarray(self.c_arr), jnp.asarray(self.row),
            jnp.asarray(self.res), jnp.int32(self.next_idx), count,
            self.rows, self.fj, self.n_blocks, self.scoring,
        )
        self.row = np.asarray(jax.device_get(row))
        self.res = np.asarray(jax.device_get(res))
        self.next_idx += count

    def run(self, checkpoint: bool = True) -> int:
        """Run remaining block rows (possibly after resume); returns the
        score."""
        while self.next_idx < self.n_blocks:
            self.run_segment(min(self.every, self.n_blocks - self.next_idx))
            if checkpoint:
                self.save()
        return int(self.res.max())


def align_blocked_checkpointed(
    a, b, c, scoring: Scoring = Scoring(), ckpt_path: Optional[str] = None,
    every: int = 8, resume: bool = True, **kw
) -> int:
    """Convenience wrapper: align with periodic checkpoints, resuming from
    an existing compatible checkpoint when present."""
    runner = CheckpointedAligner(a, b, c, scoring, ckpt_path, every, **kw)
    if resume:
        runner.resume()
    score = runner.run()
    if runner.ckpt_path and os.path.exists(runner.ckpt_path):
        os.remove(runner.ckpt_path)
    return score
