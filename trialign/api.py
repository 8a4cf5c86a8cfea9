"""Public API: align() / align_batch().

This is the host-side entry the reference exposed as the start_align /
Score / finish port handshake plus the (never-committed) RIFFA PCIe driver
(reference: src/TriAlign_1cyc.v:9-22, src/TriAlign_tb.sv:313-353).  Here the
host<->accelerator boundary is Python <-> a compiled XLA program.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from trialign.config import Scoring, encode


@dataclasses.dataclass
class AlignResult:
    """Result of one three-sequence alignment."""

    score: int
    alignment: Optional[List[List[int]]] = None  # 3 rows of codes, -1 = gap
    backend: str = ""
    cells: int = 0  # DP cell-updates performed (|A|*|B|*|C|)
    seconds: float = 0.0

    @property
    def gcups(self) -> float:
        """Giga cell-updates per second (1 cell = all 7 matrices),
        the reference's headline metric (pic/Result.png)."""
        return self.cells / self.seconds / 1e9 if self.seconds > 0 else 0.0


def _prep(seq) -> np.ndarray:
    if isinstance(seq, str):
        return encode(seq)
    return np.asarray(seq, dtype=np.uint8)


BACKENDS = ("auto", "golden", "xla", "sweep", "native")


def _pick_backend(scoring: Scoring) -> str:
    """"sweep" (the sliced sweep on this device's engine, see
    trialign/engine.py) unless the substitution matrix is past the sweep's
    alphabet cap, which only the XLA sweep takes."""
    from trialign.kernels.plane_math import SUBMATRIX_NSYM_CAP

    if scoring.submatrix is not None and len(scoring.submatrix) > SUBMATRIX_NSYM_CAP:
        return "xla"
    return "sweep"


def align(
    a,
    b,
    c,
    scoring: Scoring = Scoring(),
    backend: str = "auto",
    return_alignment: bool = False,
    score_bits: int = 0,
) -> AlignResult:
    """Optimal alignment of three sequences.

    ``backend``: "auto", "golden" (NumPy), "xla" (plain XLA plane sweep),
    "sweep" (the sliced sweep: the CUDA kernel on the GPU, its plain-JAX
    reference on the CPU), "native" (C++ oracle engine; with
    ``return_alignment`` it runs the host-side choice-capture traceback).

    ``score_bits`` nonzero selects RTL bit-parity mode (stored scores wrap
    as signed score_bits-wide registers, the hardware's unsaturated
    SCORE_BITS=12 behavior; reference: src/TriAlign_1cyc.v:6).  Supported
    by the "golden", "xla" and "sweep" backends.
    """
    import time

    a, b, c = _prep(a), _prep(b), _prep(c)
    la, lb, lc = len(a), len(b), len(c)
    cells = la * lb * lc
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from {BACKENDS}")
    if score_bits and return_alignment:
        raise ValueError("score_bits mode is score-only (no traceback)")

    if return_alignment:
        # Alignment recovery runs the Hirschberg/direct engine; the score
        # backends do not materialize paths, so `backend` is ignored here
        # except for "native", which selects the C++ choice-capture engine
        # (host-side oracle; ~4 B per DP cell).
        t0 = time.perf_counter()
        if backend == "native":
            from trialign.native import align_native

            score, alignment = align_native(a, b, c, scoring)
        else:
            from trialign.traceback import hirschberg_align

            score, alignment = hirschberg_align(a, b, c, scoring)
            backend = "hirschberg"
        return AlignResult(
            score=score,
            alignment=alignment,
            backend=backend,
            cells=cells,
            seconds=time.perf_counter() - t0,
        )

    if backend == "auto":
        backend = _pick_backend(scoring)
    if score_bits and backend not in ("golden", "xla", "sweep"):
        raise ValueError(
            f"score_bits wraparound is implemented by the 'golden', 'xla' "
            f"and 'sweep' backends, not {backend!r}"
        )
    if scoring.submatrix is not None and backend == "sweep" and \
            _pick_backend(scoring) != "sweep":
        raise ValueError(
            f"submatrix scoring with {len(scoring.submatrix)} symbols is "
            "implemented by the 'golden', 'xla' and 'native' backends, "
            "not 'sweep'"
        )

    t0 = time.perf_counter()
    if backend == "golden":
        from trialign.golden import align_planes_numpy

        score = align_planes_numpy(a, b, c, scoring, score_bits=score_bits)
    elif backend == "xla":
        from trialign.kernels.xla_ref import align_xla

        score = align_xla(a, b, c, scoring, score_bits=score_bits)
    elif backend == "sweep":
        from trialign.kernels.sweep import align_sweep

        score = align_sweep(a, b, c, scoring, score_bits=score_bits)
    else:
        from trialign.native import score_native

        score = score_native(a, b, c, scoring)

    return AlignResult(
        score=int(score),
        backend=backend,
        cells=cells,
        seconds=time.perf_counter() - t0,
    )


# Per-problem cell cap for routing batch traceback to the C++ engine:
# its choice buffer is 4 B/cell per in-flight problem (~256 MB at the
# cap), and several run concurrently.
NATIVE_TB_CELLS = 64 * 2**20


def _align_batch_traceback(
    triplets: Sequence, scoring: Scoring
) -> List[AlignResult]:
    """Batch alignment recovery: C++ engine threads for small problems,
    the Hirschberg/direct device engine for the rest."""
    import time
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    arrs = [(_prep(a), _prep(b), _prep(c)) for a, b, c in triplets]
    out: List[Optional[AlignResult]] = [None] * len(arrs)

    native_ok = False
    try:
        from trialign.native import align_native, is_available

        native_ok = is_available()
    except Exception:  # noqa: BLE001 - toolchain missing
        native_ok = False

    def one_native(i):
        a, b, c = arrs[i]
        score, rows = align_native(a, b, c, scoring)
        return i, score, rows, "native"

    small = [
        i for i, (a, b, c) in enumerate(arrs)
        if native_ok and len(a) * len(b) * len(c) <= NATIVE_TB_CELLS
    ]
    if small:
        with ThreadPoolExecutor(min(8, len(small))) as ex:
            for i, score, rows, bk in ex.map(one_native, small):
                out[i] = AlignResult(
                    score=score, alignment=rows, backend=bk,
                    cells=len(arrs[i][0]) * len(arrs[i][1]) * len(arrs[i][2]),
                )
    if None in out:
        from trialign.traceback import hirschberg_align

        for i, (a, b, c) in enumerate(arrs):
            if out[i] is not None:
                continue
            score, rows = hirschberg_align(a, b, c, scoring)
            out[i] = AlignResult(
                score=score, alignment=rows, backend="hirschberg",
                cells=len(a) * len(b) * len(c),
            )
    dt = time.perf_counter() - t0
    total_cells = sum(r.cells for r in out) or 1
    for r in out:
        r.seconds = dt * r.cells / total_cells
    return out  # type: ignore[return-value]


def align_batch(
    triplets: Sequence,
    scoring: Scoring = Scoring(),
    backend: str = "auto",
    return_alignment: bool = False,
) -> List[AlignResult]:
    """Align a batch of independent (a, b, c) triplets.

    Bucket-sized triplets are scored in one batched dispatch per bucket,
    longer ones one after another through the sliced sweep
    (trialign.dist.batch.align_batch_bucketed).  Across several cards use
    :func:`trialign.dist.batch.align_batch_sharded`.

    ``return_alignment`` recovers every alignment: small problems run
    concurrently through the C++ choice-capture engine (ctypes releases
    the GIL, so OS threads parallelize the host-side DP); the rest go
    through the device Hirschberg/direct engine.
    """
    import time

    if return_alignment:
        return _align_batch_traceback(triplets, scoring)

    t0 = time.perf_counter()
    arrs = [(_prep(a), _prep(b), _prep(c)) for a, b, c in triplets]
    if _pick_backend(scoring) == "xla":
        # Alphabets past the sweep's cap: one XLA sweep per item.
        from trialign.kernels.xla_ref import align_xla

        scores = [align_xla(a, b, c, scoring) for a, b, c in arrs]
        backend_name = "xla"
    else:
        from trialign.dist.batch import align_batch_bucketed

        scores = align_batch_bucketed(arrs, scoring)
        backend_name = "batch"
    dt = time.perf_counter() - t0
    # Items share dispatches, so per-item time is apportioned by cell
    # count: every item's .gcups then equals the batch aggregate GCUPS
    # (total cells / total seconds) instead of a distorted per-item figure.
    total_cells = sum(len(a) * len(b) * len(c) for a, b, c in arrs) or 1
    out = []
    for (a, b, c), s in zip(arrs, scores):
        cells = len(a) * len(b) * len(c)
        out.append(
            AlignResult(
                score=int(s),
                backend=backend_name,
                cells=cells,
                seconds=dt * cells / total_cells,
            )
        )
    return out
