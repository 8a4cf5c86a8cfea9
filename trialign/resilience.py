"""Failure detection and elastic recovery for long alignments.

The reference has no recovery story at all -- its FSM even parks forever
after `finish` because the 1cyc top has no OUT-state arm
(reference: src/TriAlign_1cyc.v:225-348; SURVEY.md section 5).  Production
runs on preemptible machines need one: the sliced sweep's boundary faces
are a complete intermediate state between block rows (the same property
the reference's y/z SRAMs have, src/TriAlign_1cyc.v:127-140), so the
checkpointed aligner can resume mid-grid.  This module wraps it in a
supervisor that detects failures (device loss, preemption surfacing as
exceptions), reinitializes the backend, and resumes from the last
checkpoint -- the single-host analogue of re-dispatching failed hosts.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Tuple

from trialign.checkpoint import CheckpointedAligner
from trialign.config import Scoring

log = logging.getLogger("trialign.resilience")


class AlignmentFailed(RuntimeError):
    """Raised when an alignment keeps failing after max_retries recoveries."""


def align_resilient(
    a,
    b,
    c,
    scoring: Scoring = Scoring(),
    ckpt_path: Optional[str] = None,
    every: int = 8,
    max_retries: int = 3,
    backoff_s: float = 1.0,
    cleanup: bool = True,
    **kw,
) -> int:
    """Sliced-sweep alignment that survives transient backend failures.

    Runs the checkpointed aligner; on any exception, waits, rebuilds the
    aligner (fresh jit state / device handles) and resumes from the last
    persisted face checkpoint, re-running at most `every` block rows.
    """
    attempts = 0
    last_exc: Optional[BaseException] = None
    runner = CheckpointedAligner(
        a, b, c, scoring, ckpt_path=ckpt_path, every=every, **kw
    )
    ckpt = runner.ckpt_path
    # `max_retries` recoveries = 1 initial attempt + max_retries retries.
    while attempts <= max_retries:
        try:
            score = runner.run(checkpoint=True)
            if cleanup:
                import os

                if os.path.exists(ckpt):
                    os.remove(ckpt)
            return score
        except (KeyboardInterrupt, SystemExit, GeneratorExit):
            # Deliberate interruption/shutdown must not be retried.
            raise
        except Exception as e:  # noqa: BLE001 - device loss is broad
            attempts += 1
            last_exc = e
            log.warning(
                "alignment attempt %d failed at block %d/%d: %s -- resuming "
                "from checkpoint",
                attempts,
                runner.next_idx,
                runner.n_blocks,
                e,
            )
            time.sleep(backoff_s * attempts)
            runner = CheckpointedAligner(
                a, b, c, scoring, ckpt_path=ckpt, every=every, **kw
            )
            runner.resume()
    raise AlignmentFailed(
        f"alignment failed after {max_retries} recoveries"
    ) from last_exc


def progress(runner: CheckpointedAligner) -> Tuple[int, int]:
    """(completed block rows, total block rows) -- the failure-detection heartbeat
    a pool supervisor polls."""
    return runner.next_idx, runner.n_blocks


def _bucketed_batch(triplets, scoring, mesh=None, on_scores=None):
    from trialign.dist.batch import align_batch_bucketed

    return align_batch_bucketed(triplets, scoring, on_scores=on_scores)


def align_batch_resilient(
    triplets,
    scoring: Scoring = Scoring(),
    mesh=None,
    max_retries: int = 3,
    backoff_s: float = 1.0,
    batch_fn=None,
    **kw,
):
    """Fleet-path elastic recovery: batch scoring that survives a killed
    dispatch mid-batch by re-dispatching ONLY the problems whose work
    unit had not drained (round-3 VERDICT item 5).

    The bucketed batch decomposes into independent dispatches -- one per
    small-problem bucket, one per long triplet -- whose scores drain one by
    one through align_batch_bucketed's ``on_scores`` feed.  A preemption
    therefore loses only the dispatches still in flight: each retry
    re-dispatches the UNSCORED problems alone, so completed ones are never
    rerun.  `batch_fn(sub, scoring, mesh=..., on_scores=...)` swaps the
    underlying batch executor (tests)."""
    fn = batch_fn or _bucketed_batch
    n = len(triplets)
    out = [None] * n
    attempts = 0
    last_exc: Optional[BaseException] = None
    while attempts <= max_retries:
        remaining = [i for i in range(n) if out[i] is None]
        if not remaining:
            break
        sub = [triplets[i] for i in remaining]

        def record(local_i, score, _remaining=remaining):
            out[_remaining[local_i]] = int(score)

        try:
            scores = fn(sub, scoring, mesh=mesh,
                        on_scores=record, **kw)
            for li, i in enumerate(remaining):
                out[i] = int(scores[li])
            break
        except (KeyboardInterrupt, SystemExit, GeneratorExit):
            raise
        except Exception as e:  # noqa: BLE001 - device loss is broad
            attempts += 1
            last_exc = e
            done = n - sum(1 for v in out if v is None)
            log.warning(
                "batch attempt %d failed with %d/%d problems scored: %s -- "
                "re-dispatching only the remainder",
                attempts, done, n, e,
            )
            time.sleep(backoff_s * attempts)
    if any(v is None for v in out):
        raise AlignmentFailed(
            f"batch failed after {max_retries} recoveries"
        ) from last_exc
    return out
