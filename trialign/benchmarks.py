"""Benchmark measurement helpers (shared by bench.py and the CLI).

Measurement discipline:
* every timed sample ends in ``jax.block_until_ready`` (or a host fetch of
  the result) -- dispatch returns before the device finishes;
* repeated alignments use DIFFERENT inputs, so nothing can be cached or
  folded away;
* take the min over trials, after one untimed warm-up call that compiles;
* every result names the device it ran on (``device_fields``).
"""

from __future__ import annotations

import shutil
import subprocess
import time

import numpy as np

from trialign.config import Scoring

BASELINE_ASIC_GCUPS = 12.4  # reference ASIC @512^3, pic/Result.png (derived)


def gpu_name_and_power() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports them, or
    "not available" where there is no nvidia-smi."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "not available"
    proc = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 and \
        proc.stdout.strip() else "not available"


def device_fields() -> dict:
    """The device a measurement ran on, as JAX and nvidia-smi report it."""
    import jax

    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "device_kind": devs[0].device_kind,
        "device_count": len(devs),
        "gpu": gpu_name_and_power(),
    }


def best_time(fn, trials=3):
    """min wall time of fn() over ``trials`` after one warm-up call; fn
    must wait for its own result."""
    fn()
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _random_triplets(rng, count, lo, hi):
    return [
        tuple(rng.integers(0, 4, int(rng.integers(lo, hi + 1))).astype(np.uint8)
              for _ in range(3))
        for _ in range(count)
    ]


def bench_sweep(n, repeats, scoring: Scoring = Scoring(),
                return_score0=False):
    """Per-alignment time of the sliced sweep at n^3: ``repeats`` distinct
    alignments dispatched back to back, waited for together.

    ``return_score0`` appends (score of alignment 0, its (a, b, c)) so
    callers can parity-check the measured workload itself against an
    independent oracle."""
    import jax

    from trialign.kernels.sweep import align_sweep_async

    rng = np.random.default_rng(3)
    trips = _random_triplets(rng, repeats, n, n)

    def run():
        return jax.block_until_ready(
            [align_sweep_async(a, b, c, scoring) for a, b, c in trips])

    dt = best_time(run) / repeats
    if return_score0:
        score0 = int(jax.device_get(align_sweep_async(*trips[0], scoring)))
        return n**3 / dt / 1e9, dt, score0, trips[0]
    return n**3 / dt / 1e9, dt


def bench_align_batch(n_triplets, lo, hi, scoring: Scoring = Scoring(),
                      parity_samples: int = 4, seed: int = 77):
    """``n_triplets`` independent triplets with lengths uniform in
    [lo, hi], scored end to end through ``trialign.align_batch`` (host
    prep, dispatches, transfers).

    Returns (aggregate GCUPS, seconds, triplets/s).  Spot-checks
    ``parity_samples`` scores against the C++ oracle."""
    from trialign.api import align_batch
    from trialign.native import score_native

    rng = np.random.default_rng(seed)
    trips = _random_triplets(rng, n_triplets, lo, hi)
    cells = sum(len(a) * len(b) * len(c) for a, b, c in trips)
    scores = []

    def run():
        scores[:] = [r.score for r in align_batch(trips, scoring)]

    best = best_time(run)
    for i in rng.choice(n_triplets, size=parity_samples, replace=False):
        want = score_native(*trips[i], scoring)
        if scores[i] != want:
            raise AssertionError(
                f"batch parity FAILED at {i}: {scores[i]} != {want}"
            )
    return cells / best / 1e9, best, n_triplets / best


def parity_check(scoring: Scoring = Scoring(), include_alt: bool = True):
    """Bit-exact score parity of the compiled paths vs the NumPy oracle on
    the bundled fixtures -- a bench run with wrong answers is void."""
    from trialign.golden import align_planes_numpy
    from trialign.io import load_alt_triplet, load_reference_triplet
    from trialign.kernels.sweep import align_sweep
    from trialign.kernels.xla_ref import align_xla

    fixtures = [("reference dat", load_reference_triplet())]
    if include_alt:
        fixtures.append(("alt fixture", load_alt_triplet()))
    want = None
    for name, (a, b, c) in fixtures:
        w = align_planes_numpy(a, b, c, scoring)
        for engine, fn in (("xla", align_xla), ("sweep", align_sweep)):
            got = fn(a, b, c, scoring)
            if got != w:
                raise AssertionError(
                    f"{engine} parity FAILED ({name}): {got} != {w}")
        if want is None:
            want = w  # the reference triplet's score is the reported one
    return want
