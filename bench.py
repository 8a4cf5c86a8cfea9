#!/usr/bin/env python
"""TriAlign benchmark (NVIDIA GPU).

Prints an incrementally-enriched JSON result line to stdout: a valid
  {"metric": ..., "value": N, "unit": "GCUPS", "vs_baseline": N, ...}
line lands right after the FIRST measured stage and is re-printed with
more fields after every later stage -- the LAST line is the complete
result, but any line is a valid one.  Every line names the device it ran
on: JAX's platform, device kind and device count, and the card's name and
power limit as nvidia-smi reports them.

The parent process never imports JAX; every stage runs in its own
subprocess (`python bench.py --stage NAME`), one at a time, with a hard
timeout, so only one process holds the card and a stage that hangs or
dies costs only itself.  With no GPU the run stops with a non-zero exit
code and prints no result.

A global wall-clock budget (TRIALIGN_BENCH_BUDGET_S, default 1100 s)
gates the stages, which run highest-value-first.  Stage stderr is teed to
bench_err.log.

The headline metric is DP cell-updates/s on one card at 1k^3 via the
sliced sweep (1 cell-update = one (i,j,k) lattice site across all 7
matrices, the reference's unit, pic/Result.png).  vs_baseline is the
ratio to the reference ASIC's 12.4 GCUPS at 512^3.  The headline stage
checks its own score against the independent C++ oracle.

Measurement discipline lives in trialign/benchmarks.py.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ERR_LOG = os.path.join(HERE, "bench_err.log")

_err_fh = None


def log(msg):
    global _err_fh
    print(msg, file=sys.stderr, flush=True)
    try:
        if _err_fh is None:
            _err_fh = open(ERR_LOG, "a")
        _err_fh.write(msg if msg.endswith("\n") else msg + "\n")
        _err_fh.flush()
    except OSError:
        pass


# ----------------------------------------------------------------------
# Stage implementations (run inside per-stage subprocesses).
# Each returns a dict of result fields.
# ----------------------------------------------------------------------

def stage_probe():
    from trialign.benchmarks import device_fields

    return device_fields()


def stage_blocked_1k():
    """Headline 1k^3 + parity vs the C++ oracle on the measured inputs."""
    from trialign import benchmarks as B
    from trialign.native import score_native

    g, dt, score0, trip0 = B.bench_sweep(1024, 4, return_score0=True)
    want = score_native(*trip0)
    if score0 != want:
        raise AssertionError(f"1k^3 parity vs C++ oracle FAILED: {score0} != {want}")
    log(f"sweep 1k^3: {dt*1e3:.1f} ms/alignment -> {g:.2f} GCUPS; parity "
        f"OK vs the C++ oracle ({score0})")
    return {"blocked_1024_gcups": round(g, 3),
            "blocked_1024_ms": round(dt * 1e3, 1), "parity": "exact"}


def stage_parity_fixtures():
    from trialign import benchmarks as B

    score = B.parity_check(include_alt=False)
    log(f"parity OK on the reference dat triplet (score {score})")
    return {"parity": "exact", "reference_dat_score": int(score)}


def stage_single_512():
    """The ASIC's own protocol: ONE 512^3 alignment including ramp
    (pic/Result.png Table III: 10.82 ms)."""
    from trialign import benchmarks as B

    g, dt = B.bench_sweep(512, 8)
    log(f"sweep 512^3 single-stream: {dt*1e3:.2f} ms -> {g:.2f} GCUPS "
        "(ASIC: 10.82 ms)")
    return {"blocked_512_single_ms": round(dt * 1e3, 2),
            "blocked_512_single_gcups": round(g, 3)}


def _batch_stage(key, count, lo, hi, seed):
    from trialign import benchmarks as B

    g, s, tps = B.bench_align_batch(count, lo, hi, seed=seed)
    log(f"align_batch {count} x [{lo}, {hi}]^3: {s:.3f} s -> {g:.2f} GCUPS, "
        f"{tps:.1f} triplets/s (parity spot-checked)")
    return {f"{key}_gcups": round(g, 3),
            f"{key}_ms": round(s * 1e3 / count, 2)}


def stage_chain_512():
    return _batch_stage("blocked_512", 16, 512, 512, 5)


def stage_hetero_512():
    return _batch_stage("hetero_512", 16, 496, 512, 11)


def stage_chain_1k():
    return _batch_stage("blocked_1024_chained", 8, 1024, 1024, 13)


def stage_batch_mixed():
    from trialign import benchmarks as B

    g, s, tps = B.bench_align_batch(1024, 128, 512)
    log(f"batch 1024 triplets len 128-512 end-to-end: {s:.2f} s -> "
        f"{g:.2f} GCUPS aggregate, {tps:.0f} triplets/s (parity "
        "spot-checked)")
    return {"batch_mixed_1024_gcups": round(g, 3),
            "batch_mixed_1024_triplets_per_s": round(tps, 1)}


def stage_blocked_2k():
    from trialign import benchmarks as B

    g, dt = B.bench_sweep(2048, 2)
    log(f"sweep 2048^3: {dt*1e3:.1f} ms -> {g:.2f} GCUPS")
    return {"blocked_2048_gcups": round(g, 3)}


def stage_single_stream_255():
    from trialign import benchmarks as B

    g, dt = B.bench_sweep(255, 16)
    log(f"sweep 255^3: {dt*1e3:.2f} ms -> {g:.2f} GCUPS")
    return {"single_stream_255_gcups": round(g, 3)}


def _traceback_at(n, seed, key, trials=2):
    """Full alignment (score + traceback) at n^3: compile+warm once
    (rescore-validated), then min-of-`trials` timed runs."""
    import numpy as np

    from trialign import benchmarks as B
    from trialign.api import align
    from trialign.golden.numpy_model import rescore_alignment

    rng = np.random.default_rng(seed)
    a, b, c = (rng.integers(0, 4, n).astype(np.uint8) for _ in range(3))
    res = align(a, b, c, return_alignment=True)
    assert rescore_alignment(res.alignment) == res.score
    best = B.best_time(lambda: align(a, b, c, return_alignment=True),
                       trials=trials)
    log(f"{n}^3 FULL alignment (score + traceback, warm): {best:.2f} s "
        "(rescore-validated)")
    return {key: round(best, 3)}


def stage_traceback_512():
    return _traceback_at(512, 13, "traceback_512_s", trials=3)


def stage_traceback_1k():
    return _traceback_at(1024, 13, "traceback_1k_s")


def stage_traceback_2k():
    return _traceback_at(2048, 13, "traceback_2k_s")


def stage_traceback_4k():
    return _traceback_at(4096, 29, "traceback_4k_s")


def stage_traceback_8k():
    return _traceback_at(8192, 31, "traceback_8k_s", trials=1)


STAGE_FNS = {
    "probe": stage_probe,
    "blocked_1k": stage_blocked_1k,
    "parity_fixtures": stage_parity_fixtures,
    "single_512": stage_single_512,
    "chain_512": stage_chain_512,
    "hetero_512": stage_hetero_512,
    "batch_mixed": stage_batch_mixed,
    "blocked_2k": stage_blocked_2k,
    "chain_1k": stage_chain_1k,
    "traceback_512": stage_traceback_512,
    "traceback_1k": stage_traceback_1k,
    "traceback_2k": stage_traceback_2k,
    "traceback_4k": stage_traceback_4k,
    "traceback_8k": stage_traceback_8k,
    "single_stream_255": stage_single_stream_255,
}

# (name, worst-case seconds, hard cap or None) in execution order,
# highest-value-first.  The estimates are not measured on the H100 yet.
STAGES = [
    ("blocked_1k", 300, None),
    ("single_512", 200, None),
    ("batch_mixed", 400, None),
    ("chain_512", 200, None),
    ("hetero_512", 200, None),
    ("blocked_2k", 300, None),
    ("chain_1k", 300, None),
    ("traceback_512", 300, None),
    ("traceback_1k", 350, None),
    ("traceback_2k", 400, None),
    ("traceback_4k", 400, 600),
    ("traceback_8k", 500, 700),  # runs only if traceback_4k landed
    ("parity_fixtures", 200, None),
    ("single_stream_255", 150, None),
]


# ----------------------------------------------------------------------
# Parent orchestration.
# ----------------------------------------------------------------------

class Runner:
    def __init__(self):
        self.budget = float(os.environ.get("TRIALIGN_BENCH_BUDGET_S", "1100"))
        self.t0 = time.time()
        self.fields = {}
        self._last_emitted = None

    def elapsed(self):
        return time.time() - self.t0

    def remaining(self):
        return self.budget - self.elapsed()

    def emit(self):
        # Inlined from trialign.benchmarks.BASELINE_ASIC_GCUPS (asserted
        # equal by tests/test_bench_script.py): the parent never imports
        # trialign or jax.
        BASELINE_ASIC_GCUPS = 12.4

        f = self.fields
        if "blocked_1024_gcups" not in f:
            return
        value = f["blocked_1024_gcups"]
        result = {
            "metric": "single-card DP cell-updates/s at 1024^3 "
                      "(7-matrix cells, sliced sweep)",
            "value": round(value, 3),
            "unit": "GCUPS",
            "vs_baseline": round(value / BASELINE_ASIC_GCUPS, 3),
            "parity": f.get("parity", "pending"),
        }
        for k, v in f.items():
            if k not in result and k != "blocked_1024_gcups":
                result[k] = v
        key = json.dumps({k: v for k, v in result.items()
                          if k != "elapsed_s"}, sort_keys=True)
        if key == self._last_emitted:
            return
        self._last_emitted = key
        result["elapsed_s"] = round(self.elapsed(), 1)
        print(json.dumps(result), flush=True)

    def _stage_timeout(self, est, cap=None):
        t = max(60.0, min(self.remaining() - 15.0, max(1.5 * est, est + 180.0)))
        if cap is not None:
            t = min(t, cap)
        return t

    def _run_child(self, name, timeout):
        """Run one stage's child; returns (fields or None, returncode)."""
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--stage", name],
                capture_output=True, text=True, timeout=timeout, cwd=HERE,
            )
        except subprocess.TimeoutExpired as e:
            for s in (e.stderr or b""), (e.stdout or b""):
                if s:
                    log(s.decode() if isinstance(s, bytes) else s)
            log(f"[{name}] TIMED OUT after {timeout:.0f}s")
            return None, None
        if proc.stderr:
            log(proc.stderr.rstrip())
        fields = None
        for line in proc.stdout.splitlines():
            if line.startswith("FIELDS "):
                fields = json.loads(line[len("FIELDS "):])
        return fields, proc.returncode

    def run_stage(self, name, est, cap=None):
        if self.remaining() < 75.0:
            log(f"[{name}] SKIPPED ({self.remaining():.0f}s left "
                f"of {self.budget:.0f})")
            return None
        timeout = self._stage_timeout(est, cap)
        log(f"[{name}] start (elapsed {self.elapsed():.0f}s, "
            f"timeout {timeout:.0f}s)")
        t0 = time.time()
        fields, rc = self._run_child(name, timeout)
        dt = time.time() - t0
        if rc != 0 or fields is None:
            log(f"[{name}] FAILED (rc={rc}, {dt:.0f}s); continuing")
            return None
        log(f"[{name}] done in {dt:.0f}s")
        self.fields.update(fields)
        self.emit()
        return fields


def parent_main():
    r = Runner()
    log(f"=== bench session start {time.strftime('%Y-%m-%d %H:%M:%S')} "
        f"(budget {r.budget:.0f}s) ===")
    probe, _ = r._run_child("probe", 180)
    if not probe or probe.get("platform") != "gpu":
        log(f"no GPU found (probe: {probe}); the benchmark measures the "
            "card only")
        return 1
    r.fields.update(probe)
    r.fields["reference_asic_512_ms"] = 10.82
    r.fields["reference_software_512_gcups"] = 0.058
    for name, est, cap in STAGES:
        if name == "traceback_8k" and "traceback_4k_s" not in r.fields:
            log("[traceback_8k] SKIPPED (traceback_4k did not land)")
            continue
        r.run_stage(name, est, cap=cap)
    r.emit()
    log(f"bench complete in {r.elapsed():.0f}s; fields: {sorted(r.fields)}")
    return 0


def child_main(name):
    from trialign.engine import setup_compile_cache

    setup_compile_cache()
    fields = STAGE_FNS[name]()
    print("FIELDS " + json.dumps(fields), flush=True)


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--stage":
        child_main(sys.argv[2])
    else:
        sys.exit(parent_main())
