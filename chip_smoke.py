#!/usr/bin/env python
"""Smoke test of TriAlign on one NVIDIA GPU: the quickest proof that the
system still starts on the card and gives exact scores there.

    python chip_smoke.py          # one card, every phase below
    python chip_smoke.py --four   # four cards: the sharded paths only

Phases (each prints a line; any failure exits non-zero):

0. Device check: the card's name and power limit (nvidia-smi), the JAX
   and CUDA versions; JAX must report platform "gpu".
1. Set-up: build the CUDA sweep library (before any process touches the
   card), then warm the compiles.
4. Card-only tests: ``pytest -m gpu`` in a child process, run before this
   process first touches the card, so one process holds it at a time.
2. Kernel against plain XLA: the sliced sweep and ``align_xla`` at 512^3
   and 1024^3, both equal to the C++ oracle; 2048^3 kernel against XLA;
   s3_mode="rtl", a 4-symbol submatrix and score_bits=12 at a shape that
   does not divide into tiles against the golden model; small problems
   through the batched XLA sweep and through the kernel.
3. Public API: ``align`` at 1024^3, ``align(return_alignment=True)`` at
   512^3 and 1024^3 (rescored), ``align_batch`` on 256 triplets of
   length 128-512 (16 spot-checked), ``trialign.cli`` selftest.
5. Memory: peak device bytes in use.

Every comparison is exact integer equality.  The last line is one JSON
object: {"ok": true, "device": {"platform": ..., "kind": ..., "count": N}}.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def last_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {"platform": platform,
                                              "kind": kind, "count": count}})


def say(phase, msg):
    print(f"[phase {phase}] {msg}", flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def timed(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def best_of(fn, n=3):
    import jax

    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def triplets(seed, count, lo, hi):
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, 4, int(rng.integers(lo, hi + 1))).astype(np.uint8)
                  for _ in range(3)) for _ in range(count)]


def cube(seed, n):
    rng = np.random.default_rng(seed)
    return tuple(rng.integers(0, 4, n).astype(np.uint8) for _ in range(3))


def gpu_tests():
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-rs",
         "-p", "no:cacheprovider", os.path.join(HERE, "tests", "test_gpu.py")],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=600,
    )
    tail = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    say(4, f"card-only tests: {tail}")
    check(proc.returncode == 0 and "skipped" not in tail and "passed" in tail,
          f"gpu-marked tests:\n{proc.stdout[-3000:]}\n{proc.stderr[-2000:]}")


def device_check(want_count):
    import jax

    from trialign.benchmarks import gpu_name_and_power

    dev = jax.devices()[0]
    check(dev.platform == "gpu", f"JAX platform is {dev.platform!r}, not 'gpu'")
    check(len(jax.devices()) >= want_count,
          f"{want_count} cards needed, JAX sees {len(jax.devices())}")
    nvcc = subprocess.run(["/usr/local/cuda/bin/nvcc", "--version"],
                          capture_output=True, text=True)
    cuda = nvcc.stdout.strip().splitlines()[-1] if nvcc.returncode == 0 else "?"
    say(0, f"jax {jax.__version__}; {cuda}; {len(jax.devices())} x "
        f"{dev.device_kind}; nvidia-smi: {gpu_name_and_power()}")
    return dev


def build():
    """Compile the CUDA library; touches no device."""
    from trialign import cuda

    t0 = time.perf_counter()
    path = cuda.build()
    say(1, f"library {os.path.basename(path)} built in "
        f"{time.perf_counter() - t0:.1f} s")


def warm_up():
    from trialign.engine import score_engine, setup_compile_cache
    from trialign.kernels.sweep import align_sweep
    from trialign.kernels.xla_ref import align_xla

    t0 = time.perf_counter()
    cache = setup_compile_cache()
    check(score_engine() == "cuda", "the GPU engine is not the CUDA sweep")
    a, b, c = cube(0, 64)
    check(align_sweep(a, b, c) == align_xla(a, b, c), "warm-up scores")
    say(1, f"first compiles {time.perf_counter() - t0:.1f} s (compile "
        f"cache {cache})")


def kernel_vs_xla():
    from trialign.api import align_batch
    from trialign.config import Scoring
    from trialign.dist.batch import align_batch_padded
    from trialign.golden import align_planes_numpy
    from trialign.kernels.sweep import align_sweep, align_sweep_async
    from trialign.kernels.xla_ref import align_xla
    from trialign.native import score_native

    oracles = {}
    for n in (512, 1024, 2048):
        a, b, c = cube(n, n)
        got = align_sweep(a, b, c)
        t_sweep = best_of(lambda: align_sweep_async(a, b, c))
        want_x, t_xla = None, None
        want_x = align_xla(a, b, c)
        _, t_xla = timed(lambda: align_xla(a, b, c))
        line = (f"{n}^3: sweep {got} in {t_sweep * 1e3:.2f} ms "
                f"({n**3 / t_sweep / 1e9:.2f} GCUPS); xla {want_x} in "
                f"{t_xla * 1e3:.1f} ms")
        check(got == want_x, f"{n}^3 sweep {got} != xla {want_x}")
        if n <= 1024:
            oracles[n] = score_native(a, b, c)
            line += f"; C++ oracle {oracles[n]}"
            check(got == oracles[n], f"{n}^3 sweep {got} != oracle {oracles[n]}")
        say(2, line)

    sub4 = ((2, -1, -1, 0), (-1, 2, 0, -1), (-1, 0, 2, -1), (0, -1, -1, 2))
    a, b, c = (np.random.default_rng(7).integers(0, 4, n).astype(np.uint8)
               for n in (300, 700, 520))
    for name, sc, bits in (("rtl", Scoring(s3_mode="rtl"), 0),
                           ("submatrix4", Scoring(submatrix=sub4), 0),
                           ("score_bits12", Scoring(), 12)):
        got = align_sweep(a, b, c, sc, bits)
        want = align_planes_numpy(a, b, c, sc, score_bits=bits)
        say(2, f"(300, 700, 520) {name}: sweep {got}, golden {want}")
        check(got == want, f"{name} sweep {got} != golden {want}")

    small = triplets(3, 128, 128, 255)
    want = align_batch_padded(small)
    t_batched = best_of(lambda: align_batch_padded(small), n=2)

    def per_item():
        return [int(s) for s in
                np.asarray([align_sweep_async(*t) for t in small])]

    check(per_item() == want, "small problems: sweep != batched XLA sweep")
    t_items = best_of(per_item, n=2)
    say(2, f"128 triplets of length 128-255: batched XLA sweep "
        f"{t_batched * 1e3:.1f} ms, sliced sweep per item {t_items * 1e3:.1f} ms")
    check(len(align_batch(small[:2])) == 2, "align_batch")
    return oracles


def public_api(oracles):
    from trialign.api import align, align_batch
    from trialign.cli import main as cli_main
    from trialign.golden.numpy_model import rescore_alignment
    from trialign.native import score_native
    from trialign.traceback.hirschberg import _direct_ok

    res = align(*cube(1024, 1024))
    say(3, f"align 1024^3 backend={res.backend}: {res.score} in "
        f"{res.seconds * 1e3:.1f} ms")
    check(res.score == oracles[1024], f"align 1024^3 {res.score} != oracle")

    for n in (512, 1024):
        a, b, c = cube(n, n)
        res, dt = timed(lambda: align(a, b, c, return_alignment=True))
        route = "direct" if _direct_ok(n, n, n) else "hirschberg split"
        rescored = rescore_alignment(res.alignment)
        say(3, f"align {n}^3 return_alignment: score {res.score}, rescored "
            f"{rescored}, top node {route}, {dt:.2f} s")
        check(res.score == oracles[n] and rescored == res.score,
              f"traceback {n}^3")

    batch = triplets(11, 256, 128, 512)
    res, dt = timed(lambda: align_batch(batch))
    res2, dt2 = timed(lambda: align_batch(batch))
    rng = np.random.default_rng(5)
    picks = rng.choice(len(batch), size=16, replace=False)
    for i in picks:
        check(res[i].score == score_native(*batch[i]), f"align_batch item {i}")
    check([r.score for r in res] == [r.score for r in res2], "align_batch rerun")
    say(3, f"align_batch 256 x [128, 512]: {dt:.2f} s cold, {dt2:.2f} s warm; "
        "16 spot checks equal the C++ oracle")
    check(cli_main(["selftest"]) == 0, "cli selftest")
    say(3, "cli selftest PASS")
    return [r.score for r in res2]


def four_cards():
    import jax

    from trialign.api import align_batch
    from trialign.dist.batch import align_batch_sharded
    from trialign.dist.halo import align_sharded_triplet
    from trialign.dist.mesh import make_mesh
    from trialign.kernels.sweep import align_sweep

    warm_up()
    batch = triplets(11, 256, 128, 512)
    one = [r.score for r in align_batch(batch)]
    mesh = make_mesh(data=4, model=1)
    check(len({d.id for d in mesh.devices.flat}) == 4, "data mesh devices")
    got = align_batch_sharded(batch, mesh=mesh)
    _, dt = timed(lambda: align_batch_sharded(batch, mesh=mesh))
    check(got == one, "align_batch_sharded != one-card align_batch")
    say("4", f"align_batch_sharded over {[d.id for d in mesh.devices.flat]}: "
        f"256 triplets equal one card, {dt:.2f} s warm")

    a, b, c = cube(2048, 2048)
    want = align_sweep(a, b, c)
    mesh = make_mesh(data=1, model=4)
    check(len({d.id for d in mesh.devices.flat}) == 4, "model mesh devices")
    got = align_sharded_triplet(a, b, c, mesh=mesh)
    _, dt = timed(lambda: align_sharded_triplet(a, b, c, mesh=mesh))
    _, dt1 = timed(lambda: align_sweep(a, b, c))
    check(got == want, f"halo 2048^3 {got} != one card {want}")
    say("4", f"align_sharded_triplet 2048^3 on 4 cards: {got} equals one "
        f"card; {dt * 1e3:.1f} ms vs {dt1 * 1e3:.1f} ms on one card")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args()
    count = 4 if args.four else 1

    from trialign.benchmarks import gpu_name_and_power

    card = gpu_name_and_power()
    check(card != "not available", "no NVIDIA GPU (nvidia-smi not found)")
    print(card, flush=True)
    build()
    if not args.four:
        gpu_tests()
    dev = device_check(count)
    if args.four:
        four_cards()
    else:
        warm_up()
        oracles = kernel_vs_xla()
        public_api(oracles)
    import jax

    peak = max(d.memory_stats().get("peak_bytes_in_use", 0)
               for d in jax.local_devices())
    say(5, f"peak_bytes_in_use {peak}")
    print(last_line(dev.platform, dev.device_kind, len(jax.devices())),
          flush=True)


if __name__ == "__main__":
    main()
