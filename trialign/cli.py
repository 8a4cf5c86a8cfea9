"""Command-line interface.

The reference is driven by recompiling Verilog parameters and re-running a
simulator (SURVEY.md section 5: all configuration is compile-time localparams,
src/TriAlign_1cyc.v:1-8).  Here everything is a runtime flag.

Examples:
  python -m trialign.cli align --a ACGTACGT --b ACGACGT --c ACTTACG --alignment
  python -m trialign.cli align --a-file dat/A_seq.dat --b-file dat/B_seq.dat \
      --c-file dat/C_seq.dat --backend golden
  python -m trialign.cli batch --tsv triplets.tsv
  python -m trialign.cli selftest
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from trialign.config import Scoring, decode, encode


def _load_seq(inline, path):
    if inline is not None:
        return encode(inline)
    if path is None:
        raise SystemExit("provide either an inline sequence or a file")
    if path.endswith(".dat"):
        from trialign.io import load_dat_sequence

        return load_dat_sequence(path)
    from trialign.io import read_fasta

    seqs = read_fasta(path)
    if len(seqs) != 1:
        raise SystemExit(f"{path}: expected exactly one FASTA record, got {len(seqs)}")
    return encode(next(iter(seqs.values())))


def _load_triplet(args):
    """Three sequences from inline flags, per-sequence files, or one
    3-record FASTA (--fasta)."""
    if getattr(args, "fasta", None):
        from trialign.io import read_fasta

        seqs = read_fasta(args.fasta)
        if len(seqs) != 3:
            raise SystemExit(
                f"{args.fasta}: expected exactly 3 FASTA records, got {len(seqs)}"
            )
        return tuple(encode(s) for s in seqs.values())
    return (
        _load_seq(args.a, args.a_file),
        _load_seq(args.b, args.b_file),
        _load_seq(args.c, args.c_file),
    )


def _parse_submatrix(spec):
    """'1,-1,-1,-1,-1,1,...' (n*n comma values, row-major) -> nested tuple."""
    if not spec:
        return None
    vals = [int(v) for v in spec.replace(" ", "").split(",") if v != ""]
    n = int(len(vals) ** 0.5)
    if n * n != len(vals):
        raise SystemExit(
            f"--submatrix needs a square count of values (got {len(vals)})"
        )
    return tuple(tuple(vals[i * n : (i + 1) * n]) for i in range(n))


def _scoring(args) -> Scoring:
    return Scoring(
        match=args.match,
        mismatch=args.mismatch,
        gap_open=args.gap_open,
        gap_extend=args.gap_extend,
        s3_mode=args.s3_mode,
        submatrix=_parse_submatrix(getattr(args, "submatrix", None)),
    )


def _add_scoring_args(p):
    p.add_argument("--match", type=int, default=1)
    p.add_argument("--mismatch", type=int, default=-1)
    p.add_argument("--gap-open", type=int, default=2)
    p.add_argument("--gap-extend", type=int, default=1)
    p.add_argument("--s3-mode", choices=["sop", "rtl"], default="sop")
    p.add_argument(
        "--submatrix", default=None, metavar="V1,V2,...",
        help="runtime substitution matrix: n*n comma-separated ints, "
        "row-major (symbol codes 0..n-1); requires --s3-mode sop "
        "(the reference testbench's planned 4x4 score-matrix ports)",
    )


def cmd_align(args) -> int:
    from trialign.api import align
    from trialign.metrics import RunMetrics, device_summary, profile_trace

    a, b, c = _load_triplet(args)
    with profile_trace(args.profile):
        res = align(
            a, b, c, scoring=_scoring(args), backend=args.backend,
            return_alignment=args.alignment,
            score_bits=getattr(args, "score_bits", 0),
        )
    if args.profile:
        print(f"profiler trace written to {args.profile}", file=sys.stderr)
    if args.metrics:
        RunMetrics(
            score=res.score,
            cells=res.cells,
            seconds=res.seconds,
            backend=res.backend,
            device=device_summary(),
            shape=(len(a), len(b), len(c)),
        ).emit()
    if args.json:
        out = {
            "score": res.score,
            "backend": res.backend,
            "cells": res.cells,
            "seconds": round(res.seconds, 6),
            "gcups": round(res.gcups, 4),
            "device": device_summary(),
        }
        if res.alignment:
            out["alignment"] = [
                decode([v if v != -1 else 255 for v in row]) for row in res.alignment
            ]
        print(json.dumps(out))
    else:
        print(f"score: {res.score}")
        print(f"backend: {res.backend}  cells: {res.cells}  "
              f"time: {res.seconds*1e3:.2f} ms  gcups: {res.gcups:.3f}")
        if res.alignment:
            for name, row in zip("ABC", res.alignment):
                print(f"{name}: {decode([v if v != -1 else 255 for v in row])}")
    return 0


def cmd_batch(args) -> int:
    from trialign.api import align_batch

    trips = []
    with open(args.tsv) as f:
        for lineno, line in enumerate(f, 1):
            if not line.strip():
                continue
            parts = line.split()
            if len(parts) != 3:
                raise SystemExit(
                    f"{args.tsv}:{lineno}: expected 3 whitespace-separated "
                    f"sequences, got {len(parts)}"
                )
            trips.append(tuple(encode(p) for p in parts))
    if args.sharded and args.alignment:
        raise SystemExit("--alignment is score+path recovery on the host "
                         "path; run it without --sharded")
    if args.sharded:
        from trialign.dist.batch import align_batch_sharded

        for i, s in enumerate(align_batch_sharded(trips,
                                                  scoring=_scoring(args))):
            print(f"{i}\t{s}")
        return 0
    results = align_batch(trips, scoring=_scoring(args),
                          return_alignment=args.alignment)
    for i, r in enumerate(results):
        print(f"{i}\t{r.score}")
        if r.alignment:
            for name, row in zip("ABC", r.alignment):
                print(f"  {name}: "
                      f"{decode([v if v != -1 else 255 for v in row])}")
    return 0


def cmd_bench(args) -> int:
    """Single-card score benchmark at --size^3 (see trialign.benchmarks
    for the measurement discipline)."""
    from trialign.benchmarks import (
        BASELINE_ASIC_GCUPS,
        bench_sweep,
        device_fields,
        parity_check,
    )
    from trialign.metrics import profile_trace

    sc = _scoring(args)
    n = args.size
    parity_check(sc)
    with profile_trace(args.profile):
        gcups, dt = bench_sweep(n, args.repeats, sc)
    if args.profile:
        print(f"profiler trace written to {args.profile}", file=sys.stderr)
    out = {
        "size": n,
        "ms_per_alignment": round(dt * 1e3, 3),
        "gcups": round(gcups, 3),
        "vs_reference_asic": round(gcups / BASELINE_ASIC_GCUPS, 3),
        "parity": "exact",
        **device_fields(),
    }
    print(json.dumps(out) if args.json else
          f"sweep {n}^3: {dt*1e3:.2f} ms/alignment -> {gcups:.2f} GCUPS "
          f"({out['vs_reference_asic']}x reference ASIC) on "
          f"{out['platform']}/{out['device_kind']}")
    return 0


def cmd_selftest(args) -> int:
    """Cross-backend parity on the canonical triplet -- the self-checking
    the reference testbench lacked."""
    from trialign.engine import platform, score_engine
    from trialign.golden import align_planes_numpy
    from trialign.io import load_reference_triplet

    a, b, c = load_reference_triplet()
    sc = _scoring(args)
    want = align_planes_numpy(a, b, c, sc)
    rows = [("golden", want)]

    from trialign.kernels.xla_ref import align_xla

    rows.append(("xla", align_xla(a, b, c, sc)))
    from trialign.kernels.sweep import align_sweep

    rows.append(("sweep", align_sweep(a, b, c, sc)))
    try:
        from trialign.native import align_native, score_native

        rows.append(("native-c++", score_native(a, b, c, sc)))
        nscore, nrows = align_native(a, b, c, sc)
        from trialign.golden.numpy_model import rescore_alignment

        # A traceback whose rescore disagrees is a mismatch even if the
        # score itself is right; surface it as one.
        ok_tb = rescore_alignment(nrows, sc) == nscore
        rows.append(("native-tb", nscore if ok_tb else 10**9))
    except Exception as e:  # toolchain may be missing
        print(f"native-c++: skipped ({e})", file=sys.stderr)
    from trialign.traceback import hirschberg_align

    hscore, _ = hirschberg_align(a, b, c, sc)
    rows.append(("hirschberg", hscore))

    ok = True
    for name, got in rows:
        good = got == want
        ok &= good
        print(f"{name:12s} {got:6d}  {'OK' if good else 'MISMATCH'}")
    print(f"platform: {platform()}  engine: {score_engine()}  ->  "
          f"{'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trialign", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("align", help="align one triplet")
    p.add_argument("--a")
    p.add_argument("--b")
    p.add_argument("--c")
    p.add_argument("--a-file")
    p.add_argument("--b-file")
    p.add_argument("--c-file")
    p.add_argument("--fasta", help="one FASTA file with exactly 3 records")
    p.add_argument("--backend", default="auto",
                   choices=["auto", "golden", "xla", "sweep", "native"])
    p.add_argument("--alignment", action="store_true", help="recover the alignment")
    p.add_argument("--score-bits", type=int, default=0, dest="score_bits",
                   help="RTL bit-parity mode: wrap stored scores as signed "
                   "N-bit registers (the hardware's SCORE_BITS=12)")
    p.add_argument("--json", action="store_true")
    p.add_argument("--profile", metavar="DIR",
                   help="write a jax.profiler trace to DIR")
    p.add_argument("--metrics", action="store_true",
                   help="emit a structured RunMetrics JSON line to stderr")
    _add_scoring_args(p)
    p.set_defaults(fn=cmd_align)

    p = sub.add_parser("batch", help="align triplets from a TSV (a b c per line)")
    p.add_argument("--tsv", required=True)
    p.add_argument("--sharded", action="store_true",
                   help="data-parallel across every local device "
                        "(align_batch_sharded)")
    p.add_argument("--alignment", action="store_true",
                   help="recover every alignment (threaded C++ engine / "
                        "device Hirschberg; incompatible with --sharded)")
    _add_scoring_args(p)
    p.set_defaults(fn=cmd_batch)

    p = sub.add_parser("bench", help="single-card benchmark at --size^3")
    p.add_argument("--size", type=int, default=1024)
    p.add_argument("--repeats", type=int, default=4)
    p.add_argument("--json", action="store_true")
    p.add_argument("--profile", metavar="DIR",
                   help="write a jax.profiler trace to DIR")
    _add_scoring_args(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("selftest", help="cross-backend parity check")
    _add_scoring_args(p)
    p.set_defaults(fn=cmd_selftest)

    args = ap.parse_args(argv)
    from trialign.engine import setup_compile_cache

    setup_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
