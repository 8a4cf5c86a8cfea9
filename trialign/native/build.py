"""Build + ctypes bindings for the native C++ reference engine.

Compiled on demand with g++ (no pybind11 dependency); the shared object is
cached next to the source and rebuilt when the source is newer.  Run
``python -m trialign.native.build`` to build explicitly.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import List, Optional, Sequence

import numpy as np

from trialign.config import Scoring

_DIR = os.path.dirname(__file__)
_SRC = os.path.join(_DIR, "trialign_ref.cpp")
_LIB = os.path.join(_DIR, "libtrialign_ref.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build(force: bool = False, verbose: bool = False) -> str:
    """Compile the shared library if missing or stale; returns its path."""
    with _lock:
        if (
            not force
            and os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)
        ):
            return _LIB
        cmd = [
            "g++",
            "-O3",
            "-march=native",
            "-funroll-loops",
            "-shared",
            "-fPIC",
            "-fopenmp",
            _SRC,
            "-o",
            _LIB + ".tmp",
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=not verbose)
        except subprocess.CalledProcessError:
            # Retry without OpenMP (not all toolchains ship libgomp).
            cmd.remove("-fopenmp")
            subprocess.run(cmd, check=True, capture_output=not verbose)
        os.replace(_LIB + ".tmp", _LIB)
        return _LIB


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    build()
    lib = ctypes.CDLL(_LIB)
    lib.trialign_score.restype = ctypes.c_int32
    lib.trialign_score.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
    ]
    lib.trialign_score_batch.restype = None
    lib.trialign_score_sub.restype = ctypes.c_int32
    lib.trialign_score_sub.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.trialign_align_sub.restype = ctypes.c_int32
    lib.trialign_align_sub.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.trialign_align.restype = ctypes.c_int32
    lib.trialign_align.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return lib


def is_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _lut_ptr(scoring: Scoring):
    """(lut_array, int32-pointer) for the scoring's (256, 256) lookup;
    keep the array referenced for the call's duration."""
    lut = np.ascontiguousarray(scoring.sub_lookup(), dtype=np.int32)
    return lut, lut.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def score_native(a, b, c, scoring: Scoring = Scoring()) -> int:
    """Optimal score via the C++ engine (runtime submatrix supported via
    the (256, 256) lookup, trialign_score_sub)."""
    lib = _load()
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    c = np.ascontiguousarray(c, dtype=np.uint8)
    if scoring.submatrix is not None:
        lut, lptr = _lut_ptr(scoring)
        return int(
            lib.trialign_score_sub(
                _ptr(a), len(a), _ptr(b), len(b), _ptr(c), len(c),
                scoring.gap_open, scoring.gap_extend, lptr,
            )
        )
    return int(
        lib.trialign_score(
            _ptr(a),
            len(a),
            _ptr(b),
            len(b),
            _ptr(c),
            len(c),
            scoring.match,
            scoring.mismatch,
            scoring.gap_open,
            scoring.gap_extend,
            0 if scoring.s3_mode == "sop" else 1,
        )
    )


def align_native(a, b, c, scoring: Scoring = Scoring()):
    """(score, rows) via the C++ choice-capture engine: one optimal
    alignment as 3 rows of symbol codes (-1 = gap), semantics identical to
    hirschberg_align (zero-border free start, walk stops at the first
    border, unscored leading context prepended).

    The choice buffer is 4 bytes per DP cell (~0.5 GB at 512^3); this is
    an oracle for tests and host-side use, not the production path.

    Restores natively the capability the reference stubbed out
    (reference: src/PE_1cyc.v:12-14,30).  Runtime submatrix scoring is
    supported (trialign_align_sub with the (256, 256) lookup)."""
    lib = _load()
    a = np.ascontiguousarray(a, dtype=np.uint8)
    b = np.ascontiguousarray(b, dtype=np.uint8)
    c = np.ascontiguousarray(c, dtype=np.uint8)
    la, lb, lc = len(a), len(b), len(c)
    score = ctypes.c_int32(0)
    stop = np.zeros(3, dtype=np.int32)
    cap = la + lb + lc + 1
    actions = np.zeros(cap, dtype=np.int8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    if scoring.submatrix is not None:
        lut, lptr = _lut_ptr(scoring)
        n = lib.trialign_align_sub(
            _ptr(a), la, _ptr(b), lb, _ptr(c), lc,
            scoring.gap_open, scoring.gap_extend, lptr,
            ctypes.byref(score),
            actions.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), cap,
            stop.ctypes.data_as(i32p),
        )
    else:
        n = lib.trialign_align(
            _ptr(a), la, _ptr(b), lb, _ptr(c), lc,
            scoring.match, scoring.mismatch, scoring.gap_open,
            scoring.gap_extend, 0 if scoring.s3_mode == "sop" else 1,
            ctypes.byref(score),
            actions.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), cap,
            stop.ctypes.data_as(i32p),
        )
    assert n >= 0, "native traceback buffer overflow"

    from trialign.config import CONSUMES

    cols = []
    ii, jj, kk = la, lb, lc
    for t in actions[:n]:
        ca, cb, cc = CONSUMES[int(t)]
        cols.append(
            (
                int(a[ii - 1]) if ca else -1,
                int(b[jj - 1]) if cb else -1,
                int(c[kk - 1]) if cc else -1,
            )
        )
        ii, jj, kk = ii - ca, jj - cb, kk - cc
    assert (ii, jj, kk) == tuple(int(v) for v in stop)
    while ii > 0 or jj > 0 or kk > 0:
        cols.append(
            (
                int(a[ii - 1]) if ii > 0 else -1,
                int(b[jj - 1]) if jj > 0 else -1,
                int(c[kk - 1]) if kk > 0 else -1,
            )
        )
        ii, jj, kk = max(ii - 1, 0), max(jj - 1, 0), max(kk - 1, 0)
    cols.reverse()
    rows = [list(r) for r in zip(*cols)] if cols else [[], [], []]
    return int(score.value), rows


def score_native_batch(
    triplets: Sequence, scoring: Scoring = Scoring()
) -> List[int]:
    """Batch scores via the C++ engine (OpenMP-parallel when available).

    No submatrix variant: batched submatrix scoring rides the padded
    device path (api.align_batch); per-item score_native supports it."""
    if scoring.submatrix is not None:
        raise ValueError("submatrix: use score_native per item or the "
                         "batched device path (api.align_batch)")
    lib = _load()
    n = len(triplets)
    if n == 0:
        return []
    sa = max(len(t[0]) for t in triplets)
    sb = max(len(t[1]) for t in triplets)
    sc = max(len(t[2]) for t in triplets)
    aa = np.zeros((n, max(sa, 1)), dtype=np.uint8)
    bb = np.zeros((n, max(sb, 1)), dtype=np.uint8)
    cc = np.zeros((n, max(sc, 1)), dtype=np.uint8)
    las = np.zeros(n, dtype=np.int32)
    lbs = np.zeros(n, dtype=np.int32)
    lcs = np.zeros(n, dtype=np.int32)
    for i, (a, b, c) in enumerate(triplets):
        aa[i, : len(a)] = a
        bb[i, : len(b)] = b
        cc[i, : len(c)] = c
        las[i], lbs[i], lcs[i] = len(a), len(b), len(c)
    scores = np.zeros(n, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.trialign_score_batch(
        _ptr(aa),
        las.ctypes.data_as(i32p),
        _ptr(bb),
        lbs.ctypes.data_as(i32p),
        _ptr(cc),
        lcs.ctypes.data_as(i32p),
        n,
        aa.shape[1],
        bb.shape[1],
        cc.shape[1],
        scoring.match,
        scoring.mismatch,
        scoring.gap_open,
        scoring.gap_extend,
        0 if scoring.s3_mode == "sop" else 1,
        scores.ctypes.data_as(i32p),
    )
    return [int(s) for s in scores]


if __name__ == "__main__":
    path = build(force="--force" in sys.argv, verbose=True)
    print(f"built {path}")
