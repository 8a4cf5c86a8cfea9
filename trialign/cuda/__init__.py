"""Build, load and register the CUDA sweep library.

The library is compiled from ``sweep.cu`` with ``nvcc`` for Hopper
(``sm_90a``) against JAX's FFI headers, into ``trialign/cuda/_build``
(listed in .gitignore).  The file name carries a hash of the source and
the build flags, so an edited source is rebuilt on its next use.  Build it
ahead of time with::

    python -m trialign.cuda
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "sweep.cu")
BUILD_DIR = os.path.join(HERE, "_build")
TARGET = "trialign_sweep"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_lib = None  # the loaded library, kept for the life of the process


class CudaLibraryError(RuntimeError):
    """The CUDA library could not be built or loaded."""


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise CudaLibraryError(
            "nvcc not found (set CUDA_HOME or put it on PATH); the GPU "
            "engine needs it to build trialign/cuda/sweep.cu"
        )
    return found


def build_command(nvcc: str, include_dir: str, output: str) -> list:
    return [
        nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-I", include_dir, "-o", output, SOURCE,
    ]


def library_path(include_dir: str) -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    h.update(include_dir.encode())
    return os.path.join(BUILD_DIR, f"libtrialign_sweep-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if its current version is missing; returns the
    path of the shared object."""
    import jax.ffi

    include_dir = jax.ffi.include_dir()
    path = library_path(include_dir)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            build_command(nvcc_path(), include_dir, tmp),
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise CudaLibraryError(
                f"nvcc failed (rc={proc.returncode}):\n{proc.stderr[-4000:]}"
            )
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def ensure_registered() -> None:
    """Build (if needed), load and register the FFI target once."""
    global _lib
    with _lock:
        if _lib is not None:
            return
        import jax.ffi

        lib = ctypes.cdll.LoadLibrary(build())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.TrialignSweep), platform="CUDA"
        )
        _lib = lib

