"""TriAlign: optimal three-sequence alignment on an NVIDIA GPU.

A from-scratch JAX + CUDA re-design of the capabilities of the Verilog
accelerator in timmy139710/HW-Accelerator-Three-Sequence-Alignment
(NORCAS 2018): the 7-matrix affine-gap 3-D DP recurrence computed as a
wavefront sweep, the memory-efficient slicing method realized as a sliced
sweep over (B, C) rectangles exchanging boundary faces, alignments
recovered by a device-resident choice-capture walk and Hirschberg-style
divide and conquer, and scaling via jax.sharding meshes.
"""

from trialign.config import Scoring, encode, decode, MATRIX_NAMES  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy imports keep `import trialign` cheap and NumPy-only unless the
    # JAX-backed API is actually used.
    if name in ("align", "align_batch", "AlignResult"):
        from trialign import api

        return getattr(api, name)
    if name in ("align_resilient", "align_batch_resilient"):
        from trialign import resilience

        return getattr(resilience, name)
    if name in ("align_batch_bucketed", "align_batch_sharded"):
        from trialign.dist import batch

        return getattr(batch, name)
    raise AttributeError(f"module 'trialign' has no attribute {name!r}")
