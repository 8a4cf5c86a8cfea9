#!/usr/bin/env python
"""A guided tour of TriAlign (runs on the CPU or an NVIDIA GPU).

    python examples/tour.py

Covers: scoring config, single alignment, alignment recovery, batching,
long-sequence sliced sweep, checkpoint/resume, and the parity oracle.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import trialign  # noqa: E402
from trialign.config import Scoring, decode, encode  # noqa: E402


def main():
    # --- 1. Score three sequences (backend picked automatically) --------
    r = trialign.align("ACGTACGGT", "ACGTCGT", "ACGTAGT")
    print(f"score={r.score}  backend={r.backend}  gcups={r.gcups:.4f}")

    # --- 2. Recover the alignment itself --------------------------------
    r = trialign.align("ACGTACGGT", "ACGTCGT", "ACGTAGT", return_alignment=True)
    for name, row in zip("ABC", r.alignment):
        print(f"  {name}: {decode([v if v != -1 else 255 for v in row])}")

    # --- 3. Custom scoring, including the RTL's quirk mode --------------
    sc = Scoring(match=2, mismatch=-1, gap_open=3, gap_extend=1, s3_mode="rtl")
    r = trialign.align("ACGT", "AGGT", "ACGT", scoring=sc)
    print(f"rtl-mode score={r.score}")

    # A full runtime substitution matrix (the reference testbench's
    # planned-never-wired 4x4 score ports) runs on the production kernels
    # via select-chain tables -- and through full alignment recovery:
    blosum_ish = ((2, -1, -1, 0), (-1, 2, 0, -1), (-1, 0, 2, -1), (0, -1, -1, 2))
    r = trialign.align("ACGTACGT", "ACGTCGT", "ACGGTACT",
                       scoring=Scoring(submatrix=blosum_ish),
                       return_alignment=True)
    print(f"submatrix score={r.score}")

    # --- 4. Batch of independent triplets (MSA pre-alignment mode) ------
    rng = np.random.default_rng(0)
    trips = [
        tuple(rng.integers(0, 4, size=int(n)).astype(np.uint8) for n in dims)
        for dims in rng.integers(10, 60, size=(6, 3))
    ]
    for i, res in enumerate(trialign.align_batch(trips)):
        print(f"  triplet {i}: {res.score}")

    # --- 5. The reference repo's own test vectors ------------------------
    from trialign.io import load_reference_triplet

    a, b, c = load_reference_triplet()
    r = trialign.align(a, b, c)
    print(f"dat triplet score={r.score} (paper repo's 64-symbol vectors)")

    # --- 6. Long sequences: the sliced sweep -----------------------------
    a, b, c = (rng.integers(0, 4, size=400).astype(np.uint8) for _ in range(3))
    r = trialign.align(a, b, c, backend="sweep")
    print(f"400^3 sweep score={r.score} ({r.gcups:.2f} GCUPS)")

    # --- 7. Checkpointed + failure-resilient long runs -------------------
    score = trialign.align_resilient(a, b, c, every=4)
    print(f"resilient run score={score} (faces checkpointed every 4 block rows)")

    # --- 8. Verify anything against the NumPy oracle ---------------------
    from trialign.golden import align_planes_numpy

    assert align_planes_numpy(a, b, c) == r.score
    print("oracle parity: exact")

    # --- 9. Data-parallel throughput across every local device -----------
    # (one device here is fine; with several cards each sweeps its share
    # of the triplets.)
    from trialign.dist.batch import align_batch_sharded

    scores = align_batch_sharded(trips)
    assert scores == [res.score for res in trialign.align_batch(trips)]
    print(f"sharded batch: {scores}")


if __name__ == "__main__":
    main()
