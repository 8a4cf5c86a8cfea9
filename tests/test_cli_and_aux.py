"""CLI, metrics, and checkpoint/resume subsystems."""

import json
import os
import tempfile

import numpy as np
import pytest

from trialign.golden import align_planes_numpy
from tests.conftest import random_triplet


def test_cli_align_inline(capsys):
    from trialign.cli import main

    rc = main(["align", "--a", "ACGT", "--b", "ACGT", "--c", "ACGT",
               "--backend", "golden", "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["score"] == 12  # 4 triple matches x 3


def test_cli_align_dat_files(capsys):
    import trialign.io.datasets as ds
    from trialign.cli import main

    d = ds._DATA_DIR
    rc = main([
        "align",
        "--a-file", os.path.join(d, "A_seq.dat"),
        "--b-file", os.path.join(d, "B_seq.dat"),
        "--c-file", os.path.join(d, "C_seq.dat"),
        "--backend", "golden", "--json",
    ])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    from trialign.io import load_reference_triplet

    a, b, c = load_reference_triplet()
    assert out["score"] == align_planes_numpy(a, b, c)


def test_cli_alignment_output(capsys):
    from trialign.cli import main

    rc = main(["align", "--a", "ACGTACGT", "--b", "ACGACGT", "--c", "ACTTACG",
               "--alignment"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "score: 12" in out
    assert "ACG-ACGT" in out


def test_cli_batch(tmp_path, capsys):
    from trialign.cli import main

    f = tmp_path / "trips.tsv"
    f.write_text("ACGT ACGT ACGT\nAAAA TTTT CCCC\n")
    rc = main(["batch", "--tsv", str(f)])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split("\t") == ["0", "12"]


def test_cli_batch_alignment(tmp_path, capsys):
    from trialign.cli import main

    f = tmp_path / "trips.tsv"
    f.write_text("ACGT ACGT ACGT\n")
    rc = main(["batch", "--tsv", str(f), "--alignment"])
    assert rc == 0
    out = capsys.readouterr().out
    assert out.startswith("0\t12")
    assert "A: ACGT" in out


def test_cli_batch_sharded(tmp_path, capsys):
    from trialign.cli import main

    f = tmp_path / "trips.tsv"
    f.write_text("ACGT ACGT ACGT\nAAAA TTTT CCCC\n")
    rc = main(["batch", "--tsv", str(f), "--sharded"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split("\t") == ["0", "12"]


def test_metrics_record():
    from trialign.metrics import RunMetrics, timed

    m = RunMetrics(score=5, cells=1000, backend="x")
    with timed(m):
        pass
    d = m.to_dict()
    assert d["score"] == 5 and "gcups" in d


def test_checkpoint_resume_parity(rng, tmp_path):
    from trialign.checkpoint import CheckpointedAligner

    a, b, c = random_triplet(rng, 8, 75, 40)
    want = align_planes_numpy(a, b, c)
    path = str(tmp_path / "ck.npz")

    # Run the first half, "crash", resume in a new runner.
    r1 = CheckpointedAligner(a, b, c, ckpt_path=path, every=2, rows=16)
    assert r1.n_blocks == 5
    half = r1.n_blocks // 2
    while r1.next_idx < half:
        saved = r1.next_idx
        r1.run_segment(1)
        r1.save()
        assert r1.next_idx > saved

    r2 = CheckpointedAligner(a, b, c, ckpt_path=path, every=3, rows=16)
    assert r2.resume()
    assert r2.next_idx == r1.next_idx
    assert r2.run() == want


def test_checkpoint_incompatible_shapes_rejected(rng, tmp_path):
    from trialign.checkpoint import CheckpointedAligner

    a, b, c = random_triplet(rng, 8, 35, 150)
    path = str(tmp_path / "ck.npz")
    r1 = CheckpointedAligner(a, b, c, ckpt_path=path, every=2, rows=16)
    r1.save()
    a2, b2, c2 = random_triplet(rng, 8, 35, 290)
    r2 = CheckpointedAligner(a2, b2, c2, ckpt_path=path, every=2, rows=16)
    assert not r2.resume()
    # Same problem, other block rows: a different geometry, not resumed.
    r3 = CheckpointedAligner(a, b, c, ckpt_path=path, every=2, rows=32)
    assert not r3.resume()


def test_align_resilient_recovers_from_injected_failure(rng, tmp_path, monkeypatch):
    """Failure detection / elastic recovery (SURVEY section 5): kill the
    run mid-grid twice; the supervisor must resume from the face checkpoint
    and still produce the exact score."""
    import trialign.checkpoint as ckpt_mod
    from trialign.golden import align_planes_numpy
    from trialign.resilience import align_resilient
    from tests.conftest import random_triplet

    a, b, c = random_triplet(rng, 10, 40, 50)
    want = align_planes_numpy(a, b, c)

    real_segment = ckpt_mod._segment
    crashes = {"left": 2}

    def flaky_segment(*args, **kw):
        out = real_segment(*args, **kw)
        if crashes["left"] > 0:
            crashes["left"] -= 1
            raise RuntimeError("injected device loss")
        return out

    monkeypatch.setattr(ckpt_mod, "_segment", flaky_segment)
    got = align_resilient(
        a, b, c,
        ckpt_path=str(tmp_path / "ck.npz"),
        every=1,
        max_retries=3,
        backoff_s=0.0,
        rows=16,
    )
    assert got == want
    assert crashes["left"] == 0


def test_align_batch_resilient_retries_only_failed_chunk():
    """Round-3 VERDICT item 5 (supervisor logic): a batch failure after
    some work units drained must re-dispatch ONLY the unscored problems,
    and completed chunks must never be rerun."""
    from trialign.resilience import align_batch_resilient

    triplets = [("t%d" % i,) * 3 for i in range(7)]
    calls = []

    def flaky_batch(sub, scoring, mesh=None, on_scores=None):
        calls.append(list(sub))
        if len(calls) == 1:
            # First attempt: drain units covering the first 4 problems,
            # then die mid-batch.
            for li in range(4):
                on_scores(li, 100 + li)
            raise RuntimeError("injected device preemption")
        return [200 + li for li in range(len(sub))]

    out = align_batch_resilient(
        triplets, batch_fn=flaky_batch, backoff_s=0.0, max_retries=2
    )
    assert out == [100, 101, 102, 103, 200, 201, 202]
    assert len(calls) == 2
    assert len(calls[0]) == 7
    # Only the 3 unscored problems were re-dispatched.
    assert calls[1] == [triplets[i] for i in (4, 5, 6)]


def test_align_batch_resilient_gives_up():
    import pytest

    from trialign.resilience import AlignmentFailed, align_batch_resilient

    def always_fail(sub, scoring, mesh=None, on_scores=None):
        raise RuntimeError("permanent failure")

    with pytest.raises(AlignmentFailed):
        align_batch_resilient(
            [(np.zeros(3),) * 3], batch_fn=always_fail, backoff_s=0.0,
            max_retries=1,
        )


def test_align_batch_resilient_mosaic_end_to_end(rng, monkeypatch):
    """Integration: kill the bucketed batch mid-DRAIN (after the first
    dispatch's scores landed) and check the retry scores only the lost
    problems, with exact golden parity throughout."""
    import jax

    from trialign.golden import align_planes_numpy
    from trialign.resilience import align_batch_resilient
    from tests.conftest import random_triplet

    # Two small-bucket triplets (one dispatch) and two past the buckets
    # (one sliced-sweep dispatch each).
    trips = [random_triplet(rng, 12, 10, 24), random_triplet(rng, 9, 11, 20),
             random_triplet(rng, 6, 8, 260), random_triplet(rng, 5, 9, 270)]
    want = [align_planes_numpy(*t) for t in trips]

    real_get = jax.device_get
    state = {"fetches": 0, "armed": True}

    def flaky_get(x):
        if state["armed"]:
            state["fetches"] += 1
            if state["fetches"] == 2:  # the second dispatch's drain
                state["armed"] = False
                raise RuntimeError("injected device loss at drain")
        return real_get(x)

    monkeypatch.setattr(jax, "device_get", flaky_get)
    sizes = []
    from trialign.dist.batch import align_batch_bucketed

    def counting_batch(sub, scoring, mesh=None, on_scores=None):
        sizes.append(len(sub))
        return align_batch_bucketed(sub, scoring, on_scores=on_scores)

    out = align_batch_resilient(
        trips, batch_fn=counting_batch, backoff_s=0.0, max_retries=2
    )
    assert out == want
    assert len(sizes) == 2 and sizes[0] == len(trips)
    # The retry re-dispatched strictly fewer problems (the first
    # dispatch's scores survived the injected loss).
    assert 0 < sizes[1] < len(trips), sizes


def test_align_resilient_gives_up(rng, tmp_path, monkeypatch):
    import pytest

    import trialign.checkpoint as ckpt_mod
    from trialign.resilience import AlignmentFailed, align_resilient
    from tests.conftest import random_triplet

    a, b, c = random_triplet(rng, 6, 10, 10)

    def always_fail(*args, **kw):
        raise RuntimeError("permanent failure")

    monkeypatch.setattr(ckpt_mod, "_segment", always_fail)
    with pytest.raises(AlignmentFailed):
        align_resilient(
            a, b, c,
            ckpt_path=str(tmp_path / "ck2.npz"),
            max_retries=1,
            backoff_s=0.0,
            rows=16,
        )


def test_cli_align_metrics_and_profile(tmp_path, capsys):
    """--metrics emits a RunMetrics JSON line; --profile DIR writes a
    jax.profiler trace directory (round-1 VERDICT item 10)."""
    from trialign.cli import main

    prof = str(tmp_path / "trace")
    rc = main(["align", "--a", "ACGT", "--b", "ACGT", "--c", "ACGT",
               "--backend", "golden", "--metrics", "--profile", prof])
    assert rc == 0
    err = capsys.readouterr().err
    metric_lines = [l for l in err.splitlines() if l.startswith("{")]
    assert metric_lines, f"no RunMetrics JSON line in stderr: {err!r}"
    rec = json.loads(metric_lines[-1])
    assert rec["score"] == 12 and rec["cells"] == 64
    assert rec["backend"] == "golden" and rec["shape"] == [4, 4, 4]
    assert os.path.isdir(prof) and os.listdir(prof), "profiler trace missing"
    assert f"profiler trace written to {prof}" in err


def test_cli_align_fasta_triplet(tmp_path, capsys):
    from trialign.cli import main

    fa = tmp_path / "trip.fa"
    fa.write_text(">A\nACGTACGT\n>B\nACG\nTCGT\n>C\nACGTAGT\n")
    rc = main(["align", "--fasta", str(fa), "--backend", "golden", "--json"])
    assert rc == 0
    import json

    out = json.loads(capsys.readouterr().out)
    from trialign.golden import align_planes_numpy
    from trialign.config import encode

    want = align_planes_numpy(encode("ACGTACGT"), encode("ACGTCGT"), encode("ACGTAGT"))
    assert out["score"] == want


def test_benchmarks_helpers_cpu_smoke():
    """benchmarks module runs end-to-end on CPU (reference engine) and
    names the device of every measurement."""
    from trialign.benchmarks import bench_sweep, device_fields, parity_check

    assert isinstance(parity_check(), int)
    gcups, dt = bench_sweep(12, 2)
    assert gcups > 0 and dt > 0
    fields = device_fields()
    assert fields["platform"] == "cpu" and fields["device_count"] == 8
    assert fields["gpu"] == "not available"


def test_wavefront_rejects_oversize():
    import pytest

    from trialign.kernels.plane_math import bucket_dims

    with pytest.raises(ValueError):
        bucket_dims(64, 300, 64)  # |B| > 255
    with pytest.raises(ValueError):
        bucket_dims(5000, 64, 64)  # |A| past the batched buckets


def test_cli_selftest_passes(capsys):
    from trialign.cli import main

    assert main(["selftest"]) == 0
    out = capsys.readouterr().out
    assert "sweep" in out and "PASS" in out and "MISMATCH" not in out


def test_cli_align_sweep_backend(capsys):
    from trialign.cli import main

    rc = main(["align", "--a", "ACGTAC", "--b", "ACGAC", "--c", "ACTTAC",
               "--backend", "sweep", "--json"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    from trialign.config import encode

    assert out["backend"] == "sweep"
    assert out["score"] == align_planes_numpy(
        encode("ACGTAC"), encode("ACGAC"), encode("ACTTAC"))
