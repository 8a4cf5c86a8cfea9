"""bench.py orchestration invariants (no GPU, no subprocess stages).

The parent emits a valid, complete JSON line after every stage, names the
device on every line, never imports JAX (so only one process at a time
holds the card), and stops with a non-zero exit code instead of measuring
anything when no GPU is found.
"""

import importlib.util
import io
import json
import os
from contextlib import redirect_stdout

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GPU_PROBE = {"platform": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
             "device_count": 1, "gpu": "NVIDIA H100 80GB HBM3, 700.00 W"}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "bench", os.path.join(HERE, "bench.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # Keep test log lines out of the repo's real bench_err.log.
    mod.ERR_LOG = str(tmp_path_factory.mktemp("bench") / "bench_err.log")
    return mod


def test_inlined_baseline_matches_benchmarks(bench):
    from trialign.benchmarks import BASELINE_ASIC_GCUPS

    r = bench.Runner()
    r.fields = {"blocked_1024_gcups": BASELINE_ASIC_GCUPS}
    buf = io.StringIO()
    with redirect_stdout(buf):
        r.emit()
    out = json.loads(buf.getvalue().splitlines()[-1])
    # vs_baseline == 1.0 exactly iff the constant inlined in bench.emit()
    # equals trialign.benchmarks.BASELINE_ASIC_GCUPS.
    assert out["vs_baseline"] == 1.0


def test_emit_json_line_shape(bench, capsys):
    r = bench.Runner()
    r.fields = dict(GPU_PROBE)
    # No headline field yet -> emit() must print nothing (not a broken line).
    r.emit()
    r.fields.update({"blocked_1024_gcups": 28.25, "blocked_1024_ms": 38.0,
                     "parity": "exact"})
    r.emit()
    r.emit()  # unchanged fields: no duplicate line
    r.fields["hetero_512_ms"] = 9.68
    r.emit()
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 2
    for ln in lines:
        rec = json.loads(ln)
        for key in ("metric", "value", "unit", "vs_baseline", "platform",
                    "device_kind", "device_count", "gpu"):
            assert key in rec, (key, rec)
    final = json.loads(lines[-1])
    assert final["value"] == 28.25 and final["hetero_512_ms"] == 9.68


def test_parent_module_is_jax_free(bench):
    """The orchestrating parent must never import jax: a JAX process
    reserves most of the card's memory, so only the stage child may."""
    src = open(os.path.join(HERE, "bench.py")).read()
    import ast

    tree = ast.parse(src)
    # Module-level (parent-executed) imports only; stage fns import inside.
    for node in tree.body:
        if isinstance(node, ast.Import):
            assert not any(a.name.split(".")[0] in ("jax", "trialign")
                           for a in node.names)
        if isinstance(node, ast.ImportFrom):
            assert (node.module or "").split(".")[0] not in ("jax", "trialign")


@pytest.mark.parametrize("probe", [None, {"platform": "cpu"}])
def test_parent_without_gpu_fails(bench, monkeypatch, capsys, probe):
    """No GPU (or no probe at all): exit non-zero, print no result, run
    no stage."""
    calls = []

    def fake_child(self, name, timeout):
        calls.append(name)
        return probe, 0

    monkeypatch.setattr(bench.Runner, "_run_child", fake_child)
    assert bench.parent_main() == 1
    assert calls == ["probe"]
    assert capsys.readouterr().out == ""


def test_parent_runs_stages_one_at_a_time(bench, monkeypatch, capsys):
    calls = []

    def fake_child(self, name, timeout):
        calls.append(name)
        if name == "probe":
            return dict(GPU_PROBE), 0
        if name == "blocked_1k":
            return {"blocked_1024_gcups": 28.0, "parity": "exact"}, 0
        return None, 1  # every other stage fails: reported, not fatal

    monkeypatch.setattr(bench.Runner, "_run_child", fake_child)
    assert bench.parent_main() == 0
    assert calls[0] == "probe" and calls[1] == "blocked_1k"
    assert "traceback_8k" not in calls  # gated on traceback_4k
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["value"] == 28.0 and last["platform"] == "gpu"
