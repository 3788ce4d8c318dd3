"""The harness's guards: no card, no result; a checkout of the benchmark
alone, no result; nothing of JAX or the JAX package loaded, compared by
whole top-level names; and a traced view reduces events as it should."""
import os
import shutil
import subprocess
import sys

from benchmark import guard, harness
from benchmark.trace import WINDOW_EVENT, TraceView

RUN = [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload", "detect.bf16.b128",
       "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"]


def _env():
    return dict(os.environ, CUDA_VISIBLE_DEVICES="")


def test_no_card_no_result():
    out = subprocess.run(RUN, capture_output=True, text=True, cwd=harness.ROOT, env=_env(),
                         timeout=300)
    assert out.returncode == harness.NO_CARD_EXIT, out.stderr
    assert out.stdout == ""
    assert "CUDA card" in out.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cmd = [sys.executable, str(tmp_path / "benchmark" / "run.py")] + RUN[2:]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path, env=_env(),
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_names_compare_whole():
    assert guard.loaded_forbidden(["dan_tpu_torch", "dan_tpu_torch.api", "jaxtyping", "numpy"]) == []
    assert guard.loaded_forbidden(["dan_tpu", "dan_tpu.models", "jax", "jaxlib.xla_client",
                                   "flax.linen"]) == ["dan_tpu", "dan_tpu.models", "flax.linen",
                                                      "jax", "jaxlib.xla_client"]


def test_the_benchmark_imports_nothing_forbidden():
    assert guard.scan_imports(harness.HERE) == []


def test_the_scan_finds_a_forbidden_import(tmp_path):
    (tmp_path / "reference").mkdir()
    (tmp_path / "reference" / "bad.py").write_text("import dan_tpu_torch.api\n")
    (tmp_path / "drivers").mkdir()
    (tmp_path / "drivers" / "ok.py").write_text("import dan_tpu_torch.api\n")
    (tmp_path / "drivers" / "bad.py").write_text("from jax import numpy\nimport dan_tpu.x\n")
    found = guard.scan_imports(str(tmp_path))
    assert sorted(found) == sorted(["reference/bad.py: dan_tpu_torch.api", "drivers/bad.py: jax",
                                    "drivers/bad.py: dan_tpu.x"])


def test_a_whole_tiny_run_loads_nothing_forbidden():
    code = ("import sys, torch; torch.set_num_threads(2)\n"
            "from benchmark.tests.tiny import tiny_cell, run\n"
            "for c in ('detect.bf16.b128', 'detect.int8.b128', 'train.bf16.b32'):\n"
            "    run(tiny_cell(c), seconds=0.2, trace=True)\n"
            "from benchmark import guard\n"
            "print('FORBIDDEN', guard.loaded_forbidden())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, env=_env(), timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_trace_view_reduces_a_timeline():
    # (on the device, name, start, end) in seconds
    events = [(False, WINDOW_EVENT, 0.0, 1.0), (True, WINDOW_EVENT, 0.0, 1.0),
              (False, "aten::conv", 0.1, 0.5),
              (False, "cudaStreamSynchronize", 0.6, 0.9),
              (True, "kernel_a", 0.0, 0.3), (True, "kernel_b", 0.2, 0.4),
              (True, "Memcpy HtoD", 0.7, 0.8), (True, "kernel_a", 0.95, 1.2)]
    v = TraceView(events, {"s": [1.0, 3.0]}, {}, {}, {}, {}, 1.0)
    assert abs(v.busy_s() - 0.55) < 1e-9
    assert abs(v.idle_share() - 45.0) < 1e-6
    assert abs(v.kernel_s("kernel_a") - 0.35) < 1e-9 and v.kernel_s("nothing") is None
    assert v.span_mean_ms("s") == 2.0
    b = v.breakdown()
    assert b["device_ops"][0][0] == "kernel_a" and abs(b["device_ops"][0][1] - 0.35) < 1e-9
    gaps = dict(b["idle_gaps"])
    assert abs(gaps["cudaStreamSynchronize"] - 0.15) < 1e-9 and abs(gaps["no host event"] - 0.3) < 1e-9


def test_every_tap_of_a_metric_names_a_function_of_the_program():
    from benchmark.trace import _resolve

    for m in harness.manifest()["per_layer"]:
        mod = harness.metric_module(m["name"])
        for target in {**getattr(mod, "SPANS", {}), **getattr(mod, "RECORDS", {})}.values():
            if not target.startswith("@"):
                obj, name = _resolve(target)
                assert callable(getattr(obj, name)), (m["name"], target)


def test_the_tracer_takes_its_taps_only_while_the_stretch_runs():
    import torch

    from benchmark.tests import tapped
    from benchmark.trace import Tracer

    t = Tracer("cpu", spans={"twice": "benchmark.tests.tapped:twice", "fwd": "@net"},
               records={"calls": "benchmark.tests.tapped:Box.scale"})
    net = torch.nn.Linear(2, 2)
    t.state = {"net": net}
    raw_twice, raw_scale = tapped.twice, vars(tapped.Box)["scale"]
    with t.stretch():
        assert tapped.twice(3) == 6 and tapped.Box.scale(2, k=5) == 10
        net(torch.ones(1, 2))
    assert tapped.twice is raw_twice and vars(tapped.Box)["scale"] is raw_scale
    assert not net._forward_hooks and not net._forward_pre_hooks
    tapped.twice(1)  # after the stretch: no span
    v = t.view({"calls": 1}, {}, {})
    assert len(v.spans["twice"]) == 1 and len(v.spans["fwd"]) == 1
    assert v.records["calls"] == [((2,), {"k": 5})] and v.units == {"calls": 1}


def test_two_metrics_cannot_tap_one_name_in_two_places():
    import pytest

    mods = {"a": type("M", (), {"SPANS": {"s": "x:f"}}), "b": type("M", (), {"SPANS": {"s": "x:g"}})}
    old = dict(harness._METRICS)
    harness._METRICS.update(mods)
    try:
        with pytest.raises(ValueError):
            harness.taps([{"name": "a"}, {"name": "b"}])
        assert harness.taps([{"name": "a"}, {"name": "a"}]) == ({"s": "x:f"}, {})
    finally:
        harness._METRICS.clear()
        harness._METRICS.update(old)
