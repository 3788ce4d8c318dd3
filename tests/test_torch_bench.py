"""The port's bench entry points (dan_tpu_torch/tools/bench.py,
bench_train.py, bench_tta_dataset.py, bench_int8.py, entry.py) against the
reference's (bench.py, scripts/bench_*.py, __graft_entry__.py) on the CPU,
at a small config on the JAX package's PRNGKey(0) weights: the bench detect
function, the train bench's first loss, the int8 bench's calibration and
detections, the TTA sweep's sizes and launch arithmetic, the CPU-baseline
cache, the printed lines, and the entry forward."""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__
import bench as ref_bench
import dan_tpu.config as jax_config
from dan_tpu import quant as jax_quant
from dan_tpu.box.anchors import generate_anchors_np
from dan_tpu.data.synthetic import synthetic_batch
from dan_tpu.eval.tta import TTARunner as JaxTTARunner
from dan_tpu.ops.postprocess import postprocess_batch as jax_postprocess_batch
from dan_tpu.ops.preprocess import normalize_image as jax_normalize_image
from dan_tpu.train.loop import create_train_state as jax_create_train_state
from dan_tpu.train.loop import make_train_step as jax_make_train_step
from dan_tpu_torch.api import Detector
from dan_tpu_torch.config import default_config, from_reference
from dan_tpu_torch.eval.tta import TTARunner
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.models.reference_init import init_reference_params
from dan_tpu_torch.quant import QuantizedDetector
from dan_tpu_torch.tools import bench, bench_int8, bench_train, bench_tta_dataset
from dan_tpu_torch.tools.entry import entry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = jax_config.DANConfig(
    model=jax_config.ModelConfig(image_size=64, compute_dtype="float32"),
    preprocess=jax_config.PreprocessConfig(train_image_size=64, canvas_size=128),
    match=jax_config.MatchConfig(max_gt=8),
    # The reference's CPU configuration (bench.py:190-194): no Pallas NMS.
    postprocess=jax_config.PostprocessConfig(pre_nms_topk=64, max_detections=16,
                                             use_pallas_nms=False),
    tta=jax_config.TTAConfig(buckets=(64, 128)),
    train=jax_config.TrainConfig(batch_size=2),
)
TCFG = from_reference(JCFG)
PAIRS = [(tb, vb) for tb in (4, 16, 32) for vb in (32, 128)]


def _ref_script(name):
    spec = importlib.util.spec_from_file_location(
        f"ref_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref_tta_bench = _ref_script("bench_tta_dataset")


@pytest.fixture(autouse=True)
def _plain_cpu_conv():
    # PyTorch's plain CPU convolution is as accurate as XLA's; its oneDNN
    # path is 2-3x less so (see test_torch_model.py).
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


@pytest.fixture(scope="module")
def params():
    """init_detector_params(PRNGKey(0)) of the small config, drawn once."""
    return init_reference_params(0, TCFG.model)


def test_detect_fn_matches_the_reference_bench(params):
    """tools/bench.py's build_detect_fn on the CPU against bench.py's on the
    same weights and the same numpy images (4 of 64x64)."""
    images = bench.bench_images(TCFG, 4)
    cpu = jax.devices("cpu")[0]
    want = ref_bench.build_detect_fn(JCFG, cpu)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(images))
    model = Detector.from_jax_params(params, TCFG, "cpu").model
    got = bench.build_detect_fn(TCFG, "cpu")(model, torch.from_numpy(images))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert int(got["valid"].sum()) > 0
    np.testing.assert_allclose(got["bboxes"].numpy(), np.asarray(want["bboxes"]),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=1e-4, atol=1e-6)


def test_bench_images_are_the_reference_images():
    """bench.py:228's draw, for the default config's size and batch."""
    cfg = default_config()
    got = bench.bench_images(cfg, 2)
    size = cfg.model.image_size
    want = np.random.default_rng(0).integers(0, 255, (2, size, size, 3), dtype=np.uint8)
    np.testing.assert_array_equal(got, want)


def test_synth_sizes_equal_the_reference():
    assert bench_tta_dataset.synth_sizes(300, 0) == ref_tta_bench.synth_sizes(300, 0)
    assert bench_tta_dataset.synth_sizes(48, 3) == ref_tta_bench.synth_sizes(48, 3)


@pytest.fixture(scope="module")
def default_runners():
    """The port's and the JAX package's TTARunner at the default config (the
    arithmetic reads their config and bucket_chunk only)."""
    return (TTARunner(DANDetector(default_config().model), default_config(), device="cpu"),
            JaxTTARunner(None, jax_config.default_config()))


@pytest.mark.parametrize("tta_batch,vote_batch", PAIRS)
def test_launch_counts_equal_the_reference(default_runners, tta_batch, vote_batch):
    port, ref = default_runners
    sizes = bench_tta_dataset.synth_sizes(300, 0)
    got = bench_tta_dataset.launch_counts(sizes, port, tta_batch, port._vote_chunk(1, vote_batch))
    want = ref_tta_bench.launch_counts(sizes, ref, tta_batch, ref._vote_chunk(1, vote_batch))
    assert got == want


def test_tta_sweep_counts_equal_last_run_stats(params, capsys):
    """A 3-image sweep at 2 x 2 pairs on the CPU: every row's counts equal
    the runner's own record of the run, and the printed rows the returned
    ones."""
    stats = []

    def measure(runner, sizes, images, tb, vb):
        row = bench_tta_dataset.measure_pair(runner, sizes, images, tb, vb)
        stats.append(dict(runner.last_run_stats))
        return row

    args = bench_tta_dataset.parse_args(["--images", "3", "--tta_batches", "1,4",
                                         "--vote_batches", "1,2", "--device", "cpu"])
    rows = bench_tta_dataset.run(args, TCFG, params, measure)
    out, err = capsys.readouterr()
    assert [json.loads(line) for line in out.strip().splitlines()] == rows
    assert json.loads(err.strip().splitlines()[-1]) == {"rows": rows}
    assert [(r["tta_batch"], r["vote_batch"]) for r in rows] == [(1, 1), (1, 2), (4, 1), (4, 2)]
    for row, s in zip(rows, stats):
        assert set(row) == {"tta_batch", "vote_batch", "images", "seconds", "img_per_s",
                            "bucket_launches", "vote_launches", "units", "groups"}
        assert row["images"] == s["images"] == 3
        assert row["units"] == s["variants"]
        assert row["bucket_launches"] == s["bucket_launches"]
        assert row["vote_launches"] == s["vote_launches"] == -(-3 // row["vote_batch"])
    assert rows[0]["bucket_launches"] == rows[0]["units"] > rows[2]["bucket_launches"]


def test_read_cpu_baseline_never_raises(tmp_path, monkeypatch):
    """Every malformation that tests/unit/test_bench_baseline_cache.py covers
    returns (None, reason)."""
    cache = tmp_path / "cache.json"
    monkeypatch.setattr(bench, "CPU_BASELINE_CACHE", str(cache))

    def check():
        ips, reason = bench.read_cpu_baseline("feedfacefeedface")
        assert ips is None and isinstance(reason, str) and reason
        return reason

    assert "missing" in check()
    cache.write_bytes(b"\x80not json")
    assert "unreadable" in check()
    cache.write_text("[1, 2, 3]")
    assert "not a JSON object" in check()
    cache.write_text(json.dumps({"batch": bench.BATCH + 1, "config_fp": "feedfacefeedface"}))
    assert "batch" in check()
    cache.write_text(json.dumps({"batch": bench.BATCH, "config_fp": "0000000000000000",
                                 "images_per_sec": 1.0}))
    assert "stale" in check()
    for bad_ips in (None, 0, -1.0, "fast", True):
        cache.write_text(json.dumps({"batch": bench.BATCH, "config_fp": "feedfacefeedface",
                                     "images_per_sec": bad_ips}))
        assert "images_per_sec" in check()
    cache.write_text(json.dumps({"batch": bench.BATCH, "config_fp": "feedfacefeedface",
                                 "images_per_sec": 0.178}))
    assert bench.read_cpu_baseline("feedfacefeedface") == (0.178, None)


def test_bench_main_on_the_cpu_prints_one_line_then_measures_the_baseline(
        params, tmp_path, monkeypatch, capsys):
    """With DAN_BENCH_ALLOW_CPU=1: exactly one JSON line with the four keys
    and vs_baseline null (no cache); DAN_BENCH_MEASURE_CPU=1 then writes the
    port's own cache, which the next run divides by."""
    monkeypatch.setattr(bench, "CPU_BASELINE_CACHE", str(tmp_path / "baseline.json"))
    monkeypatch.setattr(bench, "BATCH", 2)
    monkeypatch.setattr(bench, "MEASURE_ITERS", 1)
    monkeypatch.setenv("DAN_BENCH_ALLOW_CPU", "1")
    monkeypatch.setenv("DAN_BENCH_MEASURE_CPU", "1")
    assert bench.main(TCFG, params) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    head = json.loads(lines[0])
    assert set(head) == {"metric", "value", "unit", "vs_baseline"}
    assert head["metric"] == "images_per_sec_per_chip_640x640_inference"
    assert head["unit"] == "images/sec/chip" and head["value"] > 0 and head["vs_baseline"] is None
    cached = json.loads((tmp_path / "baseline.json").read_text())
    assert cached["batch"] == 2 and cached["config_fp"] == bench.config_fingerprint(TCFG)
    ips, reason = bench.read_cpu_baseline(bench.config_fingerprint(TCFG))
    assert reason is None and ips == cached["images_per_sec"] > 0
    monkeypatch.delenv("DAN_BENCH_MEASURE_CPU")
    assert bench.main(TCFG, params) == 0
    head = json.loads(capsys.readouterr().out.strip())
    assert isinstance(head["vs_baseline"], float) and head["vs_baseline"] > 0
    assert bench.read_cpu_baseline(bench.config_fingerprint(default_config()))[0] is None


def test_bench_without_a_card_exits_5_and_prints_no_number():
    env = {k: v for k, v in os.environ.items()
           if k not in ("DAN_BENCH_ALLOW_CPU", "DAN_BENCH_MEASURE_CPU")}
    proc = subprocess.run(
        [sys.executable, "-m", "dan_tpu_torch.tools.bench"], cwd=REPO,
        env=dict(env, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 5, proc.stderr[-2000:]
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_bench_train_prints_the_reference_line(params, capsys):
    assert bench_train.main(["--batch", "2", "--iters", "1", "--device", "cpu"],
                            TCFG, params) == 0
    out, err = capsys.readouterr()
    line = out.strip().splitlines()[-1]
    assert line.startswith("train batch=2/chip x 1 chip(s): ")
    assert line.endswith(" ms/step)") and " img/s/chip (" in line
    assert "compile+first:" in err


@pytest.mark.parametrize("skip_bf16", [False, True])
def test_bench_int8_prints_the_reference_line(params, capsys, skip_bf16):
    argv = ["--batch", "2", "--iters", "1", "--device", "cpu"] + (["--skip_bf16"] * skip_bf16)
    assert bench_int8.main(argv, TCFG, params) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    if skip_bf16:
        assert line.startswith("int8 ") and line.endswith(" img/s/chip")
    else:
        assert line.startswith("bf16 ") and " -> int8 " in line and line.endswith("x)")


def test_bench_train_first_loss_matches_the_reference(params):
    """bench_train.run's first step (the PRNGKey(0) tree loaded into the
    train state, synthetic_batch(seed=0)) against the reference's on the
    same batch: create_train_state(PRNGKey(0)) and one jitted train step
    (scripts/bench_train.py's, on one device).  Colour distortion and flip
    are off: the two packages draw them from different generators
    (test_torch_train_step.py).  The loss at that test's rtol 1e-4."""
    jcfg = dataclasses.replace(JCFG, preprocess=dataclasses.replace(
        JCFG.preprocess, color_distort_prob=0.0, flip_prob=0.0))
    args = bench_train.parse_args(["--batch", "2", "--iters", "1", "--device", "cpu"])
    got = bench_train.run(args, from_reference(jcfg), params)
    _, metrics = jax.jit(jax_make_train_step(jcfg, None))(
        jax_create_train_state(jcfg, jax.random.PRNGKey(0)), synthetic_batch(jcfg, 2, seed=0))
    assert float(metrics["num_pos"]) > 0
    np.testing.assert_allclose(got["loss"], float(metrics["loss"]), rtol=1e-4)


def test_bench_int8_calibration_and_detections_match_the_reference(params):
    """bench_int8.quantize on 9 bench images (it calibrates on the first 8)
    and the int8 detect path on 2 of them, against scripts/bench_int8.py's
    steps on the same weights and images: calibrate_act_scales over the
    first 8, normalized in the compute dtype; the jitted
    quantize_detector_params; quantized_detector_forward + postprocess.
    Scales within 1e-5 of each vector's largest entry (test_torch_quant.py;
    measured 1.7e-6: the float32 statistics forwards sum in other orders).
    Scales that close still flip the rounding of some s8 activations, which
    moves this random-weight model's logits by ~1 % (relative L2), so the
    detections are compared on the reference's scales, at the detect path's
    tolerance (measured: boxes 4e-6, scores 2e-7)."""
    images = bench.bench_images(TCFG, 9)
    model = Detector.from_jax_params(params, TCFG, "cpu").model
    scales, qmodel = bench_int8.quantize(TCFG, model, torch.from_numpy(images))
    assert isinstance(qmodel, QuantizedDetector)

    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    x_cal = jax_normalize_image(jnp.asarray(images[:8]).astype(jnp.float32),
                                JCFG.preprocess).astype(jnp.dtype(JCFG.model.compute_dtype))
    want_scales = jax_quant.calibrate_act_scales(jparams, [x_cal], JCFG.model)
    assert set(scales) == set(want_scales)
    for name, s in scales.items():
        want = np.asarray(want_scales[name])
        assert s.shape == want.shape, name
        assert np.abs(s.astype(np.float64) - want).max() <= 1e-5 * want.max(), name
    qmodel = QuantizedDetector(model, {k: np.asarray(v) for k, v in want_scales.items()})
    got = bench.build_detect_fn(TCFG, "cpu")(qmodel.eval(), torch.from_numpy(images[:2]))
    qparams = jax.jit(lambda p: jax_quant.quantize_detector_params(
        p, JCFG.model, want_scales))(jparams)
    size = JCFG.model.image_size
    anchors = jnp.asarray(generate_anchors_np(JCFG.anchors, size, size))
    x = jax_normalize_image(jnp.asarray(images[:2]).astype(jnp.float32), JCFG.preprocess)
    cls, loc = jax_quant.quantized_detector_forward(qparams, x, JCFG.model)
    want = jax_postprocess_batch(cls, loc, anchors, JCFG.anchors, JCFG.postprocess,
                                 float(size), float(size))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert int(got["valid"].sum()) > 0
    np.testing.assert_allclose(got["bboxes"].numpy(), np.asarray(want["bboxes"]),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=1e-4, atol=1e-6)


def test_bench_int8_without_a_card_exits_5(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_int8.main([]) == 5
    assert capsys.readouterr().out == ""


def test_entry_matches_graft_entry(params, monkeypatch):
    """entry()'s forward on the CPU against __graft_entry__.entry()'s, both
    at the small config (the reference reads default_config()), on the
    example zero image and on a seeded normalized one."""
    monkeypatch.setattr(jax_config, "default_config", lambda: JCFG)
    jfn, (jparams, jimages) = __graft_entry__.entry()
    fn, (model, images) = entry(TCFG, device="cpu", params=params)
    assert images.shape == tuple(jimages.shape) == (1, 64, 64, 3)
    assert images.dtype == torch.float32 and not images.any()
    x = np.random.default_rng(5).normal(0.0, 60.0, (1, 64, 64, 3)).astype(np.float32)
    for want, got in ((jfn(jparams, jimages), fn(model, images)),
                      (jfn(jparams, jnp.asarray(x)), fn(model, torch.from_numpy(x)))):
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=5e-4)
