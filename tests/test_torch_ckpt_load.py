"""The port's checkpoint loading: ckpt/load.py's dispatch over every format
(TF1 prefix, .npz, .pt, model_dir), the refusals (an orbax directory, another
architecture), scripts/export_params_npz.py against orbax_io.restore_params,
Detector.from_checkpoint against the JAX package's on the same prefix, the
convert CLI, and the train CLI's --warm_start.  The tiny configs have the
default widths (77 tensors, 95.9 MB) at 64x64."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from dan_tpu.api import Detector as JaxDetector
from dan_tpu.ckpt.orbax_io import restore_params, save_params, save_train_state
from dan_tpu.config import DANConfig as JaxDANConfig
from dan_tpu.config import ModelConfig as JaxModelConfig
from dan_tpu.config import PostprocessConfig as JaxPostprocessConfig
from dan_tpu.config import TTAConfig as JaxTTAConfig
from dan_tpu.models.detector import init_detector_params
from dan_tpu.train.loop import create_train_state as jax_create_train_state
from dan_tpu_torch.api import Detector
from dan_tpu_torch.ckpt import train_state as ckpt
from dan_tpu_torch.ckpt.bridge import params_from_jax, params_to_jax
from dan_tpu_torch.ckpt.load import load_npz, load_params, save_npz
from dan_tpu_torch.ckpt.tf_import import export_tf_checkpoint
from dan_tpu_torch.config import (
    DANConfig,
    MatchConfig,
    ModelConfig,
    PreprocessConfig,
    TrainConfig,
    from_reference,
)
from dan_tpu_torch.data.synthetic import synthetic_batch
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.train import __main__ as train_cli
from dan_tpu_torch.train.loop import create_train_state, train_step

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _plain_cpu_conv():
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


def tiny() -> DANConfig:
    return DANConfig(
        model=ModelConfig(image_size=64, compute_dtype="float32"),
        preprocess=PreprocessConfig(train_image_size=64, canvas_size=128),
        match=MatchConfig(max_gt=8), train=TrainConfig(batch_size=2),
    )


@pytest.fixture(scope="module")
def source():
    """A seeded detector's state_dict and the same weights as a JAX tree."""
    sd = DANDetector(tiny().model, torch.Generator().manual_seed(5)).state_dict()
    return sd, params_to_jax(sd)


@pytest.fixture(scope="module")
def prefix(source, tmp_path_factory):
    p = str(tmp_path_factory.mktemp("tf") / "dan.ckpt")
    export_tf_checkpoint(source[1], p)
    return p


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k]), k


def test_load_params_reads_every_format(source, prefix, tmp_path):
    sd, tree = source
    cfg = tiny()
    npz = str(tmp_path / "p.npz")
    save_npz(tree, npz)
    pt = str(tmp_path / "w.pt")
    torch.save({"model": sd}, pt)
    state = create_train_state(cfg, 0, "cpu")
    state.model.load_state_dict(sd)
    step_file = ckpt.save(str(tmp_path / "run"), 4, state)
    bare = str(tmp_path / "bare")  # a prefix with neither .ckpt nor .ckpt- in it
    export_tf_checkpoint(tree, bare)
    for path in (prefix, bare, npz, pt, step_file, str(tmp_path / "run")):
        _assert_state_equal(load_params(path, cfg, verbose=False), sd)
    loaded = load_npz(npz)
    assert sorted(loaded) == sorted(tree) and all(
        np.array_equal(loaded[g][n][leaf], v) for g in tree for n in tree[g]
        for leaf, v in tree[g][n].items())


def test_orbax_directories_raise_and_name_the_exporter(source, tmp_path):
    save_params(str(tmp_path / "orbax"), source[1])
    os.makedirs(tmp_path / "run" / "step_00000010")
    for path in (tmp_path / "orbax", tmp_path / "run", tmp_path / "orbax" / "params"):
        with pytest.raises(ValueError, match="orbax.*scripts/export_params_npz.py"):
            load_params(str(path), tiny())
    with pytest.raises(FileNotFoundError):
        load_params(str(tmp_path / "nothing.pt"), tiny())
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        load_params(str(tmp_path / "empty"), tiny())


def test_another_architecture_raises_with_the_names(tmp_path):
    other = dataclasses.replace(tiny().model, fc7_channels=512)
    sd = DANDetector(other).state_dict()
    npz, pt = str(tmp_path / "o.npz"), str(tmp_path / "o.pt")
    save_npz(params_to_jax(sd), npz)
    torch.save({"model": sd}, pt)
    for path in (npz, pt):
        with pytest.raises(ValueError, match=r"shape mismatches.*backbone\.fc7\.weight"):
            load_params(path, tiny())
    partial = {k: v for k, v in sd.items() if not k.startswith("heads.")}
    torch.save({"model": partial}, pt)
    with pytest.raises(ValueError, match=r"24 missing \['heads\.cls_conv3_3\.bias'"):
        load_params(pt, dataclasses.replace(tiny(), model=other))
    extra = dict(DANDetector(tiny().model).state_dict(), **{"heads.extra.weight": torch.ones(1)})
    torch.save({"model": extra}, pt)
    with pytest.raises(ValueError, match=r"1 extra \['heads\.extra\.weight'\]"):
        load_params(pt, tiny())


def _jax_tiny():
    return JaxDANConfig(model=JaxModelConfig(image_size=64))


def _export(ckpt_path, out):
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "export_params_npz.py"),
         "--ckpt", ckpt_path, "--out", out], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "wrote 77 arrays" in proc.stdout


def test_export_params_npz_script_equals_restore_params(tmp_path):
    """The exporter on a save_params directory and on a train model_dir of
    save_train_state: its .npz loads bit-identically to restore_params."""
    cfg = _jax_tiny()
    params = init_detector_params(jax.random.PRNGKey(7), cfg.model)
    save_params(str(tmp_path / "p"), params)
    state = jax_create_train_state(cfg, jax.random.PRNGKey(8))
    # save_train_state writes in the background and lists its root at once:
    # the root must exist first, as a train model_dir does.
    os.makedirs(tmp_path / "run")
    save_train_state(str(tmp_path / "run"), 3, state)
    for src in ("p", "run"):
        out = str(tmp_path / f"{src}.npz")
        _export(str(tmp_path / src), out)
        want = jax.tree_util.tree_map(np.asarray, restore_params(str(tmp_path / src)))
        got = load_npz(out)
        assert sorted(got) == sorted(want)
        for g in want:
            for layer, leaves in want[g].items():
                for leaf, w in leaves.items():
                    v = got[g][layer][leaf]
                    assert v.dtype == w.dtype and np.array_equal(v, w), (src, g, layer, leaf)
        _assert_state_equal(load_params(out, from_reference(cfg)), params_from_jax(want))


def test_from_checkpoint_detects_as_jax(tmp_path):
    """Detector.from_checkpoint on a TF prefix against the JAX package's on the
    same prefix: the config of tests/parity/test_tf_import.py, float32."""
    jcfg = JaxDANConfig(
        model=JaxModelConfig(image_size=64, compute_dtype="float32"),
        postprocess=JaxPostprocessConfig(pre_nms_topk=64, max_detections=8),
        tta=JaxTTAConfig(buckets=(64, 128)),
    )
    params = init_detector_params(jax.random.PRNGKey(3), jcfg.model)
    prefix = str(tmp_path / "ref.ckpt")
    export_tf_checkpoint(jax.tree_util.tree_map(np.asarray, params), prefix)
    want_det = JaxDetector.from_checkpoint(prefix, jcfg)
    det = Detector.from_checkpoint(prefix, from_reference(jcfg), device="cpu")
    assert det.device.type == "cpu"
    rng = np.random.default_rng(0)
    for shape in ((60, 70, 3), (128, 90, 3)):
        img = rng.integers(0, 255, shape, dtype=np.uint8)
        got, want = det.detect(img), want_det.detect(img)
        assert got["bboxes"].shape == want["bboxes"].shape and len(got["scores"]) > 0
        np.testing.assert_allclose(got["bboxes"], want["bboxes"], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4, atol=1e-6)


def _convert(*args):
    return subprocess.run([sys.executable, "-m", "dan_tpu_torch.ckpt.convert", *args], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))


def test_convert_cli_round_trips_bit_for_bit(source, prefix, tmp_path):
    out = str(tmp_path / "sub" / "w.pt")
    proc = _convert("--tf_ckpt", prefix, "--out", out, "--strict")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "placed 77 params" in proc.stdout and "wrote 77 tensors" in proc.stdout
    _assert_state_equal(torch.load(out, weights_only=True)["model"], source[0])
    _assert_state_equal(load_params(out, tiny()), source[0])


def test_convert_cli_strict_refuses_a_partial_bundle(source, tmp_path):
    tree = {g: dict(v) for g, v in source[1].items()}
    del tree["heads"]["cls_conv3_3"]
    partial = str(tmp_path / "partial.ckpt")
    export_tf_checkpoint(tree, partial)
    proc = _convert("--tf_ckpt", partial, "--out", str(tmp_path / "s.pt"), "--strict")
    assert proc.returncode != 0 and "strict import failed: 2 model params unplaced" in proc.stderr
    assert not os.path.exists(tmp_path / "s.pt")
    proc = _convert("--tf_ckpt", partial, "--out", str(tmp_path / "n.pt"))
    assert proc.returncode == 0 and "2 model params left at init" in proc.stdout
    got = torch.load(tmp_path / "n.pt", weights_only=True)["model"]
    assert torch.equal(got["heads.loc_conv3_3.weight"], source[0]["heads.loc_conv3_3.weight"])
    # The uncovered leaves get the JAX package's init_detector_params(PRNGKey(0)):
    # the heads' key, then the first of its 12 convs, drawn here by JAX itself.
    k_heads = jax.random.split(jax.random.PRNGKey(0), 3)[2]
    shape = (3, 3, 256, 4)  # conv3_3's head: 256 channels in, 3 background + 1 face out
    init = np.asarray(jax.random.normal(jax.random.split(k_heads, 12)[0], shape)
                      * (2.0 / (9 * 256)) ** 0.5)
    kernel = got["heads.cls_conv3_3.weight"].permute(2, 3, 1, 0).numpy()
    ulps = np.abs(kernel.view(np.int32).astype(np.int64) - init.view(np.int32).astype(np.int64))
    assert kernel.shape == shape and ulps.max() <= 4
    assert not got["heads.cls_conv3_3.bias"].any()


def _losses(model_dir):
    with open(os.path.join(model_dir, "train_metrics.jsonl")) as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f)]


def _warm_args(prefix, model_dir, steps, *extra):
    return train_cli.parse_args([
        "--synthetic", "--warm_start", prefix, "--steps", str(steps), "--model_dir", model_dir,
        "--log_every", "1", "--checkpoint_every", "1", "--device", "cpu", *extra])


def test_train_warm_start_then_resume(source, prefix, tmp_path):
    """Two CPU steps of the train CLI warm-started from the TF prefix at the
    tiny config: step 1's loss is the checkpoint's weights' loss on the
    first batch; a --resume run continues the step-2 checkpoint."""
    cfg = dataclasses.replace(tiny(), train=dataclasses.replace(
        tiny().train, warmup_steps=50, grad_clip_norm=10.0))
    d = str(tmp_path / "run")
    assert train_cli.train(_warm_args(prefix, d, 2), cfg, None) == 0
    state = create_train_state(cfg, 0, "cpu")
    state.model.load_state_dict(source[0])
    want = float(train_step(state, synthetic_batch(cfg, 2, seed=0))["loss"])
    got = _losses(d)
    assert [s for s, _ in got] == [1, 2] and got[0][1] == want
    step2 = ckpt.load_model_weights(d)
    assert train_cli.train(_warm_args(prefix, d, 3, "--resume"), cfg, None) == 0
    assert [s for s, _ in _losses(d)] == [1, 2, 3] and ckpt.latest_step(d) == 3
    # Step 3 continued step 2's weights and momentum, not the warm start.
    state = create_train_state(cfg, 0, "cpu")
    ckpt.restore(d, state, step=2)
    assert all(torch.equal(state.model.state_dict()[k], v) for k, v in step2.items())
    m = train_step(state, synthetic_batch(cfg, 2, seed=2))
    assert float(m["loss"]) == _losses(d)[-1][1]


def test_warm_start_keeps_the_reference_recipe():
    """The --synthetic warm-up and clip defaults are for random init only."""
    base = ["--synthetic", "--model_dir", "d"]
    cfg = train_cli.make_config(train_cli.parse_args(base + ["--warm_start", "x.npz"]))
    assert (cfg.train.warmup_steps, cfg.train.grad_clip_norm) == (0, 0.0)
    cfg = train_cli.make_config(train_cli.parse_args(
        base + ["--warm_start", "x.npz", "--warmup_steps", "5", "--grad_clip", "3"]))
    assert (cfg.train.warmup_steps, cfg.train.grad_clip_norm) == (5, 3.0)
    cfg = train_cli.make_config(train_cli.parse_args(base))
    assert (cfg.train.warmup_steps, cfg.train.grad_clip_norm) == (50, 10.0)


def _train_cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "dan_tpu_torch.train", "--synthetic", "--device", "cpu", *args],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))


def test_train_cli_warm_start_in_a_subprocess(tmp_path):
    """`python -m dan_tpu_torch.train --warm_start ... --device cpu` at its
    default config, without a forward: a checkpoint of another architecture
    fails before the first step, naming the mismatch; with --resume and a
    checkpoint already at --steps, the warm start is not even read."""
    other = dataclasses.replace(tiny().model, fc7_channels=512)
    pt = str(tmp_path / "other.pt")
    torch.save({"model": DANDetector(other).state_dict()}, pt)
    proc = _train_cli("--warm_start", pt, "--steps", "1", "--model_dir", str(tmp_path / "a"))
    assert proc.returncode != 0
    assert "does not match the config's detector" in proc.stderr
    assert "backbone.fc7.weight" in proc.stderr
    run = str(tmp_path / "run")
    ckpt.save(run, 1, create_train_state(tiny(), 0, "cpu"))
    proc = _train_cli("--warm_start", str(tmp_path / "absent.npz"), "--resume", "--steps", "1",
                      "--model_dir", run)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "resumed from step 1" in proc.stderr and "warm-started" not in proc.stderr
