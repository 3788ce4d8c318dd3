"""The train CLI's --trace_dir and --debug_nans (counterparts of
scripts/train.py's flags) and its log record, on the CPU: the trace file is
written, the log keys are the reference's (images_per_sec_per_chip), a NaN
injected into one parameter makes --debug_nans raise naming the module
before any update and with no checkpoint written, a non-finite loss writes
its record before exit 6, and train_step(debug_nans=True) leaves a clean
step's numbers as they are.  train() ends its data threads (the prefetch
stream's, a TrainPipeline's producers) before it returns or raises, and
main() tears the process group down only after that."""
import json
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from dan_tpu.config import ModelConfig as JaxModelConfig
from dan_tpu.config import DANConfig as JaxDANConfig
from dan_tpu.config import MatchConfig as JaxMatchConfig
from dan_tpu.config import PreprocessConfig as JaxPreprocessConfig
from dan_tpu.config import TrainConfig as JaxTrainConfig
from dan_tpu.data.synthetic import synthetic_batch as jax_synthetic_batch
from dan_tpu.train.loop import create_train_state as jax_create_train_state
from dan_tpu.train.loop import make_train_step
from dan_tpu_torch.config import DANConfig, MatchConfig, ModelConfig, PreprocessConfig, TrainConfig
from dan_tpu_torch.data.synthetic import synthetic_batch
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.parallel import mesh as pmesh
from dan_tpu_torch.train import __main__ as train_cli
from dan_tpu_torch.train.loop import check_finite, create_train_state, train_step
from dan_tpu_torch.utils.profiling import trace_path

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "mini_wider")


def tiny(batch=2, **train):
    return DANConfig(
        model=ModelConfig(image_size=64, compute_dtype="float32"),
        preprocess=PreprocessConfig(train_image_size=64, canvas_size=128),
        match=MatchConfig(max_gt=8), train=TrainConfig(batch_size=batch, **train),
    )


def _records(model_dir):
    path = os.path.join(model_dir, "train_metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f]


def _args(model_dir, *extra):
    return train_cli.parse_args(["--synthetic", "--model_dir", model_dir, "--log_every", "1",
                                 "--checkpoint_every", "1", "--device", "cpu", *extra])


def test_log_keys_are_the_reference_keys(tmp_path):
    """The record's keys: step, time, the JAX train step's metrics and
    images_per_sec_per_chip, as scripts/train.py writes them."""
    d = str(tmp_path / "run")
    cfg = tiny(warmup_steps=50, grad_clip_norm=10.0)
    assert train_cli.train(_args(d, "--steps", "2"), cfg, None) == 0
    recs = _records(d)
    jcfg = JaxDANConfig(model=JaxModelConfig(image_size=64, compute_dtype="float32"),
                        preprocess=JaxPreprocessConfig(train_image_size=64, canvas_size=128),
                        match=JaxMatchConfig(max_gt=8), train=JaxTrainConfig(batch_size=2))
    state = jax_create_train_state(jcfg, jax.random.PRNGKey(0))
    # Traced, not run: the metrics' names only.
    _, metrics = jax.eval_shape(make_train_step(jcfg), state, jax_synthetic_batch(jcfg, 2, seed=0))
    want = ["step", "time"] + sorted(metrics) + ["images_per_sec_per_chip"]
    assert [r["step"] for r in recs] == [1, 2]
    for r in recs:
        assert sorted(r) == sorted(want) and list(r)[:2] == ["step", "time"]
        assert list(r)[-1] == "images_per_sec_per_chip" and r["images_per_sec_per_chip"] > 0
    assert "images_per_sec" not in recs[0]


def test_trace_dir_writes_a_trace(tmp_path):
    d, trace = str(tmp_path / "run"), str(tmp_path / "trace")
    assert train_cli.train(_args(d, "--steps", "1", "--trace_dir", trace), tiny(), None) == 0
    path = trace_path(trace)
    assert os.listdir(trace) == [os.path.basename(path)]
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::convolution" in names


def _poisoned(tmp_path, name="backbone.conv3_1.weight"):
    sd = DANDetector(tiny().model).state_dict()
    sd[name].view(-1)[0] = float("nan")
    pt = str(tmp_path / "nan.pt")
    torch.save({"model": sd}, pt)
    return pt


def test_debug_nans_names_the_module_and_saves_nothing(tmp_path):
    d = str(tmp_path / "run")
    pt = _poisoned(tmp_path)
    args = _args(d, "--steps", "2", "--debug_nans", "--warm_start", pt,
                 "--warmup_steps", "50", "--grad_clip", "10")
    with pytest.raises(FloatingPointError, match=r"backbone\.conv3_1 \(Conv\)"):
        train_cli.train(args, tiny(warmup_steps=50, grad_clip_norm=10.0), None)
    assert not [f for f in os.listdir(d) if f.startswith("step_")] and not _records(d)


def test_debug_nans_cli_exits_non_zero(tmp_path):
    """The same through `python -m dan_tpu_torch.train` at its default
    config: a traceback naming the module, no checkpoint."""
    d = str(tmp_path / "run")
    proc = subprocess.run(
        [sys.executable, "-m", "dan_tpu_torch.train", "--synthetic", "--model_dir", d,
         "--steps", "2", "--batch_size", "2", "--checkpoint_every", "1", "--device", "cpu",
         "--debug_nans", "--warm_start", _poisoned(tmp_path, "backbone.conv4_2.bias"),
         "--warmup_steps", "50", "--grad_clip", "10"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert "FloatingPointError: debug_nans: the output of backbone.conv4_2 (Conv)" in proc.stderr
    assert not os.path.exists(d) or not [f for f in os.listdir(d) if f.startswith("step_")]


def test_debug_nans_step_changes_nothing_of_a_clean_step():
    cfg = tiny(warmup_steps=50, grad_clip_norm=10.0)
    batch = synthetic_batch(cfg, 2, seed=1)
    a, b = create_train_state(cfg, 0, "cpu"), create_train_state(cfg, 0, "cpu")
    ma, mb = train_step(a, batch), train_step(b, batch, debug_nans=True)
    assert {k: float(v) for k, v in ma.items()} == {k: float(v) for k, v in mb.items()}
    for (n, p), (_, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(p, q), n
    assert not a.model._forward_hooks and not any(m._forward_hooks for m in b.model.modules())


def test_debug_nans_leaves_the_parameters_alone():
    cfg = tiny(warmup_steps=50, grad_clip_norm=10.0)
    state = create_train_state(cfg, 0, "cpu")
    with torch.no_grad():
        state.model.heads.loc_fc7.bias[1] = float("inf")
    before = {n: p.clone() for n, p in state.model.named_parameters()}
    with pytest.raises(FloatingPointError, match="heads"):
        train_step(state, synthetic_batch(cfg, 2, seed=0), debug_nans=True)
    assert state.step == 0
    for n, p in state.model.named_parameters():
        assert torch.equal(p, before[n]) or n == "heads.loc_fc7.bias", n
    assert all(not m._forward_hooks for m in state.model.modules())


def test_check_finite_names_the_gradient():
    grads = {"a.weight": torch.ones(3), "b.bias": torch.tensor([1.0, float("nan")])}
    with pytest.raises(FloatingPointError, match="gradient of b.bias"):
        check_finite(grads, {"loss": torch.tensor(1.0)})
    with pytest.raises(FloatingPointError, match="loss is inf"):
        check_finite(grads, {"loss": torch.tensor(float("inf"))})
    check_finite({"a.weight": torch.ones(3)}, {"loss": torch.tensor(1.0)})


def test_non_finite_loss_writes_its_record_then_exits_6(tmp_path):
    d = str(tmp_path / "run")
    cfg = tiny(learning_rate=1e30)
    rc = train_cli.train(_args(d, "--steps", "3", "--lr", "1e30"), cfg, None)
    recs = _records(d)
    assert rc == 6 and recs and not np.isfinite(recs[-1]["loss"])
    assert "images_per_sec_per_chip" not in recs[-1]
    assert all(np.isfinite(r["loss"]) for r in recs[:-1])


def _data_threads(before):
    """The threads started since `before` that still run: train() starts
    only data threads (the prefetch stream's, TrainPipeline's producers and
    their decode pools)."""
    return [t.name for t in threading.enumerate() if t not in before]


def _wider_train_root(tmp_path):
    """A WIDER layout whose train split is the fixture's val split."""
    root = tmp_path / "wider"
    (root / "wider_face_split").mkdir(parents=True)
    os.symlink(os.path.join(FIX, "WIDER_val"), root / "WIDER_train")
    shutil.copy(os.path.join(FIX, "wider_face_split", "wider_face_val_bbx_gt.txt"),
                root / "wider_face_split" / "wider_face_train_bbx_gt.txt")
    return str(root)


@pytest.mark.parametrize("end", ["steps_done", "exit_6", "raises", "wider_pipeline"])
def test_train_ends_its_data_threads(tmp_path, end):
    """No prefetch, producer or decode thread outlives train(): after the
    last step, after exit 6, after a FloatingPointError, and on the WIDER
    path (TrainPipeline's producers joined)."""
    d = str(tmp_path / "run")
    before = set(threading.enumerate())
    if end == "steps_done":
        assert train_cli.train(_args(d, "--steps", "2"), tiny(), None) == 0
    elif end == "exit_6":
        assert train_cli.train(_args(d, "--steps", "3", "--lr", "1e30"),
                               tiny(learning_rate=1e30), None) == 6
    elif end == "raises":
        args = _args(d, "--steps", "2", "--debug_nans", "--warm_start", _poisoned(tmp_path))
        with pytest.raises(FloatingPointError):
            train_cli.train(args, tiny(), None)
    else:
        args = train_cli.parse_args(["--wider_root", _wider_train_root(tmp_path),
                                     "--model_dir", d, "--steps", "2", "--log_every", "1",
                                     "--device", "cpu"])
        assert train_cli.train(args, tiny(), None) == 0
        assert [r["step"] for r in _records(d)] == [1, 2]
    assert not _data_threads(before)


def test_main_tears_the_group_down_after_the_data_threads(tmp_path, monkeypatch):
    """main() on a one-rank gloo mesh: when Mesh.close destroys the process
    group, train() has already ended its data threads; the group is gone
    when main() returns."""
    before = set(threading.enumerate())
    seen = []
    close = pmesh.Mesh.close

    def spy(self, sync=True):
        seen.append((_data_threads(before), dist.is_initialized(), sync))
        close(self, sync)

    monkeypatch.setattr(pmesh.Mesh, "close", spy)
    monkeypatch.setattr(train_cli, "make_config", lambda args: tiny())
    monkeypatch.setattr(train_cli, "torchrun_mesh", lambda config, device: pmesh.make_mesh(
        config, device, backend="gloo", rank=0, world_size=1,
        init_method=f"file://{tmp_path}/pg"))
    d = str(tmp_path / "run")
    assert train_cli.main(["--synthetic", "--model_dir", d, "--steps", "2", "--log_every", "1",
                           "--device", "cpu"]) == 0
    assert seen == [([], True, True)] and not dist.is_initialized()
    assert [r["step"] for r in _records(d)] == [1, 2] and not _data_threads(before)
