"""The port's train step against the JAX package's, and on its own.

The tiny config of tests/e2e/test_train_step.py (64 px, canvas 128,
max_gt 8, batch 8, float32) with colour distortion and flip off, so both
steps are deterministic.  From one JAX create_train_state(PRNGKey(0))
carried across by the bridge (parameters and optax momentum), two steps of
the port against two of jax.jit(make_train_step(cfg, None)): metrics at
rtol 1e-4, the positive and selected-negative counts equal, parameters and
momentum at rtol 1e-4, atol 1e-6 -- the two packages sum their float32
convolutions in different orders.

The synthetic canvas is 4x-upsampled noise; the batch's identity-ish crop
resamples it 2:1 into constant 2x2 blocks, where max-pool windows hold
near-ties that those float32 differences can resolve to different pixels
(one window in 262,144 at pool2 flipped, and moved conv1/conv2 gradients by
~1e-3).  So the parity batch takes an irregular crop window instead.

Momentum is the raw gradient sum, and one more near-tie remains in it: a
conv1_1 pre-activation 9.2e-6 from zero (packed channel 88) falls on
different sides of the relu in the two packages, which moves the 27
weights of conv1_1 output channel 24 by up to 1.5e-4 of that tensor's
largest gradient.  So momentum is held at rtol 1e-4 with an atol of 2e-4
of each tensor's largest entry; the parameters (lr x momentum) hold at
rtol 1e-4, atol 1e-6.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dan_tpu.config import DANConfig, MatchConfig, ModelConfig, PreprocessConfig, TrainConfig
from dan_tpu.data.synthetic import synthetic_batch
from dan_tpu.train.loop import create_train_state as jax_create
from dan_tpu.train.loop import make_train_step
from dan_tpu_torch.ckpt import train_state as ckpt
from dan_tpu_torch.config import from_reference
from dan_tpu_torch.ckpt.bridge import opt_state_from_jax, params_from_jax, params_to_jax
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.train import TrainState, create_train_state, train_step
from dan_tpu_torch.train.__main__ import make_config, parse_args

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


def tiny_config(**pre) -> DANConfig:
    return DANConfig(
        model=ModelConfig(image_size=64, compute_dtype="float32"),
        preprocess=PreprocessConfig(train_image_size=64, canvas_size=128, **pre),
        match=MatchConfig(max_gt=8),
        train=TrainConfig(batch_size=8, learning_rate=1e-3, hnm_min_negatives=8,
                          lr_boundaries=(1000,), lr_factors=(1.0, 0.1)),
    )


def parity_batch(cfg, seed):
    batch = synthetic_batch(cfg, 8, seed=seed)
    batch["crop_x0"][:] = 7.0
    batch["crop_size"][:] = 111.0
    return batch


def state_from_jax(js, cfg) -> TrainState:
    model = DANDetector(cfg.model)
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, js.params)))
    momentum, count = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js.opt_state))
    return TrainState(model=model, momentum=momentum, step=count, config=cfg)


def test_two_steps_match_jax():
    cfg = tiny_config(color_distort_prob=0.0, flip_prob=0.0)
    js = jax_create(cfg, jax.random.PRNGKey(0))
    state = state_from_jax(js, cfg)
    step = jax.jit(make_train_step(cfg, None))
    for i in range(2):
        batch = parity_batch(cfg, i)
        js, jm = step(js, batch)
        tm = train_step(state, batch)
        assert set(tm) == set(jm)
        for k in ("num_pos", "num_neg_selected"):
            assert float(tm[k]) == float(jm[k]) > 0
        for k in ("loss", "cls_loss", "loc_loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert state.step == int(js.step) == 2
    want_p = params_from_jax(jax.tree_util.tree_map(np.asarray, js.params))
    want_m, count = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js.opt_state))
    assert count == 2
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        want = want_m[name].numpy()
        np.testing.assert_allclose(state.momentum[name].numpy(), want, rtol=1e-4,
                                   atol=2e-4 * np.abs(want).max(), err_msg=name)
    # And back: the port's momentum in the JAX tree layout.
    tree = params_to_jax(state.momentum)
    assert tree["backbone"]["conv1_1"]["kernel"].shape == (3, 3, 3, 64)


def test_loss_decreases_and_padding_batch_stays_finite():
    cfg = tiny_config()
    state = create_train_state(from_reference(cfg), seed=0, device="cpu")
    batch = synthetic_batch(cfg, 8, seed=0)
    losses = [float(train_step(state, batch)["loss"]) for _ in range(6)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
    empty = dict(batch, boxes=np.zeros_like(batch["boxes"]), mask=np.zeros_like(batch["mask"]))
    m = train_step(state, empty)
    assert float(m["num_pos"]) == 0
    assert all(np.isfinite(float(v)) for v in m.values())
    assert all(torch.isfinite(p).all() for p in state.model.parameters())


def test_save_restore_resume_is_bit_identical(tmp_path):
    """3 steps straight == 2 steps + save + restore into a fresh state + 1."""
    cfg = tiny_config()
    batches = [synthetic_batch(cfg, 8, seed=i) for i in range(3)]
    straight = create_train_state(from_reference(cfg), seed=0, device="cpu")
    for b in batches:
        train_step(straight, b)
    first = create_train_state(from_reference(cfg), seed=0, device="cpu")
    for b in batches[:2]:
        train_step(first, b)
    ckpt.save(str(tmp_path), first.step, first)
    assert ckpt.latest_step(str(tmp_path)) == 2
    resumed = ckpt.restore(str(tmp_path), create_train_state(from_reference(cfg), seed=1, device="cpu"))
    assert resumed.step == 2
    train_step(resumed, batches[2])
    assert resumed.step == straight.step == 3
    for (name, a), b in zip(straight.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(a, b), name
        assert torch.equal(straight.momentum[name], resumed.momentum[name]), name


def test_checkpoints_keep_the_newest_five(tmp_path):
    cfg = tiny_config()
    state = create_train_state(from_reference(cfg), seed=0, device="cpu")
    for step in range(1, 8):
        ckpt.save(str(tmp_path), step, state)
    names = sorted(os.listdir(tmp_path))
    assert names == [f"step_{s:08d}.pt" for s in range(3, 8)]
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), state)


def test_cli_recipe_matches_scripts_train():
    """--synthetic from random init gets warm-up 50 and clip 10 unless
    given; explicit flags win."""
    cfg = make_config(parse_args(["--synthetic", "--model_dir", "d"]))
    assert (cfg.train.warmup_steps, cfg.train.grad_clip_norm) == (50, 10.0)
    cfg = make_config(parse_args(["--synthetic", "--model_dir", "d", "--grad_clip", "0",
                                  "--warmup_steps", "0", "--batch_size", "4", "--lr", "0.01"]))
    assert (cfg.train.warmup_steps, cfg.train.grad_clip_norm) == (0, 0.0)
    assert (cfg.train.batch_size, cfg.train.learning_rate) == (4, 0.01)
    cfg = make_config(parse_args(["--wider_root", "w", "--model_dir", "d"]))
    assert (cfg.train.warmup_steps, cfg.train.grad_clip_norm) == (0, 0.0)


def test_train_runs_without_jax():
    """`import dan_tpu_torch.train` plus one tiny CPU step leaves JAX
    unimported."""
    code = (
        "import sys\n"
        "from dan_tpu_torch.config import DANConfig, MatchConfig, ModelConfig, PreprocessConfig, TrainConfig\n"
        "from dan_tpu_torch.data.synthetic import synthetic_batch\n"
        "import dan_tpu_torch.train as t\n"
        "cfg = DANConfig(model=ModelConfig(image_size=64, compute_dtype='float32'),\n"
        "                preprocess=PreprocessConfig(train_image_size=64, canvas_size=128),\n"
        "                match=MatchConfig(max_gt=8), train=TrainConfig(batch_size=2))\n"
        "s = t.create_train_state(cfg, device='cpu')\n"
        "m = t.train_step(s, synthetic_batch(cfg, 2, seed=0))\n"
        "assert s.step == 1 and float(m['loss']) > 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dan_tpu'))\n"
        "assert not bad, bad\n"
        "print('no-jax-ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "no-jax-ok" in proc.stdout
