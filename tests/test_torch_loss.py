"""The port's loss and optimizer against the JAX package: HNM selection
(ties, k = 0, images without positives, all-ignore rows), the detection
loss and its metrics, the LR schedule around its boundaries and through
the warm-up, and one SGD step with and without clipping.

Selections and counts must be identical; losses are held at rtol 1e-6
(f32 sums in another order); the optimizer step at rtol 1e-6, atol 1e-9
(the same f32 operations, where the port may fuse a multiply-add).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dan_tpu.config import TrainConfig
from dan_tpu.train.loss import _select_topk_desc as jax_topk
from dan_tpu.train.loss import detection_loss as jax_loss
from dan_tpu.train.optim import make_lr_schedule, make_optimizer
from dan_tpu_torch.train.loss import _select_topk_desc, detection_loss, smooth_l1
from dan_tpu_torch.train.optim import is_decayed, learning_rate, sgd_update

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1])
def test_select_topk_desc_matches_jax(seed):
    """Rows with heavy exact ties, k = 0, k = A, and -inf entries."""
    rng = np.random.default_rng(seed)
    values = rng.integers(0, 4, (6, 50)).astype(np.float32)
    values[2, :10] = -np.inf
    values[3] = 1.0
    k = np.array([5, 0, 50, 7, 13, 1], np.int32)
    want = np.asarray(jax_topk(jnp.asarray(values), jnp.asarray(k)))
    got = _select_topk_desc(torch.from_numpy(values), torch.from_numpy(k).long())
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().sum(1), k)


def _loss_inputs(rng, b=4, a=300):
    cls = rng.normal(size=(b, a, 2)).astype(np.float32) * 3
    # Duplicate logits so that negatives tie on CE.
    cls[:, 100:150] = cls[:, 50:100]
    loc = rng.normal(size=(b, a, 4)).astype(np.float32)
    loc_t = rng.normal(size=(b, a, 4)).astype(np.float32)
    tgt = rng.choice([-1, 0, 0, 0, 1], size=(b, a)).astype(np.int32)
    tgt[1] = np.where(tgt[1] == 1, 0, tgt[1])  # an image with no positives
    tgt[2] = -1  # an all-ignore row
    return cls, loc, loc_t, tgt


@pytest.mark.parametrize("cfg", [TrainConfig(), TrainConfig(hnm_ratio=1.5, hnm_min_negatives=7,
                                                             loc_loss_weight=0.5)])
def test_detection_loss_matches_jax(cfg):
    rng = np.random.default_rng(0)
    cls, loc, loc_t, tgt = _loss_inputs(rng)
    j_total, j_m = jax_loss(*(jnp.asarray(v) for v in (cls, loc, tgt, loc_t)), cfg)
    t_total, t_m = detection_loss(torch.from_numpy(cls), torch.from_numpy(loc),
                                  torch.from_numpy(tgt), torch.from_numpy(loc_t), cfg)
    assert set(t_m) == set(j_m)
    for k in ("num_pos", "num_neg_selected"):
        assert float(t_m[k]) == float(j_m[k])
    for k in ("loss", "cls_loss", "loc_loss"):
        np.testing.assert_allclose(float(t_m[k]), float(j_m[k]), rtol=1e-6)
    np.testing.assert_allclose(float(t_total), float(j_total), rtol=1e-6)


def test_loss_gradients_match_jax():
    rng = np.random.default_rng(1)
    cls, loc, loc_t, tgt = _loss_inputs(rng)
    cfg = TrainConfig()
    jg = jax.grad(lambda c, l: jax_loss(c, l, jnp.asarray(tgt), jnp.asarray(loc_t), cfg)[0],
                  argnums=(0, 1))(jnp.asarray(cls), jnp.asarray(loc))
    c, l = torch.from_numpy(cls).requires_grad_(), torch.from_numpy(loc).requires_grad_()
    detection_loss(c, l, torch.from_numpy(tgt), torch.from_numpy(loc_t), cfg)[0].backward()
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jg[0]), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(l.grad.numpy(), np.asarray(jg[1]), rtol=1e-5, atol=1e-8)


def test_no_positive_anywhere_keeps_the_floor():
    """No positives in the batch: total_pos is 1 and each image keeps
    hnm_min_negatives negatives."""
    cfg = TrainConfig(hnm_min_negatives=5)
    cls = torch.zeros((2, 20, 2))
    tgt = torch.zeros((2, 20), dtype=torch.int32)
    _, m = detection_loss(cls, torch.zeros((2, 20, 4)), tgt, torch.zeros((2, 20, 4)), cfg)
    assert float(m["num_pos"]) == 0 and float(m["num_neg_selected"]) == 10
    np.testing.assert_allclose(float(m["cls_loss"]), 10 * np.log(2), rtol=1e-6)
    np.testing.assert_array_equal(smooth_l1(torch.tensor([-2.0, 0.5, 1.0])).numpy(),
                                  [1.5, 0.125, 0.5])


@pytest.mark.parametrize("warmup", [0, 50])
def test_lr_schedule_matches_optax(warmup):
    cfg = TrainConfig(learning_rate=1e-3, lr_boundaries=(100, 200, 300),
                      lr_factors=(1.0, 0.1, 0.01, 0.001), warmup_steps=warmup)
    sched = make_lr_schedule(cfg)
    steps = [0, 1, 25, 49, 50, 51, 99, 100, 101, 199, 200, 201, 299, 300, 301, 5000]
    for s in steps:
        want = float(np.asarray(sched(jnp.asarray(s, jnp.int32)), np.float32))
        assert learning_rate(cfg, s) == want, (s, learning_rate(cfg, s), want)


def _tiny_params(rng):
    return {
        "backbone.conv1_1.weight": rng.normal(size=(4, 3, 3, 3)).astype(np.float32),
        "backbone.conv1_1.bias": rng.normal(size=(4,)).astype(np.float32),
        "l2norm.conv3_3.scale": rng.normal(size=(4,)).astype(np.float32) + 10,
    }


def _as_jax_tree(flat):
    """Flat port names -> the JAX package's nested tree (kernel/bias/scale)."""
    tree = {}
    for k, v in flat.items():
        group, name, leaf = k.split(".")
        tree.setdefault(group, {}).setdefault(name, {})[
            "kernel" if leaf == "weight" else leaf] = jnp.asarray(v)
    return tree


@pytest.mark.parametrize("clip", [0.0, 1.0, 1e6])
def test_sgd_step_matches_optax(clip):
    """Two steps of sgd_update against make_optimizer(...).update (weight
    decay on kernels only, momentum 0.9, optional clipping)."""
    cfg = TrainConfig(learning_rate=0.1, weight_decay=0.05, grad_clip_norm=clip,
                      warmup_steps=3, lr_boundaries=(1,), lr_factors=(1.0, 0.5))
    rng = np.random.default_rng(2)
    flat = _tiny_params(rng)
    tx = make_optimizer(cfg)
    jp = _as_jax_tree(flat)
    js = tx.init(jp)
    params = {k: torch.from_numpy(v.copy()) for k, v in flat.items()}
    mom = {k: torch.zeros_like(v) for k, v in params.items()}
    for step in range(2):
        g = {k: (rng.normal(size=v.shape) * 3).astype(np.float32) for k, v in flat.items()}
        upd, js = tx.update(_as_jax_tree(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        norm = sgd_update(params, {k: torch.from_numpy(v) for k, v in g.items()}, mom, step, cfg)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(_as_jax_tree(g))),
                                   rtol=1e-6)
        for k, v in params.items():
            group, name, leaf = k.split(".")
            want = jp[group][name]["kernel" if leaf == "weight" else leaf]
            np.testing.assert_allclose(v.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)


def test_weight_decay_on_kernels_only():
    assert is_decayed("backbone.conv1_1.weight") and is_decayed("heads.cls_fc7.weight")
    assert not is_decayed("backbone.conv1_1.bias") and not is_decayed("l2norm.conv3_3.scale")
    cfg = TrainConfig(learning_rate=1.0, weight_decay=0.5, momentum=0.0)
    params = {"a.b.weight": torch.ones(3), "a.b.bias": torch.ones(3)}
    zeros = {k: torch.zeros(3) for k in params}
    sgd_update(params, zeros, {k: torch.zeros(3) for k in params}, 0, cfg)
    np.testing.assert_array_equal(params["a.b.weight"].numpy(), 0.5)
    np.testing.assert_array_equal(params["a.b.bias"].numpy(), 1.0)
