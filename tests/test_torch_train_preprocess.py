"""The port's train-time preprocessing against the JAX package, with the
JAX package's own random draws: `jax_draws` replays the key splits of
dan_tpu/ops/preprocess.py (train_preprocess_one's split into colour and
flip keys, color_distort's five or six subkeys) and hands the values to
the port, whose own draws come from torch generators.

Exact where the operations are the same elementwise float32 ops (HSV,
boxes, flip, the two-tap resample); the colour distortion is held at atol
1e-6 on [0, 1] values, because the contrast mean sums in another order, and
the whole stage at that tolerance scaled to its [0, 255] output, 3e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dan_tpu.config import PreprocessConfig
from dan_tpu.ops import preprocess as jp
from dan_tpu_torch.ops import preprocess as tp

torch.set_num_threads(1)


def jax_draws(seed: int, cfg: PreprocessConfig) -> tp.AugmentDraws:
    """The draws jax.random makes for one image from PRNGKey(seed)."""
    k_color, k_flip = jax.random.split(jax.random.PRNGKey(seed))
    if cfg.color_distort_order == "reference":
        k_gate, k1, k2, k3, k4, k_order = jax.random.split(k_color, 6)
        order = int(jax.random.randint(k_order, (), 0, len(jp._REFERENCE_ORDERINGS)))
    else:
        k_gate, k1, k2, k3, k4 = jax.random.split(k_color, 5)
        order = 0
    u = lambda k, lo, hi: float(jax.random.uniform(k, (), minval=lo, maxval=hi))  # noqa: E731
    return tp.AugmentDraws(
        delta_b=u(k1, -cfg.brightness_max_delta, cfg.brightness_max_delta),
        f_sat=u(k2, *cfg.saturation_range),
        delta_h=u(k3, -cfg.hue_max_delta, cfg.hue_max_delta),
        f_con=u(k4, *cfg.contrast_range),
        on=bool(jax.random.bernoulli(k_gate, cfg.color_distort_prob)),
        order=order,
        flip=bool(jax.random.bernoulli(k_flip, cfg.flip_prob)),
    )


def _images(rng, b=4, h=12, w=10):
    x = rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32)
    x[0, :3] = 0.5  # grey pixels: zero range
    x[1, :2] = 0.0  # black
    x[2, 0, 0] = [1.0, 0.2, 0.2]  # each channel the max once
    x[2, 0, 1] = [0.2, 1.0, 0.2]
    x[2, 0, 2] = [0.2, 0.2, 1.0]
    return x


def test_hsv_round_trip_matches_jax():
    x = _images(np.random.default_rng(0))
    hsv_t = tp.rgb_to_hsv(torch.from_numpy(x))
    np.testing.assert_array_equal(hsv_t.numpy(), np.asarray(jp.rgb_to_hsv(jnp.asarray(x))))
    rgb_t = tp.hsv_to_rgb(hsv_t)
    np.testing.assert_array_equal(rgb_t.numpy(),
                                  np.asarray(jp.hsv_to_rgb(jnp.asarray(hsv_t.numpy()))))
    np.testing.assert_allclose(rgb_t.numpy(), x, atol=2e-6)


@pytest.mark.parametrize("order", ["fixed", "reference"])
@pytest.mark.parametrize("prob", [1.0, 0.0])
def test_color_distort_matches_jax(order, prob):
    cfg = PreprocessConfig(color_distort_order=order, color_distort_prob=prob)
    x = _images(np.random.default_rng(1), b=8)
    seeds = list(range(10, 18))
    draws = [jax_draws(s, cfg) for s in seeds]
    if order == "reference":
        assert len({d.order for d in draws}) >= 2
    keys = [jax.random.split(jax.random.PRNGKey(s))[0] for s in seeds]
    want = np.stack([np.asarray(jp.color_distort(jnp.asarray(x[i]), keys[i], cfg))
                     for i in range(len(seeds))])
    got = tp.color_distort(torch.from_numpy(x), tp.stack_draws(draws), cfg).numpy()
    if prob == 0.0:
        np.testing.assert_array_equal(got, x)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("semantics", ["half_pixel", "tf1_legacy"])
def test_crop_and_resize_matches_jax(semantics):
    """A window inside the canvas, one past its top and right edges, and a
    fractional window."""
    rng = np.random.default_rng(2)
    canvas = rng.uniform(0, 255, (3, 40, 50, 3)).astype(np.float32)
    crops = np.array([[4.0, 6.0, 24.0], [30.0, -5.0, 30.0], [1.5, 2.25, 33.3]], np.float32)
    got = tp.crop_and_resize(torch.from_numpy(canvas), *(torch.from_numpy(crops[:, i].copy())
                                                          for i in range(3)), 16, semantics)
    for i in range(3):
        crop = jp.CropParams(*(jnp.float32(v) for v in crops[i]))
        want = np.asarray(jp.crop_and_resize(jnp.asarray(canvas[i]), crop, 16, semantics))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-6, atol=1e-4)
    assert (got[1, :, -3:] == 0).all()  # beyond the canvas reads as zero


def test_transform_boxes_and_hflip_match_jax():
    rng = np.random.default_rng(3)
    boxes = rng.uniform(0, 60, (2, 6, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(0.5, 30, (2, 6, 2)).astype(np.float32)
    mask = np.array([[1, 1, 1, 0, 1, 1], [1, 0, 1, 1, 1, 1]], bool)
    crops = np.array([[5.0, 8.0, 40.0], [20.0, 0.0, 64.0]], np.float32)
    t_boxes, t_mask = tp.transform_boxes(
        torch.from_numpy(boxes), torch.from_numpy(mask),
        *(torch.from_numpy(crops[:, i].copy()) for i in range(3)), 32, 1.0)
    img = rng.uniform(size=(2, 4, 5, 3)).astype(np.float32)
    f_img, f_boxes = tp.hflip(torch.from_numpy(img), t_boxes, t_mask, 32.0)
    for i in range(2):
        crop = jp.CropParams(*(jnp.float32(v) for v in crops[i]))
        jb, jm = jp.transform_boxes(jnp.asarray(boxes[i]), jnp.asarray(mask[i]), crop, 32, 1.0)
        np.testing.assert_array_equal(t_boxes[i].numpy(), np.asarray(jb))
        np.testing.assert_array_equal(t_mask[i].numpy(), np.asarray(jm))
        ji, jfb = jp.hflip(jnp.asarray(img[i]), jb, jm, 32.0)
        np.testing.assert_array_equal(f_img[i].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(f_boxes[i].numpy(), np.asarray(jfb))
    assert not t_mask.all() and t_mask.any()


@pytest.mark.parametrize("order", ["fixed", "reference"])
def test_train_preprocess_matches_jax(order):
    cfg = PreprocessConfig(train_image_size=32, canvas_size=64, color_distort_prob=0.7,
                           color_distort_order=order)
    rng = np.random.default_rng(4)
    canvas = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    crops = np.array([[3.0, 5.0, 50.0], [20.0, 30.0, 48.0]], np.float32)
    boxes = np.zeros((2, 4, 4), np.float32)
    boxes[:, :3, :2] = rng.uniform(0, 40, (2, 3, 2))
    boxes[:, :3, 2:] = boxes[:, :3, :2] + rng.uniform(4, 20, (2, 3, 2))
    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    # The first seeds whose draws flip, and do not flip, a distorted image.
    seeds = [next(s for s in range(100) if jax_draws(s, cfg).on and jax_draws(s, cfg).flip == f)
             for f in (True, False)]
    draws = [jax_draws(s, cfg) for s in seeds]
    img, t_boxes, t_mask = tp.train_preprocess(
        torch.from_numpy(canvas), tuple(torch.from_numpy(crops[:, i].copy()) for i in range(3)),
        torch.from_numpy(boxes), torch.from_numpy(mask), tp.stack_draws(draws), cfg)
    assert img.shape == (2, 32, 32, 3) and img.dtype == torch.float32
    for i, s in enumerate(seeds):
        crop = jp.CropParams(*(jnp.float32(v) for v in crops[i]))
        wi, wb, wm = jp.train_preprocess_one(jnp.asarray(canvas[i]), crop, jnp.asarray(boxes[i]),
                                             jnp.asarray(mask[i]), jax.random.PRNGKey(s), cfg)
        np.testing.assert_allclose(img[i].numpy(), np.asarray(wi), atol=3e-4, rtol=0)
        np.testing.assert_array_equal(t_boxes[i].numpy(), np.asarray(wb))
        np.testing.assert_array_equal(t_mask[i].numpy(), np.asarray(wm))


def test_sample_augment_is_seeded_and_in_range():
    cfg = dataclasses.replace(PreprocessConfig(), color_distort_order="reference")
    a = tp.sample_augment_batch([1, 2, 3, 1], cfg)
    b = tp.sample_augment_batch([1, 2, 3, 1], cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert torch.equal(a.delta_b[0], a.delta_b[3])
    assert (a.delta_b.abs() <= cfg.brightness_max_delta).all()
    assert ((a.f_con >= 0.5) & (a.f_con <= 1.5)).all()
    assert ((a.order >= 0) & (a.order < 4)).all()
    assert a.on.dtype == torch.bool and a.flip.dtype == torch.bool
