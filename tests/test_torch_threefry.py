"""The port's numpy threefry (dan_tpu_torch/ops/threefry.py) against
jax.random, and the port's augmentation draws against the JAX package's:
`split`, `uniform`, `bernoulli` and `randint` bit for bit over 1,200 seeds
(keys one at a time and as one batch), its fused multiply-add against
exact rational arithmetic,
`sample_augment_batch` against the key splits of dan_tpu's
train_preprocess_one / color_distort in both ordering modes, and the
train preprocess with the port's own draws against train_preprocess_one
with jax.random.PRNGKey(seed)."""
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dan_tpu.config import PreprocessConfig
from dan_tpu.ops import preprocess as jp
from dan_tpu_torch.ops import preprocess as tp
from dan_tpu_torch.ops import threefry
from tests.test_torch_train_preprocess import jax_draws

torch.set_num_threads(1)

# 1,200 per-image seeds: the edges of the uint32 range the batches carry and
# seeds drawn as data/synthetic.py draws them.
SEEDS = np.concatenate([
    np.array([0, 1, 2, 2**31 - 1, 2**31, 2**32 - 1], np.uint32),
    np.random.default_rng(0).integers(0, 2**31, 1194).astype(np.uint32),
])


def _pairs(keys):
    return np.asarray([[int(k[0]), int(k[1])] for k in keys], np.uint32)


def test_prng_key_and_split_match_jax():
    jkeys = jax.vmap(jax.random.PRNGKey)(SEEDS)
    keys = [threefry.prng_key(s) for s in SEEDS]
    np.testing.assert_array_equal(_pairs(keys), np.asarray(jkeys))
    for n in (2, 5, 6):
        want = np.asarray(jax.vmap(lambda k: jax.random.split(k, n))(jkeys))
        got = np.stack([_pairs(threefry.split(k, n)) for k in keys])
        np.testing.assert_array_equal(got, want, err_msg=f"split into {n}")


@pytest.mark.parametrize("draw", ["uniform", "bernoulli", "randint"])
def test_draws_match_jax(draw):
    jkeys = jax.vmap(jax.random.PRNGKey)(SEEDS)
    keys = [threefry.prng_key(s) for s in SEEDS]
    if draw == "uniform":
        for lo, hi in ((0.0, 1.0), (-0.125, 0.125), (0.5, 1.5)):
            want = np.asarray(jax.vmap(
                lambda k: jax.random.uniform(k, (), minval=lo, maxval=hi))(jkeys))
            got = np.array([threefry.uniform(k, lo, hi) for k in keys], np.float32)
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    elif draw == "bernoulli":
        for p in (0.5, 0.7, 0.0, 1.0):
            want = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, p))(jkeys))
            got = np.array([threefry.bernoulli(k, p) for k in keys])
            np.testing.assert_array_equal(got, want)
    else:
        for lo, hi in ((0, 4), (3, 1000), (0, 1), (-5, 7)):
            want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), lo, hi))(jkeys))
            got = np.array([threefry.randint(k, lo, hi) for k in keys])
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("draw", ["split", "uniform", "bernoulli", "randint"])
def test_a_batch_of_keys_draws_what_each_key_draws(draw):
    """The functions map over an array of keys: one call on the 1,200 keys
    gives, bit for bit, what 1,200 calls on the scalar keys give."""
    keys = threefry.prng_key(SEEDS)
    one = [threefry.prng_key(s) for s in SEEDS]
    if draw == "split":
        got = threefry.split(keys, 5)
        want = [threefry.split(k, 5) for k in one]
        for j in range(5):
            np.testing.assert_array_equal(np.stack(got[j], -1), _pairs([w[j] for w in want]))
    elif draw == "uniform":
        got = threefry.uniform(keys, -0.125, 0.125)
        want = np.array([threefry.uniform(k, -0.125, 0.125) for k in one], np.float32)
        assert got.dtype == np.float32 and got.shape == SEEDS.shape
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    elif draw == "bernoulli":
        np.testing.assert_array_equal(threefry.bernoulli(keys, 0.7),
                                      [threefry.bernoulli(k, 0.7) for k in one])
    else:
        np.testing.assert_array_equal(threefry.randint(keys, 3, 1000),
                                      [threefry.randint(k, 3, 1000) for k in one])


def _fma_exact(a, b, c):
    """a * b + c rounded once to float32, ties to even, from the exact
    rational sum."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(exact))
    cands = [np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.float32(v).view(np.uint32)) & 1))


def test_fma_rounds_the_exact_sum_once():
    """`_fma_f32` against exact rational arithmetic: random float32 triples
    (the uniform draw's u in [0, 1), spans and offsets of both signs) and
    constructed sums that lie within 2**-70 of a point halfway between two
    float32 values, on both sides and on it, where rounding the float64 sum
    again would round the wrong way."""
    rng = np.random.default_rng(7)
    n = 4000
    a = rng.random(n).astype(np.float32)
    b = (rng.uniform(-4, 4, n) * 2.0 ** rng.integers(-8, 8, n)).astype(np.float32)
    c = (rng.uniform(-4, 4, n) * 2.0 ** rng.integers(-8, 8, n)).astype(np.float32)
    # Near-ties: c in [1, 2) has an ulp of 2**-23; a * b = 2**-24 (1 + t)(1 + v)
    # with t, v in {-2**-23, 0, 2**-23} puts c + a * b within 2**-70 of c's
    # upper midpoint, or on it.
    ct = (1 + rng.integers(0, 2**23, 300) * 2.0**-23).astype(np.float32)
    t = rng.choice([-2.0**-23, 0.0, 2.0**-23], (2, 300))
    at = (2.0**-24 * (1 + t[0])).astype(np.float32)
    bt = (1 + t[1]).astype(np.float32)
    a, b, c = (np.concatenate(v) for v in ((a, at), (b, bt), (c, ct)))
    got = threefry._fma_f32(a, b, c)
    want = np.array([_fma_exact(*v) for v in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive != want).any(), "no near-tie that a second rounding gets wrong"


def _jax_draws_batch(seeds, cfg: PreprocessConfig):
    """The JAX package's draws, vmapped over per-image seeds: the key splits
    of train_preprocess_one (colour, flip) and color_distort (gate, four
    strengths, and the ordering in 'reference' order)."""
    def one(seed):
        k_color, k_flip = jax.random.split(jax.random.PRNGKey(seed))
        if cfg.color_distort_order == "reference":
            k_gate, k1, k2, k3, k4, k_order = jax.random.split(k_color, 6)
            order = jax.random.randint(k_order, (), 0, len(jp._REFERENCE_ORDERINGS))
        else:
            k_gate, k1, k2, k3, k4 = jax.random.split(k_color, 5)
            order = jnp.int32(0)
        u = lambda k, lo, hi: jax.random.uniform(k, (), minval=lo, maxval=hi)  # noqa: E731
        return (u(k1, -cfg.brightness_max_delta, cfg.brightness_max_delta),
                u(k2, *cfg.saturation_range),
                u(k3, -cfg.hue_max_delta, cfg.hue_max_delta),
                u(k4, *cfg.contrast_range),
                jax.random.bernoulli(k_gate, cfg.color_distort_prob), order,
                jax.random.bernoulli(k_flip, cfg.flip_prob))
    return [np.asarray(v) for v in jax.vmap(one)(jnp.asarray(seeds))]


@pytest.mark.parametrize("order", ["fixed", "reference"])
def test_sample_augment_batch_matches_the_jax_draws(order):
    cfg = PreprocessConfig(color_distort_order=order, color_distort_prob=0.7)
    got = tp.sample_augment_batch(SEEDS, cfg)
    want = _jax_draws_batch(SEEDS, cfg)
    for name, g, w in zip(tp.AugmentDraws._fields, got, want):
        g = g.numpy()
        if g.dtype == np.float32:
            np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32), err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert 0.6 < float(got.on.float().mean()) < 0.8
    if order == "reference":
        assert set(got.order.tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("order", ["fixed", "reference"])
def test_train_preprocess_with_the_ports_own_draws_matches_jax(order):
    """The port draws from the seeds, the JAX package from PRNGKey(seed)
    inside train_preprocess_one.  The port's stage with its own draws is
    bit-identical to the same stage with the draws of `jax_draws` (the JAX
    package's key splits, run eagerly), and within 5e-4 of the JAX stage on
    the [0, 255] scale: these seeds give a constant offset of up to 3.97e-4
    over an image, the contrast mean summed in another order (1.6e-6 on
    [0, 1] values, scaled by 255)."""
    cfg = PreprocessConfig(train_image_size=32, canvas_size=64, color_distort_prob=0.7,
                           color_distort_order=order)
    rng = np.random.default_rng(5)
    canvas = rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
    crops = np.array([[3.0, 5.0, 50.0], [20.0, 30.0, 48.0], [0.0, 0.0, 64.0],
                      [8.0, 2.0, 40.0]], np.float32)
    boxes = np.zeros((4, 4, 4), np.float32)
    boxes[:, :3, :2] = rng.uniform(0, 40, (4, 3, 2))
    boxes[:, :3, 2:] = boxes[:, :3, :2] + rng.uniform(4, 20, (4, 3, 2))
    mask = np.array([[1, 1, 1, 0], [1, 1, 0, 0], [1, 0, 0, 0], [1, 1, 1, 0]], bool)
    seeds = SEEDS[:4]
    draws = tp.sample_augment_batch(seeds, cfg)
    assert draws.flip.any() and not draws.flip.all()
    img, t_boxes, t_mask = tp.train_preprocess(
        torch.from_numpy(canvas), tuple(torch.from_numpy(crops[:, i].copy()) for i in range(3)),
        torch.from_numpy(boxes), torch.from_numpy(mask), draws, cfg)
    injected = tp.train_preprocess(
        torch.from_numpy(canvas), tuple(torch.from_numpy(crops[:, i].copy()) for i in range(3)),
        torch.from_numpy(boxes), torch.from_numpy(mask),
        tp.stack_draws([jax_draws(int(s), cfg) for s in seeds]), cfg)
    for a, b in zip((img, t_boxes, t_mask), injected):
        assert torch.equal(a, b)
    for i, s in enumerate(seeds):
        crop = jp.CropParams(*(jnp.float32(v) for v in crops[i]))
        wi, wb, wm = jp.train_preprocess_one(jnp.asarray(canvas[i]), crop, jnp.asarray(boxes[i]),
                                             jnp.asarray(mask[i]), jax.random.PRNGKey(s), cfg)
        np.testing.assert_allclose(img[i].numpy(), np.asarray(wi), atol=5e-4, rtol=0)
        np.testing.assert_array_equal(t_boxes[i].numpy(), np.asarray(wb))
        np.testing.assert_array_equal(t_mask[i].numpy(), np.asarray(wm))
