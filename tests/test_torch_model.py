"""The PyTorch port's model against the JAX package, module by module, on
the same weights (carried across by the bridge) and the same inputs.

f32 on the CPU.  Tolerance rtol 1e-4, atol 5e-4 everywhere: the golden
drift tolerance of tests/parity/test_golden_drift.py, which absorbs f32
accumulation-order differences between XLA and PyTorch convolutions.
PyTorch's oneDNN convolutions are switched off here: against a float64
forward their f32 error is 2-3x XLA's (up to 1.9e-3 on taps of magnitude
~1e3), while PyTorch's plain CPU convolution is at XLA's level.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dan_tpu.config import ModelConfig, default_config
from dan_tpu.models import layers as jl
from dan_tpu.models.detector import detector_forward, init_detector_params
from dan_tpu.models.heads import heads_forward
from dan_tpu.models.lfpn import lfpn_forward
from dan_tpu.models.vgg import vgg_forward
from dan_tpu.ops.preprocess import normalize_image as jax_normalize
from dan_tpu_torch.ckpt.bridge import params_from_jax
from dan_tpu_torch.models import layers as tl
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.ops.preprocess import normalize_image

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _plain_cpu_conv():
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev

RTOL, ATOL = 1e-4, 5e-4
GOLDENS = os.path.join(os.path.dirname(__file__), "fixtures", "mini_wider", "goldens")


def small_config(**kw) -> ModelConfig:
    return ModelConfig(image_size=64, compute_dtype="float32", **kw)


def nchw(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).detach().numpy()


def close(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def build(config: ModelConfig, seed: int = 0):
    """JAX params (numpy leaves) and the port's model on the same weights."""
    params = jax.tree_util.tree_map(
        np.asarray, init_detector_params(jax.random.PRNGKey(seed), config)
    )
    model = DANDetector(config)
    model.load_state_dict(params_from_jax(params))
    return params, model.eval()


@pytest.fixture(scope="module")
def packed():
    return build(small_config())


def golden_input(size: int) -> np.ndarray:
    """(2, size, size, 3) mean-subtracted input: the two golden images,
    subsampled (natural content, the detector's real input range)."""
    imgs = np.load(os.path.join(GOLDENS, "model_io.npz"))["images"]
    step = imgs.shape[1] // size
    sub = imgs[:, : step * size : step, : step * size : step].astype(np.float32)
    return normalize_image(torch.from_numpy(sub), default_config().preprocess).numpy()


def unit_taps(rng, cfg, sizes=(17, 9, 5, 3, 2, 1)):
    """Unit-scale random taps at odd sizes (exercises LFPN's crop)."""
    from dan_tpu.models.vgg import TAP_NAMES, raw_tap_channels

    return {
        name: rng.standard_normal((2, s, s, c)).astype(np.float32)
        for name, s, c in zip(TAP_NAMES, sizes, raw_tap_channels(cfg))
    }


# -- layers --------------------------------------------------------------


@pytest.mark.parametrize(
    "size,stride,dilation,k",
    [(16, 1, 1, 3), (16, 2, 1, 3), (15, 2, 1, 3), (9, 1, 1, 1), (20, 1, 6, 3), (7, 2, 1, 3)],
)
def test_conv2d_same_padding(size, stride, dilation, k):
    rng = np.random.default_rng(size * 10 + stride)
    x = rng.standard_normal((2, size, size + 1, 5)).astype(np.float32)
    kern = rng.standard_normal((k, k, 5, 6)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    want = jl.conv2d({"kernel": kern, "bias": bias}, jnp.asarray(x), stride, dilation)
    got = torch.relu(
        tl.conv2d_same(nchw(x), torch.from_numpy(kern.transpose(3, 2, 0, 1).copy()),
                       torch.from_numpy(bias), stride, dilation)
    )
    assert got.shape[2:] == want.shape[1:3]
    close(nhwc(got), want)


@pytest.mark.parametrize("h,w", [(8, 8), (7, 9), (5, 6)])
def test_max_pool_same(h, w):
    x = np.random.default_rng(h * w).standard_normal((2, h, w, 3)).astype(np.float32)
    want = jl.max_pool(jnp.asarray(x))
    got = tl.max_pool(nchw(x))
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))


def test_l2norm_and_upsample():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    scale = rng.uniform(1, 10, 6).astype(np.float32)
    norm = tl.L2Norm(6, 1.0)
    norm.scale.data = torch.from_numpy(scale)
    close(nhwc(norm(nchw(x))), jl.l2_normalize({"scale": scale}, jnp.asarray(x)))
    close(nhwc(tl.upsample2x(nchw(x))), jl.upsample2x(jnp.asarray(x)))


# -- backbone, LFPN, heads, detector ----------------------------------------


@pytest.mark.parametrize(
    "conv1_packed,size", [(True, 64), (False, 64), (True, 66)],
    ids=["packed", "standard", "odd_66"],
)
def test_vgg_taps(conv1_packed, size):
    cfg = small_config(conv1_packed=conv1_packed)
    params, model = build(cfg)
    x = golden_input(size)
    want = vgg_forward(params["backbone"], jnp.asarray(x), cfg, for_inference=True)
    with torch.no_grad():
        got = model.backbone(nchw(x))
    assert got.keys() == want.keys()
    for name in want:
        close(nhwc(got[name]), want[name])


def test_lfpn_and_heads(packed):
    params, model = packed
    cfg = model.config
    taps = unit_taps(np.random.default_rng(2), cfg)
    want = lfpn_forward(params["lfpn"], {k: jnp.asarray(v) for k, v in taps.items()}, cfg)
    with torch.no_grad():
        got = model.lfpn({k: nchw(v) for k, v in taps.items()})
    for name in want:
        close(nhwc(got[name]), want[name])
    cls_w, loc_w = heads_forward(params["heads"], want, cfg)
    with torch.no_grad():
        cls_g, loc_g = model.heads({k: nchw(v) for k, v in want.items()})
    assert cls_g.dtype == loc_g.dtype == torch.float32
    assert cls_g.shape == cls_w.shape and loc_g.shape == loc_w.shape
    close(cls_g.numpy(), cls_w)
    close(loc_g.numpy(), loc_w)


@pytest.mark.parametrize("size", [64, 66])
def test_detector_forward(packed, size):
    params, model = packed
    cfg = model.config
    x = golden_input(size)
    cls_w, loc_w = detector_forward(params, jnp.asarray(x), cfg, for_inference=True)
    with torch.no_grad():
        cls_g, loc_g = model(torch.from_numpy(x))
    close(cls_g.numpy(), cls_w)
    close(loc_g.numpy(), loc_w)


def test_forward_matches_golden_640():
    """The full-width model (640x640, f32) on the two golden images, with
    the JAX PRNGKey(0) weights, reproduces the committed JAX logits."""
    g = np.load(os.path.join(GOLDENS, "model_io.npz"))
    cfg = default_config()
    mcfg = dataclasses.replace(cfg.model, compute_dtype="float32")
    _, model = build(mcfg)
    x = normalize_image(torch.from_numpy(g["images"]).float(), cfg.preprocess)
    np.testing.assert_array_equal(
        x.numpy(),
        np.asarray(jax_normalize(jnp.asarray(g["images"]).astype(jnp.float32), cfg.preprocess)),
    )
    with torch.no_grad():
        cls, loc = model(x)
    assert cls.shape == g["cls_logits"].shape and loc.shape == g["loc_preds"].shape
    close(cls.numpy(), g["cls_logits"])
    close(loc.numpy(), g["loc_preds"])
