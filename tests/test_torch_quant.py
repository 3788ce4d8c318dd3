"""The port's int8 deployment path (dan_tpu_torch/quant.py, ops/conv_i8*.py,
Detector.quantize_int8) against the JAX package's dan_tpu/quant.py, on the
CPU at the configuration of tests/unit/test_quant.py (64x64, float32),
with the weights carried across by ckpt/bridge.py (He-normal, torch seed 0).

Tolerances, each measured here:
  * given JAX's own activation scales, every int8 kernel, dequant vector,
    bias and packed conv1 piece is bit-identical;
  * conv_i8_plain is bit-identical to JAX's _conv_i8, and the epilogue to
    JAX's relu(acc * deq + bias) and _quantize_act, as is the fused relu +
    quantize of the conv1 block (ops/quantize_i8_cuda.py);
  * calibrated scales: within 1e-5 of each vector's largest entry (the
    float32 forwards sum in other orders; measured 1.4e-6);
  * the quantized forward: the int8 body's s8 activations and taps were
    bit-identical (0 flips); the test allows 1e-4 of the s8 entries to
    differ, by at most 1, and the taps 1e-5 relative; the logits, after the
    float32 LFPN and heads, within relative L2 1e-5 (measured 3.1e-7 and
    3.8e-7).
oneDNN is off, as in the other parity tests (its float32 convolutions are
less exact than XLA's); the int8 sums are exact either way.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dan_tpu import quant as jq
from dan_tpu.config import ModelConfig as JaxModelConfig
from dan_tpu.models.vgg import _phase_slices
from dan_tpu_torch import quant as tq
from dan_tpu_torch.api import Detector
from dan_tpu_torch.ckpt.bridge import params_from_jax, params_to_jax
from dan_tpu_torch.config import (
    DANConfig,
    MatchConfig,
    ModelConfig,
    PostprocessConfig,
    PreprocessConfig,
    TTAConfig,
)
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.models.layers import max_pool
from dan_tpu_torch.ops import conv_i8_cuda, quantize_i8_cuda
from dan_tpu_torch.ops.conv_i8 import conv_i8_epilogue_plain, conv_i8_plain, same_padding_2d
from dan_tpu_torch.ops.squash import eval_preprocess

torch.set_num_threads(1)

SIZE = 64
JCFG = JaxModelConfig(image_size=SIZE, compute_dtype="float32")
TCFG = ModelConfig(image_size=SIZE, compute_dtype="float32")


@pytest.fixture(autouse=True)
def _plain_cpu_conv():
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


@pytest.fixture(scope="module")
def model():
    return DANDetector(TCFG, torch.Generator().manual_seed(0)).eval()


@pytest.fixture(scope="module")
def params(model):
    """The same weights as the JAX package's parameter tree."""
    tree = params_to_jax(model.state_dict())
    back = params_from_jax(tree)
    assert all(torch.equal(v, back[k]) for k, v in model.state_dict().items())
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(7)
    return rng.uniform(-120.0, 130.0, (2, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_scales(params, images):
    return jq.calibrate_act_scales(params, [jnp.asarray(images)], JCFG)


@pytest.fixture(scope="module")
def jax_qparams(params, jax_scales):
    """Eager, as dan_tpu/api.py's quantize_int8 calls it (under jit XLA
    rounds 6 of the 256 k2_deq scales 1 ulp apart: the reference itself
    differs between the two)."""
    return jq.quantize_detector_params(params, JCFG, jax_scales)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def test_body_plan_and_scale_names_equal_the_reference():
    assert tq.body_plan(TCFG) == jq.body_plan(JCFG)
    assert tq.act_scale_names(TCFG) == jq.act_scale_names(JCFG)
    assert len(tq.body_plan(TCFG)) == 17


def test_quantize_kernel_bit_identical():
    """With and without a folded activation scale; an all-zero output
    channel takes the 1e-12 floor of the scale."""
    rng = np.random.default_rng(1)
    k = rng.normal(0, 0.05, (3, 3, 32, 16)).astype(np.float32)
    k[..., 5] = 0.0
    act = rng.uniform(1e-3, 2.0, 32).astype(np.float32)
    for a in (None, act):
        jqk, js = jq._quantize_kernel(jnp.asarray(k), None if a is None else jnp.asarray(a))
        tqk, ts = tq.quantize_kernel(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()),
                                     None if a is None else torch.from_numpy(a))
        np.testing.assert_array_equal(tqk.numpy(), np.asarray(jqk).transpose(3, 0, 1, 2))
        np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
        assert tqk.dtype == torch.int8 and int(tqk.abs().max()) == 127


def test_quantized_params_bit_identical_given_the_reference_scales(model, jax_scales,
                                                                   jax_qparams):
    q = tq.quantize_detector_params(model, TCFG, jax_scales)
    jc, tc = jax_qparams["conv1"], q["conv1"]
    np.testing.assert_array_equal(_bits(tc["k1p"].permute(2, 3, 1, 0).numpy()), _bits(jc["k1p"]))
    np.testing.assert_array_equal(_bits(tc["b1"].numpy()), _bits(jc["b1"]))
    np.testing.assert_array_equal(tc["k2q"].numpy(), np.asarray(jc["k2q"]).transpose(3, 0, 1, 2))
    np.testing.assert_array_equal(_bits(tc["k2_deq"].numpy()), _bits(jc["k2_deq"]))
    np.testing.assert_array_equal(_bits(tc["b2"].numpy()), _bits(jc["b2"]))
    assert set(q["body"]) == set(jax_qparams["body"])
    for name, jl_ in jax_qparams["body"].items():
        tl_ = q["body"][name]
        np.testing.assert_array_equal(tl_["kq"].numpy(), np.asarray(jl_["kq"]).transpose(3, 0, 1, 2),
                                      err_msg=name)
        np.testing.assert_array_equal(_bits(tl_["deq"].numpy()), _bits(jl_["deq"]), err_msg=name)
        np.testing.assert_array_equal(_bits(tl_["bias"].numpy()), _bits(jl_["bias"]), err_msg=name)
    for name, s in jax_qparams["act"].items():
        np.testing.assert_array_equal(_bits(q["act"][name].numpy()), _bits(s))
        np.testing.assert_array_equal(_bits(q["inv"][name].numpy()), _bits(1.0 / jnp.asarray(s)))
    missing = dict(jax_scales)
    missing.pop("conv3_1")
    with pytest.raises(ValueError, match="conv3_1"):
        tq.quantize_detector_params(model, TCFG, missing)


def test_calibration_matches_the_reference(model, images, jax_scales):
    scales = tq.calibrate_act_scales(model, [torch.from_numpy(images)], TCFG)
    assert list(scales) == tq.act_scale_names(TCFG) and set(scales) == set(jax_scales)
    for name, s in scales.items():
        want = np.asarray(jax_scales[name])
        assert s.dtype == np.float32 and s.shape == want.shape, name
        assert np.abs(s.astype(np.float64) - want).max() <= 1e-5 * want.max(), name
    # The stats forward mirrors the backbone's inference forward bit for bit.
    taps, _ = tq.collect_act_absmax(model, torch.from_numpy(images), TCFG)
    with torch.inference_mode():
        ref = model.backbone(torch.from_numpy(images).permute(0, 3, 1, 2))
    assert set(taps) == set(ref)
    for name in ref:
        assert torch.equal(taps[name], ref[name]), name
    with pytest.raises(ValueError, match="at least one batch"):
        tq.calibrate_act_scales(model, [], TCFG)


# (B, H, W, Ci, Co, k, stride, dilation): the layer shapes of the 64x64
# config (conv1_2' takes the explicit padding 1), and odd sizes.
CONV_SHAPES = [
    (2, 32, 32, 256, 256, 2, 1, 1),   # conv1_2'
    (2, 32, 32, 64, 128, 3, 1, 1),    # conv2_1
    (1, 16, 16, 128, 256, 3, 1, 1),   # conv3_1
    (1, 8, 8, 512, 512, 3, 1, 1),     # conv4_2
    (2, 2, 2, 512, 1024, 3, 1, 6),    # fc6: dilation 6, taps on padding
    (2, 2, 2, 1024, 256, 1, 1, 1),    # conv6_1
    (2, 2, 2, 256, 512, 3, 2, 1),     # conv6_2: stride 2, pads (0, 1)
    (1, 1, 1, 128, 256, 3, 2, 1),     # conv7_2
    (1, 9, 7, 64, 32, 3, 2, 1),       # odd sizes, stride 2
    (2, 11, 13, 32, 16, 3, 1, 3),     # odd sizes, dilation 3
]


@pytest.mark.parametrize("shape", CONV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv_i8_plain_bit_identical_to_the_reference(shape):
    b, h, w, ci, co, k, stride, dil = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(-127, 128, (b, h, w, ci)).astype(np.int8)
    x[0, : max(1, h // 3)] = 127  # saturated rows
    kq = rng.integers(-127, 128, (k, k, ci, co)).astype(np.int8)
    if k == 2:
        pad, jpad = (1, 1, 1, 1), ((1, 1), (1, 1))
    else:
        pad, jpad = same_padding_2d(h, w, k, k, stride, dil), "SAME"
    want = np.asarray(jq._conv_i8(jnp.asarray(x), jnp.asarray(kq), stride, dil, jpad))
    xt, kt = torch.from_numpy(x), torch.from_numpy(kq.transpose(3, 0, 1, 2).copy())
    got = conv_i8_plain(xt, kt, stride, dil, pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # The epilogue, in JAX's operations: relu(acc * deq + bias), _quantize_act.
    deq = rng.uniform(1e-6, 1e-4, co).astype(np.float32)
    bias = rng.normal(0, 1, co).astype(np.float32)
    scale = rng.uniform(0.01, 0.5, co).astype(np.float32)
    y = jax.nn.relu(jnp.asarray(want).astype(jnp.float32) * deq + bias)
    inv = tq.reciprocal(torch.from_numpy(scale))
    tap, q = conv_i8_epilogue_plain(got, torch.from_numpy(deq), torch.from_numpy(bias), inv,
                                    torch.float32)
    np.testing.assert_array_equal(_bits(tap.numpy()), _bits(y))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq._quantize_act(y, scale)))
    # The wrapper takes the plain version on CPU tensors, without a launch.
    launches = conv_i8_cuda.LAUNCHES
    out = conv_i8_cuda.conv_i8(xt, kt, torch.from_numpy(deq), torch.from_numpy(bias), inv,
                               stride, dil, pad, torch.bfloat16, with_acc=True)
    assert conv_i8_cuda.LAUNCHES == launches
    assert torch.equal(out.acc, got) and torch.equal(out.q, q)
    assert torch.equal(out.tap, tap.to(torch.bfloat16))


def test_conv_i8_wrapper_checks_its_arguments():
    x = torch.zeros((1, 4, 4, 32), dtype=torch.int8)
    k = torch.zeros((8, 3, 3, 32), dtype=torch.int8)
    v = torch.ones(8)
    with pytest.raises(TypeError):
        conv_i8_cuda.conv_i8(x.float(), k, v, v, v)
    with pytest.raises(ValueError, match="Ci"):
        conv_i8_cuda.conv_i8(x, k[..., :16], v, v, v)
    with pytest.raises(ValueError, match="inv_next"):
        conv_i8_cuda.conv_i8(x, k, v, v, torch.ones(4))
    with pytest.raises(ValueError, match="needs an output"):
        conv_i8_cuda.conv_i8(x, k, v, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv_i8_cuda._launch(x, k, v, v, v, 1, 1, (1, 1, 1, 1), None, False)
    # What the kernel takes (its plan raises; the launch builds the plan first).
    with pytest.raises(ValueError, match="Ci % 64 == 0 and Co % 64 == 0"):
        conv_i8_cuda.plan(1, 4, 4, 32, 8, 3, 3, 1, 1, (1, 1, 1, 1))
    with pytest.raises(ValueError, match="phase_max"):
        conv_i8_cuda.conv_i8(x, k, v, v, None, padding=(1, 1, 1, 1), with_acc=True,
                             phase_max=True)
    # Non-integral float results are refused: an inexact algorithm raises.
    from dan_tpu_torch.ops.conv_i8 import _integral
    with pytest.raises(AssertionError, match="not integral"):
        _integral(torch.tensor([1.0, 2.5]), "test")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_i8_equals_relu_and_the_reference_quantize(dtype):
    """The fused relu + quantize of the conv1 block: JAX's relu (in the
    compute dtype) then _quantize_act on the float32 value, bit for bit; on
    CPU tensors the wrapper runs the plain version without a launch."""
    rng = np.random.default_rng(6)
    y = (rng.standard_normal((2, 5, 7, 24)) * 40).astype(np.float32)
    y[0, 0, 0, :3] = [0.0, -0.0, 0.5 / 0.013]  # zeros, a tie at .5 after scaling
    scale = rng.uniform(0.01, 0.5, 24).astype(np.float32)
    scale[0] = 0.013
    jy = jnp.asarray(y).astype(dtype)
    want = np.asarray(jq._quantize_act(jax.nn.relu(jy).astype(jnp.float32), jnp.asarray(scale)))
    ty = torch.from_numpy(y).to(getattr(torch, dtype))
    inv = tq.reciprocal(torch.from_numpy(scale))
    launches = quantize_i8_cuda.LAUNCHES
    got = quantize_i8_cuda.quantize_i8(ty, inv)
    assert quantize_i8_cuda.LAUNCHES == launches and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="inv float32"):
        quantize_i8_cuda.quantize_i8(ty, inv[:8])
    with pytest.raises(ValueError, match="CUDA tensors"):
        quantize_i8_cuda._launch(ty, inv)


@pytest.mark.parametrize("hw", [(8, 8), (9, 7)])
def test_int8_max_pool_commutes_with_quantize(hw):
    """pool(quant(y)) == quant(pool(y)), odd sizes padded with -128, and the
    same values as JAX's _max_pool_i8."""
    rng = np.random.default_rng(2)
    y = np.maximum(rng.standard_normal((2, *hw, 4)), 0).astype(np.float32)
    s = torch.tensor(0.013)
    a = tq.max_pool_i8(tq.quantize_act(torch.from_numpy(y), s))
    b = tq.quantize_act(max_pool(torch.from_numpy(y).permute(0, 3, 1, 2)).permute(0, 2, 3, 1), s)
    assert a.is_contiguous() and torch.equal(a, b)
    want = jq._max_pool_i8(jq._quantize_act(jnp.asarray(y), 0.013))
    np.testing.assert_array_equal(a.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tq.quantize_act(torch.from_numpy(y), s).numpy(),
                                  np.asarray(jq._quantize_act(jnp.asarray(y), 0.013)))


def test_int8_phase_max_commutes_with_the_requant(model, jax_scales):
    """The packed conv1 epilogue requantizes each phase and takes the phase
    max on int8; with the requant side (bias, next scale) shared by the four
    phase groups this equals dequant -> phase max -> bias + relu -> quantize."""
    q = tq.quantize_detector_params(model, TCFG, jax_scales)
    c1 = q["conv1"]
    co = c1["b2"].shape[0]
    rng = np.random.default_rng(3)
    acc = torch.from_numpy(rng.integers(-(2**20), 2**20, (2, 9, 9, 4 * co)).astype(np.int32))
    _, q_all = conv_i8_epilogue_plain(acc, c1["k2_deq"], c1["b2"].repeat(4),
                                      q["inv"]["conv2_1"].repeat(4))
    ours = tq.phase_max_i8(q_all, co)
    r = acc.float() * c1["k2_deq"]
    s = [r[:, py:py + 8, px:px + 8, g * co:(g + 1) * co]
         for g, (py, px) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1)))]
    m = torch.maximum(torch.maximum(s[0], s[1]), torch.maximum(s[2], s[3]))
    ref = tq.quantize_act(torch.relu(m + c1["b2"]), q["act"]["conv2_1"])
    assert torch.equal(ours, ref)
    jr = _phase_slices(jnp.asarray(q_all.numpy()), co)
    jm = jnp.maximum(jnp.maximum(jr[0], jr[1]), jnp.maximum(jr[2], jr[3]))
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jm))


def _jax_body_with_inputs(qp, x, config):
    """dan_tpu/quant.py::_quant_vgg_forward, written out with its own
    primitives to also return each conv's int8 input."""
    act = qp["act"]
    c1 = qp["conv1"]
    o1 = jax.nn.relu(jax.lax.conv_general_dilated(x, c1["k1p"], (2, 2), ((1, 2), (1, 2)),
                                                  dimension_numbers=jq._DN) + c1["b1"])
    q8 = jq._quantize_act(o1, act["conv1_2"])
    inputs = {"conv1_2": q8}
    acc = jq._conv_i8(q8, c1["k2q"], padding=((1, 1), (1, 1)))
    z = acc.astype(jnp.float32) * c1["k2_deq"] + jnp.tile(c1["b2"], 4)
    q_all = jq._quantize_act(jax.nn.relu(z), jnp.tile(act["conv2_1"], 4))
    s = _phase_slices(q_all, c1["b2"].shape[0])
    q8 = jnp.maximum(jnp.maximum(s[0], s[1]), jnp.maximum(s[2], s[3]))
    taps = {}
    plan = jq.body_plan(config)
    for (name, stride, dil, is_tap, pool_after), nxt in zip(plan, plan[1:] + [None]):
        inputs[name] = q8
        lw = qp["body"][name]
        acc = jq._conv_i8(q8, lw["kq"], stride=stride, dilation=dil)
        y = jax.nn.relu(acc.astype(jnp.float32) * lw["deq"] + lw["bias"])
        if is_tap:
            taps[name] = y
        if nxt is not None:
            q8 = jq._quantize_act(y, act[nxt[0]])
            if pool_after:
                q8 = jq._max_pool_i8(q8)
    return taps, inputs


def test_quantized_forward_matches_the_reference(model, images, jax_scales, jax_qparams):
    qdet = tq.QuantizedDetector(model, jax_scales).eval()
    x = torch.from_numpy(images)
    record = {}
    with torch.inference_mode():
        taps = qdet.backbone(x, record)
        cls, loc = qdet(x)
        cls_f, loc_f = model(x)
    j_taps, j_inputs = jax.jit(_jax_body_with_inputs, static_argnums=2)(
        jax_qparams, jnp.asarray(images), JCFG)
    ref_taps = jax.jit(jq._quant_vgg_forward, static_argnums=2)(
        jax_qparams, jnp.asarray(images), JCFG)
    assert set(record) == set(j_inputs) and len(record) == 18
    for name, want in j_inputs.items():
        got = record[name].numpy()
        want = np.asarray(want)
        assert got.dtype == np.int8 and got.shape == want.shape, name
        diff = np.abs(got.astype(np.int32) - want)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, name
    for name, want in ref_taps.items():
        np.testing.assert_array_equal(np.asarray(j_taps[name]), np.asarray(want))
        np.testing.assert_allclose(taps[name].permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5 * float(np.abs(want).max()),
                                   err_msg=name)
    j_cls, j_loc = jax.jit(jq.quantized_detector_forward, static_argnums=2)(
        jax_qparams, jnp.asarray(images), JCFG)
    for got, want in ((cls, j_cls), (loc, j_loc)):
        want = np.asarray(want, np.float64)
        assert got.shape == want.shape and torch.isfinite(got).all()
        assert np.linalg.norm(got.numpy() - want) <= 1e-5 * np.linalg.norm(want)
    # PTQ noise against the float model, the JAX test's bound.
    for a, b in ((cls, cls_f), (loc, loc_f)):
        a, b = a.double().numpy().ravel(), b.double().numpy().ravel()
        assert np.corrcoef(a, b)[0, 1] > 0.99
        assert np.sqrt(np.mean((a - b) ** 2)) / (np.std(b) + 1e-9) < 0.15


def test_quantized_forward_on_an_odd_size_takes_the_unpacked_path(model, images, jax_scales,
                                                                  jax_qparams):
    x = images[:1, :45, :45]
    qdet = tq.QuantizedDetector(model, jax_scales).eval()
    record = {}
    with torch.inference_mode():
        qdet.backbone(torch.from_numpy(x), record)
        cls, loc = qdet(torch.from_numpy(x))
    assert "conv1_2" not in record and record["conv2_1"].shape == (1, 23, 23, 64)
    j_cls, j_loc = jax.jit(jq.quantized_detector_forward, static_argnums=2)(
        jax_qparams, jnp.asarray(x), JCFG)
    for got, want in ((cls, j_cls), (loc, j_loc)):
        want = np.asarray(want, np.float64)
        assert np.linalg.norm(got.numpy() - want) <= 1e-5 * np.linalg.norm(want)


def tiny_config() -> DANConfig:
    return DANConfig(
        model=TCFG,
        preprocess=PreprocessConfig(train_image_size=64, canvas_size=128),
        match=MatchConfig(max_gt=8),
        postprocess=PostprocessConfig(pre_nms_topk=64, max_detections=8),
        tta=TTAConfig(buckets=(64, 128)),
    )


class _StubRunner:
    def detect_tta(self, image):
        return {"bboxes": np.zeros((0, 4), np.float32), "scores": np.zeros((0,), np.float32)}


def test_detector_quantize_int8_dequantize_and_the_tta_warning(model):
    cfg = tiny_config()
    det = Detector(model, cfg, device="cpu")
    rng = np.random.default_rng(4)
    imgs = [rng.integers(0, 255, hw + (3,), np.uint8) for hw in ((50, 70), (64, 64), (33, 21))]
    out_f = det.detect(imgs[0])
    scales = det.quantize_int8(imgs, batch_size=2)
    assert list(scales) == tq.act_scale_names(cfg.model)
    # The calibration images went through the detect path's preprocess,
    # the short tail padded by repeating its last image.
    canvases = np.zeros((3, 128, 128, 3), np.uint8)
    for i, im in enumerate(imgs):
        canvases[i, : im.shape[0], : im.shape[1]] = im
    prep = [eval_preprocess(torch.from_numpy(canvases[i]), torch.tensor(float(im.shape[0])),
                            torch.tensor(float(im.shape[1])), SIZE, cfg.preprocess)
            for i, im in enumerate(imgs)]
    want = tq.calibrate_act_scales(model, [torch.stack(prep[:2]), torch.stack([prep[2]] * 2)],
                                   cfg.model)
    for k in want:
        np.testing.assert_array_equal(scales[k], want[k], err_msg=k)
    launches = conv_i8_cuda.LAUNCHES
    out_q = det.detect(imgs[0])
    assert conv_i8_cuda.LAUNCHES == launches  # CPU: the plain version
    assert np.isfinite(out_q["bboxes"]).all() and out_q["bboxes"].shape[1] == 4
    assert not (out_q["scores"].shape == out_f["scores"].shape
                and np.array_equal(out_q["scores"], out_f["scores"]))
    assert len(det.detect_batch(imgs[:2])) == 2
    det.warmup(buckets=(64,))
    det.dequantize()
    again = det.detect(imgs[0])
    for k in out_f:
        np.testing.assert_array_equal(again[k], out_f[k])
    # The TTA path stays in the compute dtype and warns once on an int8 detector.
    det.quantize_int8(imgs[:1], batch_size=1)
    det._tta_runner = _StubRunner()
    with pytest.warns(UserWarning, match="int8"):
        det.detect_tta(imgs[0])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        det.detect_tta(imgs[0])
    det.dequantize()
    with pytest.raises(ValueError, match="at least one"):
        det.quantize_int8([])
