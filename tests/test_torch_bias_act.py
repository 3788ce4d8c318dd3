"""The in-place bias + ReLU pass of inference convolutions
(ops/bias_act_cuda.py, csrc/bias_act.cu), on the CPU.

The kernel runs only on the card, where chip_smoke.py holds it against
ATen's add-then-clamp bit for bit.  Here:
  * the plain version equals ATen's `F.relu(y + b.to(y.dtype))` (and the add
    alone) bit for bit, over both dtypes, several widths, a channels-last
    4-D tensor against its flat (pixels, C) buffer, and a bias given in
    float32 or already in y's dtype;
  * a numpy model of the kernel's arithmetic (one float32 sum, rounded to
    nearest even, NaN passing the clamp) equals the plain version, ties
    included;
  * the wrapper refuses what the kernel does not take;
  * the model calls the pass where the card would take it: 31 times a bf16
    forward, 13 an int8 forward, never in a forward that autograd records
    or on NCHW activations, with the same logits as the path that hands the
    bias to F.conv2d.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dan_tpu_torch import quant
from dan_tpu_torch.config import ModelConfig
from dan_tpu_torch.models import layers
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.ops import bias_act_cuda

torch.set_num_threads(1)

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _values(shape, dtype, seed):
    """Normal values with NaN, infinities, both zeros and bf16 ties mixed in."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(shape, generator=g) * 3
    flat = y.view(-1)
    specials = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1.0,
                             1.0078125, -1.0, -1.0078125])
    idx = torch.randperm(flat.numel(), generator=g)[: min(flat.numel(), 4 * len(specials))]
    flat[idx] = specials.repeat(4)[: len(idx)]
    return y.to(dtype)


def _bias(c, seed):
    g = torch.Generator().manual_seed(seed)
    b = torch.randn(c, generator=g)
    # 2^-8 is half a bf16 ulp at 1.0: 1.0 + b and 1.0078125 + b are ties.
    b[: min(c, 3)] = torch.tensor([2.0 ** -8, -0.0, 0.0])[: min(c, 3)]
    return b


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "add"])
@pytest.mark.parametrize("c", [6, 8, 64, 256])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_plain_is_aten_add_then_clamp(dtype, c, relu):
    dt = DTYPES[dtype]
    y = _values((2, 5, 3, c), dt, seed=c).permute(0, 3, 1, 2)  # channels-last (2, C, 5, 3)
    assert y.is_contiguous(memory_format=torch.channels_last)
    b = _bias(c, seed=c + 1)
    want = y + b.to(dt)[:, None, None]
    want = F.relu(want) if relu else want
    got = bias_act_cuda.bias_act(y, b, relu)
    assert torch.equal(_bits(got), _bits(want))
    # The bias already in y's dtype gives the same bits.
    assert torch.equal(_bits(bias_act_cuda.bias_act(y, b.to(dt), relu)), _bits(want))
    # The flat (pixels, C) buffer of the same values, as the kernel sees it.
    flat = y.permute(0, 2, 3, 1).reshape(-1, c)
    got_flat = bias_act_cuda.bias_act(flat, b, relu)
    assert torch.equal(_bits(got_flat), _bits(got.permute(0, 2, 3, 1).reshape(-1, c)))


def _round_bf16(x32: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bf16 (ties to even), as float32; NaN stays NaN."""
    u = x32.view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    out = r.astype(np.uint32).view(np.float32)
    return np.where(np.isnan(x32), np.float32("nan"), out)


def _kernel_model(y: torch.Tensor, b: torch.Tensor, relu: bool) -> np.ndarray:
    """csrc/bias_act.cu's arithmetic in numpy over the (pixels, C) buffer."""
    bf16 = y.dtype == torch.bfloat16
    yv = y.float().numpy()
    bv = b.float().numpy()
    if bf16:
        bv = _round_bf16(bv)
    v = (yv + bv).astype(np.float32)
    if bf16:
        v = _round_bf16(v)
    if relu:
        v = np.where(np.isnan(v), v, np.maximum(v, np.float32(0)))
    return v


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "add"])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_the_kernels_arithmetic_is_the_plain_versions(dtype, relu):
    dt = DTYPES[dtype]
    y = _values((600, 64), dt, seed=7)
    b = _bias(64, seed=8)
    got = bias_act_cuda.bias_act_plain(y, b, relu).float().numpy()
    want = _kernel_model(y, b, relu)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    # Bits where neither is zero; zeros by value (the sign of a clamped -0
    # is the card's to show).
    nz = ~nan & (want != 0)
    assert np.array_equal(got[nz].view(np.uint32), want[nz].view(np.uint32))
    assert np.array_equal(got[~nan & ~nz], want[~nan & ~nz])
    if dt == torch.bfloat16:
        # The ties rounded to even: 1 + 2^-8 -> 1, (1 + 2^-7) + 2^-8 -> 1 + 2^-6.
        yt = torch.tensor([[1.0, 1.0078125]], dtype=dt)
        out = bias_act_cuda.bias_act_plain(yt, torch.tensor([2.0 ** -8, 2.0 ** -8]), False)
        assert out.float().tolist() == [[1.0, 1.015625]]


@pytest.mark.parametrize("case", ["nchw", "strided", "bias_len", "bias_2d", "bias_f64",
                                  "bias_bf16_for_f32", "f16", "f64", "int"])
def test_the_wrapper_refuses(case):
    y = torch.zeros(2, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    b = torch.zeros(8)
    if case == "nchw":
        y = torch.zeros(2, 8, 4, 4)
    elif case == "strided":
        y = torch.zeros(6, 16)[:, ::2]
    elif case == "bias_len":
        b = torch.zeros(9)
    elif case == "bias_2d":
        b = torch.zeros(1, 8)
    elif case == "bias_f64":
        b = b.double()
    elif case == "bias_bf16_for_f32":
        b = b.bfloat16()
    elif case == "f16":
        y = y.half()
    elif case == "f64":
        y = y.double()
    elif case == "int":
        y = y.int()
    with pytest.raises((ValueError, TypeError)):
        bias_act_cuda.bias_act(y, b, True)


def test_the_kernel_refuses_cpu_tensors():
    y = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        bias_act_cuda._launch(y, torch.zeros(8), True)


@pytest.fixture
def counted(monkeypatch):
    """The model's calls of the pass, with the card's dispatch taken on
    the CPU (the plain version runs in the kernel's place)."""
    calls = []
    real = bias_act_cuda.bias_act

    def counting(y, bias, relu):
        calls.append((tuple(y.shape), relu))
        return real(y, bias, relu)

    monkeypatch.setattr(bias_act_cuda, "bias_act", counting)
    monkeypatch.setattr(layers, "_on_card", lambda x: True)
    return calls


def _model(dtype: str, size: int = 64, seed: int = 0):
    model = DANDetector(ModelConfig(image_size=size, compute_dtype=dtype),
                        torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, layers.Conv):
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
    return model.eval()


def _images(size, seed=3, n=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, size, size, 3), generator=g) * 50


@pytest.mark.parametrize("size", [64, 63], ids=["packed", "odd"])
def test_a_bf16_forward_calls_the_pass_31_times(counted, size):
    model = _model("bfloat16", size)
    with torch.inference_mode():
        model(_images(size))
    relu = [r for _, r in counted]
    # 19 in the backbone (conv1_1' and pool1, or conv1_1 and conv1_2, then
    # 17 convolutions), 6 in the LFPN, all with ReLU; 6 heads, bias alone.
    assert len(counted) == 31 and relu.count(True) == 25 and relu[-6:] == [False] * 6


def test_an_int8_forward_calls_the_pass_13_times(counted):
    model = _model("float32")
    x = _images(64)
    with torch.inference_mode():
        scales = quant.calibrate_act_scales(model, [x], model.config)
        counted.clear()
        qdet = quant.QuantizedDetector(model, scales).eval()
        qdet(x)
    # conv1_1' (bias alone: quantize_i8 clamps), 6 LFPN, 6 heads.
    assert len(counted) == 13 and [r for _, r in counted][0] is False


def test_an_nchw_forward_keeps_atens_passes(counted, monkeypatch):
    """Images whose NCHW view is contiguous (the TTA runner's resampled
    canvases) give NCHW activations: the pass runs only where an NCHW
    activation is channels-last too (one pixel a channel plane), and the
    logits are the same."""
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    model = _model("float32")
    x = _images(64).permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    with torch.inference_mode():
        got = model(x)
        assert counted and all(shape[2] * shape[3] == 1 for shape, _ in counted)
        counted.clear()
        want = model(x.contiguous())
    assert len(counted) == 31
    for g, w in zip(got, want):
        assert torch.linalg.norm(g - w) <= 1e-5 * torch.linalg.norm(w)


def test_a_recorded_forward_never_calls_the_pass(counted):
    model = _model("bfloat16").train()
    cls, loc = model(_images(64))
    (cls.sum() + loc.sum()).backward()
    assert counted == []
    assert model.backbone.conv1_1.weight.grad is not None


def test_the_passes_logits_equal_the_conv_bias_path(monkeypatch):
    """float32, oneDNN off: the pass after a bias-free F.conv2d against
    F.conv2d with its bias, on the CPU (where the order of the bias in the
    sum may differ by rounding)."""
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    model = _model("float32")
    x = _images(64)
    with torch.inference_mode():
        want = model(x)
        monkeypatch.setattr(layers, "_on_card", lambda x: True)
        got = model(x)
        taps, stats = quant.collect_act_absmax(model, x, model.config)
        monkeypatch.setattr(layers, "_on_card", lambda x: False)
        taps0, stats0 = quant.collect_act_absmax(model, x, model.config)
    for g, w in zip(got, want):
        assert torch.linalg.norm(g - w) <= 1e-5 * torch.linalg.norm(w)
    # The calibration's absmax vectors: within 1e-5 of each vector's largest
    # entry (test_torch_quant.py's tolerance for sums in another order).
    for k in stats0:
        assert (stats[k] - stats0[k]).abs().max() <= 1e-5 * stats0[k].abs().max()
