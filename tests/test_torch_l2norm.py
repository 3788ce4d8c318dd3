"""L2Norm of the shallow taps in one pass (ops/l2norm_cuda.py,
csrc/l2norm.cu), on the CPU.

The kernel runs only on the card, where chip_smoke.py holds it against
ATen's six passes (within one unit in the last place, bit for bit where the
sum is exact).  Here:
  * the plain version equals the module's ATen expression bit for bit, in
    bf16 and float32, at C = 6, 256 and 512, with NaN, +-inf and all-zero
    pixels;
  * the wrapper refuses what the kernel does not take;
  * the module takes the wrapper exactly where the card would (channels-last,
    autograd recording nothing: `layers.fused_epilogue`), three times a bf16
    and an int8 forward, never on NCHW activations, in a recorded forward or
    on the CPU, and its output keeps x's channels-last strides;
  * a tiny DANDetector and QuantizedDetector give the same logits as with
    the expression in the module, on either route.
"""
import pytest
import torch

from dan_tpu_torch import quant
from dan_tpu_torch.config import ModelConfig
from dan_tpu_torch.models import layers
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.ops import l2norm_cuda

torch.set_num_threads(1)

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
EPS = 1e-12


def _expression(x, scale, eps=EPS):
    """models/layers.py::L2Norm.forward's ATen expression, as the module
    ran it before the kernel."""
    xf = x.float()
    norm = torch.rsqrt((xf * xf).sum(dim=1, keepdim=True) + eps)
    return (xf * norm * scale.float()[:, None, None]).to(x.dtype)


def _tap(c, dtype, seed, b=2, h=5, w=3):
    """A channels-last (b, c, h, w) tap with a NaN pixel, pixels holding
    +inf and -inf, and an all-zero pixel."""
    g = torch.Generator().manual_seed(seed)
    v = torch.randn((b, h, w, c), generator=g) * 4
    v[0, 0, 0, c // 2] = float("nan")
    v[0, 1, 2, 0] = float("inf")
    v[1, 2, 1, c - 1] = -float("inf")
    v[1, 4, 0] = 0.0
    x = v.to(dtype).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    return x


def _scale(c, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(c, generator=g) * 10


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("c", [6, 256, 512])
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_plain_is_the_modules_expression(dtype, c):
    x, scale = _tap(c, DTYPES[dtype], seed=c), _scale(c, seed=c + 1)
    want = _expression(x, scale)
    got = l2norm_cuda.l2norm_plain(x, scale, EPS)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(l2norm_cuda.l2norm(x, scale, EPS)), _bits(want))
    norm = layers.L2Norm(c, 1.0)
    with torch.no_grad():
        norm.scale.copy_(scale)
        assert torch.equal(_bits(norm(x)), _bits(want))
    # NaN takes its pixel, an infinity makes its own value NaN and the rest
    # of its pixel +-0, and an all-zero pixel stays zero.
    assert got[0, :, 0, 0].isnan().all()
    assert got[0, 0, 1, 2].isnan() and (got[0, 1:, 1, 2] == 0).all()
    assert got[1, c - 1, 2, 1].isnan() and (got[1, : c - 1, 2, 1] == 0).all()
    assert (got[1, :, 4, 0] == 0).all()
    finite = torch.ones_like(got, dtype=torch.bool)
    finite[0, :, 0, 0] = finite[0, :, 1, 2] = finite[1, :, 2, 1] = False
    assert got[finite].isfinite().all()


@pytest.mark.parametrize("case", ["nchw", "3d", "f16", "f64", "int", "scale_len", "scale_2d",
                                  "scale_bf16", "scale_f64", "device"])
def test_the_wrapper_refuses(case):
    x = torch.zeros(2, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    scale = torch.ones(8)
    if case == "nchw":
        x = torch.zeros(2, 8, 4, 4)
    elif case == "3d":
        x = torch.zeros(8, 4, 4)
    elif case in ("f16", "f64", "int"):
        x = x.to({"f16": torch.float16, "f64": torch.float64, "int": torch.int32}[case])
    elif case == "scale_len":
        scale = torch.ones(9)
    elif case == "scale_2d":
        scale = torch.ones(1, 8)
    elif case == "scale_bf16":
        scale = scale.bfloat16()
    elif case == "scale_f64":
        scale = scale.double()
    elif case == "device":
        scale = torch.ones(8, device="meta")
    with pytest.raises((ValueError, TypeError)):
        l2norm_cuda.l2norm(x, scale, EPS)


def test_the_kernel_refuses_a_recorded_call_and_cpu_tensors():
    x = torch.zeros(2, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    scale = torch.ones(8, requires_grad=True)
    with pytest.raises(ValueError, match="autograd"):
        l2norm_cuda._launch(x, scale, EPS)
    with pytest.raises(ValueError, match="CUDA"):
        l2norm_cuda._launch(x, scale.detach(), EPS)


@pytest.fixture
def counted(monkeypatch):
    """The calls of the wrapper, with the card's gate taken on the CPU (the
    wrapper runs the plain version there)."""
    calls = []
    real = l2norm_cuda.l2norm

    def counting(x, scale, eps):
        calls.append(tuple(x.shape))
        return real(x, scale, eps)

    monkeypatch.setattr(l2norm_cuda, "l2norm", counting)
    monkeypatch.setattr(layers, "_on_card", lambda x: True)
    return calls


def _norm(c=16):
    norm = layers.L2Norm(c, 1.0)
    with torch.no_grad():
        norm.scale.copy_(_scale(c, seed=5))
    return norm


def test_a_channels_last_tap_under_inference_takes_the_wrapper(counted):
    norm = _norm()
    x = _tap(16, torch.bfloat16, seed=1)
    with torch.inference_mode():
        got = norm(x)
    assert counted == [tuple(x.shape)]
    assert got.is_contiguous(memory_format=torch.channels_last) and got.stride() == x.stride()
    assert torch.equal(_bits(got), _bits(_expression(x, norm.scale.detach())))


@pytest.mark.parametrize("route", ["nchw", "grad", "cpu"])
def test_other_taps_keep_the_expression(counted, monkeypatch, route):
    norm = _norm()
    x = _tap(16, torch.float32, seed=2)
    if route == "nchw":
        x = x.contiguous()
    elif route == "cpu":
        monkeypatch.setattr(layers, "_on_card", lambda x: x.is_cuda)
    with torch.set_grad_enabled(route == "grad"):
        got = norm(x)
    assert counted == []
    assert got.requires_grad == (route == "grad")
    assert torch.equal(_bits(got.detach()), _bits(_expression(x, norm.scale.detach())))


def _model(dtype: str, size: int = 64, seed: int = 0):
    model = DANDetector(ModelConfig(image_size=size, compute_dtype=dtype),
                        torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return model.eval()


def _images(size=64, seed=3, n=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, size, size, 3), generator=g) * 50


def _logits_both_ways(model, x, monkeypatch):
    """The model's logits with L2Norm as it is, then with the module's
    forward replaced by the expression."""
    got = model(x)
    monkeypatch.setattr(layers.L2Norm, "forward",
                        lambda self, t: _expression(t, self.scale, self.eps))
    want = model(x)
    monkeypatch.undo()
    return got, want


@pytest.mark.parametrize("route", ["cpu", "card_gate"])
@pytest.mark.parametrize("which", ["bf16", "int8"])
def test_a_tiny_forward_gives_the_logits_it_gave(monkeypatch, which, route):
    """On the CPU route the module runs the expression; on the card's gate
    (taken on the CPU) it calls the wrapper three times a forward, whose
    plain version gives the same bits."""
    model = _model("bfloat16" if which == "bf16" else "float32")
    x = _images()
    with torch.inference_mode():
        if which == "int8":
            scales = quant.calibrate_act_scales(model, [x], model.config)
            model = quant.QuantizedDetector(model, scales).eval()
        calls = []
        if route == "card_gate":
            real = l2norm_cuda.l2norm
            monkeypatch.setattr(layers, "_on_card", lambda t: True)
            monkeypatch.setattr(l2norm_cuda, "l2norm",
                                lambda t, s, e: calls.append(tuple(t.shape)) or real(t, s, e))
        got, want = _logits_both_ways(model, x, monkeypatch)
    assert len(calls) == (3 if route == "card_gate" else 0)
    assert [c[1] for c in calls] == list(model.config.lfpn_channels)[: len(calls)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_a_recorded_forward_never_calls_the_wrapper(counted):
    model = _model("bfloat16").train()
    cls, loc = model(_images())
    (cls.sum() + loc.sum()).backward()
    assert counted == []
    assert model.l2norm["conv3_3"].scale.grad is not None
