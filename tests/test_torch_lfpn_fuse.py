"""The LFPN's upsample x lateral in one pass (ops/lfpn_fuse_cuda.py,
csrc/lfpn_fuse.cu), on the CPU.

The kernel runs only on the card, where chip_smoke.py holds it against
ATen's upsample-then-product bit for bit.  Here:
  * the plain version equals the LFPN's ATen expression bit for bit, for
    both ops, in bf16 and float32, at even and odd sizes (the crop), with
    NaN, +-inf and -0 at the edges and beside them;
  * a model of the kernel's work (a thread's 2x2 quad of output pixels
    from nine source pixels, the top row's second source row and the left
    column's second source column picked from the other two) gives ATen's
    upsample exactly, on small integers in float64, at every size from 1
    to 5 and every crop, and propagates what ATen propagates;
  * the wrapper refuses what the kernel does not take;
  * the LFPN takes the wrapper exactly where the card would (channels-last,
    autograd recording nothing: `layers.fused_epilogue`), three times a bf16
    and an int8 forward, never on NCHW activations, in a recorded forward or
    on the CPU;
  * a tiny DANDetector and QuantizedDetector give the same logits on
    either route, under both ops.
"""
import pytest
import torch

from dan_tpu_torch import quant
from dan_tpu_torch.config import ModelConfig
from dan_tpu_torch.models import layers, lfpn
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.ops import lfpn_fuse_cuda

torch.set_num_threads(1)

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
OPS = ("product", "sum")


def _expression(topdown, lateral, op):
    """models/lfpn.py's ATen route: the upsample, the crop, the op."""
    up = layers._bilinear2x(topdown)[:, :, : lateral.shape[2], : lateral.shape[3]]
    return up * lateral if op == "product" else up + lateral


def _channels_last(v, dtype):
    """(b, h, w, c) values -> a channels-last (b, c, h, w) tensor of dtype."""
    x = v.to(dtype).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    return x


def _pair(c, h, w, big_h, big_w, dtype, seed, specials=True):
    """A channels-last topdown (2, c, h, w) and lateral (2, c, H, W), with
    NaN, +inf, -inf and -0 in topdown's corners and edges and in lateral."""
    g = torch.Generator().manual_seed(seed)
    td = torch.randn((2, h, w, c), generator=g) * 3
    lat = torch.randn((2, big_h, big_w, c), generator=g) * 3
    if specials:
        td[0, 0, 0, 0] = float("nan")
        td[0, h - 1, w - 1, c - 1] = float("inf")
        td[1, h // 2, 0, c // 2] = -float("inf")
        td[1, 0, w // 2, 1 % c] = -0.0
        td[1, h - 1, w // 2, 0] = float("nan")
        lat[0, big_h - 1, 0, 0] = float("inf")
        lat[1, 0, big_w - 1, c - 1] = -0.0
        lat[1, big_h // 2, big_w // 2, 0] = 0.0
    return _channels_last(td, dtype), _channels_last(lat, dtype)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("size", ["even", "odd"])
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("dtype", list(DTYPES), ids=list(DTYPES))
def test_plain_is_the_lfpns_expression(dtype, op, size):
    h, w = 5, 4
    big_h, big_w = (2 * h, 2 * w) if size == "even" else (2 * h - 1, 2 * w - 1)
    td, lat = _pair(16, h, w, big_h, big_w, DTYPES[dtype], seed=len(op) + h)
    want = _expression(td, lat, op)
    got = lfpn_fuse_cuda.lfpn_fuse_plain(td, lat, op)
    assert got.shape == lat.shape and got.dtype == lat.dtype
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(lfpn_fuse_cuda.lfpn_fuse(td, lat, op)), _bits(want))
    # The NaN corner reaches the outputs beside it; the infinities make
    # NaN where a zero weight meets them and infinities elsewhere.
    assert got[0, 0, 0, 0].isnan() and got[0, 0, 1, 1].isnan()
    assert got.isinf().any() and got[got.isfinite()].numel() > got.numel() // 2


# -- a model of the kernel's work ---------------------------------------------


def _source(dst, size):
    """csrc/lfpn_fuse.cu::source: ATen's source index of an output row or
    column at scale 2 -> (i0, i1, l0, l1).  Every value is exact in float32."""
    r = max(0.5 * (dst + 0.5) - 0.5, 0.0)
    i0 = int(r)
    l1 = r - i0
    return i0, i0 + (1 if i0 < size - 1 else 0), 1.0 - l1, l1


def _kernel_model(td, big_h, big_w):
    """The upsampled map (cropped to (H, W)) as the kernel computes it: a
    quad (i, j) loads source rows (a0, b0, b1) x columns (c0, d0, d1) and
    takes a1 = b0 if a0's second row is b0, else b1 (and c1 likewise)."""
    b, c, h, w = td.shape
    out = torch.full((b, c, big_h, big_w), float("nan"), dtype=td.dtype)
    for qi in range((big_h + 1) // 2):
        ra, rb = _source(2 * qi, h), _source(2 * qi + 1, h)
        rows = (ra[0], rb[0], rb[1])
        for qj in range((big_w + 1) // 2):
            ca, cb = _source(2 * qj, w), _source(2 * qj + 1, w)
            cols = (ca[0], cb[0], cb[1])
            p = [[td[:, :, rows[i], cols[j]] for j in range(3)] for i in range(3)]
            a1 = p[1] if ra[1] == rb[0] else p[2]
            left = 1 if ca[1] == cb[0] else 2
            quads = (
                ((p[0][0], p[0][left], a1[0], a1[left]), ra, ca, 0, 0),
                ((p[0][1], p[0][2], a1[1], a1[2]), ra, cb, 0, 1),
                ((p[1][0], p[1][left], p[2][0], p[2][left]), rb, ca, 1, 0),
                ((p[1][1], p[1][2], p[2][1], p[2][2]), rb, cb, 1, 1),
            )
            for (x00, x01, x10, x11), r, col, dy, dx in quads:
                y, x = 2 * qi + dy, 2 * qj + dx
                if y < big_h and x < big_w:
                    out[:, :, y, x] = (r[2] * (col[2] * x00 + col[3] * x01)
                                       + r[3] * (col[2] * x10 + col[3] * x11))
    return out


@pytest.mark.parametrize("h", [1, 2, 3, 4, 5])
def test_the_kernels_quads_give_atens_upsample(h):
    """Small integers in float64, so every sum is exact in any order: the
    model must equal ATen's upsample at every width 1-5 and crop."""
    g = torch.Generator().manual_seed(h)
    for w in range(1, 6):
        td = torch.randint(-64, 65, (2, 3, h, w), generator=g).double()
        up = layers._bilinear2x(td)
        for big_h in (2 * h - 1, 2 * h):
            for big_w in (2 * w - 1, 2 * w):
                got = _kernel_model(td, big_h, big_w)
                assert torch.equal(got, up[:, :, :big_h, :big_w]), (h, w, big_h, big_w)


def test_the_kernels_quads_propagate_what_aten_propagates():
    """A NaN, +inf or -inf at each source position of a 4 x 5 map: the
    model's outputs are NaN, infinite and finite where ATen's are, and
    equal where finite."""
    up_model, up_aten = [], []
    for pos in range(20):
        for special in (float("nan"), float("inf"), -float("inf")):
            td = torch.arange(20, dtype=torch.float64).reshape(1, 1, 4, 5) - 7
            td[0, 0, pos // 5, pos % 5] = special
            up_model.append(_kernel_model(td, 7, 9))
            up_aten.append(layers._bilinear2x(td)[:, :, :7, :9])
    got, want = torch.cat(up_model), torch.cat(up_aten)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isinf(), want.isinf())
    finite = want.isfinite()
    assert torch.equal(got[finite], want[finite]) and got.isnan().any()


# -- the wrapper ----------------------------------------------------------------


@pytest.mark.parametrize("case", ["td_nchw", "lat_nchw", "3d", "f16", "f64", "int", "mixed",
                                  "channels", "batch", "short_h", "short_w", "op", "device"])
def test_the_wrapper_refuses(case):
    def cl(*shape, dtype=torch.float32):
        return torch.zeros(*shape, dtype=dtype).contiguous(memory_format=torch.channels_last)

    td, lat, op = cl(2, 8, 3, 4), cl(2, 8, 6, 7), "product"
    if case == "td_nchw":
        td = torch.zeros(2, 8, 3, 4)
    elif case == "lat_nchw":
        lat = torch.zeros(2, 8, 6, 7)
    elif case == "3d":
        td = torch.zeros(8, 3, 4)
    elif case in ("f16", "f64", "int"):
        dtype = {"f16": torch.float16, "f64": torch.float64, "int": torch.int32}[case]
        td, lat = td.to(dtype), lat.to(dtype)
    elif case == "mixed":
        lat = lat.bfloat16()
    elif case == "channels":
        lat = cl(2, 16, 6, 7)
    elif case == "batch":
        lat = cl(3, 8, 6, 7)
    elif case == "short_h":
        lat = cl(2, 8, 7, 7)
    elif case == "short_w":
        lat = cl(2, 8, 6, 9)
    elif case == "op":
        op = "max"
    elif case == "device":
        td = td.to("meta")
    with pytest.raises((ValueError, TypeError)):
        lfpn_fuse_cuda.lfpn_fuse(td, lat, op)


def test_the_kernel_refuses_a_recorded_call_and_cpu_tensors():
    td = torch.zeros(2, 8, 3, 4).contiguous(memory_format=torch.channels_last)
    lat = torch.zeros(2, 8, 6, 8).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="autograd"):
        lfpn_fuse_cuda._launch(td.requires_grad_(), lat, "product")
    with pytest.raises(ValueError, match="CUDA"):
        lfpn_fuse_cuda._launch(td.detach(), lat, "product")


# -- the routing ------------------------------------------------------------------


@pytest.fixture
def counted(monkeypatch):
    """The calls of the wrapper, with the card's gate taken on the CPU (the
    wrapper runs the plain version there)."""
    calls = []
    real = lfpn_fuse_cuda.lfpn_fuse

    def counting(topdown, lateral, op):
        calls.append((tuple(topdown.shape), tuple(lateral.shape), op))
        return real(topdown, lateral, op)

    monkeypatch.setattr(lfpn_fuse_cuda, "lfpn_fuse", counting)
    monkeypatch.setattr(layers, "_on_card", lambda x: True)
    return calls


def _config(op="product", dtype="float32", size=64):
    return ModelConfig(image_size=size, compute_dtype=dtype, lfpn_fuse_op=op)


def _lfpn(op="product", seed=0):
    cfg = _config(op)
    module = lfpn.LFPN(cfg, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return module


def _taps(module, size=37, seed=2, nchw=False):
    """Channels-last taps of an odd-sized image (the crop on every block)."""
    from dan_tpu_torch.models.vgg import TAP_NAMES, raw_tap_channels

    g = torch.Generator().manual_seed(seed)
    sizes = {"conv3_3": size, "conv4_3": -(-size // 2), "conv5_3": -(-size // 4),
             "fc7": -(-size // 8)}
    taps = {}
    for name, ch in zip(TAP_NAMES, raw_tap_channels(module.config)):
        if name in sizes:
            t = _channels_last(torch.randn((2, sizes[name], sizes[name], ch), generator=g),
                               torch.float32)
            taps[name] = t.contiguous() if nchw else t
    return taps


def _aten_route(run, monkeypatch):
    """run() with the LFPN's gate shut and every other gate as it was: the
    LFPN's ATen passes on the same tensors."""
    monkeypatch.setattr(lfpn, "fused_epilogue", lambda *t: False)
    out = run()
    monkeypatch.setattr(lfpn, "fused_epilogue", layers.fused_epilogue)
    return out


@pytest.mark.parametrize("op", OPS)
def test_a_channels_last_lfpn_under_inference_takes_the_wrapper(counted, monkeypatch, op):
    module = _lfpn(op)
    taps = _taps(module)
    with torch.inference_mode():
        got = module(taps)
        assert [c[1] for c in counted] == [tuple(taps[lo].shape)
                                          for lo in ("conv5_3", "conv4_3", "conv3_3")]
        assert all(c[2] == op for c in counted)
        want = _aten_route(lambda: module(taps), monkeypatch)
    assert len(counted) == 3
    for lo in ("conv3_3", "conv4_3", "conv5_3"):
        assert got[lo].is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(_bits(got[lo]), _bits(want[lo]))


@pytest.mark.parametrize("route", ["nchw", "grad", "cpu"])
def test_other_lfpn_calls_keep_atens_passes(counted, monkeypatch, route):
    module = _lfpn()
    taps = _taps(module, nchw=route == "nchw")
    if route == "cpu":
        monkeypatch.setattr(layers, "_on_card", lambda x: x.is_cuda)
    with torch.set_grad_enabled(route == "grad"):
        got = module(taps)
    assert counted == []
    assert got["conv3_3"].requires_grad == (route == "grad")
    if route == "grad":
        got["conv3_3"].sum().backward()
        assert module.lfpn_td_conv3_3.weight.grad is not None


def _model(dtype, op, size=64, seed=0):
    model = DANDetector(_config(op, dtype, size), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return model.eval()


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("which", ["bf16", "int8"])
def test_a_tiny_forward_gives_the_same_logits_by_both_routes(monkeypatch, which, op):
    """The card's gate (taken on the CPU) calls the wrapper three times a
    forward; its plain version gives the logits of the CPU route bit for
    bit."""
    model = _model("bfloat16" if which == "bf16" else "float32", op)
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 64, 64, 3), generator=g) * 50
    with torch.inference_mode():
        if which == "int8":
            scales = quant.calibrate_act_scales(model, [x], model.config)
            model = quant.QuantizedDetector(model, scales).eval()
        calls = []
        real = lfpn_fuse_cuda.lfpn_fuse
        monkeypatch.setattr(layers, "_on_card", lambda t: True)
        monkeypatch.setattr(lfpn_fuse_cuda, "lfpn_fuse",
                            lambda t, l, o: calls.append((t.shape[1], o)) or real(t, l, o))
        got = model(x)
        want = _aten_route(lambda: model(x), monkeypatch)
    assert calls == [(c, op) for c in (512, 512, 256)]
    for a, b in zip(got, want):
        assert torch.equal(a, b)
