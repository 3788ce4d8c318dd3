"""The gradient of the LFPN's 2x bilinear upsample (ops/upsample_cuda.py, the
kernel csrc/upsample2x_bwd.cu) against the JAX package: the plain version
(slice sums in float32, rounded once) against jax.vjp of
dan_tpu.models.layers.upsample2x (XLA's transpose of jax.image.resize's
dots), NHWC <-> NCHW.  A numpy model of the kernel's gather (bands of output
rows, each output from its clamped 4x4 patch, the same float32 operations in
the same order) equals the plain version bit for bit, which is what the card
checks of chip_smoke.py hold the kernel to."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dan_tpu.models import layers as jl
from dan_tpu_torch.models import layers as tl
from dan_tpu_torch.ops import _cuda_build, upsample_cuda
from dan_tpu_torch.ops.upsample_cuda import upsample2x_bwd, upsample2x_bwd_plain

torch.set_num_threads(1)

# (H, W, C) of the upsample's input: one pixel, odd sizes, and the LFPN's
# three levels at 640x640 (fc7 20x20, conv5_3 40x40, conv4_3 80x80) cut to a
# few channels.
SHAPES = [(1, 1, 3), (5, 7, 3), (3, 2, 2), (20, 20, 4), (40, 40, 4), (80, 80, 2)]


def _case(h, w, c, dtype, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((2, 2 * h, 2 * w, c)).astype(np.float32)
    return np.asarray(jnp.asarray(g).astype(dtype).astype(jnp.float32))


def _jax_grad(g_nhwc, h, w, dtype):
    x = jnp.zeros((g_nhwc.shape[0], h, w, g_nhwc.shape[3]), dtype)
    _, vjp = jax.vjp(jl.upsample2x, x)
    return np.asarray(vjp(jnp.asarray(g_nhwc).astype(dtype))[0].astype(jnp.float32))


def _nchw(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(dtype)


@pytest.mark.parametrize("h,w,c", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gradient_vs_jax_vjp(h, w, c, dtype):
    """float32: XLA's dots and the slice sums differ only in rounding, by at
    most 8 ulp of max |g| (measured 2.2e-7 max |g|).  bf16: the port rounds
    once, within half a bf16 ulp of the result's bound 4 max |g| of the
    exact float64 sums (2^-7 max |g|; measured 0.0034), and XLA's transpose
    rounds each of its two dots to bf16, so the two are held within 2^-6
    max |g| (measured 0.0081)."""
    g = _case(h, w, c, dtype, seed=100 * h + w)
    tdtype = getattr(torch, dtype)
    got = upsample2x_bwd_plain(_nchw(g, tdtype))
    assert got.dtype == tdtype and got.shape == (2, c, h, w)
    got = got.float().permute(0, 2, 3, 1).numpy()
    want = _jax_grad(g, h, w, dtype)
    gmax = float(np.abs(g).max())
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=8 * 2.0**-23 * gmax)
    else:
        exact = upsample2x_bwd_plain(_nchw(g, torch.float64)).permute(0, 2, 3, 1).numpy()
        assert np.abs(got - exact).max() <= 2.0**-7 * gmax
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-6 * gmax)


def _kernel_model(g, band):
    """csrc/upsample2x_bwd.cu in numpy float32: one block a band of `band`
    output rows of a plane; the band's g rows lo..hi; the H pass into a
    float32 band, then the W pass, each sum ((0.25 a + 0.75 b) + 0.75 c) +
    0.25 d with every product and sum rounded to float32; one cast."""
    n, c, h2, w2 = g.shape
    h, w = h2 // 2, w2 // 2
    f = np.float32
    gf = g.float().numpy().reshape(n * c, h2, w2)
    out = np.empty((n * c, h, w), np.float32)

    def adjoint4(a, b, cc, d):
        s = (f(0.25) * a).astype(f) + (f(0.75) * b).astype(f)
        s = s.astype(f) + (f(0.75) * cc).astype(f)
        return (s.astype(f) + (f(0.25) * d).astype(f)).astype(f)

    for p in range(n * c):
        for i0 in range(0, h, band):
            rows = min(band, h - i0)
            lo, hi = max(2 * i0 - 1, 0), min(2 * (i0 + rows), h2 - 1)
            gs = gf[p, lo:hi + 1]
            t = np.empty((rows, w2), np.float32)
            for r in range(rows):
                i = i0 + r
                t[r] = adjoint4(gs[max(2 * i - 1, 0) - lo], gs[2 * i - lo], gs[2 * i + 1 - lo],
                                gs[min(2 * i + 2, h2 - 1) - lo])
            j = np.arange(w)
            out[p, i0:i0 + rows] = adjoint4(t[:, np.maximum(2 * j - 1, 0)], t[:, 2 * j],
                                            t[:, 2 * j + 1], t[:, np.minimum(2 * j + 2, w2 - 1)])
    return torch.from_numpy(out.reshape(n, c, h, w)).to(g.dtype)


@pytest.mark.parametrize("h,w", [(1, 1), (5, 7), (20, 20), (40, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_model_equals_plain_bit_for_bit(h, w, dtype):
    """Bands of 1, 3 and all rows (the band edges: two rows of g shared with
    the neighbour, clamped at the plane's first and last row)."""
    gen = torch.Generator().manual_seed(h * 7 + w)
    g = torch.randn(2, 3, 2 * h, 2 * w, generator=gen).to(dtype)
    want = upsample2x_bwd_plain(g)
    for band in sorted({1, 3, h}):
        assert torch.equal(_kernel_model(g, band), want), band


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_default_path_on_cpu_keeps_atens_backward(dtype):
    """On the CPU the default upsample keeps ATen's deterministic backward
    (its grad_fn is upsample_bilinear2d's); under the deterministic mode it
    takes _Upsample2x, whose CPU gradient is the plain version bit for bit.
    Both gradients agree to float32 rounding."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 3, 5, 7, generator=gen).to(dtype).requires_grad_()
    g = torch.randn(2, 3, 10, 14, generator=gen).to(dtype)
    y = tl.upsample2x(x)
    assert "UpsampleBilinear2D" in type(y.grad_fn).__name__
    (aten,) = torch.autograd.grad(y, x, g)
    torch.use_deterministic_algorithms(True)
    try:
        y2 = tl.upsample2x(x)
        (ours,) = torch.autograd.grad(y2, x, g)
    finally:
        torch.use_deterministic_algorithms(False)
    assert type(y2.grad_fn).__name__ == "_Upsample2xBackward"
    assert torch.equal(y2, y)
    assert torch.equal(ours, upsample2x_bwd_plain(g))
    unit = {torch.float32: 2.0**-21, torch.bfloat16: 2.0**-6}[dtype]
    assert float((ours.double() - aten.double()).abs().max()) <= unit * float(g.abs().max())


def test_wrapper_takes_the_plain_version_on_cpu_and_checks_its_inputs():
    g = torch.randn(2, 3, 10, 14, generator=torch.Generator().manual_seed(0))
    upsample_cuda.LAUNCHES = 0
    assert torch.equal(upsample2x_bwd(g), upsample2x_bwd_plain(g))
    assert torch.equal(upsample2x_bwd(g.bfloat16()), upsample2x_bwd_plain(g.bfloat16()))
    assert torch.equal(upsample2x_bwd(g.double()), upsample2x_bwd_plain(g.double()))
    assert upsample_cuda.LAUNCHES == 0
    with pytest.raises(TypeError):
        upsample2x_bwd(g.half())
    with pytest.raises(TypeError):
        upsample_cuda._launch(g.double())  # the kernel takes bf16 and float32 only
    with pytest.raises(ValueError):
        upsample2x_bwd(g[:, :, :9])  # odd height
    with pytest.raises(ValueError):
        upsample2x_bwd(g[0])  # not NCHW
    with pytest.raises(ValueError, match="CUDA"):
        upsample_cuda._launch(g)  # the kernel path refuses CPU tensors
    with pytest.raises(ValueError, match="contiguous"):
        upsample_cuda._launch(g.transpose(2, 3))


def test_source_is_built_without_fma_contraction():
    assert "-fmad=false" in _cuda_build._flags("upsample2x_bwd")
    assert [p.rsplit("/", 1)[-1] for p in _cuda_build.sources("upsample2x_bwd")] == [
        "upsample2x_bwd.cu"]
