"""The gradient of the LFPN's 2x bilinear upsample (ops/upsample_cuda.py, the
kernel csrc/upsample2x_bwd.cu) against the JAX package: the plain version
(slice sums in float32, rounded once) against jax.vjp of
dan_tpu.models.layers.upsample2x (XLA's transpose of jax.image.resize's
dots), NHWC <-> NCHW.  A numpy model of the kernel's gather (the wrapper's
plan: items of several whole planes or of bands of output rows, each a span
of g that a ring stage holds; outputs in groups along a row, each from the
clamped patch of its four g rows; the same float32 operations in the same
order) equals the plain version bit for bit, which is what the card checks
of chip_smoke.py hold the kernel to."""
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


def _items(p, planes, h, w):
    """The kernel's item_at: (first plane, planes, first output row, output
    rows, first g row, span start, span elements) of each item of plan p."""
    for it in range(p.items):
        if p.bands == 1:
            p0, np_, i0, rows = it * p.per_item, min(p.per_item, planes - it * p.per_item), 0, h
        else:
            p0, b = divmod(it, p.bands)
            np_, i0 = 1, b * p.band
            rows = min(p.band, h - i0)
        lo, hi = max(2 * i0 - 1, 0), min(2 * (i0 + rows), 2 * h - 1)
        yield (p0, np_, i0, rows, lo, (p0 * 2 * h + lo) * 2 * w,
               ((np_ - 1) * 2 * h + hi - lo + 1) * 2 * w)


def _kernel_model(g, stage_bytes, aligned=True):
    """csrc/upsample2x_bwd.cu in numpy float32, cut as upsample_cuda.plan cuts
    it: each item's span of g alone (what a ring stage holds), its outputs in
    groups of plan.group along a row, each group from the clamped patch of
    its four g rows and 2G + 2 columns (the H-pass values t at the group's
    two edge columns recomputed, as a lane at a warp's edge does), each sum
    ((0.25 a + 0.75 b) + 0.75 c) + 0.25 d with every product and sum rounded
    to float32; one cast.  Every output is written exactly once."""
    n, c, h2, w2 = g.shape
    h, w = h2 // 2, w2 // 2
    p = upsample_cuda.plan(n * c, h, w, g.element_size(), aligned, stage_bytes)
    f = np.float32
    flat = g.float().numpy().reshape(-1)
    out = np.full((n * c, h, w), np.nan, np.float32)

    def adjoint4(a, b, cc, d):
        s = (f(0.25) * a).astype(f) + (f(0.75) * b).astype(f)
        s = s.astype(f) + (f(0.75) * cc).astype(f)
        return (s.astype(f) + (f(0.25) * d).astype(f)).astype(f)

    gs = p.group
    for p0, np_, i0, rows, lo, begin, count in _items(p, n * c, h, w):
        assert count * g.element_size() <= p.stage_bytes
        stage = flat[begin:begin + count]
        lp, r, j = np.meshgrid(np.arange(np_), np.arange(rows), np.arange(0, w, gs), indexing="ij")
        i = i0 + r
        base = lp * h2 - lo
        g_rows = [base + np.maximum(2 * i - 1, 0), base + 2 * i, base + 2 * i + 1,
                  base + np.minimum(2 * i + 2, h2 - 1)]
        # t at columns 2j - 1 .. 2j + 2G, clamped: the group's 2G + its two edges.
        t = []
        for k in range(-1, 2 * gs + 1):
            col = np.clip(2 * j + k, 0, w2 - 1)
            idx = [gr * w2 + col for gr in g_rows]
            assert all(x.min() >= 0 and x.max() < count for x in idx)
            t.append(adjoint4(*(stage[x] for x in idx)))
        for m in range(gs):
            o = adjoint4(t[2 * m], t[2 * m + 1], t[2 * m + 2], t[2 * m + 3])
            at = (p0 + lp, i, j + m)
            assert np.isnan(out[at]).all()
            out[at] = o
    assert not np.isnan(out).any()
    return torch.from_numpy(out.reshape(n, c, h, w)).to(g.dtype)


def _stage_cases(h, w, elem):
    """Stage sizes that make items of one output row (0: the least stage,
    four g rows), of a few rows, and of several whole planes."""
    row = 2 * w * elem
    return sorted({0, 8 * row, 2 * h * row * 3, upsample_cuda.STAGE_BYTES})


# (H, W): the earlier band cases, then several planes an item (3 x 8), a W
# that is no multiple of a bf16 group (6 x 6), odd W (4 x 9) and a plane cut
# into uneven bands (7 x 12).
@pytest.mark.parametrize("h,w", [(1, 1), (5, 7), (20, 20), (40, 40), (3, 8), (6, 6), (4, 9),
                                 (7, 12)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_model_equals_plain_bit_for_bit(h, w, dtype):
    """Items of bands of 1 and a few rows (the band edges: two rows of g
    shared with the neighbour, clamped at the plane's first and last row)
    and of whole planes, several an item with a shorter last item; groups
    of 8 // elem outputs and of 1 (a g off 16 bytes, a W no multiple of the
    group)."""
    gen = torch.Generator().manual_seed(h * 7 + w)
    g = torch.randn(2, 3, 2 * h, 2 * w, generator=gen).to(dtype)
    want = upsample2x_bwd_plain(g)
    elem = g.element_size()
    kinds = set()
    for stage in _stage_cases(h, w, elem):
        for aligned in (True, False):
            p = upsample_cuda.plan(6, h, w, elem, aligned, stage)
            kinds.add((p.bands > 1, p.per_item > 1, p.group))
            assert torch.equal(_kernel_model(g, stage, aligned), want), (stage, aligned, p)
    if h > 1:
        assert (True, False, 1) in kinds  # bands
    assert any(k[1] for k in kinds)  # several planes an item
    if w % (8 // elem) == 0:
        assert any(k[2] == 8 // elem for k in kinds)


@pytest.mark.parametrize("shape,per_item,bands", [((32, 512, 40, 40), 5, 1),
                                                  ((32, 512, 80, 80), 1, 1),
                                                  ((32, 256, 160, 160), 1, 4)])
def test_plan_at_the_train_shapes_covers_every_output_row_once(shape, per_item, bands):
    """A train step's three bf16 gradients: whole planes, 5 an item (16 KB),
    one plane an item (12.8 KB), or bands of 20 rows (13.4 KB with the
    halo); groups of 4 outputs; every output row of every plane in exactly
    one item, every span within its stage."""
    n, c, h2, w2 = shape
    h, w = h2 // 2, w2 // 2
    p = upsample_cuda.plan(n * c, h, w, 2)
    assert (p.per_item, p.bands, p.group, p.stage_bytes) == (per_item, bands, 4, 16 * 1024)
    seen = np.zeros((n * c, h), np.int32)
    for p0, np_, i0, rows, lo, begin, count in _items(p, n * c, h, w):
        assert count * 2 <= p.stage_bytes
        assert begin == (p0 * h2 + lo) * w2  # a contiguous span
        seen[p0:p0 + np_, i0:i0 + rows] += 1
    assert (seen == 1).all()


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
