"""The tilings of the conv1_2' weight-gradient kernels (csrc/conv12_wgrad.cu
in bf16, csrc/conv12_wgrad_f32.cu in float32), checked on the CPU:
`conv12_wgrad_cuda.BF16.tiling` and `conv12_wgrad_cuda.F32.tiling` are the
pure-Python functions the launches use to share the pixels of o1 out to the
blocks.  Every tiling test runs on both plans.

For tap (kh, kw) the kernel pairs pixel (b, y, x) of o1 with pixel
(b, y + 1 - kh, x + 1 - kw) of dr, so a tiling is right when its segments
cover every pixel of o1 exactly once: then, for each tap, every pixel of
dr's (H+1) x (W+1) grid whose tap source lies inside o1 is multiplied
exactly once, and the others (the zero padding) not at all.  A numpy model
of the segment walk -- relu, the tap shift, zeros past W -- is also held
against the plain version (the model sums in float64, so the tolerance --
rtol 1e-5, atol 1e-4, that of the other weight-gradient tests -- is the
float32 rounding of the plain version alone).
"""
import numpy as np
import pytest
import torch

from dan_tpu_torch.ops import conv12_wgrad_cuda as wg

torch.set_num_threads(1)

SHAPES = [(32, 320, 320), (1, 320, 320), (3, 320, 320), (2, 37, 53), (1, 64, 65), (3, 1, 70)]
# Each kernel, and the blocks of an SM it may hold at once.
PLANS = {"bf16": (wg.BF16, 1), "float32": (wg.F32, 2)}


def _segments(plan):
    return [(r, seg) for r in range(plan.ranges) for seg in plan.segments(r)]


@pytest.mark.parametrize("kind", PLANS)
@pytest.mark.parametrize("b,h,w", SHAPES)
def test_tiling_covers_every_pixel_once(b, h, w, kind):
    mod, per_sm = PLANS[kind]
    plan = mod.tiling(b, h, w, 256, 256, sms=132)
    tiles = (4 * 256 // mod.TILE_M) * (256 // mod.TILE_N)
    segs = _segments(plan)
    assert plan.seg == mod.SEGMENT
    assert len(segs) == plan.total_segs == b * h * -(-w // mod.SEGMENT)
    # No range is empty, ranges x tiles fit the SMs, one partial a range.
    assert all(any(True for _ in plan.segments(r)) for r in range(plan.ranges))
    assert plan.partials == plan.ranges and plan.ranges * tiles <= per_sm * 132
    # o1's pixels: a difference array over the flattened (b, y, x) index.
    diff = np.zeros(b * h * w + 1, np.int64)
    for _, (bi, y, x0, x1) in segs:
        assert 0 <= bi < b and 0 <= y < h and 0 <= x0 < x1 <= w and x0 % mod.SEGMENT == 0
        assert x1 - x0 == min(mod.SEGMENT, w - x0)  # only a row's last segment is short
        base = (bi * h + y) * w
        diff[base + x0] += 1
        diff[base + x1] -= 1
    assert (np.cumsum(diff)[:-1] == 1).all()
    # dr's grid, tap by tap: covered once where the tap's source is inside
    # o1, never on the padding positions.
    for kh in (0, 1):
        for kw in (0, 1):
            cover = np.zeros((b, h + 1, w + 1), np.int32)
            for _, (bi, y, x0, x1) in segs:
                cover[bi, y + 1 - kh, x0 + 1 - kw:x1 + 1 - kw] += 1
            want = np.zeros((h + 1, w + 1), np.int32)
            want[1 - kh:h + 1 - kh, 1 - kw:w + 1 - kw] = 1
            assert (cover == want[None]).all()


@pytest.mark.parametrize("kind", PLANS)
@pytest.mark.parametrize("b,h,w", SHAPES)
def test_accumulation_chains_stay_within_the_flush_length(b, h, w, kind):
    mod, _ = PLANS[kind]
    plan = mod.tiling(b, h, w, 256, 256)
    assert plan.flush_segs * mod.SEGMENT == mod.FLUSH_PIXELS == {"bf16": 16384,
                                                                 "float32": 4096}[kind]
    total = 0
    for r in range(plan.ranges):
        chains = plan.chains(r)
        assert chains and max(chains) <= mod.FLUSH_PIXELS
        total += sum(chains)
    assert total == b * h * w


@pytest.mark.parametrize("kind,want", [
    # 13 chains a block: 12 full ones and the rest.
    ("bf16", ((5, 51200, 16, 3200), 13)),
    # Two blocks an SM: 16 tiles of 128 x 128 times 16 ranges = 256 blocks;
    # 50 chains of 4,096 pixels a block.
    ("float32", ((20, 204800, 16, 12800), 50)),
])
def test_tiling_of_the_train_shape(kind, want):
    plan = PLANS[kind][0].tiling(32, 320, 320, 256, 256, sms=132)
    assert (plan.segs_x, plan.total_segs, plan.ranges, plan.segs_per_range) == want[0]
    assert [len(plan.chains(r)) for r in range(plan.ranges)] == [want[1]] * 16


@pytest.mark.parametrize("kind", PLANS)
@pytest.mark.parametrize("sms,tiles_ci", [(132, 256), (108, 256), (8, 256), (4, 256), (132, 512)])
def test_tiling_adapts_to_the_card(sms, tiles_ci, kind):
    mod, per_sm = PLANS[kind]
    plan = mod.tiling(2, 40, 100, tiles_ci, 256, sms=sms)
    tiles = (4 * tiles_ci // mod.TILE_M) * (256 // mod.TILE_N)
    assert plan.ranges == max(1, per_sm * sms // tiles) or (
        plan.ranges * plan.segs_per_range >= plan.total_segs)
    assert (plan.ranges - 1) * plan.segs_per_range < plan.total_segs <= plan.ranges * plan.segs_per_range


def _model(o1, dr, plan):
    """dW (CO, CI, 2, 2) by walking the plan's segments as the kernel does:
    raw o1 boxes of a segment's pixels with zeros past W, relu, dr shifted
    by the tap, one partial a range, the partials summed in range order."""
    b, h, w, ci = o1.shape
    co = dr.shape[-1]
    seg = plan.seg
    dr_pad = np.zeros((b, h + 1, w + 1 + seg, co))
    dr_pad[:, :, :w + 1] = dr
    o1_pad = np.zeros((b, h, plan.segs_x * seg, ci))
    o1_pad[:, :, :w] = o1
    out = np.zeros((co, ci, 2, 2))
    for r in range(plan.ranges):
        partial = np.zeros_like(out)
        for bi, y, x0, _ in plan.segments(r):
            a = np.maximum(o1_pad[bi, y, x0:x0 + seg], 0.0)  # (seg, CI)
            for kh in (0, 1):
                for kw in (0, 1):
                    bb = dr_pad[bi, y + 1 - kh, x0 + 1 - kw:x0 + 1 - kw + seg]  # (seg, CO)
                    partial[:, :, kh, kw] += bb.T @ a
        out += partial
    return out


@pytest.mark.parametrize("kind", PLANS)
@pytest.mark.parametrize("b,h,w", [(2, 5, 70), (1, 3, 64), (3, 4, 9)])
def test_segment_walk_equals_plain(b, h, w, kind):
    rng = np.random.default_rng(b * 100 + w)
    o1 = rng.normal(size=(b, h, w, 8)).astype(np.float32)
    dr = rng.normal(size=(b, h + 1, w + 1, 16)).astype(np.float32)
    # The plan depends on the pixels alone.
    plan = PLANS[kind][0].tiling(b, h, w, 256, 256)
    want = wg.conv12_wgrad_plain(torch.from_numpy(o1), torch.from_numpy(dr)).numpy()
    np.testing.assert_allclose(_model(o1, dr, plan), want, rtol=1e-5, atol=1e-4)


def test_cpu_float32_takes_the_plain_version():
    """A float32 CPU tensor never reaches either kernel; the launch refuses
    a float32 CPU tensor; the dtypes the launch dispatches on are those
    kernel_takes takes, each to its own kernel."""
    rng = np.random.default_rng(4)
    o1 = torch.from_numpy(rng.normal(size=(1, 3, 5, 128)).astype(np.float32))
    dr = torch.from_numpy(rng.normal(size=(1, 4, 6, 256)).astype(np.float32))
    before = (wg.BF16.LAUNCHES, wg.F32.LAUNCHES)
    got = wg.conv12_wgrad(o1, dr)
    assert (wg.BF16.LAUNCHES, wg.F32.LAUNCHES) == before
    assert torch.equal(got, wg.conv12_wgrad_plain(o1, dr))
    with pytest.raises(ValueError, match="CUDA tensors"):
        wg._launch(o1, dr)
    assert wg.KERNELS == {torch.bfloat16: wg.BF16, torch.float32: wg.F32}
    assert (wg.BF16.SOURCE, wg.F32.SOURCE) == ("conv12_wgrad", "conv12_wgrad_f32")


@pytest.mark.parametrize(
    "what,error",
    [("float16", TypeError), ("float64", TypeError), ("not_contiguous", ValueError),
     ("ci_64", ValueError), ("co_128", ValueError), ("empty", ValueError),
     ("cpu_launch", ValueError)],
)
def test_kernel_refuses_what_it_does_not_take(what, error):
    o1 = torch.zeros((2, 3, 5, 128), dtype=torch.bfloat16)
    dr = torch.zeros((2, 4, 6, 256), dtype=torch.bfloat16)
    for dtype in (torch.bfloat16, torch.float32):  # what the kernels do take
        wg.kernel_takes(o1.to(dtype), dr.to(dtype))
        wg.kernel_takes(torch.zeros((1, 3, 5, 256), dtype=dtype),
                        torch.zeros((1, 4, 6, 512), dtype=dtype))  # any batch size
    if what == "cpu_launch":
        for dtype in (torch.bfloat16, torch.float32):
            with pytest.raises(error, match="CUDA tensors"):
                wg._launch(o1.to(dtype), dr.to(dtype))
        return
    if what in ("float16", "float64"):
        o1, dr = o1.to(getattr(torch, what)), dr.to(getattr(torch, what))
    elif what == "not_contiguous":
        o1 = torch.zeros((2, 128, 3, 5), dtype=torch.bfloat16).permute(0, 2, 3, 1)
    elif what == "ci_64":
        o1 = o1[..., :64].contiguous()
    elif what == "co_128":
        dr = dr[..., :128].contiguous()
    elif what == "empty":
        o1, dr = o1[:0], dr[:0]
    with pytest.raises(error):
        wg.kernel_takes(o1, dr)
