"""The int8 convolution kernel's launch plan (ops/conv_i8_cuda.py::plan),
replayed on the CPU.

The kernel (csrc/conv_i8.cu) runs only on the card.  What it does with the
plan is plain arithmetic, replayed here in torch: each tile's k-steps
gather their TMA boxes with zero fill outside the tensor (as TMA does) and
add slice by slice into an exact sum; the masked epilogue writes the
pixels inside the output.  The replay must equal conv_i8_plain bit for bit
at every layer geometry of the default config (real Ci, Co, kernel,
stride, dilation and TF 'SAME' pads, batch and spatial size cut), and the
phase-max mode must equal quant.phase_max_i8 of the plain conv's q.
"""
import itertools

import numpy as np
import pytest
import torch

from dan_tpu_torch.models.vgg import pack_conv_kernel_2x2_phase
from dan_tpu_torch.ops import conv_i8_cuda as ci
from dan_tpu_torch.ops.conv_i8 import (
    conv_i8_epilogue_plain,
    conv_i8_plain,
    phase_max_i8,
    same_padding_2d,
)
from dan_tpu_torch.quant import QuantConv, quantize_kernel

torch.set_num_threads(1)

# (name, Ci, Co, k, stride, dilation, input size at 640x640): the 18 int8
# convolutions of the default config's forward.
LAYERS = [
    ("conv1_2p", 256, 256, 2, 1, 1, 320),
    ("conv2_1", 64, 128, 3, 1, 1, 320),
    ("conv2_2", 128, 128, 3, 1, 1, 320),
    ("conv3_1", 128, 256, 3, 1, 1, 160),
    ("conv3_2", 256, 256, 3, 1, 1, 160),
    ("conv3_3", 256, 256, 3, 1, 1, 160),
    ("conv4_1", 256, 512, 3, 1, 1, 80),
    ("conv4_2", 512, 512, 3, 1, 1, 80),
    ("conv4_3", 512, 512, 3, 1, 1, 80),
    ("conv5_1", 512, 512, 3, 1, 1, 40),
    ("conv5_2", 512, 512, 3, 1, 1, 40),
    ("conv5_3", 512, 512, 3, 1, 1, 40),
    ("fc6", 512, 1024, 3, 1, 6, 20),
    ("fc7", 1024, 1024, 1, 1, 1, 20),
    ("conv6_1", 1024, 256, 1, 1, 1, 20),
    ("conv6_2", 256, 512, 3, 2, 1, 20),
    ("conv7_1", 512, 128, 1, 1, 1, 10),
    ("conv7_2", 128, 256, 3, 2, 1, 10),
]
# Cut sizes: (b, h, w) a layer is replayed at.  Odd and ragged on purpose;
# fc6 keeps 20x20 so that its dilation 6 reaches across the image.
SMALL = {"fc6": (1, 20, 20), "conv6_2": (2, 11, 9), "conv7_2": (1, 5, 7), "conv7_1": (2, 5, 5)}


def _layer_padding(k, s, d, h, w, name):
    return (1, 1, 1, 1) if name == "conv1_2p" else same_padding_2d(h, w, k, k, s, d)


def _rand_i8(rng, shape, zeros=0.5):
    x = rng.integers(-127, 128, shape).astype(np.int8)
    x[rng.random(shape) < zeros] = 0
    return torch.from_numpy(x)


def a_box(p, x, t, step):
    """The A box of step at tile t: (128, slice) int64, rows in the tile's
    pixel order, zeros outside x (TMA's fill), `stride` apart."""
    c, x0, y0, b = p.a_coords(t, step)
    _, h, w, _ = x.shape
    ys = y0 + p.stride * torch.arange(p.rows)
    xs = x0 + p.stride * torch.arange(p.cols)
    inside = ((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None, :]
    box = x[b, ys.clamp(0, h - 1)][:, xs.clamp(0, w - 1), c:c + p.slice].long()
    return (box * inside[..., None]).reshape(p.tile_m, p.slice)


def b_box(p, kmat, t, step):
    """The B box: (nb, slice) rows of k as (Co, kh*kw*Ci), zeros past Co."""
    kk, n = p.b_coords(t, step)
    rows = kmat[n:n + p.nb, kk:kk + p.slice]
    return torch.cat([rows, rows.new_zeros((p.nb - rows.shape[0], p.slice))])


def replay(p, x, k, tiles=None):
    """The kernel's sums, replayed from the plan: {(group, tile): (128, nb)
    int64}, and the output written by the masked epilogue, int32 (b, ho,
    wo, co) (normal mode) or (b, ho, wo, 4, 64) (phase mode: each group's
    sum), with a count of how often each output element was written."""
    kmat = k.reshape(k.shape[0], -1).long()
    groups = 4 if p.phase_max else 1
    width = p.bn * (1 if p.phase_max else p.n_tiles)
    out = torch.zeros((p.b, p.ho, p.wo, groups, width), dtype=torch.int64)
    written = torch.zeros((p.b, p.ho, p.wo, groups, width), dtype=torch.int32)
    for t in range(p.total_tiles) if tiles is None else tiles:
        acc = torch.zeros((groups, p.tile_m, p.nb), dtype=torch.int64)
        for stage in p.stages():
            a = a_box(p, x, t, stage[0])  # one A box a stage, at its first step's coordinates
            for step in stage:
                acc[step.group] += a @ b_box(p, kmat, t, step).T
        _, _, _, n0 = p.tile(t)
        nn = min(p.bn, p.co_out - n0) if not p.phase_max else p.bn
        for r, b, oy, ox in ci.tile_pixels(p, t):
            if p.phase_max:
                out[b, oy, ox] += acc[:, r]
                written[b, oy, ox] += 1
            else:
                out[b, oy, ox, 0, n0:n0 + nn] += acc[0, r, :nn]
                written[b, oy, ox, 0, n0:n0 + nn] += 1
    if not p.phase_max:
        out = out.reshape(p.b, p.ho, p.wo, -1)[..., :p.co]
        written = written.reshape(p.b, p.ho, p.wo, -1)[..., :p.co]
    return out, written


def _layer_case(name):
    _, cin, co, k, s, d, _ = next(layer for layer in LAYERS if layer[0] == name)
    b, h, w = SMALL.get(name, (1, 9, 12))
    rng = np.random.default_rng(sum(map(ord, name)))
    x = _rand_i8(rng, (b, h, w, cin))
    kq = _rand_i8(rng, (co, k, k, cin), zeros=0.0)
    return x, kq, s, d, _layer_padding(k, s, d, h, w, name)


@pytest.mark.parametrize("name", [layer[0] for layer in LAYERS])
def test_plan_replay_is_bit_identical_to_plain(name):
    x, kq, s, d, pad = _layer_case(name)
    b, h, w, cin = x.shape
    co, k = kq.shape[0], kq.shape[1]
    p = ci.plan(b, h, w, cin, co, k, k, s, d, pad)
    got, written = replay(p, x, kq)
    want = conv_i8_plain(x, kq, s, d, pad)
    assert got.shape == want.shape
    assert bool((written == 1).all()), "an output element written other than once"
    assert torch.equal(got.to(torch.int32), want)


@pytest.mark.parametrize("case", [
    # (what, b, h, w, Ci, Co, k, stride, dilation, padding)
    ("37x53 odd input, conv2_1 of the unpacked path", 1, 19, 27, 64, 128, 3, 1, 1, None),
    ("37x53 odd input, conv3_1", 1, 10, 14, 128, 256, 3, 1, 1, None),
    ("ragged N: Co 64 in a 128 tile", 1, 7, 9, 64, 64, 3, 1, 1, None),
    ("ragged N: Co 192 in a 256 tile", 1, 7, 9, 128, 192, 3, 1, 1, None),
    ("ragged N: Co 320, two 256 tiles", 1, 5, 6, 128, 320, 1, 1, 1, None),
    ("stride 2 on an odd size, asymmetric pads", 1, 9, 7, 128, 256, 3, 2, 1, None),
    ("explicit asymmetric padding", 2, 6, 5, 64, 128, 3, 1, 2, (0, 3, 2, 1)),
    ("conv1_2' normal mode at an odd grid", 1, 7, 5, 256, 256, 2, 1, 1, (1, 1, 1, 1)),
])
def test_plan_replay_edge_cases(case):
    what, b, h, w, cin, co, k, s, d, pad = case
    pad = pad or same_padding_2d(h, w, k, k, s, d)
    rng = np.random.default_rng(len(what))
    x = _rand_i8(rng, (b, h, w, cin))
    kq = _rand_i8(rng, (co, k, k, cin), zeros=0.0)
    p = ci.plan(b, h, w, cin, co, k, k, s, d, pad)
    got, written = replay(p, x, kq)
    assert bool((written == 1).all()), what
    assert torch.equal(got.to(torch.int32), conv_i8_plain(x, kq, s, d, pad)), what


def test_conv1_2_at_321_output_edge_tiles():
    """conv1_2' at its real grid (320x320 input, (1, 1, 1, 1) padding, 321x321
    output): the tiles on the four edges (ragged in both directions, reading
    the padding) and one inside, replayed against plain at their pixels."""
    rng = np.random.default_rng(321)
    x = _rand_i8(rng, (1, 320, 320, 256), zeros=0.9)
    kq = _rand_i8(rng, (256, 2, 2, 256), zeros=0.0)
    p = ci.plan(1, 320, 320, 256, 256, 2, 2, 1, 1, (1, 1, 1, 1))
    assert (p.ho, p.wo) == (321, 321)
    edge = [t for t in range(p.total_tiles)
            if p.tile(t)[1] in (0, (p.tiles_y - 1) * p.rows)
            or p.tile(t)[2] in (0, (p.tiles_x - 1) * p.cols)]
    tiles = sorted(set(edge[::7] + [edge[-1], p.total_tiles // 2]))
    got, written = replay(p, x, kq, tiles)
    sel = written.bool()
    want = conv_i8_plain(x, kq, 1, 1, (1, 1, 1, 1))
    assert int(sel.sum()) > 0 and bool(sel[0, 320, 320].all())
    assert torch.equal(got[sel].to(torch.int32), want[sel])


@pytest.mark.parametrize("b, h, w, cin, co, k, s, d", [
    (128, 320, 320, 64, 128, 3, 1, 1),   # conv2_1 at the bench shape
    (128, 160, 160, 128, 256, 3, 1, 1),  # conv3_1
    (128, 40, 40, 512, 512, 3, 1, 1),    # conv5_x
    (128, 20, 20, 512, 1024, 3, 1, 6),   # fc6
    (128, 10, 10, 128, 256, 3, 2, 1),    # conv7_2
    (3, 37, 53, 64, 128, 3, 1, 1),
])
def test_plan_covers_every_output_once_and_every_tile_once(b, h, w, cin, co, k, s, d):
    """At the bench shapes: the blocks' persistent walks visit every tile
    once, and the tiles' masked pixels x channel tiles cover every output
    element once (counted, not computed)."""
    p = ci.plan(b, h, w, cin, co, k, k, s, d, same_padding_2d(h, w, k, k, s, d))
    visited = np.concatenate([np.asarray(p.block_tiles(i)) for i in range(p.grid)])
    assert np.array_equal(np.sort(visited), np.arange(p.total_tiles))
    assert p.grid == min(p.total_tiles, 132)
    # Tile t -> (b, oy0, ox0, n0) is one to one onto the grid of tile
    # origins, and that grid covers the output once: rows, columns and
    # channel tiles are consecutive, and only the last of each runs past the
    # output (the kernel masks the rest).
    origins = {p.tile(t) for t in range(p.total_tiles)}
    assert len(origins) == p.total_tiles
    assert origins == set(itertools.product(range(b), range(0, p.tiles_y * p.rows, p.rows),
                                            range(0, p.tiles_x * p.cols, p.cols),
                                            range(0, p.n_tiles * p.bn, p.bn)))
    assert p.tiles_y * p.rows >= p.ho > (p.tiles_y - 1) * p.rows
    assert p.tiles_x * p.cols >= p.wo > (p.tiles_x - 1) * p.cols
    assert p.n_tiles * p.bn >= p.co > (p.n_tiles - 1) * p.bn
    # The channel tile runs fastest: consecutive tiles share their A boxes.
    assert p.tile(1)[:3] == p.tile(0)[:3] or p.n_tiles == 1


def _packed_case(rng, b, h, w):
    kf = torch.from_numpy(rng.standard_normal((64, 64, 3, 3)).astype(np.float32))
    k2q, _ = quantize_kernel(pack_conv_kernel_2x2_phase(kf))
    x = _rand_i8(rng, (b, h, w, 256))
    deq = torch.from_numpy(rng.uniform(1e-6, 1e-5, 256).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-1, 1, 64).astype(np.float32)).repeat(4)
    inv = torch.from_numpy(rng.uniform(1, 20, 64).astype(np.float32)).repeat(4)
    return x, k2q, deq, bias, inv


def test_packed_zero_mask_is_the_packers():
    """The zero taps the phase-max plan may leave out are exactly the zeros
    models/vgg.py::pack_conv_kernel_2x2_phase leaves: 7 of 16 (tap, input
    phase) blocks of each group."""
    kf = torch.randn((64, 64, 3, 3), generator=torch.Generator().manual_seed(0))
    kp = pack_conv_kernel_2x2_phase(kf).permute(0, 2, 3, 1)  # (Co, kh, kw, Ci)
    assert torch.equal(ci.packed_zero_mask(), kp == 0)
    k2q, _ = quantize_kernel(pack_conv_kernel_2x2_phase(kf))
    assert ci.packed_zeros_hold(k2q)
    k2q[0, 0, 0, 0] = 1  # a zero tap (group 0, tap (0, 0), input phase 0) made nonzero
    assert not ci.packed_zeros_hold(k2q)
    assert not ci.packed_zeros_hold(torch.zeros((256, 3, 3, 256), dtype=torch.int8))


@pytest.mark.parametrize("b, h, w", [(1, 6, 10), (2, 5, 3), (1, 1, 1)])
def test_phase_max_replay_equals_phase_max_of_plain(b, h, w):
    """The phase-max plan replayed (each group's sum, its epilogue, the max)
    equals phase_max_i8 of the plain conv's q bit for bit.  The plan leaves
    out the packed form's zero taps and shares each A box between the
    groups it feeds: 16 stages, 36 k-steps, 9 a group, in the kernel's
    static order (groups ascending within a stage, one A box a stage)."""
    rng = np.random.default_rng(b * 100 + h)
    x, k2q, deq, bias, inv = _packed_case(rng, b, h, w)
    p = ci.plan(b, h, w, 256, 256, 2, 2, 1, 1, (1, 1, 1, 1), True)
    assert (p.ho, p.wo, p.co_out, len(p.steps), p.stages_per_tile) == (h, w, 64, 36, 16)
    assert sorted(p.stage_steps) == [1] * 4 + [2] * 8 + [4] * 4 and p.b_slots == 4
    assert [sum(s.group == g for s in p.steps) for g in range(4)] == [9] * 4
    for stage in p.stages():
        assert [s.group for s in stage] == sorted({s.group for s in stage})
        assert {(s.c, s.dx, s.dy) for s in stage} == {(stage[0].c, stage[0].dx, stage[0].dy)}
    sums, written = replay(p, x, k2q)
    assert bool((written == 1).all())
    qs = [conv_i8_epilogue_plain(sums[..., g, :].to(torch.int32), deq[64 * g:64 * g + 64],
                                 bias[64 * g:64 * g + 64], inv[64 * g:64 * g + 64])[1]
          for g in range(4)]
    got = torch.maximum(torch.maximum(qs[0], qs[1]), torch.maximum(qs[2], qs[3]))
    _, q_all = conv_i8_epilogue_plain(conv_i8_plain(x, k2q, 1, 1, (1, 1, 1, 1)), deq, bias, inv)
    assert torch.equal(got, phase_max_i8(q_all, 64))
    # The CPU path of the wrapper gives the same pool1, without a launch.
    launches = ci.LAUNCHES
    out = ci.conv_i8(x, k2q, deq, bias, inv, 1, 1, (1, 1, 1, 1), phase_max=True)
    assert ci.LAUNCHES == launches and out.tap is None and out.acc is None
    assert torch.equal(out.q, got)


def test_phase_max_leaves_the_packed_zero_taps_out_on_both_devices():
    """phase_max computes the packed conv with the packed form's zero taps
    left out (the kernel's plan has no k-step there), so the CPU path does
    the same: a kernel that is not zero there gives the pool1 of its masked
    copy, which QuantConv refuses to build from."""
    rng = np.random.default_rng(7)
    x, k2q, deq, bias, inv = _packed_case(rng, 1, 4, 6)
    kd = k2q.masked_fill(ci.packed_zero_mask(), 5)
    assert not ci.packed_zeros_hold(kd)
    got = ci.conv_i8(x, kd, deq, bias, inv, 1, 1, (1, 1, 1, 1), phase_max=True).q
    want = ci.conv_i8(x, k2q, deq, bias, inv, 1, 1, (1, 1, 1, 1), phase_max=True).q
    assert torch.equal(got, want)
    _, q_all = conv_i8_epilogue_plain(conv_i8_plain(x, kd, 1, 1, (1, 1, 1, 1)), deq, bias, inv)
    assert not torch.equal(got, phase_max_i8(q_all, 64))


def test_phase_max_conv_checks_its_zeros_once_where_it_is_made(monkeypatch):
    """QuantConv checks the packed zeros when it is built (in inference
    mode, as Detector.quantize_int8 builds it) and never again: its forward
    runs no check, so on the card no launch waits for the device."""
    from dan_tpu_torch import quant

    rng = np.random.default_rng(8)
    x, k2q, deq, bias, inv = _packed_case(rng, 1, 4, 4)
    with torch.inference_mode():
        conv = QuantConv(k2q, deq, bias, inv, padding=(1, 1, 1, 1), phase_max=True)

    def no_check(k):
        raise AssertionError("packed zeros checked in the forward")

    monkeypatch.setattr(ci, "packed_zeros_hold", no_check)
    monkeypatch.setattr(quant, "packed_zeros_hold", no_check)
    with torch.inference_mode():
        got = conv(x)[1]
    want = ci.conv_i8(x, k2q, deq, bias, inv, 1, 1, (1, 1, 1, 1), phase_max=True).q
    assert got.shape == (1, 4, 4, 64) and torch.equal(got, want)


def test_phase_max_plan_at_the_bench_grid_edge_tiles():
    """The phase-max plan at 320x320 (pool1 320x320): the tiles of the last
    row and column, replayed, against the plain conv + phase_max_i8."""
    rng = np.random.default_rng(320)
    x, k2q, deq, bias, inv = _packed_case(rng, 1, 320, 320)
    p = ci.plan(1, 320, 320, 256, 256, 2, 2, 1, 1, (1, 1, 1, 1), True)
    tiles = [t for t in range(p.total_tiles)
             if p.tile(t)[1] == (p.tiles_y - 1) * p.rows or p.tile(t)[2] == (p.tiles_x - 1) * p.cols]
    tiles = sorted(set(tiles[::9] + [tiles[-1], 0]))
    sums, written = replay(p, x, k2q, tiles)
    sel = written[..., 0, 0].bool()
    qs = [conv_i8_epilogue_plain(sums[..., g, :].to(torch.int32), deq[64 * g:64 * g + 64],
                                 bias[64 * g:64 * g + 64], inv[64 * g:64 * g + 64])[1]
          for g in range(4)]
    got = torch.maximum(torch.maximum(qs[0], qs[1]), torch.maximum(qs[2], qs[3]))
    _, q_all = conv_i8_epilogue_plain(conv_i8_plain(x, k2q, 1, 1, (1, 1, 1, 1)), deq, bias, inv)
    want = phase_max_i8(q_all, 64)
    assert bool(sel[0, 319, 319]) and bool(sel[0, 0, 0])
    assert torch.equal(got[sel], want[sel])


def test_plan_numbers_the_launch_passes():
    """The launch's int arrays: 26 ints in the C function's order, five a
    step; stages, ring and shared memory inside the card's limits; the
    bench layers' tiles as chosen (least padding, the wider tile on a tie)."""
    p = ci.plan(128, 320, 320, 64, 128, 3, 3, 1, 1, (1, 1, 1, 1))
    cfg = p.launch_ints()
    assert len(cfg) == 26 and cfg[11:13] == [p.rows, p.cols] and cfg[-1] == p.smem_bytes
    assert len(p.step_ints()) == 5 * len(p.steps)
    assert (p.rows, p.cols, p.slice, p.bn, p.tile_m) == (4, 64, 64, 128, 256)
    assert p.box_a == (64, 64, 4, 1) and p.box_b == (64, 128)
    assert ci.tile_rect(160, 160) == (4, 32) and ci.tile_rect(80, 80) == (8, 16)
    assert ci.tile_rect(321, 321) == (8, 16)
    s2 = ci.plan(2, 20, 20, 256, 512, 3, 3, 2, 1, same_padding_2d(20, 20, 3, 3, 2, 1))
    assert s2.box_a == (128, 2 * s2.cols, 2 * s2.rows, 1)
    for layer in LAYERS:
        name, cin, co, k, s, d, hw = layer
        q = ci.plan(128, hw, hw, cin, co, k, k, s, d, _layer_padding(k, s, d, hw, hw, name),
                    name == "conv1_2p")
        assert q.rows * q.cols == q.tile_m and q.smem_bytes <= ci.SMEM_LIMIT, name
        assert 1 <= q.ring <= ci.MAX_RING and sum(q.stage_steps) == len(q.steps)
        assert q.slice == (64 if cin == 64 or name == "conv1_2p" else 128), name
        # N tiles of 128 take 256 pixels: 128 a consumer warpgroup.
        assert q.tile_m == (256 if co == 128 else 128), name


def test_plan_and_wrapper_raise_on_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="Ci % 64"):
        ci.plan(1, 8, 8, 32, 64, 3, 3)
    with pytest.raises(ValueError, match="Co % 64"):
        ci.plan(1, 8, 8, 64, 8, 3, 3)
    with pytest.raises(ValueError, match="k-steps"):
        ci.plan(1, 8, 8, 2048, 64, 3, 3, 1, 1, (1, 1, 1, 1))
    with pytest.raises(ValueError, match="packed conv1_2'"):
        ci.plan(1, 8, 8, 256, 256, 3, 3, 1, 1, (1, 1, 1, 1), True)
    with pytest.raises(ValueError, match="packed conv1_2'"):
        ci.plan(1, 8, 8, 128, 256, 2, 2, 1, 1, (1, 1, 1, 1), True)
    xk = torch.zeros((1, 8, 8, 256), dtype=torch.int8)
    kd = torch.ones((256, 2, 2, 256), dtype=torch.int8)  # not the packed form's zeros
    v = torch.ones(256)
    # The packed zeros are checked once, where the phase-max conv is made.
    with pytest.raises(ValueError, match="packed conv1_2' kernel"):
        QuantConv(kd, v, v, v, padding=(1, 1, 1, 1), phase_max=True)
    assert QuantConv(kd, v, v, v, padding=(1, 1, 1, 1)).phase_max is False
    assert ci.kernel_takes(xk, kd, 1, 1, (1, 1, 1, 1), phase_max=True).stages_per_tile == 16
    assert ci.kernel_takes(xk, kd, 1, 1, (1, 1, 1, 1)).stages_per_tile == 8
    with pytest.raises(ValueError, match="packed conv1_2' only"):
        ci.conv_i8(torch.zeros((1, 8, 8, 256), dtype=torch.int8),
                   torch.zeros((256, 3, 3, 256), dtype=torch.int8), v, v, v,
                   padding=(1, 1, 1, 1), phase_max=True)
    with pytest.raises(ValueError, match="empty output"):
        ci.plan(1, 2, 2, 64, 64, 5, 5)
    x = torch.zeros((1, 4, 4, 256), dtype=torch.int8)
    k = torch.zeros((256, 2, 2, 256), dtype=torch.int8)
    with pytest.raises(ValueError, match="phase_max"):
        ci.conv_i8(x, k, v, v, None, padding=(1, 1, 1, 1), with_acc=True, phase_max=True)
    with pytest.raises(ValueError, match="phase_max"):
        ci.conv_i8(x, k, v, v, v, padding=(1, 1, 1, 1), tap_dtype=torch.float32,
                   phase_max=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ci._launch(x, k, v, v, v, 1, 1, (1, 1, 1, 1), None, False, True)


def test_the_variants_tool_still_applies_to_the_source():
    """tools/conv_i8_variants.py edits csrc/conv_i8.cu by text: every variant
    must still find what it replaces (the tool raises otherwise)."""
    import os

    from dan_tpu_torch.ops import _cuda_build
    from dan_tpu_torch.tools import conv_i8_variants as cv

    with open(os.path.join(_cuda_build.CSRC, "conv_i8.cu")) as f:
        src = f.read()
    for name in cv.VARIANTS:
        assert (cv.variant_source(src, name) == src) == (name == "full"), name
