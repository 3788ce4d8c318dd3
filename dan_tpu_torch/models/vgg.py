"""VGG-16 backbone with the SSD extensions, inference forward
(counterpart of dan_tpu/models/vgg.py).

  conv1_1..conv5_3 (3x3, ReLU, 2x2/2 max pool after each block),
  fc6 (3x3, dilation 6) -> fc7 (1x1),
  conv6_1 (1x1) -> conv6_2 (3x3/2), conv7_1 (1x1) -> conv7_2 (3x3/2).

Detection taps: conv3_3, conv4_3, conv5_3, fc7, conv6_2, conv7_2 (strides
4 to 128).

The conv1 block runs phase-packed (space-to-depth) when H and W are even,
as in the JAX package: conv1_1' is a 4x4 stride-2 conv whose 4*64 output
channels are the 2x2 pixel phases, conv1_2' a 2x2 conv over the packed
channels, and pool1 the max over the four phases.  The packed kernels are
gathered from the live conv1_1/conv1_2 parameters on every forward (a few
hundred thousand elements), so they follow every weight update and their
gradients flow back into the 3x3 taps.  Odd sizes take the standard path.

Training (grad enabled and the conv1 parameters requiring grad) runs the
block through two autograd Functions with hand-written backwards, as the
JAX package's custom VJPs do: `PhasePool` saves only a uint8 winner per
pooled value and routes the cotangent with the CUDA kernel of
ops/phase_pool_cuda.py, and `Conv12` owns the conv1_2' weight gradient
(ops/conv12_wgrad_cuda.py).  Inference keeps the plain conv and pool; on
the card the bias and ReLU of conv1_1' and of the phase max run in place
(layers.fused_epilogue, ops/bias_act_cuda.py).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dan_tpu_torch.config import ModelConfig
from dan_tpu_torch.models import layers
from dan_tpu_torch.models.layers import Conv, conv2d_bias_act, max_pool
from dan_tpu_torch.ops import bias_act_cuda
from dan_tpu_torch.ops.conv12_wgrad_cuda import conv12_wgrad
from dan_tpu_torch.ops.phase_pool_cuda import phase_pool_bwd

VGG_BLOCKS: Tuple[Tuple[Tuple[str, int], ...], ...] = (
    (("conv1_1", 64), ("conv1_2", 64)),
    (("conv2_1", 128), ("conv2_2", 128)),
    (("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256)),
    (("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512)),
    (("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)),
)

TAP_NAMES = ("conv3_3", "conv4_3", "conv5_3", "fc7", "conv6_2", "conv7_2")


def raw_tap_channels(config: ModelConfig) -> Tuple[int, ...]:
    """Backbone tap widths: conv3_3/4_3/5_3 are fixed, fc7 and the extra
    blocks come from the config."""
    extras = tuple(out for _, out in config.extra_channels)
    ch = (256, 512, 512, config.fc7_channels) + extras
    if len(ch) != len(TAP_NAMES):
        raise ValueError(
            "the 6-scale head contract needs exactly 2 extra blocks; got "
            f"{len(config.extra_channels)}"
        )
    return ch


def effective_tap_channels(config: ModelConfig) -> Tuple[int, ...]:
    """Tap widths seen by L2Norm and the heads: the three shallow taps carry
    the LFPN-fused widths."""
    ch = dict(zip(TAP_NAMES, raw_tap_channels(config)))
    for name, c in zip(("conv3_3", "conv4_3", "conv5_3"), config.lfpn_channels):
        ch[name] = c
    return tuple(ch[n] for n in TAP_NAMES)


def pack_conv_kernel_stride2(k: torch.Tensor) -> torch.Tensor:
    """(co, ci, 3, 3) -> (4*co, ci, 4, 4): the stride-1 3x3 conv as one
    stride-2 4x4 conv whose output channel groups are the 2x2 pixel phases.
    With padding ((1, 2), (1, 2)) output block Y covers input rows
    2Y-1..2Y+2, and phase py's tap dy lands at window row py+dy."""
    co, ci = k.shape[:2]
    kp = k.new_zeros((4 * co, ci, 4, 4))
    for py in range(2):
        for px in range(2):
            go = py * 2 + px
            for dy in range(3):
                for dx in range(3):
                    kp[go * co : (go + 1) * co, :, py + dy, px + dx] = k[:, :, dy, dx]
    return kp


def pack_conv_kernel_2x2_phase(k: torch.Tensor) -> torch.Tensor:
    """(co, ci, 3, 3) -> (4*co, 4*ci, 2, 2) for conv1_2' on the phase grid.
    With padding 1 a 2x2 conv output Y covers input blocks {Y-1, Y}; phase
    py needs blocks {Y-1+py, Y+py}, read at index Y+py, so the tap of
    source block qy sits in kernel row qy + 1 - py."""
    co, ci = k.shape[:2]
    kp = k.new_zeros((4 * co, 4 * ci, 2, 2))
    for py in range(2):
        for px in range(2):
            for dy in range(3):
                for dx in range(3):
                    ty, tx = py + dy - 1, px + dx - 1
                    qy, ry = ty // 2, ty % 2
                    qx, rx = tx // 2, tx % 2
                    gi, go = ry * 2 + rx, py * 2 + px
                    kp[
                        go * co : (go + 1) * co,
                        gi * ci : (gi + 1) * ci,
                        qy + 1 - py,
                        qx + 1 - px,
                    ] = k[:, :, dy, dx]
    return kp


def _phase_slices(r: torch.Tensor, co: int):
    """The four (B, co, H, W) pixel-phase views of the packed conv output
    r (B, 4*co, H+1, W+1): phase (py, px) lives in channel group py*2+px
    at spatial offset (py, px)."""
    hh, ww = r.shape[2] - 1, r.shape[3] - 1
    return [
        r[:, g * co : (g + 1) * co, py : py + hh, px : px + ww]
        for g, (py, px) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1)))
    ]


def phase_pool(r: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """pool1 over the packed conv1_2' output r (B, 4*co, H+1, W+1):
    relu(max over phases + b2), the bias and relu in place by the kernel
    where layers.fused_epilogue says so."""
    s = _phase_slices(r, b2.shape[0])
    m = torch.maximum(torch.maximum(s[0], s[1]), torch.maximum(s[2], s[3]))
    if layers.fused_epilogue(r, b2):
        return bias_act_cuda.bias_act(m, b2, True)
    return F.relu(m + b2[:, None, None])


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> the contiguous (B, H, W, C) tensor; free for a
    channels-last x."""
    return x.permute(0, 2, 3, 1).contiguous()


def phase_pool_with_winner(r: torch.Tensor, b2: torch.Tensor):
    """phase_pool plus its backward residual: the uint8 index of the first
    phase, in (py, px) order, that reaches the max, and 255 where the relu
    clamps, as a contiguous (B, H, W, co) tensor."""
    s = _phase_slices(r, b2.shape[0])
    m = torch.maximum(torch.maximum(s[0], s[1]), torch.maximum(s[2], s[3]))
    out = F.relu(m + b2[:, None, None])
    code = torch.arange(4, dtype=torch.uint8, device=r.device)
    win = torch.where(
        s[0] == m, code[0], torch.where(s[1] == m, code[1], torch.where(s[2] == m, code[2], code[3]))
    )
    win = torch.where(out > 0, win, torch.full_like(win, 255))
    return out, nhwc(win)


class PhasePool(torch.autograd.Function):
    """phase_pool with the JAX package's hand-written backward
    (dan_tpu/models/vgg.py::_phase_pool): the forward saves only the uint8
    winner (phase_pool_with_winner), not r; the backward routes the
    cotangent to the winning phase (ops/phase_pool_cuda.py)."""

    @staticmethod
    def forward(ctx, r: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
        out, win = phase_pool_with_winner(r, b2)
        ctx.save_for_backward(win)
        ctx.b2_dtype = b2.dtype
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (win,) = ctx.saved_tensors
        g = nhwc(g)
        gr = phase_pool_bwd(g, win).permute(0, 3, 1, 2)
        gb2 = torch.where(win != 255, g, 0).float().sum(dim=(0, 1, 2)).to(ctx.b2_dtype)
        return gr, gb2


class Conv12(torch.autograd.Function):
    """relu -> the packed conv1_2' with an owned weight gradient, as the JAX
    package's _conv12: the input gradient is torch's own conv backward
    (times the relu mask), the weight gradient the kernel of
    ops/conv12_wgrad_cuda.py, cast to k2's dtype."""

    @staticmethod
    def forward(ctx, o1_pre: torch.Tensor, k2: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(o1_pre, k2)
        return F.conv2d(F.relu(o1_pre), k2, padding=1)

    @staticmethod
    def backward(ctx, dr: torch.Tensor):
        o1_pre, k2 = ctx.saved_tensors
        do1 = torch.nn.grad.conv2d_input(o1_pre.shape, k2, dr, padding=1)
        do1_pre = torch.where(o1_pre > 0, do1, 0)
        dk2 = conv12_wgrad(nhwc(o1_pre), nhwc(dr)).to(k2.dtype)
        return do1_pre, dk2


class _Pack(torch.autograd.Function):
    """Gather of a packed kernel from the original taps (index n, one past
    the n taps, reads a zero).  Every original tap fills exactly four packed slots, one per
    output phase; the backward sums those four gradients in a fixed order,
    which is what autodiff of the JAX package's .at[].set packing does."""

    @staticmethod
    def forward(ctx, w: torch.Tensor, index: torch.Tensor, inverse: torch.Tensor):
        ctx.save_for_backward(inverse)
        ctx.shape = w.shape
        flat = torch.cat([w.reshape(-1), w.new_zeros(1)])
        return flat[index]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (inverse,) = ctx.saved_tensors
        return g.reshape(-1)[inverse].sum(dim=1).reshape(ctx.shape), None, None


def _pack_index(pack, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """(index, inverse) of a packing function: packed = flat_w[index] with
    flat_w[n] = 0, and inverse (n, 4) the packed slots of each tap."""
    n = math.prod(shape)
    ids = pack(torch.arange(1, n + 1, dtype=torch.float64).reshape(shape))
    index = ids.long() - 1
    index = torch.where(index < 0, n, index)
    order = torch.argsort(index.reshape(-1), stable=True)
    counts = torch.bincount(index.reshape(-1), minlength=n + 1)[:n]
    if not bool((counts == 4).all()):
        raise AssertionError("every tap must fill exactly four packed slots")
    return index, order[: 4 * n].reshape(n, 4)


class VGG(nn.Module):
    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.config = config
        cin = 3
        for block in VGG_BLOCKS:
            for name, cout in block:
                self.add_module(name, Conv(cin, cout, 3, generator))
                cin = cout
        self.fc6 = Conv(512, config.fc6_channels, 3, generator,
                        dilation=config.fc6_dilation)
        self.fc7 = Conv(config.fc6_channels, config.fc7_channels, 1, generator)
        cin = config.fc7_channels
        for i, (mid, out) in enumerate(config.extra_channels, start=6):
            self.add_module(f"conv{i}_1", Conv(cin, mid, 1, generator))
            self.add_module(f"conv{i}_2", Conv(mid, out, 3, generator, stride=2))
            cin = out
        # Index maps of the packed conv1 kernels into the 3x3 taps.
        for name, pack in (("k1", pack_conv_kernel_stride2),
                           ("k2", pack_conv_kernel_2x2_phase)):
            index, inverse = _pack_index(pack, getattr(self, f"conv1_{name[1]}").weight.shape)
            self.register_buffer(f"{name}_index", index, persistent=False)
            self.register_buffer(f"{name}_inverse", inverse, persistent=False)

    def packed_kernels(self):
        """(k1', b1', k2') gathered from the live conv1_1/conv1_2 parameters."""
        k1 = _Pack.apply(self.conv1_1.weight, self.k1_index, self.k1_inverse)
        k2 = _Pack.apply(self.conv1_2.weight, self.k2_index, self.k2_inverse)
        return k1, self.conv1_1.bias.repeat(4), k2

    def conv1_1_packed(self, x: torch.Tensor, relu: bool = False):
        """conv1_1' (before its relu unless relu is set), and the packed
        conv1_2' kernel and bias, in x's dtype: (o1 (B, 256, H/2, W/2), k2',
        b2)."""
        dt = x.dtype
        k1, b1, k2 = self.packed_kernels()
        o1 = conv2d_bias_act(F.pad(x, (1, 2, 1, 2)), k1, b1, relu, stride=2)
        return o1, k2.to(dt), self.conv1_2.bias.to(dt)

    def conv1_block_packed(self, x: torch.Tensor) -> torch.Tensor:
        """relu(conv1_1) -> relu(conv1_2) -> pool1 on the phase grid.
        x (B, 3, H, W), H and W even -> (B, 64, H/2, W/2)."""
        if torch.is_grad_enabled() and (
            self.conv1_1.weight.requires_grad or self.conv1_2.weight.requires_grad
        ):
            o1_pre, k2, b2 = self.conv1_1_packed(x)
            return PhasePool.apply(Conv12.apply(o1_pre, k2), b2)
        o1, k2, b2 = self.conv1_1_packed(x, relu=True)
        return phase_pool(F.conv2d(o1, k2, padding=1), b2)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x (B, 3, H, W) mean-subtracted, in compute dtype -> the six taps."""
        taps: Dict[str, torch.Tensor] = {}
        for bi, block in enumerate(VGG_BLOCKS):
            if (bi == 0 and self.config.conv1_packed
                    and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0):
                x = self.conv1_block_packed(x)
                continue
            for name, _ in block:
                x = getattr(self, name)(x)
                if name in TAP_NAMES:
                    taps[name] = x
            x = max_pool(x)
        x = self.fc7(self.fc6(x))
        taps["fc7"] = x
        for i in range(6, 6 + len(self.config.extra_channels)):
            x = getattr(self, f"conv{i}_2")(getattr(self, f"conv{i}_1")(x))
            taps[f"conv{i}_2"] = x
        return taps
