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
built from the conv1_1/conv1_2 parameters when the weights load (see
`repack`), not on every forward.  Odd sizes take the standard path.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dan_tpu.config import ModelConfig
from dan_tpu_torch.models.layers import Conv, max_pool

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


def phase_pool(r: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """pool1 over the packed conv1_2' output r (B, 4*co, H+1, W+1):
    relu(max over phases + b2).  Phase (py, px) lives in channel group
    py*2+px at spatial offset (py, px)."""
    co = b2.shape[0]
    hh, ww = r.shape[2] - 1, r.shape[3] - 1
    s = [
        r[:, g * co : (g + 1) * co, py : py + hh, px : px + ww]
        for g, (py, px) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1)))
    ]
    m = torch.maximum(torch.maximum(s[0], s[1]), torch.maximum(s[2], s[3]))
    return F.relu(m + b2[:, None, None])


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
        self.register_buffer("k1_packed", torch.empty(0), persistent=False)
        self.register_buffer("b1_packed", torch.empty(0), persistent=False)
        self.register_buffer("k2_packed", torch.empty(0), persistent=False)
        self.repack()
        self.register_load_state_dict_post_hook(lambda module, _: module.repack())

    @torch.no_grad()
    def repack(self) -> None:
        """Rebuild the packed conv1 kernels from conv1_1/conv1_2.  Runs at
        construction and after load_state_dict; call it after changing
        those weights any other way."""
        self.k1_packed = pack_conv_kernel_stride2(self.conv1_1.weight.detach())
        self.b1_packed = self.conv1_1.bias.detach().repeat(4)
        self.k2_packed = pack_conv_kernel_2x2_phase(self.conv1_2.weight.detach())

    def conv1_block_packed(self, x: torch.Tensor) -> torch.Tensor:
        """relu(conv1_1) -> relu(conv1_2) -> pool1 on the phase grid.
        x (B, 3, H, W), H and W even -> (B, 64, H/2, W/2)."""
        dt = x.dtype
        o1 = F.conv2d(F.pad(x, (1, 2, 1, 2)), self.k1_packed.to(dt),
                      self.b1_packed.to(dt), stride=2)
        r = F.conv2d(F.relu(o1), self.k2_packed.to(dt), padding=1)
        return phase_pool(r, self.conv1_2.bias.to(dt))

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
