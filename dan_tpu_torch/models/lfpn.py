"""LFPN: top-down product fusion from fc7 into the three shallow taps
(counterpart of dan_tpu/models/lfpn.py).  Each block computes

    fused = up2(1x1_conv(higher)) * 1x1_conv(lower)

('sum' instead of the product when config.lfpn_fuse_op says so); the deep
taps pass through unchanged."""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from dan_tpu_torch.config import ModelConfig
from dan_tpu_torch.models.layers import Conv, upsample2x
from dan_tpu_torch.models.vgg import TAP_NAMES, raw_tap_channels

# Top-down order: (higher_tap, lower_tap).
_LFPN_PAIRS = (
    ("fc7", "conv5_3"),
    ("conv5_3", "conv4_3"),
    ("conv4_3", "conv3_3"),
)


def _pair_channels(config: ModelConfig):
    """(higher_tap, lower_tap, lower_channels) in top-down order."""
    by_tap = dict(zip(("conv3_3", "conv4_3", "conv5_3"), config.lfpn_channels))
    return tuple((hi, lo, by_tap[lo]) for hi, lo in _LFPN_PAIRS)


class LFPN(nn.Module):
    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__()
        if config.lfpn_fuse_op not in ("product", "sum"):
            raise ValueError(f"unknown lfpn_fuse_op {config.lfpn_fuse_op!r}")
        self.config = config
        tap_ch = dict(zip(TAP_NAMES, raw_tap_channels(config)))
        pairs = _pair_channels(config)
        for i, (hi, lo, lo_ch) in enumerate(pairs):
            # Block i's higher input is block i-1's fused output.
            hi_ch = tap_ch[hi] if i == 0 else pairs[i - 1][2]
            self.add_module(f"lfpn_td_{lo}", Conv(hi_ch, lo_ch, 1, generator))
            self.add_module(f"lfpn_lat_{lo}", Conv(lo_ch, lo_ch, 1, generator))

    def forward(self, taps: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = dict(taps)
        higher = taps["fc7"]
        for _, lo, _ in _pair_channels(self.config):
            topdown = upsample2x(getattr(self, f"lfpn_td_{lo}")(higher))
            lateral = getattr(self, f"lfpn_lat_{lo}")(taps[lo])
            # Odd sizes: crop the upsampled map to the lateral's size.
            topdown = topdown[:, :, : lateral.shape[2], : lateral.shape[3]]
            if self.config.lfpn_fuse_op == "product":
                fused = topdown * lateral
            else:
                fused = topdown + lateral
            out[lo] = fused
            higher = fused
        return out
