"""LFPN: top-down product fusion from fc7 into the three shallow taps
(counterpart of dan_tpu/models/lfpn.py).  Each block computes

    fused = up2(1x1_conv(higher)) * 1x1_conv(lower)

('sum' instead of the product when config.lfpn_fuse_op says so); the deep
taps pass through unchanged.  Where layers.fused_epilogue says so (an
inference forward on the card in channels-last memory) the upsample, its
crop and the product run as one pass of ops/lfpn_fuse_cuda.py with ATen's
bits; elsewhere (the CPU, the train step, the TTA runner's NCHW canvases)
as ATen's upsample, a cropping view and ATen's product."""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from dan_tpu_torch.config import ModelConfig
from dan_tpu_torch.models.layers import Conv, fused_epilogue, upsample2x
from dan_tpu_torch.models.vgg import TAP_NAMES, raw_tap_channels
from dan_tpu_torch.ops import lfpn_fuse_cuda

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
        op = self.config.lfpn_fuse_op
        for _, lo, _ in _pair_channels(self.config):
            topdown = getattr(self, f"lfpn_td_{lo}")(higher)
            lateral = getattr(self, f"lfpn_lat_{lo}")(taps[lo])
            if (fused_epilogue(lateral, topdown)
                    and topdown.is_contiguous(memory_format=torch.channels_last)):
                fused = lfpn_fuse_cuda.lfpn_fuse(topdown, lateral, op)
            else:
                # Odd sizes: crop the upsampled map to the lateral's size.
                topdown = upsample2x(topdown)[:, :, : lateral.shape[2], : lateral.shape[3]]
                fused = topdown * lateral if op == "product" else topdown + lateral
            out[lo] = fused
            higher = fused
        return out
