"""SSD multibox heads: one fused cls+loc 3x3 conv per tap
(counterpart of dan_tpu/models/heads.py).

One square anchor per position.  Outputs are flattened in NHWC row-major
order, the order of box.anchors, so the NCHW conv outputs are permuted
before the reshape.  Max-in-out on the stride-4 layer: its background
logit is the max over `maxout_bg_size` channels.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from dan_tpu.config import ModelConfig
from dan_tpu_torch.models.layers import Conv, conv2d_same
from dan_tpu_torch.models.vgg import TAP_NAMES, effective_tap_channels


def _cls_channels(config: ModelConfig, layer_idx: int) -> int:
    if layer_idx == 0 and config.maxout_bg_size > 1:
        return config.maxout_bg_size + (config.num_classes - 1)
    return config.num_classes


class Heads(nn.Module):
    def __init__(self, config: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.config = config
        for i, (name, cin) in enumerate(zip(TAP_NAMES, effective_tap_channels(config))):
            self.add_module(
                f"cls_{name}",
                Conv(cin, _cls_channels(config, i), 3, generator, activation=False),
            )
            self.add_module(f"loc_{name}", Conv(cin, 4, 3, generator, activation=False))

    def forward(
        self, taps: Dict[str, torch.Tensor]
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (cls_logits (B, A, num_classes) f32, loc_preds (B, A, 4) f32)."""
        cfg = self.config
        cls_out: List[torch.Tensor] = []
        loc_out: List[torch.Tensor] = []
        for i, name in enumerate(TAP_NAMES):
            x = taps[name]
            cls_conv = getattr(self, f"cls_{name}")
            loc_conv = getattr(self, f"loc_{name}")
            n_cls = cls_conv.weight.shape[0]
            # One conv per tap: output channels are independent, so this is
            # the two convs' result with one pass over the input.
            out = conv2d_same(
                x,
                torch.cat([cls_conv.weight, loc_conv.weight]),
                torch.cat([cls_conv.bias, loc_conv.bias]),
            ).permute(0, 2, 3, 1)
            cls = out[..., :n_cls].float()
            loc = out[..., n_cls:].float()
            if i == 0 and cfg.maxout_bg_size > 1:
                bg = cls[..., : cfg.maxout_bg_size].amax(dim=-1, keepdim=True)
                cls = torch.cat([bg, cls[..., cfg.maxout_bg_size :]], dim=-1)
            b = x.shape[0]
            cls_out.append(cls.reshape(b, -1, cfg.num_classes))
            loc_out.append(loc.reshape(b, -1, 4))
        return torch.cat(cls_out, dim=1), torch.cat(loc_out, dim=1)
