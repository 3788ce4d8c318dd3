"""The DAN detector: VGG-16 -> LFPN -> L2Norm -> multibox heads
(counterpart of dan_tpu/models/detector.py).

    model = DANDetector(config.model, torch.Generator().manual_seed(0))
    cls_logits, loc_preds = model(images)   # (B, H, W, 3) mean-subtracted

Compute runs in config.compute_dtype (bf16 by default) with float32
parameters; the logits come out in float32.  A float32 model's forward
runs in float32 arithmetic whatever the caller set: no TF32
(device.float32_arithmetic).  The public layout is the JAX
package's: NHWC images in, (B, A, 2) and (B, A, 4) out.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from dan_tpu_torch.config import ModelConfig
from dan_tpu_torch.device import float32_arithmetic
from dan_tpu_torch.models.heads import Heads
from dan_tpu_torch.models.layers import L2Norm
from dan_tpu_torch.models.lfpn import LFPN
from dan_tpu_torch.models.vgg import TAP_NAMES, VGG, effective_tap_channels
from dan_tpu_torch.utils.profiling import span


def compute_dtype(config: ModelConfig) -> torch.dtype:
    """'float32' / 'bfloat16' -> the torch dtype."""
    return getattr(torch, config.compute_dtype)


class DANDetector(nn.Module):
    def __init__(self, config: ModelConfig, generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.config = config
        self.backbone = VGG(config, generator)
        self.lfpn = LFPN(config, generator)
        self.heads = Heads(config, generator)
        tap_ch = dict(zip(TAP_NAMES, effective_tap_channels(config)))
        self.l2norm = nn.ModuleDict(
            {
                name: L2Norm(tap_ch[name], init)
                for name, init in zip(config.l2norm_taps, config.l2norm_init)
            }
        )

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) float -> (cls_logits (B, A, 2) f32, loc_preds (B, A, 4) f32)."""
        with float32_arithmetic(self.config.compute_dtype == "float32"):
            with span("dan.model.backbone"):
                x = images.to(compute_dtype(self.config)).permute(0, 3, 1, 2)
                taps = self.backbone(x)
            with span("dan.model.lfpn"):
                taps = self.lfpn(taps)
            return heads_forward(self, taps)


def heads_forward(model: nn.Module, taps) -> Tuple[torch.Tensor, torch.Tensor]:
    """L2Norm on its taps, then the heads: the tail of `model`'s forward
    (a DANDetector or quant.QuantizedDetector)."""
    with span("dan.model.heads"):
        for name, norm in model.l2norm.items():
            taps[name] = norm(taps[name])
        return model.heads(taps)
