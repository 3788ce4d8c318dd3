"""RetinaFace-R50: ResNet-50 -> FPN -> SSH -> class, box and landmark heads
(biubug6/Pytorch_Retinaface's models/retinaface.py and models/net.py at
`cfg_re50`; arXiv:1905.00641).

    model = RetinaFace(config.model, torch.Generator().manual_seed(0))
    cls, loc, landm = model(images)    # (B, H, W, 3) mean-subtracted

Out: (B, A, 2), (B, A, 4) and (B, A, 2 * num_landmarks) float32, A the
anchors of box/anchors.py (position-major, size-minor over the levels).
The forward is the detect path's: inference only, every batch norm folded
into its conv (models/resnet.py), compute in config.compute_dtype on
channels-last activations, so that cuDNN runs its NHWC convolutions and the
bias (+ residual) + ReLU of each conv is one in-place pass on the card.  A
float32 model runs without TF32 (device.float32_arithmetic).

  FPN: out_i = relu(bn(conv1x1(C_i))); out4 = merge2(out4 + nearest(out5));
       out3 = merge1(out3 + nearest(out4)); merge = relu(bn(conv3x3)).
  SSH: relu(cat(bn(conv3x3(x) -> C/2), bn(conv3x3(m) -> C/4),
       bn(conv3x3(relu(bn(conv3x3(m)))) -> C/4))), m = relu(bn(conv3x3(x) -> C/4)).
  Heads: 1x1 convs with bias a level, run as one conv of all three heads'
       kernels (2 x (2 + 4 + 10) outputs).

Parameter names are the release's (body.*, fpn.output1.0 / .1, ssh1.conv3X3,
ClassHead.0.conv1x1, ...), without `num_batches_tracked`.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dan_tpu_torch.config import RetinaFaceModelConfig
from dan_tpu_torch.device import float32_arithmetic
from dan_tpu_torch.models.layers import conv2d_bias_act
from dan_tpu_torch.models.resnet import BatchNorm, FoldCache, FoldedConv, ResNetBody, Weight
from dan_tpu_torch.utils.profiling import span


class ConvBN(nn.Sequential):
    """conv (k x k, no bias) + batch norm, named `0` and `1` as the
    release's nn.Sequential."""

    def __init__(self, cin: int, cout: int, k: int, eps: float, generator: torch.Generator):
        super().__init__(Weight(cin, cout, k, generator), BatchNorm(cout))
        self.folded = FoldedConv(self[0], self[1], eps)

    def forward(self, x: torch.Tensor, relu: bool = True) -> torch.Tensor:
        return self.folded(x, relu)


class FPN(nn.Module):
    def __init__(self, cins: Tuple[int, ...], c: int, eps: float, generator: torch.Generator):
        super().__init__()
        self.output1, self.output2, self.output3 = (ConvBN(ci, c, 1, eps, generator) for ci in cins)
        self.merge1 = ConvBN(c, c, 3, eps, generator)
        self.merge2 = ConvBN(c, c, 3, eps, generator)

    def forward(self, c3, c4, c5) -> List[torch.Tensor]:
        o1, o2, o3 = self.output1(c3), self.output2(c4), self.output3(c5)
        # Nearest to an explicit size: row i copies row floor(i * in / out).
        o2 = self.merge2(o2 + F.interpolate(o3, size=o2.shape[2:], mode="nearest"))
        o1 = self.merge1(o1 + F.interpolate(o2, size=o1.shape[2:], mode="nearest"))
        return [o1, o2, o3]


class SSH(nn.Module):
    def __init__(self, c: int, eps: float, generator: torch.Generator):
        super().__init__()
        self.conv3X3 = ConvBN(c, c // 2, 3, eps, generator)
        self.conv5X5_1 = ConvBN(c, c // 4, 3, eps, generator)
        self.conv5X5_2 = ConvBN(c // 4, c // 4, 3, eps, generator)
        self.conv7X7_2 = ConvBN(c // 4, c // 4, 3, eps, generator)
        self.conv7x7_3 = ConvBN(c // 4, c // 4, 3, eps, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # The ReLU after the concatenation acts value by value, so each part
        # takes it in its own conv's pass.
        m = self.conv5X5_1(x)
        parts = [self.conv3X3(x), self.conv5X5_2(m), self.conv7x7_3(self.conv7X7_2(m))]
        return torch.cat(parts, dim=1)


class Head(nn.Module):
    """One level's 1x1 conv with bias: `conv1x1.weight`, `conv1x1.bias`."""

    def __init__(self, cin: int, cout: int, generator: torch.Generator):
        super().__init__()
        self.conv1x1 = Weight(cin, cout, 1, generator)
        self.conv1x1.bias = nn.Parameter(torch.zeros(cout))


class RetinaFace(nn.Module):
    def __init__(self, config: RetinaFaceModelConfig, generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.config = config
        c, eps, a = config.fpn_channels, config.bn_eps, config.anchors_per_position
        self.body = ResNetBody(config, generator)
        cins = tuple(config.stage_channels(s) for s in config.fpn_stages)
        self.fpn = FPN(cins, c, eps, generator)
        for i in range(1, len(cins) + 1):
            self.add_module(f"ssh{i}", SSH(c, eps, generator))
        self.widths = (2 * a, 4 * a, 2 * config.num_landmarks * a)
        for name, w in zip(("ClassHead", "BboxHead", "LandmarkHead"), self.widths):
            self.add_module(name, nn.ModuleList(Head(c, w, generator) for _ in cins))
        self.head_cache = [FoldCache() for _ in cins]

    def _head_params(self, i: int, dtype: torch.dtype):
        convs = [getattr(self, n)[i].conv1x1 for n in ("ClassHead", "BboxHead", "LandmarkHead")]
        tensors = [t for conv in convs for t in (conv.weight, conv.bias)]

        def make():
            w = torch.cat([conv.weight for conv in convs]).to(dtype)
            return (w.contiguous(memory_format=torch.channels_last),
                    torch.cat([conv.bias for conv in convs]).float())

        return self.head_cache[i].get(tensors, dtype, make)

    def heads(self, feats: List[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        n_cls, n_box, _ = self.widths
        outs = ([], [], [])
        for i, x in enumerate(feats):
            w, b = self._head_params(i, x.dtype)
            y = conv2d_bias_act(x, w, b, relu=False).permute(0, 2, 3, 1)
            bounds = (0, n_cls, n_cls + n_box, sum(self.widths))
            for out, lo, hi, k in zip(outs, bounds, bounds[1:], (2, 4, 2 * self.config.num_landmarks)):
                out.append(y[..., lo:hi].reshape(y.shape[0], -1, k))
        return tuple(torch.cat(o, dim=1).float() for o in outs)

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B, H, W, 3) float -> (cls (B, A, 2), loc (B, A, 4), landm (B, A, 10)) float32."""
        cfg = self.config
        with float32_arithmetic(cfg.compute_dtype == "float32"):
            with span("dan.model.backbone"):
                x = images.to(getattr(torch, cfg.compute_dtype)).permute(0, 3, 1, 2)
                taps = self.body(x)
            with span("dan.model.fpn"):
                feats = self.fpn(*taps)
            with span("dan.model.ssh"):
                feats = [getattr(self, f"ssh{i}")(f) for i, f in enumerate(feats, start=1)]
            with span("dan.model.heads"):
                return self.heads(feats)
