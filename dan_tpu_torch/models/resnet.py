"""ResNet-50 with batch norm (torchvision's v1.5: the stride on the 3x3
conv), the body of RetinaFace-R50 (models/retinaface.py).

    body = ResNetBody(config)            # config: RetinaFaceModelConfig
    c3, c4, c5 = body(x)                 # x (B, 3, H, W) in the compute dtype

Parameter names are torchvision's (conv1, bn1, layer1.0.conv1, ...,
layer1.0.downsample.0 / .1), without `num_batches_tracked`.  Padding is
torchvision's symmetric k // 2, not TF 'SAME'.  The forward is inference
only: every batch norm runs on its running statistics, folded in float32
into its conv's weight and bias (`FoldedConv`), so each conv is one
F.conv2d and one pass of ops/bias_act_cuda.py on the card: bias + ReLU, or
for a bottleneck's last conv bias + identity + ReLU.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dan_tpu_torch.config import RetinaFaceModelConfig
from dan_tpu_torch.models.layers import conv2d_bias_act, conv2d_bias_residual_relu


class Weight(nn.Module):
    """A bias-free conv's kernel `weight` (cout, cin, k, k), float32,
    He-normal by fan-in (torchvision draws its own init; the benchmark and
    the checkpoints replace it)."""

    def __init__(self, cin: int, cout: int, k: int, generator: torch.Generator):
        super().__init__()
        std = (2.0 / (k * k * cin)) ** 0.5
        self.weight = nn.Parameter(torch.randn((cout, cin, k, k), generator=generator) * std)


class BatchNorm(nn.Module):
    """Batch norm's affine map and running statistics: `weight`, `bias`,
    `running_mean`, `running_var` (c,), float32; identity at init."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


def fold(weight: torch.Tensor, bn: BatchNorm, eps: float, dtype: torch.dtype):
    """(weight, bias) of conv + batch norm as one conv, computed in
    float32: w * s and beta - mean * s with s = gamma / sqrt(var + eps); the
    weight in `dtype` and channels-last memory (cuDNN's NHWC layout), the
    bias float32."""
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + eps)
    w = (weight.float() * s[:, None, None, None]).to(dtype)
    return w.contiguous(memory_format=torch.channels_last), bn.bias.float() - bn.running_mean.float() * s


def _version(t: torch.Tensor) -> int:
    return 0 if t.is_inference() else t._version


class FoldCache:
    """A value computed from some tensors, kept while none of them changed
    (same storage and version) and nothing records autograd through them."""

    def __init__(self):
        self.key = None
        self.value = None

    def get(self, tensors, dtype: torch.dtype, make):
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            return make()
        key = (dtype, tuple((t.data_ptr(), _version(t)) for t in tensors))
        if key != self.key:
            self.key, self.value = None, make()
            self.key = key
        return self.value


class FoldedConv:
    """The forward of one conv + batch norm pair, BN folded (cached)."""

    def __init__(self, conv: Weight, bn: BatchNorm, eps: float, stride: int = 1):
        self.conv, self.bn, self.eps, self.stride = conv, bn, eps, stride
        self.padding = conv.weight.shape[-1] // 2
        self.cache = FoldCache()

    def params(self, dtype: torch.dtype):
        bn = self.bn
        tensors = (self.conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)
        return self.cache.get(tensors, dtype, lambda: fold(self.conv.weight, bn, self.eps, dtype))

    def __call__(self, x: torch.Tensor, relu: bool) -> torch.Tensor:
        w, b = self.params(x.dtype)
        return conv2d_bias_act(x, w, b, relu, self.stride, self.padding)

    def residual_relu(self, x: torch.Tensor, identity: torch.Tensor) -> torch.Tensor:
        w, b = self.params(x.dtype)
        return conv2d_bias_residual_relu(x, w, b, identity, self.stride, self.padding)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 x4, each with BN; relu(bn3(conv3) +
    identity), the identity through a 1x1 conv + BN where the shape
    changes."""

    def __init__(self, cin: int, width: int, expansion: int, stride: int, eps: float,
                 generator: torch.Generator):
        super().__init__()
        cout = width * expansion
        self.conv1, self.bn1 = Weight(cin, width, 1, generator), BatchNorm(width)
        self.conv2, self.bn2 = Weight(width, width, 3, generator), BatchNorm(width)
        self.conv3, self.bn3 = Weight(width, cout, 1, generator), BatchNorm(cout)
        self.downsample: Optional[nn.Sequential] = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(Weight(cin, cout, 1, generator), BatchNorm(cout))
        self.f1 = FoldedConv(self.conv1, self.bn1, eps)
        self.f2 = FoldedConv(self.conv2, self.bn2, eps, stride)
        self.f3 = FoldedConv(self.conv3, self.bn3, eps)
        self.fd = (FoldedConv(self.downsample[0], self.downsample[1], eps, stride)
                   if self.downsample is not None else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.fd is None else self.fd(x, relu=False)
        out = self.f2(self.f1(x, relu=True), relu=True)
        return self.f3.residual_relu(out, identity)


class ResNetBody(nn.Module):
    """conv1 7x7/2 + BN + ReLU, max pool 3x3/2, then layer1-4; returns the
    outputs of the stages config.fpn_stages (C3, C4, C5)."""

    def __init__(self, config: RetinaFaceModelConfig, generator: torch.Generator):
        super().__init__()
        self.config = config
        eps = config.bn_eps
        self.conv1, self.bn1 = Weight(3, config.stem_channels, 7, generator), BatchNorm(
            config.stem_channels)
        self.stem = FoldedConv(self.conv1, self.bn1, eps, stride=2)
        cin = config.stem_channels
        for i, (n, width) in enumerate(zip(config.stage_blocks, config.stage_widths), start=1):
            blocks = []
            for j in range(n):
                stride = 2 if (i > 1 and j == 0) else 1
                blocks.append(Bottleneck(cin, width, config.expansion, stride, eps, generator))
                cin = width * config.expansion
            self.add_module(f"layer{i}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.max_pool2d(self.stem(x, relu=True), 3, 2, 1)
        taps = []
        for i in range(1, len(self.config.stage_blocks) + 1):
            x = getattr(self, f"layer{i}")(x)
            if i in self.config.fpn_stages:
                taps.append(x)
        return taps


def bottleneck_shapes(config: RetinaFaceModelConfig, image_size: int) -> List[Tuple[int, int, int]]:
    """(channels, h, w) of each bottleneck's output at a square input:
    the shapes the residual pass runs at, one a block."""
    out = []
    s = -(-image_size // 4)  # conv1 /2, then the max pool /2
    for i, (n, width) in enumerate(zip(config.stage_blocks, config.stage_widths), start=1):
        if i > 1:
            s = -(-s // 2)
        out += [(width * config.expansion, s, s)] * n
    return out
