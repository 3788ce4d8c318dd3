"""Conv, pool and norm primitives with TF-compatible semantics, on NCHW
activations and OIHW kernels.

  * 'SAME' padding is TF's: the total padding is split with the extra
    pixel after, so a 3x3 stride-2 conv on an even size pads (0, 1).
    `nn.Conv2d(padding=1)` would pad (1, 1) and shift every output.
  * Compute runs in the activation dtype (bf16 on the card) with float32
    parameters cast at use, as in the JAX package.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dan_tpu_torch.ops import upsample_cuda


def same_padding(size: int, kernel: int, stride: int, dilation: int) -> Tuple[int, int]:
    """TF 'SAME' (before, after) padding of one spatial dimension."""
    k_eff = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k_eff - size, 0)
    return total // 2, total - total // 2


def conv_init(
    kh: int, kw: int, cin: int, cout: int, generator: torch.Generator
) -> Tuple[torch.Tensor, torch.Tensor]:
    """He-normal (MSRA) OIHW kernel and zero bias, float32."""
    std = (2.0 / (kh * kw * cin)) ** 0.5
    kernel = torch.randn((cout, cin, kh, kw), generator=generator) * std
    return kernel, torch.zeros(cout)


def conv2d_same(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None,
    stride: int = 1,
    dilation: int = 1,
) -> torch.Tensor:
    """Conv with TF 'SAME' padding in x's dtype."""
    kh, kw = weight.shape[2:]
    ph = same_padding(x.shape[2], kh, stride, dilation)
    pw = same_padding(x.shape[3], kw, stride, dilation)
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, b, stride, (ph[0], pw[0]), dilation)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, b, stride, 0, dilation)


class Conv(nn.Module):
    """kh x kw conv + bias (+ ReLU), TF 'SAME' padding.  Parameters
    `weight` (cout, cin, kh, kw) and `bias` (cout,), float32."""

    def __init__(
        self,
        cin: int,
        cout: int,
        k: int,
        generator: torch.Generator,
        stride: int = 1,
        dilation: int = 1,
        activation: bool = True,
    ):
        super().__init__()
        w, b = conv_init(k, k, cin, cout, generator)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(b)
        self.stride = stride
        self.dilation = dilation
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv2d_same(x, self.weight, self.bias, self.stride, self.dilation)
        return F.relu(out) if self.activation else out


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool, TF 'SAME': an odd size pads the far edge with
    -inf, which is what ceil_mode does."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


class L2Norm(nn.Module):
    """Channelwise L2 normalization with a learned scale, computed in
    float32 and cast back."""

    def __init__(self, channels: int, scale_init: float, eps: float = 1e-12):
        super().__init__()
        self.scale = nn.Parameter(torch.full((channels,), float(scale_init)))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = torch.rsqrt((xf * xf).sum(dim=1, keepdim=True) + self.eps)
        return (xf * norm * self.scale.float()[:, None, None]).to(x.dtype)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample with half-pixel centres (jax.image.resize).

    The forward is ATen's upsample_bilinear2d everywhere.  On a CUDA tensor
    it is _Upsample2x, whose gradient is the gather kernel of
    csrc/upsample2x_bwd.cu (ops/upsample_cuda.py): ATen's CUDA backward adds
    atomically, so it differs run to run, and the deterministic mode refuses
    it.  So the card's train step is reproducible in every mode.  On the
    CPU, ATen's backward is deterministic and stays the default; under
    torch.use_deterministic_algorithms(True) the CPU also takes _Upsample2x,
    whose gradient there is the kernel's plain version (slice sums)."""
    if x.device.type != "cpu" or torch.are_deterministic_algorithms_enabled():
        return _Upsample2x.apply(x)
    return _bilinear2x(x)


def _bilinear2x(x: torch.Tensor) -> torch.Tensor:
    """F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)'s
    kernel, called directly: under the deterministic mode F.interpolate takes
    a slower composite of index and arithmetic ops on CUDA."""
    return torch.ops.aten.upsample_bilinear2d.vec(x, None, False, [2.0, 2.0])


class _Upsample2x(torch.autograd.Function):
    """upsample2x with a gradient made of sums in a fixed order, in at least
    float32: the kernel on a CUDA gradient, its plain version on a CPU one."""

    @staticmethod
    def forward(ctx, x):
        return _bilinear2x(x)

    @staticmethod
    def backward(ctx, g):
        return upsample_cuda.upsample2x_bwd(g.contiguous())
