"""L2Norm of a channels-last tap over its channels in one pass: the CUDA
kernel (csrc/l2norm.cu) and its plain PyTorch version.

    out = l2norm(x, scale (C,) float32, eps)
    out = ((x.float() * rsqrt(sum_c x.float()^2 + eps)) * scale).to(x.dtype)

x is a bf16 or float32 (B, C, H, W) tensor in channels-last memory, so its
buffer is (pixels, C) with C fastest; out is a new tensor of x's shape,
dtype and strides.  The plain version is the expression models/layers.py's
L2Norm runs through ATen: six passes over every value (`x.float()`, the
squares, the channel sum, the two products, the cast back), with float32
tensors between them.  The kernel reads x once and writes out once, with
the same float32 operations in the same order, except the order of the
sum's terms: its output is within one unit in the last place of x's dtype
of ATen's, and the same on every run.  It replaces no TPU kernel (XLA fuses
L2Norm on the TPU); bytes bound it.

A CPU tensor goes through `l2norm_plain`; a CUDA tensor launches the
kernel (built on first use by ops/_cuda_build.py) or raises.
"""
from __future__ import annotations

import ctypes

import torch

from dan_tpu_torch.ops import _cuda_build

SOURCE = "l2norm"

# Kernel launches since the last reset (set to 0 to reset).
LAUNCHES = 0


def build() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    lib.l2norm_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.l2norm_launch.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, scale: torch.Tensor) -> int:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"x must be a channels-last (B, C, H, W) tensor, got shape "
                         f"{tuple(x.shape)} strides {x.stride()}")
    c = x.shape[1]
    if scale.shape != (c,) or scale.dtype != torch.float32:
        raise ValueError(f"expected scale ({c},) float32, got {scale.dtype} {tuple(scale.shape)}")
    if x.device != scale.device:
        raise ValueError(f"x on {x.device}, scale on {scale.device}")
    return c


def l2norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(x, scale)
    if x.device.type == "cpu":
        return l2norm_plain(x, scale, eps)
    return _launch(x, scale, eps)


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    global LAUNCHES
    c = _check(x, scale)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        raise ValueError("the l2norm kernel has no backward: it takes no tensor that autograd "
                         "records")
    if x.device.type != "cuda":
        raise ValueError(f"the l2norm kernel takes CUDA tensors, got {x.device}")
    if not scale.is_contiguous():
        raise ValueError("the l2norm kernel takes a contiguous scale")
    out = torch.empty_like(x, memory_format=torch.channels_last)
    lib = build()
    with torch.cuda.device(x.device):
        err = lib.l2norm_launch(x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.numel() // c,
                                c, x.element_size(), eps, _cuda_build.stream_of(x))
    _cuda_build.check(err, "l2norm_launch")
    LAUNCHES += 1
    return out


def l2norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The plain version: L2Norm's ATen expression, in float32 and cast
    back; x of any layout, and autograd records it."""
    xf = x.float()
    norm = torch.rsqrt((xf * xf).sum(dim=1, keepdim=True) + eps)
    return (xf * norm * scale.float()[:, None, None]).to(x.dtype)
