"""Bias (+ ReLU) of a convolution's output in one in-place pass: the CUDA
kernel (csrc/bias_act.cu) and its plain PyTorch version.

    y = bias_act(y, bias (C,) float32 or y's dtype, relu)
    y = relu(y + bias.to(y.dtype))   (the add alone when relu is False)

y is bf16 or float32: a 4-D (B, C, H, W) tensor in channels-last memory,
or any contiguous (..., C) tensor; either way its buffer is (pixels, C)
with C fastest.  The arithmetic is ATen's for `F.relu(y + b.to(y.dtype))`
(one float32 sum rounded to y's dtype, then the clamp), so the kernel's
output equals ATen's bit for bit, NaN included.  It replaces no TPU kernel:
it is the epilogue that ATen runs as two passes after cuDNN's convolution
(the broadcast bias add, then the ReLU clamp), and like them it is bound by
bytes, each value read and written once.

A CPU tensor goes through `bias_act_plain` (a new tensor); a CUDA tensor
launches the kernel (built on first use by ops/_cuda_build.py), which
overwrites y and returns it, or raises.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dan_tpu_torch.ops import _cuda_build

SOURCE = "bias_act"

# Kernel launches since the last reset (set to 0 to reset).
LAUNCHES = 0


def build() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    lib.bias_act_launch.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.bias_act_launch.restype = ctypes.c_int
    return lib


def channels(y: torch.Tensor) -> int:
    """C of y's (pixels, C) buffer; raises unless the buffer is that: a
    channels-last 4-D tensor, or a contiguous tensor of another rank."""
    if y.dim() == 4:
        if not y.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"a 4-D y must be channels-last, got strides {y.stride()} for "
                             f"shape {tuple(y.shape)}")
        return y.shape[1]
    if y.dim() < 1 or not y.is_contiguous():
        raise ValueError(f"y must be a contiguous (..., C) tensor, got shape {tuple(y.shape)}")
    return y.shape[-1]


def _check(y: torch.Tensor, bias: torch.Tensor) -> int:
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"y must be bfloat16 or float32, got {y.dtype}")
    c = channels(y)
    if bias.shape != (c,) or bias.dtype not in (torch.float32, y.dtype):
        raise ValueError(f"expected bias ({c},) float32 or {y.dtype}, got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    if y.device != bias.device:
        raise ValueError(f"y on {y.device}, bias on {bias.device}")
    return c


def bias_act(y: torch.Tensor, bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel,
    in place on y."""
    _check(y, bias)
    if y.device.type == "cpu":
        return bias_act_plain(y, bias, relu)
    return _launch(y, bias, relu)


def _launch(y: torch.Tensor, bias: torch.Tensor, relu: bool) -> torch.Tensor:
    global LAUNCHES
    c = _check(y, bias)
    if y.device.type != "cuda":
        raise ValueError(f"the bias_act kernel takes CUDA tensors, got {y.device}")
    if y.requires_grad and torch.is_grad_enabled():
        raise ValueError("the bias_act kernel overwrites y: it takes no tensor that autograd records")
    if not bias.is_contiguous():
        raise ValueError("the bias_act kernel takes a contiguous bias")
    lib = build()
    with torch.cuda.device(y.device):
        err = lib.bias_act_launch(y.data_ptr(), bias.data_ptr(), y.numel(), c, y.element_size(),
                                  bias.element_size(), int(bool(relu)), _cuda_build.stream_of(y))
    _cuda_build.check(err, "bias_act_launch")
    LAUNCHES += 1
    return y


def bias_act_plain(y: torch.Tensor, bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """The plain version: ATen's `F.relu(y + bias.to(y.dtype))` (the add
    alone without relu), broadcast over y's channel dimension."""
    c = _check(y, bias)
    b = bias.to(y.dtype)
    out = y + (b.reshape(c, 1, 1) if y.dim() == 4 else b)
    return F.relu(out) if relu else out
