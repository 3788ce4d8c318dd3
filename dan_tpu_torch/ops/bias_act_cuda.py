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

The residual variant closes a ResNet bottleneck (models/resnet.py):

    y = bias_residual_relu(y, bias, r)
    y = relu((y + bias.to(y.dtype)) + r)      (r: y's dtype, shape and strides)

bit for bit ATen's two adds and clamp, each sum rounded to y's dtype, in
one in-place pass (kernel `residual_relu_kernel`) that reads y and r and
writes y: 3 accesses a value against ATen's 7.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dan_tpu_torch.ops import _cuda_build

SOURCE = "bias_act"

# Kernel launches since the last reset (set to 0 to reset): the plain
# pass's, and the residual variant's apart.
LAUNCHES = 0
RESIDUAL_LAUNCHES = 0


def build() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    lib.bias_act_launch.argtypes = [ctypes.c_void_p] * 2 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.bias_act_launch.restype = ctypes.c_int
    lib.bias_residual_relu_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.bias_residual_relu_launch.restype = ctypes.c_int
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


def _check_residual(y: torch.Tensor, bias: torch.Tensor, r: torch.Tensor) -> int:
    c = _check(y, bias)
    if r.dtype != y.dtype or r.shape != y.shape or r.stride() != y.stride():
        raise ValueError(f"r must have y's dtype, shape and strides: y {y.dtype} "
                         f"{tuple(y.shape)} {y.stride()}, r {r.dtype} {tuple(r.shape)} "
                         f"{r.stride()}")
    if r.device != y.device:
        raise ValueError(f"y on {y.device}, r on {r.device}")
    return c


def bias_residual_relu(y: torch.Tensor, bias: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel,
    in place on y."""
    _check_residual(y, bias, r)
    if y.device.type == "cpu":
        return bias_residual_relu_plain(y, bias, r)
    return _launch_residual(y, bias, r)


def _launch_residual(y: torch.Tensor, bias: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    global RESIDUAL_LAUNCHES
    c = _check_residual(y, bias, r)
    if y.device.type != "cuda":
        raise ValueError(f"the residual pass takes CUDA tensors, got {y.device}")
    if torch.is_grad_enabled() and (y.requires_grad or r.requires_grad):
        raise ValueError("the residual pass overwrites y: it takes no tensor that autograd records")
    if not bias.is_contiguous():
        raise ValueError("the residual pass takes a contiguous bias")
    if y.data_ptr() == r.data_ptr():
        raise ValueError("the residual pass takes an r apart from y")
    lib = build()
    with torch.cuda.device(y.device):
        err = lib.bias_residual_relu_launch(y.data_ptr(), r.data_ptr(), bias.data_ptr(),
                                            y.numel(), c, y.element_size(), bias.element_size(),
                                            _cuda_build.stream_of(y))
    _cuda_build.check(err, "bias_residual_relu_launch")
    RESIDUAL_LAUNCHES += 1
    return y


def bias_residual_relu_plain(y: torch.Tensor, bias: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The plain version: ATen's `F.relu((y + bias.to(y.dtype)) + r)`."""
    return F.relu(bias_act_plain(y, bias, False) + r)
