"""relu + int8 quantization of a channels-last activation: the CUDA kernel
(csrc/quantize_i8.cu) and its plain PyTorch version.

    q = quantize_i8(y (..., C) bf16 or float32, inv (C,) float32) -> int8 (..., C)
    q = clip(round(relu(y) * inv), -127, 127), in float32, half to even

This is dan_tpu/quant.py's relu + _quantize_act on the conv1_1' output (the
packed path) or on pool1 (odd sizes), with inv = 1 / scale made once in
float32 (quant.py::reciprocal).  A CPU tensor goes through
`quantize_i8_plain`; a CUDA tensor launches the kernel (built on first use
by ops/_cuda_build.py) or raises: it takes a contiguous y with C % 8 == 0.
"""
from __future__ import annotations

import ctypes

import torch

from dan_tpu_torch.ops import _cuda_build

SOURCE = "quantize_i8"

# Kernel launches since the last reset (set to 0 to reset).
LAUNCHES = 0


def build() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    lib.quantize_i8_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.quantize_i8_launch.restype = ctypes.c_int
    return lib


def _check(y: torch.Tensor, inv: torch.Tensor) -> None:
    if y.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"y must be float32 or bfloat16, got {y.dtype}")
    if y.dim() < 1 or inv.dtype != torch.float32 or inv.shape != (y.shape[-1],):
        raise ValueError(f"expected y (..., C) and inv float32 (C,), got {tuple(y.shape)} and "
                         f"{inv.dtype} {tuple(inv.shape)}")
    if y.device != inv.device:
        raise ValueError(f"y on {y.device}, inv on {inv.device}")


def quantize_i8(y: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(y, inv)
    if y.device.type == "cpu":
        return quantize_i8_plain(y, inv)
    return _launch(y, inv)


def _launch(y: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if y.device.type != "cuda":
        raise ValueError(f"the quantize kernel takes CUDA tensors, got {y.device}")
    c = y.shape[-1]
    if not (y.is_contiguous() and inv.is_contiguous()) or c % 8:
        raise ValueError(f"the quantize kernel takes a contiguous y with C % 8 == 0, got C={c}")
    if y.data_ptr() % 16:
        raise ValueError("the quantize kernel takes a 16-byte aligned y")
    q = torch.empty(y.shape, dtype=torch.int8, device=y.device)
    lib = build()
    with torch.cuda.device(y.device):
        err = lib.quantize_i8_launch(y.data_ptr(), inv.data_ptr(), q.data_ptr(), y.numel() // c,
                                     c, y.element_size(), _cuda_build.stream_of(y))
    _cuda_build.check(err, "quantize_i8_launch")
    LAUNCHES += 1
    return q


def quantize_i8_plain(y: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """The plain version: relu as y > 0 ? y : +0 in float32, times inv,
    rounded half to even, clipped to +-127."""
    _check(y, inv)
    r = y.float()
    r = torch.where(r > 0, r, torch.zeros((), dtype=r.dtype, device=r.device))
    return torch.round(r * inv).clamp_(-127, 127).to(torch.int8)
