"""Weight gradient of the packed conv1_2': the CUDA kernel
(csrc/conv12_wgrad.cu) and its plain PyTorch version.

    dk2 = conv12_wgrad(o1_pre (B, H, W, CI), dr (B, H+1, W+1, CO))
        -> (CO, CI, 2, 2) float32

o1_pre is the PRE-relu conv1_1' output and dr the cotangent of the packed
conv1_2' output, both in the JAX package's NHWC layout and contiguous (the
memory layout of the port's channels-last activations).  The result is the
gradient of conv2d(relu(o1_pre), k2, padding=1) with respect to k2, in the
port's OIHW layout, accumulated in float32: the semantics of
dan_tpu/ops/conv12_wgrad_pallas.py with relu_input=True.  Unlike the TPU
kernel it has no batch-size rule.

A CPU tensor goes through `conv12_wgrad_plain`; a CUDA tensor launches the
kernel (bf16 operands; built on first use by ops/_cuda_build.py) or raises.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dan_tpu_torch.ops import _cuda_build

SOURCE = "conv12_wgrad"
_TILE = 128  # the kernel's tile edge: CI and CO must be multiples of it
# Split-K: each split sums about _CHAIN pixels into its own float32 partial.
# The error of the partial sums grows with their length: measured on the
# H100 against a float64 reference, 8.6k-pixel chains were 7.6e-6 (rel. L2),
# 26k 2.6e-5, 69k 7.2e-5; the time at batch 32 is flat from 48 to 192 splits.
_CHAIN = 16384
_MAX_SPLITS = 256

# Kernel launches since the last reset (set to 0 to reset).
LAUNCHES = 0


def build() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    lib.conv12_wgrad_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p
    ]
    lib.conv12_wgrad_launch.restype = ctypes.c_int
    return lib


def _check(o1_pre: torch.Tensor, dr: torch.Tensor) -> None:
    if o1_pre.dim() != 4 or dr.dim() != 4:
        raise ValueError(
            f"expected o1_pre (B, H, W, CI) and dr (B, H+1, W+1, CO), got "
            f"{tuple(o1_pre.shape)} and {tuple(dr.shape)}"
        )
    b, h, w, _ = o1_pre.shape
    if tuple(dr.shape[:3]) != (b, h + 1, w + 1):
        raise ValueError(f"dr {tuple(dr.shape)} does not fit o1_pre {tuple(o1_pre.shape)}")
    if o1_pre.dtype != dr.dtype or o1_pre.device != dr.device:
        raise ValueError(
            f"o1_pre {o1_pre.dtype} on {o1_pre.device}, dr {dr.dtype} on {dr.device}"
        )


def conv12_wgrad(o1_pre: torch.Tensor, dr: torch.Tensor) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(o1_pre, dr)
    if o1_pre.device.type == "cpu":
        return conv12_wgrad_plain(o1_pre, dr)
    return _launch(o1_pre, dr)


def _launch(o1_pre: torch.Tensor, dr: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if o1_pre.device.type != "cuda":
        raise ValueError(f"the wgrad kernel takes CUDA tensors, got {o1_pre.device}")
    if o1_pre.dtype != torch.bfloat16:
        raise TypeError(f"the wgrad kernel takes bf16 operands, got {o1_pre.dtype}")
    if not (o1_pre.is_contiguous() and dr.is_contiguous()):
        raise ValueError("the wgrad kernel takes contiguous NHWC o1_pre and dr")
    b, h, w, ci = o1_pre.shape
    co = dr.shape[-1]
    if ci % _TILE or co % _TILE:
        raise ValueError(f"the wgrad kernel needs CI, CO multiples of {_TILE}: {ci}, {co}")
    k_total = b * (h + 1) * (w + 1)
    if k_total >= 2**31:
        raise ValueError(f"{k_total} pixels exceed the kernel's 32-bit index")
    splits = max(1, min(_MAX_SPLITS, -(-k_total // _CHAIN)))
    lib = build()
    partial = torch.empty((splits, 4 * ci, co), dtype=torch.float32, device=dr.device)
    out = torch.empty((co, ci, 2, 2), dtype=torch.float32, device=dr.device)
    with torch.cuda.device(dr.device):
        err = lib.conv12_wgrad_launch(
            o1_pre.data_ptr(), dr.data_ptr(), partial.data_ptr(), out.data_ptr(),
            b, h, w, ci, co, splits, _cuda_build.stream_of(dr),
        )
    _cuda_build.check(err, "conv12_wgrad_launch")
    LAUNCHES += 1
    return out


def conv12_wgrad_plain(o1_pre: torch.Tensor, dr: torch.Tensor) -> torch.Tensor:
    """The plain version: torch's conv weight gradient in float32 (call it
    with TF32 off on a card for a float32 reference)."""
    _check(o1_pre, dr)
    ci, co = o1_pre.shape[-1], dr.shape[-1]
    x = F.relu(o1_pre).float().permute(0, 3, 1, 2)
    g = dr.float().permute(0, 3, 1, 2)
    return torch.nn.grad.conv2d_weight(x, (co, ci, 2, 2), g, padding=1)
