"""The LFPN's top-down fusion in one pass: the CUDA kernel
(csrc/lfpn_fuse.cu) and its plain PyTorch version.

    out = lfpn_fuse(topdown, lateral, op)
    out = upsample2x(topdown)[:, :, :H, :W] * lateral     (op "product")
    out = upsample2x(topdown)[:, :, :H, :W] + lateral     (op "sum")

topdown is a (B, C, h, w) and lateral a (B, C, H, W) tensor, bf16 or
float32, of one dtype, in channels-last memory, with H <= 2h and W <= 2w;
upsample2x is ATen's upsample_bilinear2d at scale 2 with half-pixel centres
(models/layers.py::upsample2x's forward).  out is a new tensor of lateral's
shape, dtype and strides.  The plain version is the expression the LFPN
runs through ATen: the upsample, a view that crops it and the product or
sum, two passes and the upsampled map written between them.  The kernel
reads topdown and lateral once and writes out once, with the arithmetic of
ATen's channels-last upsample operation by operation, its FMAs included
(the upsampled value rounded to the dtype before the product, as ATen's two
passes round it), so its output is ATen's bit for bit: in bf16 at every
width, in float32 where C >= 16.  Below 16 channels ATen upsamples with its
NCHW kernel, which contracts the sums into FMAs in another order; in bf16
that changes no bit, in float32 it moves the last bits of 10-15 % of the
values.  It replaces no TPU kernel (XLA fuses the resize and the
product on the TPU); bytes bound it.

A CPU tensor goes through `lfpn_fuse_plain`; a CUDA tensor launches the
kernel (built on first use by ops/_cuda_build.py) or raises.
"""
from __future__ import annotations

import ctypes

import torch

from dan_tpu_torch.ops import _cuda_build

SOURCE = "lfpn_fuse"
OPS = ("product", "sum")

# Kernel launches since the last reset (set to 0 to reset).
LAUNCHES = 0


def build() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    lib.lfpn_fuse_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    lib.lfpn_fuse_launch.restype = ctypes.c_int
    return lib


def _check(topdown: torch.Tensor, lateral: torch.Tensor, op: str) -> None:
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    for name, t in (("topdown", topdown), ("lateral", lateral)):
        if t.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"{name} must be bfloat16 or float32, got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"{name} must be a channels-last (B, C, H, W) tensor, got shape "
                             f"{tuple(t.shape)} strides {t.stride()}")
    if topdown.dtype != lateral.dtype:
        raise TypeError(f"topdown is {topdown.dtype}, lateral {lateral.dtype}")
    (b, c, h, w), (lb, lc, lh, lw) = topdown.shape, lateral.shape
    if (b, c) != (lb, lc):
        raise ValueError(f"topdown {tuple(topdown.shape)} and lateral {tuple(lateral.shape)} "
                         f"differ in batch or channels")
    if 2 * h < lh or 2 * w < lw:
        raise ValueError(f"the upsampled topdown ({2 * h}, {2 * w}) is smaller than lateral "
                         f"({lh}, {lw})")
    if topdown.device != lateral.device:
        raise ValueError(f"topdown on {topdown.device}, lateral on {lateral.device}")


def lfpn_fuse(topdown: torch.Tensor, lateral: torch.Tensor, op: str) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(topdown, lateral, op)
    if lateral.device.type == "cpu":
        return lfpn_fuse_plain(topdown, lateral, op)
    return _launch(topdown, lateral, op)


def _launch(topdown: torch.Tensor, lateral: torch.Tensor, op: str) -> torch.Tensor:
    global LAUNCHES
    _check(topdown, lateral, op)
    if torch.is_grad_enabled() and (topdown.requires_grad or lateral.requires_grad):
        raise ValueError("the lfpn_fuse kernel has no backward: it takes no tensor that autograd "
                         "records")
    if lateral.device.type != "cuda":
        raise ValueError(f"the lfpn_fuse kernel takes CUDA tensors, got {lateral.device}")
    b, c, h, w = topdown.shape
    out = torch.empty_like(lateral, memory_format=torch.channels_last)
    lib = build()
    with torch.cuda.device(lateral.device):
        err = lib.lfpn_fuse_launch(topdown.data_ptr(), lateral.data_ptr(), out.data_ptr(), b, c,
                                   h, w, lateral.shape[2], lateral.shape[3],
                                   lateral.element_size(), int(op == "sum"),
                                   _cuda_build.stream_of(lateral))
    _cuda_build.check(err, "lfpn_fuse_launch")
    LAUNCHES += 1
    return out


def lfpn_fuse_plain(topdown: torch.Tensor, lateral: torch.Tensor, op: str) -> torch.Tensor:
    """The plain version: the LFPN's ATen expression, of any layout, and
    autograd records it."""
    up = torch.ops.aten.upsample_bilinear2d.vec(topdown, None, False, [2.0, 2.0])
    up = up[:, :, : lateral.shape[2], : lateral.shape[3]]
    return up * lateral if op == "product" else up + lateral
