"""The int8 convolution with its fused epilogue: the CUDA kernel
(csrc/conv_i8.cu) and, for CPU tensors, its plain version (ops/conv_i8.py).

    out = conv_i8(x_q, k_q, deq, bias, inv_next, stride=1, dilation=1,
                  padding=(top, bottom, left, right), tap_dtype=torch.bfloat16)
    out.tap    relu(acc * deq + bias) in tap_dtype (None without tap_dtype)
    out.q      int8 clip(round(tap_f32 * inv_next), -127, 127) (None without inv_next)
    out.acc    the int32 sum (only with with_acc=True: the check of the product)

x_q int8 (B, H, W, Ci), k_q int8 (Co, kh, kw, Ci), deq / bias / inv_next
float32 (Co,); outputs (B, Ho, Wo, Co).  The kernel replaces XLA's s8 conv
and the chain it fuses into the conv's output in dan_tpu/quant.py (no
Pallas kernel).  A CUDA tensor launches the kernel (built on first use by
ops/_cuda_build.py) or raises: it takes contiguous operands with Ci % 32
== 0 and Co % 8 == 0.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from dan_tpu_torch.ops import _cuda_build
from dan_tpu_torch.ops.conv_i8 import (
    Padding,
    check_conv_args,
    conv_i8_epilogue_plain,
    conv_i8_plain,
    out_size,
)

SOURCE = "conv_i8"

# Kernel launches since the last reset (set to 0 to reset).
LAUNCHES = 0

_TAP_KIND = {None: 0, torch.float32: 1, torch.bfloat16: 2}


class ConvI8Out(NamedTuple):
    tap: Optional[torch.Tensor]
    q: Optional[torch.Tensor]
    acc: Optional[torch.Tensor]


def build() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    lib.conv_i8_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2
        + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    )
    lib.conv_i8_launch.restype = ctypes.c_int
    lib.conv_i8_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes() -> int:
    """Dynamic shared memory a block of the kernel takes (builds it)."""
    return build().conv_i8_smem_bytes()


def _check(x, k, deq, bias, inv_next, padding, tap_dtype, with_acc) -> None:
    check_conv_args(x, k, padding)
    co = k.shape[0]
    for name, v in (("deq", deq), ("bias", bias), ("inv_next", inv_next)):
        if v is None and name == "inv_next":
            continue
        if v.dtype != torch.float32 or v.shape != (co,) or v.device != x.device:
            raise ValueError(f"{name} must be float32 ({co},) on {x.device}, got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")
    if tap_dtype not in _TAP_KIND:
        raise ValueError(f"tap_dtype must be None, float32 or bfloat16, got {tap_dtype}")
    if tap_dtype is None and inv_next is None and not with_acc:
        raise ValueError("conv_i8 needs an output: tap_dtype, inv_next or with_acc")


def conv_i8(
    x: torch.Tensor,
    k: torch.Tensor,
    deq: torch.Tensor,
    bias: torch.Tensor,
    inv_next: Optional[torch.Tensor] = None,
    stride: int = 1,
    dilation: int = 1,
    padding: Padding = (0, 0, 0, 0),
    tap_dtype: Optional[torch.dtype] = None,
    with_acc: bool = False,
) -> ConvI8Out:
    """CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(x, k, deq, bias, inv_next, padding, tap_dtype, with_acc)
    if x.device.type == "cpu":
        acc = conv_i8_plain(x, k, stride, dilation, padding)
        tap, q = conv_i8_epilogue_plain(acc, deq, bias, inv_next, tap_dtype)
        return ConvI8Out(tap, q, acc if with_acc else None)
    return _launch(x, k, deq, bias, inv_next, stride, dilation, padding, tap_dtype, with_acc)


def _launch(x, k, deq, bias, inv_next, stride, dilation, padding, tap_dtype, with_acc):
    global LAUNCHES
    if x.device.type != "cuda":
        raise ValueError(f"the conv_i8 kernel takes CUDA tensors, got {x.device}")
    operands = [x, k, deq, bias] + ([inv_next] if inv_next is not None else [])
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("the conv_i8 kernel takes contiguous operands")
    if x.shape[3] % 32 or k.shape[0] % 8:
        raise ValueError(f"the conv_i8 kernel needs Ci % 32 == 0 and Co % 8 == 0, got "
                         f"Ci={x.shape[3]}, Co={k.shape[0]}")
    if any(t.data_ptr() % 16 for t in operands):
        raise ValueError("the conv_i8 kernel takes 16-byte aligned operands")
    b, h, w, ci = x.shape
    co, kh, kw, _ = k.shape
    pt, pb, pl, pr = padding
    ho = out_size(h, kh, stride, dilation, pt, pb)
    wo = out_size(w, kw, stride, dilation, pl, pr)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output {ho}x{wo}")
    shape = (b, ho, wo, co)
    dev = x.device
    tap = None if tap_dtype is None else torch.empty(shape, dtype=tap_dtype, device=dev)
    q = None if inv_next is None else torch.empty(shape, dtype=torch.int8, device=dev)
    acc = torch.empty(shape, dtype=torch.int32, device=dev) if with_acc else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = build()
    with torch.cuda.device(dev):
        err = lib.conv_i8_launch(
            x.data_ptr(), k.data_ptr(), deq.data_ptr(), bias.data_ptr(), ptr(inv_next),
            ptr(tap), _TAP_KIND[tap_dtype], ptr(q), ptr(acc), b, h, w, ci, co, kh, kw,
            stride, dilation, pt, pl, ho, wo, _cuda_build.stream_of(x),
        )
    _cuda_build.check(err, "conv_i8_launch")
    LAUNCHES += 1
    return ConvI8Out(tap, q, acc)
