"""The plain PyTorch version of the int8 convolution (counterpart of
dan_tpu/quant.py::_conv_i8) and of the epilogue fused into it: the CPU
path of ops/conv_i8_cuda.py and, on the card, the oracle it is held to.

    acc = conv_i8_plain(x_q, k_q, stride, dilation, padding)   # int32, exact
    tap, q = conv_i8_epilogue_plain(acc, deq, bias, inv_next, tap_dtype)
    pool1 = phase_max_i8(q, co)        # the packed conv1_2''s phase max

Layouts are the kernel's: x_q int8 NHWC (B, H, W, Ci), k_q int8 (Co, kh,
kw, Ci), the result (B, Ho, Wo, Co); padding is (top, bottom, left, right)
zeros, which TF 'SAME' makes asymmetric (`same_padding_2d`).

The sum is exact.  On the CPU it is the JAX package's 4-bit split: k =
16 * k_hi + k_lo with k_hi = floor((k + 8) / 16) and k_lo in [-8, 8), two
float32 convolutions whose partial sums are integers below 2^24 (R * 127 * 8
for R = kh * kw * Ci <= 16,512; the net's largest R is 4,608), each cast to
int32 before the recombination; a larger R takes one float64 convolution.
On the card it is a float64 im2col and matrix product, a batch chunk at a
time (DGEMM has no Winograd or FFT form, and every partial sum is an
integer below 2^53).  Either way the float result is checked to be integral
before the cast: an inexact algorithm (Winograd, FFT, TF32) raises instead
of rounding silently.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dan_tpu_torch.models.layers import same_padding

Padding = Tuple[int, int, int, int]

# Float64 elements of one im2col chunk on the card (2 GiB).
_IM2COL_CHUNK = 2**28


def same_padding_2d(h: int, w: int, kh: int, kw: int, stride: int, dilation: int) -> Padding:
    """TF 'SAME' padding of an (h, w) input: (top, bottom, left, right)."""
    return (*same_padding(h, kh, stride, dilation), *same_padding(w, kw, stride, dilation))


def out_size(size: int, k: int, stride: int, dilation: int, before: int, after: int) -> int:
    return (size + before + after - dilation * (k - 1) - 1) // stride + 1


def check_conv_args(x_q: torch.Tensor, k_q: torch.Tensor, padding: Padding) -> None:
    if x_q.dtype != torch.int8 or k_q.dtype != torch.int8:
        raise TypeError(f"conv_i8 takes int8 operands, got {x_q.dtype} and {k_q.dtype}")
    if x_q.dim() != 4 or k_q.dim() != 4 or k_q.shape[3] != x_q.shape[3]:
        raise ValueError(
            f"expected x (B, H, W, Ci) and k (Co, kh, kw, Ci), got {tuple(x_q.shape)} and "
            f"{tuple(k_q.shape)}")
    if len(padding) != 4 or min(padding) < 0:
        raise ValueError(f"padding must be (top, bottom, left, right) >= 0, got {padding}")
    if x_q.device != k_q.device:
        raise ValueError(f"x on {x_q.device}, k on {k_q.device}")


def _integral(t: torch.Tensor, what: str) -> torch.Tensor:
    if not torch.equal(t, torch.round(t)):
        raise AssertionError(
            f"conv_i8_plain: the {what} convolution's float result is not integral; the "
            "algorithm is inexact (Winograd, FFT or TF32?)")
    return t


def conv_i8_plain(
    x_q: torch.Tensor,
    k_q: torch.Tensor,
    stride: int = 1,
    dilation: int = 1,
    padding: Padding = (0, 0, 0, 0),
) -> torch.Tensor:
    """int8 x int8 -> the exact int32 convolution (B, Ho, Wo, Co)."""
    check_conv_args(x_q, k_q, padding)
    pt, pb, pl, pr = padding
    co, kh, kw, ci = k_q.shape
    x = F.pad(x_q.permute(0, 3, 1, 2), (pl, pr, pt, pb))  # NCHW view, padded
    if x_q.device.type != "cpu":
        return _conv_f64_im2col(x, k_q, stride, dilation)
    r = kh * kw * ci
    if r * 127 * 8 >= 2**24:
        acc = F.conv2d(x.double(), k_q.double().permute(0, 3, 1, 2), stride=stride,
                       dilation=dilation)
        return _integral(acc, "float64").to(torch.int32).permute(0, 2, 3, 1).contiguous()
    k32 = k_q.to(torch.int32)
    k_hi = (k32 + 8) >> 4  # floor((k + 8) / 16), in [-8, 8]
    k_lo = k32 - (k_hi << 4)  # in [-8, 8)
    xf = x.float()

    def conv(k: torch.Tensor, what: str) -> torch.Tensor:
        out = F.conv2d(xf, k.float().permute(0, 3, 1, 2), stride=stride, dilation=dilation)
        return _integral(out, what).to(torch.int32)

    acc = (conv(k_hi, "high 4-bit") << 4) + conv(k_lo, "low 4-bit")
    return acc.permute(0, 2, 3, 1).contiguous()


def _conv_f64_im2col(x: torch.Tensor, k_q: torch.Tensor, stride: int, dilation: int):
    """The exact sum on the card: float64 im2col (x padded, NCHW view) times
    the kernel as a (Co, Ci*kh*kw) matrix, a batch chunk at a time."""
    co, kh, kw, ci = k_q.shape
    b, _, hp, wp = x.shape
    ho = (hp - dilation * (kh - 1) - 1) // stride + 1
    wo = (wp - dilation * (kw - 1) - 1) // stride + 1
    wmat = k_q.permute(0, 3, 1, 2).reshape(co, ci * kh * kw).double()
    out = torch.empty((b, ho, wo, co), dtype=torch.int32, device=x.device)
    step = max(1, _IM2COL_CHUNK // max(1, ci * kh * kw * ho * wo))
    for i in range(0, b, step):
        cols = F.unfold(x[i:i + step].double(), (kh, kw), dilation=dilation, stride=stride)
        acc = _integral(torch.matmul(wmat, cols), "float64 im2col")  # (n, Co, Ho*Wo)
        out[i:i + step] = acc.to(torch.int32).reshape(-1, co, ho, wo).permute(0, 2, 3, 1)
    return out


def conv_i8_epilogue_plain(
    acc: torch.Tensor,
    deq: torch.Tensor,
    bias: torch.Tensor,
    inv_next: Optional[torch.Tensor] = None,
    tap_dtype: Optional[torch.dtype] = None,
):
    """The epilogue of dan_tpu/quant.py (:396-397, :412-418), every step in
    float32 and in its order, each rounded on its own:
        z = acc * deq + bias;  y = relu(z) (z > 0 ? z : +0)
        tap = y in tap_dtype;  q = clip(round(y * inv_next), -127, 127)
    round is half to even.  -> (tap or None, q int8 or None)."""
    z = acc.float() * deq
    z = z + bias
    y = torch.where(z > 0, z, torch.zeros((), dtype=z.dtype, device=z.device))
    tap = None if tap_dtype is None else y.to(tap_dtype)
    q = None
    if inv_next is not None:
        q = torch.round(y * inv_next).clamp_(-127, 127).to(torch.int8)
    return tap, q


def phase_max_i8(q_all: torch.Tensor, co: int) -> torch.Tensor:
    """pool1 on the requantized packed conv1_2' output (B, H+1, W+1, 4*co)
    int8: the max over the four pixel phases, phase (py, px) in channel
    group py*2+px at spatial offset (py, px)."""
    hh, ww = q_all.shape[1] - 1, q_all.shape[2] - 1
    s = [q_all[:, py:py + hh, px:px + ww, g * co:(g + 1) * co]
         for g, (py, px) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1)))]
    return torch.maximum(torch.maximum(s[0], s[1]), torch.maximum(s[2], s[3])).contiguous()
