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

The kernel (TMA loads, wgmma, one producer warp and two consumer
warpgroups) gives a block 128 rows of dW -- one tap, 128 input channels --
by 256 output channels and a contiguous range of the pixels of o1, cut into
segments of 64 along x.  `tiling` computes the ranges; the launch uses it
and the CPU tests can call it.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Iterator, Tuple

import torch
import torch.nn.functional as F

from dan_tpu_torch.ops import _cuda_build

SOURCE = "conv12_wgrad"
TILE_M = 128  # rows of dW a block owns: CI must be a multiple of it
TILE_N = 256  # columns of dW a block owns: CO must be a multiple of it
SEGMENT = 64  # pixels of one row of o1 a pipeline stage holds
# The error of a tensor-core accumulation grows with the length of the
# chain: measured on the H100 against a float64 reference, chains of 8.6k
# pixels were 7.6e-6 (rel. L2), 17k 1.6e-5, 26k 2.6e-5, 69k 7.2e-5.  A block
# walks far more (about 200k at batch 32), so it ends a chain every
# FLUSH_PIXELS pixels: its registers go into its float32 partial by plain
# adds and start again from zero.
FLUSH_PIXELS = 16384
_SMS = 132  # an H100's; `tiling` takes the card's own count from the launch

# Kernel launches since the last reset (set to 0 to reset).
LAUNCHES = 0
# The tiling of the last launch.
LAST_TILING = None


@dataclasses.dataclass(frozen=True)
class Tiling:
    """How the pixels of o1 (B, H, W) are shared out.  Row (b, y) is cut
    into `segs_x` segments of 64 pixels (the last one ragged when W is not
    a multiple of 64: the kernel reads zeros past W); the b*h*segs_x
    segments, in (b, y, x) order, are dealt to `ranges` blocks of
    `segs_per_range` each (the last may be short), and a block ends an
    accumulation chain every `flush_segs` segments.  There is one float32
    partial of dW for each range."""

    b: int
    h: int
    w: int
    segs_x: int
    total_segs: int
    ranges: int
    segs_per_range: int
    flush_segs: int

    @property
    def partials(self) -> int:
        return self.ranges

    def segments(self, r: int) -> Iterator[Tuple[int, int, int, int]]:
        """(b, y, x0, x1) of range r's segments of o1, in the kernel's order.
        For tap (kh, kw) a pixel (b, y, x) meets dr at (b, y+1-kh, x+1-kw)."""
        lo = r * self.segs_per_range
        for q in range(lo, min(self.total_segs, lo + self.segs_per_range)):
            row, sx = divmod(q, self.segs_x)
            b, y = divmod(row, self.h)
            yield b, y, sx * SEGMENT, min(self.w, (sx + 1) * SEGMENT)

    def chains(self, r: int):
        """Pixels of each accumulation chain of range r."""
        px = [x1 - x0 for _, _, x0, x1 in self.segments(r)]
        return [sum(px[i:i + self.flush_segs]) for i in range(0, len(px), self.flush_segs)]


def tiling(b: int, h: int, w: int, ci: int, co: int, sms: int = _SMS) -> Tiling:
    """One block an SM where the pixels allow: the 4*ci/128 x co/256 tiles
    of dW times as many pixel ranges as fit `sms`, no range empty."""
    segs_x = -(-w // SEGMENT)
    total = b * h * segs_x
    tiles = (4 * ci // TILE_M) * (co // TILE_N)
    ranges = max(1, min(sms // max(tiles, 1), total))
    per = -(-total // ranges)
    return Tiling(b, h, w, segs_x, total, -(-total // per), per, FLUSH_PIXELS // SEGMENT)


def build() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    lib.conv12_wgrad_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
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


def kernel_takes(o1_pre: torch.Tensor, dr: torch.Tensor) -> None:
    """Raise on what the kernel does not take (beyond `_check`): anything but
    contiguous, 16-byte aligned bf16 NHWC operands with CI a multiple of 128
    and CO of 256."""
    if o1_pre.dtype != torch.bfloat16:
        raise TypeError(f"the wgrad kernel takes bf16 operands, got {o1_pre.dtype}")
    if not (o1_pre.is_contiguous() and dr.is_contiguous()):
        raise ValueError("the wgrad kernel takes contiguous NHWC o1_pre and dr")
    ci, co = o1_pre.shape[-1], dr.shape[-1]
    if ci % TILE_M or co % TILE_N:
        raise ValueError(
            f"the wgrad kernel needs CI a multiple of {TILE_M} and CO of {TILE_N}: {ci}, {co}")
    if min(o1_pre.shape[:3]) < 1:
        raise ValueError(f"the wgrad kernel needs a non-empty o1_pre, got {tuple(o1_pre.shape)}")
    if o1_pre.data_ptr() % 16 or dr.data_ptr() % 16:
        raise ValueError("the wgrad kernel needs 16-byte aligned operands")


def _launch(o1_pre: torch.Tensor, dr: torch.Tensor) -> torch.Tensor:
    global LAUNCHES, LAST_TILING
    if o1_pre.device.type != "cuda":
        raise ValueError(f"the wgrad kernel takes CUDA tensors, got {o1_pre.device}")
    kernel_takes(o1_pre, dr)
    b, h, w, ci = o1_pre.shape
    co = dr.shape[-1]
    sms = torch.cuda.get_device_properties(dr.device).multi_processor_count
    plan = tiling(b, h, w, ci, co, sms)
    if plan.total_segs >= 2**31:
        raise ValueError(f"{plan.total_segs} segments exceed the kernel's 32-bit index")
    lib = build()
    partial = torch.empty((plan.partials, 4 * ci, co), dtype=torch.float32, device=dr.device)
    out = torch.empty((co, ci, 2, 2), dtype=torch.float32, device=dr.device)
    with torch.cuda.device(dr.device):
        err = lib.conv12_wgrad_launch(
            o1_pre.data_ptr(), dr.data_ptr(), partial.data_ptr(), out.data_ptr(),
            b, h, w, ci, co, plan.ranges, plan.segs_per_range, plan.flush_segs,
            _cuda_build.stream_of(dr),
        )
    _cuda_build.check(err, "conv12_wgrad_launch")
    LAUNCHES += 1
    LAST_TILING = plan
    return out


def conv12_wgrad_plain(o1_pre: torch.Tensor, dr: torch.Tensor) -> torch.Tensor:
    """The plain version: torch's conv weight gradient in float32 (call it
    with TF32 off on a card for a float32 reference)."""
    _check(o1_pre, dr)
    ci, co = o1_pre.shape[-1], dr.shape[-1]
    x = F.relu(o1_pre).float().permute(0, 3, 1, 2)
    g = dr.float().permute(0, 3, 1, 2)
    return torch.nn.grad.conv2d_weight(x, (co, ci, 2, 2), g, padding=1)
