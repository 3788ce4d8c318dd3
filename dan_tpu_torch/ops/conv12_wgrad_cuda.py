"""Weight gradient of the packed conv1_2': the CUDA kernels
(csrc/conv12_wgrad.cu for bf16 operands, csrc/conv12_wgrad_f32.cu for
float32 ones) and their plain PyTorch version.

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
kernel of its dtype (built on first use by ops/_cuda_build.py) or raises:
bf16 and float32 are taken, nothing else.

Both kernels give a block 128 rows of dW -- one tap, 128 input channels --
by TILE_N output channels and a contiguous range of the pixels of o1, cut
into segments along x.  The bf16 kernel (TMA loads, wgmma, one producer
warp and two consumer warpgroups) takes 256 output channels and segments
of 64 pixels, one block an SM; the float32 kernel (register-blocked FFMA,
cp.async; wgmma has no float32 operands) 128 and 16, two blocks an SM.  A
block ends an accumulation chain every FLUSH_PIXELS pixels (its registers
go into its float32 partial by plain adds and start again from zero), and
the partials are summed in range order: two runs give the same bits.
`BF16.tiling` and `F32.tiling` compute the ranges; the launch uses them
and the CPU tests can call them.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from dan_tpu_torch.ops import _cuda_build

_SMS = 132  # an H100's; `tiling` takes the card's own count from the launch


@dataclasses.dataclass(frozen=True)
class Tiling:
    """How the pixels of o1 (B, H, W) are shared out.  Row (b, y) is cut
    into `segs_x` segments of `seg` pixels (the last one ragged when W is
    not a multiple of seg: the kernel reads zeros past W); the b*h*segs_x
    segments, in (b, y, x) order, are dealt to `ranges` blocks of
    `segs_per_range` each (the last may be short), and a block ends an
    accumulation chain every `flush_segs` segments.  There is one float32
    partial of dW for each range."""

    b: int
    h: int
    w: int
    seg: int
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
            yield b, y, sx * self.seg, min(self.w, (sx + 1) * self.seg)

    def chains(self, r: int):
        """Pixels of each accumulation chain of range r."""
        px = [x1 - x0 for _, _, x0, x1 in self.segments(r)]
        return [sum(px[i:i + self.flush_segs]) for i in range(0, len(px), self.flush_segs)]


def plan(b: int, h: int, w: int, seg: int, tiles: int, slots: int, flush_pixels: int) -> Tiling:
    """`tiles` tiles of dW times as many pixel ranges as fit `slots` blocks
    on the card at once (the pixels allowing), no range empty; segments of
    `seg` pixels, a chain ended every `flush_pixels`."""
    segs_x = -(-w // seg)
    total = b * h * segs_x
    ranges = max(1, min(slots // max(tiles, 1), total))
    per = -(-total // ranges)
    return Tiling(b, h, w, seg, segs_x, total, -(-total // per), per, flush_pixels // seg)


@dataclasses.dataclass
class Kernel:
    """One of the two kernels: its source, its tile of dW, its segment, the
    blocks an SM holds and the longest accumulation chain; and its launches
    since the last reset (set LAUNCHES to 0 to reset) with the tiling of
    its last launch.  The fields are named as the kernel modules name
    theirs, so that launch counters read a Kernel as they read a module."""

    SOURCE: str
    TILE_M: int  # rows of dW a block owns: CI must be a multiple of it
    TILE_N: int  # columns of dW a block owns: CO must be a multiple of it
    SEGMENT: int  # pixels of one row of o1 a pipeline stage holds
    BLOCKS_PER_SM: int
    FLUSH_PIXELS: int
    LAUNCHES: int = 0
    LAST_TILING: Optional[Tiling] = None

    def tiling(self, b: int, h: int, w: int, ci: int, co: int, sms: int = _SMS) -> Tiling:
        """BLOCKS_PER_SM blocks an SM: the 4*ci/TILE_M x co/TILE_N tiles of
        dW times as many pixel ranges as fit, no range empty."""
        tiles = (4 * ci // self.TILE_M) * (co // self.TILE_N)
        return plan(b, h, w, self.SEGMENT, tiles, self.BLOCKS_PER_SM * sms, self.FLUSH_PIXELS)

    def build(self):
        """The kernel's C launch function, its library built on first use."""
        fn = getattr(_cuda_build.load(self.SOURCE), f"{self.SOURCE}_launch")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn


# The error of a tensor-core accumulation grows with the length of the
# chain: measured on the H100 against a float64 reference, chains of 8.6k
# pixels were 7.6e-6 (rel. L2), 17k 1.6e-5, 26k 2.6e-5, 69k 7.2e-5.  A block
# walks far more (about 200k at batch 32), so it flushes every 16,384.
BF16 = Kernel("conv12_wgrad", TILE_M=128, TILE_N=256, SEGMENT=64, BLOCKS_PER_SM=1,
              FLUSH_PIXELS=16384)
# The rounding error of a chain of n float32 products grows about as
# sqrt(n), and 4,096 keeps it well under the 1e-5 relative L2 that the
# kernel is held to against a float64 reference.  Two blocks an SM: 48 KB
# of shared memory and at most 128 registers a thread.
F32 = Kernel("conv12_wgrad_f32", TILE_M=128, TILE_N=128, SEGMENT=16, BLOCKS_PER_SM=2,
             FLUSH_PIXELS=4096)
KERNELS = {torch.bfloat16: BF16, torch.float32: F32}


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
    """CPU tensors take the plain version; CUDA tensors launch the kernel of
    their dtype."""
    _check(o1_pre, dr)
    if o1_pre.device.type == "cpu":
        return conv12_wgrad_plain(o1_pre, dr)
    return _launch(o1_pre, dr)


def kernel_takes(o1_pre: torch.Tensor, dr: torch.Tensor) -> None:
    """Raise on what the kernels do not take (beyond `_check`): anything but
    contiguous, 16-byte aligned bf16 or float32 NHWC operands with CI a
    multiple of 128 and CO of 256 (the bf16 kernel's tile, which the
    float32 kernel's divides)."""
    if o1_pre.dtype not in KERNELS:
        raise TypeError(f"the wgrad kernels take bf16 or float32 operands, got {o1_pre.dtype}")
    if not (o1_pre.is_contiguous() and dr.is_contiguous()):
        raise ValueError("the wgrad kernel takes contiguous NHWC o1_pre and dr")
    ci, co = o1_pre.shape[-1], dr.shape[-1]
    if ci % BF16.TILE_M or co % BF16.TILE_N:
        raise ValueError(f"the wgrad kernel needs CI a multiple of {BF16.TILE_M} and CO of "
                         f"{BF16.TILE_N}: {ci}, {co}")
    if min(o1_pre.shape[:3]) < 1:
        raise ValueError(f"the wgrad kernel needs a non-empty o1_pre, got {tuple(o1_pre.shape)}")
    if o1_pre.data_ptr() % 16 or dr.data_ptr() % 16:
        raise ValueError("the wgrad kernel needs 16-byte aligned operands")


def _launch(o1_pre: torch.Tensor, dr: torch.Tensor) -> torch.Tensor:
    if o1_pre.device.type != "cuda":
        raise ValueError(f"the wgrad kernel takes CUDA tensors, got {o1_pre.device}")
    kernel_takes(o1_pre, dr)
    kernel = KERNELS[o1_pre.dtype]
    b, h, w, ci = o1_pre.shape
    co = dr.shape[-1]
    sms = torch.cuda.get_device_properties(dr.device).multi_processor_count
    plan = kernel.tiling(b, h, w, ci, co, sms)
    if plan.total_segs >= 2**31:
        raise ValueError(f"{plan.total_segs} segments exceed the kernel's 32-bit index")
    launch = kernel.build()
    partial = torch.empty((plan.partials, 4 * ci, co), dtype=torch.float32, device=dr.device)
    out = torch.empty((co, ci, 2, 2), dtype=torch.float32, device=dr.device)
    with torch.cuda.device(dr.device):
        err = launch(
            o1_pre.data_ptr(), dr.data_ptr(), partial.data_ptr(), out.data_ptr(),
            b, h, w, ci, co, plan.ranges, plan.segs_per_range, plan.flush_segs,
            _cuda_build.stream_of(dr),
        )
    _cuda_build.check(err, f"{kernel.SOURCE}_launch")
    kernel.LAUNCHES += 1
    kernel.LAST_TILING = plan
    return out


def conv12_wgrad_plain(o1_pre: torch.Tensor, dr: torch.Tensor) -> torch.Tensor:
    """The plain version of both kernels: torch's conv weight gradient in
    float32 (call it with TF32 off on a card for a float32 reference)."""
    _check(o1_pre, dr)
    ci, co = o1_pre.shape[-1], dr.shape[-1]
    x = F.relu(o1_pre).float().permute(0, 3, 1, 2)
    g = dr.float().permute(0, 3, 1, 2)
    return torch.nn.grad.conv2d_weight(x, (co, ci, 2, 2), g, padding=1)
