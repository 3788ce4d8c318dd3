"""The int8 convolution with its fused epilogue: the CUDA kernel
(csrc/conv_i8.cu) and, for CPU tensors, its plain version (ops/conv_i8.py).

    out = conv_i8(x_q, k_q, deq, bias, inv_next, stride=1, dilation=1,
                  padding=(top, bottom, left, right), tap_dtype=torch.bfloat16)
    out.tap    relu(acc * deq + bias) in tap_dtype (None without tap_dtype)
    out.q      int8 clip(round(tap_f32 * inv_next), -127, 127) (None without inv_next)
    out.acc    the int32 sum (only with with_acc=True: the check of the product)

    pool1 = conv_i8(x_q, k2q, deq, bias, inv_next, padding=(1, 1, 1, 1),
                    phase_max=True).q     # the packed conv1_2' and its phase max

x_q int8 (B, H, W, Ci), k_q int8 (Co, kh, kw, Ci), deq / bias / inv_next
float32 (Co,); outputs (B, Ho, Wo, Co), or with phase_max pool1 (B, H, W,
Co / 4): `phase_max_i8` of q.  The kernel replaces XLA's s8 conv and the
chain it fuses into the conv's output in dan_tpu/quant.py (no Pallas
kernel).  A CUDA tensor launches the kernel (built on first use by
ops/_cuda_build.py) or raises: it takes contiguous, 16-byte aligned
operands with Ci % 64 == 0 and Co % 64 == 0 and at most MAX_STEPS k-steps
(kh * kw * Ci / slice); phase_max takes the packed conv1_2' only (2x2,
padding 1, stride 1, Ci = Co = 256) and leaves out the k-steps where the
packed form is zero by construction (`packed_zero_mask`), on both devices:
for the packed conv itself the kernel must be zero there, which the caller
checks once with `packed_zeros_hold` (QuantConv does).

`plan(...)` is the launch in numbers (tile rectangle, TMA boxes, the k-step
table with each box's coordinates, stages, persistent tile order), pure
Python: the launch passes exactly its numbers, and the CPU tests replay it.
`LAST_PLAN` is the plan of the last launch.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Iterator, List, NamedTuple, Optional, Tuple

import torch

from dan_tpu_torch.ops import _cuda_build
from dan_tpu_torch.ops.conv_i8 import (
    Padding,
    check_conv_args,
    conv_i8_epilogue_plain,
    conv_i8_plain,
    out_size,
    phase_max_i8,
)

SOURCE = "conv_i8"

TILE_M = 128  # output pixels a tile: two consumer warpgroups of 64 rows (of 128 when bn = 128)
TILE_COLS = (128, 64, 32, 16, 8)  # tile widths tried; rows = tile_m / cols
PHASE_CHANNELS = 64  # channels of one phase group of the packed conv1_2'
MAX_STEPS = 128  # k-steps the kernel's parameter table holds
MAX_RING = 8  # mbarrier stages
# Dynamic shared memory: 227 KB less room for static barriers, the 1 KB
# alignment of the ring (the swizzle is a function of the address), the
# epilogue's staging rows (two warpgroups x 64 rows x 144 bytes) and its
# vectors (deq, bias, inv_next: 12 bytes a channel).
SMEM_LIMIT = 232448 - 1024
ALIGN = 1024
STAGING_BYTES = 2 * 64 * 144
_SMS = 132  # an H100's; the launch passes the card's own count

# Kernel launches since the last reset (set to 0 to reset).
LAUNCHES = 0
# The plan of the last launch.
LAST_PLAN: Optional["Plan"] = None

_TAP_KIND = {None: 0, torch.float32: 1, torch.bfloat16: 2}


class ConvI8Out(NamedTuple):
    tap: Optional[torch.Tensor]
    q: Optional[torch.Tensor]
    acc: Optional[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Step:
    """One k-step: an A box of x at (c, ox0*s + dx, oy0*s + dy, b) and a B
    box of k (as (kh*kw*Ci, Co)) at (k, n0 + n), for the tile at (b, oy0,
    ox0, n0).  `group` is the phase group whose registers it adds to (phase
    mode), else 0."""

    c: int
    dx: int
    dy: int
    n: int
    k: int
    group: int = 0


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one launch covers its output.  A tile is a rows x cols rectangle
    of output pixels of one image (rows * cols = tile_m) by `bn` channels;
    tile t is (b, ty, tx, nt) with nt fastest, then tx, ty, b, and block i
    of `grid` takes tiles i, i + grid, ...  Each tile runs every stage in
    order: one A box and the B boxes of its `stage_steps` k-steps."""

    b: int
    h: int
    w: int
    ci: int
    co: int
    kh: int
    kw: int
    stride: int
    dilation: int
    padding: Padding
    phase_max: bool
    ho: int  # the output tensor: (b, ho, wo, co_out); pool1 in phase mode
    wo: int
    co_out: int
    rows: int
    cols: int
    tiles_y: int
    tiles_x: int
    n_tiles: int
    bn: int  # channels a tile (a phase group's in phase mode)
    nb: int  # rows of a B box
    slice: int  # bytes of K a step: 64 or 128 (the swizzle)
    steps: Tuple[Step, ...]
    stage_steps: Tuple[int, ...]  # k-steps of each stage, in order
    b_slots: int  # B boxes a stage holds at most
    ring: int
    grid: int
    smem_bytes: int

    @property
    def total_tiles(self) -> int:
        return self.b * self.tiles_y * self.tiles_x * self.n_tiles

    @property
    def tile_m(self) -> int:
        """Pixels a tile: 256 with N tiles of 128 (128 a consumer warpgroup, so
        that a loaded byte feeds as many products as with N = 256), else 128."""
        return 2 * TILE_M if not self.phase_max and self.bn == 128 else TILE_M

    @property
    def a_bytes(self) -> int:
        return self.tile_m * self.slice

    @property
    def b_bytes(self) -> int:
        return self.nb * self.slice

    @property
    def stage_bytes(self) -> int:
        return self.a_bytes + self.b_slots * self.b_bytes

    @property
    def stages_per_tile(self) -> int:
        return len(self.stage_steps)

    def stages(self) -> Iterator[Tuple[Step, ...]]:
        """The k-steps of each stage: one A box (the first step's
        coordinates; the others share it) and one B box a step."""
        first = 0
        for n in self.stage_steps:
            yield self.steps[first:first + n]
            first += n

    @property
    def box_a(self) -> Tuple[int, int, int, int]:
        """(channels, x, y, images) of an A box; x and y are counted in input
        elements, `stride` apart (the map's element strides)."""
        return (self.slice, self.cols * self.stride, self.rows * self.stride, 1)

    @property
    def box_b(self) -> Tuple[int, int]:
        return (self.slice, self.nb)

    def tile(self, t: int) -> Tuple[int, int, int, int]:
        """(b, oy0, ox0, n0) of tile t."""
        m, nt = divmod(t, self.n_tiles)
        m, tx = divmod(m, self.tiles_x)
        b, ty = divmod(m, self.tiles_y)
        return b, ty * self.rows, tx * self.cols, nt * self.bn

    def block_tiles(self, i: int) -> range:
        """The tiles block i walks, in its order."""
        return range(i, self.total_tiles, self.grid)

    def a_coords(self, t: int, step: Step) -> Tuple[int, int, int, int]:
        b, oy0, ox0, _ = self.tile(t)
        return (step.c, ox0 * self.stride + step.dx, oy0 * self.stride + step.dy, b)

    def b_coords(self, t: int, step: Step) -> Tuple[int, int]:
        return (step.k, self.tile(t)[3] + step.n)

    def launch_ints(self) -> List[int]:
        """The `cfg` array of conv_i8_launch, in its order."""
        return [self.b, self.h, self.w, self.ci, self.co, self.kh, self.kw, self.ho, self.wo,
                self.co_out, self.stride, self.rows, self.cols, self.tiles_y, self.tiles_x,
                self.n_tiles, self.bn, self.nb, self.slice, len(self.steps),
                self.b_slots, self.stages_per_tile, self.ring, self.grid,
                int(self.phase_max), self.smem_bytes]

    def step_ints(self) -> List[int]:
        return [v for s in self.steps for v in (s.c, s.dx, s.dy, s.n, s.k)]

    def describe(self) -> str:
        mode = "phase max" if self.phase_max else f"N tile {self.bn}"
        return (f"tile {self.rows}x{self.cols} px, {mode}, {self.tiles_y}x{self.tiles_x}x"
                f"{self.n_tiles} tiles an image, {self.total_tiles} tiles on {self.grid} "
                f"blocks, {len(self.steps)} k-steps of {self.slice} B in "
                f"{self.stages_per_tile} stages of {self.stage_bytes} B, ring {self.ring}, "
                f"{self.smem_bytes} B shared memory")


def tile_rect(ho: int, wo: int, stride: int = 1, tile_m: int = TILE_M) -> Tuple[int, int]:
    """(rows, cols) of the tile_m-pixel tile that pads (ho, wo) least; a tie
    takes the wider tile (longer rows of contiguous pixels)."""
    best = None
    for cols in TILE_COLS:
        rows = tile_m // cols
        if cols * stride > 256 or rows * stride > 256:
            continue
        area = -(-ho // rows) * rows * -(-wo // cols) * cols
        if best is None or area < best[0]:
            best = (area, rows, cols)
    return best[1], best[2]


# The phase-max schedule along one axis: the A box at offset d of input
# phase r feeds the output phases p with p - 1 <= 2 d + r <= p + 1 (the taps
# models/vgg.py::pack_conv_kernel_2x2_phase fills); the other two (d, r)
# feed none.  csrc/conv_i8.cu holds the same table (axis_phases).
_AXIS = ((-1, 1, (0,)), (0, 0, (0, 1)), (0, 1, (0, 1)), (1, 0, (1,)))


def _phase_steps() -> Tuple[List[Step], List[int]]:
    """The packed conv1_2' + phase max k-steps and the stages they form.
    Pool pixel (y, x) of group g = (py, px) sums the conv output at (y + py,
    x + px): input (y + py - 1 + ky, x + px - 1 + kx).  Stage (i, j) is one A
    box, at offset (dy, dx) of input phase gi = ry*2 + rx, and one k-step for
    each group it feeds, groups in order (its tap is ky = dy + 1 - py, kx = dx
    + 1 - px): 16 A boxes, 36 k-steps, the 9 nonzero (tap, phase) blocks of
    each group."""
    c = PHASE_CHANNELS
    steps, sizes = [], []
    for dy, ry, pys in _AXIS:
        for dx, rx, pxs in _AXIS:
            gi = ry * 2 + rx
            groups = [(py, px) for py in pys for px in pxs]
            for py, px in groups:
                ky, kx, g = dy + 1 - py, dx + 1 - px, py * 2 + px
                steps.append(Step(gi * c, dx, dy, g * c, (ky * 2 + kx) * 4 * c + gi * c, g))
            sizes.append(len(groups))
    return steps, sizes


def packed_zero_mask(device=None) -> torch.Tensor:
    """bool (256, 2, 2, 256), the (Co, kh, kw, Ci) layout: True where the
    packed conv1_2' kernel is zero by construction (7 of 16 (tap, input
    phase) blocks of each output group), i.e. outside every phase k-step."""
    c = PHASE_CHANNELS
    mask = torch.ones((4 * c, 2, 2, 4 * c), dtype=torch.bool, device=device)
    for st in _phase_steps()[0]:
        tap, ci0 = divmod(st.k, 4 * c)
        mask[st.n:st.n + c, tap // 2, tap % 2, ci0:ci0 + c] = False
    return mask


@functools.lru_cache(maxsize=256)
def plan(b: int, h: int, w: int, ci: int, co: int, kh: int, kw: int, stride: int = 1,
         dilation: int = 1, padding: Padding = (0, 0, 0, 0), phase_max: bool = False,
         sms: int = _SMS) -> Plan:
    """The launch of the kernel for x (b, h, w, ci) and k (co, kh, kw, ci).
    Raises ValueError on what the kernel does not take by shape."""
    pt, pb, pl, pr = padding
    if ci % 64 or co % 64:
        raise ValueError(f"the conv_i8 kernel needs Ci % 64 == 0 and Co % 64 == 0, got "
                         f"Ci={ci}, Co={co}")
    if stride < 1 or dilation < 1:
        raise ValueError(f"stride and dilation must be >= 1, got {stride}, {dilation}")
    ho = out_size(h, kh, stride, dilation, pt, pb)
    wo = out_size(w, kw, stride, dilation, pl, pr)
    if ho <= 0 or wo <= 0:
        raise ValueError(f"empty output {ho}x{wo}")
    if phase_max:
        if (kh, kw, stride, dilation, tuple(padding), ci, co) != (
                2, 2, 1, 1, (1, 1, 1, 1), 4 * PHASE_CHANNELS, 4 * PHASE_CHANNELS):
            raise ValueError(
                "phase_max takes the packed conv1_2' only: a 2x2 kernel, padding (1, 1, 1, 1), "
                f"stride 1, dilation 1, Ci = Co = {4 * PHASE_CHANNELS}; got {kh}x{kw}, padding "
                f"{padding}, stride {stride}, dilation {dilation}, Ci={ci}, Co={co}")
        ho, wo, co_out = h, w, PHASE_CHANNELS
        slice_, bn, n_tiles = PHASE_CHANNELS, PHASE_CHANNELS, 1
        steps, stage_steps = _phase_steps()
    else:
        co_out = co
        slice_ = 128 if ci % 128 == 0 else 64
        bn = 128 if co <= 128 else 256
        n_tiles = -(-co // bn)
        steps = [Step(c0, kx * dilation - pl, ky * dilation - pt, 0, (ky * kw + kx) * ci + c0)
                 for ky in range(kh) for kx in range(kw) for c0 in range(0, ci, slice_)]
        stage_steps = [1] * len(steps)
    if len(steps) > MAX_STEPS:
        raise ValueError(f"the conv_i8 kernel takes at most {MAX_STEPS} k-steps (kh * kw * "
                         f"Ci / {slice_}), got {len(steps)}")
    if any(not -32768 <= v <= 32767 for s in steps for v in (s.dx, s.dy)):
        raise ValueError(f"tap offsets out of the kernel's 16-bit range: padding {padding}, "
                         f"dilation {dilation}")
    tile_m = 2 * TILE_M if not phase_max and bn == 128 else TILE_M
    rows, cols = tile_rect(ho, wo, stride, tile_m)
    b_slots = max(stage_steps)
    stage_bytes = tile_m * slice_ + b_slots * bn * slice_
    fixed = ALIGN + STAGING_BYTES + 12 * co
    ring = min(MAX_RING, (SMEM_LIMIT - fixed) // stage_bytes)
    if ring < 1:
        raise ValueError(f"Co={co}: the epilogue's vectors leave no room for a stage")
    tiles_y, tiles_x = -(-ho // rows), -(-wo // cols)
    total = b * tiles_y * tiles_x * n_tiles
    if total >= 2**31:
        raise ValueError(f"{total} tiles: more than the kernel counts")
    return Plan(b, h, w, ci, co, kh, kw, stride, dilation, tuple(padding), phase_max, ho, wo,
                co_out, rows, cols, tiles_y, tiles_x, n_tiles, bn, bn, slice_, tuple(steps),
                tuple(stage_steps), b_slots, ring, max(1, min(total, sms)),
                fixed + ring * stage_bytes)


def tile_pixels(p: Plan, t: int) -> Iterator[Tuple[int, int, int, int]]:
    """(row of the tile's A box, b, oy, ox) of tile t's pixels inside the
    output; the kernel masks the others."""
    b, oy0, ox0, _ = p.tile(t)
    for r in range(p.tile_m):
        oy, ox = oy0 + r // p.cols, ox0 + r % p.cols
        if oy < p.ho and ox < p.wo:
            yield r, b, oy, ox


def build() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    ints = ctypes.POINTER(ctypes.c_int)
    lib.conv_i8_launch.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ints] * 3
        + [ctypes.c_void_p]
    )
    lib.conv_i8_launch.restype = ctypes.c_int
    return lib


def _check(x, k, deq, bias, inv_next, padding, tap_dtype, with_acc, phase_max) -> None:
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
    if phase_max and (inv_next is None or tap_dtype is not None or with_acc or co % 4):
        raise ValueError("phase_max writes the phase max of q only: it needs inv_next, no "
                         "tap_dtype, no with_acc and Co % 4 == 0")


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
    phase_max: bool = False,
) -> ConvI8Out:
    """CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(x, k, deq, bias, inv_next, padding, tap_dtype, with_acc, phase_max)
    if x.device.type == "cpu":
        if phase_max:  # the packed form's zero taps left out, as the kernel's plan does
            kernel_takes(x, k, stride, dilation, padding, True)
            k = k.masked_fill(packed_zero_mask(), 0)
        acc = conv_i8_plain(x, k, stride, dilation, padding)
        tap, q = conv_i8_epilogue_plain(acc, deq, bias, inv_next, tap_dtype)
        if phase_max:
            q = phase_max_i8(q, k.shape[0] // 4)
        return ConvI8Out(tap, q, acc if with_acc else None)
    return _launch(x, k, deq, bias, inv_next, stride, dilation, padding, tap_dtype, with_acc,
                   phase_max)


def packed_zeros_hold(k: torch.Tensor) -> bool:
    """Whether k is zero wherever the packed conv1_2' form is by
    construction (`packed_zero_mask`), so that phase_max, which leaves those
    k-steps out, computes the packed conv itself.  On the card this waits
    for the device: check once, where the kernel is made (QuantConv)."""
    if tuple(k.shape) != (4 * PHASE_CHANNELS, 2, 2, 4 * PHASE_CHANNELS):
        return False
    return not bool(k[packed_zero_mask(k.device)].any())


def kernel_takes(x: torch.Tensor, k: torch.Tensor, stride: int = 1, dilation: int = 1,
                 padding: Padding = (0, 0, 0, 0), phase_max: bool = False,
                 sms: int = _SMS) -> Plan:
    """The kernel's plan for these operands, or ValueError on what it does
    not take by shape (`plan`)."""
    b, h, w, ci = x.shape
    co, kh, kw, _ = k.shape
    return plan(b, h, w, ci, co, kh, kw, stride, dilation, tuple(padding), phase_max, sms)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=256)
def _launch_arrays(p: Plan):
    """The plan's three int arrays for conv_i8_launch, made once a plan."""
    return [(ctypes.c_int * len(v))(*v) for v in (p.launch_ints(), p.step_ints(), p.stage_steps)]


def _launch(x, k, deq, bias, inv_next, stride, dilation, padding, tap_dtype, with_acc,
            phase_max=False):
    global LAUNCHES, LAST_PLAN
    if x.device.type != "cuda":
        raise ValueError(f"the conv_i8 kernel takes CUDA tensors, got {x.device}")
    operands = [x, k, deq, bias] + ([inv_next] if inv_next is not None else [])
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("the conv_i8 kernel takes contiguous operands")
    if any(t.data_ptr() % 16 for t in operands):
        raise ValueError("the conv_i8 kernel takes 16-byte aligned operands")
    b, h, w, ci = x.shape
    co, kh, kw, _ = k.shape
    p = kernel_takes(x, k, stride, dilation, padding, phase_max, _sms(x.device))
    shape = (b, p.ho, p.wo, p.co_out)
    dev = x.device
    tap = None if tap_dtype is None else torch.empty(shape, dtype=tap_dtype, device=dev)
    q = None if inv_next is None else torch.empty(shape, dtype=torch.int8, device=dev)
    acc = torch.empty(shape, dtype=torch.int32, device=dev) if with_acc else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = build()
    arrays = _launch_arrays(p)
    with torch.cuda.device(dev):
        err = lib.conv_i8_launch(
            x.data_ptr(), k.data_ptr(), deq.data_ptr(), bias.data_ptr(), ptr(inv_next),
            ptr(tap), _TAP_KIND[tap_dtype], ptr(q), ptr(acc), *arrays, _cuda_build.stream_of(x),
        )
    _cuda_build.check(err, "conv_i8_launch")
    LAUNCHES += 1
    LAST_PLAN = p
    return ConvI8Out(tap, q, acc)
