"""The gradient of the LFPN's 2x bilinear upsample: the CUDA kernel
(csrc/upsample2x_bwd.cu) and its plain PyTorch version.

    gx = upsample2x_bwd(g (N, C, 2H, 2W) bf16 or float32) -> (N, C, H, W), g's dtype

gx is the transpose of models/layers.py::upsample2x (half-pixel centres,
edges clamped, as jax.image.resize's bilinear) applied to g: along H, then
along W, as sums of four products in float32, rounded once to g's dtype.
Every sum has one order, so the gradient is the same bits in every run; the
ATen backward it replaces on the card adds atomically.  The kernel computes
the plain version's sums in the plain version's order and agrees with it
bit for bit.

A tensor on the CPU goes through `upsample2x_bwd_plain` (float64 too); a
CUDA tensor launches the kernel (built on first use by ops/_cuda_build.py)
or raises: it takes a contiguous bf16 or float32 g of even height and
width whose storage starts on a pair of elements, and at most
`max_w` output columns (3,623 in bf16, 1,811 in float32: one
output row's four g rows must fit a stage of the kernel's shared-memory
ring).  `plan` cuts g into the kernel's work items; the CPU tests replay it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from dan_tpu_torch.ops import _cuda_build

SOURCE = "upsample2x_bwd"

# Kernel launches since the last reset (set to 0 to reset).
LAUNCHES = 0
# Bytes of g a stage of the kernel's ring holds by default: items of several
# whole planes where planes are small, bands of output rows where not.
STAGE_BYTES = 16 * 1024
# Stages of the kernel's ring (csrc/upsample2x_bwd.cu kStages).
STAGES = 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel cuts g (planes, 2h, 2w): `items` contiguous spans, each
    `per_item` whole planes (band == h) or `band` output rows of one plane
    with their halo rows, each at most `stage_bytes`; `group` outputs a
    consumer thread (8 // elem from one 16-byte load a g row, or 1)."""
    per_item: int
    band: int
    bands: int
    items: int
    stage_bytes: int
    group: int


@functools.lru_cache(maxsize=64)
def plan(planes: int, h: int, w: int, elem: int, aligned: bool = True,
         stage_bytes: int = STAGE_BYTES) -> Plan:
    """The kernel's work items for g (planes, 2h, 2w) of `elem`-byte
    elements; `aligned`: g starts on 16 bytes."""
    row = 2 * w * elem  # bytes of a g row
    cap = -(-max(stage_bytes, 4 * row) // 16) * 16  # one output row's 4 g rows fit
    plane = 2 * h * row
    if plane <= cap:
        per_item = min(planes, cap // plane)
        items = -(-planes // per_item)
        per_item, band, bands = -(-planes // items), h, 1  # evened out over the items
    else:
        band = (cap // row - 2) // 2  # a band of R rows reads 2R + 2 g rows
        bands = -(-h // band)
        per_item, band = 1, -(-h // bands)
    items = -(-planes // per_item) * bands
    group = 8 // elem if aligned and w % (8 // elem) == 0 else 1
    return Plan(per_item, band, bands, items, cap, group)


_lib = None


def build() -> ctypes.CDLL:
    """Compile csrc/upsample2x_bwd.cu (once per source hash) and load it."""
    global _lib
    if _lib is None:
        lib = _cuda_build.load(SOURCE)
        lib.upsample2x_bwd_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.upsample2x_bwd_launch.restype = ctypes.c_int
        lib.upsample2x_bwd_max_w.argtypes = [ctypes.c_int]
        lib.upsample2x_bwd_max_w.restype = ctypes.c_int
        lib.upsample2x_bwd_grid.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int]
        lib.upsample2x_bwd_grid.restype = ctypes.c_longlong
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def max_w(elem: int) -> int:
    """The widest output row the kernel takes for `elem`-byte elements."""
    return build().upsample2x_bwd_max_w(elem)


def grid(p: Plan, elem: int) -> int:
    """Blocks of the kernel's persistent grid for plan `p` on the current
    card (as many as fit its SMs, at most one an item)."""
    blocks = build().upsample2x_bwd_grid(p.items, elem, p.stage_bytes, p.group)
    if blocks < 0:
        _cuda_build.check(-blocks, "upsample2x_bwd_grid")
    return blocks


def _check(g: torch.Tensor) -> None:
    if g.dim() != 4 or g.shape[2] % 2 or g.shape[3] % 2 or 0 in g.shape:
        raise ValueError(f"expected g (N, C, 2H, 2W) with H, W >= 1, got {tuple(g.shape)}")
    if g.dtype not in (torch.float32, torch.bfloat16, torch.float64):
        raise TypeError(f"g must be float32, bfloat16 or float64, got {g.dtype}")


def upsample2x_bwd(g: torch.Tensor) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(g)
    if g.device.type == "cpu":
        return upsample2x_bwd_plain(g)
    return _launch(g)


def _launch(g: torch.Tensor, stage_bytes: int = STAGE_BYTES) -> torch.Tensor:
    global LAUNCHES
    if not g.is_contiguous():
        raise ValueError("the upsample backward kernel takes a contiguous NCHW g")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the upsample backward kernel takes float32 or bfloat16, got {g.dtype}")
    if g.device.type != "cuda":
        raise ValueError(f"the upsample backward kernel takes CUDA tensors, got {g.device}")
    # g must start on a pair of elements, as the wrapper has always asked;
    # a g off 16 bytes takes the kernel's one-output-a-thread path.
    if g.data_ptr() % (2 * g.element_size()):
        raise ValueError("the upsample backward kernel takes a g aligned to a pair of elements")
    n, c, h2, w2 = g.shape
    h, w, elem = h2 // 2, w2 // 2, g.element_size()
    if w > max_w(elem):
        raise ValueError(f"W={w} exceeds the kernel's limit ({max_w(elem)})")
    gx = torch.empty((n, c, h, w), dtype=g.dtype, device=g.device)
    p = plan(n * c, h, w, elem, g.data_ptr() % 16 == 0, stage_bytes)
    with torch.cuda.device(g.device):
        err = build().upsample2x_bwd_launch(g.data_ptr(), gx.data_ptr(), n * c, h, w, elem,
                                            p.per_item, p.band, p.stage_bytes, p.group,
                                            _cuda_build.stream_of(g))
    _cuda_build.check(err, "upsample2x_bwd_launch")
    LAUNCHES += 1
    return gx


def _adjoint(g: torch.Tensor, dim: int) -> torch.Tensor:
    """The transpose of the 2x half-pixel upsample along `dim` (2n -> n):
    out[2i] = x[i-1] / 4 + 3 x[i] / 4 and out[2i+1] = 3 x[i] / 4 + x[i+1] / 4,
    with x clamped at both ends, so with g padded by its edge values,
    gx[i] = ((gp[2i] / 4 + 3 gp[2i+1] / 4) + 3 gp[2i+2] / 4) + gp[2i+3] / 4."""
    n = g.shape[dim] // 2
    gp = torch.cat([g.narrow(dim, 0, 1), g, g.narrow(dim, 2 * n - 1, 1)], dim)
    pairs = gp.unflatten(dim, (n + 1, 2))  # (..., n + 1, 2, ...): gp[2j], gp[2j + 1]
    even, odd = pairs.select(dim + 1, 0), pairs.select(dim + 1, 1)
    return (0.25 * even.narrow(dim, 0, n) + 0.75 * odd.narrow(dim, 0, n)
            + 0.75 * even.narrow(dim, 1, n) + 0.25 * odd.narrow(dim, 1, n))


def upsample2x_bwd_plain(g: torch.Tensor) -> torch.Tensor:
    """The plain version, on any device: sums of slices along H, then W, in
    float32 (float64 stays float64), cast once to g's dtype."""
    wide = g if g.dtype in (torch.float32, torch.float64) else g.float()
    return _adjoint(_adjoint(wide, 2), 3).to(g.dtype)
