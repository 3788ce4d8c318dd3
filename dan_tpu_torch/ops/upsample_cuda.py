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
width whose storage starts on a pair of elements.
"""
from __future__ import annotations

import ctypes

import torch

from dan_tpu_torch.ops import _cuda_build

SOURCE = "upsample2x_bwd"

# Kernel launches since the last reset (set to 0 to reset).
LAUNCHES = 0


def build() -> ctypes.CDLL:
    """Compile csrc/upsample2x_bwd.cu (once per source hash) and load it."""
    lib = _cuda_build.load(SOURCE)
    lib.upsample2x_bwd_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.upsample2x_bwd_launch.restype = ctypes.c_int
    lib.upsample2x_bwd_max_w.argtypes = [ctypes.c_int]
    lib.upsample2x_bwd_max_w.restype = ctypes.c_int
    return lib


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


def _launch(g: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if not g.is_contiguous():
        raise ValueError("the upsample backward kernel takes a contiguous NCHW g")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the upsample backward kernel takes float32 or bfloat16, got {g.dtype}")
    if g.device.type != "cuda":
        raise ValueError(f"the upsample backward kernel takes CUDA tensors, got {g.device}")
    # Columns are loaded and stored in pairs: g must start on a pair.
    if g.data_ptr() % (2 * g.element_size()):
        raise ValueError("the upsample backward kernel takes a g aligned to a pair of elements")
    n, c, h2, w2 = g.shape
    lib = build()
    if w2 // 2 > lib.upsample2x_bwd_max_w(g.element_size()):
        raise ValueError(f"W={w2 // 2} exceeds the kernel's limit "
                         f"({lib.upsample2x_bwd_max_w(g.element_size())})")
    gx = torch.empty((n, c, h2 // 2, w2 // 2), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        err = lib.upsample2x_bwd_launch(g.data_ptr(), gx.data_ptr(), n * c, h2 // 2, w2 // 2,
                                        g.element_size(), _cuda_build.stream_of(g))
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
