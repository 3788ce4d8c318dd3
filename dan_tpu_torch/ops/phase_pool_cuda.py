"""Backward of the phase-packed pool1: the CUDA kernel (csrc/phase_pool.cu)
and its plain PyTorch version.

    gr = phase_pool_bwd(g (B, H, W, C), win (B, H, W, C) uint8)
       -> (B, H+1, W+1, 4C), g's dtype

Tensors are in the JAX package's NHWC layout and contiguous, which is the
memory layout of the port's channels-last activations.  gr[b, y, x, go*C +
c] receives g[b, y-py, x-px, c] where win there equals go = py*2 + px, and
0 elsewhere; a winner of 255 (relu clamped) routes nothing.  It is the
semantics of dan_tpu/models/vgg.py::_phase_pool_bwd_xla, bit for bit.

A CPU tensor goes through `phase_pool_bwd_plain`; a CUDA tensor launches the
kernel (built on first use by ops/_cuda_build.py) or raises.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dan_tpu_torch.ops import _cuda_build

SOURCE = "phase_pool"

# Kernel launches since the last reset (set to 0 to reset).
LAUNCHES = 0


def build() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    lib.phase_pool_bwd_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p
    ]
    lib.phase_pool_bwd_launch.restype = ctypes.c_int
    return lib


def _check(g: torch.Tensor, win: torch.Tensor) -> None:
    if g.dim() != 4 or win.shape != g.shape:
        raise ValueError(
            f"expected g and win of one (B, H, W, C) shape, got "
            f"{tuple(g.shape)} and {tuple(win.shape)}"
        )
    if win.dtype != torch.uint8:
        raise TypeError(f"win must be uint8, got {win.dtype}")
    if g.device != win.device:
        raise ValueError(f"g on {g.device}, win on {win.device}")


def phase_pool_bwd(g: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(g, win)
    if g.device.type == "cpu":
        return phase_pool_bwd_plain(g, win)
    return _launch(g, win)


def _launch(g: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    global LAUNCHES
    if g.device.type != "cuda":
        raise ValueError(f"the phase-pool kernel takes CUDA tensors, got {g.device}")
    if not (g.is_contiguous() and win.is_contiguous()):
        raise ValueError("the phase-pool kernel takes contiguous NHWC g and win")
    b, h, w, c = g.shape
    if c % 8 or g.element_size() not in (2, 4):
        raise ValueError(
            f"the phase-pool kernel needs C % 8 == 0 and 2- or 4-byte elements, "
            f"got C={c}, {g.dtype}"
        )
    lib = build()
    gr = torch.empty((b, h + 1, w + 1, 4 * c), dtype=g.dtype, device=g.device)
    with torch.cuda.device(g.device):
        err = lib.phase_pool_bwd_launch(
            g.data_ptr(), win.data_ptr(), gr.data_ptr(), b, h, w, c,
            g.element_size(), _cuda_build.stream_of(g),
        )
    _cuda_build.check(err, "phase_pool_bwd_launch")
    LAUNCHES += 1
    return gr


def phase_pool_bwd_plain(g: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """The plain version, written as the JAX package's XLA assembly:
    a masked copy of g per phase, padded to its offset, concatenated on
    the channel axis."""
    _check(g, win)
    groups = []
    for py in range(2):
        for px in range(2):
            contrib = torch.where(win == py * 2 + px, g, torch.zeros((), dtype=g.dtype,
                                                                    device=g.device))
            groups.append(F.pad(contrib, (0, 0, px, 1 - px, py, 1 - py)))
    return torch.cat(groups, dim=-1)
