"""The device an entry point runs on: the first CUDA card unless the caller
names another device.  There is no silent fall-back to the CPU.  And the
arithmetic a float32 model runs in there (`float32_arithmetic`)."""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the first CUDA card and raises
    RuntimeError when there is none (pass device="cpu" to run on the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: dan_tpu_torch runs on the first CUDA card by "
            'default; pass device="cpu" (--device cpu) to run on the CPU'
        )
    return torch.device("cuda", 0)


@contextlib.contextmanager
def float32_arithmetic(on: bool = True, deterministic: bool = False) -> Iterator[None]:
    """While the block runs, when `on`: TF32 off for cuDNN's convolutions
    (PyTorch's default lets them use it, and TF32 is not the reference's
    float32) and for matmuls, and with `deterministic` cuDNN in its
    deterministic mode; the flags restored after it, whatever the caller
    had set."""
    if not on:
        yield
        return
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    cudnn.deterministic = deterministic or prev[2]
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic = prev
