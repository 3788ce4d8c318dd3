"""The device an entry point runs on: the first CUDA card unless the caller
names another device.  There is no silent fall-back to the CPU."""
from __future__ import annotations

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
