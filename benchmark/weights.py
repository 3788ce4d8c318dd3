"""The detector's weights, made on the device from the seed: one float32
normal draw of a torch.Generator on the card for all kernels, split and
scaled He-normal by fan-in (sqrt(2 / (kh * kw * Ci))), zero biases, the
L2Norm scales at their stated initial values.  The same seed gives the
same weights, which both the program and the reference take.

    params = make_weights(spec, seed, device)   # {state_dict name: tensor}
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator of `device` for one use of the seed: weights, inputs and
    draws each take their own stream number, so none shifts another."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (2**63))
    return g


def make_weights(spec: List[Tuple[str, Tuple[int, ...], object]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    kernels = [(n, s) for n, s, kind in spec if kind == "he"]
    total = sum(math.prod(s) for _, s in kernels)
    flat = torch.randn(total, generator=generator(seed, device, 1), device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        if kind == "he":
            n = math.prod(shape)
            std = math.sqrt(2.0 / math.prod(shape[1:]))
            out[name] = flat[at:at + n].view(shape).mul_(std)
            at += n
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.full(shape, float(kind), device=device)
    return out
