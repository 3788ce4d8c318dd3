"""The controls: the reference put in the program's place and computed in
the precision below the one a configuration states, which must come out
not correct.  The step below is looked up by the configuration's
`precision`, so a cell of a new precision needs an entry here, not a
driver's edit.

    fp8(t), tf32(t)            # roundings, back in t's dtype
    rounding(precision)        # the rounding for a float configuration's control
    Control(weights, dan, precision, calib, block)   # the forward control

    bfloat16 -> float8 e4m3 (one scale a tensor)
    float32  -> TF32 (the program runs float32 with TF32 off)
    int8     -> int4 (qmax 7) in the reference's int8 body
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from benchmark.reference import model as ref
from benchmark.reference import quant as ref_quant

FP8_MAX = 448.0  # the largest finite float8 e4m3fn
TF32_DROPPED = 13  # float32's 23 mantissa bits less TF32's 10


def _straight_through(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return t + (q.to(t.dtype) - t).detach()


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 under a per-tensor scale, in t's dtype."""
    scale = (t.detach().abs().amax().float() / FP8_MAX).clamp_min(1e-30)
    q = (t.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return _straight_through(t, q)


def tf32(t: torch.Tensor) -> torch.Tensor:
    """t rounded to TF32 (10 mantissa bits, to nearest, ties to even), in
    t's dtype."""
    i = t.detach().float().contiguous().view(torch.int32)
    half = (1 << (TF32_DROPPED - 1)) - 1
    i = (i + half + ((i >> TF32_DROPPED) & 1)) & ~((1 << TF32_DROPPED) - 1)
    return _straight_through(t, i.view(torch.float32))


ROUNDING = {"bfloat16": fp8, "float32": tf32}
INT_QMAX = {"int8": 7}  # an integer body's control: its qmax


def rounding(precision: str) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """The rounding of a float precision's control; None for an integer one."""
    if precision in INT_QMAX:
        return None
    if precision not in ROUNDING:
        raise KeyError(f"no control for precision {precision!r}; add it to reference/lowp.py")
    return ROUNDING[precision]


class Control(torch.nn.Module):
    """The reference forward in the precision below `precision`, in the
    program's place: normalized (B, H, W, 3) -> (cls, loc), a block of
    images at a time.  An integer body calibrates its own scales on
    `calib` (normalized images)."""

    def __init__(self, weights, dan, precision: str, calib, block: int):
        super().__init__()
        self.weights, self.dan, self.block = weights, dan, block
        self.quant = rounding(precision)
        self.qmax = INT_QMAX.get(precision)
        self.scales = (ref_quant.calibrate(weights, dan, calib, qmax=self.qmax)
                       if self.qmax is not None else None)

    @torch.no_grad()
    def forward(self, x):
        outs = []
        with ref.float32_exact():
            for i in range(0, x.shape[0], self.block):
                xb = x[i:i + self.block].float()
                if self.scales is None:
                    outs.append(ref.forward(self.weights, self.dan, xb, quant=self.quant))
                else:
                    outs.append(ref_quant.forward(self.weights, self.dan, xb, self.scales,
                                                  qmax=self.qmax))
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
