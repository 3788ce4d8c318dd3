"""SGD with momentum, weight decay on conv kernels only, a piecewise
constant LR with a warm-up ramp, and global-norm clipping (counterpart of
dan_tpu/train/optim.py, whose optax chain it reproduces step for step).

Per step, with g the gradients and step the count of earlier updates:
  1. norm = sqrt(sum of g^2 over all tensors); if norm >= clip (clip > 0),
     g = g / norm * clip                      (optax.clip_by_global_norm);
  2. g = g + weight_decay * p for conv kernels (optax.add_decayed_weights);
  3. m = g + momentum * m                     (optax.trace);
  4. p = p - lr(step) * m                     (optax.scale_by_learning_rate).
torch.nn.utils.clip_grad_norm_ scales by clip / (norm + 1e-6) instead, so
it is not used.  Parameters and momentum buffers are updated in place.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from dan_tpu_torch.config import TrainConfig


def learning_rate(config: TrainConfig, step: int) -> float:
    """The LR of the update made at `step` (the count of earlier updates),
    in float32 as optax computes it: the piecewise constant schedule on
    absolute boundaries, times 0.1 + 0.9 * min(step / warmup, 1)."""
    f32 = np.float32
    scales = {
        int(b): config.lr_factors[i + 1] / config.lr_factors[i]
        for i, b in enumerate(config.lr_boundaries)
    }
    v = f32(config.learning_rate)
    for boundary, scale in sorted(scales.items()):
        indicator = f32(max(0.0, np.sign(boundary - step)))
        v = f32(v * indicator + (f32(1.0) - indicator) * f32(scale) * v)
    if config.warmup_steps > 0:
        frac = min(f32(step) / f32(config.warmup_steps), f32(1.0))
        v = f32(v * (f32(0.1) + f32(0.9) * frac))
    return float(v)


def is_decayed(name: str) -> bool:
    """Weight decay applies to conv kernels ('weight'), not to biases or
    L2Norm scales."""
    return name.endswith(".weight")


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (float32 tensors).
    Each tensor is summed in its contiguous layout: autograd may hand the
    same gradient to two data-parallel ranks in different layouts, and a
    norm summed in another order would clip the replicas apart."""
    norms = torch.stack(torch._foreach_norm([g.contiguous() for g in grads]))
    return torch.sqrt(torch.sum(norms * norms))


@torch.no_grad()
def sgd_update(
    named_params: Dict[str, torch.Tensor],
    grads: Dict[str, torch.Tensor],
    momentum: Dict[str, torch.Tensor],
    step: int,
    config: TrainConfig,
) -> torch.Tensor:
    """One optimizer step in place.  Returns the gradient norm before the
    clip (a 0-d tensor; nothing is synchronised with the device)."""
    names = list(named_params)
    g = [grads[n] for n in names]
    norm = global_norm(g)
    if config.grad_clip_norm > 0:
        # (g / norm) * clip where norm >= clip, g itself (divided by 1 and
        # multiplied by 1, which is exact) where it is below.
        below = norm < config.grad_clip_norm
        div = torch.where(below, torch.ones_like(norm), norm)
        mul = torch.where(below, torch.ones_like(norm), torch.full_like(norm, config.grad_clip_norm))
        g = [(x / div) * mul for x in g]
    params = [named_params[n] for n in names]
    dec = [i for i, n in enumerate(names) if is_decayed(n)]
    decayed = torch._foreach_add(
        [g[i] for i in dec], [params[i] for i in dec], alpha=config.weight_decay
    )
    for i, x in zip(dec, decayed):
        g[i] = x
    bufs = [momentum[n] for n in names]
    torch._foreach_mul_(bufs, config.momentum)
    torch._foreach_add_(bufs, g)
    # optax scales by the float32 -lr, then adds.
    torch._foreach_add_(params, torch._foreach_mul(bufs, -learning_rate(config, step)))
    return norm
