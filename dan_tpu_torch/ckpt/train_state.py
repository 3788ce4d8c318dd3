"""Train-state checkpoints: model, momentum and step in one torch file per
step, `<model_dir>/step_<8 digits>.pt` (the port's counterpart of the JAX
package's orbax train-state checkpoints; orbax itself is not a dependency
of the port).

    path = save(model_dir, state.step, state)   # keeps the newest 5
    step = latest_step(model_dir)                 # None when there is none
    restore(model_dir, state)                     # in place, newest step

A save writes to a temporary file and renames it, so a crash never leaves
a partial checkpoint under a step name.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Optional

import torch

KEEP = 5
_NAME = re.compile(r"step_(\d+)\.pt")


def _path(model_dir: str, step: int) -> str:
    return os.path.join(model_dir, f"step_{step:08d}.pt")


def _steps(model_dir: str):
    if not os.path.isdir(model_dir):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(model_dir) if (m := _NAME.fullmatch(f)))


def latest_step(model_dir: str) -> Optional[int]:
    """The newest complete checkpoint's step, or None."""
    steps = _steps(model_dir)
    return steps[-1] if steps else None


def save(model_dir: str, step: int, state) -> str:
    """Write state (model, momentum, step) as step `step`, then delete all
    but the newest KEEP checkpoints."""
    os.makedirs(model_dir, exist_ok=True)
    payload = {
        "step": int(step),
        "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "momentum": {k: v.detach().cpu() for k, v in state.momentum.items()},
    }
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=model_dir)
    os.close(fd)
    try:
        torch.save(payload, tmp)
        os.replace(tmp, _path(model_dir, step))
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    for old in _steps(model_dir)[:-KEEP]:
        os.remove(_path(model_dir, old))
    return _path(model_dir, step)


def restore(model_dir: str, state, step: Optional[int] = None):
    """Load the newest (or the given) step into state, in place; returns
    state."""
    if step is None:
        step = latest_step(model_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {model_dir}")
    payload = torch.load(_path(model_dir, step), map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    with torch.no_grad():
        for name, buf in state.momentum.items():
            buf.copy_(payload["momentum"][name])
    state.step = int(payload["step"])
    return state
