"""Train-state checkpoints: model, momentum and step in one torch file per
step, `<model_dir>/step_<8 digits>.pt` (the port's counterpart of the JAX
package's orbax train-state checkpoints; orbax itself is not a dependency
of the port).

    path = save(model_dir, state.step, state)   # keeps the newest 5
    step = latest_step(model_dir)                 # None when there is none
    restore(model_dir, state)                     # in place, newest step
    weights = load_model_weights(path)            # a step file or a model_dir

A save writes to a temporary file and renames it, so a crash never leaves
a partial checkpoint under a step name.  Under data parallelism rank 0
writes and every rank waits for it (`save(..., mesh=mesh)`); every rank
restores the same file to its own device.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Optional

import torch

from dan_tpu_torch.parallel.mesh import barrier

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


def state_payload(state, step: Optional[int] = None) -> dict:
    """A copy of the state's model, momentum and step in CPU tensors: what
    a checkpoint holds."""
    return {
        "step": int(state.step if step is None else step),
        "model": {k: v.detach().to("cpu", copy=True) for k, v in state.model.state_dict().items()},
        "momentum": {k: v.to("cpu", copy=True) for k, v in state.momentum.items()},
    }


def load_payload(state, payload: dict):
    """Copy a state_payload into state, in place, on state's device;
    returns state."""
    state.model.load_state_dict(payload["model"])
    with torch.no_grad():
        for name, buf in state.momentum.items():
            buf.copy_(payload["momentum"][name])
    state.step = int(payload["step"])
    return state


def save(model_dir: str, step: int, state, mesh=None) -> str:
    """Write state (model, momentum, step) as step `step`, then delete all
    but the newest KEEP checkpoints.  With a mesh (dan_tpu_torch.parallel)
    only rank 0 writes, and every rank returns once the file is there."""
    if mesh is not None:
        if mesh.rank == 0:
            save(model_dir, step, state)
        barrier(mesh)
        return _path(model_dir, step)
    os.makedirs(model_dir, exist_ok=True)
    payload = state_payload(state, step)
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
    return load_payload(state, payload)


def load_model_weights(path: str):
    """The model's state dict from a checkpoint: `path` is one step file
    (`.../step_00000100.pt`) or a model_dir, whose newest step is read."""
    if os.path.isdir(path):
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
        path = _path(path, step)
    return torch.load(path, map_location="cpu", weights_only=True)["model"]
