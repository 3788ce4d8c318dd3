"""One loader for every checkpoint format the port reads:

    state_dict = load_params(path, config)   # on the CPU; .to(device) once

  * a TF1 checkpoint prefix (`<prefix>.index` exists, or the name ends in
    `.ckpt` or holds `.ckpt-`): the slim-style importer of
    ckpt/tf_import.py, reading the V2 bundle without TensorFlow;
  * `<file>.npz`: a parameter tree in the JAX package's layout, one array
    per `"<group>/<layer>/<leaf>"` key (save_npz / load_npz; orbax
    checkpoints become one with scripts/export_params_npz.py, run where JAX
    is);
  * `<file>.pt`: a step file of `python -m dan_tpu_torch.train` or a file
    of `python -m dan_tpu_torch.ckpt.convert` (both hold {"model":
    state_dict});
  * a directory of `step_<8 digits>.pt` files (a train model_dir): its
    newest step.

An orbax directory (one holding `params/` or `step_<digits>/`) is refused
with the export command: the card host has no orbax.  Every format but a
non-strict TF import (a warm start, whose uncovered leaves get the JAX
package's PRNGKey(0) init) is checked against `DANDetector(config.model)`: another
architecture's checkpoint fails here, listing the missing, extra and
mismatched names, instead of deep inside the first forward.
"""
from __future__ import annotations

import functools
import os
import re
from typing import Dict, Mapping

import numpy as np
import torch

from dan_tpu_torch.ckpt.bridge import params_from_jax
from dan_tpu_torch.ckpt.train_state import latest_step, load_model_weights
from dan_tpu_torch.config import DANConfig, ModelConfig

def looks_like_tf_ckpt(path: str) -> bool:
    """The JAX package's test for a TF1 checkpoint prefix (dan_tpu/api.py)."""
    return (
        os.path.exists(path + ".index")
        or path.endswith(".ckpt")
        or ".ckpt-" in os.path.basename(path)
    )


def is_orbax_dir(path: str) -> bool:
    """A directory written by the JAX package's orbax_io: save_params's
    `params/`, or a train model_dir's `step_<digits>/` saves (or one of
    those step directories itself, which holds orbax's metadata file)."""
    if not os.path.isdir(path):
        return False
    names = os.listdir(path)
    return (os.path.isdir(os.path.join(path, "params"))
            or any(re.fullmatch(r"step_\d+", n) and os.path.isdir(os.path.join(path, n))
                   for n in names)
            or "_CHECKPOINT_METADATA" in names)


def save_npz(tree: Mapping, path: str) -> None:
    """A parameter tree (JAX layout) -> an .npz of "<group>/<layer>/<leaf>"
    arrays."""
    flat = {f"{g}/{layer}/{leaf}": np.asarray(v)
            for g, layers in tree.items() for layer, leaves in layers.items()
            for leaf, v in leaves.items()}
    np.savez(path, **flat)


def load_npz(path: str) -> Dict:
    """save_npz's file -> the parameter tree."""
    tree: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            parts = key.split("/")
            if len(parts) != 3:
                raise ValueError(f"{path}: key {key!r} is not <group>/<layer>/<leaf>")
            g, layer, leaf = parts
            tree.setdefault(g, {}).setdefault(layer, {})[leaf] = z[key]
    return tree


@functools.lru_cache(maxsize=8)
def _model_shapes(model_config: ModelConfig) -> Dict[str, tuple]:
    from dan_tpu_torch.models.detector import DANDetector

    return {k: tuple(v.shape) for k, v in DANDetector(model_config).state_dict().items()}


def check_config(state: Mapping[str, torch.Tensor], config: DANConfig, path: str) -> None:
    """Raise ValueError unless `state` has exactly the names and shapes of
    DANDetector(config.model)'s state_dict."""
    want = _model_shapes(config.model)
    got = {k: tuple(v.shape) for k, v in state.items()}
    if got == want:
        return
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    diff = {k: (got[k], want[k]) for k in sorted(set(want) & set(got)) if got[k] != want[k]}
    raise ValueError(
        f"checkpoint at {path} does not match the config's detector: "
        f"{len(missing)} missing {missing[:8]}, {len(extra)} extra {extra[:8]}, "
        f"{len(diff)} shape mismatches (checkpoint, model) {dict(list(diff.items())[:8])}")


def _from_jax_tree(tree: Mapping, path: str) -> Dict[str, torch.Tensor]:
    groups = {"backbone", "lfpn", "heads", "l2norm"}
    if set(tree) != groups:
        raise ValueError(f"checkpoint at {path} holds groups {sorted(tree)}, not the "
                         f"detector's {sorted(groups)}")
    return params_from_jax(tree)


def load_params(path: str, config: DANConfig, strict: bool = False,
                verbose: bool = True) -> Dict[str, torch.Tensor]:
    """The detector's state_dict (CPU float32 tensors) from a checkpoint of
    any format above.  `strict` and `verbose` are the TF importer's: with
    strict=False a TF checkpoint may cover only part of the detector."""
    path = os.fspath(path)
    if looks_like_tf_ckpt(path):
        from dan_tpu_torch.ckpt.tf_import import load_tf_checkpoint

        state = params_from_jax(load_tf_checkpoint(path, config.model, strict, verbose))
        if strict:
            check_config(state, config, path)
        return state
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint at {path}")
    if path.endswith(".npz"):
        state = _from_jax_tree(load_npz(path), path)
    elif os.path.isdir(path) and latest_step(path) is not None:
        state = load_model_weights(path)
    elif is_orbax_dir(path):
        raise ValueError(
            f"{path} is an orbax checkpoint of the JAX package, which the port does not read; "
            f"export its parameters to an .npz first: python scripts/export_params_npz.py "
            f"--ckpt {path} --out params.npz (in the repo, where JAX and orbax are installed)")
    elif path.endswith(".pt"):
        state = load_model_weights(path)
    elif os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoints under {path}")
    else:
        raise ValueError(f"{path}: not a TF checkpoint prefix, .npz, .pt or checkpoint "
                         "directory")
    check_config(state, config, path)
    return state
