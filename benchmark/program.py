"""The benchmark's one door into the program under test, dan_tpu_torch:
its configuration built from a configuration file's "dan" section, and
its detector on the device with the benchmark's seeded weights.  The
drivers call the program's entry points through this module and the
modules it returns; the reference never does."""
from __future__ import annotations

from typing import Dict

import torch

from dan_tpu_torch import config as pc
from dan_tpu_torch.models.detector import DANDetector


def _tup(v):
    return tuple(_tup(x) for x in v) if isinstance(v, (list, tuple)) else v


def dan_config(dan: Dict) -> pc.DANConfig:
    """The program's DANConfig holding exactly the file's settings."""
    parts = {}
    for name, cls in pc._NESTED.items():
        sub = {k: _tup(v) for k, v in dan[name].items()}
        if cls is pc.AnchorConfig:
            sub["layers"] = tuple(pc.AnchorLayerConfig(**layer) for layer in dan[name]["layers"])
        parts[name] = cls(**sub)
    return pc.DANConfig(**parts)


def detector(cfg: pc.DANConfig, weights: Dict[str, torch.Tensor], device) -> DANDetector:
    """The program's detector on `device` holding `weights` (its own init is
    drawn on the device and then replaced)."""
    with torch.device(device):
        model = DANDetector(cfg.model, torch.Generator(device=device).manual_seed(0))
    model.load_state_dict(weights, strict=True)
    return model
