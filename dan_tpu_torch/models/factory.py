"""The model a configuration names: DANDetector for a DANConfig,
RetinaFace for a RetinaFaceConfig.  Detector and the bench path build
their model here."""
from __future__ import annotations

import torch
from torch import nn

from dan_tpu_torch.config import RetinaFaceConfig
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.models.retinaface import RetinaFace


def build_model(config, generator: torch.Generator | None = None) -> nn.Module:
    """The detector of `config` (its whole tree: DANConfig or
    RetinaFaceConfig) with its own random init from `generator`."""
    if isinstance(config, RetinaFaceConfig):
        return RetinaFace(config.model, generator)
    return DANDetector(config.model, generator)
