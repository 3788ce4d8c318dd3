"""The single-card forward step of the default detector (counterpart of
__graft_entry__.py::entry; its sibling dryrun_multichip is
tools/dryrun_multichip.py).

    fn, args = entry()          # on the first CUDA card
    cls_logits, loc_preds = fn(*args)

entry() returns (fn, example_args): fn(model, images) is the inference
forward of the 640x640 detector ((B, 640, 640, 3) float32 normalized images
-> cls logits (B, 34125, 2), loc offsets (B, 34125, 4), float32), the model
a DANDetector with the JAX package's PRNGKey(0) weights on the device, and
the images one (1, 640, 640, 3) float32 zero image there.  No hand-written
kernel is on this path (the forward is cuDNN and PyTorch ops).  Without a
card it raises unless device="cpu" is given.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from dan_tpu_torch.api import Detector
from dan_tpu_torch.config import DANConfig, default_config
from dan_tpu_torch.device import resolve_device
from dan_tpu_torch.tools.bench import reference_params


def entry(config: Optional[DANConfig] = None, device=None, params: Optional[Mapping] = None):
    """-> (fn, (model, images)); `config` replaces the default config and
    `params` (a reference-layout tree) the PRNGKey(0) draw."""
    cfg = config or default_config()
    device = resolve_device(device)  # raises without a card before the draw
    det = Detector.from_jax_params(reference_params(cfg, params), cfg, device)

    @torch.inference_mode()
    def forward(model, images):
        return model(images)

    size = cfg.model.image_size
    images = torch.zeros((1, size, size, 3), dtype=torch.float32, device=device)
    return forward, (det.model, images)
