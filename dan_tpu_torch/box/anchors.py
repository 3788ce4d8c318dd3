"""Anchor generation for the six detection scales (counterpart of
dan_tpu/box/anchors.py, which cannot be imported without JAX).

One square anchor of size 4*stride per feature-map position, centred at
(i + 0.5) * stride, concatenated over the layers in (H, W) row-major order:
the order in which models.heads flattens its outputs.

Box conventions: corner format (x1, y1, x2, y2) and centre format
(cx, cy, w, h), both in pixels of the network input.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from dan_tpu_torch.config import AnchorConfig


def layer_anchor_centers(
    feat_h: int, feat_w: int, stride: int, offset: float = 0.5
) -> np.ndarray:
    """(feat_h*feat_w, 2) array of (cx, cy) anchor centres, row-major."""
    ys = (np.arange(feat_h, dtype=np.float32) + offset) * stride
    xs = (np.arange(feat_w, dtype=np.float32) + offset) * stride
    cx, cy = np.meshgrid(xs, ys)
    return np.stack([cx.reshape(-1), cy.reshape(-1)], axis=-1)


@functools.lru_cache(maxsize=32)
def generate_anchors_np(
    config: AnchorConfig, image_h: int, image_w: int
) -> np.ndarray:
    """(A, 4) float32 centre-format anchors for an (image_h, image_w) input.

    Cached and read-only: every caller gets the same array."""
    per_layer = []
    for layer in config.layers:
        fh = -(-image_h // layer.stride)
        fw = -(-image_w // layer.stride)
        centers = layer_anchor_centers(fh, fw, layer.stride, layer.offset)
        wh = np.full_like(centers, layer.anchor_size)
        per_layer.append(np.concatenate([centers, wh], axis=-1))
    out = np.concatenate(per_layer, axis=0).astype(np.float32)
    out.setflags(write=False)
    return out


def generate_anchors(
    config: AnchorConfig, image_h: int, image_w: int, device="cpu"
) -> torch.Tensor:
    """The anchors as a float32 tensor on `device`."""
    return torch.from_numpy(generate_anchors_np(config, image_h, image_w).copy()).to(
        device
    )


def center_to_corner(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) (cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack(
        [cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], dim=-1
    )


def corner_to_center(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) (x1, y1, x2, y2) -> (cx, cy, w, h)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], dim=-1)
