"""Synthetic WIDER-FACE-shaped data for tests and benchmarks.

Generates images with bright rectangular 'faces' on dark noise so that a
few train steps measurably reduce loss, plus correctly-shaped host batches
matching dan_tpu_torch.data.pipeline's output contract (the port's copy of
dan_tpu/data/synthetic.py).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from dan_tpu_torch.config import DANConfig


def synthetic_sample(
    rng: np.random.Generator, canvas: int, max_gt: int, n_faces: int | None = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One uint8 canvas + (max_gt, 4) corner boxes + (max_gt,) mask."""
    # Low-res noise upsampled 4x: 16x cheaper than full-res RNG.
    coarse = rng.integers(0, 60, (canvas // 4 + 1, canvas // 4 + 1, 3), dtype=np.uint8)
    img = np.repeat(np.repeat(coarse, 4, axis=0), 4, axis=1)[:canvas, :canvas]
    img = np.ascontiguousarray(img)
    if n_faces is None:
        n_faces = int(rng.integers(1, 6))
    n_faces = min(n_faces, max_gt)
    boxes = np.zeros((max_gt, 4), np.float32)
    mask = np.zeros((max_gt,), bool)
    for i in range(n_faces):
        size = float(rng.uniform(24, canvas // 4))
        x0 = float(rng.uniform(0, canvas - size))
        y0 = float(rng.uniform(0, canvas - size))
        img[int(y0) : int(y0 + size), int(x0) : int(x0 + size)] = rng.integers(
            180, 255, 3, dtype=np.uint8
        )
        boxes[i] = [x0, y0, x0 + size, y0 + size]
        mask[i] = True
    return img, boxes, mask


def synthetic_batch(
    config: DANConfig, batch_size: int, seed: int = 0
) -> Dict[str, np.ndarray]:
    """A host batch in the train-pipeline contract (see data/pipeline.py)."""
    rng = np.random.default_rng(seed)
    canvas = config.preprocess.canvas_size
    size = config.preprocess.train_image_size
    max_gt = config.match.max_gt
    out = {
        "canvas": np.zeros((batch_size, canvas, canvas, 3), np.uint8),
        "crop_x0": np.zeros((batch_size,), np.float32),
        "crop_y0": np.zeros((batch_size,), np.float32),
        "crop_size": np.zeros((batch_size,), np.float32),
        "boxes": np.zeros((batch_size, max_gt, 4), np.float32),
        "mask": np.zeros((batch_size, max_gt), bool),
        "seed": np.zeros((batch_size,), np.uint32),
    }
    for b in range(batch_size):
        img, boxes, mask = synthetic_sample(rng, canvas, max_gt)
        out["canvas"][b] = img
        out["boxes"][b] = boxes
        out["mask"][b] = mask
        # Identity-ish crop: a size-`canvas` window (the whole canvas
        # downsampled to `size`) keeps every synthetic face visible.
        out["crop_x0"][b] = 0.0
        out["crop_y0"][b] = 0.0
        out["crop_size"][b] = float(canvas)
        out["seed"][b] = rng.integers(0, 2**31)
    return out
