"""WIDER-FACE-shaped inputs from a seed: train batches (a frozen copy of
the port's synthetic recipe: bright square faces on dark upsampled noise, 1
to 5 an image, each canvas whole as its crop window) and their augmentation
draws, so that a change to the program cannot change the traffic."""
from __future__ import annotations

from typing import Dict

import numpy as np


def sample(rng: np.random.Generator, canvas: int, max_gt: int):
    """One uint8 canvas, its (max_gt, 4) corner boxes and (max_gt,) mask."""
    coarse = rng.integers(0, 60, (canvas // 4 + 1, canvas // 4 + 1, 3), dtype=np.uint8)
    img = np.ascontiguousarray(np.repeat(np.repeat(coarse, 4, axis=0), 4, axis=1)[:canvas, :canvas])
    n_faces = min(int(rng.integers(1, 6)), max_gt)
    boxes = np.zeros((max_gt, 4), np.float32)
    mask = np.zeros((max_gt,), bool)
    for i in range(n_faces):
        size = float(rng.uniform(24, canvas // 4))
        x0 = float(rng.uniform(0, canvas - size))
        y0 = float(rng.uniform(0, canvas - size))
        img[int(y0):int(y0 + size), int(x0):int(x0 + size)] = rng.integers(180, 255, 3, dtype=np.uint8)
        boxes[i] = [x0, y0, x0 + size, y0 + size]
        mask[i] = True
    return img, boxes, mask


def batch(dan: Dict, batch_size: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """A host batch: canvas, crop_x0, crop_y0, crop_size, boxes, mask."""
    canvas = dan["preprocess"]["canvas_size"]
    max_gt = dan["match"]["max_gt"]
    out = {"canvas": np.zeros((batch_size, canvas, canvas, 3), np.uint8),
           "crop_x0": np.zeros((batch_size,), np.float32),
           "crop_y0": np.zeros((batch_size,), np.float32),
           "crop_size": np.full((batch_size,), float(canvas), np.float32),
           "boxes": np.zeros((batch_size, max_gt, 4), np.float32),
           "mask": np.zeros((batch_size, max_gt), bool)}
    for b in range(batch_size):
        out["canvas"][b], out["boxes"][b], out["mask"][b] = sample(rng, canvas, max_gt)
    return out


def draws(pre: Dict, batch_size: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """The seven augmentation draws of a batch: brightness delta,
    saturation factor, hue delta, contrast factor, colour on, ordering (0:
    the fixed one), flip."""
    u = lambda lo, hi: rng.uniform(lo, hi, batch_size).astype(np.float32)  # noqa: E731
    bd, hd = pre["brightness_max_delta"], pre["hue_max_delta"]
    return {"delta_b": u(-bd, bd), "f_sat": u(*pre["saturation_range"]),
            "delta_h": u(-hd, hd), "f_con": u(*pre["contrast_range"]),
            "on": rng.random(batch_size) < pre["color_distort_prob"],
            "order": np.zeros(batch_size, np.int64),
            "flip": rng.random(batch_size) < pre["flip_prob"]}

