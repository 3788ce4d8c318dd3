"""Host-side augmentation parameter sampling (scalar logic only).

Data-anchor-sampling (SURVEY.md §2 'Train preprocessing' [B][K —
PyramidBox]): pick a random face, pick a random anchor scale at-or-below
(+1) the face's nearest anchor scale, and resample the image so the face
lands at that scale, then crop a train-size window containing it.

The reference does the whole thing in tf.image/py_func on host; here the
host only samples the SCALAR crop window (x0, y0, size in source pixels) —
branchy, data-dependent logic that is cheap — and the expensive
resample/distort/normalize math runs on device
(dan_tpu_torch.ops.preprocess.train_preprocess).  The port's copy of
dan_tpu/data/augment.py.

A crop window of side `train_image_size / resize_factor` at the source
resolution, resampled to (train_image_size)^2 on device, is mathematically
identical to the reference's resize-whole-image-then-crop formulation.

All constants are [K]/[?] and config-isolated (PreprocessConfig).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from dan_tpu_torch.config import PreprocessConfig


def sample_data_anchor_crop(
    rng: np.random.Generator,
    boxes: np.ndarray,
    image_h: int,
    image_w: int,
    cfg: PreprocessConfig,
) -> Tuple[float, float, float]:
    """Sample (x0, y0, size) of a square crop window in source pixels.

    boxes: (n, 4) valid corner boxes (may be empty -> plain random window).
    """
    size_out = float(cfg.train_image_size)
    if len(boxes) == 0:
        # No faces: random window at a random scale covering the image.
        # The window may exceed the SHORT side of a non-square image; the
        # offset range then inverts, so sort the bounds (any offset keeping
        # >=90% of the short side inside the window is equally fine).
        side = float(max(image_h, image_w))
        crop = rng.uniform(0.5, 1.0) * side
        x0 = rng.uniform(*sorted((-0.1 * crop, image_w - 0.9 * crop)))
        y0 = rng.uniform(*sorted((-0.1 * crop, image_h - 0.9 * crop)))
        return float(x0), float(y0), float(crop)

    # 1. Random face and its scale.
    i = int(rng.integers(len(boxes)))
    bx1, by1, bx2, by2 = boxes[i]
    face_w, face_h = bx2 - bx1, by2 - by1
    face_scale = float(np.sqrt(max(face_w * face_h, 1.0)))

    # 2. Nearest anchor index; target uniformly from {0..min(i+1, last)}
    #    (reproduces PyramidBox's shrink-biased sampling [K]).
    sizes = np.asarray(cfg.das_anchor_sizes, np.float64)
    anchor_idx = int(np.argmin(np.abs(sizes - face_scale)))
    target_idx = int(rng.integers(0, min(anchor_idx + 1, len(sizes) - 1) + 1))
    jitter = rng.uniform(*cfg.das_max_scale_jitter)
    target_scale = float(sizes[target_idx]) * jitter

    # 3. Source-resolution crop side such that the face, resampled into the
    #    (size_out)^2 output, has scale `target_scale`.
    resize_factor = target_scale / face_scale
    crop = size_out / resize_factor
    # Cap the minification so the crop window is never absurdly larger than
    # the image (tiny target scales on small images).
    crop = float(min(crop, 4.0 * max(image_h, image_w)))

    # 4. Window position: uniform, keeping the chosen face's center strictly
    #    inside the window with a 10% margin [?].
    cx = (bx1 + bx2) * 0.5
    cy = (by1 + by2) * 0.5
    x0 = cx - rng.uniform(0.1, 0.9) * crop
    y0 = cy - rng.uniform(0.1, 0.9) * crop
    return float(x0), float(y0), float(crop)
