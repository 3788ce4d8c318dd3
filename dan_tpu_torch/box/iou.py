"""Jaccard overlap (IoU) of corner-format boxes (x1, y1, x2, y2)."""
from __future__ import annotations

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) corner boxes -> (...,) areas; degenerate boxes -> 0."""
    w = (boxes[..., 2] - boxes[..., 0]).clamp_min(0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp_min(0.0)
    return w * h


def iou_one_to_many(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of (..., 4) corner boxes, one per row, against the (..., N, 4)
    boxes of the same row -> (..., N).  The operation order is the TPU NMS
    kernel's, (area + areas) - inter, which the CUDA kernel repeats."""
    box = box[..., None, :]
    ix1 = torch.maximum(box[..., 0], boxes[..., 0])
    iy1 = torch.maximum(box[..., 1], boxes[..., 1])
    ix2 = torch.minimum(box[..., 2], boxes[..., 2])
    iy2 = torch.minimum(box[..., 3], boxes[..., 3])
    inter = (ix2 - ix1).clamp_min(0.0) * (iy2 - iy1).clamp_min(0.0)
    union = box_area(box) + box_area(boxes) - inter
    return torch.where(union > 0.0, inter / union, 0.0)


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """IoU of (..., A, 4) against (..., G, 4) corner boxes -> (..., A, G),
    in the JAX package's operation order (areas first, a + b - inter, then
    inter / union where union > 0), which the matcher kernel repeats.
    Degenerate or padded (zero-area) boxes give 0 against everything."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    ix1 = torch.maximum(a[..., 0], b[..., 0])
    iy1 = torch.maximum(a[..., 1], b[..., 1])
    ix2 = torch.minimum(a[..., 2], b[..., 2])
    iy2 = torch.minimum(a[..., 3], b[..., 3])
    inter = (ix2 - ix1).clamp_min(0.0) * (iy2 - iy1).clamp_min(0.0)
    union = box_area(boxes_a)[..., :, None] + box_area(boxes_b)[..., None, :] - inter
    return torch.where(union > 0.0, inter / union, 0.0)
