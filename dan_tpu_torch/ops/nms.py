"""Greedy NMS with fixed output shapes, and the tensor work around it.

Scores descend, ties go to the lower index, a box is suppressed at IoU
strictly greater than the threshold.  Sorting is always stable
(`torch.sort(stable=True)`): `torch.topk` promises no order for ties.

All boxes are corner format, float32.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from dan_tpu_torch.ops.nms_cuda import greedy_nms_rank_plain


class NMSResult(NamedTuple):
    boxes: torch.Tensor  # (..., max_out, 4)
    scores: torch.Tensor  # (..., max_out)
    indices: torch.Tensor  # (..., max_out) int32 into the input arrays, -1 if empty
    valid: torch.Tensor  # (..., max_out) bool


def greedy_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    score_threshold: float = 0.0,
) -> NMSResult:
    """Greedy NMS over (N, 4) boxes / (N,) scores -> fixed (max_out, ...).

    The plain version on any device (no kernel); the oracle of the
    kernel's tests."""
    rank = greedy_nms_rank_plain(
        boxes[None], scores[None], iou_threshold, max_out, score_threshold
    )
    res = rank_to_result(rank, boxes[None], scores[None], max_out)
    return NMSResult(*(t[0] for t in res))


def topk_select(
    boxes: torch.Tensor, scores: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pre-NMS top-k by score over (..., N, 4)/(..., N) -> (..., k, 4)/(..., k),
    by a stable sort (ties keep ascending original index)."""
    order = topk_order(scores, k)
    top_boxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    return top_boxes, torch.gather(scores, -1, order)


def topk_order(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (..., min(k, N)) of the pre-NMS top-k of (..., N) scores, by
    a stable sort: topk_select's order, for gathering other rows by it."""
    k = min(k, scores.shape[-1])
    return torch.sort(-scores, dim=-1, stable=True).indices[..., :k]


def rank_to_result(
    rank: torch.Tensor,
    boxes: torch.Tensor,
    scores: torch.Tensor,
    max_out: int,
) -> NMSResult:
    """Selection ranks (..., N) (-1 = dropped, r = r-th kept) -> ordered
    fixed-shape NMSResult (..., max_out, ...).  Unselected entries sort
    after all selected ones, stable by original index."""
    n = rank.shape[-1]
    key = torch.where(rank >= 0, rank, max_out)
    key_s, order = torch.sort(key, dim=-1, stable=True)
    k_top = min(max_out, n)
    key_s, order = key_s[..., :k_top], order[..., :k_top]
    valid = key_s < max_out
    out_boxes = torch.gather(
        boxes.float(), -2, order[..., None].expand(*order.shape, 4)
    )
    out_scores = torch.gather(scores.float(), -1, order)
    res = NMSResult(
        boxes=torch.where(valid[..., None], out_boxes, 0.0),
        scores=torch.where(valid, out_scores, 0.0),
        indices=torch.where(valid, order, -1).to(torch.int32),
        valid=valid,
    )
    if k_top < max_out:
        pad = max_out - k_top

        def _pad(t):
            shape = (*t.shape[: valid.dim() - 1], pad, *t.shape[valid.dim():])
            fill = -1 if t.dtype == torch.int32 else 0
            return torch.cat([t, t.new_full(shape, fill)], dim=valid.dim() - 1)

        res = NMSResult(*(_pad(t) for t in res))
    return res
