"""Bbox-vote fusion of TTA detections: the plain PyTorch version
(counterpart of dan_tpu/ops/bbox_vote.py) and the oracle of the CUDA kernel
in ops/bbox_vote_cuda.py.

Contract: a detection is active when it is valid and its score is > 0.
Repeatedly take the active detection of highest score (lowest index on
ties); every active detection whose IoU with it is >= the threshold merges
with it (the selected one always does) into one output whose box is the
score-weighted mean of the merged boxes and whose score is the selected
score; merged detections are deactivated.  Stop after max_out outputs or
when nothing is active.  Fixed shapes: the outputs have max_out slots, the
unused ones zero with valid False.

All boxes are corner format, float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dan_tpu_torch.box.iou import iou_one_to_many


class VoteResult(NamedTuple):
    boxes: torch.Tensor  # (..., max_out, 4)
    scores: torch.Tensor  # (..., max_out)
    valid: torch.Tensor  # (..., max_out) bool


def check_vote_inputs(boxes, scores, in_valid) -> None:
    """Raise unless boxes (B, N, 4) f32, scores (B, N) f32 and in_valid
    (B, N) bool lie on one device."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.dim() != 2:
        raise ValueError(
            f"expected boxes (B, N, 4) and scores (B, N), got "
            f"{tuple(boxes.shape)} and {tuple(scores.shape)}"
        )
    if boxes.shape[:2] != scores.shape or in_valid.shape != scores.shape:
        raise ValueError(
            f"boxes {tuple(boxes.shape)}, scores {tuple(scores.shape)} and "
            f"valid {tuple(in_valid.shape)} do not agree"
        )
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"expected float32, got {boxes.dtype} and {scores.dtype}")
    if in_valid.dtype != torch.bool:
        raise TypeError(f"expected a bool valid mask, got {in_valid.dtype}")
    if not (boxes.device == scores.device == in_valid.device):
        raise ValueError(
            f"boxes on {boxes.device}, scores on {scores.device}, "
            f"valid on {in_valid.device}"
        )


def bbox_vote_batched(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    in_valid: torch.Tensor,
    iou_threshold: float,
    max_out: int,
) -> VoteResult:
    """(B, N, 4) boxes, (B, N) scores, (B, N) bool validity -> VoteResult
    with (B, max_out, ...) leaves.  All rows in lockstep as (B, N) tensor
    ops on any device; a row that is exhausted writes nothing more."""
    check_vote_inputs(boxes, scores, in_valid)
    bsz, n = scores.shape
    dev = boxes.device
    out_boxes = torch.zeros((bsz, max_out, 4), dtype=torch.float32, device=dev)
    out_scores = torch.zeros((bsz, max_out), dtype=torch.float32, device=dev)
    out_valid = torch.zeros((bsz, max_out), dtype=torch.bool, device=dev)
    if bsz == 0 or n == 0:
        return VoteResult(out_boxes, out_scores, out_valid)
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(-float("inf"), dtype=torch.float32, device=dev)
    tiny = torch.tensor(1e-12, dtype=torch.float32, device=dev)
    active = in_valid & (scores > 0.0)
    col = torch.arange(n, device=dev)
    rows = torch.arange(bsz, device=dev)
    for i in range(max_out):
        if i % 16 == 0 and not bool(active.any()):
            break
        masked = torch.where(active, scores, neg_inf)
        best = masked.max(dim=1).values
        valid = best > neg_inf  # (B,)
        # Per-row argmax, lowest index on ties.
        j = torch.where(masked == best[:, None], col, n).min(dim=1).values
        j = torch.where(valid, j, 0)
        iou = iou_one_to_many(boxes[rows, j], boxes)
        merge = active & ((iou >= thr) | (col == j[:, None]))
        w = torch.where(merge, scores, 0.0)
        wsum = torch.maximum(w.sum(dim=1), tiny)
        fused = (boxes * w[..., None]).sum(dim=1) / wsum[:, None]
        out_boxes[:, i] = torch.where(valid[:, None], fused, 0.0)
        out_scores[:, i] = torch.where(valid, best, 0.0)
        out_valid[:, i] = valid
        active = active & ~merge
    return VoteResult(out_boxes, out_scores, out_valid)


def bbox_vote(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    in_valid: torch.Tensor,
    iou_threshold: float,
    max_out: int,
) -> VoteResult:
    """One image: (N, 4) boxes, (N,) scores, (N,) bool validity ->
    VoteResult with (max_out, ...) leaves."""
    res = bbox_vote_batched(
        boxes[None], scores[None], in_valid[None], iou_threshold, max_out
    )
    return VoteResult(*(t[0] for t in res))
