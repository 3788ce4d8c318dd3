"""Detection post-processing: softmax + decode -> score and degenerate-box
filter -> stable top-k -> greedy NMS -> detection dict with a fixed
max_detections rows and a validity mask.

The NMS stage is ops.nms_cuda.greedy_nms_rank: the CUDA kernel for CUDA
tensors, its plain version for CPU tensors.  postprocess_one is the batched
path at a batch of one, so both give the same rows.
"""
from __future__ import annotations

from typing import Dict

import torch

from dan_tpu.config import AnchorConfig, PostprocessConfig
from dan_tpu_torch.box.decode import decode_boxes
from dan_tpu_torch.ops.nms import rank_to_result, topk_select
from dan_tpu_torch.ops.nms_cuda import greedy_nms_rank


def filter_and_topk(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    post_config: PostprocessConfig,
):
    """Zero the scores of sub-threshold and degenerate (after clipping)
    boxes, then take the pre-NMS top-k.  Zero-area boxes have IoU 0 with
    everything and would all survive greedy NMS."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    keep = (scores >= post_config.score_threshold) & (w > 1.0) & (h > 1.0)
    scores = torch.where(keep, scores, 0.0)
    return topk_select(boxes, scores, post_config.pre_nms_topk)


def postprocess_batch(
    cls_logits: torch.Tensor,
    loc_preds: torch.Tensor,
    anchors_center: torch.Tensor,
    anchor_config: AnchorConfig,
    post_config: PostprocessConfig,
    image_h: float,
    image_w: float,
) -> Dict[str, torch.Tensor]:
    """(B, A, 2) logits + (B, A, 4) offsets -> {'bboxes': (B, MAX_DET, 4),
    'scores': (B, MAX_DET), 'valid': (B, MAX_DET)}, corner boxes in pixels
    of the network input."""
    scores = torch.softmax(cls_logits, dim=-1)[..., 1]
    boxes = decode_boxes(
        loc_preds, anchors_center, anchor_config.prior_scaling, image_h, image_w
    )
    boxes_k, scores_k = filter_and_topk(boxes, scores, post_config)
    rank = greedy_nms_rank(
        boxes_k,
        scores_k,
        post_config.nms_iou_threshold,
        post_config.max_detections,
        score_threshold=0.0,
    )
    res = rank_to_result(rank, boxes_k, scores_k, post_config.max_detections)
    return {"bboxes": res.boxes, "scores": res.scores, "valid": res.valid}


def postprocess_one(
    cls_logits: torch.Tensor,
    loc_preds: torch.Tensor,
    anchors_center: torch.Tensor,
    anchor_config: AnchorConfig,
    post_config: PostprocessConfig,
    image_h: float,
    image_w: float,
) -> Dict[str, torch.Tensor]:
    """Single image: (A, 2) logits + (A, 4) offsets -> detection dict with
    (MAX_DET, ...) leaves."""
    det = postprocess_batch(
        cls_logits[None], loc_preds[None], anchors_center,
        anchor_config, post_config, image_h, image_w,
    )
    return {k: v[0] for k, v in det.items()}
