"""Detection post-processing: softmax + decode -> score and degenerate-box
filter -> stable top-k -> greedy NMS -> detection dict with a fixed
max_detections rows and a validity mask.

The NMS stage is ops.nms_cuda.greedy_nms_rank: the CUDA kernel for CUDA
tensors, its plain version for CPU tensors.  postprocess_one is the batched
path at a batch of one, so both give the same rows.

A model with landmark outputs (RetinaFace) passes them as `landm_preds`:
they are decoded, carried through the top-k and the NMS gather as a payload
of the boxes, and come out as 'landmarks' (B, MAX_DET, 2K), zero in the
empty slots.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from dan_tpu_torch.config import AnchorConfig, PostprocessConfig
from dan_tpu_torch.box.decode import decode_boxes, decode_landmarks
from dan_tpu_torch.ops.nms import rank_to_result, topk_order, topk_select
from dan_tpu_torch.ops.nms_cuda import greedy_nms_rank
from dan_tpu_torch.utils.profiling import span


def filter_and_topk(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    post_config: PostprocessConfig,
):
    """Zero the scores of sub-threshold and degenerate (after clipping)
    boxes, then take the pre-NMS top-k.  Zero-area boxes have IoU 0 with
    everything and would all survive greedy NMS."""
    return topk_select(boxes, filter_scores(boxes, scores, post_config), post_config.pre_nms_topk)


def filter_scores(boxes: torch.Tensor, scores: torch.Tensor, post_config: PostprocessConfig):
    """The scores with those of sub-threshold and degenerate boxes zeroed."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    keep = (scores >= post_config.score_threshold) & (w > 1.0) & (h > 1.0)
    return torch.where(keep, scores, 0.0)


def _gather_rows(rows: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """rows (B, N, D) gathered along N by index (B, K) -> (B, K, D)."""
    return torch.gather(rows, -2, index[..., None].expand(*index.shape, rows.shape[-1]))


def postprocess_batch(
    cls_logits: torch.Tensor,
    loc_preds: torch.Tensor,
    anchors_center: torch.Tensor,
    anchor_config: AnchorConfig,
    post_config: PostprocessConfig,
    image_h: float,
    image_w: float,
    landm_preds: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """(B, A, 2) logits + (B, A, 4) offsets -> {'bboxes': (B, MAX_DET, 4),
    'scores': (B, MAX_DET), 'valid': (B, MAX_DET)}, corner boxes in pixels
    of the network input; with (B, A, 2K) `landm_preds` also 'landmarks'
    (B, MAX_DET, 2K), (x, y) pairs in the same pixels."""
    with span("dan.detect.select"):
        scores = torch.softmax(cls_logits, dim=-1)[..., 1]
        boxes = decode_boxes(
            loc_preds, anchors_center, anchor_config.prior_scaling, image_h, image_w
        )
        scores = filter_scores(boxes, scores, post_config)
        order = topk_order(scores, post_config.pre_nms_topk)
        boxes_k, scores_k = _gather_rows(boxes, order), torch.gather(scores, -1, order)
        if landm_preds is not None:
            landm = decode_landmarks(landm_preds, anchors_center, anchor_config.prior_scaling)
            landm_k = _gather_rows(landm, order)
    with span("dan.detect.nms"):
        rank = greedy_nms_rank(
            boxes_k,
            scores_k,
            post_config.nms_iou_threshold,
            post_config.max_detections,
            score_threshold=0.0,
        )
        res = rank_to_result(rank, boxes_k, scores_k, post_config.max_detections)
        det = {"bboxes": res.boxes, "scores": res.scores, "valid": res.valid}
        if landm_preds is not None:
            picked = _gather_rows(landm_k, res.indices.clamp_min(0).long())
            det["landmarks"] = torch.where(res.valid[..., None], picked, 0.0)
    return det


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
