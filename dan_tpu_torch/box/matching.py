"""Anchor -> ground-truth matching and target encoding (counterpart of
dan_tpu/box/matching.py).

  * IoU of anchors x gts; an anchor matches the gt of its highest IoU when
    that IoU >= match_threshold (S3FD: 0.35);
  * force-match: every valid gt claims its single best anchor;
  * scale compensation: a gt matched by fewer than k anchors also takes
    its top-k anchors with IoU > scale_comp_iou;
  * matched boxes encode as (dcx/w_a/s0, dcy/h_a/s1, log(w/w_a)/s2,
    log(h/h_a)/s3) with prior scaling s.

`match_anchors` is the plain PyTorch version and the oracle of the CUDA
matcher (ops/matching_cuda.py); `match_anchors_batch` sends CUDA tensors to
the kernel and CPU tensors to the plain version.  Ties go to the lowest
index everywhere: torch.argmax returns the first maximum, and the top-k is
a stable descending sort, which is lax.top_k's order (torch.topk promises
no order among ties).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from dan_tpu.config import AnchorConfig, MatchConfig
from dan_tpu_torch.box.anchors import center_to_corner, corner_to_center
from dan_tpu_torch.box.iou import pairwise_iou


class MatchTargets(NamedTuple):
    """Per-anchor training targets, with the gts' leading batch dims.

    cls_target (..., A) int32: 1 face, 0 background, -1 ignore.
    loc_target (..., A, 4) float32: encoded offsets, zero off the positives.
    matched_gt (..., A) int32: the matched gt (meaningful on positives).
    matched_iou (..., A) float32: the raw best IoU (before augmentation).
    """

    cls_target: torch.Tensor
    loc_target: torch.Tensor
    matched_gt: torch.Tensor
    matched_iou: torch.Tensor


def encode_boxes(
    gt_center: torch.Tensor, anchors_center: torch.Tensor, prior_scaling
) -> torch.Tensor:
    """SSD box encoding of (..., 4) centre-format boxes against anchors."""
    s = torch.tensor(prior_scaling, dtype=torch.float32, device=gt_center.device)
    acx, acy, aw, ah = anchors_center.unbind(-1)
    gcx, gcy, gw, gh = gt_center.unbind(-1)
    # Padded (zero-size) gts are never positives, but must encode finitely.
    gw = gw.clamp_min(1e-6)
    gh = gh.clamp_min(1e-6)
    tx = (gcx - acx) / aw / s[0]
    ty = (gcy - acy) / ah / s[1]
    tw = torch.log(gw / aw) / s[2]
    th = torch.log(gh / ah) / s[3]
    return torch.stack([tx, ty, tw, th], dim=-1)


def finish_targets(
    anchors_center: torch.Tensor,
    raw_best_iou: torch.Tensor,
    matched_aug: torch.Tensor,
    matched_gt: torch.Tensor,
    matched_center: torch.Tensor,
    match_config: MatchConfig,
    anchor_config: AnchorConfig,
) -> MatchTargets:
    """cls/loc targets from the per-anchor match: positive where the
    augmented best reaches the threshold, ignore in the raw-IoU band."""
    positive = matched_aug >= match_config.match_threshold
    ignore = (
        (raw_best_iou >= match_config.ignore_threshold)
        & (raw_best_iou < match_config.match_threshold)
        & ~positive
    )
    cls_target = torch.where(positive, 1, torch.where(ignore, -1, 0)).to(torch.int32)
    loc_target = encode_boxes(matched_center, anchors_center, anchor_config.prior_scaling)
    loc_target = torch.where(positive[..., None], loc_target, 0.0)
    return MatchTargets(
        cls_target=cls_target,
        loc_target=loc_target,
        matched_gt=matched_gt.to(torch.int32),
        matched_iou=raw_best_iou,
    )


def match_anchors(
    anchors_center: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    match_config: MatchConfig,
    anchor_config: AnchorConfig,
) -> MatchTargets:
    """The plain version, for one image or a batch.

    anchors_center (A, 4) centre format; gt_boxes (..., G, 4) corner format,
    zero-padded; gt_mask (..., G) bool.  It materialises (..., A, G)."""
    num_anchors = anchors_center.shape[0]
    valid = gt_mask.to(torch.float32)
    iou = pairwise_iou(center_to_corner(anchors_center), gt_boxes) * valid[..., None, :]

    raw_best_iou = iou.max(dim=-1).values  # (..., A)
    # Forced matches: each valid gt claims its best anchor.
    best_anchor_per_gt = iou.argmax(dim=-2)  # (..., G)
    a_idx = torch.arange(num_anchors, device=iou.device)
    forced = (a_idx[:, None] == best_anchor_per_gt[..., None, :]).to(torch.float32)
    aug = iou + 2.0 * (forced * valid[..., None, :])

    if match_config.enable_scale_comp:
        k = min(match_config.scale_comp_topk, num_anchors)
        anchor_best_gt = iou.argmax(dim=-1)  # (..., A)
        anchor_pos = raw_best_iou >= match_config.match_threshold
        per_gt_count = torch.zeros(
            gt_mask.shape, dtype=torch.float32, device=iou.device
        ).scatter_add_(-1, anchor_best_gt, anchor_pos.to(torch.float32))
        needs_comp = (per_gt_count < k) & gt_mask
        iou_t = iou.transpose(-1, -2)  # (..., G, A)
        topk_iou, topk_idx = torch.sort(iou_t, dim=-1, descending=True, stable=True)
        topk_iou, topk_idx = topk_iou[..., :k], topk_idx[..., :k]
        eligible = (topk_iou > match_config.scale_comp_iou) & needs_comp[..., None]
        comp = torch.zeros_like(iou_t).scatter_add_(
            -1, topk_idx, eligible.to(torch.float32)
        )
        aug = aug + comp.clamp_max(1.0).transpose(-1, -2)

    matched_aug = aug.max(dim=-1).values
    matched_gt = aug.argmax(dim=-1)
    gt_center = corner_to_center(gt_boxes)  # (..., G, 4)
    matched_center = torch.gather(
        gt_center, -2, matched_gt[..., None].expand(*matched_gt.shape, 4)
    )
    return finish_targets(
        anchors_center, raw_best_iou, matched_aug, matched_gt, matched_center,
        match_config, anchor_config,
    )


def match_anchors_batch(
    anchors_center: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    match_config: MatchConfig,
    anchor_config: AnchorConfig,
) -> MatchTargets:
    """(B, G, 4) gts -> (B, A) targets: the CUDA matcher for CUDA tensors,
    the plain version for CPU tensors."""
    if gt_boxes.device.type == "cpu":
        return match_anchors(anchors_center, gt_boxes, gt_mask, match_config, anchor_config)
    from dan_tpu_torch.ops.matching_cuda import match_anchors_cuda

    return match_anchors_cuda(anchors_center, gt_boxes, gt_mask, match_config, anchor_config)
