"""Detection loss: softmax cross-entropy with hard-negative mining, plus
smooth-L1 on the positives (counterpart of dan_tpu/train/loss.py).

Per image, the negatives are ranked by their CE loss and the hnm_ratio x
#positives hardest are kept (hnm_min_negatives when an image has no
positive); ties go to the lower anchor index.  The total is cls + alpha *
loc, both normalised by the batch's positive count: under data
parallelism the GLOBAL batch's, which the caller passes as `total_pos`, so
that the ranks' losses (and gradients) sum to the one-device step's.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from dan_tpu_torch.config import TrainConfig


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber, delta 1)."""
    ax = x.abs()
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def _select_topk_desc(values: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Mask of the k[b] largest elements of each row of values (B, A), ties
    to the lower index: the `rank < k` set of a stable descending argsort,
    from one value sort and a cumsum tie-break.  Rows with k = 0 select
    nothing."""
    a = values.shape[1]
    sv = torch.sort(values, dim=1, descending=True).values
    idx = torch.clamp(k - 1, 0, a - 1)
    t = torch.gather(sv, 1, idx[:, None])  # (B, 1) the k-th largest
    above = values > t
    n_above = above.sum(dim=1, keepdim=True)
    tie = values == t
    tie_rank = torch.cumsum(tie.long(), dim=1) - tie.long()  # exclusive
    sel = above | (tie & (tie_rank < k[:, None] - n_above))
    return sel & (k[:, None] > 0)


def class_ce(cls_logits: torch.Tensor, cls_targets: torch.Tensor) -> torch.Tensor:
    """(B, A) softmax cross-entropy of each anchor against its label
    (ignored anchors against background; the loss masks them out)."""
    labels = cls_targets.clamp_min(0)
    log_probs = F.log_softmax(cls_logits, dim=-1)
    return -torch.where(labels == 1, log_probs[..., 1], log_probs[..., 0])


def hard_negatives(ce: torch.Tensor, cls_targets: torch.Tensor, config: TrainConfig) -> torch.Tensor:
    """(B, A) mask of the negatives each image keeps: its hnm_ratio x
    #positives hardest by `ce` (hnm_min_negatives when it has none), ties
    to the lower anchor index."""
    negative = cls_targets == 0
    num_pos = (cls_targets == 1).sum(dim=1)  # (B,)
    # 3:1 negatives per positive; the floor only for images with none.
    wanted = torch.where(
        num_pos > 0,
        (config.hnm_ratio * num_pos).long(),
        config.hnm_min_negatives,
    )
    num_neg_keep = torch.minimum(wanted, negative.sum(dim=1))
    neg_ce = torch.where(negative, ce.detach(), -torch.inf)
    return negative & _select_topk_desc(neg_ce, num_neg_keep)


def detection_loss(
    cls_logits: torch.Tensor,
    loc_preds: torch.Tensor,
    cls_targets: torch.Tensor,
    loc_targets: torch.Tensor,
    config: TrainConfig,
    total_pos: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """cls_logits (B, A, 2) f32, loc_preds (B, A, 4) f32, cls_targets (B, A)
    in {-1 ignore, 0 bg, 1 face}, loc_targets (B, A, 4) -> (total loss,
    metrics {loss, cls_loss, loc_loss, num_pos, num_neg_selected}), all
    0-d float32 tensors on the logits' device.

    total_pos: the positives of the global batch (a 0-d tensor) when these
    rows are one rank's share; None: these rows' own.  The losses are
    divided by max(total_pos, 1) and `num_pos` reports total_pos; the other
    metrics are these rows' shares, which sum over the ranks."""
    positive = cls_targets == 1
    ce = class_ce(cls_logits, cls_targets)
    neg_selected = hard_negatives(ce, cls_targets, config)

    pos = positive.sum().float() if total_pos is None else total_pos.float()
    norm = pos.clamp_min(1.0)
    cls_loss = torch.where(positive | neg_selected, ce, 0.0).sum() / norm

    loc_l1 = smooth_l1(loc_preds - loc_targets).sum(dim=-1)
    loc_loss = torch.where(positive, loc_l1, 0.0).sum() / norm

    total = cls_loss + config.loc_loss_weight * loc_loss
    metrics = {
        "loss": total.detach(),
        "cls_loss": cls_loss.detach(),
        "loc_loss": loc_loss.detach(),
        "num_pos": pos,
        "num_neg_selected": neg_selected.sum().float(),
    }
    return total, metrics
