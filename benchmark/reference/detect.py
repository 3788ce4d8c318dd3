"""The plain reference of the detect tail: anchors, softmax, SSD decode
clipped to the image, the score and degenerate-box filter, the pre-NMS
top-k by a stable sort, greedy NMS and the fixed-size detection rows.

    det = postprocess(cls, loc, dan, h, w)   # {'bboxes', 'scores', 'valid'}

Greedy NMS: scores descend, ties go to the lower index, a box is suppressed
at IoU strictly above the threshold, at most max_detections kept.  The
operation order of every float step is the detector's published one
(decode: t * s * anchor + centre; IoU: (area + areas) - inter), so on the
same logits and the same device the rows come out bit for bit.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def anchors(dan: Dict, h: int, w: int, device) -> torch.Tensor:
    """(A, 4) float32 centre-format anchors, layers in order, each row-major."""
    out = []
    for layer in dan["anchors"]["layers"]:
        s, off = layer["stride"], layer["offset"]
        fh, fw = -(-h // s), -(-w // s)
        ys = (np.arange(fh, dtype=np.float32) + off) * s
        xs = (np.arange(fw, dtype=np.float32) + off) * s
        cx, cy = np.meshgrid(xs, ys)
        c = np.stack([cx.reshape(-1), cy.reshape(-1)], -1)
        out.append(np.concatenate([c, np.full_like(c, layer["anchor_size"])], -1))
    return torch.from_numpy(np.concatenate(out, 0).astype(np.float32)).to(device)


def decode(loc: torch.Tensor, anc: torch.Tensor, prior, h: float, w: float) -> torch.Tensor:
    s = torch.tensor(prior, dtype=loc.dtype, device=loc.device)
    acx, acy, aw, ah = anc.unbind(-1)
    tx, ty, tw, th = loc.unbind(-1)
    cx = tx * s[0] * aw + acx
    cy = ty * s[1] * ah + acy
    bw = torch.exp(torch.clamp(tw * s[2], max=10.0)) * aw
    bh = torch.exp(torch.clamp(th * s[3], max=10.0)) * ah
    x1, y1, x2, y2 = cx - bw * 0.5, cy - bh * 0.5, cx + bw * 0.5, cy + bh * 0.5
    w_hi = torch.as_tensor(w, dtype=loc.dtype, device=loc.device)
    h_hi = torch.as_tensor(h, dtype=loc.dtype, device=loc.device)
    return torch.stack([torch.minimum(x1.clamp_min(0.0), w_hi), torch.minimum(y1.clamp_min(0.0), h_hi),
                        torch.minimum(x2.clamp_min(0.0), w_hi), torch.minimum(y2.clamp_min(0.0), h_hi)],
                       dim=-1)


def area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]).clamp_min(0.0) * (b[..., 3] - b[..., 1]).clamp_min(0.0)


def iou_one_to_many(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of one box a row (B, 4) against its row's boxes (B, N, 4)."""
    box = box[..., None, :]
    ix1 = torch.maximum(box[..., 0], boxes[..., 0])
    iy1 = torch.maximum(box[..., 1], boxes[..., 1])
    ix2 = torch.minimum(box[..., 2], boxes[..., 2])
    iy2 = torch.minimum(box[..., 3], boxes[..., 3])
    inter = (ix2 - ix1).clamp_min(0.0) * (iy2 - iy1).clamp_min(0.0)
    union = area(box) + area(boxes) - inter
    return torch.where(union > 0.0, inter / union, 0.0)


def nms_rank(boxes: torch.Tensor, scores: torch.Tensor, thr: float, max_out: int) -> torch.Tensor:
    """(B, N) int32: the k-th kept box of a row gets k, the others -1."""
    bsz, n = scores.shape
    dev = boxes.device
    thr_t = torch.tensor(thr, dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(-float("inf"), dtype=torch.float32, device=dev)
    active = scores > 0.0
    rank = torch.full((bsz, n), -1, dtype=torch.int32, device=dev)
    col, rows = torch.arange(n, device=dev), torch.arange(bsz, device=dev)
    for i in range(max_out):
        if i % 16 == 0 and not bool(active.any()):
            break
        masked = torch.where(active, scores, neg_inf)
        best = masked.max(dim=1, keepdim=True).values
        live = best > neg_inf
        j = torch.where(masked == best, col, n).min(dim=1).values
        sel = (col == j[:, None]) & live
        gone = (iou_one_to_many(boxes[rows, j], boxes) > thr_t) | sel
        rank = torch.where(sel, i, rank)
        active = active & ~(live & gone)
    return rank


def postprocess(cls: torch.Tensor, loc: torch.Tensor, dan: Dict, h: int, w: int,
                clip=None) -> Dict:
    """(B, A, 2) logits, (B, A, 4) offsets of an (h, w) input -> fixed rows
    of detections, boxes clipped to (h, w) or to clip = (clip_h, clip_w),
    two (B, 1) tensors."""
    post = dan["postprocess"]
    scores = torch.softmax(cls, dim=-1)[..., 1]
    clip_h, clip_w = clip if clip is not None else (float(h), float(w))
    boxes = decode(loc, anchors(dan, h, w, cls.device), dan["anchors"]["prior_scaling"],
                   clip_h, clip_w)
    bw, bh = boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1]
    keep = (scores >= post["score_threshold"]) & (bw > 1.0) & (bh > 1.0)
    scores = torch.where(keep, scores, 0.0)
    k = min(post["pre_nms_topk"], scores.shape[-1])
    order = torch.sort(-scores, dim=-1, stable=True).indices[..., :k]
    boxes = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    scores = torch.gather(scores, -1, order)
    max_out = post["max_detections"]
    rank = nms_rank(boxes, scores, post["nms_iou_threshold"], max_out)
    key = torch.where(rank >= 0, rank, max_out)
    key_s, pick = torch.sort(key, dim=-1, stable=True)
    n = min(max_out, k)
    key_s, pick = key_s[..., :n], pick[..., :n]
    valid = key_s < max_out
    out_b = torch.gather(boxes, -2, pick[..., None].expand(*pick.shape, 4))
    out_s = torch.gather(scores, -1, pick)
    det = {"bboxes": torch.where(valid[..., None], out_b, 0.0),
           "scores": torch.where(valid, out_s, 0.0), "valid": valid}
    if n < max_out:
        pad = max_out - n
        det = {k2: torch.cat([v, v.new_zeros((v.shape[0], pad, *v.shape[2:]))], 1)
               for k2, v in det.items()}
    return det, (boxes, scores)


def mismatched_rows(got: Dict, want: Dict) -> int:
    """Detection slots of `got` that differ from `want`: a valid flag, a
    score or a box coordinate (rows compared where either is valid)."""
    v_g, v_w = got["valid"].bool(), want["valid"].bool()
    either = v_g | v_w
    bad = (v_g != v_w)
    bad |= either & (got["scores"].float() != want["scores"].float())
    bad |= either & (got["bboxes"].float() != want["bboxes"].float()).any(-1)
    return int(bad.sum())
