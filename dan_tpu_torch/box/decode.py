"""Box decoding: the inverse of the SSD encoding, clipped to the image."""
from __future__ import annotations

import torch

from dan_tpu_torch.box.anchors import center_to_corner


def decode_boxes(
    loc_pred: torch.Tensor,
    anchors_center: torch.Tensor,
    prior_scaling,
    image_h: float | None = None,
    image_w: float | None = None,
) -> torch.Tensor:
    """Decode (..., A, 4) predicted offsets against (A, 4) centre anchors.

    Returns corner-format boxes, clipped to [0, w] x [0, h] when the image
    size is given: two floats, or two tensors that broadcast against
    (..., A) (one size per batch row: shape (B, 1))."""
    s = torch.tensor(prior_scaling, dtype=loc_pred.dtype, device=loc_pred.device)
    acx, acy, aw, ah = anchors_center.unbind(-1)
    tx, ty, tw, th = loc_pred.unbind(-1)
    cx = tx * s[0] * aw + acx
    cy = ty * s[1] * ah + acy
    # Clamp the exponent so that garbage logits still decode to finite sizes.
    w = torch.exp(torch.clamp(tw * s[2], max=10.0)) * aw
    h = torch.exp(torch.clamp(th * s[3], max=10.0)) * ah
    boxes = center_to_corner(torch.stack([cx, cy, w, h], dim=-1))
    if image_h is not None and image_w is not None:
        x1, y1, x2, y2 = boxes.unbind(-1)
        w_hi = torch.as_tensor(image_w, dtype=boxes.dtype, device=boxes.device)
        h_hi = torch.as_tensor(image_h, dtype=boxes.dtype, device=boxes.device)
        boxes = torch.stack(
            [
                torch.minimum(x1.clamp_min(0.0), w_hi),
                torch.minimum(y1.clamp_min(0.0), h_hi),
                torch.minimum(x2.clamp_min(0.0), w_hi),
                torch.minimum(y2.clamp_min(0.0), h_hi),
            ],
            dim=-1,
        )
    return boxes
