"""Eval-time resize: squash the top-left (src_h, src_w) image region of a
uint8 canvas to the square network input (no aspect preservation), then
subtract the mean."""
from __future__ import annotations

import torch

from dan_tpu_torch.config import PreprocessConfig
from dan_tpu_torch.ops.preprocess import bilinear_resample, normalize_image


def squash_resize(
    canvas: torch.Tensor,
    src_h,
    src_w,
    out_h: int,
    out_w: int,
    semantics: str = "half_pixel",
) -> torch.Tensor:
    """(C, C, 3) float canvas -> (out_h, out_w, 3), resizing the region
    (src_h, src_w) to fill the output, edge-clamped at the image's true
    extent.  src_h and src_w are float32 scalars (as in the JAX package,
    where they are traced)."""
    dev = canvas.device
    src_h = torch.as_tensor(src_h, dtype=torch.float32, device=dev)
    src_w = torch.as_tensor(src_w, dtype=torch.float32, device=dev)
    # Divide tensor by tensor: PyTorch computes `int / tensor` as the int
    # times the tensor's rounded reciprocal, which can be 1 ulp off the
    # correctly rounded scale the JAX package uses.
    out_hw = torch.tensor([out_h, out_w], dtype=torch.float32, device=dev)
    return bilinear_resample(
        canvas,
        out_h,
        out_w,
        out_hw[0] / src_h,
        out_hw[1] / src_w,
        region=(0.0, src_h, 0.0, src_w),
        semantics=semantics,
    )


def eval_preprocess(
    canvas_u8: torch.Tensor,
    src_h,
    src_w,
    out_size: int,
    cfg: PreprocessConfig,
) -> torch.Tensor:
    """uint8 canvas -> normalized float32 (out_size, out_size, 3) input."""
    img = squash_resize(
        canvas_u8.float(), src_h, src_w, out_size, out_size,
        semantics=cfg.resize_semantics,
    )
    return normalize_image(img, cfg)
