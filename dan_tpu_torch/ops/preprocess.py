"""Eval-time image preprocessing: mean subtraction and the separable
bilinear resample that reproduces TF's resize (no antialias), including
edge clamping at a region inside a larger canvas.

The resample builds the same (out, src) interpolation matrices as the JAX
package and applies them with two matrix products.  `F.interpolate` has no
way to clamp at a region narrower than its input.
"""
from __future__ import annotations

import torch

from dan_tpu.config import PreprocessConfig


def normalize_image(x: torch.Tensor, cfg: PreprocessConfig) -> torch.Tensor:
    """RGB [0, 255] float (..., 3) -> mean-subtracted network input."""
    mean = torch.tensor(cfg.mean_rgb, dtype=x.dtype, device=x.device)
    std = torch.tensor(cfg.std_rgb, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _bilinear_weights(
    src_len: int,
    out_len: int,
    scale,
    offset,
    region_lo=None,
    region_hi=None,
    semantics: str = "half_pixel",
    device="cpu",
) -> torch.Tensor:
    """(out_len, src_len) float32 interpolation matrix.  Output o samples
    the input at
        src(o) = (o + 0.5) / scale + offset - 0.5   (semantics='half_pixel')
        src(o) =  o / scale + offset                (semantics='tf1_legacy')
    with the two neighbours clamped into [region_lo, region_hi) and all-zero
    rows where src lies more than one pixel outside the region.  The region
    defaults to [0, src_len)."""
    scale = _f32(scale, device)
    offset = _f32(offset, device)
    lo_b = _f32(0.0 if region_lo is None else region_lo, device)
    hi_b = _f32(float(src_len) if region_hi is None else region_hi, device)
    o = torch.arange(out_len, dtype=torch.float32, device=device)
    if semantics == "tf1_legacy":
        src = o / scale + offset
    elif semantics == "half_pixel":
        src = (o + 0.5) / scale + offset - 0.5
    else:
        raise ValueError(f"unknown resize semantics {semantics!r}")
    lo = torch.floor(src)
    f = src - lo
    valid = (src > lo_b - 1.0) & (src < hi_b)
    lo_px = torch.ceil(lo_b - 0.5)
    hi_px = torch.floor(hi_b - 0.5)
    lo_c = torch.minimum(torch.maximum(lo, lo_px), hi_px)
    hi_c = torch.minimum(torch.maximum(lo + 1.0, lo_px), hi_px)
    i = torch.arange(src_len, dtype=torch.float32, device=device)
    w = (1.0 - f)[:, None] * (i[None, :] == lo_c[:, None]) + f[:, None] * (
        i[None, :] == hi_c[:, None]
    )
    return torch.where(valid[:, None], w, 0.0)


def bilinear_resample(
    image: torch.Tensor,
    out_h: int,
    out_w: int,
    scale_y,
    scale_x,
    y0=0.0,
    x0=0.0,
    region=None,
    semantics: str = "half_pixel",
) -> torch.Tensor:
    """(H, W, C) image -> (out_h, out_w, C) float32, sampling pixel (oy, ox)
    at ((oy + 0.5) / scale_y + y0 - 0.5, (ox + 0.5) / scale_x + x0 - 0.5)
    ('half_pixel'; 'tf1_legacy' drops the half-pixel terms), edge-clamped
    inside region = (y_lo, y_hi, x_lo, x_hi), zeros outside it."""
    h, w, c = image.shape
    dev = image.device
    y_lo, y_hi, x_lo, x_hi = region if region is not None else (None,) * 4
    wy = _bilinear_weights(h, out_h, scale_y, y0, y_lo, y_hi, semantics, dev)
    wx = _bilinear_weights(w, out_w, scale_x, x0, x_lo, x_hi, semantics, dev)
    tmp = torch.matmul(wy, image.float().reshape(h, w * c)).reshape(out_h, w, c)
    out = torch.einsum("hwc,ow->hoc", tmp, wx)
    return out.to(image.dtype) if image.is_floating_point() else out
