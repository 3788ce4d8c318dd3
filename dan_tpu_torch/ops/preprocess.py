"""Image preprocessing (counterpart of dan_tpu/ops/preprocess.py): mean
subtraction, the separable bilinear resample that reproduces TF's resize
(no antialias) with edge clamping at a region inside a larger canvas, and
the train-time stage -- crop + resize, colour distortion, flip -- batched
over B on the device.

The resample builds the same (out, src) interpolation matrices as the JAX
package and applies them with two matrix products.  `F.interpolate` has no
way to clamp at a region narrower than its input.

The train stage takes its random numbers as data (`AugmentDraws`, seven
scalars an image, drawn on the host by `sample_augment_batch` from each image's
seed with the JAX package's generator, ops/threefry.py), so the port draws
the JAX package's numbers and a test can also hand it any others.  Divisions by a constant
divide by a tensor: on a CUDA tensor PyTorch turns `x / 255.0` into a
multiplication by the rounded reciprocal, which is not IEEE division.
"""
from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from dan_tpu_torch.config import PreprocessConfig
from dan_tpu_torch.ops import threefry


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
    """(..., out_len, src_len) float32 interpolation matrix, one per entry
    of the (broadcast) scale, offset and region tensors, whose shapes end in
    a 1 where they vary.  Output o samples the input at
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
    w = (1.0 - f)[..., None] * (i == lo_c[..., None]) + f[..., None] * (
        i == hi_c[..., None]
    )
    return torch.where(valid[..., None], w, 0.0)


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


def bilinear_resample_batch(
    images: torch.Tensor,
    out_h: int,
    out_w: int,
    scale_y: torch.Tensor,
    scale_x: torch.Tensor,
    y0: torch.Tensor,
    x0: torch.Tensor,
    region,
    semantics: str = "half_pixel",
) -> torch.Tensor:
    """bilinear_resample for a batch: (B, H, W, C) float images ->
    (B, out_h, out_w, C) float32, image b with its own scale, offset and
    region = (y_lo, y_hi, x_lo, x_hi), all (B,) float32 tensors.  One pair
    of interpolation matrices per image, applied as batched matrix
    products."""
    bsz, h, w, c = images.shape
    dev = images.device
    col = lambda v: v.to(dev, torch.float32)[:, None]  # noqa: E731
    y_lo, y_hi, x_lo, x_hi = (col(v) for v in region)
    wy = _bilinear_weights(h, out_h, col(scale_y), col(y0), y_lo, y_hi, semantics, dev)
    wx = _bilinear_weights(w, out_w, col(scale_x), col(x0), x_lo, x_hi, semantics, dev)
    tmp = torch.bmm(wy, images.float().reshape(bsz, h, w * c)).reshape(bsz, out_h, w, c)
    return torch.einsum("bhwc,bow->bhoc", tmp, wx)


# ---------------------------------------------------------------------------
# train-time preprocessing, batched over B
# ---------------------------------------------------------------------------

# The tf.slim distort_color op orderings (op ids: 0 brightness,
# 1 saturation, 2 hue, 3 contrast), as in the JAX package.
REFERENCE_ORDERINGS = (
    (0, 1, 2, 3),
    (1, 0, 3, 2),
    (3, 2, 0, 1),
    (2, 1, 3, 0),
)


class AugmentDraws(NamedTuple):
    """The random draws of the train preprocess: (B,) CPU tensors for a
    batch (`sample_augment_batch`), or scalars for one image (`stack_draws`
    makes a batch of those)."""

    delta_b: object  # brightness delta
    f_sat: object  # saturation factor
    delta_h: object  # hue delta
    f_con: object  # contrast factor
    on: object  # colour distortion applied
    order: object  # index into REFERENCE_ORDERINGS ('reference' order only)
    flip: object  # horizontal flip


def stack_draws(draws: Sequence[AugmentDraws]) -> AugmentDraws:
    """Per-image draws -> (B,) CPU tensors."""
    cols = list(zip(*draws))
    f32 = [torch.tensor(c, dtype=torch.float32) for c in cols[:4]]
    return AugmentDraws(
        *f32,
        on=torch.tensor(cols[4], dtype=torch.bool),
        order=torch.tensor(cols[5], dtype=torch.int64),
        flip=torch.tensor(cols[6], dtype=torch.bool),
    )


def sample_augment_batch(seeds, cfg: PreprocessConfig) -> AugmentDraws:
    """The draws of a batch, image b's from seeds[b] (the host batch's
    `seed` entry): the numbers the JAX package draws from
    jax.random.PRNGKey(seed) (dan_tpu/train/loop.py and ops/preprocess.py's
    train_preprocess_one / color_distort).  The key splits into colour and
    flip keys, the colour key into the gate and four strengths (and the
    ordering in 'reference' order), through the numpy threefry of
    ops/threefry.py, one hash a draw for the whole batch."""
    keys = threefry.prng_key(np.asarray(seeds, np.int64).reshape(-1))
    k_color, k_flip = threefry.split(keys)
    if cfg.color_distort_order == "reference":
        k_gate, k1, k2, k3, k4, k_order = threefry.split(k_color, 6)
        order = threefry.randint(k_order, 0, len(REFERENCE_ORDERINGS))
    else:
        k_gate, k1, k2, k3, k4 = threefry.split(k_color, 5)
        order = np.zeros(np.shape(keys[1]), np.int64)

    def uniform(k, lo, hi):
        return torch.from_numpy(threefry.uniform(k, lo, hi))

    return AugmentDraws(
        delta_b=uniform(k1, -cfg.brightness_max_delta, cfg.brightness_max_delta),
        f_sat=uniform(k2, *cfg.saturation_range),
        delta_h=uniform(k3, -cfg.hue_max_delta, cfg.hue_max_delta),
        f_con=uniform(k4, *cfg.contrast_range),
        on=torch.from_numpy(threefry.bernoulli(k_gate, cfg.color_distort_prob)),
        order=torch.from_numpy(order),
        flip=torch.from_numpy(threefry.bernoulli(k_flip, cfg.flip_prob)),
    )


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d with IEEE division on every device."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _per_image(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 1, 1, 1) on like's device and dtype."""
    return v.to(device=like.device, dtype=like.dtype, non_blocking=True)[:, None, None, None]


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 1] -> HSV in [0, 1] (TF-compatible)."""
    r, g, b = rgb.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    rangec = maxc - minc
    safe_range = torch.where(rangec > 0, rangec, 1.0)
    s = torch.where(maxc > 0, rangec / torch.where(maxc > 0, maxc, 1.0), 0.0)
    rc = (maxc - r) / safe_range
    gc = (maxc - g) / safe_range
    bc = (maxc - b) / safe_range
    h = torch.where(
        r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = _div(h, 6.0) % 1.0
    h = torch.where(rangec > 0, h, 0.0)
    return torch.stack([h, s, v], dim=-1)


def _select(i: torch.Tensor, choices: List[torch.Tensor]) -> torch.Tensor:
    """choices[i] elementwise for i in 0..5 (jnp.select with i == k)."""
    out = torch.zeros_like(choices[0])
    for k in reversed(range(len(choices))):
        out = torch.where(i == k, choices[k], out)
    return out


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """(..., 3) HSV in [0, 1] -> RGB in [0, 1]."""
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6
    r = _select(i, [v, q, p, p, t, v])
    g = _select(i, [t, v, v, q, p, p])
    b = _select(i, [p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


def _distort_fixed(x, db, fs, dh, fc):
    d = torch.clamp(x + db, 0.0, 1.0)
    h, s, v = rgb_to_hsv(d).unbind(-1)
    s = torch.clamp(s * fs[..., 0], 0.0, 1.0)
    h = (h + dh[..., 0]) % 1.0
    d = hsv_to_rgb(torch.stack([h, s, v], dim=-1))
    mean = d.mean(dim=(-3, -2), keepdim=True)
    return torch.clamp((d - mean) * fc + mean, 0.0, 1.0)


def _distort_reference(x, db, fs, dh, fc, ordering):
    def brightness(img):
        return img + db

    def saturation(img):
        h, s, v = rgb_to_hsv(torch.clamp(img, 0.0, 1.0)).unbind(-1)
        return hsv_to_rgb(torch.stack([h, torch.clamp(s * fs[..., 0], 0.0, 1.0), v], -1))

    def hue(img):
        h, s, v = rgb_to_hsv(torch.clamp(img, 0.0, 1.0)).unbind(-1)
        return hsv_to_rgb(torch.stack([(h + dh[..., 0]) % 1.0, s, v], -1))

    def contrast(img):
        mean = img.mean(dim=(-3, -2), keepdim=True)
        return (img - mean) * fc + mean

    ops = (brightness, saturation, hue, contrast)
    for op_id in ordering:
        x = ops[op_id](x)
    return torch.clamp(x, 0.0, 1.0)


def color_distort(x: torch.Tensor, draws: AugmentDraws, cfg: PreprocessConfig) -> torch.Tensor:
    """Photometric distortion of (B, H, W, 3) RGB images in [0, 1], image b
    with the draws' entry b.  cfg.color_distort_order 'fixed' runs
    brightness, saturation, hue, contrast with one HSV round trip;
    'reference' runs each image's tf.slim ordering with an HSV round trip
    per op and one final clip.  Images whose draw `on` is false come back
    unchanged."""
    if not bool(draws.on.any()):
        return x
    db, fs, dh, fc = (_per_image(v, x) for v in draws[:4])
    on = _per_image(draws.on, x) > 0
    if cfg.color_distort_order == "fixed":
        d = _distort_fixed(x, db, fs, dh, fc)
    elif cfg.color_distort_order == "reference":
        d = torch.empty_like(x)
        order = draws.order.tolist()
        for o, ordering in enumerate(REFERENCE_ORDERINGS):
            idx = [b for b, ob in enumerate(order) if ob == o]
            if idx:
                sel = torch.tensor(idx, device=x.device)
                d[sel] = _distort_reference(
                    x[sel], db[sel], fs[sel], dh[sel], fc[sel], ordering
                )
    else:
        raise ValueError(f"unknown color_distort_order {cfg.color_distort_order!r}")
    return torch.where(on, d, x)


def crop_and_resize(
    images: torch.Tensor,
    x0: torch.Tensor,
    y0: torch.Tensor,
    size: torch.Tensor,
    out_size: int,
    semantics: str = "half_pixel",
) -> torch.Tensor:
    """(B, H, W, C) float images -> (B, out_size, out_size, C) float32,
    sampling each image's square window (x0, y0, size) (float32 (B,)
    tensors, canvas pixels).  The resample clamps at the window's edge and
    window content beyond the canvas reads as zero, as the JAX package's
    crop_and_resize does."""
    dev = images.device
    x0, y0, size = (v.to(dev, torch.float32) for v in (x0, y0, size))
    s = torch.tensor(float(out_size), device=dev) / size
    return bilinear_resample_batch(
        images, out_size, out_size, s, s, y0, x0,
        region=(y0, y0 + size, x0, x0 + size), semantics=semantics,
    )


def transform_boxes(
    boxes: torch.Tensor,
    mask: torch.Tensor,
    x0: torch.Tensor,
    y0: torch.Tensor,
    size: torch.Tensor,
    out_size: int,
    min_size: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map (B, G, 4) corner boxes through each image's crop + resize.  A box
    survives if its centre lies inside the window and its clipped size is
    at least min_size output pixels; the others become zero rows."""
    dev = boxes.device
    x0, y0, size = (v.to(dev, torch.float32)[:, None] for v in (x0, y0, size))
    s = torch.tensor(float(out_size), device=dev) / size
    x1, y1, x2, y2 = boxes.unbind(-1)
    cx = (x1 + x2) * 0.5
    cy = (y1 + y2) * 0.5
    center_in = (cx >= x0) & (cx < x0 + size) & (cy >= y0) & (cy < y0 + size)
    new = torch.stack([(x1 - x0) * s, (y1 - y0) * s, (x2 - x0) * s, (y2 - y0) * s], -1)
    new = torch.clamp(new, 0.0, float(out_size))
    w = new[..., 2] - new[..., 0]
    h = new[..., 3] - new[..., 1]
    new_mask = mask & center_in & (w >= min_size) & (h >= min_size)
    return torch.where(new_mask[..., None], new, 0.0), new_mask


def hflip(
    images: torch.Tensor, boxes: torch.Tensor, mask: torch.Tensor, width: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Horizontal flip of (B, H, W, C) images and (B, G, 4) corner boxes."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    fb = torch.stack([width - x2, y1, width - x1, y2], dim=-1)
    return images.flip(2), torch.where(mask[..., None], fb, 0.0)


def train_preprocess(
    canvas_u8: torch.Tensor,
    crop: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    boxes: torch.Tensor,
    mask: torch.Tensor,
    draws: AugmentDraws,
    cfg: PreprocessConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, C, C, 3) uint8 canvases, their crop windows crop = (x0, y0,
    size) ((B,) float32) and (B, G, 4) boxes with (B, G) mask -> normalised
    (B, S, S, 3) float32 images, boxes and mask (S = train_image_size).
    The JAX package's train_preprocess_one, for the whole batch at once."""
    size = cfg.train_image_size
    x0, y0, csize = crop
    img = _div(canvas_u8.float(), 255.0)
    img = crop_and_resize(img, x0, y0, csize, size, cfg.resize_semantics)
    boxes, mask = transform_boxes(boxes, mask, x0, y0, csize, size, cfg.min_box_size)
    img = color_distort(img, draws, cfg)
    if bool(draws.flip.any()):
        flip = draws.flip.to(img.device, non_blocking=True)
        img_f, boxes_f = hflip(img, boxes, mask, float(size))
        img = torch.where(flip[:, None, None, None], img_f, img)
        boxes = torch.where(flip[:, None, None], boxes_f, boxes)
    img = normalize_image(img * 255.0, cfg)
    return img, boxes, mask
