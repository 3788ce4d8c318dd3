"""The plain reference of one train step of the detector, in float32:

    uint8 canvases -> crop window resized bilinearly (half-pixel centres,
    edges clamped at the window) -> colour distortion (brightness,
    saturation, hue, contrast in one HSV round trip) -> horizontal flip ->
    mean subtraction -> anchor matching (threshold 0.35, forced best
    anchor per face, scale compensation) -> forward -> softmax
    cross-entropy with 3:1 hard negatives + smooth-L1 on the positives,
    both over the batch's positives -> SGD: clip by global norm, weight
    decay on kernels, momentum, a warm-up ramp on the LR.

    loss, grads = loss_and_grads(params, dan, batch, draws, block=8)
    sgd(params, grads, momentum, step, dan["train"])

`batch` holds the host arrays (canvas, crop_x0, crop_y0, crop_size, boxes,
mask); `draws` the seven per-image draws as float / bool tensors.  The
gradients are summed over blocks of images with the loss normalised by
the whole batch's positives, so a block at a time fits on the card.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import model as ref
from benchmark.reference.detect import anchors as make_anchors

DRAW_KEYS = ("delta_b", "f_sat", "delta_h", "f_con", "on", "order", "flip")


# ---------------------------------------------------------------- preprocess

def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def _weights(src_len, out_len, scale, offset, lo_b, hi_b, device):
    """(B, out_len, src_len) half-pixel bilinear matrices, taps clamped into
    [lo_b, hi_b), zero rows more than a pixel outside it."""
    o = torch.arange(out_len, dtype=torch.float32, device=device)
    src = (o + 0.5) / scale + offset - 0.5
    lo = torch.floor(src)
    f = src - lo
    valid = (src > lo_b - 1.0) & (src < hi_b)
    lo_px, hi_px = torch.ceil(lo_b - 0.5), torch.floor(hi_b - 0.5)
    lo_c = torch.minimum(torch.maximum(lo, lo_px), hi_px)
    hi_c = torch.minimum(torch.maximum(lo + 1.0, lo_px), hi_px)
    i = torch.arange(src_len, dtype=torch.float32, device=device)
    w = (1.0 - f)[..., None] * (i == lo_c[..., None]) + f[..., None] * (i == hi_c[..., None])
    return torch.where(valid[..., None], w, 0.0)


def crop_resize(img, x0, y0, size, out):
    """(B, H, W, C) float -> (B, out, out, C): each image's square window."""
    b, h, w, c = img.shape
    s = torch.tensor(float(out), device=img.device) / size
    col = lambda v: v[:, None]  # noqa: E731
    wy = _weights(h, out, col(s), col(y0), col(y0), col(y0 + size), img.device)
    wx = _weights(w, out, col(s), col(x0), col(x0), col(x0 + size), img.device)
    tmp = torch.bmm(wy, img.reshape(b, h, w * c)).reshape(b, out, w, c)
    return torch.einsum("bhwc,bow->bhoc", tmp, wx)


def rgb_to_hsv(rgb):
    r, g, b = rgb.unbind(-1)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    rangec = maxc - minc
    safe = torch.where(rangec > 0, rangec, 1.0)
    s = torch.where(maxc > 0, rangec / torch.where(maxc > 0, maxc, 1.0), 0.0)
    rc, gc, bc = (maxc - r) / safe, (maxc - g) / safe, (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc, torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = _div(h, 6.0) % 1.0
    h = torch.where(rangec > 0, h, 0.0)
    return torch.stack([h, s, maxc], dim=-1)


def _pick(i, choices):
    out = torch.zeros_like(choices[0])
    for k in reversed(range(len(choices))):
        out = torch.where(i == k, choices[k], out)
    return out


def hsv_to_rgb(hsv):
    h, s, v = hsv.unbind(-1)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    i = i.to(torch.int32) % 6
    return torch.stack([_pick(i, [v, q, p, p, t, v]), _pick(i, [t, v, v, q, p, p]),
                        _pick(i, [p, p, t, v, v, q])], dim=-1)


def colour(x, d):
    """Brightness, saturation, hue, contrast; images whose draw is off are
    returned unchanged."""
    col = lambda v: v.to(x.device, x.dtype)[:, None, None, None]  # noqa: E731
    db, fs, dh, fc = (col(d[k]) for k in DRAW_KEYS[:4])
    y = torch.clamp(x + db, 0.0, 1.0)
    h, s, v = rgb_to_hsv(y).unbind(-1)
    s = torch.clamp(s * fs[..., 0], 0.0, 1.0)
    h = (h + dh[..., 0]) % 1.0
    y = hsv_to_rgb(torch.stack([h, s, v], dim=-1))
    mean = y.mean(dim=(-3, -2), keepdim=True)
    y = torch.clamp((y - mean) * fc + mean, 0.0, 1.0)
    return torch.where(col(d["on"]) > 0, y, x)


def preprocess(batch: Dict[str, torch.Tensor], draws: Dict, dan: Dict):
    """Device batch -> (normalized images (B, S, S, 3), boxes (B, G, 4), mask)."""
    pre = dan["preprocess"]
    size = pre["train_image_size"]
    x0, y0, cs = batch["crop_x0"], batch["crop_y0"], batch["crop_size"]
    img = crop_resize(_div(batch["canvas"].float(), 255.0), x0, y0, cs, size)
    s = torch.tensor(float(size), device=img.device) / cs[:, None]
    x1, y1, x2, y2 = batch["boxes"].unbind(-1)
    cx, cy = (x1 + x2) * 0.5, (y1 + y2) * 0.5
    xa, ya, ca = x0[:, None], y0[:, None], cs[:, None]
    inside = (cx >= xa) & (cx < xa + ca) & (cy >= ya) & (cy < ya + ca)
    nb = torch.stack([(x1 - xa) * s, (y1 - ya) * s, (x2 - xa) * s, (y2 - ya) * s], -1)
    nb = torch.clamp(nb, 0.0, float(size))
    bw, bh = nb[..., 2] - nb[..., 0], nb[..., 3] - nb[..., 1]
    mask = batch["mask"] & inside & (bw >= pre["min_box_size"]) & (bh >= pre["min_box_size"])
    boxes = torch.where(mask[..., None], nb, 0.0)
    img = colour(img, draws)
    flip = draws["flip"].to(img.device)
    fx1, fy1, fx2, fy2 = boxes.unbind(-1)
    fb = torch.where(mask[..., None], torch.stack([size - fx2, fy1, size - fx1, fy2], -1), 0.0)
    img = torch.where(flip[:, None, None, None], img.flip(2), img)
    boxes = torch.where(flip[:, None, None], fb, boxes)
    return ref.normalize(img * 255.0, dan), boxes, mask


# ------------------------------------------------------------------ matching

def _corner(c):
    cx, cy, w, h = c.unbind(-1)
    return torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], -1)


def _center(b):
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) * 0.5, (y1 + y2) * 0.5, x2 - x1, y2 - y1], -1)


def pairwise_iou(a, b):
    a, bb = a[..., :, None, :], b[..., None, :, :]
    ix1, iy1 = torch.maximum(a[..., 0], bb[..., 0]), torch.maximum(a[..., 1], bb[..., 1])
    ix2, iy2 = torch.minimum(a[..., 2], bb[..., 2]), torch.minimum(a[..., 3], bb[..., 3])
    inter = (ix2 - ix1).clamp_min(0.0) * (iy2 - iy1).clamp_min(0.0)
    ar = lambda t: (t[..., 2] - t[..., 0]).clamp_min(0.0) * (t[..., 3] - t[..., 1]).clamp_min(0.0)  # noqa
    union = ar(a[..., 0, :])[..., :, None] + ar(bb[..., 0, :, :])[..., None, :] - inter
    return torch.where(union > 0.0, inter / union, 0.0)


def match(anc, gt, mask, dan):
    """(A, 4) centre anchors, (B, G, 4) corner gts -> (cls (B, A) int32 in
    {-1, 0, 1}, loc (B, A, 4))."""
    mc, prior = dan["match"], dan["anchors"]["prior_scaling"]
    n_anc = anc.shape[0]
    valid = mask.float()
    iou = pairwise_iou(_corner(anc), gt) * valid[..., None, :]
    raw_best = iou.max(dim=-1).values
    best_anchor = iou.argmax(dim=-2)
    a_idx = torch.arange(n_anc, device=iou.device)
    forced = (a_idx[:, None] == best_anchor[..., None, :]).float()
    aug = iou + 2.0 * (forced * valid[..., None, :])
    if mc["enable_scale_comp"]:
        k = min(mc["scale_comp_topk"], n_anc)
        best_gt = iou.argmax(dim=-1)
        pos = raw_best >= mc["match_threshold"]
        count = torch.zeros(mask.shape, dtype=torch.float32, device=iou.device).scatter_add_(
            -1, best_gt, pos.float())
        needs = (count < k) & mask
        iou_t = iou.transpose(-1, -2)
        top_v, top_i = torch.sort(iou_t, dim=-1, descending=True, stable=True)
        top_v, top_i = top_v[..., :k], top_i[..., :k]
        ok = (top_v > mc["scale_comp_iou"]) & needs[..., None]
        comp = torch.zeros_like(iou_t).scatter_add_(-1, top_i, ok.float())
        aug = aug + comp.clamp_max(1.0).transpose(-1, -2)
    m_aug = aug.max(dim=-1).values
    m_gt = aug.argmax(dim=-1)
    gc = torch.gather(_center(gt), -2, m_gt[..., None].expand(*m_gt.shape, 4))
    positive = m_aug >= mc["match_threshold"]
    ignore = (raw_best >= mc["ignore_threshold"]) & (raw_best < mc["match_threshold"]) & ~positive
    cls = torch.where(positive, 1, torch.where(ignore, -1, 0)).to(torch.int32)
    s = torch.tensor(prior, dtype=torch.float32, device=anc.device)
    acx, acy, aw, ah = anc.unbind(-1)
    gcx, gcy, gw, gh = gc.unbind(-1)
    gw, gh = gw.clamp_min(1e-6), gh.clamp_min(1e-6)
    loc = torch.stack([(gcx - acx) / aw / s[0], (gcy - acy) / ah / s[1],
                       torch.log(gw / aw) / s[2], torch.log(gh / ah) / s[3]], -1)
    return cls, torch.where(positive[..., None], loc, 0.0)


# ---------------------------------------------------------------------- loss

def _topk_mask(values, k):
    """Mask of the k[b] largest of each row, ties to the lower index."""
    a = values.shape[1]
    order = torch.sort(values, dim=1, descending=True, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(1, order, torch.arange(a, device=values.device).expand_as(order))
    return rank < k[:, None]


def loss_sum(cls_logits, loc_preds, cls_t, loc_t, tc):
    """(sum of CE over positives and kept negatives, sum of smooth-L1 over
    positives): the unnormalised loss of these images."""
    positive = cls_t == 1
    logp = F.log_softmax(cls_logits, dim=-1)
    ce = -torch.where(cls_t.clamp_min(0) == 1, logp[..., 1], logp[..., 0])
    negative = cls_t == 0
    n_pos = positive.sum(dim=1)
    wanted = torch.where(n_pos > 0, (tc["hnm_ratio"] * n_pos).long(),
                         torch.full_like(n_pos, tc["hnm_min_negatives"]))
    keep = torch.minimum(wanted, negative.sum(dim=1))
    neg_ce = torch.where(negative, ce.detach(), -torch.inf)
    hard = negative & _topk_mask(neg_ce, keep) & (keep[:, None] > 0)
    cls_sum = torch.where(positive | hard, ce, 0.0).sum()
    d = loc_preds - loc_t
    ad = d.abs()
    l1 = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5).sum(-1)
    return cls_sum, torch.where(positive, l1, 0.0).sum()


def loss_and_grads(p: Dict[str, torch.Tensor], dan: Dict, batch: Dict[str, torch.Tensor],
                   draws: Dict, block: int = 8, quant=None) -> Tuple[float, Dict]:
    """-> (loss, {name: float32 gradient}) of one batch, a block of images
    at a time; `quant` rounds every conv's operands (the control)."""
    images, boxes, mask = preprocess(batch, draws, dan)
    size = dan["preprocess"]["train_image_size"]
    anc = make_anchors(dan, size, size, images.device)
    cls_t, loc_t = [], []
    for i in range(0, images.shape[0], block):
        c, lo = match(anc, boxes[i:i + block], mask[i:i + block], dan)
        cls_t.append(c)
        loc_t.append(lo)
    cls_t, loc_t = torch.cat(cls_t), torch.cat(loc_t)
    norm = (cls_t == 1).sum().float().clamp_min(1.0)
    tc = dan["train"]
    leaves = {n: t.detach().requires_grad_(True) for n, t in p.items()}
    grads = {n: torch.zeros_like(t) for n, t in p.items()}
    total = 0.0
    for i in range(0, images.shape[0], block):
        cls, loc = ref.forward(leaves, dan, images[i:i + block], quant)
        cs, ls = loss_sum(cls, loc, cls_t[i:i + block], loc_t[i:i + block], tc)
        loss = cs / norm + tc["loc_loss_weight"] * (ls / norm)
        gs = torch.autograd.grad(loss, list(leaves.values()))
        for n, g in zip(leaves, gs):
            grads[n] += g
        total += float(loss.detach())
    return total, grads


# ----------------------------------------------------------------------- SGD

def learning_rate(tc: Dict, step: int) -> float:
    """The LR of the update made after `step` earlier ones, in float32."""
    f32 = np.float32
    v = f32(tc["learning_rate"])
    for i, b in sorted(enumerate(tc["lr_boundaries"]), key=lambda t: t[1]):
        scale = f32(tc["lr_factors"][i + 1] / tc["lr_factors"][i])
        ind = f32(max(0.0, np.sign(b - step)))
        v = f32(v * ind + (f32(1.0) - ind) * scale * v)
    if tc["warmup_steps"] > 0:
        frac = min(f32(step) / f32(tc["warmup_steps"]), f32(1.0))
        v = f32(v * (f32(0.1) + f32(0.9) * frac))
    return float(v)


@torch.no_grad()
def sgd(p: Dict[str, torch.Tensor], g: Dict[str, torch.Tensor], mom: Dict[str, torch.Tensor],
        step: int, tc: Dict) -> Dict[str, torch.Tensor]:
    """One update in place -> the gradients as the optimizer took them
    (clipped, before weight decay)."""
    norm = torch.sqrt(sum((x.double() ** 2).sum() for x in g.values())).float()
    clip = tc["grad_clip_norm"]
    f = (clip / norm) if (clip > 0 and float(norm) >= clip) else torch.ones_like(norm)
    taken = {n: x * f for n, x in g.items()}
    lr = learning_rate(tc, step)
    for n in p:
        d = taken[n] + tc["weight_decay"] * p[n] if n.endswith(".weight") else taken[n]
        mom[n].mul_(tc["momentum"]).add_(d)
        p[n].add_(mom[n], alpha=-lr)
    return taken


def leaf_norms(t: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(x.double().norm()) for n, x in t.items()}


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   leaves: Optional[List[str]] = None) -> Tuple[float, str]:
    """The largest |got - want| of a leaf's norm, over max(that leaf's
    reference norm, the median leaf's) -> (gap, leaf)."""
    names = leaves if leaves is not None else list(want)
    med = float(np.median([want[n] for n in names]))
    gaps = {n: abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in names}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def median_leaf_gap(got: Dict[str, float], want: Dict[str, float]) -> float:
    """The median over the leaves of worst_leaf_gap's per-leaf gap: steady
    where the worst leaf is one small leaf's noise."""
    med = float(np.median(list(want.values())))
    return float(np.median([abs(got[n] - want[n]) / max(want[n], med, 1e-30) for n in want]))
