"""The plain reference of RetinaFace-R50 (arXiv:1905.00641; the
configuration `cfg_re50` of biubug6/Pytorch_Retinaface, data/config.py,
with its models/net.py and models/retinaface.py; the body torchvision's
ResNet-50 v1.5, arXiv:1512.03385), written from those equations alone in
plain PyTorch: float32, NCHW, batch norm unfolded (F.batch_norm on running
statistics), no kernels of the program.

    spec = param_spec(dan)                  # conv kernels and head biases, for weights.make_weights
    bn = bn_params(dan, seed, device)       # BN scale and shift from the seed, statistics at identity
    calibrate(params, dan, x)               # BN running statistics from one pass over x
    cls, loc, landm = forward(params, dan, x)   # x (B, H, W, 3) mean-subtracted
    det = postprocess(cls, loc, landm, dan, h, w)   # the detect tail, with 'landmarks'

`dan` is the configuration file's "dan" section.  The parameter names are
the release's state_dict names (torchvision's in the body), without
`num_batches_tracked`.  `quant` (a function of a tensor) is applied to
every convolution's input and kernel: None for the reference, a
lower-precision rounding for the control.

Where this departs from the release (each also under the configuration's
`assumed`): anchors and decoded boxes are in pixels of the network input,
not in [0, 1] scaled back; boxes are clipped to the image and the exponent
of a size clamped at 10 (the port's decode); a box no wider or taller than
1 pixel is dropped before the top-k (the port's filter); the NMS IoU has no
+1 in its widths (the port's, `reference.detect.nms_rank`); the input is
RGB, its mean (123, 117, 104), the release's BGR (104, 117, 123) reordered.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import detect as ref_detect
from benchmark.weights import generator

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]
BN_STREAM = 4  # the seed's generator stream of the BN scales and shifts
BN_SCALE_STD = 0.1  # gamma ~ 1 + 0.1 N(0, 1), beta ~ 0.1 N(0, 1)
# The BN that closes a residual branch (each bottleneck's bn3) starts its
# scale at 0.2 x (1 + 0.1 N(0, 1)): a trained ResNet holds those scales
# small (torchvision's zero_init_residual starts them at 0).  With every
# scale near 1 the random body is chaotic: a perturbation of 2e-3 at the
# stem (bf16 rounding) grows to 0.6-0.7 of the logits at 64-128 px, so
# the bf16 program and the fp8 control would both read of order 1.
RESIDUAL_SCALE = 0.2
HEADS = (("ClassHead", 2), ("BboxHead", 4), ("LandmarkHead", 10))
SSH_CONVS = ("conv3X3", "conv5X5_1", "conv5X5_2", "conv7X7_2", "conv7x7_3")


def _stage_out(m: Dict, i: int) -> int:
    return m["stage_widths"][i - 1] * m["expansion"]


def conv_bn_layers(m: Dict) -> List[Tuple[str, str, int, int, int, int]]:
    """Every conv + BN pair in order: (conv name, BN name, cin, cout, k,
    stride)."""
    out = [("body.conv1", "body.bn1", 3, m["stem_channels"], 7, 2)]
    cin = m["stem_channels"]
    for i, (n, w) in enumerate(zip(m["stage_blocks"], m["stage_widths"]), start=1):
        for j in range(n):
            p, stride, cout = f"body.layer{i}.{j}", (2 if i > 1 and j == 0 else 1), w * m["expansion"]
            out += [(f"{p}.conv1", f"{p}.bn1", cin, w, 1, 1),
                    (f"{p}.conv2", f"{p}.bn2", w, w, 3, stride),
                    (f"{p}.conv3", f"{p}.bn3", w, cout, 1, 1)]
            if j == 0:
                out.append((f"{p}.downsample.0", f"{p}.downsample.1", cin, cout, 1, stride))
            cin = cout
    c = m["fpn_channels"]
    for k, s in enumerate(m["fpn_stages"], start=1):
        out.append((f"fpn.output{k}.0", f"fpn.output{k}.1", _stage_out(m, s), c, 1, 1))
    out += [("fpn.merge1.0", "fpn.merge1.1", c, c, 3, 1), ("fpn.merge2.0", "fpn.merge2.1", c, c, 3, 1)]
    for k in range(1, len(m["fpn_stages"]) + 1):
        for name, cin_, cout in zip(SSH_CONVS, (c, c, c // 4, c // 4, c // 4),
                                    (c // 2, c // 4, c // 4, c // 4, c // 4)):
            out.append((f"ssh{k}.{name}.0", f"ssh{k}.{name}.1", cin_, cout, 3, 1))
    return out


def param_spec(dan: Dict) -> List[Tuple[str, Tuple[int, ...], object]]:
    """[(state_dict name, shape, kind)] for weights.make_weights: every conv
    kernel "he" (He-normal by fan-in), every head bias "zero"."""
    m = dan["model"]
    spec: List = [(f"{conv}.weight", (co, ci, k, k), "he")
                  for conv, _, ci, co, k, _ in conv_bn_layers(m)]
    a = m["anchors_per_position"]
    for name, width in HEADS:
        for lvl in range(len(m["fpn_stages"])):
            co = a * (2 * m["num_landmarks"] if name == "LandmarkHead" else width)
            spec.append((f"{name}.{lvl}.conv1x1.weight", (co, m["fpn_channels"], 1, 1), "he"))
            spec.append((f"{name}.{lvl}.conv1x1.bias", (co,), "zero"))
    return spec


def bn_params(dan: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every BN's weight (near 1, near RESIDUAL_SCALE for a bn3) and bias
    (near 0) from one normal draw of the seed's own stream, in layer order;
    running_mean 0 and running_var 1 until `calibrate` sets them."""
    layers = conv_bn_layers(dan["model"])
    total = sum(2 * co for _, _, _, co, _, _ in layers)
    flat = torch.randn(total, generator=generator(seed, device, BN_STREAM), device=device)
    out, at = {}, 0
    for _, bn, _, co, _, _ in layers:
        scale = RESIDUAL_SCALE if bn.endswith(".bn3") else 1.0
        out[f"{bn}.weight"] = scale * (1.0 + BN_SCALE_STD * flat[at:at + co])
        out[f"{bn}.bias"] = BN_SCALE_STD * flat[at + co:at + 2 * co]
        out[f"{bn}.running_mean"] = torch.zeros(co, device=device)
        out[f"{bn}.running_var"] = torch.ones(co, device=device)
        at += 2 * co
    return out


def _conv(x, w, b=None, stride=1, quant: Quant = None):
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv2d(x, w, b, stride, w.shape[-1] // 2)


class _Net:
    """One pass over the parameters: conv + BN (+ ReLU) by name; with
    `stats` a dict, each BN first takes its input's batch mean and biased
    variance over (B, H, W) as its running statistics (written into the
    parameters and into `stats`)."""

    def __init__(self, p: Dict, m: Dict, quant: Quant, stats: Optional[Dict]):
        self.p, self.eps, self.quant, self.stats = p, m["bn_eps"], quant, stats

    def __call__(self, x, conv: str, bn: str, relu: bool, stride: int = 1):
        y = _conv(x, self.p[f"{conv}.weight"], stride=stride, quant=self.quant)
        if self.stats is not None:
            var, mean = torch.var_mean(y.double(), dim=(0, 2, 3), unbiased=False)
            self.p[f"{bn}.running_mean"], self.p[f"{bn}.running_var"] = mean.float(), var.float()
            self.stats[bn] = (mean.float(), var.float())
        y = F.batch_norm(y, self.p[f"{bn}.running_mean"], self.p[f"{bn}.running_var"],
                         self.p[f"{bn}.weight"], self.p[f"{bn}.bias"], False, 0.0, self.eps)
        return F.relu(y) if relu else y


def body(net: _Net, m: Dict, x: torch.Tensor) -> List[torch.Tensor]:
    """x (B, 3, H, W) -> the outputs of the stages m["fpn_stages"]."""
    x = F.max_pool2d(net(x, "body.conv1", "body.bn1", True, 2), 3, 2, 1)
    taps = []
    for i, (n, _) in enumerate(zip(m["stage_blocks"], m["stage_widths"]), start=1):
        for j in range(n):
            p, stride = f"body.layer{i}.{j}", (2 if i > 1 and j == 0 else 1)
            identity = (net(x, f"{p}.downsample.0", f"{p}.downsample.1", False, stride)
                        if j == 0 else x)
            y = net(x, f"{p}.conv1", f"{p}.bn1", True)
            y = net(y, f"{p}.conv2", f"{p}.bn2", True, stride)
            x = F.relu(net(y, f"{p}.conv3", f"{p}.bn3", False) + identity)
        if i in m["fpn_stages"]:
            taps.append(x)
    return taps


def fpn(net: _Net, taps: List[torch.Tensor]) -> List[torch.Tensor]:
    o1, o2, o3 = (net(t, f"fpn.output{k}.0", f"fpn.output{k}.1", True)
                  for k, t in enumerate(taps, start=1))
    o2 = net(o2 + F.interpolate(o3, size=o2.shape[2:], mode="nearest"), "fpn.merge2.0",
             "fpn.merge2.1", True)
    o1 = net(o1 + F.interpolate(o2, size=o1.shape[2:], mode="nearest"), "fpn.merge1.0",
             "fpn.merge1.1", True)
    return [o1, o2, o3]


def ssh(net: _Net, k: int, x: torch.Tensor) -> torch.Tensor:
    def cb(t, name, relu):
        return net(t, f"ssh{k}.{name}.0", f"ssh{k}.{name}.1", relu)

    a = cb(x, "conv3X3", False)
    m = cb(x, "conv5X5_1", True)
    b = cb(m, "conv5X5_2", False)
    c = cb(cb(m, "conv7X7_2", True), "conv7x7_3", False)
    return F.relu(torch.cat([a, b, c], dim=1))


def forward(p: Dict, dan: Dict, x: torch.Tensor, quant: Quant = None,
            stats: Optional[Dict] = None):
    """(B, H, W, 3) mean-subtracted float32 -> (cls (B, A, 2), loc (B, A, 4),
    landm (B, A, 2K)), anchors position-major and size-minor."""
    m = dan["model"]
    net = _Net(p, m, quant, stats)
    feats = fpn(net, body(net, m, x.permute(0, 3, 1, 2).contiguous()))
    feats = [ssh(net, k, f) for k, f in enumerate(feats, start=1)]
    outs = []
    for name, width in HEADS:
        width = 2 * m["num_landmarks"] if name == "LandmarkHead" else width
        per = []
        for lvl, f in enumerate(feats):
            y = _conv(f, p[f"{name}.{lvl}.conv1x1.weight"], p[f"{name}.{lvl}.conv1x1.bias"],
                      quant=quant)
            per.append(y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, width))
        outs.append(torch.cat(per, dim=1).float())
    return tuple(outs)


@torch.no_grad()
def calibrate(p: Dict, dan: Dict, x: torch.Tensor) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Set every BN's running statistics, in place in `p`, to the batch
    statistics of its input over x (normalized (B, H, W, 3)), layer by
    layer in one float32 pass, as a trained network's BN would hold them
    for these images; -> {BN name: (mean, var)}."""
    stats: Dict = {}
    forward(p, dan, x, stats=stats)
    return stats


def anchors(dan: Dict, h: int, w: int, device) -> torch.Tensor:
    """(A, 4) float32 centre-format anchors in pixels: at each level every
    size of min_sizes at each position (row-major), size-minor."""
    a = dan["anchors"]
    out = []
    for step, sizes in zip(a["steps"], a["min_sizes"]):
        fh, fw = -(-h // step), -(-w // step)
        for i in range(fh):
            for j in range(fw):
                for s in sizes:
                    out.append(((j + a["offset"]) * step, (i + a["offset"]) * step, s, s))
    return torch.tensor(np.asarray(out, np.float32), device=device)


def decode_landmarks(landm: torch.Tensor, anc: torch.Tensor, prior) -> torch.Tensor:
    """x = l_x * v0 * w + cx, y = l_y * v1 * h + cy, (x, y) pairs in order."""
    acx, acy, aw, ah = (t[:, None] for t in anc.unbind(-1))
    x = landm[..., 0::2] * float(prior[0]) * aw + acx
    y = landm[..., 1::2] * float(prior[1]) * ah + acy
    return torch.stack([x, y], dim=-1).flatten(-2)


def postprocess(cls, loc, landm, dan: Dict, h: int, w: int) -> Dict:
    """The detect tail: softmax, decode clipped to (h, w), the score and
    degenerate-box filter, the stable pre-NMS top-k, greedy NMS
    (`reference.detect.nms_rank`), the fixed rows, and each kept box's
    decoded landmarks (zero in empty slots)."""
    post = dan["postprocess"]
    anc = anchors(dan, h, w, cls.device)
    scores = torch.softmax(cls, dim=-1)[..., 1]
    boxes = ref_detect.decode(loc, anc, dan["anchors"]["prior_scaling"], float(h), float(w))
    lm = decode_landmarks(landm, anc, dan["anchors"]["prior_scaling"])
    bw, bh = boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1]
    keep = (scores >= post["score_threshold"]) & (bw > 1.0) & (bh > 1.0)
    scores = torch.where(keep, scores, 0.0)
    k = min(post["pre_nms_topk"], scores.shape[-1])
    order = torch.sort(-scores, dim=-1, stable=True).indices[..., :k]

    def rows(t, idx):
        return torch.gather(t, -2, idx[..., None].expand(*idx.shape, t.shape[-1]))

    boxes, scores, lm = rows(boxes, order), torch.gather(scores, -1, order), rows(lm, order)
    max_out = post["max_detections"]
    rank = ref_detect.nms_rank(boxes, scores, post["nms_iou_threshold"], max_out)
    key = torch.where(rank >= 0, rank, max_out)
    key_s, pick = torch.sort(key, dim=-1, stable=True)
    n = min(max_out, k)
    key_s, pick = key_s[..., :n], pick[..., :n]
    valid = key_s < max_out
    det = {"bboxes": torch.where(valid[..., None], rows(boxes, pick), 0.0),
           "scores": torch.where(valid, torch.gather(scores, -1, pick), 0.0), "valid": valid,
           "landmarks": torch.where(valid[..., None], rows(lm, pick), 0.0)}
    if n < max_out:
        det = {k2: torch.cat([v, v.new_zeros((v.shape[0], max_out - n, *v.shape[2:]))], 1)
               for k2, v in det.items()}
    return det


def mismatched_rows(got: Dict, want: Dict) -> int:
    """Detection slots of `got` that differ from `want`: a valid flag, a
    score, a box coordinate or a landmark coordinate (rows compared where
    either is valid)."""
    v_g, v_w = got["valid"].bool(), want["valid"].bool()
    either = v_g | v_w
    bad = v_g != v_w
    bad |= either & (got["scores"].float() != want["scores"].float())
    for key in ("bboxes", "landmarks"):
        bad |= either & (got[key].float() != want[key].float()).any(-1)
    return int(bad.sum())
