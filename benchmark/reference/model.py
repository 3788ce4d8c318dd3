"""The plain reference of the DAN detector's forward: VGG-16 with the SSD
extensions, LFPN product fusion, L2Norm on the shallow taps and the
multibox heads with max-in-out, written from the architecture alone in
plain PyTorch (float32, NCHW, no kernels of the program).

    spec = param_spec(dan)                # [(name, shape, kind)]
    cls, loc = forward(params, dan, x)    # x (B, H, W, 3) mean-subtracted

`dan` is the configuration file's "dan" section (plain dicts and lists).
The parameter names are the detector's state_dict names, so one set of
seeded weights loads into both.  The conv1 block is the standard 3x3 pair
(the program runs it phase-packed, which is the same function).  `quant`
(a function of a tensor) is applied to every convolution's input and
kernel: None for the reference, a lower-precision rounding for the control.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

VGG_BLOCKS = (
    (("conv1_1", 64), ("conv1_2", 64)),
    (("conv2_1", 128), ("conv2_2", 128)),
    (("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256)),
    (("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512)),
    (("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)),
)
TAPS = ("conv3_3", "conv4_3", "conv5_3", "fc7", "conv6_2", "conv7_2")
SHALLOW = ("conv3_3", "conv4_3", "conv5_3")
# LFPN top-down order: (higher tap, lower tap).
LFPN_PAIRS = (("fc7", "conv5_3"), ("conv5_3", "conv4_3"), ("conv4_3", "conv3_3"))

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def body_convs(m: Dict) -> List[Tuple[str, int, int, int, int, int]]:
    """Every backbone conv in order: (name, cin, cout, k, stride, dilation)."""
    out, cin = [], 3
    for block in VGG_BLOCKS:
        for name, cout in block:
            out.append((name, cin, cout, 3, 1, 1))
            cin = cout
    out.append(("fc6", 512, m["fc6_channels"], 3, 1, m["fc6_dilation"]))
    out.append(("fc7", m["fc6_channels"], m["fc7_channels"], 1, 1, 1))
    cin = m["fc7_channels"]
    for i, (mid, o) in enumerate(m["extra_channels"], start=6):
        out.append((f"conv{i}_1", cin, mid, 1, 1, 1))
        out.append((f"conv{i}_2", mid, o, 3, 2, 1))
        cin = o
    return out


def tap_channels(m: Dict) -> Dict[str, int]:
    """Channels each head sees: the LFPN widths on the shallow taps."""
    raw = {"conv3_3": 256, "conv4_3": 512, "conv5_3": 512, "fc7": m["fc7_channels"],
           "conv6_2": m["extra_channels"][0][1], "conv7_2": m["extra_channels"][1][1]}
    raw.update(dict(zip(SHALLOW, m["lfpn_channels"])))
    return raw


def lfpn_convs(m: Dict) -> List[Tuple[str, int, int]]:
    """(name, cin, cout) of the LFPN's 1x1 convs, top-down."""
    width = dict(zip(SHALLOW, m["lfpn_channels"]))
    out, hi_ch = [], m["fc7_channels"]
    for _, lo in LFPN_PAIRS:
        out.append((f"lfpn_td_{lo}", hi_ch, width[lo]))
        out.append((f"lfpn_lat_{lo}", width[lo], width[lo]))
        hi_ch = width[lo]
    return out


def head_classes(m: Dict, i: int) -> int:
    if i == 0 and m["maxout_bg_size"] > 1:
        return m["maxout_bg_size"] + m["num_classes"] - 1
    return m["num_classes"]


def param_spec(dan: Dict) -> List[Tuple[str, Tuple[int, ...], object]]:
    """[(state_dict name, shape, kind)]: kind "he" for a conv kernel
    (He-normal by fan-in), "zero" for a bias, a float for an L2Norm scale
    filled with that value."""
    m = dan["model"]
    spec: List = []

    def conv(prefix, cin, cout, k):
        spec.append((f"{prefix}.weight", (cout, cin, k, k), "he"))
        spec.append((f"{prefix}.bias", (cout,), "zero"))

    for name, cin, cout, k, _, _ in body_convs(m):
        conv(f"backbone.{name}", cin, cout, k)
    for name, cin, cout in lfpn_convs(m):
        conv(f"lfpn.{name}", cin, cout, 1)
    ch = tap_channels(m)
    for i, name in enumerate(TAPS):
        conv(f"heads.cls_{name}", ch[name], head_classes(m, i), 3)
        conv(f"heads.loc_{name}", ch[name], 4, 3)
    for name, init in zip(m["l2norm_taps"], m["l2norm_init"]):
        spec.append((f"l2norm.{name}.scale", (ch[name],), float(init)))
    return spec


def same_pad(size: int, k: int, stride: int, dilation: int) -> Tuple[int, int]:
    """TF 'SAME' padding (before, after): the odd pixel goes after."""
    k_eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + k_eff - size, 0)
    return total // 2, total - total // 2


def conv(x, w, b, stride=1, dilation=1, quant: Quant = None):
    if quant is not None:
        x, w = quant(x), quant(w)
    ph = same_pad(x.shape[2], w.shape[2], stride, dilation)
    pw = same_pad(x.shape[3], w.shape[3], stride, dilation)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w.to(x.dtype), b.to(x.dtype), stride, 0, dilation)


def pool(x):
    """2x2/2 max pool, TF 'SAME' (an odd edge pads with -inf)."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def backbone(p: Dict, m: Dict, x: torch.Tensor, quant: Quant = None) -> Dict[str, torch.Tensor]:
    """x (B, 3, H, W) -> the six raw taps."""
    taps = {}
    pools_after = {blk[-1][0] for blk in VGG_BLOCKS}
    for name, _, _, _, stride, dil in body_convs(m):
        x = F.relu(conv(x, p[f"backbone.{name}.weight"], p[f"backbone.{name}.bias"], stride, dil,
                        quant))
        if name in TAPS:
            taps[name] = x
        if name in pools_after:
            x = pool(x)
    return taps


def lfpn(p: Dict, m: Dict, taps: Dict[str, torch.Tensor], quant: Quant = None):
    out = dict(taps)
    higher = taps["fc7"]
    for _, lo in LFPN_PAIRS:
        td = F.relu(conv(higher, p[f"lfpn.lfpn_td_{lo}.weight"], p[f"lfpn.lfpn_td_{lo}.bias"],
                         quant=quant))
        td = F.interpolate(td, scale_factor=2, mode="bilinear", align_corners=False)
        lat = F.relu(conv(taps[lo], p[f"lfpn.lfpn_lat_{lo}.weight"], p[f"lfpn.lfpn_lat_{lo}.bias"],
                          quant=quant))
        td = td[:, :, :lat.shape[2], :lat.shape[3]]
        fused = td * lat if m["lfpn_fuse_op"] == "product" else td + lat
        out[lo] = higher = fused
    return out


def l2norm(x, scale, eps=1e-12):
    return x * torch.rsqrt((x * x).sum(dim=1, keepdim=True) + eps) * scale[:, None, None]


def heads(p: Dict, m: Dict, taps: Dict[str, torch.Tensor], quant: Quant = None):
    cls_out, loc_out = [], []
    for i, name in enumerate(TAPS):
        x = taps[name]
        b = x.shape[0]
        c = conv(x, p[f"heads.cls_{name}.weight"], p[f"heads.cls_{name}.bias"], quant=quant)
        lo = conv(x, p[f"heads.loc_{name}.weight"], p[f"heads.loc_{name}.bias"], quant=quant)
        c, lo = c.permute(0, 2, 3, 1), lo.permute(0, 2, 3, 1)
        if i == 0 and m["maxout_bg_size"] > 1:
            k = m["maxout_bg_size"]
            c = torch.cat([c[..., :k].amax(dim=-1, keepdim=True), c[..., k:]], dim=-1)
        cls_out.append(c.reshape(b, -1, m["num_classes"]))
        loc_out.append(lo.reshape(b, -1, 4))
    return torch.cat(cls_out, 1).float(), torch.cat(loc_out, 1).float()


def forward(p: Dict, dan: Dict, x: torch.Tensor, quant: Quant = None):
    """(B, H, W, 3) mean-subtracted float32 -> (cls (B, A, C), loc (B, A, 4))."""
    m = dan["model"]
    taps = lfpn(p, m, backbone(p, m, x.permute(0, 3, 1, 2), quant), quant)
    for name in m["l2norm_taps"]:
        taps[name] = l2norm(taps[name], p[f"l2norm.{name}.scale"])
    return heads(p, m, taps, quant)


def normalize(images_u8: torch.Tensor, dan: Dict) -> torch.Tensor:
    """uint8 RGB (..., 3) -> mean-subtracted float32."""
    pre = dan["preprocess"]
    mean = torch.tensor(pre["mean_rgb"], dtype=torch.float32, device=images_u8.device)
    std = torch.tensor(pre["std_rgb"], dtype=torch.float32, device=images_u8.device)
    return (images_u8.float() - mean) / std


class float32_exact:
    """No TF32 in convolutions and matrix products while the block runs."""

    def __enter__(self):
        c, mm = torch.backends.cudnn, torch.backends.cuda.matmul
        self.prev = c.allow_tf32, mm.allow_tf32
        c.allow_tf32 = mm.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.prev
