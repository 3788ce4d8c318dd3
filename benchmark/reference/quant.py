"""The plain reference of the int8 deployment: symmetric per-channel
post-training quantization of the VGG body, as the detector's int8 mode
states it.

  * activation scales: per channel, absmax / qmax of each body conv's input
    over the calibration images (one float forward);
  * kernels: the activation scale folded in per input channel, then per
    output channel absmax / qmax, rounded half to even, clipped to +-qmax;
  * a body conv sums integer products exactly (float64), dequantizes with
    its kernel scale, adds the bias and applies the relu; its input is the
    previous output times the reciprocal of its scale, rounded and clipped;
  * conv1_1, the LFPN, L2Norm and the heads stay in float;
  * with the conv1 block phase-packed (`conv1_packed`, even sizes), conv1_2's
    input has one scale for each of the four 2x2 pixel phases of each
    channel, and its kernel one scale for each output phase and channel,
    as a quantized 2x2 conv over the packed channels has.

qmax 127 is int8; qmax 7 is the int4 control.

    scales = calibrate(params, dan, x_cal)
    cls, loc = forward(params, dan, x, scales, qmax=127)
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference import model as ref


def _body(p: Dict, m: Dict, x: torch.Tensor, step):
    """The backbone with `step(name, y_in, w, b, stride, dil)` computing
    each conv after conv1_1 -> the six taps (float32)."""
    taps = {}
    pools_after = {blk[-1][0] for blk in ref.VGG_BLOCKS}
    for name, _, _, _, stride, dil in ref.body_convs(m):
        w, b = p[f"backbone.{name}.weight"], p[f"backbone.{name}.bias"]
        x = F.relu(ref.conv(x, w, b, stride, dil)) if name == "conv1_1" else step(
            name, x, w, b, stride, dil)
        if name in ref.TAPS:
            taps[name] = x
        if name in pools_after:
            x = ref.pool(x)
    return taps


PHASES = ((0, 0), (0, 1), (1, 0), (1, 1))


def _packed(m: Dict, x: torch.Tensor) -> bool:
    return bool(m["conv1_packed"]) and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0


def _phase_absmax(y: torch.Tensor) -> torch.Tensor:
    """(4 * C,) absmax of each pixel phase of each channel, phase-major."""
    return torch.cat([y[:, :, py::2, px::2].abs().amax(dim=(0, 2, 3)) for py, px in PHASES])


@torch.no_grad()
def calibrate(p: Dict, dan: Dict, x_cal: torch.Tensor, qmax: int = 127) -> Dict[str, torch.Tensor]:
    """{body conv name: (Ci,) float32 activation scale} from one float
    forward over normalized (B, H, W, 3) calibration images."""
    scales = {}

    x = x_cal.permute(0, 3, 1, 2)
    packed = _packed(dan["model"], x)

    def step(name, y, w, b, stride, dil):
        amax = _phase_absmax(y) if packed and name == "conv1_2" else y.abs().amax(dim=(0, 2, 3))
        scales[name] = (amax.double().clamp_min(1e-8) / qmax).float()
        return F.relu(ref.conv(y, w, b, stride, dil))

    _body(p, dan["model"], x, step)
    return scales


def quantize(t: torch.Tensor, scale: torch.Tensor, qmax: int) -> torch.Tensor:
    """Kernels: true division by the scale, rounded half to even, clipped."""
    return torch.round(t / scale).clamp(-qmax, qmax)


def quantize_act(t: torch.Tensor, scale: torch.Tensor, qmax: int) -> torch.Tensor:
    """Activations: one multiply with the float32 reciprocal of the scale."""
    return torch.round(t * (torch.ones_like(scale) / scale)).clamp(-qmax, qmax)


@torch.no_grad()
def forward(p: Dict, dan: Dict, x: torch.Tensor, scales: Dict[str, torch.Tensor], qmax: int = 127):
    """(B, H, W, 3) mean-subtracted -> (cls, loc) of the int8 model (int4
    at qmax 7)."""
    m = dan["model"]
    x = x.permute(0, 3, 1, 2)
    packed = _packed(m, x)

    def step(name, y, w, b, stride, dil):
        if packed and name == "conv1_2":
            return _conv12_packed(y, w, b, scales[name].to(y.device), qmax)
        s_a = scales[name].to(y.device)
        wf = w.float() * s_a[None, :, None, None]
        s_k = wf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / qmax
        kq = quantize(wf, s_k[:, None, None, None], qmax)
        xq = quantize_act(y, s_a[None, :, None, None], qmax)
        ph = ref.same_pad(xq.shape[2], kq.shape[2], stride, dil)
        pw = ref.same_pad(xq.shape[3], kq.shape[3], stride, dil)
        acc = F.conv2d(F.pad(xq.double(), (pw[0], pw[1], ph[0], ph[1])), kq.double(),
                       stride=stride, dilation=dil)
        z = acc.float() * s_k[None, :, None, None] + b.float()[None, :, None, None]
        return F.relu(z)

    taps = _body(p, m, x, step)
    taps = ref.lfpn(p, m, taps)
    for name in m["l2norm_taps"]:
        taps[name] = ref.l2norm(taps[name], p[f"l2norm.{name}.scale"])
    return ref.heads(p, m, taps)


def _conv12_packed(y, w, b, s_phase, qmax):
    """conv1_2 (3x3, stride 1) with a scale for each input pixel phase and
    channel (s_phase (4 * Ci,)): each output phase's kernel folds the
    scales of the input phases its taps reach and takes its own per-channel
    kernel scale.  -> relu(z), (B, Co, H, W)."""
    ci = y.shape[1]
    s = s_phase.view(4, ci)
    xq = torch.empty_like(y)
    for g, (py, px) in enumerate(PHASES):
        xq[:, :, py::2, px::2] = quantize_act(y[:, :, py::2, px::2], s[g][None, :, None, None], qmax)
    xp = F.pad(xq.double(), (1, 1, 1, 1))
    out = torch.empty((y.shape[0], w.shape[0], y.shape[2], y.shape[3]), dtype=torch.float32,
                      device=y.device)
    for oy, ox in PHASES:
        fold = torch.empty((3, 3, ci), dtype=torch.float32, device=y.device)
        for dy in range(3):
            for dx in range(3):
                fold[dy, dx] = s[((oy + dy - 1) % 2) * 2 + (ox + dx - 1) % 2]
        wf = w.float() * fold.permute(2, 0, 1)[None]
        s_k = wf.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12) / qmax
        kq = quantize(wf, s_k[:, None, None, None], qmax)
        acc = F.conv2d(xp[:, :, oy:, ox:], kq.double(), stride=2)
        acc = acc[:, :, :y.shape[2] // 2, :y.shape[3] // 2]
        z = acc.float() * s_k[None, :, None, None] + b.float()[None, :, None, None]
        out[:, :, oy::2, ox::2] = F.relu(z)
    return out
