"""Post-training int8 quantization of the detect path (counterpart of
dan_tpu/quant.py): the deployment mode behind `Detector.quantize_int8`.

    scales = calibrate_act_scales(model, batches, config.model)
    qdet = QuantizedDetector(model, scales)         # int8 body, bf16 rest
    cls_logits, loc_preds = qdet(images)            # as DANDetector(images)

The scheme is the JAX package's, symmetric and per channel on both sides:
  * activations: a per-channel scale s_a[ci] (absmax / 127 over
    calibration images) folds into the consuming conv's kernel before the
    kernel is quantized (w~ = w * s_a[ci]), so a conv's input is quantized
    by one multiply with 1 / s_a (computed once, in float32) and its output
    dequantized by one per-output-channel vector;
  * kernels: per output channel, scale = absmax / 127 of the folded kernel;
  * every body conv runs s8 x s8 -> s32 with the epilogue fused in
    (ops/conv_i8_cuda.py: dequant, bias, relu, then the tap in the compute
    dtype and/or the s8 input of the next conv); conv7_2 emits only its tap;
  * max pools run on int8 (round(relu(y) / s) is monotone in y, so pool
    and quantize commute); an odd size pads with -128 (TF 'SAME');
  * the packed conv1 block keeps conv1_1' in the compute dtype (its relu
    and quantize one pass, ops/quantize_i8_cuda.py) and quantizes the
    packed 2x2 conv1_2' (its own dequant vector `k2_deq`; bias
    and the next scale tiled x4 and shared by the four phase groups, so the
    phase max can run on the requantized int8, inside the conv's own launch:
    `conv_i8(..., phase_max=True)` writes pool1); odd sizes take conv1 in the
    compute dtype, then the pool, then quantize;
  * LFPN, L2Norm and the heads stay in the compute dtype: the
    `QuantizedDetector` reuses the float model's own submodules.
Rounding is half to even and clipping to +-127 (never -128), as in JAX;
kernels are quantized by true division k / s.

Activations of the int8 body are NHWC int8, the kernel's layout; the taps
go to the LFPN as NCHW views.  The public functions keep the JAX package's
layout where it can be compared: scale vectors by channel, names as in
`act_scale_names`; int8 kernels are (Co, kh, kw, Ci), JAX's (kh, kw, Ci, Co)
transposed.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dan_tpu_torch.config import ModelConfig
from dan_tpu_torch.models.detector import DANDetector, compute_dtype, heads_forward
from dan_tpu_torch.models.layers import max_pool
from dan_tpu_torch.models.vgg import TAP_NAMES, VGG_BLOCKS, nhwc, phase_pool
from dan_tpu_torch.ops.conv_i8 import Padding, phase_max_i8, same_padding_2d  # noqa: F401
from dan_tpu_torch.ops.conv_i8_cuda import conv_i8, packed_zeros_hold
from dan_tpu_torch.ops.quantize_i8_cuda import quantize_i8
from dan_tpu_torch.utils.profiling import span


def body_plan(config: ModelConfig) -> List[Tuple[str, int, int, bool, bool]]:
    """The quantized body's conv order after the conv1 block:
    (name, stride, dilation, is_tap, pool_after) per conv."""
    plan: List[Tuple[str, int, int, bool, bool]] = []
    for block in VGG_BLOCKS[1:]:
        for i, (name, _) in enumerate(block):
            plan.append((name, 1, 1, name in TAP_NAMES, i == len(block) - 1))
    plan.append(("fc6", 1, config.fc6_dilation, False, False))
    plan.append(("fc7", 1, 1, True, False))
    for i in range(6, 6 + len(config.extra_channels)):
        plan.append((f"conv{i}_1", 1, 1, False, False))
        plan.append((f"conv{i}_2", 2, 1, f"conv{i}_2" in TAP_NAMES, False))
    return plan


def act_scale_names(config: ModelConfig) -> List[str]:
    """Every activation-scale key, named for the conv that CONSUMES the
    activation ('conv1_2' = relu(conv1_1'), 'conv2_1' = pool1, other body
    convs = the predecessor's relu output)."""
    return ["conv1_2"] + [n for n, *_ in body_plan(config)]


def reciprocal(scale: torch.Tensor) -> torch.Tensor:
    """1 / scale by true float32 division (JAX's `1.0 / scale`)."""
    return torch.ones_like(scale) / scale


def quantize_act(y: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """float32 activation (..., C) -> symmetric int8, by a multiply with the
    float32 reciprocal of the per-channel (C,) (or scalar) scale."""
    q = torch.round(y * reciprocal(scale.to(torch.float32)))
    return q.clamp_(-127, 127).to(torch.int8)


def quantize_kernel(
    k: torch.Tensor, act_scale: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 (Co, Ci, kh, kw) kernel -> (int8 (Co, kh, kw, Ci) kernel, (Co,)
    float32 per-channel scale).  act_scale: the (Ci,) per-input-channel
    activation scale folded in before the absmax, so the returned scale
    also holds the activation side and the dequant stays one vector."""
    k = k.detach().to(torch.float32)
    if act_scale is not None:
        k = k * act_scale.to(torch.float32)[None, :, None, None]
    amax = k.abs().amax(dim=(1, 2, 3)).clamp_min(1e-12)
    s = amax / torch.tensor(127.0, dtype=torch.float32, device=k.device)
    q = torch.round(k / s[:, None, None, None]).clamp_(-127, 127).to(torch.int8)
    return q.permute(0, 2, 3, 1).contiguous(), s


def max_pool_i8(q: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool of an int8 NHWC tensor, TF 'SAME' (an odd size pads
    its far edge with -128): the max of four strided views."""
    _, h, w, _ = q.shape
    if h % 2 or w % 2:
        q = F.pad(q, (0, 0, 0, w % 2, 0, h % 2), value=-128)
    m = torch.maximum(torch.maximum(q[:, 0::2, 0::2], q[:, 0::2, 1::2]),
                      torch.maximum(q[:, 1::2, 0::2], q[:, 1::2, 1::2]))
    return m.contiguous()


def _packed(config: ModelConfig, h: int, w: int) -> bool:
    return config.conv1_packed and h % 2 == 0 and w % 2 == 0


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def _absmax(v: torch.Tensor) -> torch.Tensor:
    """Per-channel absmax of an NCHW tensor, float32 (C,)."""
    return v.float().abs().amax(dim=(0, 2, 3))


@torch.inference_mode()
def collect_act_absmax(
    model: DANDetector, x: torch.Tensor, config: ModelConfig
) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """One forward of the float backbone over normalized (B, H, W, 3) images
    in the compute dtype -> (the six taps (NCHW), {scale name: per-channel
    absmax float32 (C,)}).  It mirrors the backbone's inference forward, so
    its taps equal the backbone's bit for bit."""
    bb = model.backbone
    stats: Dict[str, torch.Tensor] = {}
    taps: Dict[str, torch.Tensor] = {}
    y = x.to(compute_dtype(config)).permute(0, 3, 1, 2)
    if _packed(config, y.shape[2], y.shape[3]):
        o1_pre, k2, b2 = bb.conv1_1_packed(y)
        o1 = F.relu(o1_pre)
        stats["conv1_2"] = _absmax(o1)
        y = phase_pool(F.conv2d(o1, k2, padding=1), b2)
    else:
        y = bb.conv1_1(y)
        stats["conv1_2"] = _absmax(y)
        y = max_pool(bb.conv1_2(y))
    stats["conv2_1"] = _absmax(y)
    plan = body_plan(config)
    for (name, _, _, is_tap, pool_after), nxt in zip(plan, plan[1:] + [None]):
        y = getattr(bb, name)(y)
        if is_tap:
            taps[name] = y
        if nxt is not None:
            stats[nxt[0]] = _absmax(y)
        if pool_after:
            y = max_pool(y)
    return taps, stats


def calibrate_act_scales(
    model: DANDetector, batches: Iterable[torch.Tensor], config: ModelConfig
) -> Dict[str, np.ndarray]:
    """The stats forward over normalized image batches ((B, H, W, 3) each,
    in the compute dtype) -> per-channel activation scales {name: (C,)
    float32 absmax / 127}, the running max kept in float64 as in JAX."""
    running: Dict[str, np.ndarray] = {}
    n = 0
    for x in batches:
        for k, v in collect_act_absmax(model, x, config)[1].items():
            v = v.cpu().numpy().astype(np.float64)
            running[k] = v if k not in running else np.maximum(running[k], v)
        n += 1
    if n == 0:
        raise ValueError("calibration needs at least one batch")
    return {k: (np.maximum(v, 1e-8) / 127.0).astype(np.float32) for k, v in running.items()}


# ---------------------------------------------------------------------------
# parameter quantization
# ---------------------------------------------------------------------------


@torch.no_grad()
def quantize_detector_params(
    model: DANDetector, config: ModelConfig, act_scales
) -> Dict:
    """The int8 inference parameters, as dan_tpu/quant.py's
    quantize_detector_params lays them out: {'act': {name: (C,) scale},
    'inv': {name: (C,) float32 1 / scale}, 'conv1': {'k1p', 'b1' (packed
    conv1_1'), 'k2q', 'k2_deq', 'b2' (packed conv1_2')}, 'body': {name:
    {'kq', 'deq', 'bias'}}}, on the model's device."""
    missing = [k for k in act_scale_names(config) if k not in act_scales]
    if missing:
        raise ValueError(f"act_scales missing keys: {missing}")
    bb = model.backbone
    dev = bb.conv1_1.weight.device
    act = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
           for k, v in act_scales.items()}
    k1p, b1, k2p = bb.packed_kernels()
    k2q, k2s = quantize_kernel(k2p, act["conv1_2"])
    q: Dict = {
        "act": act,
        "inv": {k: reciprocal(v) for k, v in act.items()},
        "conv1": {
            "k1p": k1p.detach().float(),
            "b1": b1.detach().float(),
            "k2q": k2q,
            "k2_deq": k2s,
            "b2": bb.conv1_2.bias.detach().float(),
        },
        "body": {},
    }
    for name, *_ in body_plan(config):
        conv = getattr(bb, name)
        kq, s = quantize_kernel(conv.weight, act[name])
        q["body"][name] = {"kq": kq, "deq": s, "bias": conv.bias.detach().float()}
    return q


# ---------------------------------------------------------------------------
# quantized forward
# ---------------------------------------------------------------------------


class QuantConv(nn.Module):
    """One int8 conv: the kernel and its epilogue vectors as buffers.
    inv_next None: the last conv, which emits only its tap.  phase_max: the
    packed conv1_2', whose next input is pool1, its phase max (one launch);
    its kernel's packed zeros are checked here, once."""

    def __init__(self, kq, deq, bias, inv_next, stride=1, dilation=1,
                 padding: Optional[Padding] = None, phase_max: bool = False):
        super().__init__()
        if phase_max and not packed_zeros_hold(kq):
            raise ValueError("phase_max takes a packed conv1_2' kernel: zero wherever "
                             "models/vgg.py::pack_conv_kernel_2x2_phase leaves zeros")
        self.phase_max = phase_max
        self.register_buffer("kq", kq)
        self.register_buffer("deq", deq)
        self.register_buffer("bias", bias)
        self.register_buffer("inv_next", inv_next)
        self.stride, self.dilation, self.padding = stride, dilation, padding

    def padding_for(self, q8: torch.Tensor) -> Padding:
        """(top, bottom, left, right): the fixed padding, else TF 'SAME'."""
        _, kh, kw, _ = self.kq.shape
        return self.padding or same_padding_2d(q8.shape[1], q8.shape[2], kh, kw,
                                               self.stride, self.dilation)

    def forward(self, q8: torch.Tensor, tap_dtype: Optional[torch.dtype] = None):
        """int8 NHWC input -> (tap (NHWC, tap_dtype) or None, int8 next input or None)."""
        out = conv_i8(q8, self.kq, self.deq, self.bias, self.inv_next, self.stride,
                      self.dilation, self.padding_for(q8), tap_dtype, phase_max=self.phase_max)
        return out.tap, out.q


class QuantizedDetector(nn.Module):
    """DANDetector's int8-body twin (dan_tpu/quant.py::quantized_detector_forward):
    (B, H, W, 3) normalized images -> (cls_logits (B, A, 2) f32, loc_preds
    (B, A, 4) f32).  Built from a float model and activation scales; it
    shares the model's conv1_1 / conv1_2 (the odd-size path), LFPN, L2Norm
    and heads, which run in the compute dtype."""

    def __init__(self, model: DANDetector, act_scales):
        super().__init__()
        config = self.config = model.config
        qp = quantize_detector_params(model, config, act_scales)
        self.plan = body_plan(config)
        c1, inv = qp["conv1"], qp["inv"]
        self.register_buffer("k1p", c1["k1p"])
        self.register_buffer("b1", c1["b1"])
        self.register_buffer("inv_conv1_2", inv["conv1_2"])
        self.register_buffer("inv_conv2_1", inv["conv2_1"])
        self.conv12 = QuantConv(c1["k2q"], c1["k2_deq"], c1["b2"].repeat(4),
                                inv["conv2_1"].repeat(4), padding=(1, 1, 1, 1), phase_max=True)
        self.body = nn.ModuleDict()
        for (name, stride, dilation, _, _), nxt in zip(self.plan, self.plan[1:] + [None]):
            lw = qp["body"][name]
            self.body[name] = QuantConv(lw["kq"], lw["deq"], lw["bias"],
                                        None if nxt is None else inv[nxt[0]], stride, dilation)
        self.conv1_1 = model.backbone.conv1_1
        self.conv1_2 = model.backbone.conv1_2
        self.lfpn = model.lfpn
        self.heads = model.heads
        self.l2norm = model.l2norm

    def conv1_block(self, x: torch.Tensor, record: Optional[Dict] = None) -> torch.Tensor:
        """(B, 3, H, W) in the compute dtype -> pool1 as int8 NHWC, the input
        of conv2_1."""
        if _packed(self.config, x.shape[2], x.shape[3]):
            o1_pre = F.conv2d(F.pad(x, (1, 2, 1, 2)), self.k1p.to(x.dtype), self.b1.to(x.dtype),
                              stride=2)
            q8 = quantize_i8(nhwc(o1_pre), self.inv_conv1_2)  # relu fused in
            if record is not None:
                record["conv1_2"] = q8
            return self.conv12(q8)[1]
        y = max_pool(self.conv1_2(self.conv1_1(x)))
        return quantize_i8(nhwc(y), self.inv_conv2_1)

    def backbone(self, x: torch.Tensor, record: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """(B, H, W, 3) -> the six taps (NCHW views of NHWC tensors, compute
        dtype).  record: a dict that receives each conv's int8 input by
        conv name ('conv1_2' is the packed conv1_2')."""
        dt = compute_dtype(self.config)
        x = x.to(dt).permute(0, 3, 1, 2)
        q8 = self.conv1_block(x, record)
        taps: Dict[str, torch.Tensor] = {}
        for name, _, _, is_tap, pool_after in self.plan:
            if record is not None:
                record[name] = q8
            tap, q8 = self.body[name](q8, dt if is_tap else None)
            if is_tap:
                taps[name] = tap.permute(0, 3, 1, 2)
            if pool_after:
                q8 = max_pool_i8(q8)
        return taps

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with span("dan.model.backbone"):
            taps = self.backbone(images)
        with span("dan.model.lfpn"):
            taps = self.lfpn(taps)
        return heads_forward(self, taps)
