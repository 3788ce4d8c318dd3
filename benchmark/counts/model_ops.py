"""Operations and bytes of the detector's layers, counted from the layer
shapes of the configuration (never from a run).

    forward_ops(dan, size)          # {precision: operations} of one image's forward
    conv12_wgrad_least_s(dan, b)    # K6's least time at batch b
    conv_i8_least_s(dan, b)         # the 18 int8 body convolutions' least time

A convolution costs 2 x Ho x Wo x Co x Ci x kh x kw operations (one
multiply and one add a tap); the conv1 block is counted as the 3x3 pair it
computes, whatever packing runs it.  Elementwise passes are not counted.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.counts.peaks import least_seconds
from benchmark.reference import model as ref


def _out(size: int, stride: int) -> int:
    return -(-size // stride)


def conv_layers(dan: Dict, size: int) -> List[Tuple[str, str, int, int, int, int, int]]:
    """Every convolution of the forward at a square input of `size`:
    (name, part, hi, ho, ci, co, k) with part 'body' (conv1_2 to conv7_2),
    'conv1_1', 'lfpn' or 'heads'."""
    m = dan["model"]
    out, s = [], size
    taps = {}
    pools_after = {blk[-1][0] for blk in ref.VGG_BLOCKS}
    for name, ci, co, k, stride, _ in ref.body_convs(m):
        ho = _out(s, stride)
        out.append((name, "conv1_1" if name == "conv1_1" else "body", s, ho, ci, co, k))
        s = ho
        if name in ref.TAPS:
            taps[name] = s
        if name in pools_after:
            s = _out(s, 2)
    for name, ci, co in ref.lfpn_convs(m):
        lo = name.split("_", 2)[2]
        hw = taps[lo] if name.startswith("lfpn_lat") else taps[{"conv5_3": "fc7", "conv4_3": "conv5_3",
                                                                "conv3_3": "conv4_3"}[lo]]
        out.append((name, "lfpn", hw, hw, ci, co, 1))
    ch = ref.tap_channels(m)
    for i, name in enumerate(ref.TAPS):
        co = ref.head_classes(m, i) + 4
        out.append((f"head_{name}", "heads", taps[name], taps[name], ch[name], co, 3))
    return out


def conv_ops(ho: int, ci: int, co: int, k: int) -> int:
    return 2 * ho * ho * co * ci * k * k


def forward_ops(dan: Dict, size: int, int8_body: bool = False) -> Dict[str, int]:
    """{precision: operations} of one image's forward at `size`: everything
    in the model's compute dtype, or the body convolutions in int8."""
    compute = dan["model"]["compute_dtype"]
    ops = {compute: 0, "int8": 0}
    for _, part, _, ho, ci, co, k in conv_layers(dan, size):
        ops["int8" if int8_body and part == "body" else compute] += conv_ops(ho, ci, co, k)
    return ops


def config_forward_ops(config: Dict, size: int) -> Dict[str, int]:
    """forward_ops of a configuration file: its int8 body where its
    precision is int8."""
    return forward_ops(config["dan"], size, int8_body=config["precision"] == "int8")


def conv12_wgrad_least_s(dan: Dict, batch: int) -> float:
    """K6, the packed conv1_2' weight gradient at a train batch: reads the
    relu'd conv1_1' output (B, S/2, S/2, 4*64) and the output gradient
    (B, S/2+1, S/2+1, 4*64) in the compute dtype once, writes the float32
    (256, 256, 2, 2) gradient once; 2 x B x (S/2)^2 x 4 x 256 x 256
    operations at the compute dtype's peak."""
    compute = dan["model"]["compute_dtype"]
    size = 2 if compute == "bfloat16" else 4
    h = dan["preprocess"]["train_image_size"] // 2
    c = 4 * 64
    n_bytes = batch * h * h * c * size + batch * (h + 1) * (h + 1) * c * size + 4 * c * c * 4
    return least_seconds(n_bytes, 2 * batch * h * h * 4 * c * c, compute)


def conv_i8_least_s(dan: Dict, batch: int) -> float:
    """The int8 body's 18 convolutions at a batch: per layer the larger of
    its operations at the int8 peak and its bytes (the int8 input and
    kernel, 12 bytes a channel of epilogue vectors, the bfloat16 tap where
    the layer is a tap, the int8 output where a layer follows; conv1_2
    writes pool1), summed over the layers."""
    size = dan["model"]["image_size"]
    body = [c for c in conv_layers(dan, size) if c[1] == "body"]
    total = 0.0
    for i, (name, _, hi, ho, ci, co, k) in enumerate(body):
        out = 0
        if name in ref.TAPS:
            out += batch * ho * ho * co * 2
        if i + 1 < len(body):
            side = _out(ho, 2) if name == "conv1_2" else ho
            out += batch * side * side * co
        n_bytes = batch * hi * hi * ci + co * k * k * ci + 12 * co + out
        total += least_seconds(n_bytes, batch * conv_ops(ho, ci, co, k), "int8")
    return total
