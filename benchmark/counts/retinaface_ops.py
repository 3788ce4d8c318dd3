"""Operations and bytes of RetinaFace-R50's layers, counted from the
configuration file's widths at a square input (never from a run).

    conv_layers(dan, size)      # [(name, ho, ci, co, k)] every convolution
    forward_ops(dan, size)      # operations of one image's forward
    residual_values(dan, size)  # values of the 16 bottleneck outputs of one image

A convolution costs 2 x Ho x Wo x Co x Ci x kh x kw operations (one
multiply and one add a tap); batch norm, folded into the convolutions, and
the elementwise passes are not counted.  Layer shapes come from
reference/retinaface.py's list of conv + BN pairs and the heads, each
output side ceil(input side / stride) (symmetric k // 2 padding).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from benchmark.reference import retinaface as ref


def _out(size: int, stride: int) -> int:
    return -(-size // stride)


def conv_layers(dan: Dict, size: int) -> List[Tuple[str, int, int, int, int]]:
    """Every convolution of the forward at a square input of `size`:
    (name, ho, ci, co, k), the heads' three 1x1 convs of a level each."""
    m = dan["model"]
    s = _out(size, 4)  # conv1 /2 and the max pool /2
    side = {"body.conv1": _out(size, 2)}
    stage_side = {}
    for i, n in enumerate(m["stage_blocks"], start=1):
        if i > 1:
            s = _out(s, 2)
        stage_side[i] = s
        for j in range(n):
            for part in ("conv1", "conv2", "conv3", "downsample.0"):
                hw = stage_side[i]
                if part == "conv1" and j == 0 and i > 1:
                    hw = stage_side[i - 1]  # the 1x1 before the stride
                side[f"body.layer{i}.{j}.{part}"] = hw
    levels = [stage_side[st] for st in m["fpn_stages"]]
    for k, hw in enumerate(levels, start=1):
        side[f"fpn.output{k}.0"] = hw
        for name in ref.SSH_CONVS:
            side[f"ssh{k}.{name}.0"] = hw
    side["fpn.merge1.0"], side["fpn.merge2.0"] = levels[0], levels[1]
    out = [(conv, side[conv], ci, co, k) for conv, _, ci, co, k, _ in ref.conv_bn_layers(m)]
    a = m["anchors_per_position"]
    for name, width in ref.HEADS:
        co = a * (2 * m["num_landmarks"] if name == "LandmarkHead" else width)
        for lvl, hw in enumerate(levels):
            out.append((f"{name}.{lvl}.conv1x1", hw, m["fpn_channels"], co, 1))
    return out


def conv_ops(ho: int, ci: int, co: int, k: int) -> int:
    return 2 * ho * ho * co * ci * k * k


def forward_ops(dan: Dict, size: int) -> int:
    """Operations of one image's forward at `size`, all in the compute dtype."""
    return sum(conv_ops(ho, ci, co, k) for _, ho, ci, co, k in conv_layers(dan, size))


def residual_values(dan: Dict, size: int) -> int:
    """Values of one image's bottleneck outputs (each block's conv3), the
    residual pass's work: each read once, its identity read once, written
    once."""
    return sum(ho * ho * co for name, ho, _, co, _ in conv_layers(dan, size)
               if name.startswith("body.layer") and name.endswith(".conv3"))
