"""The JAX package's parameter init (`init_detector_params(PRNGKey(seed),
config)`), in numpy, for the leaves that a partial checkpoint leaves
uncovered (ckpt/tf_import.py): the JAX importer fills them from that init,
so the port does too.

    params = init_reference_params(0, config)    # JAX layout, numpy leaves
    specs = reference_specs(0, config)           # the same tree, drawn on request
    kernel = specs["heads"]["cls_conv3_3"]["kernel"].value()

The init is He-normal conv kernels, `jax.random.normal(key, (kh, kw, cin,
cout)) * sqrt(2 / fan_in)`, zero biases and constant L2Norm scales, with
the keys split as the JAX package splits them: PRNGKey(seed) into the
backbone's, the LFPN's and the heads' keys, each of those into one key a
conv in construction order.  The bits are JAX's exactly; a normal may
differ from JAX's by up to 3 ulp (ops/threefry.py).  Detector.from_random
and create_train_state keep the port's own torch init.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from dan_tpu_torch.config import ModelConfig
from dan_tpu_torch.models.heads import _cls_channels
from dan_tpu_torch.models.lfpn import _pair_channels
from dan_tpu_torch.models.vgg import (
    TAP_NAMES,
    VGG_BLOCKS,
    effective_tap_channels,
    raw_tap_channels,
)
from dan_tpu_torch.ops import threefry


@dataclasses.dataclass(frozen=True)
class LeafInit:
    """One leaf's init: a He-normal kernel drawn from `key` with `std`, or
    (key None) a constant `fill`."""

    shape: Tuple[int, ...]
    key: Optional[threefry.Key] = None
    std: float = 0.0
    fill: float = 0.0

    def value(self) -> np.ndarray:
        if self.key is None:
            return np.full(self.shape, self.fill, np.float32)
        return threefry.normal(self.key, self.shape) * np.float32(self.std)


def _conv(key, kh: int, kw: int, cin: int, cout: int) -> Dict[str, LeafInit]:
    """layers.conv_init of the JAX package."""
    return {"kernel": LeafInit((kh, kw, cin, cout), key, (2.0 / (kh * kw * cin)) ** 0.5),
            "bias": LeafInit((cout,))}


def _backbone(key, config: ModelConfig) -> Dict:
    n_convs = sum(len(b) for b in VGG_BLOCKS) + 2 + 2 * len(config.extra_channels)
    keys = iter(threefry.split(key, n_convs))
    out, cin = {}, 3
    for block in VGG_BLOCKS:
        for name, cout in block:
            out[name] = _conv(next(keys), 3, 3, cin, cout)
            cin = cout
    out["fc6"] = _conv(next(keys), 3, 3, 512, config.fc6_channels)
    out["fc7"] = _conv(next(keys), 1, 1, config.fc6_channels, config.fc7_channels)
    cin = config.fc7_channels
    for i, (mid, cout) in enumerate(config.extra_channels, start=6):
        out[f"conv{i}_1"] = _conv(next(keys), 1, 1, cin, mid)
        out[f"conv{i}_2"] = _conv(next(keys), 3, 3, mid, cout)
        cin = cout
    return out


def _lfpn(key, config: ModelConfig) -> Dict:
    tap_ch = dict(zip(TAP_NAMES, raw_tap_channels(config)))
    pairs = _pair_channels(config)
    keys = threefry.split(key, 2 * len(pairs))
    out = {}
    for i, (hi, lo, lo_ch) in enumerate(pairs):
        hi_ch = tap_ch[hi] if i == 0 else pairs[i - 1][2]
        out[f"lfpn_td_{lo}"] = _conv(keys[2 * i], 1, 1, hi_ch, lo_ch)
        out[f"lfpn_lat_{lo}"] = _conv(keys[2 * i + 1], 1, 1, lo_ch, lo_ch)
    return out


def _heads(key, config: ModelConfig) -> Dict:
    keys = threefry.split(key, 2 * len(TAP_NAMES))
    out = {}
    for i, (name, cin) in enumerate(zip(TAP_NAMES, effective_tap_channels(config))):
        out[f"cls_{name}"] = _conv(keys[2 * i], 3, 3, cin, _cls_channels(config, i))
        out[f"loc_{name}"] = _conv(keys[2 * i + 1], 3, 3, cin, 4)
    return out


def reference_specs(seed: int, config: ModelConfig) -> Dict:
    """{section: {layer: {leaf: LeafInit}}}, the tree of
    init_detector_params(PRNGKey(seed), config), nothing drawn yet."""
    k_vgg, k_lfpn, k_heads = threefry.split(threefry.prng_key(seed), 3)
    tap_ch = dict(zip(TAP_NAMES, effective_tap_channels(config)))
    return {
        "backbone": _backbone(k_vgg, config),
        "lfpn": _lfpn(k_lfpn, config),
        "heads": _heads(k_heads, config),
        "l2norm": {name: {"scale": LeafInit((tap_ch[name],), fill=init)}
                   for name, init in zip(config.l2norm_taps, config.l2norm_init)},
    }


def init_reference_params(seed: int, config: ModelConfig) -> Dict:
    """init_detector_params(PRNGKey(seed), config) with numpy float32 leaves."""
    return {section: {layer: {leaf: spec.value() for leaf, spec in leaves.items()}
                      for layer, leaves in layers.items()}
            for section, layers in reference_specs(seed, config).items()}
