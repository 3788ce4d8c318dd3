"""TF1 checkpoint importer (counterpart of dan_tpu/ckpt/tf_import.py): maps
the TF-slim-style variable names of a V2 bundle onto the detector's
parameters, read through ckpt/tf_bundle.py, so neither TensorFlow nor JAX
is needed.

TF conv kernels are HWIO, the JAX package's layout, so the map is a
renaming; the result is a parameter tree in that layout with numpy leaves,
which `ckpt.bridge.params_from_jax` turns into a state_dict (the one place
the OIHW transpose lives).  The name rules, the slot and bookkeeping skips
and the VGG-16 classifier fc6/fc7 subsampling are copies of the JAX
package's, so both packages place the same variables.

Leaves the checkpoint does not cover get the JAX package's init,
`init_detector_params(PRNGKey(0))`, as its importer gives them: drawn in
numpy by models/reference_init.py, only for those leaves (the bits exactly,
a kernel within 4 ulp of JAX's).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from dan_tpu_torch.ckpt.tf_bundle import BundleReader, write_bundle
from dan_tpu_torch.config import ModelConfig
from dan_tpu_torch.models.reference_init import reference_specs

# (regex on the TF variable name) -> (params section, layer key, leaf key).
# Applied in order; first match wins.  {m} groups substitute into targets.
NAME_RULES: List[Tuple[str, Tuple[str, str, Optional[str]]]] = [
    # LFPN first: its names embed tap names like 'conv3_3/weights' that the
    # flat backbone rule would otherwise hijack (rules are first-match).
    (r"lfpn.*?td.*?(conv\d+_\d+)/(weights|biases)$", ("lfpn", r"lfpn_td_\1", None)),
    (r"lfpn.*?lat.*?(conv\d+_\d+)/(weights|biases)$", ("lfpn", r"lfpn_lat_\1", None)),
    # vgg_16/conv3/conv3_3/weights -> backbone.conv3_3.kernel
    (
        r"(?:vgg_16/)?conv\d+/(conv\d+_\d+)/(weights|biases)$",
        ("backbone", r"\1", None),
    ),
    # flat variant: vgg_16/conv3_3/weights
    (r"(?:vgg_16/)?(conv[1-5]_\d+)/(weights|biases)$", ("backbone", r"\1", None)),
    # fc6/fc7 as convs
    (r"(?:vgg_16/)?(fc[67])/(weights|biases)$", ("backbone", r"\1", None)),
    # extra SSD layers: conv6_1, conv6_2, conv7_1, conv7_2 (any scope)
    (r"(conv[67]_[12])/(weights|biases)$", ("backbone", r"\1", None)),
    # L2Norm scales: conv3_3_norm/gamma | .../scale
    (r"(conv\d+_\d+)_(?:l2_)?norm/(?:gamma|scale)$", ("l2norm", r"\1", "scale")),
    # multibox heads: conv3_3_norm_mbox_conf/weights, fc7_mbox_loc/biases, ...
    (
        r"(conv\d+_\d+|fc7)(?:_norm)?_mbox_conf/(weights|biases)$",
        ("heads", r"cls_\1", None),
    ),
    (
        r"(conv\d+_\d+|fc7)(?:_norm)?_mbox_loc/(weights|biases)$",
        ("heads", r"loc_\1", None),
    ),
]

_LEAF = {"weights": "kernel", "biases": "bias"}

_SKIP_EXACT = {
    "global_step",
    "beta1_power",
    "beta2_power",
    "save_counter",
}


def _strip_name(name: str) -> str:
    """Drop optimizer slots and bookkeeping vars that don't carry identity."""
    name = name.split(":")[0]
    if name in _SKIP_EXACT:
        return ""
    for suffix in ("/Momentum", "/ExponentialMovingAverage", "/Adam", "/Adam_1"):
        if name.endswith(suffix):
            return ""  # optimizer slot — skip
    return name


def map_tf_name(name: str) -> Optional[Tuple[str, str, str]]:
    """TF var name -> (section, layer, leaf) or None if unmapped."""
    name = _strip_name(name)
    if not name:
        return None
    for pattern, (section, layer_t, leaf_t) in NAME_RULES:
        m = re.search(pattern, name)
        if m:
            layer = m.expand(layer_t)
            leaf = leaf_t if leaf_t else _LEAF[m.group(2)]
            return section, layer, leaf
    return None


@dataclasses.dataclass
class ImportReport:
    """What an import placed: `params` (JAX layout, numpy leaves), the
    placed (section, layer, leaf) triples, the model params left at init
    ("section/layer/leaf"), the unmapped checkpoint names and the
    mismatched ones as (name, checkpoint shape, model shape)."""

    params: Dict
    placed: set
    missing: List[str]
    unmapped: List[str]
    mismatched: List[Tuple[str, tuple, tuple]]


def import_tf_checkpoint(ckpt_path: str, model_config: ModelConfig) -> ImportReport:
    """The importer's work, without the printing and the strict check."""
    reader = BundleReader(ckpt_path)
    shapes = reader.get_variable_to_shape_map()

    specs = reference_specs(0, model_config)
    params = {section: {layer: dict.fromkeys(leaves) for layer, leaves in layers.items()}
              for section, layers in specs.items()}

    placed, unmapped, mismatched = set(), [], []
    for var_name in sorted(shapes):
        target = map_tf_name(var_name)
        if target is None:
            if _strip_name(var_name):  # bookkeeping vars skip silently
                unmapped.append(var_name)
            continue
        section, layer, leaf = target
        try:
            shape = specs[section][layer][leaf].shape
        except KeyError:
            unmapped.append(var_name)
            continue
        value = reader.get_tensor(var_name)
        if tuple(value.shape) != shape:
            adapted = _adapt_vgg_fc(value, shape, layer)
            if adapted is None:
                mismatched.append((var_name, tuple(value.shape), shape))
                continue
            value = adapted
        params[section][layer][leaf] = value.astype(np.float32)
        placed.add((section, layer, leaf))

    missing = [
        f"{section}/{layer}/{leaf}"
        for section, layers in params.items()
        for layer, leaves in layers.items()
        for leaf in leaves
        if (section, layer, leaf) not in placed
    ]
    for name in missing:
        section, layer, leaf = name.split("/")
        params[section][layer][leaf] = specs[section][layer][leaf].value()
    return ImportReport(params, placed, missing, unmapped, mismatched)


def load_tf_checkpoint(
    ckpt_path: str,
    model_config: ModelConfig,
    strict: bool = False,
    verbose: bool = True,
) -> Dict:
    """Read a TF checkpoint prefix into a parameter tree in the JAX
    package's layout (numpy leaves).

    Missing model params get the JAX package's PRNGKey(0) init (warm-start
    semantics, models/reference_init.py);
    unmapped checkpoint vars are reported.  strict=True raises if any MODEL
    param was left unplaced or any shape mismatched; unmapped
    checkpoint-side extras alone never fail strict mode (TF1 checkpoints
    always carry bookkeeping vars)."""
    r = import_tf_checkpoint(ckpt_path, model_config)
    if verbose:
        print(
            f"[tf_import] placed {len(r.placed)} params; "
            f"{len(r.missing)} model params left at init; "
            f"{len(r.unmapped)} ckpt vars unmapped; "
            f"{len(r.mismatched)} shape-mismatched"
        )
        for v in r.unmapped[:20]:
            print(f"[tf_import]   unmapped: {v}")
        for v in r.missing[:20]:
            print(f"[tf_import]   missing: {v}")
        for v, got, want in r.mismatched[:20]:
            print(f"[tf_import]   mismatch: {v} ckpt{got} != model{want}")
    if strict and (r.missing or r.mismatched):
        raise ValueError(
            f"strict import failed: {len(r.missing)} model params unplaced, "
            f"{len(r.mismatched)} mismatched"
        )
    return r.params


def _adapt_vgg_fc(value: np.ndarray, dst_shape, layer: str):
    """SSD's fc->conv weight subsampling: when warm-starting from the VGG-16
    *classifier* ckpt, fc6 (7x7x512x4096, possibly stored dense as
    (25088, 4096)) subsamples to a 3x3x512x1024 dilated conv (spatial taps
    0/3/6, every 4th output channel) and fc7 (4096x4096) to 1x1x1024x1024.
    Returns None when the shapes aren't the classifier-fc pattern."""
    dst_shape = tuple(dst_shape)
    v = value
    if layer == "fc6":
        if v.shape == (25088, 4096):
            v = v.reshape(7, 7, 512, 4096)
        if v.ndim == 4 and v.shape == (7, 7, 512, 4096) and dst_shape[:3] == (3, 3, 512):
            taps = np.array([0, 3, 6])
            out_idx = np.arange(0, 4096, 4096 // dst_shape[3])
            return v[np.ix_(taps, taps, np.arange(512), out_idx)]
        if v.shape == (4096,) and dst_shape == (1024,):  # fc6 bias
            return v[:: 4096 // 1024]
    if layer == "fc7":
        if v.shape == (4096, 4096):
            v = v.reshape(1, 1, 4096, 4096)
        if v.ndim == 4 and v.shape == (1, 1, 4096, 4096) and dst_shape[0] == 1:
            in_idx = np.arange(0, 4096, 4096 // dst_shape[2])
            out_idx = np.arange(0, 4096, 4096 // dst_shape[3])
            return v[np.ix_([0], [0], in_idx, out_idx)]
        if v.shape == (4096,) and dst_shape == (1024,):
            return v[:: 4096 // 1024]
    return None


def tf_names(params: Dict) -> Dict[str, np.ndarray]:
    """A parameter tree (JAX layout) -> {slim-style TF name: array}, the
    names NAME_RULES maps back."""
    tf_vars = {}
    for layer, leaves in params["backbone"].items():
        block = f"conv{layer[4]}" if layer.startswith("conv") and "_" in layer else layer
        for leaf, arr in leaves.items():
            kind = "weights" if leaf == "kernel" else "biases"
            if layer.startswith("conv") and layer[4].isdigit() and int(layer[4]) <= 5:
                name = f"vgg_16/{block}/{layer}/{kind}"
            elif layer.startswith("fc"):
                name = f"vgg_16/{layer}/{kind}"
            else:
                name = f"{layer}/{kind}"
            tf_vars[name] = np.asarray(arr)
    for layer, leaves in params["l2norm"].items():
        tf_vars[f"{layer}_norm/gamma"] = np.asarray(leaves["scale"])
    for layer, leaves in params["heads"].items():
        kind_map = {"kernel": "weights", "bias": "biases"}
        tap = layer.split("_", 1)[1]
        head = "conf" if layer.startswith("cls_") else "loc"
        for leaf, arr in leaves.items():
            tf_vars[f"{tap}_mbox_{head}/{kind_map[leaf]}"] = np.asarray(arr)
    for layer, leaves in params["lfpn"].items():
        # lfpn_td_conv5_3 -> lfpn/td/conv5_3
        parts = layer.split("_")
        tap = "_".join(parts[2:])
        for leaf, arr in leaves.items():
            kind = "weights" if leaf == "kernel" else "biases"
            tf_vars[f"lfpn/{parts[1]}/{tap}/{kind}"] = np.asarray(arr)
    return tf_vars


def export_tf_checkpoint(params: Dict, ckpt_prefix: str) -> None:
    """Write a parameter tree (JAX layout, e.g. `params_to_jax(state_dict)`)
    as a TF V2 bundle with the slim-style names NAME_RULES expects, the
    names the JAX package's exporter writes; `tf.train.load_checkpoint`
    reads it."""
    write_bundle(ckpt_prefix, tf_names(params))
