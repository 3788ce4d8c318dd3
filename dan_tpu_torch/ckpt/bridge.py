"""Parameters across the two packages, through numpy.

The JAX package keeps parameters as a nested dict of arrays:

    {'backbone': {'conv1_1': {'kernel': (kh, kw, cin, cout), 'bias': (cout,)}, ...},
     'lfpn':     {'lfpn_td_conv5_3': {...}, ...},
     'heads':    {'cls_conv3_3': {...}, 'loc_conv3_3': {...}, ...},
     'l2norm':   {'conv3_3': {'scale': (c,)}, ...}}

DANDetector's state_dict uses the same names: '<group>.<name>.weight'
(cout, cin, kh, kw), '<group>.<name>.bias' and 'l2norm.<name>.scale'.
Both directions copy values unchanged, so a round trip is bit-exact.
The optimizer's momentum (optax.trace) has the parameters' tree: it comes
across with `opt_state_from_jax` and goes back with `params_to_jax`.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_GROUPS = ("backbone", "lfpn", "heads", "l2norm")


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (numpy or array-like leaves) -> state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for group in _GROUPS:
        for name, leaves in tree[group].items():
            for leaf, value in leaves.items():
                a = np.asarray(value, dtype=np.float32)
                if leaf == "kernel":
                    key, a = "weight", a.transpose(3, 2, 0, 1)
                elif leaf in ("bias", "scale"):
                    key = leaf
                else:
                    raise KeyError(f"unknown parameter {group}/{name}/{leaf}")
                out[f"{group}.{name}.{key}"] = torch.from_numpy(a.copy())
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """state_dict -> JAX parameter tree with numpy leaves."""
    tree: Dict = {group: {} for group in _GROUPS}
    for full_key, value in state_dict.items():
        group, name, key = full_key.split(".")
        a = value.detach().cpu().numpy()
        if key == "weight":
            leaf, a = "kernel", a.transpose(2, 3, 1, 0)
        else:
            leaf = key
        tree[group].setdefault(name, {})[leaf] = np.ascontiguousarray(a)
    return tree


def _optax_leaves(opt_state):
    """(trace tree, count) of an optax chain state: the TraceState of
    optax.trace (the momentum) and the ScaleByScheduleState's count."""
    trace, count = None, None
    stack = [opt_state]
    while stack:
        node = stack.pop()
        fields = getattr(node, "_fields", ())  # optax states are namedtuples
        if "trace" in fields:
            trace = node.trace
        elif "count" in fields:
            count = node.count
        elif isinstance(node, (tuple, list)):
            stack.extend(node)
    if trace is None or count is None:
        raise KeyError("no momentum trace and step count in this optimizer state")
    return trace, count


def opt_state_from_jax(opt_state) -> Tuple[Dict[str, torch.Tensor], int]:
    """The JAX package's optax state (make_optimizer's chain) -> (momentum
    buffers by parameter name, in the port's layouts, and the count of
    updates made)."""
    trace, count = _optax_leaves(opt_state)
    return params_from_jax(trace), int(np.asarray(count))

