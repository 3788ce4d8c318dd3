"""mfu.detect: the detect step's share of the card's peak in %: the
forward's convolution operations (counts/model_ops.py, the int8 body's at
the int8 peak) for every image of the profiled stretch, each precision
over its peak (counts/peaks.py), over the stretch's length."""

from benchmark.counts.model_ops import config_forward_ops
from benchmark.metrics_common import mfu


def read(view):
    images = view.units.get("images")
    if not images:
        return None
    ops = config_forward_ops(view.config, view.config["dan"]["model"]["image_size"])
    return mfu(view, {p: n * images for p, n in ops.items()})
