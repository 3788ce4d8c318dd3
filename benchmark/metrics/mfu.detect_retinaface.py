"""mfu.detect_retinaface: RetinaFace's detect step as a share of the
card's peak in %: the forward's convolution operations
(counts/retinaface_ops.py, at the configuration's image size and compute
dtype) for every image of the profiled stretch, over that precision's peak
(counts/peaks.py), over the stretch's length."""

from benchmark.counts.retinaface_ops import forward_ops
from benchmark.metrics_common import mfu


def read(view):
    images = view.units.get("images")
    if not images:
        return None
    m = view.config["dan"]["model"]
    return mfu(view, {m["compute_dtype"]: forward_ops(view.config["dan"], m["image_size"]) * images})
