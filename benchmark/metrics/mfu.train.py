"""mfu.train: the train step's share of the card's peak in %: the
forward's convolution operations at the train image size times 3 (the
backward as twice the forward) for every image of the profiled stretch,
over its length."""

from benchmark.counts.model_ops import config_forward_ops
from benchmark.metrics_common import mfu


def read(view):
    images = view.units.get("images")
    if not images:
        return None
    ops = config_forward_ops(view.config, view.config["dan"]["preprocess"]["train_image_size"])
    return mfu(view, {p: 3 * n * images for p, n in ops.items()})
