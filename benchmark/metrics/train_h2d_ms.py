"""train_h2d_ms: device ms a step spends in the program's span
dan.train.h2d (train/loop.py::to_device: each batch array pinned and
copied to the card), from the CUDA events the span records."""
from benchmark.spans_common import device_ms_per_unit


def read(view):
    return device_ms_per_unit(view, "dan.train.h2d")
