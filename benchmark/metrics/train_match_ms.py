"""train_match_ms: device ms a step spends in the program's span
dan.train.match (train/loop.py: generate_anchors and match_anchors_batch,
the matcher of ops/matching_cuda.py), from the CUDA events the span
records."""
from benchmark.spans_common import device_ms_per_unit


def read(view):
    return device_ms_per_unit(view, "dan.train.match")
