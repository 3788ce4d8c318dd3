"""fpn_ms.detect_retinaface: device ms a call spends in the program's span
dan.model.fpn (models/retinaface.py: the FPN's 1x1 and merge convolutions,
the nearest upsamples and sums), from the CUDA events the span records."""
from benchmark.spans_common import device_ms_per_unit


def read(view):
    return device_ms_per_unit(view, "dan.model.fpn")
