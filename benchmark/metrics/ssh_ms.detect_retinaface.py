"""ssh_ms.detect_retinaface: device ms a call spends in the program's span
dan.model.ssh (models/retinaface.py: the three SSH context modules, five
3x3 convolutions and a concatenation each), from the CUDA events the span
records."""
from benchmark.spans_common import device_ms_per_unit


def read(view):
    return device_ms_per_unit(view, "dan.model.ssh")
