"""lfpn_ms.detect: device ms a call spends in the program's span
dan.model.lfpn (models/lfpn.py: the upsample and product fusion of the
taps), from the CUDA events the span records."""
from benchmark.spans_common import device_ms_per_unit


def read(view):
    return device_ms_per_unit(view, "dan.model.lfpn")
