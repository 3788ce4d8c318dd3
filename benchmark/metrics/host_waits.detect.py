"""host_waits.detect: host events that wait for the device
(spans_common.WAITS) inside the program's dan.detect spans
(tools/bench.py's detect), per call of the profiled stretch."""
from benchmark.spans_common import host_waits


def read(view):
    return host_waits(view, "dan.detect", "calls")
