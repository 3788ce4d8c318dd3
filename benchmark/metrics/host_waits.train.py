"""host_waits.train: host events that wait for the device
(spans_common.WAITS: the runtime's synchronise calls, a synchronous
cudaMemcpy) inside the program's dan.train.step spans, per step of the
profiled stretch."""
from benchmark.spans_common import host_waits


def read(view):
    return host_waits(view, "dan.train.step", "steps")
