"""program_idle_ms.train: ms a step of the profiled stretch in which the
card is idle while the host is inside one of the program's spans (each
gap to the latest-starting dan. span covering its midpoint, as the
breakdown labels gaps); the split by span goes to stderr."""
from benchmark.spans_common import program_idle_ms


def read(view):
    return program_idle_ms(view, "steps", "program_idle_ms.train")
