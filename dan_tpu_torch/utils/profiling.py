"""Tracing and throughput (counterpart of dan_tpu/utils/profiling.py): a
torch.profiler trace of a region, written as a Chrome trace, and an
images/s(/chip) meter on the host clock.

    with maybe_trace("/tmp/trace") as prof:     # prof is None without a dir
        ...                                     # -> /tmp/trace/<host>.<pid>.pt.trace.json
    meter = ThroughputMeter(batch_size, n_chips)
    meter.tick(); meter.images_per_sec_per_chip

The trace records the CPU and, where the process has a CUDA card, the
card's kernels (CUPTI), each under its own name; open it in Perfetto or
chrome://tracing.  The meter counts steps and reads the host clock: it
never waits for the device, so over a window that ends without a wait it
measures the rate of enqueueing (the train CLI reads a loss first, which
waits).
"""
from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Optional


def trace_path(trace_dir: str) -> str:
    """Where maybe_trace writes this process's trace in trace_dir."""
    return os.path.join(trace_dir, f"{socket.gethostname()}.{os.getpid()}.pt.trace.json")


@contextlib.contextmanager
def maybe_trace(trace_dir: Optional[str]):
    """Profile the region with torch.profiler when trace_dir is given
    (yielding the profiler), and export its Chrome trace there on exit;
    else do nothing (yielding None)."""
    if not trace_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the region's kernels end inside the trace
    prof.export_chrome_trace(trace_path(trace_dir))


class ThroughputMeter:
    """images/sec(/chip) over a sliding window of steps."""

    def __init__(self, per_step_images: int, n_chips: int = 1):
        self.per_step_images = per_step_images
        self.n_chips = n_chips
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n: int = 1):
        self._steps += n

    @property
    def images_per_sec(self) -> float:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return self._steps * self.per_step_images / dt

    @property
    def images_per_sec_per_chip(self) -> float:
        return self.images_per_sec / self.n_chips
