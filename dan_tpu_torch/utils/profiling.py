"""Tracing and throughput (counterpart of dan_tpu/utils/profiling.py):
spans at the port's layer boundaries, a torch.profiler trace of a region
written as a Chrome trace, and an images/s(/chip) meter on the host clock.

    with span("dan.train.step", unit=state.step):   # or @span("dan.tta.fetch")
        ...
    with maybe_trace("/tmp/trace") as prof:     # prof is None without a dir
        ...                                     # -> /tmp/trace/<host>.<pid>.pt.trace.json
    recorded()                                  # the spans' records, device ms resolved
    reset()
    meter = ThroughputMeter(batch_size, n_chips)
    meter.tick(); meter.images_per_sec_per_chip

A span is on only while a torch.profiler session runs in the process
(maybe_trace, tools/profile.py, the benchmark's traced stretch).  Off, it
costs one check of the profiler's flag on entry and one look at this
thread's stack of open spans on exit: no allocation, no event, no
profiler range.  On, it
  * opens a profiler range of the FUNCTION scope (`_RecordFunctionFast`),
    which sits among the session's host events on the clock of the card's
    events and in the Chrome trace, and adds nothing to the device's
    timeline (a `record_function` range is of the USER scope, and the
    profiler also draws it there);
  * records a pair of CUDA events on the current stream when CUDA is in
    use in the process: the device ms between the span's two points of
    the stream;
  * appends a SpanRecord (name, parent, unit, host start and end) to a
    list in memory of at most MAX_RECORDS, which `recorded()` returns with
    the device ms resolved by one synchronise and `reset()` clears.
The unit is the step, call or image a span belongs to: a span given none
takes its parent's.  The spans' names are what the benchmark's per-layer
metrics read (benchmark/metrics/*.py), so they are kept as they are:
dan.train.{step,h2d,preprocess,match,forward,loss,backward,allreduce,
optimizer}, dan.model.{backbone,lfpn,heads}, dan.detect{,.normalize,
.postprocess,.select,.nms}, dan.detect_batch{,.pack,.h2d,.d2h} and
dan.tta.{run,canvas,bucket,fetch,vote}.  On an H100's host a span costs
0.4-0.9 us off and about 29 us on: two CUDA events made (8 us each there)
and recorded (6 us each, on a stream object made once: making one takes
another 11 us) and the range (under 2 us).

The trace records the CPU and, where the process has a CUDA card, the
card's kernels (CUPTI), each under its own name; open it in Perfetto or
chrome://tracing.  The meter counts steps and reads the host clock: it
never waits for the device, so over a window that ends without a wait it
measures the rate of enqueueing (the train CLI reads a loss first, which
waits).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import os
import socket
import threading
import time
from typing import Dict, List, Optional

import torch

MAX_RECORDS = 1 << 16

_profiler_on = torch._C._autograd._profiler_enabled
# A profiler range of the FUNCTION scope; None where this torch has none
# (the spans then keep their records and events only).
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None)


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One span as recorded: `id` counts the spans opened in the process,
    `parent_id` is the enclosing span's (None at a root); host times are
    time.perf_counter_ns(); device_ms is None off a card."""

    id: int
    name: str
    parent: Optional[str]
    parent_id: Optional[int]
    unit: Optional[int]
    start_ns: int
    end_ns: int
    device_ms: Optional[float]


class _Open:
    __slots__ = ("span", "id", "parent", "unit", "start_ns", "end_ns", "events", "range",
                 "device_ms")


class _Stack(threading.local):
    def __init__(self):
        self.open: List[_Open] = []


_stack = _Stack()
_records: List[_Open] = []
_ids = itertools.count()


class Span:
    """A named span: a context manager, and a decorator that spans each
    call of the function (see the module's docstring)."""

    __slots__ = ("name", "unit")

    def __init__(self, name: str, unit: Optional[int] = None):
        self.name = name
        self.unit = unit

    def __enter__(self) -> "Span":
        if _profiler_on():
            _open(self)
        return self

    def __exit__(self, *exc) -> bool:
        stack = _stack.open
        if stack and stack[-1].span is self:
            _close(stack.pop())
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)

        return spanned


_named: Dict[str, Span] = {}


def span(name: str, unit: Optional[int] = None) -> Span:
    """The span `name`; `unit` (the step, call or image number) for a span
    whose unit is not its parent's.  Off, the same object every call."""
    if unit is not None and _profiler_on():
        return Span(name, unit)
    s = _named.get(name)
    if s is None:
        s = _named.setdefault(name, Span(name))
    return s


_streams: Dict[tuple, "torch.cuda.Stream"] = {}


def _current_stream() -> "torch.cuda.Stream":
    """torch.cuda.current_stream(), one object a stream: making the object
    takes most of an event record's host time."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _streams.get(key)
    if stream is None:
        stream = _streams[key] = torch.cuda.current_stream()
    return stream


def _open(s: Span) -> None:
    stack = _stack.open
    parent = stack[-1] if stack else None
    rec = _Open()
    rec.span, rec.id, rec.parent = s, next(_ids), parent
    rec.unit = s.unit if s.unit is not None or parent is None else parent.unit
    rec.end_ns, rec.device_ms = None, None
    rec.range = None
    if _Range is not None:
        rec.range = _Range(s.name)
        rec.range.__enter__()
    rec.events = None
    if torch.cuda.is_initialized():
        stream = _current_stream()
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        rec.events = (start, torch.cuda.Event(enable_timing=True), stream)
    rec.start_ns = time.perf_counter_ns()
    stack.append(rec)
    if len(_records) < MAX_RECORDS:
        _records.append(rec)


def _close(rec: _Open) -> None:
    rec.end_ns = time.perf_counter_ns()
    if rec.events is not None:
        rec.events[1].record(rec.events[2])
    if rec.range is not None:
        rec.range.__exit__(None, None, None)
        rec.range = None


def recorded() -> List[SpanRecord]:
    """The closed spans since the last reset(), in the order they opened;
    one synchronise resolves their device ms."""
    done = [r for r in _records if r.end_ns is not None]
    pending = [r for r in done if r.events is not None and r.device_ms is None]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            r.device_ms = r.events[0].elapsed_time(r.events[1])
            r.events = None
    return [SpanRecord(r.id, r.span.name, r.parent.span.name if r.parent else None,
                       r.parent.id if r.parent else None, r.unit, r.start_ns, r.end_ns,
                       r.device_ms) for r in done]


def reset() -> None:
    """Drop every record (spans still open stay on their threads' stacks)."""
    _records.clear()


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
