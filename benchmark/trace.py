"""The traced run's instruments: spans and records that the benchmark
takes around the program's functions while a stretch of the window is
profiled, and the reduction of one torch.profiler session over that
stretch to what the per-layer metrics read.

    tracer = Tracer(device, spans={"loss_and_grads": "dan_tpu_torch.train.loop:loss_and_grads"},
                    records={"nms": "dan_tpu_torch.ops.postprocess:greedy_nms_rank"})
    tracer.state = state                       # the driver's state, for "@<key>" targets
    with tracer.stretch():                     # the profiled stretch
        ...
    view = tracer.view(units, config, params)  # TraceView: what the readers read

A target is "<module>:<attribute>" (a function the program looks up there
when it calls it; "<module>:<Class>.<method>" for a method), replaced by a
wrapper while the stretch runs, or "@<key>": the torch module that the
driver's state holds under <key>, hooked around its forward.  A span is a
pair of CUDA events on the current stream around each call (the device
time between the two points of the stream; the host clock off the card);
a record keeps each call's arguments (numpy arrays copied).  The per-layer
metrics name their targets (benchmark/metrics/<metric>.py: SPANS, RECORDS).
Nothing is written to disk: the profiler's events are reduced in memory.
"""
from __future__ import annotations

import contextlib
import importlib
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

WINDOW_EVENT = "benchmark.window"
TOP = 10


class _Mark:
    def __init__(self, cuda: bool):
        self.cuda = cuda
        if cuda:
            self.ev = torch.cuda.Event(enable_timing=True)
            self.ev.record()
        else:
            self.t = time.perf_counter()

    def ms_to(self, other: "_Mark") -> float:
        if self.cuda:
            return self.ev.elapsed_time(other.ev)
        return (other.t - self.t) * 1e3


def _keep(x):
    return x.copy() if isinstance(x, np.ndarray) else x


def _resolve(target: str) -> Tuple[Any, str]:
    """"<module>:<a>.<b>" -> (the object holding the last name, that name)."""
    mod, _, path = target.partition(":")
    obj = importlib.import_module(mod)
    *outer, name = path.split(".")
    for part in outer:
        obj = getattr(obj, part)
    return obj, name


class Tracer:
    def __init__(self, device, spans: Optional[Dict[str, str]] = None,
                 records: Optional[Dict[str, str]] = None):
        self.cuda = torch.device(device).type == "cuda"
        self.on = False
        self.spans_at = dict(spans or {})
        self.records_at = dict(records or {})
        self.state: Optional[Dict] = None
        self.pairs: Dict[str, List[Tuple[_Mark, _Mark]]] = {}
        self.records: Dict[str, List[Tuple[tuple, dict]]] = {}
        self.prof = None
        self.window_s: Optional[float] = None

    def _open(self):
        return _Mark(self.cuda) if self.on else None

    def _close(self, name: str, start):
        if start is not None:
            self.pairs.setdefault(name, []).append((start, _Mark(self.cuda)))

    def _spanned(self, name: str, fn: Callable) -> Callable:
        def spanned(*args, **kwargs):
            start = self._open()
            out = fn(*args, **kwargs)
            self._close(name, start)
            return out

        return spanned

    def _recorded(self, name: str, fn: Callable) -> Callable:
        def recorded(*args, **kwargs):
            if self.on:
                self.records.setdefault(name, []).append(
                    (tuple(_keep(a) for a in args), {k: _keep(v) for k, v in kwargs.items()}))
            return fn(*args, **kwargs)

        return recorded

    def _hook(self, name: str, module: torch.nn.Module):
        starts = []

        def pre(mod, args):
            starts.append(self._open())

        def post(mod, args, out):
            self._close(name, starts.pop() if starts else None)

        return [module.register_forward_pre_hook(pre), module.register_forward_hook(post)]

    @contextlib.contextmanager
    def _taps(self):
        """Install every span and record for the block, then take them out."""
        undo: List[Callable[[], None]] = []
        try:
            for kind, name, target in ([("span", n, t) for n, t in self.spans_at.items()]
                                       + [("record", n, t) for n, t in self.records_at.items()]):
                if target.startswith("@"):
                    handles = self._hook(name, (self.state or {})[target[1:]])
                    undo.extend(h.remove for h in handles)
                    continue
                obj, attr = _resolve(target)
                raw = vars(obj).get(attr, getattr(obj, attr))
                fn = raw.__func__ if isinstance(raw, staticmethod) else raw
                new = (self._spanned if kind == "span" else self._recorded)(name, fn)
                setattr(obj, attr, staticmethod(new) if isinstance(raw, staticmethod) else new)
                undo.append(lambda obj=obj, attr=attr, raw=raw: setattr(obj, attr, raw))
            yield
        finally:
            for u in reversed(undo):
                u()

    @contextlib.contextmanager
    def stretch(self):
        """Profile the block (it must end with the device idle), with the
        spans and records in place while it runs."""
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        with self._taps():
            self.on = True
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                with record_function(WINDOW_EVENT):
                    yield
                    if self.cuda:
                        torch.cuda.synchronize()
                self.window_s = time.perf_counter() - t0
            self.on = False
        self.prof = prof

    def span_ms(self) -> Dict[str, List[float]]:
        if self.cuda:
            torch.cuda.synchronize()
        return {n: [a.ms_to(b) for a, b in v] for n, v in self.pairs.items()}

    def view(self, units: Dict, config: Dict, params: Dict) -> "TraceView":
        events = _events(self.prof) if self.prof is not None else []
        return TraceView(events, self.span_ms(), self.records, units, config, params,
                         self.window_s)


def _events(prof) -> List[Tuple[bool, str, float, float]]:
    """(on the device, name, start s, end s) of every event of a session."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        try:
            start, dur = e.start_ns() / 1e9, e.duration_ns() / 1e9
        except AttributeError:
            start, dur = e.start_us() / 1e6, e.duration_us() / 1e6
        out.append((e.device_type() == DeviceType.CUDA, e.name(), start, start + dur))
    return out


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class TraceView:
    """What a per-layer metric's reader reads: the profiled stretch's
    device events and length, the spans (ms a call), the records (each
    call's arguments), the units of work the stretch held
    (`units`: calls, steps, images, as the driver counts them), and the
    cell's configuration file (`config`) and traffic parameters (`params`),
    from which a reader counts the work itself."""

    def __init__(self, events, spans, records, units, config, params, window_s):
        self.spans = spans
        self.records = records
        self.units = units
        self.config = config
        self.params = params
        win = [(s, e) for dev, n, s, e in events if not dev and n == WINDOW_EVENT]
        self.window = win[0] if win else None
        self.window_s = window_s
        lo, hi = self.window if self.window else (float("-inf"), float("inf"))
        # The window's own annotation also shows on the device's timeline.
        self.device = [(n, max(s, lo), min(e, hi)) for dev, n, s, e in events
                       if dev and n != WINDOW_EVENT and e > lo and s < hi]
        self.host = [(n, s, e) for dev, n, s, e in events if not dev and n != WINDOW_EVENT]

    def kernel_s(self, *needles: str) -> Optional[float]:
        """Device seconds of the events whose name holds any needle; None
        when there is none."""
        hits = [e - s for n, s, e in self.device if any(k in n for k in needles)]
        return sum(hits) if hits else None

    def busy_s(self) -> float:
        return sum(e - s for s, e in _union([(s, e) for _, s, e in self.device]))

    def trace_window_s(self) -> Optional[float]:
        return (self.window[1] - self.window[0]) if self.window else self.window_s

    def idle_share(self) -> Optional[float]:
        w = self.trace_window_s()
        if not w or not self.device:
            return None
        return 100.0 * max(0.0, 1.0 - self.busy_s() / w)

    def span_mean_ms(self, name: str) -> Optional[float]:
        v = self.spans.get(name)
        return sum(v) / len(v) if v else None

    def breakdown(self) -> Dict[str, list]:
        by_name: Dict[str, float] = {}
        for n, s, e in self.device:
            by_name[n[:160]] = by_name.get(n[:160], 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps: Dict[str, float] = {}
        if self.window:
            busy = _union([(s, e) for _, s, e in self.device])
            edges = [self.window[0]] + [x for iv in busy for x in iv] + [self.window[1]]
            for s, e in zip(edges[0::2], edges[1::2]):
                if e <= s:
                    continue
                mid = (s + e) / 2
                over = [(hs, n) for n, hs, he in self.host if hs <= mid <= he]
                label = max(over)[1][:160] if over else "no host event"
                gaps[label] = gaps.get(label, 0.0) + (e - s)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": [[n, v] for n, v in idle]}
