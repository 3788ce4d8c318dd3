"""What the per-layer metrics of the program's own spans share
(dan_tpu_torch/utils/profiling.py: `span`, `recorded`).  A span is on only
while a torch.profiler session runs, so in a traced run the program's
records are those of the profiled stretch, and each span is also a host
event of the session (`view.host`), on the clock of the card's events.

Where the program has no spans (a tree before them) or the stretch ran
off a card, every reader here returns None and its metric is left out.
"""
import importlib
import sys
from typing import Dict, List, Optional

from benchmark.trace import _union

# Host events that wait for the device: the runtime's synchronise calls
# and a synchronous copy.
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")
PREFIX = "dan."


def records(view) -> List:
    """The program's span records of the stretch (SpanRecord: name, unit,
    device_ms, ...); [] where the program records none.  A view that
    carries `program_spans` (the tests' hand-built ones) gives those."""
    if not hasattr(view, "program_spans"):
        prof = importlib.import_module("dan_tpu_torch.utils.profiling")
        recorded = getattr(prof, "recorded", None)
        view.program_spans = list(recorded()) if recorded is not None else []
    return view.program_spans


def device_ms_per_unit(view, name: str) -> Optional[float]:
    """Device ms of the spans `name` per unit (step or call) they belong
    to; None without such spans or off a card."""
    recs = [r for r in records(view) if r.name == name]
    if not recs or any(r.device_ms is None for r in recs):
        return None
    return sum(r.device_ms for r in recs) / len({r.unit for r in recs})


def _profiled(view, unit: str):
    """(host events, device events, units) of the stretch; None when it
    ran off a card or holds no program span."""
    host, device = getattr(view, "host", []), getattr(view, "device", [])
    n = view.units.get(unit)
    if not n or not device or not any(h[0].startswith(PREFIX) for h in host):
        return None
    return host, device, n


def host_waits(view, root: str, unit: str) -> Optional[float]:
    """Host events of WAITS inside the spans `root`, per unit of the
    stretch (`view.units[unit]`); None without such spans or device
    events."""
    got = _profiled(view, unit)
    roots = [(s, e) for name, s, e in got[0] if name == root] if got else []
    if not roots:
        return None
    waits = [s for name, s, e in got[0] if name in WAITS
             and any(rs <= s and e <= re for rs, re in roots)]
    return len(waits) / got[2]


def idle_by_span(view) -> Dict[str, float]:
    """Device-idle seconds of the stretch by the program span the host was
    in: each gap between the device's busy intervals goes to the
    latest-starting `dan.` span that covers its midpoint (the breakdown's
    rule, over the program's spans only)."""
    spans = [(s, e, n) for n, s, e in view.host if n.startswith(PREFIX)]
    out: Dict[str, float] = {}
    if not spans or not view.window:
        return out
    busy = _union([(s, e) for _, s, e in view.device])
    edges = [view.window[0]] + [x for iv in busy for x in iv] + [view.window[1]]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = (s + e) / 2
        over = [(hs, n) for hs, he, n in spans if hs <= mid <= he]
        if over:
            label = max(over)[1]
            out[label] = out.get(label, 0.0) + (e - s)
    return out


def program_idle_ms(view, unit: str, metric: str) -> Optional[float]:
    """Device-idle ms per unit of the stretch with the host inside a
    program span; the split by span goes to stderr.  None without program
    spans or device events."""
    got = _profiled(view, unit)
    if not got or not getattr(view, "window", None):
        return None
    n = got[2]
    split = idle_by_span(view)
    print(f"{metric}: idle ms per {unit[:-1]} by span "
          + ", ".join(f"{k} {1e3 * v / n:.4f}" for k, v in
                      sorted(split.items(), key=lambda kv: -kv[1])),
          file=sys.stderr, flush=True)
    return 1e3 * sum(split.values()) / n
