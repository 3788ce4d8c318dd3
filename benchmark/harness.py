"""The benchmark of the port: one cell, one seed, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name (benchmark/README.md):
BENCHMARK.json's workload names a configuration (its file) and a traffic
mix (benchmark/traffic/<mix>.json), the mix names its driver
(benchmark/drivers/<kind>.py), the cell's limits are
benchmark/limits/<cell>.json, and each per-layer metric is read by
benchmark/metrics/<metric>.py, which also names the program's functions
its spans and records are taken around.  A driver's window returns the
cell's rate, which the harness reports under the cell's one end-to-end
metric besides setup_s.  The run sets up (timed as setup_s), runs
the window, checks what the window produced against the plain reference,
and prints one JSON line last on stdout.

Options the driver of the benchmark does not pass, for the builder's own
readings: --control 1 puts the reference, computed in the precision below
the configuration's, in the program's place; --fault <name> breaks the
timed path underneath (the names are the driver's FAULTS).
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from types import ModuleType
from typing import Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NO_CARD_EXIT = 3
FORBIDDEN_EXIT = 4


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", default=None)
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def manifest(root: str = ROOT) -> Dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def load_file_module(path: str, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with everything it names, loaded."""

    name: str
    chips: int
    config: Dict  # the configuration file
    mix: Dict  # the traffic file
    driver: ModuleType
    limits: Dict[str, float]
    end_to_end: List[Dict]  # the manifest's entries this cell reports
    per_layer: List[Dict]


def find_cell(name: str, root: str = ROOT) -> Cell:
    man = manifest(root)
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; the manifest has {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    mix = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    driver = importlib.import_module(f"benchmark.drivers.{mix['kind']}")
    lim_path = os.path.join(HERE, "limits", f"{name}.json")
    limits = ({k: v["limit"] for k, v in load_json(lim_path)["checks"].items()}
              if os.path.exists(lim_path) else {})

    def mine(m):
        return name in m["workloads"] if "workloads" in m else None

    e2e = [m for m in man["end_to_end"] if mine(m) is not False]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"]
                 if mine(m) or (mine(m) is None and m["moves"] in reported)]
    return Cell(name, w["chips"], config, mix, driver, limits, e2e, per_layer)


_METRICS: Dict[str, ModuleType] = {}


def metric_module(name: str) -> ModuleType:
    """benchmark/metrics/<name>.py: read(view), and optionally SPANS and
    RECORDS, {name: target} of the taps it reads (benchmark/trace.py)."""
    if name not in _METRICS:
        _METRICS[name] = load_file_module(os.path.join(HERE, "metrics", f"{name}.py"),
                                          f"_metric_{name}")
    return _METRICS[name]


def read_metric(name: str, view) -> Optional[float]:
    return metric_module(name).read(view)


def taps(per_layer: List[Dict]) -> Tuple[Dict[str, str], Dict[str, str]]:
    """The spans and records the cell's per-layer metrics read, merged."""
    merged: Tuple[Dict[str, str], Dict[str, str]] = ({}, {})
    for m in per_layer:
        mod = metric_module(m["name"])
        for into, decl in zip(merged, (getattr(mod, "SPANS", {}), getattr(mod, "RECORDS", {}))):
            for key, target in decl.items():
                if into.setdefault(key, target) != target:
                    raise ValueError(f"metric {m['name']}: {key!r} is tapped at {into[key]!r} "
                                     f"by another metric, not at {target!r}")
    return merged


@dataclasses.dataclass
class Run:
    """What a driver gets: the cell, the seed, the device, the mode."""

    cell: Cell
    seed: int
    seconds: float
    device: object
    trace: bool = False
    control: bool = False
    fault: Optional[str] = None
    tracer: object = None

    patched: List = dataclasses.field(default_factory=list)

    def patch(self, obj, name: str, value) -> None:
        """Replace obj.name for this run; run_cell puts it back at the end."""
        old = vars(obj)[name] if name in vars(obj) else getattr(obj, name)  # a staticmethod whole
        self.patched.append((obj, name, old))
        setattr(obj, name, value)

    def restore(self) -> None:
        while self.patched:
            obj, name, old = self.patched.pop()
            setattr(obj, name, old)

    @property
    def dan(self) -> Dict:
        return self.cell.config["dan"]

    @property
    def params(self) -> Dict:
        return self.cell.mix["params"]


@dataclasses.dataclass
class Outcome:
    """What a driver's window returns."""

    rate: Optional[float]  # the cell's end-to-end metric besides setup_s
    attempted: int
    failed: int
    units: Dict = dataclasses.field(default_factory=dict)  # of the profiled stretch
    metrics: Dict[str, float] = dataclasses.field(default_factory=dict)  # others, by name


def card_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(run: Run, t_start: float) -> Dict:
    """Set up, run the window, check; -> the result object (no printing)."""
    try:
        return _run_cell(run, t_start)
    finally:
        run.restore()


def _run_cell(run: Run, t_start: float) -> Dict:
    import torch

    from benchmark import guard, trace

    cuda = torch.device(run.device).type == "cuda"
    cell = run.cell
    if run.trace:
        spans, records = taps(cell.per_layer)
        run.tracer = trace.Tracer(run.device, spans, records)
    state = cell.driver.setup(run)
    if run.trace:
        run.tracer.state = state
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s")
    out = cell.driver.window(run, state)
    mem = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    log(f"window: rate {out.rate} {out.metrics} attempted {out.attempted} failed {out.failed}")
    view = run.tracer.view(out.units, cell.config, run.params) if run.trace else None
    checks = cell.driver.check(run, state)
    del state
    bad = guard.loaded_forbidden()
    if bad:
        raise ForbiddenModules(bad)

    compared = {}
    correct = out.failed == 0
    for name, value in checks.items():
        limit = cell.limits.get(name)
        ok = limit is not None and value is not None and math.isfinite(value) and value <= limit
        correct = correct and ok
        compared[name] = {"value": value, "limit": limit}
    if set(cell.limits) - set(checks):
        correct = False
    metrics = {}
    if run.trace:
        for m in cell.per_layer:
            v = read_metric(m["name"], view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        vals = dict(out.metrics, setup_s=setup_s)
        rated = [m["name"] for m in cell.end_to_end if m["name"] not in vals]
        if out.rate is not None and len(rated) == 1:
            vals[rated[0]] = out.rate
        for m in cell.end_to_end:
            if m["name"] not in vals:
                raise KeyError(f"the driver measured no {m['name']}")
            metrics[m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": card_name(run.device) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": mem}
    result = {"correct": bool(correct), "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device}
    if run.trace:
        device["busy_s"] = view.busy_s()
        device["window_s"] = view.trace_window_s()
        result["breakdown"] = view.breakdown()
    result["checks"] = compared
    return result


class ForbiddenModules(RuntimeError):
    pass


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    from benchmark import guard

    bad = guard.loaded_forbidden() + guard.scan_imports(HERE)
    if bad:
        log(f"benchmark: forbidden imports: {bad}")
        return FORBIDDEN_EXIT
    cell = find_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"benchmark: the cell needs {cell.chips} CUDA card(s), this machine has {n}; "
            "nothing is measured on the CPU")
        return NO_CARD_EXIT
    device = torch.device("cuda", 0)
    log(f"benchmark: {args.workload} seed {args.seed} on {card_name(device)} "
        f"({power_limit()}), torch {torch.__version__}")
    run = Run(cell, args.seed, args.seconds, device, bool(args.trace), bool(args.control),
              args.fault)
    try:
        result = run_cell(run, t_start)
    except ForbiddenModules as e:
        log(f"benchmark: forbidden modules loaded during the run: {e}")
        return FORBIDDEN_EXIT
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
