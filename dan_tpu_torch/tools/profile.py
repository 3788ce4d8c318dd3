"""Trace the detect or the train graph on the card with torch.profiler and
print a per-kernel cost table (counterpart of scripts/profile.py).

    python -m dan_tpu_torch.tools.profile detect [--batch 128] [--top 30]
    python -m dan_tpu_torch.tools.profile train  [--batch 8]   [--top 30]
        [--iters_traced 3] [--trace_dir DIR]

detect is the bench path at the default config (640x640, bf16):
tools/bench.py's build_detect_fn (normalize -> forward -> postprocess_batch,
NMS kernel K1) on its `batch` uint8 images from numpy.random.default_rng(0),
random weights (Detector.from_random, seed 0).  train is
train_step on synthetic_batch(cfg, batch, seed=0) with the synthetic
runs' recipe (warm-up 50, clip 10), the matcher, phase-pool backward and
conv1_2' weight-grad kernels included.

For the graph it prints the warm rate over 10 iterations (img/s, host
clock, synchronised), then traces `iters_traced` more with record_shapes
and with_flops and prints the device's kernel time per iteration, and the
top rows by device time, a row being one kernel launched by one op (its
name and input shapes): ms/iter, % of the device time, launches/iter,
GFLOP/s of the op that the profiler counts FLOPs for (the launching op
or the nearest op around it: matmuls and convolutions; aten::conv2d's
count covers the cuDNN kernels and the bias add under it), as that op's
FLOPs over the device time of all its kernels, the kernel's name and the
launching op with its input shapes ("-" where the profiler links the
launch to no op).  The
hand-written kernels appear under their own names.  The Chrome trace is
kept in --trace_dir (default: a new temporary directory), whose path is
printed.

xprof's hlo_stats table, which the reference prints, has no counterpart
here, and neither has its "Bound by" column: the profiler does not say
what bounds a kernel.  chip_smoke.py states each hand-written kernel's
bound from its bytes and operations.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import sys
import tempfile
import time
from typing import Dict, List

import torch

from dan_tpu_torch.api import Detector
from dan_tpu_torch.config import default_config
from dan_tpu_torch.device import resolve_device
from dan_tpu_torch.tools.bench import bench_images, build_detect_fn, sync
from dan_tpu_torch.utils.profiling import trace_path

WARM_ITERS = 10


def detect_graph(batch: int, device):
    """One iteration of the bench path, as a function."""
    cfg = default_config()
    det = Detector.from_random(0, cfg, device)
    images = torch.from_numpy(bench_images(cfg, batch)).to(device)
    detect = build_detect_fn(cfg, device)
    return lambda: detect(det.model, images)


def train_graph(batch: int, device):
    """One train step, in place, as a function."""
    from dan_tpu_torch.data.synthetic import synthetic_batch
    from dan_tpu_torch.train.loop import create_train_state, train_step

    cfg = default_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=batch, warmup_steps=50, grad_clip_norm=10.0))
    state = create_train_state(cfg, 0, device)
    host = synthetic_batch(cfg, batch, seed=0)
    return lambda: train_step(state, host)


@dataclasses.dataclass
class Row:
    """One kernel launched by one op (name and input shapes), over the
    traced iterations; op "-" for launches the profiler links to no op."""

    name: str
    op: str = "-"
    us: float = 0.0
    launches: int = 0
    flops: float = 0.0  # the launching ops' FLOPs, shared by kernel time


def _flop_owner(e):
    """The op whose FLOPs cover e's kernels: e itself or its nearest
    ancestor with a FLOP count (the profiler counts aten::conv2d's, not
    the inner aten::cudnn_convolution's that launches), or None."""
    while e is not None and not e.flops:
        e = e.cpu_parent
    return e


def kernel_table(prof, iters: int) -> tuple:
    """(total device microseconds an iteration, rows in descending time),
    from the profiler's events: every device kernel under the CPU op that
    launched it (its name and input shapes), with the FLOPs of the op that
    counts them shared out by kernel time."""
    cpu = torch.autograd.DeviceType.CPU
    launching = [e for e in prof.events() if e.device_type == cpu and e.kernels]
    owned_us = collections.Counter()  # kernel time under each FLOP-counting op
    for e in launching:
        owner = _flop_owner(e)
        if owner is not None:
            owned_us[owner.id] += sum(k.duration for k in e.kernels)
    rows: Dict[tuple, Row] = {}
    linked_us, linked_n = collections.Counter(), collections.Counter()
    for e in launching:
        owner = _flop_owner(e)
        label = f"{e.name} {list(e.input_shapes)}" if e.input_shapes else e.name
        for k in e.kernels:
            row = rows.setdefault((k.name, label), Row(k.name, label))
            row.us += k.duration
            row.launches += 1
            if owner is not None:
                row.flops += owner.flops * k.duration / max(owned_us[owner.id], 1e-9)
            linked_us[k.name] += k.duration
            linked_n[k.name] += 1
    device_us, device_n = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device_us[e.name] += e.time_range.elapsed_us()
            device_n[e.name] += 1
    for name, n in device_n.items():
        if n > linked_n[name]:
            rows[(name, "-")] = Row(name, "-", max(device_us[name] - linked_us[name], 0.0),
                                    n - linked_n[name])
    total = sum(device_us.values())
    return total / iters, sorted(rows.values(), key=lambda r: -r.us)


def print_table(total_us: float, rows: List[Row], iters: int, top: int, out=sys.stdout):
    print(f"total device kernel time: {total_us * iters / 1000:.3f} ms => "
          f"{total_us / 1000:.3f} ms/iter", file=out)
    print(f"{'ms/iter':>8} {'%':>5} {'launch/it':>9} {'GF/s':>9}  kernel | launched by", file=out)
    for r in rows[:top]:
        ms = r.us / iters / 1000
        pct = 100 * r.us / iters / max(total_us, 1e-9)
        gfs = f"{r.flops / r.us / 1e3:.1f}" if r.flops and r.us else "-"
        print(f"{ms:8.3f} {pct:5.1f} {r.launches / iters:9.2f} {gfs:>9}  "
              f"{r.name[:90]} | {r.op[:120]}", file=out)


def profile(graph: str, batch: int, iters_traced: int, top: int, trace_dir: str, device):
    """Warm rate, trace and table of one graph; returns
    (img/s, device ms an iteration, rows)."""
    device = resolve_device(device)
    os.makedirs(trace_dir, exist_ok=True)
    if device.type != "cuda":
        raise RuntimeError("the profile tool reads the card's kernel times: it needs a CUDA "
                           "device")
    step = (detect_graph if graph == "detect" else train_graph)(batch, device)
    step()  # build + warm
    step()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(WARM_ITERS):
        step()
    sync(device)
    ips = WARM_ITERS * batch / (time.perf_counter() - t0)
    print(f"{graph} batch={batch}: {ips:.1f} img/s ({torch.cuda.get_device_name(device)})",
          file=sys.stderr)
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       record_shapes=True, with_flops=True) as prof:
        for _ in range(iters_traced):
            step()
        sync(device)
    prof.export_chrome_trace(trace_path(trace_dir))
    total_us, rows = kernel_table(prof, iters_traced)
    print_table(total_us, rows, iters_traced, top)
    print(f"trace: {trace_path(trace_dir)}", file=sys.stderr)
    return ips, total_us / 1000, rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dan_tpu_torch.tools.profile")
    ap.add_argument("graph", choices=["detect", "train"])
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--iters_traced", type=int, default=3)
    ap.add_argument("--trace_dir", default=None)
    ap.add_argument("--device", default=None, help="torch device; default: the first CUDA card")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    batch = args.batch or (128 if args.graph == "detect" else 8)
    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="dan_torch_profile_")
    profile(args.graph, batch, args.iters_traced, args.top, trace_dir, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
