"""Headline benchmark of the port (counterpart of the root bench.py):
images/s on one card at 640x640 inference, printed as ONE JSON line.

    python -m dan_tpu_torch.tools.bench

The measured path is bench.py's: a uint8 batch on the card -> normalize ->
the VGG + LFPN + heads forward (bf16) -> decode -> top-k -> greedy NMS (the
CUDA kernel of ops/nms_cuda.py at B = DAN_BENCH_BATCH) -> (<= 750, 5)
detections an image.  The weights are the JAX package's PRNGKey(0) init
(models/reference_init.py), the images numpy.random.default_rng(0) uint8,
as bench.py's.  Timing is bench.py's `measure`: one first call, 3 warm-up,
20 timed on the host clock, fenced by torch.cuda.synchronize().  On the
card it also prints to stderr the NMS kernel's launches in that
measurement and how many rows of the last launch took the tile scan
(ops/nms_cuda.py: LAUNCHES, LAST_PATHS).

The line: {"metric": "images_per_sec_per_chip_640x640_inference", "value",
"unit", "vs_baseline"}.  It prints as soon as the card's number exists;
nothing after it can suppress it.  vs_baseline divides by the port's own
CPU number, cached in bench_cpu_baseline.json beside this file and keyed on
the batch and a fingerprint of the config: the same detect path on the
CPU (the kernels' plain versions) of the host that measured it.  Without a
valid cache it is null and the reason goes to stderr.  Measuring the CPU
number is opt-in (DAN_BENCH_MEASURE_CPU=1, after the headline) and takes
tens of minutes at batch 128.

Environment: DAN_BENCH_BATCH (default 128); DAN_BENCH_ALLOW_CPU=1 measures
on the CPU when there is no card (the number is then not the headline);
without it and without a card the bench exits 5 and prints no number.
DAN_BENCH_DEADLINE_S (default 1500 s, 7200 s on the opt-in CPU paths): past
it the bench exits 4 with a message.

build_detect_fn and measure are the one definition of the bench path in
the port: tools/profile.py and bench_int8 use them, and the benchmark's
detect drivers and chip_smoke.py's check of the bench path use
build_detect_fn.
"""
from __future__ import annotations

import hashlib
import itertools
import json
import os
import sys
import threading
import time
from typing import Mapping, Optional

import numpy as np
import torch

from dan_tpu_torch.api import Detector
from dan_tpu_torch.box.anchors import generate_anchors
from dan_tpu_torch.config import DANConfig, default_config
from dan_tpu_torch.models.reference_init import init_reference_params
from dan_tpu_torch.ops import nms_cuda
from dan_tpu_torch.ops.postprocess import postprocess_batch
from dan_tpu_torch.ops.preprocess import normalize_image
from dan_tpu_torch.utils.profiling import span

BATCH = int(os.environ.get("DAN_BENCH_BATCH", "128"))
WARMUP_ITERS = 3
MEASURE_ITERS = 20
METRIC = "images_per_sec_per_chip_640x640_inference"
CPU_BASELINE_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "bench_cpu_baseline.json")
NO_CARD_EXIT = 5


def deadline_s() -> float:
    """DAN_BENCH_DEADLINE_S, by default 1500 s, or 7200 s on the opt-in CPU
    paths (a CPU run at batch 128 takes tens of minutes)."""
    opt_in_cpu = "1" in (os.environ.get("DAN_BENCH_MEASURE_CPU"),
                         os.environ.get("DAN_BENCH_ALLOW_CPU"))
    return float(os.environ.get("DAN_BENCH_DEADLINE_S", "7200" if opt_in_cpu else "1500"))


def arm_deadline_watchdog(seconds: float) -> threading.Event:
    """A daemon thread that exits the process with code 4 and a message once
    `seconds` pass, unless the returned event is set first."""
    done = threading.Event()

    def watch():
        if not done.wait(seconds):
            print(f"bench: total wall clock exceeded {seconds:.0f}s — aborting (a kernel "
                  "build or a card that does not answer?)", file=sys.stderr, flush=True)
            os._exit(4)

    threading.Thread(target=watch, daemon=True).start()
    return done


def reference_params(cfg: DANConfig, params: Optional[Mapping] = None) -> Mapping:
    """`params`, else the JAX package's PRNGKey(0) tree
    (init_reference_params(0, cfg.model)), which the reference benches
    start from; load it with Detector.from_jax_params.  The draw takes
    seconds on the host: keep it out of every timed window."""
    return params if params is not None else init_reference_params(0, cfg.model)


def bench_images(cfg: DANConfig, batch: int) -> np.ndarray:
    """bench.py's images: (batch, S, S, 3) uint8 from default_rng(0)."""
    size = cfg.model.image_size
    return np.random.default_rng(0).integers(0, 255, (batch, size, size, 3), dtype=np.uint8)


def build_detect_fn(cfg: DANConfig, device):
    """detect(model, images_u8) -> {'bboxes', 'scores', 'valid'} of
    postprocess_batch: normalize, the forward of `model` (a DANDetector or a
    quant.QuantizedDetector: normalized (B, S, S, 3) -> (cls, loc)), decode,
    filter, top-k and NMS, in pixels of the network input.  With a
    RetinaFaceConfig `model` is a RetinaFace, whose third output, the
    landmarks, comes back as 'landmarks' too.  Each call is a dan.detect
    span (utils/profiling.py) whose unit is the call's number."""
    size = cfg.model.image_size
    anchors = generate_anchors(cfg.anchors, size, size, device)
    calls = itertools.count()

    @torch.inference_mode()
    def detect(model, images_u8):
        with span("dan.detect", unit=next(calls)):
            with span("dan.detect.normalize"):
                x = normalize_image(images_u8.float(), cfg.preprocess)
            cls_logits, loc_preds, *landm = model(x)
            with span("dan.detect.postprocess"):
                return postprocess_batch(cls_logits, loc_preds, anchors, cfg.anchors,
                                         cfg.postprocess, float(size), float(size),
                                         landm_preds=landm[0] if landm else None)

    return detect


def sync(device) -> None:
    """Wait for the device (a no-op on the CPU, where every op is done when
    it returns)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(detect, model, images, iters, batch, warmup=WARMUP_ITERS) -> float:
    """bench.py's measure: one first call, `warmup` more, then img/s over
    `iters` calls on the host clock, each stage fenced by a synchronise."""
    detect(model, images)
    sync(images.device)
    for _ in range(warmup):
        detect(model, images)
    sync(images.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        detect(model, images)
    sync(images.device)
    return iters * batch / (time.perf_counter() - t0)


def config_fingerprint(cfg: DANConfig) -> str:
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


def read_cpu_baseline(cfg_fp: str):
    """The cached CPU img/s and None, or (None, reason) when the cache is
    unusable.  The cached batch and config fingerprint must both be the
    current ones.  Never raises: it runs between the card's measurement and
    the headline print."""
    name = os.path.basename(CPU_BASELINE_CACHE)
    try:
        if not os.path.exists(CPU_BASELINE_CACHE):
            return None, f"{name} missing"
        try:
            with open(CPU_BASELINE_CACHE) as f:
                cached = json.load(f)
        except Exception as e:  # any malformation: report it, never raise
            return None, f"{name} unreadable: {e}"
        if not isinstance(cached, dict):
            return None, f"{name} is not a JSON object"
        if cached.get("batch") != BATCH:
            return None, f"cache batch {cached.get('batch')} != bench batch {BATCH}"
        if cached.get("config_fp") != cfg_fp:
            return None, (f"cache config_fp {cached.get('config_fp')!r} is stale for the "
                          f"current config ({cfg_fp!r})")
        ips = cached.get("images_per_sec")
        if isinstance(ips, bool) or not isinstance(ips, (int, float)) or not ips > 0:
            return None, f"cache images_per_sec invalid: {ips!r}"
        return ips, None
    except Exception as e:  # the headline must print whatever the cache holds
        return None, f"cache check failed: {e}"


def measure_cpu_baseline(cfg: DANConfig, images_np: np.ndarray, cfg_fp: str,
                         params: Optional[Mapping] = None) -> float:
    """The same detect path on this host's CPU (the kernels' plain
    versions), 1 warm-up and 2 timed calls at the bench batch; writes the
    cache and returns its img/s."""
    print(f"bench: measuring the CPU baseline at batch {len(images_np)}", file=sys.stderr)
    cpu = torch.device("cpu")
    model = Detector.from_jax_params(reference_params(cfg, params), cfg, cpu).model
    detect = build_detect_fn(cfg, cpu)
    cpu_ips = measure(detect, model, torch.from_numpy(images_np), 2, len(images_np), warmup=1)
    with open(CPU_BASELINE_CACHE, "w") as f:
        json.dump({"images_per_sec": cpu_ips, "batch": len(images_np), "config_fp": cfg_fp,
                   "note": "the port's 640x640 detect path on this host's CPU (plain kernels), "
                           "batch-matched to the card's run; re-measure with "
                           "DAN_BENCH_MEASURE_CPU=1 python -m dan_tpu_torch.tools.bench on an "
                           "idle host after a change to the path (a config change "
                           "invalidates it)"}, f)
    print(f"cpu baseline: {cpu_ips:.3f} img/s @ batch {len(images_np)} (cached)", file=sys.stderr)
    return cpu_ips


def bench_device() -> Optional[torch.device]:
    """The first CUDA card; the CPU under DAN_BENCH_ALLOW_CPU=1 when there is
    none; else None."""
    if torch.cuda.is_available():
        return torch.device("cuda", 0)
    if os.environ.get("DAN_BENCH_ALLOW_CPU") == "1":
        print("bench: DAN_BENCH_ALLOW_CPU=1 — measuring on the CPU; this number is NOT the "
              "headline metric", file=sys.stderr)
        return torch.device("cpu")
    return None


def main(config: Optional[DANConfig] = None, params: Optional[Mapping] = None) -> int:
    """The bench; `config` and `params` (a reference-layout tree) replace
    the default config and the PRNGKey(0) draw."""
    t_start = time.monotonic()
    done = arm_deadline_watchdog(deadline_s())
    try:
        return _main(config, params, t_start)
    finally:
        done.set()


def _main(config, params, t_start) -> int:
    def stage(what):
        print(f"bench: t+{time.monotonic() - t_start:.0f}s {what}", file=sys.stderr)

    cfg = config or default_config()
    device = bench_device()
    if device is None:
        print("bench: no CUDA device — aborting instead of benchmarking on the CPU. Set "
              "DAN_BENCH_ALLOW_CPU=1 to override for local testing.", file=sys.stderr)
        return NO_CARD_EXIT
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"bench device: {device} ({name})", file=sys.stderr)
    images_np = bench_images(cfg, BATCH)
    model = Detector.from_jax_params(reference_params(cfg, params), cfg, device).model
    images = torch.from_numpy(images_np).to(device)
    stage("weights and images on the device")
    launches = nms_cuda.LAUNCHES
    ips = measure(build_detect_fn(cfg, device), model, images, MEASURE_ITERS, BATCH)
    stage("measured")
    print(f"{device.type}: {ips:.2f} img/s/chip", file=sys.stderr)
    launches = nms_cuda.LAUNCHES - launches

    # -- the headline first: nothing after this point can suppress it --
    cfg_fp = config_fingerprint(cfg)
    cpu_ips, reason = read_cpu_baseline(cfg_fp)
    if cpu_ips is None:
        print(f"bench: CPU baseline unusable ({reason}); vs_baseline=null. Re-measure with "
              "DAN_BENCH_MEASURE_CPU=1 on an idle host.", file=sys.stderr)
    print(json.dumps({"metric": METRIC, "value": round(ips, 2), "unit": "images/sec/chip",
                      "vs_baseline": round(ips / cpu_ips, 2) if cpu_ips else None}))
    sys.stdout.flush()
    if launches:
        paths = nms_cuda.LAST_PATHS
        print(f"bench: greedy_nms_rank launches {launches}; rows of the last launch on the tile "
              f"scan {int((paths & nms_cuda.TILE_SCAN).sum())}/{paths.numel()}", file=sys.stderr)
    # The opt-in re-measure is forced, valid cache or not: a change to the
    # path's code does not move the fingerprint.
    if os.environ.get("DAN_BENCH_MEASURE_CPU") == "1":
        measure_cpu_baseline(cfg, images_np, cfg_fp, params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
