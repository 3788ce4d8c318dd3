#!/usr/bin/env python
"""Check the PyTorch port on one CUDA card and its host: every hand-written
kernel against its plain version, the paths that launch them, the CLIs and
tools.  The benchmark (benchmark/run.py, BENCHMARK.json) measures the paths
its cells run; this script times each kernel beside its bound and the
library call of its function, and the paths that no cell measures.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is 0 only if all pass):
  1. the card: its name and power limit (nvidia-smi);
  2. build every CUDA source (csrc/*.cu) and the host C++ helpers (native/);
  3. K1/K2 (csrc/nms.cu) == plain on the bench rows, shuffled, mixed, and a
     row's edge cases (max_out cuts, zero tails, ties, NaN boxes), with the
     path each row took (tile scan when sorted, else the argmax loop);
  4. Detector.detect() and detect_batch(): shapes, finite boxes inside the
     image, every NMS row on the tile scan; detect()'s latency (host clock);
  5. the bench path at batch 128 (tools/bench.py::build_detect_fn): its
     output and its NMS launches, every row on the tile scan;
  6. the float32 forward on the card against the CPU's, and bf16 against it;
  7. K1 and K2 timed on the bench rows; rows with a swapped pair take the
     argmax loop;
  8. the train and TTA kernels' ptxas registers, spills and shared memory;
  9. the matcher (K3/K4), the phase-pool backward (K5), the conv1_2' weight
     gradient in bf16 and float32 (K6) and the LFPN upsample's gradient ==
     plain at the train shapes and their edge cases, run to run identical;
 10. 6 train steps on one batch lower the loss, each train kernel launched
     its count a step; the train CLI with a checkpoint and a resume;
 10f. the float32 train step: TF32 off inside, two runs bit-identical, K6's
     float32 kernel alone, the card against the CPU; ms a step;
 11. each train kernel timed at the train shapes beside its bound and its
     library call (cuDNN's weight gradient, ATen's max-pool and upsample
     backwards); the upsample gradient's ring stages give the same bits;
 12. the vote (K7/K8) and blocked-NMS (K9) kernels == plain on seeded edge
     rows, the bench rows, long blocked rows and, after 13, the TTA run's
     own vote rows;
 13. the TTA path on 160 WIDER-like images: launch statistics, counters,
     bit-identical reruns, detect_tta against the dataset run (bf16 by box
     sets, float32 by value), the eval CLI's AP line; images/s, ms a bucket
     and a vote launch, peak memory, the device's busy share;
 14. K7, K8 and K9 timed, with the vote's device time and their bounds;
 15. data parallelism: NCCL at world size 1 and 2 gloo ranks on one card
     against one device, dryrun_multichip's legs, NCCL over the host's cards
     where it has two or more, the train and eval CLIs' teardown under
     torchrun; ms a step and the all-reduce's share;
 16. the int8 kernels (csrc/conv_i8.cu, quantize_i8.cu) == plain at the
     forward's 18 layer shapes and their edge cases;
 17. the int8 bench path counted (18 conv_i8, 1 quantize_i8, 1 NMS a
     step); each int8 convolution at batch 128 bit for bit over the batch
     and timed beside its bound, torch._int_mm and cuDNN's bf16 conv; the
     int8 serving path through Detector.quantize_int8 (host clock);
 18. smoke_e2e --int8 twice: the reference's AP gates, the two trained
     models identical, the kernel's int8 detections == the plain conv's;
     the deterministic mode's cost a train step;
 19. checkpoints (TF bundle, .npz, .pt) loaded bit-identical and serving the
     source's detections; a VGG-16 classifier bundle's partial import; the
     train CLI warm-started and resumed; write and read seconds;
 20. the tools and CLIs (demo, train --trace_dir / --debug_nans,
     tools.profile, TFRecords, the fixture soak, make_synth_wider + TTA
     eval), each counted; the soak's and the TTA eval's rates;
 21. the host C++ helpers: overlaps.cc == numpy, loader.cc == cv2 byte for
     byte, the native-fed train steps; profile_host_feed's rates;
 22. the bench CLIs (bench, bench_train, bench_int8, bench_tta_dataset,
     entry): exit codes, printed lines, every launch counted;
     bench_tta_dataset's rows;
 23. the long-row paths of K1/K2, K7/K8 and the matcher == plain, through
     detect, TTA and two train steps; their times and bounds;
 24. the bias + ReLU pass, its residual variant, the one-pass L2Norm and
     the LFPN's one-pass upsample x lateral == ATen's on every call of a
     bf16, int8 and RetinaFace forward and their edge cases, launches
     counted; each timed beside ATen's passes and its bound.

The line before the last is a JSON object describing each kernel (its
time, bound, library time and launches on each path); the last line is
{"ok": true, "device": {...}}.  Imports no JAX and nothing of the JAX
package.  Every phase is a function that runs alone from a script given the
card, the configuration and the inputs it checks.
"""
import collections
import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dan_tpu_torch.config import RetinaFaceConfig, default_config
from dan_tpu_torch.data.synthetic import synthetic_batch, synthetic_sample
from dan_tpu_torch.api import Detector
from dan_tpu_torch.box.anchors import generate_anchors
from dan_tpu_torch.box.iou import iou_one_to_many, pairwise_iou
from dan_tpu_torch.box.matching import MatchTargets, match_anchors
from dan_tpu_torch.ckpt import convert as ckpt_convert
from dan_tpu_torch.ckpt import train_state as ckpt
from dan_tpu_torch.ckpt.bridge import params_to_jax
from dan_tpu_torch.utils.crc32c import crc32c
from dan_tpu_torch.ckpt.load import load_params, save_npz
from dan_tpu_torch.ckpt.tf_bundle import shard_path, write_bundle
from dan_tpu_torch.ckpt.tf_import import (
    export_tf_checkpoint,
    import_tf_checkpoint,
    load_tf_checkpoint,
)
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.models.reference_init import init_reference_params
from dan_tpu_torch.models.vgg import phase_pool_with_winner, nhwc
from dan_tpu_torch.tools import profile as profile_tool
from dan_tpu_torch.tools.profile import TTA_SIZES  # the TTA run's (h, w)s
from dan_tpu_torch.eval import __main__ as eval_cli
from dan_tpu_torch.eval.tta import TTARunner, VoteRows, plan_variant_buckets
from dan_tpu_torch.eval.widerface_ap import evaluate_widerface
from dan_tpu_torch.eval.writer import load_detection_dir, write_wider_detections
from dan_tpu_torch import native
from dan_tpu_torch.ops import (
    _cuda_build,
    bbox_vote_cuda,
    bias_act_cuda,
    conv12_wgrad_cuda,
    l2norm_cuda,
    lfpn_fuse_cuda,
    conv_i8_cuda,
    matching_cuda,
    quantize_i8_cuda,
    nms_blocked_cuda,
    nms_cuda,
    phase_pool_cuda,
    upsample_cuda,
)
from dan_tpu_torch.ops.conv_i8 import conv_i8_epilogue_plain, conv_i8_plain, out_size
from dan_tpu_torch.models.detector import compute_dtype
from dan_tpu_torch.models import resnet
from dan_tpu_torch.models.layers import max_pool
from dan_tpu_torch import quant
from dan_tpu_torch.quant import QuantizedDetector, calibrate_act_scales, phase_max_i8
from dan_tpu_torch.tools import bench as bench_tool
from dan_tpu_torch.tools import smoke_e2e
from dan_tpu_torch.ops.bbox_vote import bbox_vote_batched
from dan_tpu_torch.ops.preprocess import sample_augment_batch, train_preprocess
from dan_tpu_torch.train import __main__ as train_cli
from dan_tpu_torch.train.loop import (
    create_train_state,
    loss_and_grads,
    preprocess_and_match,
    to_device,
    train_step,
)
from dan_tpu_torch.train.optim import sgd_update
from dan_tpu_torch.ops.nms import NMSResult, rank_to_result
from dan_tpu_torch.parallel.spawn import spawn
from dan_tpu_torch.tools import dryrun_multichip as dry
from dan_tpu_torch.train.loss import class_ce, hard_negatives
from dan_tpu_torch.ops.postprocess import filter_and_topk, postprocess_batch
from dan_tpu_torch.ops.preprocess import normalize_image
from dan_tpu_torch.box.decode import decode_boxes

BATCH = 128
TRAIN_BATCH = 32
SEED = 0
KERNEL_SOURCE = "dan_tpu_torch/csrc/nms.cu"
TRAIN_KERNELS = {  # module, source, the TPU kernel it replaces
    "matcher": (matching_cuda, "matching",
                "dan_tpu/ops/matching_pallas.py:87,208"),
    "phase_pool_bwd": (phase_pool_cuda, "phase_pool",
                       "dan_tpu/ops/phase_pool_pallas.py:60"),
    "conv12_wgrad": (conv12_wgrad_cuda.BF16, "conv12_wgrad",
                     "dan_tpu/ops/conv12_wgrad_pallas.py:51"),
    "conv12_wgrad_f32": (conv12_wgrad_cuda.F32, "conv12_wgrad_f32",
                         "dan_tpu/ops/conv12_wgrad_pallas.py:51 (float32 operands)"),
    "upsample2x_bwd": (upsample_cuda, "upsample2x_bwd",
                       "dan_tpu/models/layers.py:105 (no TPU kernel: XLA's transpose of "
                       "jax.image.resize's dots)"),
}
TRAIN_NAMES = tuple(TRAIN_KERNELS)
# Launches per train step in bf16 (the default): one each (the matcher
# counts calls of its C entry point, each of which launches both of its
# passes), and the LFPN's three upsample gradients; K6's float32 kernel
# none.  A float32 step launches K6's float32 kernel instead of its bf16 one.
PER_STEP = {"matcher": 1, "phase_pool_bwd": 1, "conv12_wgrad": 1, "conv12_wgrad_f32": 0,
            "upsample2x_bwd": 3}
PER_STEP_F32 = dict(PER_STEP, conv12_wgrad=0, conv12_wgrad_f32=1)
# The conv1_2' weight-gradient kernels against the plain version in float32
# (relative L2): the bf16 kernel's tensor cores add with less than float32's
# rounding, an error that grows with the chain (PERF.md).  The float32
# kernel differs from the plain version only in the order of its sums, but
# the plain version (cuDNN's float32 weight gradient) is itself about 3e-5
# from the exact value at the train shape (phase 9 prints it against a
# float64 oracle), so the float32 kernel is held to 1e-5 of that oracle,
# and to 1e-4 of the plain version.
WGRAD_RTOL = {torch.bfloat16: 1e-4, torch.float32: 1e-4}
WGRAD_F64_RTOL = 1e-5
# The float32 train phase (10f): batch, steps a run, and the image size of
# the step held against the CPU (the CPU parity test's).
F32_BATCH = 8
F32_STEPS = 4
F32_CPU_SIZE = 64
# The upsample gradients of one train step at batch 32, 640x640: g of the
# fc7 -> conv5_3, conv5_3 -> conv4_3 and conv4_3 -> conv3_3 blocks.
UPSAMPLE_SHAPES = ((TRAIN_BATCH, 512, 40, 40), (TRAIN_BATCH, 512, 80, 80),
                   (TRAIN_BATCH, 256, 160, 160))
# The matcher's kernels: pass 1 (K3) is the first two, pass 2 (K4) the last.
MATCHER_KERNELS = ("anchor_best_kernel", "gt_stats_kernel", "assign_kernel")
TTA_SOURCES = ("bbox_vote", "nms_blocked")
INT8_SOURCE = "conv_i8"
QUANT_SOURCE = "quantize_i8"
BIAS_ACT_SOURCE = "bias_act"
# Phase 24: launches of the bias + ReLU pass a forward at 640x640 (bf16: 19
# in the backbone, 6 LFPN, 6 heads; int8: conv1_1', 6 LFPN, 6 heads); the
# values written channel by channel into the first and last pixel of each
# checked output, and the first three biases of every convolution.
BIAS_ACT_PER_FORWARD = {"bf16": 31, "int8": 13}
# RetinaFace-R50's forward at 840x840: the plain pass 60 times (the stem, 2
# a bottleneck, 4 downsamples, 5 FPN, 15 SSH, 3 merged heads) and the
# residual variant once a bottleneck.
RETINAFACE_PASSES = {"bias_act": 60, "residual": 16}
# Phase 24 (L2Norm): launches of the one-pass L2Norm a DAN forward (its
# three shallow taps; none in a recorded forward, a TTA launch or a
# RetinaFace forward), its eps, and the largest distance from ATen's output
# in units in the last place: one bf16 ulp (the rounding of a product that
# differs in its last bits, since the two sum the squares in other orders);
# in float32 the same differences show at float32's finer grain.
L2NORM_SOURCE = "l2norm"
L2NORM_PER_FORWARD = 3
L2NORM_EPS = 1e-12
L2NORM_ULPS = {torch.bfloat16: 1, torch.float32: 16}
# Phase 24 (LFPN fuse): launches of the LFPN's one-pass upsample x lateral
# a DAN forward (its three blocks; none in a recorded forward, a TTA launch
# or a RetinaFace forward).  Its bits are ATen's upsample-then-product: in
# bf16 at every width, in float32 from LFPN_FUSE_NHWC_C channels, where
# ATen takes its channels-last kernel; below, ATen's NCHW kernel contracts
# its FMAs in another order, and float32 there is held to LFPN_FUSE_F32_RTOL
# of the largest value.
LFPN_FUSE_SOURCE = "lfpn_fuse"
LFPN_FUSE_PER_FORWARD = 3
LFPN_FUSE_NHWC_C = 16
LFPN_FUSE_F32_RTOL = 1e-6
RETINAFACE_SIZE = 840
BIAS_ACT_SPECIALS = (float("nan"), -0.0, 0.0, float("inf"), -float("inf"), 1.0, 1.0078125, -1.0)
BIAS_ACT_BIASES = (2.0 ** -8, -0.0, 0.0)
TTA_IMAGES = 160
# Least share of a bf16 dataset run's boxes that must have a partner in the
# per-image detect_tta of the same image at IoU > 0.5 and at IoU > 0.9.  On
# an H100 the least shares over 8 images were 0.953 and 0.749 (random
# weights, whose saturated scores tie).
BF16_MATCH = (0.9, 0.7)
# The same in float32, by value: the share of an image's boxes that may lack
# a partner within rtol 1e-4 / atol 1e-2 px and score rtol 1e-4 (a near-tied
# decision that fell the other way; a wrong variant would move a sixth).
F32_LONE_BOXES = 0.01
# Published peaks of one H100 SXM (NVIDIA's data sheet, 700 W): device
# memory rate, float32 outside the tensor cores, dense bf16.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
# Phase 15: DP train steps and TTA images a leg; the tolerances of a
# 2-rank step against one device in bf16 (the ranks' forward runs at batch
# 16, whose convolutions may take other kernels than batch 32's): the loss
# and the relative L2 of the 3-step parameter update.
DP_STEPS = 3
DP_TTA_IMAGES = 32
DP_LOSS_RTOL = 1e-2
DP_UPDATE_RTOL = 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def train_launches_ok(c, steps) -> bool:
    """Each train kernel launched its count a step (PER_STEP) in `steps`
    steps."""
    return all(c[k] == PER_STEP[k] * steps for k in TRAIN_NAMES)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of fn() over `iters` calls, CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, ops: float, peak_ops: float):
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the peak rate.  -> (ms, which)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# Operations a candidate costs in one dependent step of a greedy selection:
# an IoU against the selected box (4 max/min, 2 subtractions, 2 clamps, a
# product, 2 for the union, the union > 0 test, a division; areas are made
# once), the threshold test, and the compare of the running argmax.  A
# detection that merges into a vote output costs five multiply-adds, once.
IOU_OPS, TEST_OPS, ARGMAX_OPS, MERGE_OPS = 13, 1, 1, 10


def selection_work(boxes, scores, active, thr, max_out, inclusive):
    """Replay the greedy selection that NMS and the vote share, all rows in
    lockstep, to count what this data needs: up to max_out times a row,
    take the active candidate of highest score (lowest index on ties) and
    deactivate it and every active candidate whose IoU with it is > thr
    (>= thr when `inclusive`).  boxes (B, N, 4), scores (B, N), active
    (B, N) bool -> per row, as int64 tensors: the dependent steps, the
    (selected, other still active) pairs summed over the steps -- the IoUs
    the function cannot do without -- and the candidates deactivated."""
    bsz, n = scores.shape
    dev = boxes.device
    col, rows = torch.arange(n, device=dev), torch.arange(bsz, device=dev)
    neg_inf = torch.tensor(-float("inf"), dtype=torch.float32, device=dev)
    thr_t = torch.tensor(thr, dtype=torch.float32, device=dev)
    steps = torch.zeros(bsz, dtype=torch.int64, device=dev)
    pairs = torch.zeros(bsz, dtype=torch.int64, device=dev)
    at_start = active.sum(dim=1)
    for i in range(max_out):
        if i % 16 == 0 and not bool(active.any()):
            break
        masked = torch.where(active, scores, neg_inf)
        best = masked.max(dim=1).values
        live = best > neg_inf
        j = torch.where(masked == best[:, None], col, n).min(dim=1).values
        j = torch.where(live, j, 0)
        iou = iou_one_to_many(boxes[rows, j], boxes)
        hit = (iou >= thr_t) if inclusive else (iou > thr_t)
        steps += live
        pairs += (active.sum(dim=1) - 1).clamp_min(0)
        active = active & ~(hit | (col == j[:, None]))
    return steps, pairs, at_start - active.sum(dim=1)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def turns(kernel, library, kernel_iters=10, library_iters=2):
    """Mean ms of kernel() and of the library call that computes its
    function, timed in turns library, kernel, kernel, library after one warm
    call of each.  Each kernel turn follows three untimed calls, so that no
    turn starts cold after the library's run."""
    kernel()
    library()
    torch.cuda.synchronize()
    times = {"library": [], "kernel": []}
    for which in ("library", "kernel", "kernel", "library"):
        fn, iters = (kernel, kernel_iters) if which == "kernel" else (library, library_iters)
        if which == "kernel":
            for _ in range(3):
                fn()
        times[which].append(cuda_ms(fn, iters))
    return {k: float(np.mean(v)) for k, v in times.items()}


def host_ms(fn, iters=20) -> float:
    """Mean host milliseconds a call of fn() takes to return (what it
    enqueues is not waited for)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return t


def device_ms(fn, iters, names, alone=None, sessions=3):
    """Device time per call of fn() spent in the CUDA kernels whose names
    contain each of `names`, from torch.profiler over `iters` calls after
    one warm call -> ({name: ms}, how it was measured).

    The profiled calls sit 50 ms inside the session on both sides, and a
    session whose events lack a named kernel is profiled again, up to
    `sessions` times: CUPTI has delivered a short session without its
    kernel records.  If none shows every named kernel, a single name is
    timed with CUDA events over `iters` back-to-back calls of alone(), which
    launches that kernel and nothing else on the device; else this raises."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for session in range(1, sessions + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(0.05)
        out = dict.fromkeys(names, 0.0)
        seen = 0
        for e in prof.key_averages():
            if e.device_type.name == "CUDA":
                seen += e.count
                for name in names:
                    if name in e.key:
                        out[name] += e.self_device_time_total / 1e3 / iters
        if all(v > 0.0 for v in out.values()):
            return out, "torch.profiler"
        log(f"  torch.profiler session {session} of {sessions}: no device time for some of "
            f"{names} ({out}; {seen} device events in all)")
    if alone is None or len(names) != 1:
        raise AssertionError(f"the profiler shows no device time for some of {names}")
    alone()
    torch.cuda.synchronize()
    return {names[0]: cuda_ms(alone, iters)}, "CUDA events over the kernel's launches alone"


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (floats compared as integers of their width: a NaN
    equals its copy, -0 differs from +0)."""
    if a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.view(as_int), b.view(as_int))
    return torch.equal(a, b)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


def nms_candidates(det: Detector, images_u8: torch.Tensor):
    """The pre-NMS (boxes, scores) rows of the bench path: decode, filter
    and top-k after one forward."""
    cfg = det.config
    size = float(cfg.model.image_size)
    with torch.inference_mode():
        cls, loc = det.model(normalize_image(images_u8.float(), cfg.preprocess))
        scores = torch.softmax(cls, dim=-1)[..., 1]
        boxes = decode_boxes(loc, det.anchors, cfg.anchors.prior_scaling, size, size)
        boxes_k, scores_k = filter_and_topk(boxes, scores, cfg.postprocess)
    return boxes_k, scores_k


def compare_kernel(boxes, scores, thr, max_out, score_thr=0.0, path=None, what="") -> int:
    """Kernel vs plain version on the same CUDA tensors; raises unless the
    ranks, indices and valid flags are identical and, where `path` is given
    (1 = tile scan, 0 = argmax loop, plus 2 for the long-row path; an int
    for all rows or one per row), unless each row took that path.  Returns
    max |rank diff|."""
    got = nms_cuda.greedy_nms_rank(boxes, scores, thr, max_out, score_thr)
    paths = nms_cuda.LAST_PATHS
    want = nms_cuda.greedy_nms_rank_plain(boxes, scores, thr, max_out, score_thr)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    rg = rank_to_result(got, boxes, scores, max_out)
    rw = rank_to_result(want, boxes, scores, max_out)
    if not (torch.equal(got, want) and torch.equal(rg.indices, rw.indices)
            and torch.equal(rg.valid, rw.valid)):
        raise AssertionError(
            f"NMS kernel != plain at {tuple(scores.shape)} max_out={max_out} {what}: "
            f"{int((got != want).sum())} ranks differ"
        )
    if not torch.equal((paths & nms_cuda.TILE_SCAN).bool(), nms_cuda.rows_sorted(scores)):
        raise AssertionError(f"{what}: the kernel's path choice is not rows_sorted()'s")
    if path is not None:
        expect = torch.as_tensor(path, dtype=torch.uint8, device=paths.device).expand_as(paths)
        if not torch.equal(paths, expect):
            raise AssertionError(
                f"NMS {what} at {tuple(scores.shape)}: rows took paths {paths.tolist()[:16]}..., "
                f"expected {expect.tolist()[:16]}... (1 = tile scan, + 2 = long row)")
    log(f"  kernel == plain at B={scores.shape[0]} N={scores.shape[1]} "
        f"max_out={max_out} thr={thr} score_thr={score_thr}{' ' + what if what else ''}: "
        f"{int((got >= 0).sum())} kept; tile scan on {int((paths & nms_cuda.TILE_SCAN).sum())} "
        f"of {paths.numel()} rows, the long-row path on "
        f"{int(((paths & nms_cuda.LONG_ROW) != 0).sum())}, at most "
        f"{int(nms_cuda.LAST_TILES.max())} tiles")
    return err


def shuffle_rows(boxes, scores, seed):
    """Each row's boxes in a random order that keeps boxes of equal score in
    their relative order, so the greedy selection (lowest index on ties)
    picks the same boxes in the same order.  -> boxes, scores, and pos with
    shuffled[b, pos[b, j]] = sorted[b, j]."""
    bsz, n = scores.shape
    gen = torch.Generator(device=scores.device).manual_seed(seed)
    pos = torch.argsort(torch.rand((bsz, n), generator=gen, device=scores.device), dim=1)
    group = torch.cumsum(
        torch.nn.functional.pad(scores[:, 1:] != scores[:, :-1], (1, 0)).long(), dim=1)
    # Within a group of equal scores (adjacent in a sorted row) the positions
    # drawn for it, in ascending order.
    pos = torch.gather(pos, 1, torch.argsort(group * n + pos, dim=1))
    out_b = torch.empty_like(boxes).scatter_(1, pos[..., None].expand(-1, -1, 4), boxes)
    out_s = torch.empty_like(scores).scatter_(1, pos, scores)
    return out_b, out_s, pos


def random_boxes(rng, n):
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(2, 40, (n, 2))
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


def vote_edge_rows(rng, n, thr=0.3):
    """Seeded (7, n) vote inputs that exercise the contract's edges, as
    numpy (boxes (7, n, 4) f32, scores (7, n) f32, valid (7, n) bool):
      0  clustered boxes (many merges), a random validity mask;
      1  no valid detection;
      2  every row valid (the loop runs to max_out or to exhaustion);
      3  exact score ties: scores from 5 distinct values;
      4  a pair whose IoU is exactly `thr` (inter 3, union 10 for 0.3) among
         far-away boxes, the pair on top;
      5  valid detections with score <= 0 (never active);
      6  valid detections packed to the front, zero padding behind."""
    boxes = np.zeros((7, n, 4), np.float32)
    scores = np.zeros((7, n), np.float32)
    valid = np.zeros((7, n), bool)

    def rand_boxes(k):
        xy = rng.uniform(0, 1000, (k, 2))
        wh = rng.uniform(8, 200, (k, 2))
        return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)

    centers = rand_boxes(max(n // 12, 1))
    boxes[0] = centers[rng.integers(0, len(centers), n)] + rng.normal(0, 4, (n, 4))
    scores[0] = rng.uniform(0.05, 1.0, n)
    valid[0] = rng.uniform(size=n) > 0.3
    boxes[1], scores[1] = rand_boxes(n), rng.uniform(0.05, 1.0, n)
    boxes[2], scores[2], valid[2] = rand_boxes(n), rng.uniform(0.05, 1.0, n), True
    boxes[3] = centers[rng.integers(0, len(centers), n)] + rng.normal(0, 6, (n, 4))
    scores[3] = rng.choice(np.float32([0.2, 0.4, 0.6, 0.8, 1.0]), n)
    valid[3] = True
    far = np.arange(n, dtype=np.float32)[:, None] * 50 + np.float32([2000, 0, 2010, 10])
    boxes[4] = far
    boxes[4, 0] = [0.0, 0.0, 6.5, 1.0]
    boxes[4, 1] = [3.5, 0.0, 10.0, 1.0]
    if thr != 0.3:
        raise ValueError("the exact-IoU pair is built for a threshold of 0.3")
    scores[4] = rng.uniform(0.05, 0.5, n)
    scores[4, :2] = [0.9, 0.8]
    valid[4] = True
    boxes[5] = rand_boxes(n)
    scores[5] = rng.uniform(-0.5, 1.0, n)
    scores[5, ::7] = 0.0
    valid[5] = True
    k = n // 3
    boxes[6, :k], scores[6, :k], valid[6, :k] = rand_boxes(k), rng.uniform(0.05, 1.0, k), True
    return boxes, scores.astype(np.float32), valid


def check_dets(dets, images, max_det):
    for d, im in zip(dets, images):
        h, w = im.shape[:2]
        b, s = d["bboxes"], d["scores"]
        if b.ndim != 2 or b.shape[1] != 4 or s.shape != (b.shape[0],):
            raise AssertionError(f"bad detection shapes {b.shape} {s.shape}")
        if not (np.isfinite(b).all() and np.isfinite(s).all()):
            raise AssertionError("non-finite detections")
        if b.shape[0] > max_det or b.shape[0] == 0:
            raise AssertionError(f"{b.shape[0]} detections (max {max_det})")
        if (b[:, [0, 2]].max() > w + 1e-3 or b[:, [1, 3]].max() > h + 1e-3
                or b.min() < -1e-3):
            raise AssertionError(f"boxes leave the {h}x{w} image")
        if not (s[:-1] >= s[1:]).all():
            raise AssertionError("scores not in descending order")


def main() -> int:
    t_start = time.perf_counter()
    # -- 1. the card ---------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} CUDA device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _cuda_build.build_all(["nms"] + [src for _, src, _ in TRAIN_KERNELS.values()]
                          + list(TTA_SOURCES) + [INT8_SOURCE, QUANT_SOURCE, BIAS_ACT_SOURCE,
                                                            L2NORM_SOURCE, LFPN_FUSE_SOURCE])
    secs = _cuda_build.BUILDS["nms"].seconds
    log(f"phase 2: built all CUDA sources in {time.perf_counter() - t0:.3f} s; "
        f"{KERNEL_SOURCE} " + (f"in {secs:.3f} s" if secs is not None else "was already built"))
    for line in _cuda_build.ptxas_summary("nms"):
        log(f"  ptxas: {line}")
    native.load()
    native.load_loader()
    log(f"phase 2: host helpers (g++, seconds; None = found built): {native.BUILD_SECONDS}")

    # -- 3-7. the NMS kernel; the detect and bench paths ---------------------
    cfg = default_config()
    post = cfg.postprocess
    size = cfg.model.image_size
    det = Detector.from_random(SEED, cfg, dev)
    rng = np.random.default_rng(SEED)
    images_u8 = torch.from_numpy(
        rng.integers(0, 255, (BATCH, size, size, 3), dtype=np.uint8)
    ).to(dev)
    k1 = phase3(det, images_u8, rng, post, dev)
    launches_one, launches_batched = phase45(det, images_u8, rng, cfg, dev)
    phase6(det, images_u8, cfg, dev)
    nms_ms = phase7(k1["boxes"], k1["scores"], k1["tiles"], post, dev, smi)
    nms_rows, nan_row = k1["nms_rows"], k1["nan_row"]
    del det, images_u8, k1["boxes"], k1["scores"]
    torch.cuda.empty_cache()

    # -- 8. build of the train-step and TTA kernels ---------------------------
    for src in [src for _, src, _ in TRAIN_KERNELS.values()] + list(TTA_SOURCES):
        secs = _cuda_build.BUILDS[src].seconds
        log(f"phase 8: csrc/{src}.cu " + (f"built in {secs:.3f} s" if secs is not None
                                          else "was already built"))
        for line in _cuda_build.ptxas_summary(src):
            log(f"  ptxas: {line}")

    # -- 9. train kernels vs plain at the train shapes ------------------------
    tcfg = train_config(cfg)
    errs, cases = phase9(tcfg, dev)

    # -- 10. the train step, counted; 10f. in float32 -----------------------------
    launches = phase10(tcfg, dev)
    launches["conv12_wgrad_f32"] = phase10f(tcfg, dev, smi)

    # -- 11. train kernel timing -----------------------------------------------
    train_ms, train_bounds = phase11(cases, smi)
    del cases
    torch.cuda.empty_cache()

    # -- 12a, 13, 12b, 14: the TTA evaluation path ---------------------------------
    vote_err = phase12_synthetic(post, dev)
    blocked_err = phase12_blocked(nms_rows, nan_row, post, dev)
    tta = phase13(cfg, dev, smi)
    vote_err = max(vote_err, phase12_real(tta["vote_inputs"], post, dev))
    tta_ms, tta_bounds = phase14(tta["vote_inputs"], nms_rows, post, dev, smi)
    del tta["vote_inputs"], nms_rows
    torch.cuda.empty_cache()

    # -- 15. data parallel ---------------------------------------------------
    dp_launches = phase15(cfg, tcfg, dev, smi)

    # -- 16-18. int8 deployment -------------------------------------------------
    det8, qdet, images8, i8_err, quant_err = phase16(cfg, dev)
    i8 = phase17(cfg, dev, smi, det8, qdet, images8)
    del det8, qdet, images8
    torch.cuda.empty_cache()
    phase18(dev, smi)

    # -- 19. checkpoint loading; 20. the tools -----------------------------------
    with tempfile.TemporaryDirectory() as d:
        ck = phase19(cfg, dev, smi, d)
        tools, soak_dir = phase20(cfg, dev, smi, d)
        nat = phase21(dev, smi, d, soak_dir)

    # -- 22. the bench entry points ------------------------------------------
    bl = phase22(cfg, dev, smi)

    # -- 23. long rows ---------------------------------------------------------
    lr = phase23(cfg, dev, smi)
    lr_nms, lr_vote, lr_tta = lr["nms"], lr["vote"], lr["tta"]
    err_b, err_1 = max(k1["err_b"], lr_nms["err"]), max(k1["err_1"], lr_nms["err"])
    vote_err = max(vote_err, lr_vote["err"], lr_tta["err"])

    # -- 24. the bias + ReLU pass ------------------------------------------------
    ba = phase24(cfg, dev, smi)

    n_rows, n_box = BATCH, post.pre_nms_topk
    # NMS: 20 bytes a box in, its rank out; for every selected box an IoU, a
    # threshold test and (the input need not be sorted) an argmax compare
    # for every box that is still active, counted from this run's rows.  The
    # chain of dependent steps is the tile scan's tiles.
    pair_ops = IOU_OPS + TEST_OPS + ARGMAX_OPS
    nms_pairs, nms_tiles, kept_rows = k1["pairs"], k1["tiles"], k1["kept"]
    b_nms = bound(n_rows * n_box * 24, int(nms_pairs.sum()) * pair_ops, PEAK_F32)
    b_nms1 = bound(n_box * 24, int(nms_pairs[0]) * pair_ops, PEAK_F32)
    kernels = [
        {"name": "greedy_nms_rank (batched)", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "dan_tpu/ops/nms_batched_pallas.py:29", "launches": launches_batched,
         "launches_tta": tta["nms_launches"], "max_abs_err": err_b, "ms": nms_ms["kernel"],
         "bound_ms": b_nms[0],
         "bound_by": b_nms[1], "dependent_steps": int(nms_tiles.max()),
         "kept": int(kept_rows.max()), "library_ms": None,
         "launches_dp_ranks": [r["nms"] for r in dp_launches["tta"]],
         "launches_ckpt": ck["nms_batched"], "launches_tools": tools["K1"],
         "launches_bench": bl["K1"], "launches_long_rows": lr_nms["launches"]["K1"],
         "long_row": dict(lr_nms["K1"], shape=lr_nms["shape"],
                          jax_longest_row_ms=lr_nms["jax_row_ms"])},
        {"name": "greedy_nms_rank (B=1)", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "dan_tpu/ops/nms_pallas.py:34", "launches": launches_one,
         "max_abs_err": err_1, "ms": nms_ms["kernel1"],
         "bound_ms": b_nms1[0], "bound_by": b_nms1[1],
         "dependent_steps": int(nms_tiles[0]), "kept": int(kept_rows[0]), "library_ms": None,
         "launches_ckpt": ck["nms_one"], "launches_tools": tools["K2"],
         "launches_native": nat["nms"], "launches_bench": bl["K2"],
         "launches_long_rows": lr_nms["launches"]["K2"],
         "long_row": dict(lr_nms["K2"], shape=[1] + lr_nms["shape"][1:])},
    ]
    for name, (_, src, replaces) in TRAIN_KERNELS.items():
        entry = {
            "name": name, "route": "cuda", "source": f"dan_tpu_torch/csrc/{src}.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": errs[name],
            "ms": train_ms[name]["kernel"], "library_ms": train_ms[name].get("library"),
            "launches_dp_ranks": [r[name] for r in dp_launches["train"]],
            "launches_dryrun_ranks": [r[name] for r in dp_launches["dryrun"]],
            "launches_ckpt": ck["train"][name], "launches_tools": tools[name],
            "launches_native": nat[name], "launches_bench": bl[name]}
        if name in ("conv12_wgrad", "conv12_wgrad_f32"):
            plan = train_bounds[f"{name} tiling"]
            entry.update(partials=plan.partials, flush_pixels=plan.flush_segs * plan.seg,
                         pixels_per_block=plan.segs_per_range * plan.seg)
        if name != "matcher":
            ms_b, by = train_bounds[name]
            kernels.append(dict(entry, bound_ms=ms_b, bound_by=by))
            continue
        # One call of the matcher launches both passes: one entry for each
        # TPU kernel with its own bound and its kernels' device time; `ms` is
        # the call's (both passes and the wrapper's host work).
        dev_t = train_ms[name]["device"]
        for pass_name, line, names in (("matcher pass 1", 87, MATCHER_KERNELS[:2]),
                                       ("matcher pass 2", 208, MATCHER_KERNELS[2:])):
            ms_b, by = train_bounds[pass_name]
            lb = lr["matcher"]["bounds"][pass_name]
            kernels.append(dict(
                entry, name=pass_name, replaces=f"dan_tpu/ops/matching_pallas.py:{line}",
                bound_ms=ms_b, bound_by=by, device_ms=sum(dev_t[k] for k in names),
                ms_covers="one match_anchors_cuda call: both passes and the wrapper",
                launches_long_rows=lr["matcher"]["launches"],
                long_row={"shape": lr["matcher"]["shape"], "ms": lr["matcher"]["ms"],
                          "bound_ms": lb[0], "bound_by": lb[1],
                          "valid_gts": lr["matcher"]["valid_gts"]}))
    vote_src = "dan_tpu_torch/csrc/bbox_vote.cu"
    kernels += [
        {"name": "bbox_vote (batched)", "route": "cuda", "source": vote_src,
         "replaces": "dan_tpu/ops/bbox_vote_pallas.py:162", "launches": tta["vote_launches"],
         "max_abs_err": vote_err, "ms": tta_ms["vote"]["kernel"],
         "device_ms": tta_ms["vote"]["device"], "device_ms_from": tta_ms["vote"]["device_from"],
         "bound_ms": tta_bounds["vote"][0], "bound_by": tta_bounds["vote"][1],
         "dependent_steps": tta_bounds["vote"][2], "outputs": tta_bounds["vote"][3],
         "library_ms": None, "launches_dp_ranks": [r["bbox_vote"] for r in dp_launches["tta"]],
         "launches_tools": tools["K7"], "launches_bench": bl["K7"],
         "launches_long_rows": lr_tta["K7"], "long_row": lr_vote["K7"]},
        {"name": "bbox_vote (B=1)", "route": "cuda", "source": vote_src,
         "replaces": "dan_tpu/ops/bbox_vote_pallas.py:30", "launches": tta["vote_launches_one"],
         "max_abs_err": vote_err, "ms": tta_ms["vote1"]["kernel"],
         "device_ms": tta_ms["vote1"]["device"], "device_ms_from": tta_ms["vote1"]["device_from"],
         "bound_ms": tta_bounds["vote1"][0], "bound_by": tta_bounds["vote1"][1],
         "dependent_steps": tta_bounds["vote1"][2], "outputs": tta_bounds["vote1"][3],
         "library_ms": None, "launches_tools": tools["K8"], "launches_bench": bl["K8"],
         "launches_long_rows": lr_tta["K8"], "long_row": lr_vote["K8"]},
        {"name": "greedy_nms_blocked", "route": "cuda",
         "source": "dan_tpu_torch/csrc/nms_blocked.cu",
         "replaces": "dan_tpu/ops/nms_blocked_pallas.py:39",
         "launches": tta["blocked_launches"], "max_abs_err": blocked_err,
         "ms": tta_ms["blocked"]["kernel"], "launch_ms": tta_ms["blocked"]["launch"],
         "pass1_ms": tta_ms["blocked"]["pass1"], "pass2_ms": tta_ms["blocked"]["pass2"],
         "ms_covers": "the wrapper: order check that waits for the device, both passes, "
                      "rank_to_result; launch_ms is the two passes alone, pass1_ms / pass2_ms "
                      "each alone",
         "bound_ms": tta_bounds["blocked"][0], "bound_by": tta_bounds["blocked"][1],
         "dependent_steps": tta_bounds["blocked"][2], "library_ms": None,
         "launches_tools": tools["K9"], "launches_bench": bl["K9"]},
    ]
    kernels.append(
        {"name": "conv_i8", "route": "cuda", "source": f"dan_tpu_torch/csrc/{INT8_SOURCE}.cu",
         "replaces": I8_REPLACES, "launches": i8["launches"],
         "max_abs_err": max(i8_err, i8["err"]),
         "ms": i8["ms"], "bound_ms": i8["bound"],
         "bound_by": i8["bound_by"], "library_ms": i8["library"], "cudnn_bf16_ms": i8["cudnn"],
         "ms_covers": f"the {I8_PER_FORWARD} convolutions of one int8 forward at batch {BATCH}, "
                      "640x640, each timed alone as the forward launches it (conv1_2' with "
                      "the phase max fused); library_ms is torch._int_mm over each "
                      "layer's im2col; bound_ms counts conv1_2' as the 3x3 conv it computes "
                      "(the packed 2x2 form's zero taps left out)",
         "launches_per_forward": i8["launches"] // i8["iters"],
         "launches_tools": tools["conv_i8"], "launches_bench": bl["conv_i8"]})
    kernels.append(
        {"name": "quantize_i8", "route": "cuda", "source": f"dan_tpu_torch/csrc/{QUANT_SOURCE}.cu",
         "replaces": "dan_tpu/quant.py:383-394 (no TPU kernel: XLA's fused relu + "
                     "_quantize_act of conv1_1')",
         "launches": i8["quant"]["launches"],
         "max_abs_err": max(quant_err, i8["quant"]["err"]), "ms": i8["quant"]["ms"],
         "bound_ms": i8["quant"]["bound"][0],
         "bound_by": i8["quant"]["bound"][1], "library_ms": None,
         "launches_tools": tools["quantize_i8"], "launches_bench": bl["quantize_i8"]})
    kernels.append(
        {"name": "bias_act", "route": "cuda", "source": f"dan_tpu_torch/csrc/{BIAS_ACT_SOURCE}.cu",
         "replaces": "no TPU kernel: ATen's broadcast bias add and ReLU clamp after each "
                     "inference convolution (XLA fuses them into the TPU convolution)",
         "launches_per_forward": ba["launches"], "max_abs_err": 0.0,
         "ms": ba["ms"], "library_ms": ba["aten_ms"], "bound_ms": ba["bound_ms"],
         "bound_by": "bytes",
         "ms_covers": "each of a forward's calls at batch 128, 640x640, timed alone at its "
                      "shape and summed (bf16 and int8 forwards); library_ms is ATen's "
                      "in-place add and F.relu on the same tensors"})
    nl, lf = ba["l2norm"], ba["lfpn_fuse"]
    kernels.append(
        {"name": "l2norm", "route": "cuda", "source": f"dan_tpu_torch/csrc/{L2NORM_SOURCE}.cu",
         "replaces": "no TPU kernel: ATen's six passes of L2Norm on the three shallow taps "
                     "(XLA fuses L2Norm on the TPU)",
         "launches_per_forward": ba["l2norm_launches"],
         "max_ulps": {k: nl[k]["max_ulps"] for k in ("bf16", "f32")},
         "share_differing": {k: nl[k]["share_differing"] for k in ("bf16", "f32")},
         "ms": nl["ms"], "library_ms": nl["aten_ms"],
         "bound_ms": nl["bound_ms"], "bound_by": "bytes",
         "ms_covers": "the three taps of a bf16 forward at batch 128, 640x640, each timed "
                      "alone and summed; library_ms is ATen's expression (the kernel's plain "
                      "version) on the same tensors"})
    kernels.append(
        {"name": "lfpn_fuse", "route": "cuda",
         "source": f"dan_tpu_torch/csrc/{LFPN_FUSE_SOURCE}.cu",
         "replaces": "no TPU kernel: ATen's upsample_bilinear2d_nhwc and product of the LFPN's "
                     "three blocks (XLA fuses the resize and the product on the TPU)",
         "launches_per_forward": ba["lfpn_fuse_launches"], "max_ulps": 0,
         "ms": lf["ms"], "library_ms": lf["aten_ms"], "bound_ms": lf["bound_ms"],
         "bound_by": "bytes",
         "ms_covers": "the three LFPN blocks of a bf16 forward at batch 128, 640x640, each timed "
                      "alone in turns with ATen's upsample-then-product (library_ms) and summed; "
                      "bound_ms counts the top-down maps read once, the lateral maps read once "
                      "and the fused maps written once"})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


def phase3(det, images_u8, rng, post, dev):
    """The NMS kernel against its plain version on the card (compare_kernel):
    the bench rows of one forward, shuffled, mixed, and one row's edge cases.
    -> the rows later phases take, the largest rank differences, and what
    the bounds count: kept boxes, tiles and IoU pairs a row."""
    boxes_k, scores_k = nms_candidates(det, images_u8)
    log(f"phase 3: NMS rows {tuple(boxes_k.shape)} from a random-init forward")
    thr, max_out = post.nms_iou_threshold, post.max_detections
    ties = int((scores_k[:, 1:] == scores_k[:, :-1]).sum(dim=1).max())
    # The bench rows: sorted by filter_and_topk, with exact ties (up to
    # `ties` adjacent equal scores a row): every row must take the tile scan.
    err_b = compare_kernel(boxes_k, scores_k, thr, max_out, path=1,
                           what=f"bench rows (<= {ties} tied neighbours a row)")
    sorted_rank = nms_cuda.greedy_nms_rank(boxes_k, scores_k, thr, max_out)
    # The same rows shuffled (ties keep their order): the argmax loop, and
    # the same boxes kept with the same ranks.
    boxes_u, scores_u, pos = shuffle_rows(boxes_k, scores_k, SEED + 3)
    err_b = max(err_b, compare_kernel(boxes_u, scores_u, thr, max_out, path=0,
                                      what="bench rows shuffled"))
    if not torch.equal(torch.gather(nms_cuda.greedy_nms_rank(boxes_u, scores_u, thr, max_out),
                                    1, pos), sorted_rank):
        raise AssertionError("the argmax loop on shuffled rows keeps other boxes than the tile "
                             "scan on the sorted rows")
    log("  shuffled rows keep the same boxes with the same ranks as the sorted rows")
    # One launch that mixes both kinds of row.
    odd = (torch.arange(BATCH, device=dev) % 2 == 1)
    err_b = max(err_b, compare_kernel(
        torch.where(odd[:, None, None], boxes_u, boxes_k),
        torch.where(odd[:, None], scores_u, scores_k), thr, max_out,
        path=(~odd).to(torch.uint8), what="sorted and shuffled rows in one launch"))
    del boxes_u, scores_u
    b1, s1 = boxes_k[:1].contiguous(), scores_k[:1].contiguous()
    err_1 = compare_kernel(b1, s1, thr, max_out, path=1, what="one bench row")
    # max_out inside a tile and one past a tile's edge.
    for cut in (20, 65):
        err_1 = max(err_1, compare_kernel(b1, s1, thr, cut, path=1, what="max_out cut"))
    err_1 = max(err_1, compare_kernel(b1, s1, thr, max_out, score_thr=0.5, path=1,
                                      what="score threshold"))
    # A tail of zeros from the first box, from box 64 and from box 100.
    for start in (0, 64, 100):
        s_tail = s1.clone()
        s_tail[:, start:] = 0.0
        err_1 = max(err_1, compare_kernel(b1, s_tail, thr, max_out, path=1,
                                          what=f"zeros from box {start}"))
    # Sorted but for one swapped pair: the argmax loop.
    lo = int((s1[0, 1:] < s1[0, :-1]).nonzero()[0])  # first strict descent
    s_swap = s1.clone()
    s_swap[0, lo], s_swap[0, lo + 1] = s1[0, lo + 1], s1[0, lo]
    err_1 = max(err_1, compare_kernel(b1, s_swap, thr, max_out, path=0, what="one swapped pair"))
    # Equal boxes with equal scores: the first is kept alone.
    same_b, same_s = b1[:, :1].expand(-1, 300, -1).contiguous(), torch.full((1, 300), 0.7, device=dev)
    err_1 = max(err_1, compare_kernel(same_b, same_s, thr, max_out, path=1, what="equal boxes"))
    if int((nms_cuda.greedy_nms_rank(same_b, same_s, thr, max_out) >= 0).sum()) != 1:
        raise AssertionError("equal boxes with equal scores kept more than one")
    # Partial tiles, sorted and unsorted, on seeded boxes.
    b = torch.from_numpy(random_boxes(rng, 257)[None]).to(dev)
    s = torch.from_numpy(rng.uniform(0.01, 1.0, (1, 257)).astype(np.float32)).to(dev)
    s_desc = torch.sort(s, dim=1, descending=True).values
    for n in (257, 64, 1):
        err_1 = max(err_1, compare_kernel(b[:, :n].contiguous(), s_desc[:, :n].contiguous(),
                                          0.4, 750, path=1, what="sorted"))
    err_1 = max(err_1, compare_kernel(b, s, 0.4, 20, path=0))
    err_1 = max(err_1, compare_kernel(b, s, 0.3, 750, path=0))  # max_out > N
    err_1 = max(err_1, compare_kernel(b, s, 0.3, 750, score_thr=0.5, path=0))
    err_1 = max(err_1, compare_kernel(b, torch.zeros_like(s), 0.3, 750, path=1))
    if int((nms_cuda.greedy_nms_rank(b, torch.zeros_like(s), 0.3, 750) >= 0).sum()):
        raise AssertionError("all-zero scores kept a box")
    # A NaN x1 and a NaN y2 on two boxes of a bench row: max / min propagate
    # the NaN as torch.maximum / minimum do, so both boxes have IoU 0 with
    # every box, on both paths.
    b_nan = b1.clone()
    b_nan[0, 3, 0] = float("nan")
    b_nan[0, 40, 3] = float("nan")
    err_1 = max(err_1, compare_kernel(b_nan, s1, thr, max_out, path=1,
                                      what="NaN x1 and y2, sorted"))
    bu_nan, su_nan, _ = shuffle_rows(b_nan, s1, SEED + 5)
    err_1 = max(err_1, compare_kernel(bu_nan, su_nan, thr, max_out, path=0,
                                      what="NaN x1 and y2, shuffled"))
    # The dependent steps and IoU pairs that this run's NMS rows need.
    kept_rows = (nms_cuda.greedy_nms_rank(boxes_k, scores_k, thr, max_out) >= 0).sum(dim=1)
    nms_tiles = nms_cuda.LAST_TILES.clone()
    nms_steps, nms_pairs, _ = selection_work(boxes_k, scores_k, scores_k > 0.0, thr, max_out,
                                             False)
    if not torch.equal(nms_steps, kept_rows):
        raise AssertionError("the replay of the NMS selection counts other steps than the kernel")
    # nms_rows: rows of the bench path's candidates (descending scores) for
    # phases 12 and 14; nan_row: the bench row with two NaN coordinates.
    return {"boxes": boxes_k, "scores": scores_k, "err_b": err_b, "err_1": err_1,
            "nms_rows": (boxes_k[:4].clone(), scores_k[:4].clone()),
            "nan_row": (b_nan[0].clone(), s1[0].clone()), "kept": kept_rows, "tiles": nms_tiles,
            "pairs": nms_pairs}


def phase45(det, images_u8, rng, cfg, dev):
    """detect() on 3 images of different sizes and one detect_batch() of 4
    (shapes, finiteness, boxes inside each image), then the bench path at
    batch 128 (tools/bench.py::build_detect_fn), every NMS row of every
    launch on the tile scan; then detect()'s latency on one image (the
    host clock: no cell measures the serving path).  -> (NMS launches at
    B = 1, batched launches)."""
    post = cfg.postprocess
    size = cfg.model.image_size
    nms_cuda.LAUNCHES = 0
    req = [rng.integers(0, 255, hw + (3,), dtype=np.uint8)
           for hw in ((480, 640), (720, 1280), (300, 200))]
    nms_paths = []  # LAST_PATHS of every launch of phases 4-5: all must be 1

    def took_tile_scan(what):
        """Every row of the recorded launches took the tile scan in shared
        memory, or raise: a fast path that the main path never reaches is a
        hidden fallback."""
        rows = torch.cat(nms_paths)
        nms_paths.clear()
        if not bool((rows == nms_cuda.TILE_SCAN).all()):
            raise AssertionError(f"{what}: {int((rows != nms_cuda.TILE_SCAN).sum())} of "
                                 f"{rows.numel()} NMS rows took the argmax loop or the "
                                 f"long-row path")
        return rows.numel()

    t0 = time.perf_counter()
    dets = []
    for im in req:
        dets.append(det.detect(im))
        nms_paths.append(nms_cuda.LAST_PATHS)
    log(f"phase 4: detect() on {[im.shape[:2] for im in req]}: "
        f"{[len(d['scores']) for d in dets]} detections, "
        f"{time.perf_counter() - t0:.3f} s for the 3 (cold)")
    check_dets(dets, req, post.max_detections)
    log(f"  all {took_tile_scan('detect()')} NMS rows of detect() took the tile scan")
    launches_one = nms_cuda.LAUNCHES
    batch_req = [rng.integers(0, 255, hw + (3,), dtype=np.uint8)
                 for hw in ((640, 640), (500, 375), (1024, 768), (100, 160))]
    dets = det.detect_batch(batch_req)
    nms_paths.append(nms_cuda.LAST_PATHS)
    took_tile_scan("detect_batch()")
    log(f"  detect_batch() of 4: {[len(d['scores']) for d in dets]} detections")
    check_dets(dets, batch_req, post.max_detections)

    bench_detect = bench_tool.build_detect_fn(cfg, dev)
    for _ in range(2):
        out = bench_detect(det.model, images_u8)
        nms_paths.append(nms_cuda.LAST_PATHS)
    torch.cuda.synchronize()
    if not (torch.isfinite(out["bboxes"]).all() and torch.isfinite(out["scores"]).all()):
        raise AssertionError("non-finite bench-path output")
    n_valid = out["valid"].sum(dim=1)
    if out["bboxes"].shape != (BATCH, post.max_detections, 4) or int(n_valid.min()) == 0:
        raise AssertionError(f"bench path output {tuple(out['bboxes'].shape)}, "
                             f"min valid {int(n_valid.min())}")
    launches_batched = nms_cuda.LAUNCHES - launches_one
    n_rows_scanned = took_tile_scan("the bench path")
    log(f"phase 5: bench path batch {BATCH} at {size}x{size} bf16: "
        f"valid detections per image {int(n_valid.min())}..{int(n_valid.max())}")
    log(f"  NMS kernel launches in phases 4-5: {launches_one} at B=1, "
        f"{launches_batched} batched; all {n_rows_scanned} rows of the bench steps took the "
        f"tile scan")
    if launches_one == 0 or launches_batched == 0:
        raise AssertionError("the main path did not launch the NMS kernel")
    one = req[0]
    det.detect(one)
    torch.cuda.synchronize()
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        det.detect(one)
        lat.append((time.perf_counter() - t0) * 1e3)
    log(f"  detect() latency on one 480x640 image: median {np.median(lat):.3f} ms, "
        f"min {min(lat):.3f} ms (host clock, 10 calls)")
    return launches_one, launches_batched


def phase6(det, images_u8, cfg, dev):
    """The float32 forward on the card (TF32 off) against the same forward
    on the CPU, and the bf16 forward against the float32 one."""
    f32_cfg = dataclasses.replace(cfg.model, compute_dtype="float32")
    model32 = DANDetector(f32_cfg)
    model32.load_state_dict(det.model.state_dict())
    model32_cpu = DANDetector(f32_cfg)
    model32_cpu.load_state_dict(model32.state_dict())
    model32 = model32.to(dev).eval()
    with torch.inference_mode():
        x2 = normalize_image(images_u8[:2].float(), cfg.preprocess)
        c32, l32 = model32(x2)
        c16, l16 = det.model(x2)
        ccpu, lcpu = model32_cpu.eval()(x2[:1].cpu())
    e_cpu = max(rel_l2(c32[:1], ccpu), rel_l2(l32[:1], lcpu))
    e_bf16 = max(rel_l2(c16, c32), rel_l2(l16, l32))
    log(f"phase 6: f32 card vs f32 CPU (TF32 off) rel L2 {e_cpu:.3e} (limit 1e-3); "
        f"bf16 vs f32 rel L2 cls {rel_l2(c16, c32):.3e} loc {rel_l2(l16, l32):.3e} "
        f"(limit 5e-2)")
    if not (e_cpu < 1e-3 and e_bf16 < 5e-2):
        raise AssertionError("forward numerics out of tolerance")


def phase7(boxes_k, scores_k, tiles, post, dev, smi):
    """The NMS kernel's time on the bench rows (the tile scan) at (128,
    5000, 750) and on the first at B = 1, each a mean of back-to-back calls
    after warm-up; rows with one neighbouring pair of scores swapped must
    take the argmax loop.  -> {'kernel': ms, 'kernel1': ms}."""
    args = (post.nms_iou_threshold, post.max_detections)
    first = (scores_k[:, :-1] > scores_k[:, 1:]).float().argmax(dim=1)
    rows = torch.arange(scores_k.shape[0], device=dev)
    scores_w = scores_k.clone()
    scores_w[rows, first], scores_w[rows, first + 1] = (scores_k[rows, first + 1],
                                                        scores_k[rows, first])
    nms_cuda.greedy_nms_rank(boxes_k, scores_w, *args)
    if bool(nms_cuda.LAST_PATHS.any()):
        raise AssertionError("a row with a swapped pair took the tile scan or the long-row path")
    ms = {}
    for key, (bx, sc) in (("kernel", (boxes_k, scores_k)), ("kernel1", (boxes_k[:1],
                                                                        scores_k[:1]))):
        for _ in range(3):
            nms_cuda.greedy_nms_rank(bx, sc, *args)
        if not bool((nms_cuda.LAST_PATHS == nms_cuda.TILE_SCAN).all()):
            raise AssertionError("a bench row did not take the tile scan in shared memory")
        ms[key] = cuda_ms(lambda: nms_cuda.greedy_nms_rank(bx, sc, *args), 40)
    log(f"phase 7: NMS at ({scores_k.shape[0]}, {scores_k.shape[1]}, {post.max_detections}): "
        f"kernel (tile scan, at most {int(tiles.max())} tiles a row) {ms['kernel']:.4f} ms; at "
        f"B=1: kernel ({int(tiles[0])} tiles) {ms['kernel1']:.4f} ms ({smi})")
    return ms


def train_config(cfg):
    """The default config with the random-init recipe of the synthetic
    runs: warm-up 50 steps, global-norm clip 10, batch 32."""
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=TRAIN_BATCH, warmup_steps=50, grad_clip_norm=10.0))


def edge_case_batch(cfg):
    """synthetic_batch(cfg, 32, seed=0) with image 30 stripped of its gts
    and image 31 given a copy of its first gt in slot 200."""
    batch = synthetic_batch(cfg, TRAIN_BATCH, seed=SEED)
    batch["boxes"][30] = 0.0
    batch["mask"][30] = False
    batch["boxes"][31, 200] = batch["boxes"][31, 0]
    batch["mask"][31, 200] = True
    return batch


def wgrad_f64(o1, dr):
    """The conv1_2' weight gradient in float64 (cuDNN's): the oracle of the
    float32 kernel."""
    x = torch.relu(o1).double().permute(0, 3, 1, 2)
    return torch.nn.grad.conv2d_weight(x, (dr.shape[3], o1.shape[3], 2, 2),
                                       dr.double().permute(0, 3, 1, 2), padding=1)


def compare_wgrad(o1, dr, what) -> float:
    """The conv1_2' weight-gradient kernel of o1's dtype against its plain
    version in float32 (TF32 off): that kernel launched twice, relative L2
    <= WGRAD_RTOL[dtype], two runs bit-identical and every value finite, or
    raise; a float32 kernel also within WGRAD_F64_RTOL of wgrad_f64.
    Returns max |kernel - plain|."""
    bf16, f32 = conv12_wgrad_cuda.BF16, conv12_wgrad_cuda.F32
    mod = conv12_wgrad_cuda.KERNELS[o1.dtype]
    before = (bf16.LAUNCHES, f32.LAUNCHES)
    k_a = conv12_wgrad_cuda.conv12_wgrad(o1, dr)
    plan = mod.LAST_TILING
    k_b = conv12_wgrad_cuda.conv12_wgrad(o1, dr)
    plain = conv12_wgrad_cuda.conv12_wgrad_plain(o1, dr)
    torch.cuda.synchronize()
    launched = (bf16.LAUNCHES - before[0], f32.LAUNCHES - before[1])
    e_w = rel_l2(k_a, plain)
    e_abs = float((k_a - plain).abs().max())
    same = same_bits(k_a, k_b)
    limit = WGRAD_RTOL[o1.dtype]
    e_64 = e_plain_64 = 0.0
    oracle = ""
    if o1.dtype == torch.float32:
        exact = wgrad_f64(o1, dr)
        e_64, e_plain_64 = rel_l2(k_a, exact), rel_l2(plain, exact)
        oracle = (f"; against float64: kernel {e_64:.3e} (limit {WGRAD_F64_RTOL:g}), plain "
                  f"{e_plain_64:.3e}")
        del exact
    log(f"phase 9: conv12 wgrad {mod.SOURCE} kernel vs plain (f32, TF32 off) at o1 "
        f"{tuple(o1.shape)}, dr {tuple(dr.shape)} {o1.dtype} ({what}): rel L2 {e_w:.3e} (limit "
        f"{limit:g}), max |diff| {e_abs:.3e}{oracle}; two runs bit-identical: {same}; "
        f"{plan.partials} partials of {plan.segs_per_range} segments of {plan.seg} pixels, a "
        f"chain ends every {plan.flush_segs * plan.seg} pixels")
    want = (2, 0) if mod is bf16 else (0, 2)
    if launched != want:
        raise AssertionError(f"conv12 wgrad on {o1.dtype}: (bf16, float32) kernel launches "
                             f"{launched}, not {want}")
    if not (e_w <= limit and e_64 <= WGRAD_F64_RTOL and same and bool(torch.isfinite(k_a).all())):
        raise AssertionError(f"conv12 wgrad kernel out of tolerance or not deterministic ({what})")
    return e_abs


def compare_wgrad_shapes(o1, dr, gen) -> float:
    """compare_wgrad at the train shape (o1 from a real packed forward),
    batch 1 and 3, rows that end inside a segment (W = 53 and 65, and H = 1),
    a border-only o1 and dr, and dW exactly 0 on an all-negative o1, all in
    o1's dtype.  Returns the train shape's max |diff|."""
    dev = o1.device
    e_abs = compare_wgrad(o1, dr, "the train shape, o1 from a real packed forward")
    compare_wgrad(o1[:1].contiguous(), dr[:1].contiguous(), "batch 1 at 640x640")
    compare_wgrad(o1[:3].contiguous(), dr[:3].contiguous(), "batch 3 at 640x640")
    # Rows that are no multiple of a segment (64 pixels in bf16, 16 in
    # float32): a ragged last segment, one pixel over a segment (the kernel
    # reads zeros past W), and a single row.
    for shape in ((2, 37, 53, 256), (1, 64, 65, 256), (3, 1, 70, 256)):
        small = torch.randn(shape, generator=gen, device=dev).to(o1.dtype)
        small_dr = torch.randn((shape[0], shape[1] + 1, shape[2] + 1, 256), generator=gen,
                               device=dev).to(o1.dtype)
        compare_wgrad(small, small_dr, "an odd size")
    # Nothing passes the relu: dW is exactly 0.
    zero = conv12_wgrad_cuda.conv12_wgrad(-o1[:2].abs() - 1.0, dr[:2].contiguous())
    if float(zero.abs().max()) != 0.0:
        raise AssertionError(f"conv12 wgrad of an all-negative {o1.dtype} o1 is not exactly 0")
    log(f"  all-negative {o1.dtype} o1: dW exactly 0")
    # Only the border: o1 positive on its outer rows and columns alone, dr
    # nonzero on its outer rows and columns alone -- the taps next to the
    # zero padding carry everything.
    edge = -o1[:2].abs() - 1.0
    for sl in ((slice(None), 0), (slice(None), -1), (slice(None), slice(None), 0),
               (slice(None), slice(None), -1)):
        edge[sl] = o1[:2][sl].abs()
    edge_dr = torch.zeros_like(dr[:2])
    for sl in ((slice(None), 0), (slice(None), -1), (slice(None), slice(None), 0),
               (slice(None), slice(None), -1)):
        edge_dr[sl] = dr[:2][sl]
    compare_wgrad(edge, edge_dr, "border-only o1 and dr")
    return e_abs


def preprocessed(batch, cfg, dev):
    """A host train batch through train_preprocess on the card, with the
    draws of its own seeds -> (images, boxes, mask)."""
    t = to_device(batch, dev)
    draws = sample_augment_batch(batch["seed"], cfg.preprocess)
    return train_preprocess(
        t["canvas"], (t["crop_x0"], t["crop_y0"], t["crop_size"]), t["boxes"],
        t["mask"], draws, cfg.preprocess)


def compare_matcher(margs, what, phase="phase 9") -> MatchTargets:
    """The matcher kernel against match_anchors on the same CUDA tensors:
    all four MatchTargets leaves bit-identical, or raise."""
    got = matching_cuda.match_anchors_cuda(*margs)
    want = match_anchors(*margs)
    torch.cuda.synchronize()
    off = {name: int((g != w.to(g.dtype)).sum()) for name, g, w in zip(got._fields, got, want)}
    ulp = int((got.loc_target.view(torch.int32).long()
               - want.loc_target.view(torch.int32).long()).abs().max())
    if any(off.values()) or not all(same_bits(g, w.to(g.dtype)) for g, w in zip(got, want)):
        raise AssertionError(f"matcher kernel != plain on {what}: elements that differ {off}, "
                             f"loc_target by up to {ulp} ulp")
    npos = (got.cls_target == 1).sum(dim=1)
    log(f"{phase}: matcher kernel == plain on {what} (B={margs[1].shape[0]} "
        f"A={margs[0].shape[0]} G={margs[1].shape[1]}, {int(margs[2].sum())} valid gts): "
        f"cls_target, loc_target, matched_gt, matched_iou bit-identical; positives per image "
        f"{int(npos.min())}..{int(npos.max())}")
    return got


def phase9(cfg, dev):
    """Each train kernel against its plain version at the train shapes;
    returns the max errors and the inputs phase 11 times."""
    size = cfg.preprocess.train_image_size
    anchors = generate_anchors(cfg.anchors, size, size, dev)
    _, boxes, mask = preprocessed(synthetic_batch(cfg, TRAIN_BATCH, seed=SEED), cfg, dev)
    compare_matcher((anchors, boxes, mask, cfg.match, cfg.anchors), "the train batch")
    images, boxes, mask = preprocessed(edge_case_batch(cfg), cfg, dev)
    if not (bool(mask[31, 200]) and not bool(mask[30].any())):
        raise AssertionError("the edge-case gts did not survive the preprocess")
    margs = (anchors, boxes, mask, cfg.match, cfg.anchors)
    got = compare_matcher(margs, "the edge batch (image 30 without gts, image 31 with gt 200)")
    if int((got.cls_target[30] == 1).sum()) != 0 or not bool(
            ((got.matched_gt[31] == 200) & (got.cls_target[31] == 1)).any()):
        raise AssertionError("edge cases: image 30 has positives or gt 200 is unmatched")
    # One more image, every gt slot valid.
    rng = np.random.default_rng(SEED + 256)
    g_n = boxes.shape[1]
    xy = rng.uniform(0, size - 16, (g_n, 2))
    full = np.concatenate([xy, np.minimum(xy + rng.uniform(4, 160, (g_n, 2)), size)], -1)
    boxes_full = torch.cat([boxes, torch.from_numpy(full.astype(np.float32))[None].to(dev)])
    mask_full = torch.cat([mask, torch.ones((1, g_n), dtype=torch.bool, device=dev)])
    compare_matcher((anchors, boxes_full.contiguous(), mask_full.contiguous(), cfg.match,
                     cfg.anchors), f"the edge batch and one image with all {g_n} gts valid")
    del boxes_full, mask_full

    # Phase-pool backward on winners from a real packed forward (bf16).
    model = DANDetector(cfg.model, torch.Generator().manual_seed(SEED)).to(dev)
    x = images.to(torch.bfloat16).permute(0, 3, 1, 2)
    with torch.no_grad():
        o1_pre, k2, b2 = model.backbone.conv1_1_packed(x)
        r = torch.nn.functional.conv2d(torch.relu(o1_pre), k2, padding=1)
        _, win = phase_pool_with_winner(r, b2)
    del r
    gen = torch.Generator(device=dev).manual_seed(SEED)
    g = torch.randn(win.shape, generator=gen, device=dev, dtype=torch.bfloat16)
    got = phase_pool_cuda.phase_pool_bwd(g, win)
    want = phase_pool_cuda.phase_pool_bwd_plain(g, win)
    torch.cuda.synchronize()
    counts = torch.bincount(win.flatten().long(), minlength=256)
    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
        raise AssertionError(f"phase-pool kernel != plain: "
                             f"{int((got != want).sum())} elements differ")
    log(f"phase 9: phase-pool backward kernel == plain bit for bit at g "
        f"{tuple(g.shape)} bf16 -> {tuple(got.shape)}; winners by phase "
        f"{[int(c) for c in counts[:4]]}, clamped (255) {int(counts[255])}")
    del got, want

    # conv1_2' weight grad at the train shape, then at other shapes: the
    # bf16 kernel, then the float32 one on the same values in float32.
    o1 = nhwc(o1_pre)
    del o1_pre
    dr = torch.randn((TRAIN_BATCH, o1.shape[1] + 1, o1.shape[2] + 1, 256),
                     generator=gen, device=dev, dtype=torch.bfloat16)
    e_abs = {}
    for dtype in (torch.bfloat16, torch.float32):
        e_abs[dtype] = compare_wgrad_shapes(o1.to(dtype), dr.to(dtype), gen)
    compare_upsample(gen, dev)
    errs = {"matcher": 0.0, "phase_pool_bwd": 0.0, "conv12_wgrad": e_abs[torch.bfloat16],
            "conv12_wgrad_f32": e_abs[torch.float32], "upsample2x_bwd": 0.0}
    cases = {"matcher": margs, "phase_pool_bwd": (g, win), "conv12_wgrad": (o1, dr)}
    return errs, cases


def compare_upsample(gen, dev):
    """The upsample gradient kernel against its plain version, bit for bit
    (torch.equal), in bf16 and float32, twice each: at a train step's three
    shapes (each many times more items than the grid has blocks times the
    ring's stages, so every block's ring wraps many times); at planes that
    fill an item's stage exactly (2 bf16 planes of 64x64 = 16 KB; 6 planes
    and 7, whose last item holds one) and planes that do not (the train
    shapes: 5 x 3.2 KB); at odd sizes (odd W, W not a multiple of a
    thread's group, one pixel, uneven bands); at W = 1,500 (items of one
    output row); and on g views that start one pair of elements into their
    storage (on a pair, off 16 bytes: every span's head and tail go by plain
    loads, and a thread makes one output).  Then each train shape 200 times
    more against plain: a ring that lets a stage be read before its bytes
    land, or refilled while a warp still reads it, shows as a launch that
    differs."""
    odd = ((2, 3, 10, 14), (1, 1, 2, 2), (3, 5, 6, 4), (2, 7, 130, 66), (1, 2, 2, 322),
           (2, 3, 12, 18), (1, 3, 40, 22), (2, 3, 8, 12))
    items = ((2, 3, 64, 64), (1, 7, 64, 64), (1, 2, 8, 3000))
    for shape in UPSAMPLE_SHAPES:
        p = upsample_cuda.plan(shape[0] * shape[1], shape[2] // 2, shape[3] // 2, 2)
        grid = upsample_cuda.grid(p, 2)
        log(f"  upsample plan at g {shape} bf16: {p.items} items of {p.per_item} plane(s) / "
            f"{p.bands} band(s) a plane, {p.stage_bytes} B stages, groups of {p.group}; "
            f"grid {grid} blocks: each ring wraps {p.items / (grid * upsample_cuda.STAGES):.1f} "
            f"times")
        if p.items <= grid * upsample_cuda.STAGES:
            raise AssertionError(f"the upsample plan at {shape} does not wrap the ring")

    def check(g, what):
        got = upsample_cuda.upsample2x_bwd(g)
        again = upsample_cuda.upsample2x_bwd(g)
        want = upsample_cuda.upsample2x_bwd_plain(g)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and same_bits(got, again)):
            raise AssertionError(f"upsample gradient kernel != plain at {what}: "
                                 f"{int((got != want).sum())} elements differ")

    for dtype in (torch.bfloat16, torch.float32):
        for shape in UPSAMPLE_SHAPES + items + odd:
            check(torch.randn(shape, generator=gen, device=dev).to(dtype), f"{shape} {dtype}")
        for shape in (UPSAMPLE_SHAPES[0], (2, 3, 10, 14), (1, 7, 64, 64)):
            flat = torch.randn(math.prod(shape) + 2, generator=gen, device=dev).to(dtype)
            g = flat[2:].view(shape)
            if g.data_ptr() % 16 == 0:
                raise AssertionError("the pair-offset view starts on 16 bytes")
            check(g, f"{shape} {dtype}, one pair into its storage")
    # A contiguous g whose storage starts inside a pair of elements, and a W
    # over the kernel's limit, are refused, not a fault.
    flat = torch.zeros(2 * 3 * 10 * 14 + 1, dtype=torch.bfloat16, device=dev)
    max_w = upsample_cuda.max_w(2)
    for bad in (flat[1:].view(2, 3, 10, 14),
                torch.zeros((1, 1, 2, 2 * max_w + 2), dtype=torch.bfloat16, device=dev)):
        try:
            upsample_cuda.upsample2x_bwd(bad)
        except ValueError:
            pass
        else:
            raise AssertionError(f"the upsample gradient kernel took g {tuple(bad.shape)} at "
                                 f"{bad.data_ptr() % 4} bytes past a pair")
    log(f"phase 9: upsample gradient kernel == plain (torch.equal) and run to run bit-identical "
        f"at g {list(UPSAMPLE_SHAPES + items + odd)}, bf16 and float32, and on views one pair "
        f"into their storage; a g off a pair's alignment and W = {max_w + 1} (limit {max_w} "
        f"in bf16) refused")
    for shape in UPSAMPLE_SHAPES:
        g = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        want = upsample_cuda.upsample2x_bwd_plain(g)
        bad = sum(not torch.equal(upsample_cuda.upsample2x_bwd(g), want) for _ in range(200))
        if bad:
            raise AssertionError(f"upsample gradient kernel != plain in {bad} of 200 launches "
                                 f"at {shape}")
        del g, want
    log(f"phase 9: upsample gradient kernel == plain in 200 of 200 launches at each of "
        f"{list(UPSAMPLE_SHAPES)} bf16")


def phase10(cfg, dev):
    """The train step on the card: 6 steps on one batch must lower the
    loss, each train kernel launched its count a step; then the train CLI
    with a checkpoint and a resume.  Returns each train kernel's launches."""
    state = create_train_state(cfg, SEED, dev)
    batch = synthetic_batch(cfg, TRAIN_BATCH, seed=SEED)
    named = dict(state.model.named_parameters())

    def step(b):
        images, targets = preprocess_and_match(b, cfg, dev)
        grads, metrics = loss_and_grads(state, images, targets)
        metrics["grad_norm"] = sgd_update(named, grads, state.momentum, state.step, cfg.train)
        state.step += 1
        return metrics

    for mod, _, _ in TRAIN_KERNELS.values():
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    steps = [step(batch) for _ in range(6)]
    losses = [float(m["loss"]) for m in steps]
    log(f"phase 10: 6 steps on one batch ({TRAIN_BATCH}x640x640, bf16, warm-up 50, "
        f"clip 10): loss {' '.join(f'{x:.4f}' for x in losses)} "
        f"({time.perf_counter() - t0:.2f} s, first step cold)")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("the loss did not fall over 6 steps")
    m = {k: float(v) for k, v in steps[-1].items()}
    log(f"  last step: {' '.join(f'{k}={v:.5g}' for k, v in m.items())}")
    if not all(np.isfinite(v) for v in m.values()):
        raise AssertionError("non-finite metrics")
    n_steps = len(steps)
    launches = {name: mod.LAUNCHES for name, (mod, _, _) in TRAIN_KERNELS.items()}
    log(f"  train kernel launches over {n_steps} steps: {launches}")
    for name, n in launches.items():
        if n != PER_STEP[name] * n_steps:
            raise AssertionError(f"{name} launched {n} times, expected "
                                 f"{PER_STEP[name] * n_steps}")
    del state, batch, steps

    # The entry point a user calls, with a checkpoint and a resume.
    with tempfile.TemporaryDirectory() as d:
        common = ["--synthetic", "--model_dir", d, "--batch_size", str(TRAIN_BATCH),
                  "--log_every", "1", "--checkpoint_every", "1"]
        rc1 = train_cli.main(common + ["--steps", "1"])
        rc2 = train_cli.main(common + ["--steps", "2", "--resume"])
        with open(os.path.join(d, "train_metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        last = ckpt.latest_step(d)
    log(f"phase 10: python -m dan_tpu_torch.train main(): rc {rc1}, {rc2}; logged steps "
        f"{[r['step'] for r in logged]}, losses {[round(r['loss'], 4) for r in logged]}; "
        f"latest checkpoint step {last}")
    if (rc1, rc2, [r["step"] for r in logged], last) != (0, 0, [1, 2], 2):
        raise AssertionError("train CLI run or resume failed")
    return launches


def f32_config(cfg, **preprocess):
    """cfg in float32 at batch F32_BATCH, with the preprocess fields given."""
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        preprocess=dataclasses.replace(cfg.preprocess, **preprocess),
        train=dataclasses.replace(cfg.train, batch_size=F32_BATCH))


def tf32_and_deterministic():
    return (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic)


@contextlib.contextmanager
def tf32_allowed():
    """TF32 allowed for cuDNN's convolutions and for matmuls, cuDNN free to
    choose its algorithms, while inside (the script's flags restored
    after): what a caller of the train step may have set."""
    keep = tf32_and_deterministic()
    (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.deterministic) = True, True, False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = keep


def f32_run(cfg, dev, batch):
    """F32_STEPS train_step calls on one batch from create_train_state(SEED),
    every train kernel counted (0 just before, read just after) -> (losses,
    the last step's metrics, the state payload, launches, host ms a step,
    synchronised, the (TF32 for convolutions, TF32 for matmuls, cuDNN
    deterministic) flags each forward of the model ran under)."""
    state = create_train_state(cfg, SEED, dev)
    flags = []
    state.model.register_forward_hook(lambda *_: flags.append(tf32_and_deterministic()))
    for mod, _, _ in TRAIN_KERNELS.values():
        mod.LAUNCHES = 0
    losses, ms = [], []
    for _ in range(F32_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    launches = {name: mod.LAUNCHES for name, (mod, _, _) in TRAIN_KERNELS.items()}
    return (losses, {k: float(v) for k, v in m.items()}, ckpt.state_payload(state), launches,
            ms, flags)


@contextlib.contextmanager
def plain_cpu_conv():
    """oneDNN off: its float32 conv is too inexact to hold the card against
    (the port's CPU tests turn it off the same way)."""
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


def f32_card_vs_cpu(cfg, dev, smi):
    """One float32 train_step at F32_CPU_SIZE px (canvas twice that, the CPU
    parity test's irregular crop) on the card, TF32 allowed by the caller,
    and on the CPU from create_train_state(SEED) on one batch: the loss
    within 1e-4 relative, num_pos and the selected negatives equal, every
    parameter within rtol 1e-4 / atol 1e-6 and every momentum element (the
    step's gradient) within rtol 1e-4 + atol 2e-4 of its tensor's largest
    (tests/test_torch_train_step.py's tolerances)."""
    size = F32_CPU_SIZE
    scfg = f32_config(cfg, train_image_size=size, canvas_size=2 * size)
    batch = synthetic_batch(scfg, F32_BATCH, seed=SEED)
    batch["crop_x0"][:] = 7.0
    batch["crop_size"][:] = 111.0
    out = {}
    for where in ("cpu", dev):
        state = create_train_state(scfg, SEED, where)
        t0 = time.perf_counter()
        with plain_cpu_conv(), tf32_allowed():
            m = train_step(state, batch)
        metrics = {k: float(v) for k, v in m.items()}
        params = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
        out[str(where)] = (metrics, params, {n: v.cpu() for n, v in state.momentum.items()},
                           time.perf_counter() - t0)
    (mc, pc, vc, sc), (mg, pg, vg, sg) = out["cpu"], out[str(dev)]
    loss_rel = abs(mg["loss"] - mc["loss"]) / abs(mc["loss"])
    params_ok = all(bool(((pg[n] - pc[n]).abs() <= 1e-4 * pc[n].abs() + 1e-6).all()) for n in pc)
    worst, worst_name = 0.0, None
    for n, want in vc.items():
        diff = (vg[n] - want).abs()
        e = float((diff - 1e-4 * want.abs()).max() / want.abs().max().clamp_min(1e-30))
        if e > worst:
            worst, worst_name = e, n
    log(f"phase 10f: one float32 step at {size}x{size}, batch {F32_BATCH}, card (TF32 allowed "
        f"by the caller) against CPU (oneDNN off; {sg:.1f} s and {sc:.1f} s on the host clock): "
        f"loss {mg['loss']!r} / {mc['loss']!r} (rel {loss_rel:.3e}, limit 1e-4); num_pos "
        f"{mg['num_pos']:g} / {mc['num_pos']:g}, selected negatives {mg['num_neg_selected']:g} "
        f"/ {mc['num_neg_selected']:g}; parameters within rtol 1e-4 / atol 1e-6: {params_ok}; "
        f"momentum: worst element {worst:.3e} of its tensor's largest beyond rtol 1e-4, in "
        f"{worst_name} (limit 2e-4) ({smi})")
    if not (loss_rel <= 1e-4 and mg["num_pos"] == mc["num_pos"] > 0
            and mg["num_neg_selected"] == mc["num_neg_selected"] and params_ok
            and worst <= 2e-4):
        raise AssertionError(f"phase 10f: the float32 step at {size} px on the card differs "
                             "from the CPU's")


def phase10f(cfg, dev, smi):
    """The float32 train step on the card, at full width (640x640) and batch
    F32_BATCH, with TF32 allowed by the caller: two runs of F32_STEPS steps
    on one batch from create_train_state(SEED); every forward runs with
    TF32 off and cuDNN deterministic, the loss falls, the runs are
    bit-identical, and each step launches K6's float32 kernel once and its
    bf16 kernel never.  Then f32_card_vs_cpu.  Returns the float32
    kernel's launches."""
    fcfg = f32_config(cfg)
    batch = synthetic_batch(fcfg, F32_BATCH, seed=SEED)
    t0 = time.perf_counter()
    with tf32_allowed():
        (losses, m, st, launches, ms, flags), (losses_b, m_b, st_b, launches_b, ms_b, flags_b) = (
            f32_run(fcfg, dev, batch) for _ in range(2))
    params = differing(st_b["model"], st["model"])
    moms = differing(st_b["momentum"], st["momentum"])
    exact = set(flags + flags_b) == {(False, False, True)}
    log(f"phase 10f: {F32_STEPS} float32 steps on one batch ({F32_BATCH}x640x640, warm-up 50, "
        f"clip 10), twice from create_train_state({SEED}), TF32 allowed by the caller; the "
        f"forwards ran under (TF32 convolutions, TF32 matmuls, cuDNN deterministic) "
        f"{sorted(set(flags + flags_b))} ({time.perf_counter() - t0:.1f} s): loss "
        f"{' '.join(f'{x:.5f}' for x in losses)}; "
        f"ms a step (host clock, synchronised) {[round(x, 3) for x in ms]} then "
        f"{[round(x, 3) for x in ms_b]} = {np.mean(ms_b[1:]):.3f} ms = "
        f"{F32_BATCH / np.mean(ms_b[1:]) * 1e3:.1f} img/s warm ({smi}); the second run: "
        f"{len(params)} parameter and {len(moms)} momentum tensors differ, metrics "
        f"{'identical' if (losses_b, m_b) == (losses, m) else 'differ'}; launches {launches}")
    want = {name: PER_STEP_F32[name] * F32_STEPS for name in TRAIN_NAMES}
    if not exact or len(flags) != F32_STEPS:
        raise AssertionError("phase 10f: the float32 step's forward did not run with TF32 off "
                             f"and cuDNN deterministic: {flags}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("phase 10f: the float32 loss did not fall")
    if launches != want or launches_b != want:
        raise AssertionError(f"phase 10f: launches {launches} and {launches_b}, not {want}")
    if params or moms or (losses_b, m_b) != (losses, m):
        raise AssertionError(f"phase 10f: two float32 runs differ ({(params + moms)[:4]})")
    del st, st_b
    f32_card_vs_cpu(cfg, dev, smi)
    return 2 * launches["conv12_wgrad_f32"]


def aten_ups_one(g):
    """ATen's gradient of the 2x bilinear upsample of g (N, C, 2H, 2W)."""
    return torch.ops.aten.upsample_bilinear2d_backward.default(
        g, list(g.shape[2:]), [g.shape[0], g.shape[1], g.shape[2] // 2, g.shape[3] // 2], False,
        2.0, 2.0)


def phase11(cases, smi):
    """Each train kernel's time at the train shapes (CUDA events over
    back-to-back calls after warm-up), beside the library call that
    computes its function where there is one, and its bound."""
    # A step's three upsample gradients, and K6's inputs in float32.
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    cases = dict(cases, upsample2x_bwd=tuple(
        torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
        for shape in UPSAMPLE_SHAPES), conv12_wgrad_f32=tuple(
        t.float() for t in cases["conv12_wgrad"]))
    fns = {
        "matcher": matching_cuda.match_anchors_cuda,
        "phase_pool_bwd": phase_pool_cuda.phase_pool_bwd,
        "conv12_wgrad": conv12_wgrad_cuda.conv12_wgrad,
        # The same function on the same values in float32: its own kernel.
        "conv12_wgrad_f32": conv12_wgrad_cuda.conv12_wgrad,
        # A step's three upsample gradients, one call each.
        "upsample2x_bwd": lambda *gs: [upsample_cuda.upsample2x_bwd(g) for g in gs],
    }
    out = {}
    launched = {}
    for name, kernel in fns.items():
        args = cases[name]
        # One call launches what one train step in its dtype launches.
        mod = TRAIN_KERNELS[name][0]
        mod.LAUNCHES = 0
        kernel(*args)
        launched[name] = mod.LAUNCHES
        per_call = max(PER_STEP[name], PER_STEP_F32[name])
        if launched[name] != per_call:
            raise AssertionError(f"phase 11: {name} launched {launched[name]} times a call, "
                                 f"not {per_call}")
        for _ in range(3):
            kernel(*args)
        out[name] = {"kernel": cuda_ms(lambda: kernel(*args), 20)}
        log(f"phase 11: {name}: kernel {out[name]['kernel']:.4f} ms ({smi})")
    # The matcher call (host work, allocations, three launches) beside its
    # kernels' own device time.
    margs = cases["matcher"]
    call = lambda: matching_cuda.match_anchors_cuda(*margs)  # noqa: E731
    dev_t, _ = device_ms(call, 20, MATCHER_KERNELS)
    out["matcher"]["device"] = dev_t
    if matching_cuda.LAST_PATH != matching_cuda.SHARED:
        raise AssertionError("the matcher at the train shape did not take one chunk of gts")
    log(f"phase 11: matcher call {out['matcher']['kernel']:.4f} ms (CUDA events over back-to-back "
        f"calls; the wrapper's host time {host_ms(call):.4f} ms a call); its kernels' device time "
        f"(torch.profiler, a call) " + ", ".join(f"{k} {v:.4f} ms" for k, v in dev_t.items())
        + f" = {sum(dev_t.values()):.4f} ms ({smi})")

    # The one PyTorch call that computes a ported kernel's function: cuDNN's
    # weight gradient for the conv1_2' kernel, bf16, on the materialised
    # relu'd and zero-padded input.  Timed here, called nowhere in the port.
    o1, dr = cases["conv12_wgrad"]
    x = torch.nn.functional.pad(torch.relu(o1).permute(0, 3, 1, 2), (1, 1, 1, 1)).contiguous(
        memory_format=torch.channels_last)
    g = dr.permute(0, 3, 1, 2)  # NCHW view of the NHWC cotangent: channels-last
    size = (dr.shape[3], o1.shape[3], 2, 2)
    lib = lambda: torch.nn.grad.conv2d_weight(x, size, g)  # noqa: E731
    want = conv12_wgrad_cuda.conv12_wgrad(o1, dr)
    e_lib = rel_l2(lib(), want)
    torch.cuda.synchronize()
    out["conv12_wgrad"]["library"] = cuda_ms(lib, 5)
    log(f"phase 11: conv12_wgrad beside torch.nn.grad.conv2d_weight (cuDNN, bf16, "
        f"materialised input): library {out['conv12_wgrad']['library']:.4f} ms, rel L2 to the "
        f"kernel {e_lib:.3e} ({smi})")
    if not e_lib < 2e-2:
        raise AssertionError("the library call does not compute the kernel's function")
    del x, g, want
    # The same in float32 (TF32 off), in turns library, kernel, kernel,
    # library with K6's float32 kernel.
    o1f, drf = cases["conv12_wgrad_f32"]
    xf = torch.nn.functional.pad(torch.relu(o1f).permute(0, 3, 1, 2), (1, 1, 1, 1)).contiguous(
        memory_format=torch.channels_last)
    lib_f = lambda: torch.nn.grad.conv2d_weight(xf, size, drf.permute(0, 3, 1, 2))  # noqa: E731
    e_lib_f = rel_l2(lib_f(), conv12_wgrad_cuda.conv12_wgrad(o1f, drf))
    f32_turns = turns(lambda: conv12_wgrad_cuda.conv12_wgrad(o1f, drf), lib_f, 5, 3)
    out["conv12_wgrad_f32"]["library"] = f32_turns["library"]
    log(f"phase 11: conv12_wgrad_f32 beside torch.nn.grad.conv2d_weight (cuDNN, float32, TF32 "
        f"off, materialised input), in turns library, kernel, kernel, library: library "
        f"{f32_turns['library']:.4f} ms, kernel {f32_turns['kernel']:.4f} ms; rel L2 to the "
        f"kernel {e_lib_f:.3e} ({smi})")
    if not e_lib_f < 1e-4:
        raise AssertionError("the float32 library call does not compute the kernel's function")
    del xf

    # K5's library call: ATen's max-pool backward routes each gradient to
    # its window's winner by an index, the same routing in the unpacked
    # layout: g (32, 64, 320, 320) bf16 and the indices of the 2x2 max pool
    # of a (32, 64, 640, 640) input.  Timed in turns with K5 at the train
    # shape; called nowhere in the port.
    pool_in = torch.randn((TRAIN_BATCH, 64, 640, 640), generator=gen, device="cuda",
                          dtype=torch.bfloat16)
    _, idx = torch.nn.functional.max_pool2d(pool_in, 2, 2, return_indices=True)
    g_lib = torch.randn(idx.shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    pool_lib = lambda: torch.ops.aten.max_pool2d_with_indices_backward(  # noqa: E731
        g_lib, pool_in, [2, 2], [2, 2], [0, 0], [1, 1], False, idx)
    routed = pool_lib()
    lib_routes = torch.equal(routed.flatten(2).gather(2, idx.flatten(2)), g_lib.flatten(2)) \
        and int((routed != 0).sum()) == int((g_lib != 0).sum())
    del routed
    k5 = fns["phase_pool_bwd"]
    pool_turns = turns(lambda: k5(*cases["phase_pool_bwd"]), pool_lib, 10, 10)
    out["phase_pool_bwd"]["library"] = pool_turns["library"]
    log(f"phase 11: phase_pool_bwd beside aten::max_pool2d_with_indices_backward (g "
        f"{tuple(g_lib.shape)} bf16, indices of a 2x2 max pool of {tuple(pool_in.shape)}), in "
        f"turns library, K5, K5, library: library {pool_turns['library']:.4f} ms, K5 "
        f"{pool_turns['kernel']:.4f} ms; the library routes every gradient to its index: "
        f"{lib_routes} ({smi})")
    if not lib_routes:
        raise AssertionError("the max-pool backward does not route g by its indices")
    del pool_in, idx, g_lib

    # The upsample gradient's library call: ATen's upsample_bilinear2d_backward
    # (atomic adds: not reproducible run to run).
    ups = cases["upsample2x_bwd"]

    def aten_ups():
        return [aten_ups_one(g) for g in ups]

    e_ups = max(rel_l2(a, k) for a, k in zip(aten_ups(), fns["upsample2x_bwd"](*ups)))
    torch.cuda.synchronize()
    out["upsample2x_bwd"]["library"] = cuda_ms(aten_ups, 10)
    log(f"phase 11: launches a call == PER_STEP: {launched}")
    log(f"phase 11: upsample2x_bwd, a step's three calls at g {[tuple(g.shape) for g in ups]} "
        f"bf16: kernel {out['upsample2x_bwd']['kernel']:.4f} ms, ATen's upsample_bilinear2d_backward "
        f"{out['upsample2x_bwd']['library']:.4f} ms (rel L2 to the kernel {e_ups:.3e}) ({smi})")
    # Each call alone beside its own bound (bytes: g read once, gx written
    # once): the kernel's device time (profiler) and the call's time back to
    # back (CUDA events; the wrapper's host time a call beside it) and ATen's
    # backward of the same call.
    alone = []
    for g in ups:
        ms_b, _ = bound(nbytes(g) * 5 // 4, 21 * g.numel() // 4, PEAK_F32)
        call = lambda: upsample_cuda.upsample2x_bwd(g)  # noqa: E731
        dev_t, how = device_ms(call, 20, ("upsample2x_bwd_kernel",), alone=call)
        ms_d, ms_k = dev_t["upsample2x_bwd_kernel"], cuda_ms(call, 20)
        alone.append((ms_d, ms_k, ms_b))
        log(f"  g {tuple(g.shape)}: kernel {ms_d:.4f} ms ({how}), bound {ms_b:.4f} ms "
            f"({nbytes(g) * 5 // 4 / 1e6:.1f} MB): {100 * ms_b / ms_d:.1f} % of it; the call "
            f"back to back {ms_k:.4f} ms (host {host_ms(call):.4f} ms); ATen "
            f"{cuda_ms(lambda: aten_ups_one(g), 20):.4f} ms")
    d_sum, k_sum, b_sum = (sum(a[i] for a in alone) for i in range(3))
    log(f"  the three calls alone: kernels {d_sum:.4f} ms ({k_sum:.4f} ms back to back) against "
        f"a bound of {b_sum:.4f} ms: {100 * b_sum / d_sum:.1f} % of it ({smi})")
    # The ring's stage size: a step's three calls with 12, 16 (the default)
    # and 24 KB stages give the default's bits.
    ref = [upsample_cuda.upsample2x_bwd(g) for g in ups]
    for sb in (12 * 1024, upsample_cuda.STAGE_BYTES, 24 * 1024):
        if not all(torch.equal(upsample_cuda._launch(g, sb), r) for g, r in zip(ups, ref)):
            raise AssertionError(f"upsample gradient kernel with {sb} B stages != the default's")
    del ref
    if not e_ups < 1e-2:
        raise AssertionError("ATen's upsample backward does not compute the kernel's function")

    # Bounds from this run's inputs.  Matcher: each pass reads anchors, gts
    # and mask and does 14 operations an (anchor, valid gt) pair; pass 1
    # writes 8 bytes an anchor and 16 a gt, pass 2 reads those and writes 24
    # bytes an anchor.  Phase pool: pure routing.  Weight grad: one
    # multiply-add per (pixel, tap, ci, co) on the unpadded positions.
    anchors, gts, mask = cases["matcher"][:3]
    bsz, n_anchor = gts.shape[0], anchors.shape[0]
    pair_ops = 14 * n_anchor * int(mask.sum())
    g_pool, win = cases["phase_pool_bwd"]
    pool_out = g_pool.shape[0] * (g_pool.shape[1] + 1) * (g_pool.shape[2] + 1) * 4 * g_pool.shape[3]
    b, h, w, ci = o1.shape
    co = dr.shape[3]
    bounds = {
        "matcher pass 1": bound(nbytes(anchors, gts, mask) + bsz * n_anchor * 8
                                + 16 * mask.numel(), pair_ops, PEAK_F32),
        "matcher pass 2": bound(nbytes(anchors, gts, mask) + 16 * mask.numel()
                                + bsz * n_anchor * 24, pair_ops, PEAK_F32),
        "phase_pool_bwd": bound(nbytes(g_pool, win) + pool_out * g_pool.element_size(),
                                pool_out, PEAK_F32),
        "conv12_wgrad": bound(nbytes(o1, dr) + 4 * ci * co * 4,
                              2 * b * h * w * 4 * ci * co, PEAK_BF16),
        "conv12_wgrad_f32": bound(nbytes(o1f, drf) + 4 * ci * co * 4,
                                  2 * b * h * w * 4 * ci * co, PEAK_F32),
        # g read once, gx (a quarter of g) written once; 21 float32
        # operations an output (two H sums of 7, one W sum).
        "upsample2x_bwd": bound(sum(nbytes(g) * 5 // 4 for g in ups),
                                sum(21 * g.numel() // 4 for g in ups), PEAK_F32),
    }
    for name, (ms_b, by) in bounds.items():
        log(f"  bound {name}: {ms_b:.4f} ms by {by}")
    conv12_wgrad_cuda.conv12_wgrad(o1, dr)
    conv12_wgrad_cuda.conv12_wgrad(o1f, drf)
    bounds["conv12_wgrad tiling"] = conv12_wgrad_cuda.BF16.LAST_TILING
    bounds["conv12_wgrad_f32 tiling"] = conv12_wgrad_cuda.F32.LAST_TILING
    return out, bounds


# ---------------------------------------------------------------------------
# the TTA evaluation path: phases 12-14
# ---------------------------------------------------------------------------


def check_tiles(tiles, active, what):
    """Every vote row took the tile scan as its input says it must: tiles
    > 0 exactly where a detection is active, at most one for every 64
    active detections.  tiles and active (B,) int tensors; raises."""
    tiles, active = tiles.cpu().long(), active.cpu().long()
    per_tile = bbox_vote_cuda.TILE
    if not (torch.equal(tiles > 0, active > 0)
            and bool((tiles <= (active + per_tile - 1) // per_tile).all())):
        raise AssertionError(f"vote rows of {what}: tiles {tiles.tolist()[:16]} for active "
                             f"{active.tolist()[:16]}")
    return tiles


def compare_vote(boxes, scores, valid, thr, max_out, what) -> float:
    """Vote kernel vs plain version on the same CUDA tensors.  Raises unless
    valid, scores and output counts are identical, boxes within rtol 1e-5 /
    atol 1e-4 (NaN where the plain version has NaN), two kernel runs give
    the same bits, and each row's tiles fit its input.  Returns max |box
    diff|."""
    got = bbox_vote_cuda.bbox_vote_batched_cuda(boxes, scores, valid, thr, max_out)
    tiles = bbox_vote_cuda.LAST_TILES
    again = bbox_vote_cuda.bbox_vote_batched_cuda(boxes, scores, valid, thr, max_out)
    want = bbox_vote_batched(boxes, scores, valid, thr, max_out)
    torch.cuda.synchronize()
    if not all(same_bits(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"vote kernel: two runs differ on {what}")
    if not (torch.equal(got.valid, want.valid) and torch.equal(got.scores, want.scores)):
        raise AssertionError(
            f"vote kernel != plain on {what}: {int((got.valid != want.valid).sum())} valid "
            f"flags, {int((got.scores != want.scores).sum())} scores differ")
    err = float((got.boxes - want.boxes).abs().nan_to_num(0.0).max())
    if not torch.allclose(got.boxes, want.boxes, rtol=1e-5, atol=1e-4, equal_nan=True):
        raise AssertionError(f"vote kernel boxes off by {err:.3e} on {what}")
    tiles = check_tiles(tiles, (valid & (scores > 0.0)).sum(dim=1), what)
    counts = got.valid.sum(dim=1)
    n_nan = int(torch.isnan(got.boxes).any(dim=-1).sum())
    log(f"  vote kernel == plain on {what} {tuple(scores.shape)} -> {max_out} at IoU >= {thr}: "
        f"valid and scores identical, max |box diff| {err:.3e} (rtol 1e-5, atol 1e-4"
        f"{f'; {n_nan} NaN boxes in both' if n_nan else ''}), two runs identical; outputs per "
        f"row {int(counts.min())}..{int(counts.max())}, tiles a row {int(tiles.min())}.."
        f"{int(tiles.max())}")
    return err


def vote_more_rows(rng, n):
    """Seeded (4, n) vote rows for the tile scan's own edges, as numpy
    (boxes (4, n, 4) f32, scores (4, n) f32, valid (4, n) bool):
      0  300 near-equal boxes, the rest invalid: one output, whose members
         come from later tiles' worth of the sorted list (the owner crosses
         tiles);
      1  n spread boxes, all valid (max_out 20 and 70 cut inside the first
         and the second tile);
      2  clusters under a zero-area box of the top score (selected first,
         it merges only itself);
      3  clusters with a NaN x1 and a NaN y2 on two valid boxes, a NaN y1 on
         an invalid one, and a NaN score (never active)."""
    boxes = np.zeros((4, n, 4), np.float32)
    scores = rng.uniform(0.05, 1.0, (4, n)).astype(np.float32)
    valid = np.ones((4, n), bool)
    boxes[0, :300] = np.float32([100, 100, 160, 170]) + rng.normal(0, 0.5, (300, 4))
    valid[0, 300:] = False
    xy = rng.uniform(0, 3000, (n, 2))
    boxes[1] = np.concatenate([xy, xy + rng.uniform(8, 60, (n, 2))], -1)
    centers = rng.uniform(0, 1000, (max(n // 12, 1), 2))
    for row in (2, 3):
        xy = centers[rng.integers(0, len(centers), n)] + rng.normal(0, 4, (n, 2))
        boxes[row] = np.concatenate([xy, xy + rng.uniform(20, 80, (n, 2))], -1)
    boxes[2, 0] = [20.0, 20.0, 20.0, 40.0]
    scores[2, 0] = 1.0
    boxes[3, 5, 0] = boxes[3, 40, 3] = boxes[3, 70, 1] = np.nan
    valid[3, 70] = False
    scores[3, 90] = np.nan
    return boxes, scores, valid


def phase12_synthetic(post, dev) -> float:
    """The vote kernel on the seeded edge rows at the TTA row length."""
    thr, max_out = post.vote_iou_threshold, post.max_detections
    rows = 8 * max_out  # max_variants x max_detections at the default config
    rng = np.random.default_rng(SEED + 12)
    b, s, v = (torch.from_numpy(a).to(dev) for a in vote_edge_rows(rng, rows, thr))
    log("phase 12: vote kernel against its plain version")
    err = compare_vote(b, s, v, thr, max_out, "seeded edge rows")
    got = bbox_vote_cuda.bbox_vote_batched_cuda(b, s, v, thr, max_out)
    if bool(got.valid[1].any()) or int(got.valid[2].sum()) != max_out:
        raise AssertionError("the empty row voted or the full row stopped early")
    if float(got.scores[4, 0]) != float(s[4, 0]) or float(got.scores[4, 1]) >= float(s[4, 1]):
        raise AssertionError("the pair at IoU == threshold did not merge")
    for t in (0.0, 1.0):
        err = max(err, compare_vote(b, s, v, t, max_out, f"seeded edge rows at threshold {t}"))
    for row in (0, 2, 6):  # the same kernel at B = 1
        err = max(err, compare_vote(b[row:row + 1], s[row:row + 1], v[row:row + 1],
                                    thr, max_out, f"edge row {row} at B=1"))
    err = max(err, compare_vote(b[:, :257].contiguous(), s[:, :257].contiguous(),
                                v[:, :257].contiguous(), thr, 20, "257-long rows, max_out 20"))
    err = max(err, compare_vote(b[:, :1].contiguous(), s[:, :1].contiguous(),
                                v[:, :1].contiguous(), thr, max_out, "R = 1"))
    mb, ms, mv = (torch.from_numpy(a).to(dev) for a in vote_more_rows(rng, rows))
    err = max(err, compare_vote(mb, ms, mv, thr, max_out,
                                "a 300-box cluster, spread boxes, a zero-area top box, NaNs"))
    got = bbox_vote_cuda.bbox_vote_batched_cuda(mb, ms, mv, thr, max_out)
    if int(got.valid[0].sum()) != 1 or float(got.scores[2, 0]) != 1.0:
        raise AssertionError("the cluster gave more than one output, or the zero-area box "
                             "was not selected first")
    if not (bool(torch.isnan(got.boxes[3][got.valid[3]][:, [0, 1, 3]]).all())
            and not bool(torch.isnan(got.boxes[3][got.valid[3]][:, 2]).any())):
        raise AssertionError("the NaN row's outputs are not NaN in its NaN columns alone")
    for cut in (20, 70):
        err = max(err, compare_vote(mb[1:2], ms[1:2], mv[1:2], thr, cut,
                                    f"spread boxes, max_out {cut} inside tile {cut // 64 + 1}"))
        if int(bbox_vote_cuda.LAST_TILES[0]) != cut // 64 + 1:
            raise AssertionError(f"max_out {cut} did not end the scan in tile {cut // 64 + 1}")
    return err


def phase12_real(vote_inputs, post, dev) -> float:
    """The vote kernel on the packed pre-vote detections of the TTA run."""
    b, s, v = (torch.from_numpy(a).to(dev) for a in vote_inputs[0][:3])
    log(f"phase 12: vote kernel on the TTA run's own pre-vote rows; valid detections per "
        f"image {int(v.sum(dim=1).min())}..{int(v.sum(dim=1).max())}")
    return compare_vote(b, s, v, post.vote_iou_threshold, post.max_detections,
                        "the TTA run's first vote chunk")


def blocked_stress_row(groups, copies, dev):
    """A sorted row built against a scan that reads a tile before every
    helper warp has ORed the earlier kept boxes into it: `groups` times a
    tile of 64 disjoint boxes (all kept: a long chain step, 64 words for a
    helper to OR into each later tile) followed by `copies` tiles that repeat
    it (all suppressed: short chain steps, the tile after next suppressed
    only by the helpers' ORs).  Boxes sit on a 10-px grid, 8 px wide."""
    q = np.arange(groups * 64)
    corner = np.stack([(q % 16) * 10.0, (q // 16) * 10.0], 1)
    first = np.concatenate([corner, corner + 8.0], 1).astype(np.float32)
    bx = np.concatenate([np.tile(first[k * 64:(k + 1) * 64], (1 + copies, 1))
                         for k in range(groups)])
    sc = np.linspace(1.0, 0.01, bx.shape[0]).astype(np.float32)
    return torch.from_numpy(bx).to(dev), torch.from_numpy(sc).to(dev)


def phase12_blocked(nms_rows, nan_row, post, dev) -> float:
    """The blocked NMS kernel: kept set against its plain version and
    against greedy_nms_rank's ranks (the tile scan: these rows are sorted),
    on the bench rows, on the bench row with two NaN coordinates, on 257
    and 20,000 seeded boxes and on two stress rows (blocked_stress_row), each
    of which is then launched 200 times more against the plain ranks."""
    boxes, scores = nms_rows
    thr, max_out = post.nms_iou_threshold, post.max_detections
    rng = np.random.default_rng(SEED + 9)
    small_b = torch.from_numpy(random_boxes(rng, 257)).to(dev)
    small_s = torch.from_numpy(np.sort(rng.uniform(0.01, 1.0, 257).astype(np.float32))[::-1]
                               .copy()).to(dev)
    cases = [(boxes[i], scores[i], thr, 0.0) for i in range(boxes.shape[0])]
    cases.append((nan_row[0], nan_row[1], thr, 0.0))
    cases += [(small_b, small_s, 0.4, 0.0), (small_b, small_s, 0.3, 0.5),
              (small_b, torch.zeros_like(small_s), 0.3, 0.0)]
    # Past 8,192 boxes the scan stages a capped range of columns and reads
    # the rest from L2: 20,000 seeded boxes (greedy_nms_rank's long-row path
    # there).
    big_b = torch.from_numpy(random_boxes(rng, 20000)).to(dev)
    big_s = torch.from_numpy(np.sort(rng.uniform(0.01, 1.0, 20000).astype(np.float32))[::-1]
                             .copy()).to(dev)
    cases.append((big_b, big_s, thr, 0.0))
    # 2,048 boxes: only the first helper warp has tiles to OR; 4,992: the
    # helpers' share of the tiles changes along the row.
    stress = [blocked_stress_row(4, 7, dev), blocked_stress_row(13, 5, dev)]
    cases += [(sb, ss, thr, 0.0) for sb, ss in stress]
    log("phase 12: blocked NMS kernel against its plain version and the ranks of greedy_nms_rank")
    diff = 0
    for bx, sc, t, sthr in cases:
        # max_out = N gives the whole kept set; then the path's max_out, and
        # cuts of the kernel's stop at the max_out-th kept box: inside the
        # first tile, at the edge of the tiles that hold the first half of
        # the kept boxes, and one past it.
        kept = nms_blocked_cuda._kept_plain(bx, sc, t, sthr)
        per_tile = torch.nn.functional.pad(kept, (0, -kept.shape[0] % 64)).view(-1, 64).sum(1)
        upto = per_tile.cumsum(0)
        half = min(int((upto < max(int(kept.sum()) // 2, 1)).sum()), upto.shape[0] - 1)
        edge = int(upto[half])
        cuts = sorted({sc.shape[0], max_out, 1, 20, edge, edge + 1})
        for out in cuts:
            got = nms_blocked_cuda.greedy_nms_blocked_cuda(bx, sc, t, out, sthr)
            want = nms_blocked_cuda.greedy_nms_blocked_plain(bx, sc, t, out, sthr)
            k1 = rank_to_result(
                nms_cuda.greedy_nms_rank(bx[None].contiguous(), sc[None].contiguous(), t,
                                         out, sthr), bx[None], sc[None], out)
            refs = [want, NMSResult(*(leaf[0] for leaf in k1))]
            torch.cuda.synchronize()
            off = [int((got.indices != w.indices).sum()) + int((got.valid != w.valid).sum())
                   for w in refs]
            diff = max(diff, *off)
            if any(off):
                raise AssertionError(
                    f"blocked NMS at N={sc.shape[0]} thr={t} score_thr={sthr} max_out={out}: "
                    f"{off[0]} kept entries differ from plain, {off[1]} from "
                    f"greedy_nms_rank")
        log(f"  blocked NMS == plain == greedy_nms_rank at N={sc.shape[0]} thr={t} "
            f"score_thr={sthr}, max_out {cuts} ({edge} = the kept boxes of tiles 1-{half + 1}): "
            f"ranks identical, {int(kept.sum())} kept in all")
    for sb, ss in stress:
        n = ss.shape[0]
        want = nms_blocked_cuda.kept_to_rank(nms_blocked_cuda._kept_plain(sb, ss, thr), n)
        off = torch.zeros((), dtype=torch.int64, device=dev)
        for _ in range(200):
            off += (nms_blocked_cuda._launch(sb, ss, thr, 0.0, n) != want).sum()
        off = int(off)
        diff = max(diff, off)
        if off:
            raise AssertionError(f"blocked NMS on the stress row of N={n}: {off} ranks differ "
                                 f"from plain over 200 launches")
        log(f"  blocked NMS on the stress row of N={n} ({int((want >= 0).sum())} kept): "
            f"ranks identical to plain in 200 launches")
    return float(diff)


class RecordingRunner(TTARunner):
    """The TTA runner, keeping the host rows of every vote launch so that
    phase 12 can hold the kernel against its plain version on them, with
    each launch's tiles a row, and the path that every NMS row of every
    bucket launch took."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.vote_inputs = []
        self.vote_tiles = []  # (tiles, active detections) a row, every vote launch
        self.nms_paths = []  # nms_cuda.LAST_PATHS of every bucket launch
        self.vote_paths = []  # bbox_vote_cuda.LAST_PATH of every vote launch

    def _run_bucket(self, *args, **kwargs):
        out = super()._run_bucket(*args, **kwargs)
        self.nms_paths.append(nms_cuda.LAST_PATHS)
        return out

    def _run_vote(self, boxes_b, scores_b, valid_b, buffer):
        fetch = super()._run_vote(boxes_b, scores_b, valid_b, buffer)
        self.vote_inputs.append(VoteRows(boxes_b, scores_b, valid_b, buffer))
        self.vote_tiles.append((bbox_vote_cuda.LAST_TILES,
                                torch.from_numpy((valid_b & (scores_b > 0.0)).sum(axis=1))))
        self.vote_paths.append(bbox_vote_cuda.LAST_PATH)
        return fetch


def expected_stats(items, runner, tta_batch, vote_batch):
    """run_dataset's launch statistics from the planners' arithmetic."""
    groups, variants = {}, 0
    for _, img, _ in items:
        for _, bucket, canvas in plan_variant_buckets(*img.shape[:2], runner.config):
            groups[(bucket, canvas)] = groups.get((bucket, canvas), 0) + 1
            variants += 1
    launches = sum(-(-n // runner.bucket_chunk(b, 1, tta_batch)) for (b, _), n in groups.items())
    return {"images": len(items), "variants": variants, "bucket_launches": launches,
            "vote_launches": -(-len(items) // runner._vote_chunk(1, vote_batch))}, groups


def phase13(cfg, dev, smi):
    """The TTA path at full width through the Detector's entry points."""
    post = cfg.postprocess
    det = Detector.from_random(SEED, cfg, dev)
    runner = det._tta_runner = RecordingRunner(det.model, cfg, device=dev)
    items = profile_tool.tta_images(TTA_IMAGES)
    keyed = [(k, im) for k, im, _ in items]
    sizes = [im.shape[:2] for _, im in keyed]
    want_stats, groups = expected_stats(items, runner, 16, 128)
    log(f"phase 13: TTA at the default config (bf16, buckets {cfg.tta.buckets}): "
        f"{len(items)} images of sizes {list(TTA_SIZES)}; planned {want_stats}; units by "
        f"(bucket, canvas) {dict(sorted(groups.items()))}")
    if {b for b, _ in groups} != set(cfg.tta.buckets):
        raise AssertionError("the images do not reach every bucket")

    t0 = time.perf_counter()
    n_warm = det.warmup_tta(sizes)
    torch.cuda.synchronize()
    log(f"  warmup_tta: {n_warm} launch shapes in {time.perf_counter() - t0:.2f} s")
    if n_warm != len(groups) + 1:
        raise AssertionError(f"warmup returned {n_warm}, expected {len(groups) + 1}")
    runner.vote_inputs.clear()
    runner.vote_tiles.clear()
    runner.nms_paths.clear()
    runner.vote_paths.clear()

    # The counted run: detect_tta on one image of each size, then the dataset.
    nms_cuda.LAUNCHES = bbox_vote_cuda.LAUNCHES = nms_blocked_cuda.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    singles = keyed[:len(TTA_SIZES)]
    t0 = time.perf_counter()
    one = {k: det.detect_tta(im) for k, im in singles}
    t_single = (time.perf_counter() - t0) / len(singles)
    nms_one, vote_one = nms_cuda.LAUNCHES, bbox_vote_cuda.LAUNCHES
    single_groups = sum(
        len({(b, c) for _, b, c in plan_variant_buckets(*im.shape[:2], cfg)}) for _, im in singles)
    runner.vote_inputs.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = det.detect_tta_dataset(keyed)  # tta_batch 16, vote_batch 128, max_pending 32
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    stats = dict(runner.last_run_stats)
    nms_ds, vote_ds = nms_cuda.LAUNCHES - nms_one, bbox_vote_cuda.LAUNCHES - vote_one
    peak = torch.cuda.max_memory_allocated() / 2**30
    vote_inputs = list(runner.vote_inputs)
    log(f"  detect_tta_dataset: {len(got)} images, {stats['variants']} variants in {secs:.3f} s "
        f"= {len(got) / secs:.2f} images/s, {stats['variants'] / secs:.1f} variants/s (host "
        f"clock, after warm-up, synchronised; {smi}); stats {stats}; detect_tta alone "
        f"{t_single * 1e3:.1f} ms an image (host clock, mean of {len(singles)}); peak device "
        f"memory {peak:.2f} GiB")
    log(f"  launches: greedy_nms_rank {nms_one} in detect_tta + {nms_ds} in the dataset run; "
        f"bbox_vote {vote_one} at B=1 + {vote_ds} batched")
    nms_rows_tta = torch.cat(runner.nms_paths)
    log(f"  NMS rows of detect_tta and the dataset run: {int(nms_rows_tta.sum())} of "
        f"{nms_rows_tta.numel()} took the tile scan in shared memory ({len(runner.nms_paths)} "
        f"launches); every vote launch the shared-memory path")
    if len(runner.nms_paths) != nms_one + nms_ds or not bool(
            (nms_rows_tta == nms_cuda.TILE_SCAN).all()):
        raise AssertionError("an NMS row of the TTA run took the argmax loop or the long-row "
                             "path, or a launch was not recorded")
    if runner.vote_paths != [bbox_vote_cuda.SHARED] * len(runner.vote_paths):
        raise AssertionError(f"vote launches of the TTA run took paths {runner.vote_paths}")
    if stats != want_stats:
        raise AssertionError(f"last_run_stats {stats} != planned {want_stats}")
    if (nms_ds, vote_ds) != (stats["bucket_launches"], stats["vote_launches"]):
        raise AssertionError("the kernels' launch counters do not match last_run_stats")
    if (nms_one, vote_one) != (single_groups, len(singles)):
        raise AssertionError(f"detect_tta launched {nms_one} NMS / {vote_one} vote kernels, "
                             f"expected {single_groups} / {len(singles)}")
    if list(got) != [k for k, _ in keyed]:
        raise AssertionError("run_dataset lost or reordered keys")
    tiles = torch.cat([check_tiles(t, a, "detect_tta and the dataset run")
                       for t, a in runner.vote_tiles])
    log(f"  vote rows of detect_tta and the dataset run: all {tiles.numel()} took the tile "
        f"scan ({len(runner.vote_tiles)} launches), {int(tiles.min())}..{int(tiles.max())} "
        f"tiles a row")
    if len(runner.vote_tiles) != vote_one + vote_ds:
        raise AssertionError("a vote launch was not recorded")

    check_dets([got[k] for k, _ in keyed], [im for _, im in keyed], post.max_detections)
    n_det = [len(got[k]["scores"]) for k, _ in keyed]
    log(f"  detections per image {min(n_det)}..{max(n_det)}, all finite, inside the image, "
        f"scores descending")
    same = lambda a, b: (np.array_equal(a["bboxes"], b["bboxes"])  # noqa: E731
                         and np.array_equal(a["scores"], b["scores"]))
    again = det.detect_tta_dataset(keyed)
    if not all(same(got[k], again[k]) for k in got):
        raise AssertionError("a second dataset run differs")
    # One image through the dataset runner takes the launch shapes of the
    # full run (short chunks are padded), so it must give the same bits
    # whatever else shared its launches.
    for k, im in singles:
        if not same(det.detect_tta_dataset([(k, im)])[k], got[k]):
            raise AssertionError(f"{k}: alone through the dataset runner != in the full run")
    log(f"  a second detect_tta_dataset run is bit-identical; each of {len(singles)} images "
        f"alone through the dataset runner is bit-identical to its entry in the full run")
    # The counted detect_tta calls above were the first at their launch
    # shapes (1-3 units, which warmup_tta does not run): the same images
    # again give the warm latency, and must give the same bits.
    t0 = time.perf_counter()
    warm = {k: det.detect_tta(im) for k, im in singles}
    t_warm = (time.perf_counter() - t0) / len(singles)
    if not all(same(warm[k], one[k]) for k, _ in singles):
        raise AssertionError("a second detect_tta of the same image differs")
    log(f"  detect_tta warm {t_warm * 1e3:.1f} ms an image (host clock, mean of {len(singles)}; "
        f"the first calls {t_single * 1e3:.1f} ms), bit-identical to the first calls ({smi})")
    # detect_tta launches 1-3 units where the dataset run launches 8 or 16:
    # the same image at the same launch shapes gives the same bits (above),
    # at other shapes cuDNN picks other kernels, bf16 rounds elsewhere, and
    # near-tied NMS and vote decisions of a random-init model flip.  So in
    # bf16 the two are held as sets of boxes, at the floors measured on this
    # card less a margin; in float32 (below) by value.
    fracs = [box_match(got[k], one[k]) for k, _ in singles]
    lo5, lo9 = min(f[0] for f in fracs), min(f[1] for f in fracs)
    log(f"  bf16 dataset run vs per-image detect_tta: share of boxes with a partner at IoU > "
        f"0.5 {lo5:.3f}..1 (gate {BF16_MATCH[0]}), at IoU > 0.9 {lo9:.3f}..1 (gate "
        f"{BF16_MATCH[1]})")
    if lo5 < BF16_MATCH[0] or lo9 < BF16_MATCH[1]:
        raise AssertionError(
            f"bf16 detect_tta and the dataset run share {lo5:.3f} of boxes at IoU > 0.5 and "
            f"{lo9:.3f} at IoU > 0.9; gates {BF16_MATCH}")

    # The blocked NMS has no dispatching path in either package; its public
    # wrapper is driven here on one TTA image's sorted pre-vote detections.
    bx, sc, va = runner.collect_variant_dets(singles[0][1])
    order = np.argsort(-sc[va], kind="stable")
    res = nms_blocked_cuda.greedy_nms_blocked_cuda(
        torch.from_numpy(bx[va][order]).to(dev), torch.from_numpy(sc[va][order]).to(dev),
        post.nms_iou_threshold, post.max_detections)
    torch.cuda.synchronize()
    blocked_launches = nms_blocked_cuda.LAUNCHES
    log(f"  greedy_nms_blocked_cuda on {int(va.sum())} sorted detections of one image: "
        f"{int(res.valid.sum())} kept; {blocked_launches} launch")
    if not (bool(res.valid.any()) and bool(torch.isfinite(res.boxes).all())):
        raise AssertionError("the blocked NMS wrapper returned nothing")

    # The eval CLI's tail, without a JPEG decoder: the detections as WIDER
    # txt files, read back, scored against seeded ground truth; then the same
    # files through `python -m dan_tpu_torch.eval --score_only`'s main(), the
    # ground truth as a WIDER annotation file.
    with tempfile.TemporaryDirectory() as d:
        pred_dir, root = os.path.join(d, "preds"), os.path.join(d, "wider")
        for k, _ in keyed:
            write_wider_detections(pred_dir, k + ".jpg", got[k]["bboxes"], got[k]["scores"])
        preds = load_detection_dir(pred_dir)
        if sorted(preds) != sorted(got):
            raise AssertionError("the detection files do not read back")
        aps = evaluate_widerface(preds, {k: g for k, _, g in items})
        os.makedirs(os.path.join(root, "wider_face_split"))
        with open(os.path.join(root, "wider_face_split", "wider_face_val_bbx_gt.txt"), "w") as f:
            for k, _, g in items:
                f.write(f"{k}.jpg\n{len(g)}\n")
                for x1, y1, x2, y2 in g.astype(int):
                    f.write(f"{x1} {y1} {x2 - x1} {y2 - y1} 0 0 0 0 0 0\n")
        cli_out = io.StringIO()
        with contextlib.redirect_stdout(cli_out):
            rc = eval_cli.main(["--score_only", "--pred_dir", pred_dir, "--wider_root", root])
    ap_line = (f"WIDER FACE val AP  easy={aps['easy']:.4f}  medium={aps['medium']:.4f}  "
               f"hard={aps['hard']:.4f}")
    log(f"  {ap_line}  (synthetic ground truth, random weights: printed, not gated)")
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in aps.values()):
        raise AssertionError(f"AP out of range: {aps}")
    if rc != 0 or cli_out.getvalue().strip().splitlines()[-1] != ap_line:
        raise AssertionError(f"the eval CLI's --score_only returned {rc} and printed "
                             f"{cli_out.getvalue()!r}, expected {ap_line!r}")
    log("  python -m dan_tpu_torch.eval --score_only main() printed the same line")

    # Where the time goes: one launch of each bucket at its chunk, the vote
    # launch, the 2048 bucket's memory, and a profiler pass.
    canvas = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 255, (1280, 1280, 3), dtype=np.uint8)).to(dev)
    per_bucket = {}
    top = max(cfg.tta.buckets)
    for bucket in cfg.tta.buckets:
        chunk = runner.bucket_chunk(bucket, 1, 16)
        args = (bucket, canvas[None].expand(chunk, -1, -1, -1),
                np.full(chunk, 768, np.float32), np.full(chunk, 1024, np.float32),
                np.full(chunk, bucket / 1024.0, np.float32), np.zeros(chunk, bool))
        if bucket == top:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        runner._run_bucket(*args)
        torch.cuda.synchronize()
        if bucket == top:
            peak_top = torch.cuda.max_memory_allocated() / 2**30
        per_bucket[bucket] = (chunk, cuda_ms(lambda: runner._run_bucket(*args), 2))
    vote_ms = cuda_ms(lambda: runner._run_vote(*vote_inputs[0]), 3)
    log("  ms per bucket launch (units): " + ", ".join(
        f"{b}: {ms:.2f} ({c})" for b, (c, ms) in per_bucket.items())
        + f"; ms per vote launch of 128 images (copies in and out included) {vote_ms:.3f}; "
        f"peak device memory of one {top}-bucket launch of {per_bucket[top][0]} units "
        f"{peak_top:.2f} GiB ({smi})")
    profile_tta(det, keyed[:32])
    weights = det.model.state_dict()
    del det, runner
    torch.cuda.empty_cache()
    float32_paths_agree(cfg, weights, keyed, dev)
    return {"vote_inputs": vote_inputs, "nms_launches": nms_one + nms_ds,
            "vote_launches": vote_ds, "vote_launches_one": vote_one,
            "blocked_launches": blocked_launches}


def box_match(a, b):
    """Share of a's boxes that have a box of b at IoU > 0.5 and > 0.9."""
    iou = pairwise_iou(torch.from_numpy(a["bboxes"]), torch.from_numpy(b["bboxes"]))
    best = iou.max(dim=1).values
    return float((best > 0.5).float().mean()), float((best > 0.9).float().mean())


def float32_paths_agree(cfg, weights, keyed, dev):
    """The same weights in float32 (TF32 off): the dataset run over all the
    images against per-image detect_tta, by value, on one image of each size
    taken from the middle of the run, where its units share their launches
    with other images'.  The two launch different batch shapes, so their
    convolutions sum in other orders: equal counts, and all but 1 % of an
    image's boxes paired within rtol 1e-4 / atol 1e-2 pixels and score rtol
    1e-4."""
    cfg32 = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"))
    model = DANDetector(cfg32.model)
    model.load_state_dict(weights)
    det = Detector(model, cfg32, dev)
    mid = len(keyed) // 2
    picks = keyed[mid:mid + len(TTA_SIZES)]
    if {im.shape[:2] for _, im in picks} != set(TTA_SIZES):
        raise AssertionError("the float32 picks do not cover every image size")
    one = {k: det.detect_tta(im) for k, im in picks}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = det.detect_tta_dataset(keyed)
    secs = time.perf_counter() - t0
    e_box = e_score = 0.0
    lone_max = 0
    for k, _ in picks:
        gb, gs, ob, os_ = got[k]["bboxes"], got[k]["scores"], one[k]["bboxes"], one[k]["scores"]
        if gb.shape != ob.shape:
            raise AssertionError(f"float32 {k}: dataset run gave {len(gs)} detections, "
                                 f"detect_tta {len(os_)}")
        # Row by row where the rows agree; a near-tied NMS or vote decision
        # that fell the other way moves a box or swaps two rows, so every box
        # is then paired with the nearest box of the other run.
        dist = np.abs(gb[:, None, :] - ob[None, :, :]).max(axis=-1)  # (n, n) pixels
        near = dist.argmin(axis=1)
        tol = 1e-2 + 1e-4 * np.abs(ob[near]).max(axis=-1)
        paired = (dist[np.arange(len(gb)), near] <= tol) & np.isclose(
            gs, os_[near], rtol=1e-4, atol=0.0)
        lone = int((~paired).sum())
        lone_max = max(lone_max, lone)
        if lone:
            log(f"    {k}: {lone} of {len(gb)} boxes have no partner within tolerance; scores "
                f"{gs[~paired][:4].tolist()}, nearest at {dist.min(axis=1)[~paired][:4].tolist()} px")
        if lone > F32_LONE_BOXES * len(gb):
            raise AssertionError(f"float32 {k}: {lone} of {len(gb)} boxes of the dataset run "
                                 f"have no partner in detect_tta within tolerance")
        e_box = max(e_box, float(dist[np.arange(len(gb)), near][paired].max()))
        e_score = max(e_score, float(np.abs(gs - os_[near])[paired].max()))
    log(f"  float32 (TF32 off) dataset run of {len(keyed)} images ({secs:.1f} s) against "
        f"per-image detect_tta on {len(picks)} images from its middle, one of each size: equal "
        f"counts; at most {lone_max} boxes an image without a partner (gate "
        f"{F32_LONE_BOXES:.1%}); the paired boxes within {e_box:.3e} px, scores {e_score:.3e} "
        f"(boxes rtol 1e-4 / atol 1e-2, scores rtol 1e-4)")
    del det, model
    torch.cuda.empty_cache()


def profile_tta(det, keyed):
    """torch.profiler over one dataset run of a few images: device kernel
    time against the run's event time (the device's busy share), and the
    kernels that take the most of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        det.detect_tta_dataset(keyed)
        end.record()
        torch.cuda.synchronize()
    span = start.elapsed_time(end)
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = lambda e: e.self_device_time_total  # noqa: E731
    busy = sum(dev_us(e) for e in events) / 1e3
    log(f"  profiler over a dataset run of {len(keyed)} images: device kernel time "
        f"{busy:.1f} ms of {span:.1f} ms (event clock) = busy share {busy / span:.3f}")
    for e in sorted(events, key=dev_us, reverse=True)[:10]:
        log(f"    {dev_us(e) / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:90]}")


def blocked_passes(bx, sc, thr, max_out):
    """CUDA-event ms of the blocked NMS's two passes apart, each launched
    alone back to back on one row (uncounted: timing only), after checking
    that the scan's ranks equal the wrapper's."""
    lib = nms_blocked_cuda.build()
    n = sc.shape[0]
    mask = torch.empty((lib.nms_blocked_mask_words(n),), dtype=torch.int64, device=sc.device)
    rank = torch.empty((n,), dtype=torch.int32, device=sc.device)

    def mask_pass():
        _cuda_build.check(lib.nms_blocked_mask_launch(
            bx.data_ptr(), mask.data_ptr(), n, float(thr), _cuda_build.stream_of(bx)), "mask")

    def scan_pass():
        _cuda_build.check(lib.nms_blocked_scan_launch(
            sc.data_ptr(), mask.data_ptr(), rank.data_ptr(), n, 0.0, int(max_out),
            _cuda_build.stream_of(sc)), "scan")

    mask_pass()
    scan_pass()
    want = nms_blocked_cuda._launch(bx, sc, thr, 0.0, max_out)
    torch.cuda.synchronize()
    if not torch.equal(rank, want):
        raise AssertionError("the blocked NMS's passes alone rank other boxes than its wrapper")
    return {"pass1": cuda_ms(mask_pass, 50), "pass2": cuda_ms(scan_pass, 50)}


def phase14(vote_inputs, nms_rows, post, dev, smi):
    """Times of the vote and blocked-NMS kernels (CUDA events over
    back-to-back calls after warm-up), the vote's own device time, and
    their bounds from these inputs."""
    thr, max_out = post.vote_iou_threshold, post.max_detections
    b, s, v = (torch.from_numpy(a).to(dev) for a in vote_inputs[0][:3])
    b1, s1, v1 = b[:1].contiguous(), s[:1].contiguous(), v[:1].contiguous()
    bx, sc = nms_rows[0][0], nms_rows[1][0]
    nthr = post.nms_iou_threshold
    calls = {
        "vote": lambda: bbox_vote_cuda.bbox_vote_batched_cuda(b, s, v, thr, max_out),
        "vote1": lambda: bbox_vote_cuda.bbox_vote_batched_cuda(b1, s1, v1, thr, max_out),
        "blocked": lambda: nms_blocked_cuda.greedy_nms_blocked_cuda(bx, sc, nthr, max_out),
    }
    out = {}
    for key, call in calls.items():
        for _ in range(3):
            call()
        out[key] = {"kernel": cuda_ms(call, 40)}
    # The wrapper's check of the descending order waits for the device, and
    # rank_to_result follows the kernel: the two launches alone, beside it,
    # and each pass alone.
    out["blocked"]["launch"] = cuda_ms(
        lambda: nms_blocked_cuda._launch(bx, sc, nthr, 0.0, max_out), 20)
    out["blocked"].update(blocked_passes(bx, sc, nthr, max_out))
    k1_ms = cuda_ms(lambda: rank_to_result(
        nms_cuda.greedy_nms_rank(bx[None], sc[None], nthr, max_out), bx[None], sc[None],
        max_out), 20)
    k1_launch_ms = cuda_ms(
        lambda: nms_cuda.greedy_nms_rank(bx[None], sc[None], nthr, max_out), 20)
    for key, args in (("vote", (b, s, v)), ("vote1", (b1, s1, v1))):
        call = lambda: bbox_vote_cuda.bbox_vote_batched_cuda(*args, thr, max_out)  # noqa: E731
        alone = lambda: bbox_vote_cuda._launch(*args, thr, max_out)  # noqa: E731
        dev_t, out[key]["device_from"] = device_ms(call, 20, ("bbox_vote_kernel",), alone)
        out[key]["device"] = dev_t["bbox_vote_kernel"]
        out[key]["host"] = host_ms(call)
        if bbox_vote_cuda.LAST_PATH != bbox_vote_cuda.SHARED:
            raise AssertionError(f"the vote at {tuple(args[1].shape)} left shared memory")
    log(f"phase 14: bbox_vote at {tuple(s.shape)} -> {max_out}: kernel "
        f"{out['vote']['kernel']:.4f} ms (its device time {out['vote']['device']:.4f} ms by "
        f"{out['vote']['device_from']}, the wrapper's host time {out['vote']['host']:.4f} ms); "
        f"at B=1: kernel {out['vote1']['kernel']:.4f} ms "
        f"(device {out['vote1']['device']:.4f} ms by {out['vote1']['device_from']}, host "
        f"{out['vote1']['host']:.4f} ms) ({smi})")
    log(f"phase 14: greedy_nms_blocked at ({sc.shape[0]}, {max_out}): the wrapper (order check "
        f"that waits for the device, both passes, rank_to_result) "
        f"{out['blocked']['kernel']:.4f} ms, its two passes alone "
        f"{out['blocked']['launch']:.4f} ms (pass 1, the mask, {out['blocked']['pass1']:.4f} ms; "
        f"pass 2, the scan with the ranks, {out['blocked']['pass2']:.4f} ms, each alone); "
        f"greedy_nms_rank (tile scan) at B=1 with "
        f"rank_to_result {k1_ms:.4f} ms, alone {k1_launch_ms:.4f} ms ({smi})")

    # Bounds, from what these inputs need.  Vote: 21 bytes a detection in,
    # 21 an output slot; in each dependent step an IoU, a test and an argmax
    # compare for every detection still active, and five multiply-adds once
    # for every detection that merges.
    # The kernel's chain is its tiles (LAST_TILES); the outputs are the
    # selection's dependent steps, which the replay must count alike.
    res = bbox_vote_cuda.bbox_vote_batched_cuda(b, s, v, thr, max_out)
    tiles = bbox_vote_cuda.LAST_TILES.cpu()
    steps, pairs, merged = selection_work(b, s, v & (s > 0.0), thr, max_out, True)
    if not torch.equal(steps, res.valid.sum(dim=1)):
        raise AssertionError("the replay of the vote counts other steps than the kernel")
    n_rows, r = s.shape
    pair_ops = IOU_OPS + TEST_OPS + ARGMAX_OPS
    vote_ops = pairs * pair_ops + merged * MERGE_OPS
    bounds = {
        "vote": bound(n_rows * 21 * (r + max_out), int(vote_ops.sum()), PEAK_F32)
        + (int(tiles.max()), int(steps.max())),
        "vote1": bound(21 * (r + max_out), int(vote_ops[0]), PEAK_F32)
        + (int(tiles[0]), int(steps[0])),
    }
    # Blocked NMS: 20 bytes a box in, 1 out; an IoU and a test for every
    # (kept box, later box not yet removed) pair up to the max_out-th kept
    # box (sorted input: no argmax); the scan's chain is one step a 64-box
    # tile.
    n = sc.shape[0]
    _, k9_pairs, _ = selection_work(bx[None], sc[None], sc[None] > 0.0, nthr, max_out, False)
    bounds["blocked"] = bound(21 * n, int(k9_pairs[0]) * (IOU_OPS + TEST_OPS), PEAK_F32) + (
        -(-n // nms_blocked_cuda.TILE), None)
    log(f"  this run's work: vote {int(pairs.sum())} IoU pairs and {int(merged.sum())} merges "
        f"over {n_rows} rows ({int(pairs[0])} and {int(merged[0])} in row 0); blocked NMS "
        f"{int(k9_pairs[0])} IoU pairs of {n * (n - 1) // 2}")
    for name, (ms_b, by, chain, outs) in bounds.items():
        log(f"  bound {name}: {ms_b:.5f} ms by {by}; {chain} dependent steps"
            + (f" (tiles) for {outs} outputs" if outs is not None else ""))
    return out, bounds

# ---------------------------------------------------------------------------
# data parallelism: phase 15
# ---------------------------------------------------------------------------


def card_rank(fn, rank, world_size, init_method, *args):
    """fn on a spawned rank with this script's numerics (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return fn(rank, world_size, init_method, *args)


def dp_batch(cfg, i):
    """Global host batch i of phase 15's train legs."""
    return synthetic_batch(cfg, TRAIN_BATCH, seed=300 + i)


def dp_items(n):
    """Phase 15's TTA images: the first n of phase 13's, as (key, image)."""
    return [(k, img) for k, img, _ in profile_tool.tta_images(n)]


def one_device_steps(cfg, dev):
    """DP_STEPS train_step calls on one device from create_train_state(SEED),
    recording what train_rank records; the host ms a step (synchronised)."""
    state = create_train_state(cfg, SEED, dev)
    out = {"metrics": [], "targets": [], "hard_negatives": [], "ms": []}
    for i in range(DP_STEPS):
        batch = dp_batch(cfg, i)
        images, targets = preprocess_and_match(batch, cfg, dev)
        cls_logits, _ = state.model(images)
        out["hard_negatives"].append(hard_negatives(
            class_ce(cls_logits, targets.cls_target), targets.cls_target, cfg.train).cpu().numpy())
        out["targets"].append({k: v.cpu().numpy() for k, v in targets._asdict().items()})
        del images, targets, cls_logits
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(state, batch)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["state"] = ckpt.state_payload(state)
    return out


def max_param_diff(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in b)


def differing(a, b):
    """The names of the tensors of payload dict a that are not torch.equal
    to b's."""
    return [k for k in b if not torch.equal(a[k], b[k])]


def dp_expected(items, runner, rank, n, tta_batch, vote_batch):
    """A rank's bucket and vote launches from the planners: the chunks of
    each (bucket, canvas) group, and of the vote, in which its block holds
    an entry."""
    groups = {}
    for _, img in items:
        for _, bucket, canvas in plan_variant_buckets(*img.shape[:2], runner.config):
            groups[(bucket, canvas)] = groups.get((bucket, canvas), 0) + 1
    per = {b: runner.bucket_chunk(b, n, tta_batch) // n for b, _ in groups}
    vchunk = runner._vote_chunk(n, vote_batch)
    return (sum(len(range(rank * per[b], m, n * per[b])) for (b, _), m in groups.items()),
            len(range(rank * (vchunk // n), len(items), vchunk)))


class Checks:
    """Phase 15's checks: each is printed, and every failure is raised at
    the end of the phase, so that one run reports all of them."""

    def __init__(self):
        self.failed = []

    def __call__(self, ok: bool, what: str) -> None:
        log(f"  [{'ok' if ok else 'FAILED'}] {what}")
        if not ok:
            self.failed.append(what)


def check_train_ranks(check, ranks, one, start, label, exact):
    """One leg's DP train steps against the one-device steps."""
    n = len(ranks)
    check(len({r["digest"] for r in ranks}) == 1, f"{label}: the {n} replicas are bit-identical")
    check(all(r["ooms"] == 0 for r in ranks),
          f"{label}: no rank's allocation ran out of device memory ({[r['ooms'] for r in ranks]})")
    check(all(r["metrics"] == ranks[0]["metrics"] for r in ranks),
          f"{label}: every rank reports the same global metrics")
    same_targets = all(
        np.array_equal(np.concatenate([r["targets"][i][k] for r in ranks]), want)
        for i in range(DP_STEPS) for k, want in one["targets"][i].items())
    check(same_targets, f"{label}: matcher targets (all four leaves) identical to one device")
    neg_diff = [int((np.concatenate([r["hard_negatives"][i] for r in ranks])
                     != one["hard_negatives"][i]).sum()) for i in range(DP_STEPS)]
    n_neg = [int(h.sum()) for h in one["hard_negatives"]]
    counts = all(r_m[k] == o_m[k] for r_m, o_m in zip(ranks[0]["metrics"], one["metrics"])
                 for k in ("num_pos", "num_neg_selected"))
    check(counts, f"{label}: num_pos and num_neg_selected identical at every step "
          f"({[m['num_pos'] for m in one['metrics']]}, "
          f"{[m['num_neg_selected'] for m in one['metrics']]})")
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                   for a, b in zip(ranks[0]["metrics"], one["metrics"]))
    upd = dry.update_rel_l2(ranks[0]["state"]["model"], one["state"]["model"], start)
    diff = max_param_diff(ranks[0]["state"]["model"], one["state"]["model"])
    log(f"  {label}: hard negatives differing from one device {neg_diff} of {n_neg} a step; "
        f"loss rel diff {loss_rel:.3e}; parameter update rel L2 {upd:.3e}, max |dp| {diff:.3e}")
    if exact:
        mom = differing(ranks[0]["state"]["momentum"], one["state"]["momentum"])
        check(ranks[0]["metrics"] == one["metrics"] and diff == 0.0 and sum(neg_diff) == 0
              and not mom, f"{label}: metrics, hard negatives, parameters and momentum "
              f"bit-identical to one device (momentum tensors differing: {mom[:4]})")
    else:
        check(loss_rel <= DP_LOSS_RTOL and upd <= DP_UPDATE_RTOL,
              f"{label}: loss within {DP_LOSS_RTOL} and update within {DP_UPDATE_RTOL}")
    for r, rk in enumerate(ranks):
        want = {name: DP_STEPS * PER_STEP[name] for name in PER_STEP}
        got = {name: rk["launches"][name] for name in PER_STEP}
        check(got == want, f"{label}: rank {r} launched K3+K4 / K5 / K6 / the upsample gradient "
              f"{got} in {DP_STEPS} steps")


def check_tta_ranks(check, ranks, ref, items, runner, label):
    """One leg's sharded TTA run against the one-device run."""
    n = len(ranks)
    check(all(r["ooms"] == 0 for r in ranks),
          f"{label}: no rank's allocation ran out of device memory (ranks {[r['ooms'] for r in ranks]}; "
          "cuDNN would take another algorithm)")
    differ = [[k for k in ref if not (
        np.array_equal(r["results"][k]["bboxes"], ref[k]["bboxes"])
        and np.array_equal(r["results"][k]["scores"], ref[k]["scores"]))]
        if list(r["results"]) == list(ref) else ["(other keys)"] for r in ranks]
    for rank, keys in enumerate(differ):
        for k in keys[:4]:
            got = ranks[rank]["results"].get(k)
            log(f"    rank {rank} {k}: {0 if got is None else len(got['scores'])} detections, "
                f"one device {len(ref[k]['scores'])}")
    check(not any(differ), f"{label}: every rank's {len(ref)} images bit-identical to one device "
          f"(differing a rank: {[len(d) for d in differ]})")
    for rank, r in enumerate(ranks):
        m = r["memory"]
        log(f"  {label}: rank {rank} peak {m['allocated_gib']:.2f} GiB in use, "
            f"{m['reserved_gib']:.2f} GiB reserved, {m['retries']} cache flushes to retry an "
            f"allocation")
        bucket, vote = dp_expected(items, runner, rank, n, 16, 128)
        stats = r["stats"]
        check((stats["bucket_launches"], stats["vote_launches"]) == (bucket, vote)
              and (r["launches"]["nms"], r["launches"]["bbox_vote"]) == (bucket, vote),
              f"{label}: rank {rank} launched K1 {r['launches']['nms']} and K7 "
              f"{r['launches']['bbox_vote']} times = last_run_stats {stats} = planners "
              f"({bucket}, {vote}); the run {r['s']:.3f} s")


# Phase 15d: the train CLI under torchrun, launched in pairs (one step with a
# checkpoint, then one more resumed from it), TEARDOWN_ROUNDS times; then the
# eval CLI, with TTA and without, on EVAL_LIMIT images of the fixture.
TEARDOWN_ROUNDS = 3
EVAL_LIMIT = 4
# A sitecustomize for the torchrun workers: when the interpreter starts to
# shut down (threading's exit hooks run before it joins the non-daemon
# threads), it prints the Python threads other than the main one that are
# alive, and the names of the process's other threads (/proc: NCCL's,
# gloo's, CUDA's and torch's own, which Python does not see).  It then runs
# the sitecustomize that it shadows, if the environment has one.
EXIT_THREADS_HOOK = """import importlib.machinery, importlib.util, json, os, sys, threading


def _exit_threads():
    alive = [[t.name, t.daemon] for t in threading.enumerate()
             if t is not threading.main_thread() and t.is_alive()]
    python = {t.native_id for t in threading.enumerate()}
    native = []
    for tid in sorted(os.listdir("/proc/self/task"), key=int):
        if int(tid) not in python:
            try:
                with open(f"/proc/self/task/{tid}/comm") as f:
                    native.append(f.read().strip())
            except OSError:
                pass
    sys.stderr.write("exit threads " + json.dumps(
        {"rank": int(os.environ["RANK"]), "threads": alive, "native": native}) + "\\n")
    sys.stderr.flush()


if "LOCAL_RANK" in os.environ:
    threading._register_atexit(_exit_threads)

_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
"""


def native_groups(names):
    """A rank's other threads at exit by owner: NCCL's, gloo's, the rest."""
    low = [(n, n.lower()) for n in names]
    return {"nccl": [n for n, m in low if "nccl" in m],
            "gloo": [n for n, m in low if "gloo" in m],
            "other": sorted(collections.Counter(
                n for n, m in low if "nccl" not in m and "gloo" not in m).items())}


def torchrun_once(module, args, d, env, what, fails, secs):
    """`python -m torch.distributed.run --standalone --nproc_per_node 1 -m
    module args` in REPO with the exit hook on its PYTHONPATH.  Logs its
    exit code, seconds and the threads alive at the rank's exit; a launch
    that exits non-zero or leaves a Python thread but the main one alive
    goes into `fails`.  Returns the finished process."""
    launch = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
              "1", "-m", module] + args
    t0 = time.perf_counter()
    proc = subprocess.run(launch, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    secs.append(time.perf_counter() - t0)
    exits = [json.loads(line[len("exit threads "):])
             for line in proc.stderr.splitlines() if line.startswith("exit threads ")]
    ok = proc.returncode == 0 and [(e["rank"], e["threads"]) for e in exits] == [(0, [])]
    log(f"  phase 15d {what}: rc {proc.returncode} in {secs[-1]:.1f} s; Python threads alive at "
        f"the rank's exit {[e['threads'] for e in exits]}; its other threads "
        f"{[native_groups(e['native']) for e in exits]}")
    if not ok:
        fails.append(what)
        log("    its stderr ends: " + proc.stderr[-3000:].replace("\n", "\n    "))
    return proc


def phase15d(check, smi):
    """The train CLI under torchrun on NCCL, one rank on cuda:0, as a user
    launches it: one step with a checkpoint, then one more resumed from it,
    TEARDOWN_ROUNDS times; then the eval CLI the same way on EVAL_LIMIT
    images of the fixture, with TTA and with --no_tta (each runs its
    decode on an iter_prefetch stream).  Every launch must exit 0, the
    second train launch say it resumed from step 1 and the log hold steps
    [1, 2], the eval launches print their AP line; when the rank's
    interpreter starts to shut down (after the process group's teardown) no
    Python thread but the main one may be alive.  The process's other
    threads are printed by owner."""
    from dan_tpu_torch.tools import soak_fixture_e2e as soak

    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    train = ["--synthetic", "--batch_size", str(TRAIN_BATCH), "--checkpoint_every", "1",
             "--log_every", "1"]
    secs, fails = [], []
    with tempfile.TemporaryDirectory(prefix="dan_teardown_") as d:
        with open(os.path.join(d, "sitecustomize.py"), "w") as f:
            f.write(EXIT_THREADS_HOOK)
        env["PYTHONPATH"] = os.pathsep.join(p for p in (d, REPO, env.get("PYTHONPATH")) if p)
        for r in range(TEARDOWN_ROUNDS):
            model_dir = os.path.join(d, f"run_{r}")
            for extra in (["--steps", "1"], ["--steps", "2", "--resume"]):
                what = f"train round {r} {' '.join(extra)}"
                proc = torchrun_once("dan_tpu_torch.train", train + ["--model_dir", model_dir]
                                     + extra, d, env, what, fails, secs)
                if proc.stderr.count("resumed from step 1") != (extra[-1] == "--resume"):
                    fails.append(f"{what}: resumed?")
            log_path = os.path.join(model_dir, "train_metrics.jsonl")
            steps = []
            if os.path.exists(log_path):
                with open(log_path) as f:
                    steps = [json.loads(line)["step"] for line in f]
            if steps != [1, 2]:
                fails.append(f"round {r}: logged steps {steps}")
        for extra in ([], ["--no_tta"]):
            what = f"eval {' '.join(extra) or '(TTA)'}"
            proc = torchrun_once(
                "dan_tpu_torch.eval", ["--wider_root", soak.FIX, "--gt_mats", os.path.join(
                    soak.FIX, "eval_tools", "ground_truth"), "--limit", str(EVAL_LIMIT),
                    "--output_dir", os.path.join(d, f"eval{len(extra)}")] + extra,
                d, env, what, fails, secs)
            last = proc.stdout.strip().splitlines()[-1:] or [""]
            log(f"    its last line: {last[0]}")
            if "WIDER FACE" not in last[0]:
                fails.append(f"{what}: no AP line")
    log(f"phase 15d: torchrun --standalone --nproc_per_node 1 (NCCL): -m dan_tpu_torch.train at "
        f"batch {TRAIN_BATCH}, {TEARDOWN_ROUNDS} x (--steps 1, then --steps 2 --resume), then -m "
        f"dan_tpu_torch.eval on {EVAL_LIMIT} fixture images with TTA and --no_tta: seconds a "
        f"launch {[round(t, 1) for t in secs]} ({smi})")
    check(not fails, f"15d: {2 * TEARDOWN_ROUNDS} torchrun launches of the train CLI and 2 of "
          f"the eval CLI exit 0, the train CLI logs steps [1, 2], the eval CLI its AP line, and "
          f"each leaves only the main Python thread at exit (failed: {fails})")


def phase15(cfg, tcfg, dev, smi):
    """Data parallelism on the card; returns the per-rank launches of the
    2-rank leg."""
    check = Checks()
    start = ckpt.state_payload(create_train_state(tcfg, SEED, "cpu"))["model"]
    one = one_device_steps(tcfg, dev)
    again = one_device_steps(tcfg, dev)
    # The default train step trains one model per seed: a second run from
    # create_train_state(SEED) on the same batches is bit-identical in every
    # parameter, every momentum buffer and every metric.
    spread = dry.update_rel_l2(again["state"]["model"], one["state"]["model"], start)
    params = differing(again["state"]["model"], one["state"]["model"])
    moms = differing(again["state"]["momentum"], one["state"]["momentum"])
    log(f"phase 15: one device, {DP_STEPS} steps at batch {TRAIN_BATCH}: "
        f"{np.mean(one['ms'][1:]):.3f} ms a step after the first (host clock, synchronised); "
        f"a second run: {len(params)} of {len(one['state']['model'])} parameter and {len(moms)} "
        f"of {len(one['state']['momentum'])} momentum tensors differ (max |dp| "
        f"{max_param_diff(again['state']['model'], one['state']['model']):.3e}, update rel L2 "
        f"{spread:.3e}), metrics {'identical' if again['metrics'] == one['metrics'] else 'differ'}"
        f" ({smi})")
    check(not params and not moms and again["metrics"] == one["metrics"],
          f"one device: two default runs of {DP_STEPS} steps from create_train_state({SEED}) "
          f"bit-identical in every parameter, momentum buffer and metric (differing: "
          f"{(params + moms)[:4]})")
    batch_fn = functools.partial(dp_batch, tcfg)
    train_args = (tcfg, SEED, batch_fn, DP_STEPS)

    det = Detector.from_random(SEED, cfg, dev)
    items = dp_items(DP_TTA_IMAGES)
    det.warmup_tta([im.shape[:2] for _, im in items], 16, 128)
    t0 = time.perf_counter()
    ref = det.detect_tta_dataset(items, 16, 128)
    torch.cuda.synchronize()
    tta_one_s = time.perf_counter() - t0
    runner = det._get_tta_runner()
    weights = {k: v.cpu() for k, v in det.model.state_dict().items()}
    tta_args = (cfg, weights, functools.partial(dp_items, DP_TTA_IMAGES), 16, 128)
    log(f"phase 15: one device, {DP_TTA_IMAGES} TTA images: {tta_one_s:.3f} s = "
        f"{DP_TTA_IMAGES / tta_one_s:.2f} images/s, {runner.last_run_stats}; allocations of this "
        f"process that ran out of device memory so far: {dry.allocator_ooms(dev)}; ranks that "
        f"share the card hold {dry.CARD_SHARE} of its memory between them")
    del det
    torch.cuda.empty_cache()

    def ranks_of(fn, n, backend, args):
        return spawn(functools.partial(card_rank, fn), n, ("cuda", backend) + args, timeout=600,
                     threads=None)

    # (a) NCCL at world size 1.
    r1 = ranks_of(dry.train_rank, 1, "nccl", train_args)
    log(f"phase 15a: NCCL, 1 rank: {np.mean(r1[0]['ms'][1:]):.3f} ms a step after the first, "
        f"one all-reduce of the gradients' buffer {r1[0]['allreduce_ms']:.3f} ms ({smi})")
    check_train_ranks(check, r1, one, start, "15a NCCL x1", exact=True)
    t1 = ranks_of(dry.tta_rank, 1, "nccl", tta_args)
    check_tta_ranks(check, t1, ref, items, runner, "15a NCCL x1")

    # (b) gloo, two ranks sharing cuda:0.
    r2 = ranks_of(dry.train_rank, 2, "gloo", train_args)
    ms2 = np.mean([np.mean(r["ms"][1:]) for r in r2])
    ar2 = np.mean([r["allreduce_ms"] for r in r2])
    log(f"phase 15b: gloo, 2 ranks on cuda:0, 16 images a rank: {ms2:.3f} ms a step after the "
        f"first = {TRAIN_BATCH / ms2 * 1e3:.1f} img/s (one device {np.mean(one['ms'][1:]):.3f}); "
        f"one all-reduce of the gradients' buffer {ar2:.3f} ms = {ar2 / ms2:.3f} of a step "
        f"({smi})")
    check_train_ranks(check, r2, one, start, "15b gloo x2", exact=False)
    t2 = ranks_of(dry.tta_rank, 2, "gloo", tta_args)
    check_tta_ranks(check, t2, ref, items, runner, "15b gloo x2")
    dry_launches = []
    try:
        dry_launches = [r["launches"] for r in dry.dryrun_multichip(2, "cuda", "gloo")]
        k6 = [(r["conv12_wgrad_f32"], r["conv12_wgrad"]) for r in dry_launches]
        check(k6 == [(3, 0)] * 2, f"15b: tools/dryrun_multichip.py's three legs in float32 on 2 "
              f"ranks sharing cuda:0; (float32, bf16) K6 launches a rank {k6}: the float32 "
              f"kernel once a step (3 steps), the bf16 kernel never")
    except (AssertionError, RuntimeError) as e:
        check(False, f"15b: tools/dryrun_multichip.py on 2 ranks sharing cuda:0: {e}")

    # (c) NCCL over the host's cards.
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        log(f"phase 15c: not run: this host has {torch.cuda.device_count()} CUDA device, and "
            "NCCL over cards needs two or more")
    else:
        rn = ranks_of(dry.train_rank, n, "nccl", train_args)
        msn = np.mean([np.mean(r["ms"][1:]) for r in rn])
        log(f"phase 15c: NCCL over {n} cards: {msn:.3f} ms a step = "
            f"{TRAIN_BATCH / msn * 1e3:.1f} img/s against one card's "
            f"{TRAIN_BATCH / np.mean(one['ms'][1:]) * 1e3:.1f}; all-reduce "
            f"{np.mean([r['allreduce_ms'] for r in rn]):.3f} ms ({smi})")
        check_train_ranks(check, rn, one, start, f"15c NCCL x{n}", exact=False)
        tn = ranks_of(dry.tta_rank, n, "nccl", tta_args)
        s_n = max(r["s"] for r in tn)
        log(f"phase 15c: TTA over {n} cards: {DP_TTA_IMAGES / s_n:.2f} images/s against one "
            f"card's {DP_TTA_IMAGES / tta_one_s:.2f}")
        check_tta_ranks(check, tn, ref, items, runner, f"15c NCCL x{n}")

    # (d) the train CLI's teardown under torchrun.
    phase15d(check, smi)
    if check.failed:
        raise AssertionError("phase 15: " + "; ".join(check.failed))
    return {"train": [r["launches"] for r in r2], "tta": [r["launches"] for r in t2],
            "dryrun": dry_launches}



# ---------------------------------------------------------------------------
# int8 deployment: phases 16-18
# ---------------------------------------------------------------------------

# The 18 int8 convolutions of one forward: the packed conv1_2', then the body.
I8_PER_FORWARD = 18
CALIB_IMAGES = 8
I8_REPLACES = "dan_tpu/quant.py:126 (no TPU kernel: XLA's s8 conv + the fused epilogue)"


def i8_layers(qdet):
    """(name, QuantConv) of the int8 convolutions in forward order."""
    return [("conv1_2", qdet.conv12)] + list(qdet.body.items())


def check_i8(x, k, deq, bias, inv, stride, dilation, pad, what, modes=False) -> int:
    """The int8 kernel against its plain version on the same CUDA tensors:
    the s32 sum, the float32 and bf16 taps and the s8 output bit-identical,
    a second run bit-identical, and (modes) each output asked for alone the
    same as together.  Returns max |acc|."""
    acc = conv_i8_plain(x, k, stride, dilation, pad)
    tap32, q = conv_i8_epilogue_plain(acc, deq, bias, inv, torch.float32)
    run = lambda dt, **kw: conv_i8_cuda.conv_i8(  # noqa: E731
        x, k, deq, bias, inv, stride, dilation, pad, dt, **kw)
    a = run(torch.float32, with_acc=True)
    b = run(torch.bfloat16)
    again = run(torch.float32, with_acc=True)
    torch.cuda.synchronize()
    ok = (same_bits(a.acc, acc) and same_bits(a.tap, tap32)
          and torch.equal(b.tap.view(torch.int16), tap32.to(torch.bfloat16).view(torch.int16))
          and (q is None or (torch.equal(a.q, q) and torch.equal(b.q, q)))
          and same_bits(again.acc, a.acc) and same_bits(again.tap, a.tap)
          and (q is None or torch.equal(again.q, a.q)))
    if modes:
        alone = [conv_i8_cuda.conv_i8(x, k, deq, bias, None, stride, dilation, pad,
                                      torch.float32).tap,
                 conv_i8_cuda.conv_i8(x, k, deq, bias, None, stride, dilation, pad,
                                      torch.bfloat16).tap,
                 conv_i8_cuda.conv_i8(x, k, deq, bias, None, stride, dilation, pad,
                                      with_acc=True).acc]
        torch.cuda.synchronize()
        ok = ok and same_bits(alone[0], a.tap) and torch.equal(alone[1], b.tap)
        ok = ok and same_bits(alone[2], a.acc)
        if inv is not None:
            q_alone = conv_i8_cuda.conv_i8(x, k, deq, bias, inv, stride, dilation, pad).q
            ok = ok and torch.equal(q_alone, a.q)
    amax = int(acc.abs().max()) if acc.numel() else 0
    err = max(int((a.acc.long() - acc.long()).abs().max()),
              float((a.tap - tap32).abs().max())) if acc.numel() else 0
    if not ok:
        raise AssertionError(f"phase 16: conv_i8 kernel != plain on {what}")
    sat = "" if q is None else (f", s8 at 127: {float((q == 127).float().mean()):.4f}, "
                                f"at 0: {float((q == 0).float().mean()):.4f}")
    log(f"  conv_i8 == plain bit for bit ({'each output mode alone too, ' if modes else ''}"
        f"twice): {what}: x {tuple(x.shape)} k {tuple(k.shape)} stride {stride} dilation "
        f"{dilation} pad {pad}, max |acc| {amax}{sat}")
    return err


def check_i8_layer(layer, q8, what, modes=False) -> int:
    return check_i8(q8, layer.kq, layer.deq, layer.bias, layer.inv_next, layer.stride,
                    layer.dilation, layer.padding_for(q8), what, modes)


def check_quant(y, inv, what) -> int:
    """The quantize kernel against its plain version: identical int8, and a
    second run identical.  Returns max |kernel - plain|."""
    want = quantize_i8_cuda.quantize_i8_plain(y, inv)
    got = quantize_i8_cuda.quantize_i8(y, inv)
    again = quantize_i8_cuda.quantize_i8(y, inv)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(again, got)):
        raise AssertionError(f"quantize_i8 kernel != plain on {what}: "
                             f"{int((got != want).sum())} of {got.numel()} differ")
    log(f"  quantize_i8 == plain bit for bit (twice): {what}: y {tuple(y.shape)} {y.dtype}, "
        f"s8 at 127: {float((got == 127).float().mean()):.4f}, at 0: "
        f"{float((got == 0).float().mean()):.4f}")
    return int((got.int() - want.int()).abs().max())


def phase16(cfg, dev):
    """The int8 kernels against their plain versions on the card.  Returns
    the detector, the quantized detector and the bench images for phase 17,
    and the largest difference from plain of conv_i8 and of quantize_i8."""
    for src in (INT8_SOURCE, QUANT_SOURCE):
        for line in _cuda_build.ptxas_summary(src):
            log(f"  ptxas ({src}.cu): {line}")
    log("  conv_i8 kernel: 384 threads (a TMA producer warp's warpgroup, two wgmma consumer "
        "warpgroups); each launch's plan (tile, k-steps, ring, shared memory) is printed "
        "with its layer in phase 17")
    secs = _cuda_build.BUILDS[INT8_SOURCE].seconds
    size = cfg.model.image_size
    det = Detector.from_random(SEED, cfg, dev)
    rng = np.random.default_rng(SEED)
    images_u8 = torch.from_numpy(
        rng.integers(0, 255, (BATCH, size, size, 3), dtype=np.uint8)).to(dev)
    dt = compute_dtype(cfg.model)
    with torch.inference_mode():
        x = normalize_image(images_u8[:CALIB_IMAGES].float(), cfg.preprocess).to(dt)
    t0 = time.perf_counter()
    scales = calibrate_act_scales(det.model, [x], cfg.model)
    qdet = QuantizedDetector(det.model, scales).to(dev).eval()
    torch.cuda.synchronize()
    log(f"phase 16: csrc/conv_i8.cu " + (f"built in {secs:.3f} s" if secs is not None
                                         else "was already built")
        + f"; calibrated on {CALIB_IMAGES} bench images and quantized in "
        f"{time.perf_counter() - t0:.3f} s")
    try:
        pooled = torch.nn.functional.max_pool2d(
            torch.zeros((1, 8, 4, 4), dtype=torch.int8, device=dev), 2)
        log(f"  F.max_pool2d takes int8 on the card ({pooled.dtype}); quant.max_pool_i8 "
            "takes the max of four strided views all the same (one form for both devices)")
    except RuntimeError as e:
        log(f"  F.max_pool2d refuses int8 on the card ({str(e).splitlines()[0]}); "
            "quant.max_pool_i8 takes the max of four strided views")
    record, errs, q_errs = {}, [], []
    with torch.inference_mode():
        qdet.backbone(x[:2], record)
        for name, layer in i8_layers(qdet):
            errs.append(check_i8_layer(layer, record[name], f"{name} at batch 2, {size}x{size}"))
        errs.append(check_i8_layer(qdet.body["conv3_1"], record["conv3_1"][:1].contiguous(),
                                   "conv3_1 at batch 1"))
        # The fused relu + quantize on the conv1_1' output, in bf16 and float32.
        xn = x[:2].permute(0, 3, 1, 2)
        o1_pre = nhwc(torch.nn.functional.conv2d(torch.nn.functional.pad(xn, (1, 2, 1, 2)),
                                                 qdet.k1p.to(dt), qdet.b1.to(dt), stride=2))
        q_errs.append(check_quant(o1_pre, qdet.inv_conv1_2, "conv1_1' output at batch 2"))
        q_errs.append(check_quant(o1_pre.float(), qdet.inv_conv1_2,
                                  "conv1_1' output at batch 2, float32"))
        if not torch.equal(quantize_i8_cuda.quantize_i8(o1_pre, qdet.inv_conv1_2),
                           record["conv1_2"]):
            raise AssertionError("phase 16: the forward's conv1_2' input is not the quantize "
                                 "of the conv1_1' output")
        # An odd input: conv1 in the compute dtype, pool, quantize (no packed conv1_2').
        odd = {}
        qdet.backbone(x[:1, :37, :53], odd)
        if "conv1_2" in odd or odd["conv2_1"].shape != (1, 19, 27, 64):
            raise AssertionError(f"phase 16: the 37x53 input did not take the unpacked path: "
                                 f"{ {k: tuple(v.shape) for k, v in odd.items()} }")
        for name, layer in qdet.body.items():
            errs.append(check_i8_layer(layer, odd[name],
                                       f"{name} on the unpacked path of a 37x53 input"))
        pool1 = nhwc(max_pool(qdet.conv1_2(qdet.conv1_1(x[:1, :37, :53].permute(0, 3, 1, 2)))))
        q_errs.append(check_quant(pool1, qdet.inv_conv2_1, "pool1 of the 37x53 input"))
        # An all-zero input, and each output mode alone.
        errs.append(check_i8_layer(qdet.body["conv4_3"], torch.zeros_like(record["conv4_3"]),
                                   "conv4_3 on an all-zero input", modes=True))
        errs.append(check_i8_layer(qdet.body["conv4_3"], record["conv4_3"], "conv4_3",
                                   modes=True))
        # Saturation: x = 127 everywhere, k = +-127, so |acc| = 127 * 127 * 4608 inside.
        fc6 = qdet.body["fc6"]
        xs = torch.full_like(record["fc6"], 127)
        ks = torch.full_like(fc6.kq, 127)
        ks[1::2] = -127
        errs.append(check_i8(xs, ks, fc6.deq, fc6.bias, fc6.inv_next, 1, fc6.dilation,
                             fc6.padding_for(xs), "fc6 saturated (+-127)"))
        # A ragged M (63 pixels) and N, each output mode alone.  The kernel
        # takes Ci % 64 == 0 and Co % 64 == 0, so the ragged N is 64 channels
        # of a 128-channel tile.
        g = torch.Generator(device=dev).manual_seed(16)
        xr = torch.randint(-127, 128, (1, 7, 9, 64), generator=g, device=dev).to(torch.int8)
        kr = torch.randint(-127, 128, (64, 3, 3, 64), generator=g, device=dev).to(torch.int8)
        v = lambda lo, hi: torch.empty(64, device=dev).uniform_(lo, hi, generator=g)  # noqa: E731
        errs.append(check_i8(xr, kr, v(1e-4, 1e-3), v(-1, 1), v(1, 10), 1, 1, (1, 1, 1, 1),
                             "ragged M = 63 in a 128-pixel tile, N = 64 in a 128-channel tile",
                             modes=True))
        errs.append(check_i8_phase(qdet.conv12, record["conv1_2"],
                                   f"the packed conv1_2' + phase max at batch 2, {size}x{size}"))
        errs.append(check_i8_relaunch(qdet, record))
    check_i8_second_card(qdet, record)
    return det, qdet, images_u8, max(errs), max(q_errs)


def check_i8_phase(layer, q8, what) -> int:
    """The fused conv1_2' + phase max (one launch) against the plain conv,
    its epilogue and quant.phase_max_i8, bit for bit, twice; the plan must
    have left out the packed form's zero taps (9 k-steps a group)."""
    pad = layer.padding_for(q8)
    acc = conv_i8_plain(q8, layer.kq, 1, 1, pad)
    _, q_all = conv_i8_epilogue_plain(acc, layer.deq, layer.bias, layer.inv_next)
    want = phase_max_i8(q_all, q_all.shape[3] // 4)
    got = layer(q8)[1]
    plan = conv_i8_cuda.LAST_PLAN
    again = layer(q8)[1]
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(again, got)):
        raise AssertionError(f"phase 16: fused conv_i8 phase max != plain on {what}: "
                             f"{int((got != want).sum())} of {want.numel()} differ")
    if not (plan.phase_max and len(plan.steps) == 4 * 9):
        raise AssertionError(f"phase 16: the phase-max plan kept the zero taps: {plan.describe()}")
    log(f"  conv_i8 phase max == conv_i8_plain + epilogue + phase_max_i8 bit for bit (twice): "
        f"{what}: pool1 {tuple(got.shape)}; {plan.describe()}")
    return int((got.int() - want.int()).abs().max())


def check_i8_relaunch(qdet, record) -> int:
    """conv2_1, then conv4_3 (another plan: tile, slice, N tile and ring),
    then conv2_1 again: the third launch equals the first bit for bit, so
    nothing of one launch's plan or attribute stays behind for the next."""
    first = qdet.body["conv2_1"](record["conv2_1"])[1]
    plan1 = conv_i8_cuda.LAST_PLAN
    qdet.body["conv4_3"](record["conv4_3"], torch.bfloat16)
    plan2 = conv_i8_cuda.LAST_PLAN
    third = qdet.body["conv2_1"](record["conv2_1"])[1]
    torch.cuda.synchronize()
    if plan1 == plan2 or conv_i8_cuda.LAST_PLAN != plan1 or not torch.equal(first, third):
        raise AssertionError("phase 16: conv2_1 launched after conv4_3's plan differs from "
                             "its first launch")
    log(f"  conv2_1 ({plan1.describe()}) after conv4_3 ({plan2.describe()}): bit-identical "
        "to its first launch")
    return 0


def check_i8_second_card(qdet, record) -> None:
    """The kernel's shared-memory attribute belongs to a device: a layer on
    cuda:1 after cuda:0 must launch and agree bit for bit."""
    if torch.cuda.device_count() < 2:
        log(f"  second-card check not run: this host has {torch.cuda.device_count()} CUDA "
            "device (the attribute is set on every launch, so a second card cannot find it "
            "unset)")
        return
    layer = qdet.body["conv3_2"]
    q8 = record["conv3_2"]
    want = layer(q8)[1]
    dev1 = torch.device("cuda", 1)
    got = conv_i8_cuda.conv_i8(q8.to(dev1), layer.kq.to(dev1), layer.deq.to(dev1),
                               layer.bias.to(dev1), layer.inv_next.to(dev1), 1, 1,
                               layer.padding_for(q8)).q
    torch.cuda.synchronize(dev1)
    if not torch.equal(got.to(want.device), want):
        raise AssertionError("phase 16: conv_i8 on cuda:1 != cuda:0")
    log("  conv3_2 on cuda:1 after cuda:0: launched and bit-identical")


def im2col_i8(q8, kh, kw, stride, dilation, pad):
    """(B, H, W, Ci) int8 -> the (B*Ho*Wo, kh*kw*Ci) int8 im2col, taps in
    the kernel's (ky, kx, ci) order."""
    pt, pb, pl, pr = pad
    xp = torch.nn.functional.pad(q8, (0, 0, pl, pr, pt, pb))
    ho = out_size(q8.shape[1], kh, stride, dilation, pt, pb)
    wo = out_size(q8.shape[2], kw, stride, dilation, pl, pr)
    cols = [xp[:, ky * dilation: ky * dilation + (ho - 1) * stride + 1: stride,
               kx * dilation: kx * dilation + (wo - 1) * stride + 1: stride]
            for ky in range(kh) for kx in range(kw)]
    return torch.cat(cols, dim=-1).reshape(-1, kh * kw * q8.shape[3])


def time_i8_layer(name, layer, q8, tap_dtype, smi, packed=False):
    """One layer of the int8 forward at the bench shape: the kernel with the
    forward's outputs, held bit for bit against the plain version (batch
    chunks of 16) over the whole batch, its bound, torch._int_mm over the
    layer's im2col (chunks of 2^22 rows, the yardstick; the port never
    calls it) and cuDNN's bf16 conv of the same shape.  `packed`: the layer is the packed 2x2 conv1_2', launched as the
    forward launches it, with the phase max (its output is pool1, held
    against the plain conv + epilogue + phase_max_i8); its bound counts the
    work of the 3x3 conv it computes (9 of its 16 taps a phase are zero by
    construction, and the plan leaves them out); the yardsticks compute the
    conv alone."""
    _, kh, kw, ci = layer.kq.shape
    co = layer.kq.shape[0]
    pad = layer.padding_for(q8)
    inv = layer.inv_next
    run = lambda: conv_i8_cuda.conv_i8(q8, layer.kq, layer.deq, layer.bias, inv,  # noqa: E731
                                       layer.stride, layer.dilation, pad, tap_dtype,
                                       phase_max=packed)
    out = run()
    plan = conv_i8_cuda.LAST_PLAN
    out_shape = tuple((out.q if out.q is not None else out.tap).shape)
    torch.cuda.synchronize()
    ms = cuda_ms(run, 5)
    b = q8.shape[0]
    ho = out_size(q8.shape[1], kh, layer.stride, layer.dilation, pad[0], pad[1])
    wo = out_size(q8.shape[2], kw, layer.stride, layer.dilation, pad[2], pad[3])
    m, kdim = b * ho * wo, kh * kw * ci
    dense_ops = 2 * m * co * kdim
    # conv1_2' at (2H, 2W): a 3x3 conv of Ci/4 -> Co/4 channels.
    ops = 2 * b * 4 * q8.shape[1] * q8.shape[2] * (co // 4) * 9 * (ci // 4) if packed else dense_ops
    out_bytes = sum(t.numel() * t.element_size() for t in (out.tap, out.q) if t is not None)
    bnd = bound(q8.numel() + layer.kq.numel() + 12 * co + out_bytes, ops, PEAK_INT8)

    def plain(i):
        acc = conv_i8_plain(q8[i:i + 16], layer.kq, layer.stride, layer.dilation, pad)
        tap, q = conv_i8_epilogue_plain(acc, layer.deq, layer.bias, inv, tap_dtype)
        return (tap, phase_max_i8(q, co // 4)) if packed else (tap, q)

    err = 0.0
    for i in range(0, b, 16):
        tap, q = plain(i)
        if not ((tap is None or same_bits(out.tap[i:i + 16], tap))
                and (q is None or same_bits(out.q[i:i + 16], q))):
            raise AssertionError(f"phase 17: conv_i8 != plain on {name} at batch {b}, images "
                                 f"{i}..{min(i + 16, b) - 1}")
        if tap is not None:
            err = max(err, float((out.tap[i:i + 16].float() - tap.float()).abs().max()))
        if q is not None:
            err = max(err, float((out.q[i:i + 16].int() - q.int()).abs().max()))
    del tap, q
    a = im2col_i8(q8, kh, kw, layer.stride, layer.dilation, pad)
    bmat = layer.kq.reshape(co, kdim).t()
    rows = 2**22
    nb = min(b, -(-rows // (ho * wo)))
    acc0 = conv_i8_cuda.conv_i8(q8[:nb], layer.kq, layer.deq, layer.bias, None, layer.stride,
                                layer.dilation, pad, with_acc=True).acc.reshape(-1, co)[:rows]
    chunk0 = torch._int_mm(a[:acc0.shape[0]], bmat)
    if not torch.equal(chunk0, acc0):
        raise AssertionError(f"phase 17: torch._int_mm on the im2col of {name} != the "
                             "kernel's s32 sum")
    del chunk0, acc0
    lib_ms = cuda_ms(lambda: [torch._int_mm(a[i:i + rows], bmat) for i in range(0, m, rows)], 3)
    del a
    xb = torch.nn.functional.pad(q8.permute(0, 3, 1, 2).to(torch.bfloat16),
                                 (pad[2], pad[3], pad[0], pad[1]))
    xb = xb.contiguous(memory_format=torch.channels_last)
    wb = layer.kq.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    conv = lambda: torch.nn.functional.conv2d(xb, wb, stride=layer.stride,  # noqa: E731
                                              dilation=layer.dilation)
    conv()
    cudnn_ms = cuda_ms(conv, 5)
    del xb, out
    work = (f"{ops / 1e12:.3f} T operations of the 3x3 conv it computes ({dense_ops / 1e12:.3f} T "
            f"counting the packed form's zero taps, bound {dense_ops / PEAK_INT8 * 1e3:.4f} ms), "
            f"with the phase max: pool1 {out_shape}"
            if packed else f"{ops / 1e12:.3f} T operations")
    log(f"  {name}: ({b}, {q8.shape[1]}, {q8.shape[2]}, {ci}) -> ({ho}, {wo}, {co}), K {kdim}: "
        f"== plain bit for bit over all {b} images; kernel {ms:.4f} ms = "
        f"{ops / ms / 1e9:.1f} TOPS of {work}, bound {bnd[0]:.4f} ms ({bnd[1]}), "
        f"{bnd[0] / ms:.0%} of it; torch._int_mm {lib_ms:.4f} ms, "
        f"cuDNN bf16 {cudnn_ms:.4f} ms ({smi})")
    log(f"    plan: {plan.describe()}")
    return {"ms": ms, "bound": bnd, "library": lib_ms, "cudnn": cudnn_ms, "ops": ops,
            "err": err}


def phase17(cfg, dev, smi, det, qdet, images_u8):
    """The int8 bench path at batch 128 beside the bf16 one, counted; each
    int8 kernel at the bench shapes held against its plain version and
    timed beside its bound and the library calls of its shape."""
    post, size = cfg.postprocess, cfg.model.image_size
    anchors = det.anchors
    nms_paths = []

    def step(model):
        with torch.inference_mode():
            x = normalize_image(images_u8.float(), cfg.preprocess)
            cls, loc = model(x)
            out = postprocess_batch(cls, loc, anchors, cfg.anchors, post,
                                    float(size), float(size))
            nms_paths.append(nms_cuda.LAST_PATHS)
            return out, cls, loc

    step(qdet)
    step(det.model)
    torch.cuda.synchronize()
    iters = 2
    # The main path, counted: every count set to 0 just before, read just after.
    conv_i8_cuda.LAUNCHES = 0
    quantize_i8_cuda.LAUNCHES = 0
    nms_cuda.LAUNCHES = 0
    nms_paths.clear()
    for _ in range(iters):
        out_q, cls_q, loc_q = step(qdet)
    torch.cuda.synchronize()
    launches = {"conv_i8": conv_i8_cuda.LAUNCHES, "quantize_i8": quantize_i8_cuda.LAUNCHES,
                "nms": nms_cuda.LAUNCHES}
    rows = torch.cat(nms_paths)
    if launches != {"conv_i8": I8_PER_FORWARD * iters, "quantize_i8": iters, "nms": iters}:
        raise AssertionError(f"phase 17: launches in {iters} int8 bench steps {launches}, "
                             f"expected {I8_PER_FORWARD} conv_i8, 1 quantize_i8 and 1 NMS a step")
    if not bool(rows.all()):
        raise AssertionError(f"phase 17: {int((rows == 0).sum())} of {rows.numel()} NMS rows "
                             "of the int8 bench steps took the argmax loop")
    out_f, cls_f, loc_f = step(det.model)
    torch.cuda.synchronize()
    for out in (out_q, out_f):
        if not (torch.isfinite(out["bboxes"]).all() and torch.isfinite(out["scores"]).all()):
            raise AssertionError("phase 17: non-finite bench-path output")
    if not (torch.isfinite(cls_q).all() and torch.isfinite(loc_q).all()):
        raise AssertionError("phase 17: non-finite int8 logits")
    e_cls, e_loc = rel_l2(cls_q, cls_f), rel_l2(loc_q, loc_f)
    n_q, n_f = out_q["valid"].sum(dim=1), out_f["valid"].sum(dim=1)
    log(f"phase 17: int8 bench path batch {BATCH} at {size}x{size}: launches in {iters} int8 "
        f"steps: conv_i8 {launches['conv_i8']}, quantize_i8 {launches['quantize_i8']}, NMS "
        f"{launches['nms']}, all {rows.numel()} NMS "
        f"rows on the tile scan; int8 logits vs bf16 rel L2 cls {e_cls:.4e} loc {e_loc:.4e}; "
        f"valid detections an image int8 {int(n_q.min())}..{int(n_q.max())}, bf16 "
        f"{int(n_f.min())}..{int(n_f.max())}")
    del out_q, out_f, cls_q, loc_q, cls_f, loc_f
    time_user_int8(det, images_u8, smi)
    with torch.inference_mode():
        x = normalize_image(images_u8.float(), cfg.preprocess)
        # The fused relu + quantize at the bench shape.
        dt = compute_dtype(cfg.model)
        xn = x.to(dt).permute(0, 3, 1, 2)
        o1_pre = nhwc(torch.nn.functional.conv2d(torch.nn.functional.pad(xn, (1, 2, 1, 2)),
                                                 qdet.k1p.to(dt), qdet.b1.to(dt), stride=2))
        inv = qdet.inv_conv1_2
        q_err = check_quant(o1_pre, inv, f"conv1_1' output at batch {BATCH}, {size}x{size}")
        q_ms = cuda_ms(lambda: quantize_i8_cuda.quantize_i8(o1_pre, inv), 20)
        qb = bound(o1_pre.numel() * (o1_pre.element_size() + 1) + inv.numel() * 4,
                   2 * o1_pre.numel(), PEAK_F32)
        log(f"phase 17: quantize_i8 at {tuple(o1_pre.shape)} {o1_pre.dtype}: kernel "
            f"{q_ms:.4f} ms, bound {qb[0]:.4f} ms ({qb[1]}) ({smi})")
        del o1_pre, xn
    # Each layer at the bench shape, on its own inputs from one int8 forward.
    record = {}
    with torch.inference_mode():
        qdet.backbone(x, record)
        del x
        dt = compute_dtype(cfg.model)
        taps = {name for name, _, _, is_tap, _ in qdet.plan if is_tap}
        log(f"phase 17: the {I8_PER_FORWARD} int8 convolutions at batch {BATCH}, {size}x{size}:")
        layers = {name: time_i8_layer(name, layer, record.pop(name),
                                      dt if name in taps else None, smi,
                                      packed=name == "conv1_2")
                  for name, layer in i8_layers(qdet)}
    tot = {k: sum(v[k] for v in layers.values()) for k in ("ms", "cudnn", "ops", "library")}
    tot["err"] = max(v["err"] for v in layers.values())
    by_ops = sum(v["bound"][0] for v in layers.values() if v["bound"][1] == "operations")
    tot["bound"] = sum(v["bound"][0] for v in layers.values())
    tot["bound_by"] = "operations" if by_ops >= tot["bound"] / 2 else "bytes"
    log(f"  sum of the {I8_PER_FORWARD}: kernel {tot['ms']:.3f} ms "
        f"({tot['ops'] / tot['ms'] / 1e9:.1f} TOPS for {tot['ops'] / 1e12:.2f} T operations), "
        f"bound {tot['bound']:.3f} ms ({tot['bound_by']}), "
        f"torch._int_mm {tot['library']:.3f} ms, cuDNN bf16 {tot['cudnn']:.3f} ms ({smi})")
    slower = [n for n, v in layers.items() if v["ms"] > v["library"]]
    log(f"  layers where the kernel is slower than torch._int_mm on the im2col: "
        f"{', '.join(slower) if slower else 'none'}")
    return {"launches": launches["conv_i8"], "iters": iters,
            "quant": {"launches": launches["quantize_i8"], "ms": q_ms, "bound": qb,
                      "err": q_err}, **tot}


def time_user_int8(det, images_u8, smi):
    """The int8 path as serving callers reach it (no cell measures it):
    Detector.quantize_int8 (which builds its QuantizedDetector in inference
    mode) on the calibration images, then detect_batch of the bench batch
    and detect() of one image on the host's clock, int8 beside bf16."""
    imgs = list(images_u8.cpu().numpy())
    t0 = time.perf_counter()
    det.quantize_int8(imgs[:CALIB_IMAGES], batch_size=CALIB_IMAGES)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    out = {}
    for mode in ("int8", "bf16"):
        det.detect_batch(imgs)
        det.detect(imgs[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            det.detect_batch(imgs)
        batch_ms = (time.perf_counter() - t0) / 3 * 1e3
        lat = []
        for _ in range(10):
            t0 = time.perf_counter()
            det.detect(imgs[0])
            lat.append((time.perf_counter() - t0) * 1e3)
        out[mode] = (batch_ms, float(np.median(lat)), min(lat))
        det.dequantize()
    log(f"  Detector.quantize_int8 on {CALIB_IMAGES} calibration images: {quant_s:.3f} s "
        f"(host clock) ({smi})")
    for mode, (batch_ms, med, lo) in out.items():
        log(f"  {mode}: detect_batch of the {BATCH} bench images {batch_ms:.3f} ms = "
            f"{BATCH / batch_ms * 1e3:.1f} img/s; detect() of one {images_u8.shape[1]}x"
            f"{images_u8.shape[2]} image median {med:.3f} ms, min {lo:.3f} ms (host clock, "
            f"3 and 10 calls)")


def plain_conv_i8(x, k, deq, bias, inv_next=None, stride=1, dilation=1, padding=(0, 0, 0, 0),
                  tap_dtype=None, with_acc=False, phase_max=False):
    """conv_i8's plain version on the card (quant.py's conv, swapped in)."""
    acc = conv_i8_plain(x, k, stride, dilation, padding)
    tap, q = conv_i8_epilogue_plain(acc, deq, bias, inv_next, tap_dtype)
    if phase_max:
        q = phase_max_i8(q, k.shape[0] // 4)
    return conv_i8_cuda.ConvI8Out(tap, q, acc if with_acc else None)


def device_split(fn):
    """Device ms of one call of fn() (torch.profiler, after a warm call), by
    CUDA kernel and by the aten op that launched it -> ({kernel: ms}, {op: ms})."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = {"CUDA": {}, "CPU": {}}
    for e in prof.key_averages():
        if e.self_device_time_total > 0 and e.device_type.name in by:
            d = by[e.device_type.name]
            d[e.key] = d.get(e.key, 0.0) + e.self_device_time_total / 1e3
    return by["CUDA"], by["CPU"]


def time_deterministic(dev, smi):
    """The train step's cost of smoke_e2e's deterministic mode, and of its
    parts: ms a step at batch 8 (smoke_e2e's) and 32 by default (the LFPN
    upsample's gradient by csrc/upsample2x_bwd.cu); with
    torch.backends.cudnn.deterministic on; under deterministic(); and under
    it with PyTorch's fill of new tensors on (the mode's default).  Each is
    timed twice, in the order given and then in reverse.  At batch 32, the
    kernels and the aten ops whose device time the mode adds over the
    default with cuDNN deterministic (torch.profiler, one step each)."""
    @contextlib.contextmanager
    def cudnn_deterministic():
        prev = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            yield
        finally:
            torch.backends.cudnn.deterministic = prev

    @contextlib.contextmanager
    def with_fill():
        with smoke_e2e.deterministic():
            torch.utils.deterministic.fill_uninitialized_memory = True
            yield

    modes = {"default (kernel)": contextlib.nullcontext,
             "kernel + cudnn.deterministic": cudnn_deterministic,
             "deterministic()": smoke_e2e.deterministic, "with the fill": with_fill}
    out, split = {}, {}
    for batch in (8, TRAIN_BATCH):
        cfg = train_config(default_config())
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=batch))
        batches = [synthetic_batch(cfg, batch, seed=500 + i) for i in range(8)]

        def steps(profile=False):
            state = create_train_state(cfg, SEED, dev)
            for b in batches[:2]:
                train_step(state, b)
            torch.cuda.synchronize()
            if profile:
                return device_split(lambda: train_step(state, batches[2]))
            return cuda_ms(lambda: [train_step(state, b) for b in batches[2:]], 1) / 6

        t = out[batch] = {name: [] for name in modes}
        for name in list(modes) + list(modes)[::-1]:
            with modes[name]():
                t[name].append(steps())
        if batch == TRAIN_BATCH:
            for name in ("kernel + cudnn.deterministic", "deterministic()"):
                with modes[name]():
                    split[name] = steps(profile=True)
    log("phase 18: train step ms (CUDA events, mean of 6 after 2; each timed twice, in this order "
        "and back) " + " / ".join(modes) + ": " + "; ".join(
            f"batch {b}: " + " / ".join(f"{v[0]:.3f}, {v[1]:.3f}" for v in t.values())
            for b, t in out.items()) + f" ({smi})")
    narrow, mode = split["kernel + cudnn.deterministic"], split["deterministic()"]
    for i, what in enumerate(("kernels", "aten ops")):
        diff = sorted(((mode[i].get(k, 0.0) - narrow[i].get(k, 0.0), k)
                       for k in set(mode[i]) | set(narrow[i])), reverse=True)
        log(f"  batch {TRAIN_BATCH}, one step's device time (profiler): kernel + cudnn."
            f"deterministic {sum(narrow[i].values()):.3f} ms, deterministic() "
            f"{sum(mode[i].values()):.3f} ms; the {what} the mode adds most to: "
            + "; ".join(f"{k[:90]} {d:+.3f} ms" for d, k in diff[:6]))
    return out


def phase18(dev, smi):
    """scripts/smoke_e2e.py's recipe through the port's tool, with --int8,
    and the trained model's NMS and vote load."""
    runs = []
    for i in range(2):
        t0 = time.perf_counter()
        run = smoke_e2e.run(smoke_e2e.parse_args(["--int8"]))
        rc = smoke_e2e.gates(run)
        aps = run["aps"]
        base, q = aps["bfloat16"], aps["int8"]
        log(f"phase 18: smoke_e2e run {i + 1} (300 steps at batch 8, 640x640, bf16, --int8, "
            f"deterministic mode) rc {rc} in {time.perf_counter() - t0:.1f} s; train "
            f"{run['train_img_s']:.1f} img/s (host clock, with the host's synthetic batches) "
            f"({smi})")
        log(f"  AP on 24 held-out images: bf16 easy {base['easy']!r} medium {base['medium']!r} "
            f"hard {base['hard']!r}; int8 easy {q['easy']!r} medium {q['medium']!r} hard "
            f"{q['hard']!r}; int8 - bf16 hard {q['hard'] - base['hard']:+.4f} (gates: hard >= "
            f"{smoke_e2e.MIN_HARD_AP}, int8 >= bf16 - {smoke_e2e.MAX_INT8_DROP})")
        runs.append(run)
    # The two runs must train the same model: every parameter and every AP
    # identical (smoke_e2e runs under torch.use_deterministic_algorithms).
    weights = [r["detector"].model.state_dict() for r in runs]
    differ = [k for k in weights[0] if not torch.equal(weights[0][k], weights[1][k])]
    if differ or runs[0]["aps"] != runs[1]["aps"] or runs[0]["loss"] != runs[1]["loss"]:
        raise AssertionError(f"phase 18: two smoke_e2e runs trained different models: "
                             f"{len(differ)} of {len(weights[0])} tensors differ "
                             f"({differ[:4]}), APs {runs[0]['aps']} and {runs[1]['aps']}")
    log(f"  runs 1 and 2: all {len(weights[0])} parameter tensors, the last loss "
        f"({runs[0]['loss']!r}) and every AP identical")
    time_deterministic(dev, smi)
    run = runs[0]
    aps = run["aps"]
    base, q = aps["bfloat16"], aps["int8"]
    del runs, weights
    det = run["detector"]
    items = run["eval_set"]
    # The trained model's int8 detections through the kernel against the same
    # forward with the plain conv (f64 im2col + epilogue + phase_max_i8) in
    # its place: identical on every held-out image, so the int8 AP above is
    # the int8 model's, whatever kernel computes it.
    kern = [det.detect(img, score_threshold=0.05) for _, img in items]
    real_conv = quant.conv_i8
    quant.conv_i8 = plain_conv_i8
    try:
        ref = [det.detect(img, score_threshold=0.05) for _, img in items]
    finally:
        quant.conv_i8 = real_conv
    if not all(np.array_equal(a["bboxes"], b["bboxes"]) and np.array_equal(a["scores"], b["scores"])
               for a, b in zip(kern, ref)):
        raise AssertionError("phase 18: the trained model's int8 detections differ between the "
                             "kernel and the plain conv")
    log(f"  the trained model's int8 detections (score >= 0.05) through conv_i8 == through the "
        f"plain conv on all {len(items)} held-out images")
    load = {}
    for mode in ("int8", "bf16"):
        kept, tiles = [], []
        for _, img in items:
            kept.append(len(det.detect(img)["scores"]))
            tiles.append(int(nms_cuda.LAST_TILES.max()))
        load[mode] = (kept, tiles)
        det.dequantize()
    for mode, (kept, tiles) in load.items():
        log(f"  trained model's NMS load ({mode}, detect() at B = 1, no score threshold): kept "
            f"boxes an image {min(kept)}..{max(kept)} (mean {np.mean(kept):.1f}), tiles a row "
            f"{min(tiles)}..{max(tiles)}")
    det.warmup_tta([im.shape[:2] for _, im in items], 16, 128)
    t0 = time.perf_counter()
    res = det.detect_tta_dataset(items, 16, 128)
    torch.cuda.synchronize()
    tta_s = time.perf_counter() - t0
    vote_tiles = bbox_vote_cuda.LAST_TILES
    preds = {k: np.concatenate([v["bboxes"], v["scores"][:, None]], axis=-1).astype(np.float64)
             for k, v in res.items()}
    tta_aps = evaluate_widerface(preds, run["gts"])
    log(f"  TTA (detect_tta_dataset, bf16) on the same images, printed, not gated: easy "
        f"{tta_aps['easy']:.4f} medium {tta_aps['medium']:.4f} hard {tta_aps['hard']:.4f} in "
        f"{tta_s:.3f} s; kept boxes an image {min(len(v['scores']) for v in res.values())}.."
        f"{max(len(v['scores']) for v in res.values())}; the last vote launch's tiles a row "
        f"{int(vote_tiles.min())}..{int(vote_tiles.max())}")
    if rc != 0 or not (base["hard"] >= smoke_e2e.MIN_HARD_AP
                       and q["hard"] >= base["hard"] - smoke_e2e.MAX_INT8_DROP):
        raise AssertionError(f"phase 18: smoke_e2e failed the reference's gates (rc {rc}): "
                             f"bf16 hard {base['hard']:.4f}, int8 hard {q['hard']:.4f}")
    return {"aps": aps, "tta_aps": tta_aps}


# ---------------------------------------------------------------------------
# checkpoint loading: phase 19
# ---------------------------------------------------------------------------

# VGG-16 classifier layers (slim names vgg_16/convN/convN_M): the 13 convs.
VGG_CONVS = tuple(f"conv{b}_{i}" for b, n in ((1, 2), (2, 2), (3, 3), (4, 3), (5, 3))
                  for i in range(1, n + 1))
CKPT_REQUESTS = ((480, 640), (720, 1280), (300, 200))
CKPT_BATCH = ((640, 640), (500, 375), (1024, 768), (100, 160))


def same_detections(a, b) -> bool:
    return all(np.array_equal(x["bboxes"], y["bboxes"]) and np.array_equal(x["scores"], y["scores"])
               for x, y in zip(a, b))


def phase19a(cfg, dev, smi, d):
    """Write a seeded full-width detector as a TF bundle, an .npz and (through
    the convert CLI) a .pt; load each with Detector.from_checkpoint and serve
    from it.  Returns (the bundle's prefix, the source weights on the CPU,
    the K2 and K1 launches of the loaded detectors' detect / detect_batch)."""
    src = Detector.from_random(SEED + 19, cfg, dev)
    sd = src.model.state_dict()
    tree = params_to_jax(sd)
    n_bytes = sum(v.numel() * v.element_size() for v in sd.values())
    prefix = os.path.join(d, "dan.ckpt")
    t0 = time.perf_counter()
    export_tf_checkpoint(tree, prefix)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_params(prefix, cfg, verbose=False)
    read_s = time.perf_counter() - t0
    data = np.fromfile(shard_path(prefix, 0, 1), dtype=np.uint8)
    t0 = time.perf_counter()
    crc32c(data)
    crc_s = time.perf_counter() - t0
    log(f"phase 19: TF bundle of the default config's detector ({len(sd)} tensors, "
        f"{n_bytes / 1e6:.1f} MB; data file {data.size / 1e6:.1f} MB): write {write_s:.3f} s, "
        f"read + CRC check + import {read_s:.3f} s; CRC-32C alone {crc_s:.3f} s = "
        f"{data.size / crc_s / 1e9:.3f} GB/s (host numbers of the card's host, numpy, one "
        f"thread) ({smi})")
    del data
    if sorted(loaded) != sorted(sd) or not all(torch.equal(loaded[k], sd[k].cpu()) for k in sd):
        raise AssertionError("phase 19: the TF bundle's tensors differ from the source's")
    npz = os.path.join(d, "dan.npz")
    save_npz(tree, npz)
    pt = os.path.join(d, "dan.pt")
    rc = ckpt_convert.main(["--tf_ckpt", prefix, "--out", pt, "--strict"])
    if rc != 0:
        raise AssertionError(f"phase 19: the convert CLI exited {rc}")
    del tree, loaded
    req = [np.random.default_rng(SEED + 190 + i).integers(0, 255, hw + (3,), dtype=np.uint8)
           for i, hw in enumerate(CKPT_REQUESTS)]
    batch = [np.random.default_rng(SEED + 195 + i).integers(0, 255, hw + (3,), dtype=np.uint8)
             for i, hw in enumerate(CKPT_BATCH)]
    want_one = [src.detect(im) for im in req]
    want_batch = src.detect_batch(batch)
    check_dets(want_one, req, cfg.postprocess.max_detections)
    dets = {}
    for fmt, path in (("TF bundle", prefix), ("npz", npz), ("pt (convert CLI)", pt)):
        t0 = time.perf_counter()
        dets[fmt] = Detector.from_checkpoint(path, cfg, dev)
        secs = time.perf_counter() - t0
        got = dets[fmt].model.state_dict()
        bad = [k for k in sd if not torch.equal(got[k], sd[k])]
        if bad or sorted(got) != sorted(sd):
            raise AssertionError(f"phase 19: {fmt}: {len(bad)} tensors differ from the "
                                 f"source ({bad[:4]})")
        log(f"  {fmt} {os.path.basename(path)}: Detector.from_checkpoint {secs:.3f} s (host "
            f"clock, to the card); all {len(sd)} tensors bit-identical to the source")
    # The main path, counted: every count set to 0 just before, read just after.
    nms_cuda.LAUNCHES = 0
    rows = []
    got_one = {}
    for fmt, det in dets.items():
        got_one[fmt] = []
        for im in req:
            got_one[fmt].append(det.detect(im))
            rows.append(nms_cuda.LAST_PATHS)
    k2 = nms_cuda.LAUNCHES
    got_batch = {}
    for fmt, det in dets.items():
        got_batch[fmt] = det.detect_batch(batch)
        rows.append(nms_cuda.LAST_PATHS)
    k1 = nms_cuda.LAUNCHES - k2
    rows = torch.cat(rows)
    for fmt in dets:
        if not (same_detections(got_one[fmt], want_one)
                and same_detections(got_batch[fmt], want_batch)):
            raise AssertionError(f"phase 19: detections of the {fmt} detector differ from the "
                                 "source detector's")
    if k1 == 0 or k2 == 0 or not bool(rows.all()):
        raise AssertionError(f"phase 19: NMS launches {k2} at B = 1 and {k1} batched, "
                             f"{int((rows == 0).sum())} rows off the tile scan")
    log(f"  detect() on {[im.shape[:2] for im in req]} and detect_batch() of 4 from each: boxes "
        f"and scores bit-identical to the source detector's "
        f"({[len(x['scores']) for x in want_one]} and "
        f"{[len(x['scores']) for x in want_batch]} detections); NMS launches {k2} at B = 1 "
        f"(K2), {k1} batched (K1); all {rows.numel()} rows on the tile scan")
    sd_cpu = {k: v.cpu() for k, v in sd.items()}
    del src, dets, sd
    torch.cuda.empty_cache()
    return prefix, sd_cpu, {"nms_one": k2, "nms_batched": k1}


def phase19b(cfg, d):
    """A VGG-16 classifier-shaped bundle from the port's writer (13 convs,
    fc6 (25088, 4096) and fc7 (4096, 4096) dense, global_step int64, one
    momentum slot): a non-strict import places the 30 backbone leaves, fc6
    and fc7 subsampled; the rest is reported missing; strict raises."""
    model_tree = params_to_jax(DANDetector(cfg.model).state_dict())
    rng = np.random.default_rng(SEED + 191)
    tensors = {}
    for name in VGG_CONVS:
        kernel = model_tree["backbone"][name]["kernel"]
        tensors[f"vgg_16/conv{name[4]}/{name}/weights"] = rng.standard_normal(
            kernel.shape, dtype=np.float32)
        tensors[f"vgg_16/conv{name[4]}/{name}/biases"] = rng.standard_normal(
            kernel.shape[-1:], dtype=np.float32)
    fc6 = rng.standard_normal((25088, 4096), dtype=np.float32)
    fc7 = rng.standard_normal((4096, 4096), dtype=np.float32)
    b6, b7 = (rng.standard_normal(4096, dtype=np.float32) for _ in range(2))
    tensors.update({"vgg_16/fc6/weights": fc6, "vgg_16/fc6/biases": b6,
                    "vgg_16/fc7/weights": fc7, "vgg_16/fc7/biases": b7,
                    "global_step": np.int64(1_000_000),
                    "vgg_16/conv1/conv1_1/weights/Momentum":
                        np.zeros_like(tensors["vgg_16/conv1/conv1_1/weights"])})
    prefix = os.path.join(d, "vgg_16.ckpt")
    t0 = time.perf_counter()
    write_bundle(prefix, tensors)
    write_s = time.perf_counter() - t0
    size = os.path.getsize(shard_path(prefix, 0, 1))
    t0 = time.perf_counter()
    rep = import_tf_checkpoint(prefix, cfg.model)
    read_s = time.perf_counter() - t0
    want = {("backbone", n, leaf) for n in VGG_CONVS + ("fc6", "fc7") for leaf in ("kernel", "bias")}
    everything = {f"{g}/{n}/{leaf}" for g, layers in model_tree.items()
                  for n, leaves in layers.items() for leaf in leaves}
    left = everything - {"/".join(t) for t in want}
    if rep.placed != want or rep.unmapped or rep.mismatched or set(rep.missing) != left:
        raise AssertionError(f"phase 19: classifier import placed {len(rep.placed)}, unmapped "
                             f"{rep.unmapped}, mismatched {rep.mismatched}, missing "
                             f"{len(rep.missing)}")
    kinds = sorted({m.split("/")[0] if m.startswith(("heads", "lfpn", "l2norm"))
                    else m.split("/")[1] for m in rep.missing})
    if not all(k in ("heads", "lfpn", "l2norm") or k.startswith(("conv6_", "conv7_"))
               for k in kinds):
        raise AssertionError(f"phase 19: missing leaves outside heads/LFPN/L2Norm/conv6-7: {kinds}")
    bb = rep.params["backbone"]
    expect = {
        "fc6/kernel": fc6.reshape(7, 7, 512, 4096)[np.ix_([0, 3, 6], [0, 3, 6], np.arange(512),
                                                          np.arange(0, 4096, 4))],
        "fc6/bias": b6[::4], "fc7/kernel": fc7[::4, ::4][None, None], "fc7/bias": b7[::4]}
    for key, value in expect.items():
        layer, leaf = key.split("/")
        if not np.array_equal(bb[layer][leaf], value):
            raise AssertionError(f"phase 19: {key} is not the [::4] subsample of the classifier's")
    for name in VGG_CONVS:
        if not np.array_equal(bb[name]["kernel"], tensors[f"vgg_16/conv{name[4]}/{name}/weights"]):
            raise AssertionError(f"phase 19: {name} was not placed as written")
    try:
        load_tf_checkpoint(prefix, cfg.model, strict=True, verbose=False)
    except ValueError as e:
        strict_msg = str(e)
    else:
        raise AssertionError("phase 19: a strict import of the classifier bundle did not raise")
    log(f"phase 19: VGG-16 classifier bundle ({len(tensors)} tensors, {size / 1e6:.1f} MB; write "
        f"{write_s:.3f} s, read + import {read_s:.3f} s, host clock): placed exactly the "
        f"{len(rep.placed)} backbone leaves (fc6 {tuple(bb['fc6']['kernel'].shape)} and fc7 "
        f"{tuple(bb['fc7']['kernel'].shape)} the [::4] subsample), {len(rep.missing)} left at "
        f"init ({', '.join(kinds)}), global_step and the Momentum slot skipped; strict: "
        f"\"{strict_msg}\"")
    for f in os.listdir(d):
        if f.startswith("vgg_16.ckpt"):
            os.remove(os.path.join(d, f))


def phase19c(prefix, sd_cpu, dev, d):
    """The train CLI warm-started from the bundle: 2 steps at batch 32, the
    first loss against train_step on the source weights; then --resume."""
    model_dir = os.path.join(d, "warm")
    # The source weights are random, which the reference recipe (no warm-up,
    # no clip: what --warm_start keeps) does not train from: its loss grows
    # by orders of magnitude a step.  So the runs take the synthetic recipe
    # explicitly.
    args = ["--synthetic", "--warm_start", prefix, "--steps", "2", "--batch_size",
            str(TRAIN_BATCH), "--model_dir", model_dir, "--log_every", "1",
            "--checkpoint_every", "1", "--warmup_steps", "50", "--grad_clip", "10"]
    bare = train_cli.make_config(train_cli.parse_args(
        ["--synthetic", "--warm_start", prefix, "--model_dir", model_dir]))
    if (bare.train.warmup_steps, bare.train.grad_clip_norm) != (0, 0.0):
        raise AssertionError("phase 19: --warm_start took the random-init recipe's defaults")
    # The main path, counted: every count set to 0 just before, read just after.
    for mod, _, _ in TRAIN_KERNELS.values():
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    rc = train_cli.main(args)
    secs = time.perf_counter() - t0
    launches = {name: mod.LAUNCHES for name, (mod, _, _) in TRAIN_KERNELS.items()}
    with open(os.path.join(model_dir, "train_metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    cfg = train_cli.make_config(train_cli.parse_args(args))
    state = create_train_state(cfg, 0, dev)
    state.model.load_state_dict(sd_cpu)
    ref = float(train_step(state, synthetic_batch(cfg, TRAIN_BATCH, seed=0))["loss"])
    del state
    rc2 = train_cli.main(args[:4] + ["3"] + args[5:] + ["--resume"])
    with open(os.path.join(model_dir, "train_metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    log(f"phase 19: python -m dan_tpu_torch.train main() --warm_start <the bundle> --steps 2 "
        f"--batch_size {TRAIN_BATCH} --warmup_steps 50 --grad_clip 10: rc {rc} in {secs:.1f} s "
        f"(host clock); without the two flags --warm_start keeps the reference recipe (warm-up "
        f"0, clip 0); losses {[r['loss'] for r in logged]}; first step's loss "
        f"{logged[0]['loss']!r} against train_step on the source weights {ref!r}; train kernel "
        f"launches {launches}")
    log(f"  then --steps 3 --resume --warm_start: rc {rc2}, logged steps {steps}, latest "
        f"checkpoint {ckpt.latest_step(model_dir)}")
    if rc != 0 or [r["step"] for r in logged] != [1, 2]:
        raise AssertionError(f"phase 19: the warm-started train CLI exited {rc}")
    if launches != {name: 2 * n for name, n in PER_STEP.items()}:
        raise AssertionError(f"phase 19: train kernel launches {launches} in 2 steps")
    if logged[0]["loss"] != ref:
        raise AssertionError("phase 19: the warm-started first step's loss is not the source "
                             "weights' loss on the same batch")
    if rc2 != 0 or steps != [1, 2, 3] or ckpt.latest_step(model_dir) != 3:
        raise AssertionError("phase 19: --resume did not continue the step-2 checkpoint")
    return launches


def phase19(cfg, dev, smi, d):
    """Phase 19 in the directory d, where it leaves dan.pt for phase 20."""
    prefix, sd_cpu, launches = phase19a(cfg, dev, smi, d)
    phase19b(cfg, d)
    launches["train"] = phase19c(prefix, sd_cpu, dev, d)
    return launches


# ---------------------------------------------------------------------------
# the tools, scripts and utils: phase 20
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))
COUNTERS = {"nms": nms_cuda, "vote": bbox_vote_cuda, "blocked": nms_blocked_cuda,
            "matcher": matching_cuda, "phase_pool_bwd": phase_pool_cuda,
            "conv12_wgrad": conv12_wgrad_cuda.BF16, "conv12_wgrad_f32": conv12_wgrad_cuda.F32,
            "conv_i8": conv_i8_cuda,
            "quantize_i8": quantize_i8_cuda, "upsample2x_bwd": upsample_cuda}
TOOLS_STEPS = 3  # train CLI steps of phase 20b
SOAK_N = 320  # images of phase 20f's synthetic-val soak (the documented one: 3,226)


def is_kernel(trace_name: str, kernel: str) -> bool:
    """Whether a profiler's kernel name ("name(args)", "void name<T>(args)",
    "ns::name(args)" or "name") names `kernel`."""
    import re

    return re.search(rf"(?:^|[ :]){kernel}(?:[<(]|$)", trace_name) is not None


# Every launch that counted() read in phase 20, by COUNTERS key.
COUNTED = collections.Counter()


def counted(fn):
    """(fn(), every kernel's launches in it): every count set to 0 just
    before, read just after, and added to COUNTED."""
    for mod in COUNTERS.values():
        mod.LAUNCHES = 0
    out = fn()
    c = {k: mod.LAUNCHES for k, mod in COUNTERS.items()}
    COUNTED.update(c)
    return out, c


def quiet(fn):
    """(fn(), what it printed to stdout and stderr), the two kept apart."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        res = fn()
    return res, out.getvalue(), err.getvalue()


def demo_lines(det_out, out_path=None):
    lines = [f"{len(det_out['scores'])} detections"] + [
        f"  [{b[0]:7.1f} {b[1]:7.1f} {b[2]:7.1f} {b[3]:7.1f}] {s:.3f}"
        for b, s in zip(det_out["bboxes"], det_out["scores"])]
    return lines + ([f"wrote {out_path}"] if out_path else [])


def phase20a(cfg, dev, tools, d, pt):
    """The demo CLI on a 1024x768 JPEG with phase 19's .pt: its detections
    == Detector.detect's bit for bit, --out at the input's shape, --tta
    (K1 + K8), --int8 (conv_i8 + quantize_i8 + K2)."""
    import cv2

    from dan_tpu_torch.data.widerface import load_image_rgb
    from dan_tpu_torch.tools import demo

    img = np.random.default_rng(SEED + 20).integers(0, 255, (768, 1024, 3), dtype=np.uint8)
    path, drawn = os.path.join(d, "demo.jpg"), os.path.join(d, "demo_out.jpg")
    cv2.imwrite(path, img[:, :, ::-1])
    rgb = load_image_rgb(path)
    base = ["--image", path, "--ckpt", pt, "--score_threshold", "0.05"]
    (res, printed, _), plain = counted(lambda: quiet(
        lambda: demo.run(demo.parse_args(base + ["--out", drawn]))))
    want = Detector.from_checkpoint(pt, cfg, dev).detect(rgb, score_threshold=0.05)
    if not same_detections([res[0]], [want]) or len(want["scores"]) == 0:
        raise AssertionError("phase 20a: the demo's detections differ from Detector.detect's")
    if printed.splitlines() != demo_lines(want, drawn):
        raise AssertionError("phase 20a: the demo printed other lines than detect's detections")
    shape = cv2.imread(drawn).shape
    if shape != rgb.shape:
        raise AssertionError(f"phase 20a: --out wrote {shape} for an input of {rgb.shape}")
    (res_t, _, _), tta = counted(lambda: quiet(
        lambda: demo.run(demo.parse_args(base + ["--tta"]))))
    (res_8, _, err8), i8 = counted(lambda: quiet(
        lambda: demo.run(demo.parse_args(base + ["--int8"]))))
    log(f"phase 20a: python -m dan_tpu_torch.tools.demo on a 1024x768 JPEG with phase 19's .pt "
        f"(score threshold 0.05): {len(want['scores'])} detections, boxes and scores "
        f"bit-identical to Detector.detect's and printed as the reference prints them; --out "
        f"{shape}; launches: plain {plain}; --tta {len(res_t[0]['scores'])} detections, {tta}; "
        f"--int8 {len(res_8[0]['scores'])} detections ({err8.strip().splitlines()[-1]}), {i8}")
    if plain["nms"] != 1 or not (tta["nms"] and tta["vote"]) or not (
            i8["conv_i8"] and i8["quantize_i8"] and i8["nms"]):
        raise AssertionError("phase 20a: the demo did not launch K2, K1 + K8 (--tta) or the "
                             "int8 kernels (--int8)")
    if not all(np.isfinite(r[0]["bboxes"]).all() for r in (res_t, res_8)):
        raise AssertionError("phase 20a: non-finite --tta or --int8 detections")
    tools.update({"K2": plain["nms"] + i8["nms"], "K1": tta["nms"], "K8": tta["vote"],
                  "conv_i8": i8["conv_i8"], "quantize_i8": i8["quantize_i8"]})


def trace_kernels(path):
    """{kernel name: launches} of a Chrome trace's device kernels."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    want = MATCHER_KERNELS + ("phase_pool_bwd_kernel", "wgrad_kernel", "upsample2x_bwd_kernel")
    return {k: sum(is_kernel(n, k) for n in names) for k in want}


def logged_step_ms(model_dir):
    """ms a step between the first and the last logged step (host clock of
    the train CLI's log, which reads each step's loss)."""
    with open(os.path.join(model_dir, "train_metrics.jsonl")) as f:
        t = [json.loads(line)["time"] for line in f]
    return (t[-1] - t[0]) * 1e3 / (len(t) - 1)


def phase20b(dev, smi, tools, d, pt):
    """The train CLI: --trace_dir (the trace names K3/K4, K5 and K6 as many
    times as they launched), --debug_nans timed beside the default, and a
    NaN in one parameter under --debug_nans (non-zero exit naming the module,
    no checkpoint)."""
    from dan_tpu_torch.utils.profiling import trace_path

    common = ["--synthetic", "--steps", str(TOOLS_STEPS), "--batch_size", str(TRAIN_BATCH),
              "--log_every", "1", "--checkpoint_every", str(TOOLS_STEPS)]
    runs = {k: os.path.join(d, f"train_{k}") for k in ("trace", "default", "debug")}
    trace_dir = os.path.join(d, "train_trace")
    rc, c_trace = counted(lambda: train_cli.main(
        common + ["--model_dir", runs["trace"], "--trace_dir", trace_dir]))
    seen = trace_kernels(trace_path(trace_dir))
    size = os.path.getsize(trace_path(trace_dir))
    want = {**{k: c_trace["matcher"] for k in MATCHER_KERNELS},
            "phase_pool_bwd_kernel": c_trace["phase_pool_bwd"],
            "wgrad_kernel": c_trace["conv12_wgrad"],
            "upsample2x_bwd_kernel": c_trace["upsample2x_bwd"]}
    log(f"phase 20b: python -m dan_tpu_torch.train main() --steps {TOOLS_STEPS} --batch_size "
        f"{TRAIN_BATCH} --trace_dir: rc {rc}; trace {size / 1e6:.1f} MB, kernels in it {seen}; "
        f"launch counters {c_trace}")
    if rc != 0 or any(seen[k] != n for k, n in want.items()) or c_trace["matcher"] != TOOLS_STEPS:
        raise AssertionError("phase 20b: the trace does not name K3/K4, K5 and K6 as many times "
                             "as they launched")
    # In turns: default, --debug_nans, --debug_nans, default.
    ms, rcs, c_def, c_dbg = {"default": [], "debug": []}, [], collections.Counter(), \
        collections.Counter()
    for i, kind in enumerate(("default", "debug", "debug", "default")):
        run = os.path.join(d, f"train_{kind}_{i}")
        extra = ["--debug_nans"] if kind == "debug" else []
        rc_i, c = counted(lambda: train_cli.main(common + ["--model_dir", run] + extra))
        rcs.append(rc_i)
        (c_dbg if kind == "debug" else c_def).update(c)
        ms[kind].append(logged_step_ms(run))
    ms_d, ms_g = np.mean(ms["default"]), np.mean(ms["debug"])
    log(f"  the same {TOOLS_STEPS} steps in turns: default {ms['default']} ms a step, "
        f"--debug_nans {ms['debug']} ({ms_g / ms_d:.2f}x; host clock of the log from step 1 to "
        f"{TOOLS_STEPS}, each step reading its loss; {smi}); rc {rcs}")
    if rcs != [0] * 4 or c_dbg != c_def:
        raise AssertionError("phase 20b: --debug_nans changed the launches or failed a clean run")
    sd = torch.load(pt, weights_only=True)["model"]
    sd["backbone.conv3_1.weight"].view(-1)[0] = float("nan")
    nan_pt, nan_dir = os.path.join(d, "nan.pt"), os.path.join(d, "train_nan")
    torch.save({"model": sd}, nan_pt)
    proc = subprocess.run(
        [sys.executable, "-m", "dan_tpu_torch.train", *common[:5], "--checkpoint_every", "1",
         "--model_dir", nan_dir, "--warm_start", nan_pt, "--debug_nans", "--warmup_steps", "50",
         "--grad_clip", "10"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True,
        timeout=600)
    saved = [f for f in os.listdir(nan_dir) if f.startswith("step_")] if os.path.isdir(
        nan_dir) else []
    last = proc.stderr.strip().splitlines()[-1] if proc.stderr.strip() else ""
    log(f"  a NaN in backbone.conv3_1.weight under --debug_nans (a subprocess): rc "
        f"{proc.returncode}, \"{last}\", checkpoints {saved}")
    if proc.returncode == 0 or "backbone.conv3_1 (Conv)" not in last or saved:
        raise AssertionError("phase 20b: --debug_nans did not stop at the poisoned module")
    for k in TRAIN_NAMES:
        tools[k] += c_trace[k] + c_def[k] + c_dbg[k]


def phase20c(dev, tools, d):
    """tools.profile detect at batch 128 and train at batch 32: the
    hand-written kernels by name in the tables."""
    rows = {}
    for graph, batch in (("detect", BATCH), ("train", TRAIN_BATCH)):
        (_, _, table), c = counted(lambda: profile_tool.profile(
            graph, batch, 3, 12, os.path.join(d, f"profile_{graph}"), dev))
        rows[graph] = [r.name for r in table]
        log(f"phase 20c: tools.profile {graph} at batch {batch}: {len(table)} rows; launches {c}")
        if graph == "detect":
            tools["K1"] += c["nms"]
        else:
            for k in TRAIN_NAMES:
                tools[k] += c[k]
    named = {"detect": ("nms_rank_kernel",),
             "train": MATCHER_KERNELS + ("phase_pool_bwd_kernel", "wgrad_kernel",
                                         "upsample2x_bwd_kernel")}
    for graph, kernels in named.items():
        missing = [k for k in kernels if not any(is_kernel(n, k) for n in rows[graph])]
        if missing:
            raise AssertionError(f"phase 20c: {missing} not in the {graph} table")


def phase20de(dev, smi, tools, d):
    """The TFRecord roundtrip of the fixture with its MB/s, then the fixture
    soak at the reference's defaults, then its eval CLI again in process,
    counted."""
    from dan_tpu_torch.tools import soak_fixture_e2e as soak

    _, t_w, t_r, size = soak.tfrecord_roundtrip(os.path.join(d, "tfr_only"))
    log(f"phase 20d: TFRecord roundtrip of the fixture (20 images, 4 shards, {size / 1e6:.2f} "
        f"MB): write {t_w:.3f} s = {size / 1e6 / t_w:.1f} MB/s (cv2 decode for (h, w) "
        f"included), read + CRC check {t_r:.3f} s = {size / 1e6 / t_r:.1f} MB/s (host "
        f"numbers of the card's host, numpy)")
    work = os.path.join(d, "soak")
    res, c = counted(lambda: soak.run(soak.parse_args(["--work_dir", work])))
    ap = [ln for ln in res["eval_stdout"].splitlines() if "AP" in ln]
    log(f"phase 20e: python -m dan_tpu_torch.tools.soak_fixture_e2e main() at its defaults "
        f"(300 steps, batch 8, TrainPipeline of 4 workers a producer): {res['img_s']:.1f} img/s "
        f"(host clock, feed included; {smi}), last loss {res['loss']:.4f}; train launches "
        f"{ {k: c[k] for k in TRAIN_NAMES} }; the eval CLI "
        f"(a subprocess): {ap}")
    if not train_launches_ok(c, 300):
        raise AssertionError("phase 20e: the soak's train steps did not launch K3-K6 once and "
                             "the upsample gradient three times a step")
    argv = ["--wider_root", soak.FIX, "--ckpt", res["model_dir"], "--no_tta", "--output_dir",
            os.path.join(d, "soak_preds"), "--gt_mats",
            os.path.join(soak.FIX, "eval_tools", "ground_truth")]
    (rc, out, _), c_eval = counted(lambda: quiet(lambda: eval_cli.main(argv)))
    log(f"  the same eval CLI in process: rc {rc}, {out.strip().splitlines()[-1]}; NMS "
        f"launches {c_eval['nms']} (K2, one an image)")
    if rc != 0 or c_eval["nms"] != 20:
        raise AssertionError("phase 20e: the eval CLI did not launch K2 once an image")
    for k in TRAIN_NAMES:
        tools[k] += c[k]
    tools["K2"] += c_eval["nms"]
    return res["model_dir"]


def phase20f(dev, smi, tools, d):
    """The synthetic-val soak at SOAK_N images: make_synth_wider, then the
    eval CLI with TTA on; K1 and K7 counted against last_run_stats."""
    import ast
    import re

    from dan_tpu_torch.tools import make_synth_wider

    root = os.path.join(d, "synth")
    t0 = time.perf_counter()
    _, made, _ = quiet(lambda: make_synth_wider.main(["--out", root, "--n", str(SOAK_N)]))
    t_make = time.perf_counter() - t0
    t0 = time.perf_counter()
    (rc, out, err), c = counted(lambda: quiet(lambda: eval_cli.main(
        ["--wider_root", root, "--output_dir", os.path.join(d, "synth_preds")])))
    secs = time.perf_counter() - t0
    stats = ast.literal_eval(re.search(r"\[tta\] stats: (\{.*\})", err).group(1))
    warmed = int(re.search(r"\[tta\] warmed (\d+) launch shapes", err).group(1))
    run_line = re.search(r"\[tta\] \d+ images in .*", err).group(0)
    log(f"phase 20f: make_synth_wider --n {SOAK_N} ({t_make:.1f} s) then python -m "
        f"dan_tpu_torch.eval --wider_root <it> (TTA): rc {rc}, {run_line}; the CLI "
        f"{SOAK_N / secs:.2f} images/s end to end incl. warm-up, decode and AP (host clock; "
        f"{smi}); stats {stats}; launches K1 {c['nms']}, K7 {c['vote']} ({warmed} shapes "
        f"warmed, one launch each); {out.strip().splitlines()[-1]}")
    if rc != 0 or stats["images"] != SOAK_N or (c["nms"], c["vote"]) != (
            stats["bucket_launches"] + warmed - 1, stats["vote_launches"] + 1):
        raise AssertionError("phase 20f: K1 / K7 launches differ from last_run_stats + warm-up")
    tools["K1"] += c["nms"]
    tools["K7"] += c["vote"]


def phase20(cfg, dev, smi, d):
    """The tools, scripts and utils of the port (dan_tpu_torch/tools/,
    utils/, data/tfrecords.py) on the card; returns each kernel's launches
    in them, by kernels-line entry, and the fixture soak's model dir."""
    import cv2

    log(f"phase 20: cv2 {cv2.__version__} is on this host: every part (a)-(f) runs")
    tools = collections.Counter()
    COUNTED.clear()
    pt = os.path.join(d, "dan.pt")
    phase20a(cfg, dev, tools, d, pt)
    phase20b(dev, smi, tools, d, pt)
    phase20c(dev, tools, d)
    soak_dir = phase20de(dev, smi, tools, d)
    phase20f(dev, smi, tools, d)
    tools["K9"] = COUNTED["blocked"]
    if tools["K9"]:
        raise AssertionError(f"phase 20: the blocked NMS, on no path, launched {tools['K9']} "
                             "times on the tools' paths")
    log(f"phase 20: launches of the tools' paths {dict(tools)}")
    return tools, soak_dir


# ---------------------------------------------------------------------------
# the host C++ helpers (dan_tpu_torch/native/): phase 21
# ---------------------------------------------------------------------------

TURBO_SYMBOLS = ("jpeg_crop_scanline", "jpeg_skip_scanlines", "jpeg_mem_src")
NATIVE_IMAGES = 64  # synthetic JPEGs 1024 wide, profile_host_feed's
NATIVE_STEPS, NATIVE_BATCH = 20, 8  # train steps of phase 21d
MATCHER_IMAGES = 50


@contextlib.contextmanager
def numpy_matcher():
    """The AP protocol on its numpy matcher: native.image_eval answers None."""
    saved = native.image_eval
    native.image_eval = lambda *a, **k: None
    try:
        yield
    finally:
        native.image_eval = saved


def phase21a():
    """The probe: PIL's version and the libjpeg it ships, that library's
    libjpeg-turbo symbols, g++, and both builds.  Returns the libjpeg file
    (None: this host has none)."""
    import ctypes
    import importlib.metadata
    import shutil

    path, _, why = native.libjpeg()
    try:
        pil = importlib.metadata.version("pillow")
    except importlib.metadata.PackageNotFoundError:
        pil = "not installed"
    log(f"phase 21a: PIL {pil}; PIL's libjpeg {native.pil_libjpeg()}; linked: {path or why}")
    found = {}
    if path is not None:
        if shutil.which("nm"):
            how = "nm -D"
            lines = subprocess.run(["nm", "-D", path], capture_output=True,
                                   text=True).stdout.splitlines()
            defined = {ln.split()[-1].split("@")[0] for ln in lines if " T " in ln}
            found = {sym: sym in defined for sym in TURBO_SYMBOLS}
        else:
            how = "ctypes"
            lib = ctypes.CDLL(path)
            found = {sym: hasattr(lib, sym) for sym in TURBO_SYMBOLS}
        log(f"  {how} {os.path.basename(path)}: {found}")
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True).stdout
    log(f"  {gxx.splitlines()[0] if gxx else 'no g++'}")
    loaded = native.load_loader() is not None
    log(f"  builds (g++ seconds, phase 2): {native.BUILD_SECONDS}; overlaps "
        f"{'loaded' if native.load() is not None else 'unavailable'}; loader "
        f"{'loaded' if loaded else native.loader_unavailable_reason()}")
    if native.load() is None:
        raise AssertionError("phase 21a: overlaps.cc did not build or load")
    if path is not None and not (loaded and all(found.values())):
        raise AssertionError("phase 21a: a libjpeg is on this host but the loader did not load")
    return path


def matcher_images(rng, n):
    """WIDER-like images for the AP matcher: up to 750 score-sorted
    detections, half of them near one of up to 120 gts, the rest anywhere;
    a third of the gts outside the difficulty subset."""
    out = []
    for _ in range(n):
        m = int(rng.integers(0, 120))
        xy = rng.uniform(0, 1000, (m, 2))
        gts = np.concatenate([xy, xy + rng.uniform(4, 300, (m, 2))], 1)
        k = int(rng.integers(1, 750))
        dets = np.concatenate([rng.uniform(0, 1000, (k, 2)), np.zeros((k, 2))], 1)
        dets[:, 2:] = dets[:, :2] + rng.uniform(4, 300, (k, 2))
        if m:
            near = rng.integers(0, m, k // 2)
            dets[:k // 2] = gts[near] + rng.normal(0, 6.0, (k // 2, 4))
        dets = np.concatenate([dets, rng.uniform(0, 1, (k, 1))], 1)
        dets = dets[np.argsort(-dets[:, 4], kind="stable")]
        out.append((dets, gts, np.nonzero(rng.uniform(size=m) > 0.33)[0]))
    return out


def phase21b(d, soak_dir):
    """overlaps.cc bit for bit against the numpy IoU and matcher, and the
    eval CLI's AP on the fixture with and without it; returns K2's
    launches."""
    from dan_tpu_torch.eval import widerface_ap as ap
    from dan_tpu_torch.eval.widerface_ap import load_official_gt
    from dan_tpu_torch.tools import soak_fixture_e2e as soak

    rng = np.random.default_rng(SEED + 21)
    boxes = [np.concatenate([xy, xy + rng.uniform(1, 200, (n, 2))], 1)
             for n, xy in ((3000, rng.uniform(0, 1000, (3000, 2))),
                           (1000, rng.uniform(0, 1000, (1000, 2))))]
    t0 = time.perf_counter()
    got = native.bbox_overlaps(*boxes)
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = ap._bbox_overlaps(*boxes)
    t_np = time.perf_counter() - t0
    same_iou = np.array_equal(got.view(np.int64), want.view(np.int64))
    images = matcher_images(rng, MATCHER_IMAGES)

    def match_all():
        return [ap._image_eval(dets, gts, keep) for dets, gts, keep in images]

    t0 = time.perf_counter()
    nat = match_all()
    t_nat_m = time.perf_counter() - t0
    with numpy_matcher():
        t0 = time.perf_counter()
        ref = match_all()
        t_np_m = time.perf_counter() - t0
    bad = sum(not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))
              for a, b in zip(nat, ref))
    log(f"phase 21b: bbox_overlaps 3000 x 1000: {(got > 0).sum()} nonzero pairs, bit-identical "
        f"to numpy: {same_iou} ({t_nat * 1e3:.1f} ms native, {t_np * 1e3:.1f} ms numpy; host "
        f"clock); image_eval on {MATCHER_IMAGES} images ({sum(len(i[0]) for i in images)} dets, "
        f"{sum(len(i[1]) for i in images)} gts): {bad} differ from the numpy matcher "
        f"({t_nat_m * 1e3:.1f} ms native, {t_np_m * 1e3:.1f} ms numpy)")
    if not same_iou or bad:
        raise AssertionError("phase 21b: overlaps.cc differs from numpy")
    gt_dir = os.path.join(soak.FIX, "eval_tools", "ground_truth")
    preds = os.path.join(d, "native_preds")
    calls = []
    image_eval = native.image_eval
    native.image_eval = lambda *a: calls.append(1) or image_eval(*a)
    try:
        (rc, out, _), c = counted(lambda: quiet(lambda: eval_cli.main(
            ["--wider_root", soak.FIX, "--ckpt", soak_dir, "--no_tta", "--output_dir", preds,
             "--gt_mats", gt_dir])))
    finally:
        native.image_eval = image_eval
    with numpy_matcher():
        rc2, out2, _ = quiet(lambda: eval_cli.main(
            ["--score_only", "--pred_dir", preds, "--gt_mats", gt_dir]))
    gt_boxes, keep, _ = load_official_gt(gt_dir)
    dets = load_detection_dir(preds)
    ap_nat = evaluate_widerface(dets, gt_boxes, keep)
    with numpy_matcher():
        ap_np = evaluate_widerface(dets, gt_boxes, keep)
    line, line2 = out.strip().splitlines()[-1], out2.strip().splitlines()[-1]
    log(f"  the eval CLI --no_tta on the fixture with phase 20e's model, native matcher "
        f"({len(calls)} image_eval calls): rc {rc}, {line}; --score_only on the numpy matcher: "
        f"rc {rc2}, {line2}; AP native {ap_nat} numpy {ap_np}; K2 launches {c['nms']}")
    if rc or rc2 or line != line2 or ap_nat != ap_np or not calls or c["nms"] != 20:
        raise AssertionError("phase 21b: the fixture's AP differs without the native matcher, "
                             "or the eval did not take it or K2")
    return c["nms"]


def reencoded(records, d):
    """16 of the synthetic JPEGs encoded again: 4:2:0 and 4:4:4 at quality
    60, 75, 95 and 99, twice, the last two progressive."""
    import cv2

    from dan_tpu_torch.data.widerface import ImageRecord

    out = []
    for k, r in enumerate(records[:16]):
        q = (60, 75, 95, 99)[k % 4]
        params = [cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                  (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)[
                      (k // 4) % 2]]
        if k >= 14:
            params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
        path = os.path.join(d, f"reenc{k}.jpg")
        cv2.imwrite(path, cv2.imread(r.path), params)
        out.append(ImageRecord(path=path, rel_path=f"e/reenc{k}.jpg", event="e",
                               boxes=r.boxes, attrs=r.attrs))
    return out


def odd_files(d, rng):
    """An EXIF-rotated JPEG (orientation 6) and a PNG, each with a face."""
    import cv2
    from PIL import Image

    from dan_tpu_torch.data.widerface import ImageRecord

    img = rng.integers(0, 255, (700, 900, 3), dtype=np.uint8)
    exif = Image.Exif()
    exif[0x0112] = 6
    rot, png = os.path.join(d, "rot.jpg"), os.path.join(d, "odd.png")
    Image.fromarray(img).save(rot, format="JPEG", exif=exif.tobytes())
    cv2.imwrite(png, img[:, :, ::-1])
    box = np.array([[100, 120, 300, 330]], np.float32)
    return [ImageRecord(path=p, rel_path=f"e/{os.path.basename(p)}", event="e", boxes=box,
                        attrs=np.zeros((1, 6), np.float32)) for p in (rot, png)]


def phase21c(dev, d, synth):
    """loader.cc's batches against the cv2 batches: byte for byte at 'full',
    the same train preprocess and targets on the card at 'crop', the
    fallback for an EXIF-rotated JPEG and a PNG."""
    from dan_tpu_torch.data.pipeline import _collate, _prepare_batch_native, _prepare_sample
    from dan_tpu_torch.data.widerface import load_split
    from dan_tpu_torch.tools import soak_fixture_e2e as soak

    cfg = default_config()
    records = load_split(soak.FIX, "val", keep_invalid=True) + synth + reencoded(synth, d)
    seeds = [SEED + 2100 + i for i in range(len(records))]
    counts = {w: collections.Counter() for w in ("full", "crop")}
    full_bad, crop_bad, t_prep = [], [], 0.0
    for i in range(0, len(records), 16):
        recs, sds = records[i:i + 16], seeds[i:i + 16]
        full = _prepare_batch_native(recs, cfg, sds, os.cpu_count(), "full", counts["full"])
        crop = _prepare_batch_native(recs, cfg, sds, os.cpu_count(), "crop", counts["crop"])
        want = _collate([_prepare_sample(r, cfg, sd) for r, sd in zip(recs, sds)])
        for j in range(len(recs)):
            if any(not np.array_equal(full[k][j], want[k][j]) for k in want):
                full_bad.append(recs[j].rel_path)
        t0 = time.perf_counter()
        img_c, t_c = preprocess_and_match(crop, cfg, dev)
        img_w, t_w = preprocess_and_match(want, cfg, dev)
        torch.cuda.synchronize()
        t_prep += time.perf_counter() - t0
        for j in range(len(recs)):
            if not (same_bits(img_c[j], img_w[j]) and all(
                    same_bits(getattr(t_c, k)[j], getattr(t_w, k)[j]) for k in t_c._fields)):
                crop_bad.append(recs[j].rel_path)
    odd = odd_files(d, np.random.default_rng(SEED + 22))
    plain = [records[20], records[21]]
    mixed = odd + plain
    odd_counts = collections.Counter()
    got = _prepare_batch_native(mixed, cfg, [7, 8, 9, 10], 2, "full", odd_counts)
    want = _collate([_prepare_sample(r, cfg, sd) for r, sd in zip(mixed, [7, 8, 9, 10])])
    odd_same = all(np.array_equal(got[k], want[k]) for k in want)
    log(f"phase 21c: {len(records)} images (the fixture's 20, {len(synth)} synthetic 1024 wide, "
        f"16 re-encoded at 4:2:0 / 4:4:4, q 60-99, 2 progressive) at canvas "
        f"{cfg.preprocess.canvas_size}: window 'full' native == cv2 byte for byte, every key, on "
        f"{len(records) - len(full_bad)} (differ: {full_bad}); images by path {dict(counts['full'])}; "
        f"window 'crop' train preprocess + matcher targets on the card bit-identical to the cv2 "
        f"batch's on {len(records) - len(crop_bad)} (differ: {crop_bad}; {t_prep:.2f} s for both "
        f"on the card); images by path {dict(counts['crop'])}; an EXIF-rotated JPEG and a PNG "
        f"beside 2 plain: {dict(odd_counts)}, the batch == cv2's: {odd_same}")
    if full_bad or crop_bad or counts["full"]["fallback"] or counts["crop"]["fallback"] or (
            odd_counts != {"native": 2, "fallback": 2}) or not odd_same:
        raise AssertionError("phase 21c: the native batch differs from the cv2 batch, or the "
                             "fallback was not taken where it must be and only there")


def phase21d(dev, smi, synth):
    """TrainPipeline on the native decoder -> device_prefetch -> train_step,
    NATIVE_STEPS at NATIVE_BATCH on the synthetic JPEGs; returns the
    launches."""
    from dan_tpu_torch.data.pipeline import TrainPipeline, device_prefetch

    cfg = train_config(default_config())
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=NATIVE_BATCH))
    state = create_train_state(cfg, SEED, dev)
    pipe = TrainPipeline(synth, cfg, seed=SEED, num_workers=4)

    def run():
        feed = device_prefetch(iter(pipe), dev)
        try:
            out = [train_step(state, next(feed)) for _ in range(NATIVE_STEPS)]
            torch.cuda.synchronize()
            return out
        finally:
            feed.close()  # closes the pipeline's stream, which joins its producers

    t0 = time.perf_counter()
    metrics, c = counted(run)
    secs = time.perf_counter() - t0
    losses = [float(m["loss"]) for m in metrics]
    log(f"phase 21d: TrainPipeline (native, window {pipe.native_window}, "
        f"{pipe.num_producers} producers x 4 threads) -> device_prefetch -> train_step, "
        f"{NATIVE_STEPS} steps at batch {NATIVE_BATCH}, {cfg.preprocess.train_image_size}x"
        f"{cfg.preprocess.train_image_size}: {NATIVE_STEPS * NATIVE_BATCH / secs:.1f} img/s "
        f"(host clock, first step and the feed included; {smi}); images by path "
        f"{dict(pipe.decoded)}; loss {losses[0]:.4f} -> {losses[-1]:.4f}; launches "
        f"{ {k: c[k] for k in TRAIN_NAMES} }")
    if not np.isfinite(losses).all() or not train_launches_ok(c, NATIVE_STEPS) or (
            pipe.decoded["native"] < NATIVE_STEPS * NATIVE_BATCH or pipe.decoded["fallback"]):
        raise AssertionError("phase 21d: the native-fed train steps did not launch K3-K6 once "
                             "and the upsample gradient three times a step, met a non-finite "
                             "loss, or did not decode natively")
    return c


def phase21e(smi, synth):
    """profile_host_feed on the synthetic JPEGs: the native and the cv2
    path's stages and pipeline rates."""
    from dan_tpu_torch.tools import profile_host_feed

    res, out, _ = quiet(lambda: profile_host_feed.measure(
        synth, profile_host_feed.parse_args(["--n", str(len(synth))])))
    log(f"phase 21e: python -m dan_tpu_torch.tools.profile_host_feed --n {len(synth)} (host "
        f"only, the card's host, {os.cpu_count()} cores; {smi}):")
    for line in out.strip().splitlines():
        log(f"  {line}")
    nat = res["native"]
    if nat is None or nat["fallback"] or not nat["per_img_ms"] > 0:
        raise AssertionError("phase 21e: no native host feed cost, or a fallback row")
    log(f"phase 21e: decode ms an image, one thread: native crop window "
        f"{nat['ms']['decode_crop']:.3f}, native whole image {nat['ms']['decode_full']:.3f}, cv2 "
        f"whole image {res['ms']['decode']:.3f}; per image {nat['per_img_ms']:.3f} ms native, "
        f"{res['per_img_ms']:.3f} ms cv2: one card's train step at "
        f"{profile_host_feed.TRAIN_IMG_S} img/s needs "
        f"{profile_host_feed.TRAIN_IMG_S * nat['per_img_ms'] / 1e3:.2f} cores native, "
        f"{profile_host_feed.TRAIN_IMG_S * res['per_img_ms'] / 1e3:.2f} cv2; pipeline img/s "
        f"{res['pipeline_img_s']}")


def phase21(dev, smi, d, soak_dir):
    """The host C++ helpers on the card's host; returns the launches of the
    paths they feed, by kernels-line entry."""
    import cv2

    from dan_tpu_torch.tools import profile_host_feed

    t0 = time.perf_counter()
    jpeg = phase21a()
    launches = collections.Counter(nms=phase21b(d, soak_dir))
    if jpeg is None:
        log(f"phase 21c-e: not run: {native.loader_unavailable_reason()}")
        return launches
    synth_dir = os.path.join(d, "native_synth")
    os.makedirs(synth_dir)
    synth = profile_host_feed.make_dataset(NATIVE_IMAGES, synth_dir, np.random.default_rng(0))
    log(f"phase 21c: cv2 {cv2.__version__}")
    phase21c(dev, d, synth)
    c = phase21d(dev, smi, synth)
    for k in TRAIN_NAMES:
        launches[k] = c[k]
    phase21e(smi, synth)
    log(f"phase 21: {time.perf_counter() - t0:.1f} s; launches {dict(launches)}")
    return launches


# ---------------------------------------------------------------------------
# the bench entry points (tools/bench*.py, tools/entry.py): phase 22
# ---------------------------------------------------------------------------

# 22b and 22c: the smallest run bench_train and bench_int8 take.  They are
# checked for their exit code, the line they print and their launches; the
# benchmark's cells measure the paths they time.
BENCH_ARGV = ["--batch", "1", "--iters", "1"]
TTA_BENCH_ARGV = ["--images", "48", "--tta_batches", "4,16", "--vote_batches", "32,128"]
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}
NMS_LINE = (r"bench: greedy_nms_rank launches (\d+); rows of the last launch on the tile scan "
            r"(\d+)/(\d+)")
TRAIN_LINE = r"train batch=(\d+)/chip x (\d+) chip\(s\): ([\d.]+) img/s/chip \(([\d.]+) ms/step\)"
INT8_LINE = r"bf16 ([\d.]+) -> int8 ([\d.]+) img/s/chip \(([\d.]+)x\)"


def phase22a():
    """python -m dan_tpu_torch.tools.bench in a subprocess, as a shell runs
    it; then with no card visible.  Its NMS launches are read from the line
    it prints to stderr (nms_cuda.LAUNCHES over its measure(), and
    LAST_PATHS of the last launch: the 24 launches take the same images).
    Returns the NMS launches at B = BATCH."""
    import re

    env = {k: v for k, v in os.environ.items()
           if k not in ("DAN_BENCH_ALLOW_CPU", "DAN_BENCH_MEASURE_CPU", "DAN_BENCH_BATCH")}
    env["PYTHONPATH"] = REPO
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dan_tpu_torch.tools.bench"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    log(f"phase 22a: python -m dan_tpu_torch.tools.bench (a subprocess, {secs:.1f} s, PyTorch's "
        f"TF32 defaults: the bf16 convolutions do not use TF32): rc {proc.returncode}, stdout "
        f"{lines}")
    for line in proc.stderr.strip().splitlines()[-6:]:
        log(f"  {line}")
    head = json.loads(lines[0]) if len(lines) == 1 else {}
    if proc.returncode != 0 or set(head) != BENCH_KEYS or head["metric"] != bench_tool.METRIC:
        raise AssertionError("phase 22a: the bench did not print one JSON line with the four "
                             "keys")
    nms = re.search(NMS_LINE, proc.stderr)
    calls = 1 + bench_tool.WARMUP_ITERS + bench_tool.MEASURE_ITERS
    if nms is None or [int(g) for g in nms.groups()] != [calls, BATCH, BATCH]:
        raise AssertionError(f"phase 22a: the bench did not launch the NMS kernel {calls} times "
                             f"with every row of its last launch on the tile scan "
                             f"({nms.group(0) if nms else 'no launch line'})")
    proc = subprocess.run([sys.executable, "-m", "dan_tpu_torch.tools.bench"], cwd=REPO,
                          env=dict(env, CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
                          timeout=300)
    last = proc.stderr.strip().splitlines()[-1] if proc.stderr.strip() else ""
    log(f"  with CUDA_VISIBLE_DEVICES=\"\": rc {proc.returncode}, stdout {proc.stdout!r}, "
        f"\"{last}\"")
    if proc.returncode != bench_tool.NO_CARD_EXIT or proc.stdout.strip():
        raise AssertionError("phase 22a: without a card the bench did not exit 5 or printed a "
                             "number")
    return calls


def phase22b(params):
    """bench_train at BENCH_ARGV in process, counted."""
    import re

    from dan_tpu_torch.tools import bench_train

    (rc, out, err), c = counted(lambda: quiet(lambda: bench_train.main(BENCH_ARGV,
                                                                      params=params)))
    m = re.fullmatch(TRAIN_LINE, out.strip().splitlines()[-1])
    steps = 1 + bench_train.WARMUP_STEPS + int(BENCH_ARGV[3])
    log(f"phase 22b: python -m dan_tpu_torch.tools.bench_train {' '.join(BENCH_ARGV)}: rc {rc}, "
        f"\"{out.strip()}\" ({err.strip().splitlines()[0]}); launches in {steps} steps "
        f"{ {k: c[k] for k in TRAIN_NAMES} }")
    if rc != 0 or m is None or m.group(1) != BENCH_ARGV[1] or not train_launches_ok(c, steps):
        raise AssertionError("phase 22b: bench_train did not print the reference's line or did "
                             "not launch K3-K6 once and the upsample gradient three times a "
                             "step")
    return c


def phase22c(params):
    """bench_int8 at BENCH_ARGV in process, counted."""
    import re

    from dan_tpu_torch.tools import bench_int8

    (rc, out, err), c = counted(lambda: quiet(lambda: bench_int8.main(BENCH_ARGV,
                                                                     params=params)))
    m = re.fullmatch(INT8_LINE, out.strip().splitlines()[-1])
    fwd = 1 + bench_tool.WARMUP_ITERS + int(BENCH_ARGV[3])  # forwards of each measure()
    log(f"phase 22c: python -m dan_tpu_torch.tools.bench_int8 {' '.join(BENCH_ARGV)}: rc {rc}, "
        f"\"{out.strip()}\"; launches conv_i8 {c['conv_i8']}, "
        f"quantize_i8 {c['quantize_i8']}, NMS {c['nms']} in {fwd} int8 and {fwd} bf16 forwards")
    if rc != 0 or m is None:
        raise AssertionError("phase 22c: bench_int8 did not print the reference's line")
    if (c["conv_i8"], c["quantize_i8"], c["nms"]) != (I8_PER_FORWARD * fwd, fwd, 2 * fwd):
        raise AssertionError(f"phase 22c: launches {dict(c)}, expected {I8_PER_FORWARD} conv_i8 "
                             "and 1 quantize_i8 an int8 forward, 1 NMS a step")
    return c


def phase22d(smi, params):
    """bench_tta_dataset on 48 images at 2 x 2 pairs, each row's launches
    counted and held against its counts and last_run_stats."""
    from dan_tpu_torch.tools import bench_tta_dataset as btd

    per_row = []

    def measure(runner, sizes, images, tb, vb):
        before = {k: mod.LAUNCHES for k, mod in COUNTERS.items()}
        row = btd.measure_pair(runner, sizes, images, tb, vb)
        per_row.append((row, {k: mod.LAUNCHES - before[k] for k, mod in COUNTERS.items()},
                        dict(runner.last_run_stats)))
        return row

    t0 = time.perf_counter()
    (rows, out, err), c = counted(lambda: quiet(lambda: btd.run(
        btd.parse_args(TTA_BENCH_ARGV), params=params, measure=measure)))
    printed = [json.loads(line) for line in out.strip().splitlines()]
    log(f"phase 22d: python -m dan_tpu_torch.tools.bench_tta_dataset {' '.join(TTA_BENCH_ARGV)} "
        f"({time.perf_counter() - t0:.1f} s with the warm-up; host clock; {smi}):")
    for line in err.strip().splitlines()[:-1]:
        log(f"  {line}")
    bad = printed != rows
    for row, launches, stats in per_row:
        log(f"  {json.dumps(row)}; counted K1 {launches['nms']}, K7 {launches['vote']}; "
            f"last_run_stats {stats}")
        bad |= not (row["bucket_launches"] == launches["nms"] == stats["bucket_launches"]
                    and row["vote_launches"] == launches["vote"] == stats["vote_launches"]
                    and row["images"] == stats["images"] == int(TTA_BENCH_ARGV[1]))
    log(f"  warm-up launches: K1 {c['nms'] - sum(r['bucket_launches'] for r in rows)}, K7 "
        f"{c['vote'] - sum(r['vote_launches'] for r in rows)}")
    if bad or len(rows) != 4:
        raise AssertionError("phase 22d: a row's launch counts differ from the K1 / K7 counters "
                             "or last_run_stats, or the printed rows from the returned ones")
    return c


def phase22e(cfg, dev, params):
    """entry()'s forward on the card."""
    from dan_tpu_torch.tools.entry import entry

    def forward():
        fn, args = entry(device=dev, params=params)
        return fn(*args)

    (cls, loc), c = counted(forward)
    torch.cuda.synchronize()
    n = cfg.anchors.num_anchors(cfg.model.image_size)
    log(f"phase 22e: tools.entry.entry(): forward of one zero 640x640 image -> cls "
        f"{tuple(cls.shape)} {cls.dtype}, loc {tuple(loc.shape)} {loc.dtype}; kernel launches "
        f"{sum(c.values())}")
    if (cls.shape, loc.shape) != ((1, n, 2), (1, n, 4)) or cls.dtype != torch.float32 or not (
            torch.isfinite(cls).all() and torch.isfinite(loc).all()) or sum(c.values()):
        raise AssertionError("phase 22e: entry()'s forward is not finite logits of the default "
                             "shapes, or it launched a hand-written kernel")


@contextlib.contextmanager
def launch_batches():
    """{'nms': [...], 'vote': [...]}: (rows, LAST_PATHS or None) of every
    NMS and vote kernel launch while inside, read after each launch that
    its wrapper counted (each module's _launch wrapped, restored after)."""
    seen = {"nms": [], "vote": []}
    saved = {k: COUNTERS[k]._launch for k in seen}

    def spy(key):
        mod = COUNTERS[key]

        def launch(*args, **kwargs):
            before = mod.LAUNCHES
            out = saved[key](*args, **kwargs)
            if mod.LAUNCHES != before:
                seen[key].append((int(mod.LAST_TILES.shape[0]),
                                  mod.LAST_PATHS if key == "nms" else None))
            return out
        return launch

    for key in seen:
        COUNTERS[key]._launch = spy(key)
    try:
        yield seen
    finally:
        for key, fn in saved.items():
            COUNTERS[key]._launch = fn


def phase22(cfg, dev, smi):
    """The bench entry points on the card; returns each kernel's launches in
    them, by kernels-line entry."""
    t0 = time.perf_counter()
    COUNTED.clear()
    params = init_reference_params(0, cfg.model)
    log(f"phase 22: the JAX package's PRNGKey(0) weights drawn on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    bench_nms = phase22a()
    with launch_batches() as seen:
        train = phase22b(params)
        i8 = phase22c(params)
        tta = phase22d(smi, params)
        phase22e(cfg, dev, params)
    if COUNTED["blocked"]:
        raise AssertionError(f"phase 22: the blocked NMS, on no path, launched "
                             f"{COUNTED['blocked']} times")
    # K2 and K8 are the batched kernels at B = 1: each launch goes to the
    # entry of its batch, as the spy read it.
    one = {k: sum(rows == 1 for rows, _ in v) for k, v in seen.items()}
    rows_on_scan = torch.cat([p for _, p in seen["nms"]]) == nms_cuda.TILE_SCAN
    log(f"phase 22: in process, NMS launches by batch "
        f"{dict(collections.Counter(r for r, _ in seen['nms']))}, vote launches by batch "
        f"{dict(collections.Counter(r for r, _ in seen['vote']))}; NMS rows on the tile scan "
        f"{int(rows_on_scan.sum())}/{rows_on_scan.numel()}")
    if [len(seen[k]) for k in seen] != [COUNTED[k] for k in seen] or not bool(
            rows_on_scan.all()):
        raise AssertionError("phase 22: the launches read after each launch differ from the "
                             "counters, or an NMS row took the argmax loop or the long-row "
                             "path")
    launches = collections.Counter(
        K1=bench_nms + COUNTED["nms"] - one["nms"], K2=one["nms"],
        K7=COUNTED["vote"] - one["vote"], K8=one["vote"], K9=COUNTED["blocked"],
        conv_i8=i8["conv_i8"], quantize_i8=i8["quantize_i8"],
        **{k: train[k] for k in TRAIN_NAMES})
    log(f"phase 22: {time.perf_counter() - t0:.1f} s; launches {dict(launches)}")
    return launches


# ---------------------------------------------------------------------------
# long rows: phase 23
# ---------------------------------------------------------------------------

LONG_TOPK = 34125  # pre_nms_topk: every anchor of a 640x640 image
JAX_NMS_ROW = 56064  # the longest row nms_batched_pallas.py takes (its n_pad)
LONG_VOTE_ROWS = (8000, 29440)  # 8 variants x 1,000 detections; the JAX kernel's most at 750
LONG_MAX_DET = 1000
LONG_GT = 1024
LONG_FACES = 700
LONG_TRAIN_BATCH = 8
LONG_TTA_IMAGES = 16


def post_config(cfg, **fields):
    return dataclasses.replace(cfg, postprocess=dataclasses.replace(cfg.postprocess, **fields))


def phase23_nms(cfg, dev, smi):
    """K1 / K2's long-row path against the plain version on the card: the
    (8, 34125) rows of a random-init forward at pre_nms_topk 34,125, one of
    them alone, both sides of the shared-memory limit, one row shuffled
    (the argmax loop), a row with a NaN x1 and a NaN y2 sorted and shuffled,
    and the JAX kernel's longest row; two runs bit-identical; the kernel's
    times and their bounds from the replay.  -> (the Detector, results)."""
    post = cfg.postprocess
    thr, max_out = post.nms_iou_threshold, post.max_detections
    k1_max = nms_cuda.build().nms_rank_shared_max_n()
    det = Detector.from_random(SEED, post_config(cfg, pre_nms_topk=LONG_TOPK), dev)
    size = cfg.model.image_size
    rng = np.random.default_rng(SEED + 23)
    images = torch.from_numpy(
        rng.integers(0, 255, (LONG_TRAIN_BATCH, size, size, 3), dtype=np.uint8)).to(dev)
    boxes, scores = nms_candidates(det, images)
    del images
    if tuple(scores.shape) != (LONG_TRAIN_BATCH, LONG_TOPK):
        raise AssertionError(f"phase 23: NMS rows {tuple(scores.shape)}")
    log(f"phase 23: long rows.  NMS rows {tuple(scores.shape)} from a random-init forward at "
        f"pre_nms_topk {LONG_TOPK}; the shared-memory path takes up to {k1_max} boxes a row")
    err = compare_kernel(boxes, scores, thr, max_out, path=3, what="long rows, sorted")
    rank = nms_cuda.greedy_nms_rank(boxes, scores, thr, max_out)
    tiles = nms_cuda.LAST_TILES.clone()
    if not torch.equal(rank, nms_cuda.greedy_nms_rank(boxes, scores, thr, max_out)):
        raise AssertionError("phase 23: two runs of the long-row NMS differ")
    b1, s1 = boxes[:1].contiguous(), scores[:1].contiguous()
    err = max(err, compare_kernel(b1, s1, thr, max_out, path=3, what="one long row (K2)"))
    for n, code in ((k1_max, 1), (k1_max + 1, 3)):
        err = max(err, compare_kernel(boxes[:2, :n].contiguous(), scores[:2, :n].contiguous(),
                                      thr, max_out, path=code, what="at the shared-memory limit"))
    bu, su, pos = shuffle_rows(b1, s1, SEED + 23)
    err = max(err, compare_kernel(bu, su, thr, max_out, path=2, what="a long row shuffled"))
    if not torch.equal(torch.gather(nms_cuda.greedy_nms_rank(bu, su, thr, max_out), 1, pos),
                       rank[:1]):
        raise AssertionError("phase 23: the shuffled long row keeps other boxes")
    b_nan = b1.clone()
    b_nan[0, 3, 0] = float("nan")
    b_nan[0, 40, 3] = float("nan")
    err = max(err, compare_kernel(b_nan, s1, thr, max_out, path=3, what="NaN x1 and y2, sorted"))
    bn, sn, _ = shuffle_rows(b_nan, s1, SEED + 24)
    err = max(err, compare_kernel(bn, sn, thr, max_out, path=2, what="NaN x1 and y2, shuffled"))
    # The JAX kernel's longest row: rows 0 and 1 end to end, the first
    # 56,064 in stable score order.
    order = torch.sort(scores[:2].reshape(1, -1), dim=1, descending=True,
                       stable=True).indices[:, :JAX_NMS_ROW]
    bj = torch.gather(boxes[:2].reshape(1, -1, 4), 1, order[..., None].expand(-1, -1, 4))
    sj = torch.gather(scores[:2].reshape(1, -1), 1, order)
    err = max(err, compare_kernel(bj.contiguous(), sj.contiguous(), thr, max_out, path=3,
                                  what="the JAX kernel's longest row"))

    greedy = nms_cuda.greedy_nms_rank
    ms = {"K1": cuda_ms(lambda: greedy(boxes, scores, thr, max_out), 10),
          "K2": cuda_ms(lambda: greedy(b1, s1, thr, max_out), 20)}
    jax_row_ms = cuda_ms(lambda: greedy(bj, sj, thr, max_out), 5)
    kept = (rank >= 0).sum(dim=1)
    steps, pairs, _ = selection_work(boxes, scores, scores > 0.0, thr, max_out, False)
    if not torch.equal(steps, kept):
        raise AssertionError("phase 23: the replay of the NMS selection counts other steps")
    n_rows, n = scores.shape
    pair_ops = IOU_OPS + TEST_OPS + ARGMAX_OPS
    bounds = {"K1": bound(n_rows * n * 24, int(pairs.sum()) * pair_ops, PEAK_F32),
              "K2": bound(n * 24, int(pairs[0]) * pair_ops, PEAK_F32)}
    log(f"phase 23: NMS long-row path (tile scan from scratch) at ({n_rows}, {n}, {max_out}): "
        f"{ms['K1']:.4f} ms, bound "
        f"{bounds['K1'][0]:.5f} ms by {bounds['K1'][1]}; at (1, {n}): {ms['K2']:.4f} "
        f"ms, bound {bounds['K2'][0]:.5f} ms; the tile scan at (1, "
        f"{JAX_NMS_ROW}) {jax_row_ms:.4f} ms; {int(kept.min())}..{int(kept.max())} kept, at most "
        f"{int(tiles.max())} tiles a row ({smi})")
    res = {"err": err, "jax_row_ms": jax_row_ms, "shape": [n_rows, n, max_out]}
    for k in ("K1", "K2"):
        res[k] = {"ms": ms[k], "bound_ms": bounds[k][0], "bound_by": bounds[k][1]}
    res["K1"]["tiles"], res["K2"]["tiles"] = int(tiles.max()), int(tiles[0])
    return det, res


def phase23_vote(cfg, dev, smi):
    """K7 / K8's long-row path against the plain version on seeded edge rows:
    both sides of the shared-memory limit, 4 rows of 8,000 and 4 of 29,440
    (K7), one of 8,000 (K8); the kernel's times and their bounds from the
    replay."""
    thr, max_out = cfg.postprocess.vote_iou_threshold, cfg.postprocess.max_detections
    vmax = bbox_vote_cuda.build().bbox_vote_shared_max_rows()
    rng = np.random.default_rng(SEED + 230)
    err = 0.0
    log(f"phase 23: vote rows; the shared-memory path takes up to {vmax} a row")

    def dev_rows(n, pick):
        bx, sc, va = vote_edge_rows(rng, n)
        return tuple(torch.from_numpy(np.ascontiguousarray(a[pick])).to(dev)
                     for a in (bx, sc, va))

    def path_is(code, what):
        if bbox_vote_cuda.LAST_PATH != code:
            raise AssertionError(f"phase 23: the vote on {what} took path "
                                 f"{bbox_vote_cuda.LAST_PATH}, expected {code}")

    for n, code in ((vmax, bbox_vote_cuda.SHARED), (vmax + 1, bbox_vote_cuda.LONG_ROW)):
        err = max(err, compare_vote(*dev_rows(n, slice(None)), thr, max_out,
                                    "the 7 edge rows at the shared-memory limit"))
        path_is(code, f"rows of {n}")
    res = {}
    pair_ops = IOU_OPS + TEST_OPS + ARGMAX_OPS
    for n in LONG_VOTE_ROWS:
        b, s, v = dev_rows(n, [0, 2, 3, 5])
        cases = [("K7", (b, s, v))]
        if n == LONG_VOTE_ROWS[0]:
            cases.append(("K8", (b[:1].contiguous(), s[:1].contiguous(), v[:1].contiguous())))
        for name, args in cases:
            err = max(err, compare_vote(*args, thr, max_out, f"long rows ({name})"))
            path_is(bbox_vote_cuda.LONG_ROW, f"{tuple(args[1].shape)}")
            t = cuda_ms(lambda: bbox_vote_cuda.bbox_vote_batched_cuda(*args, thr, max_out), 10)
            out = bbox_vote_cuda.bbox_vote_batched_cuda(*args, thr, max_out)
            tiles = bbox_vote_cuda.LAST_TILES.cpu()
            steps, pairs, merged = selection_work(args[0], args[1], args[2] & (args[1] > 0.0),
                                                  thr, max_out, True)
            if not torch.equal(steps, out.valid.sum(dim=1)):
                raise AssertionError("phase 23: the replay of the vote counts other steps")
            rows, r = args[1].shape
            ops = int((pairs * pair_ops + merged * MERGE_OPS).sum())
            bd = bound(rows * 21 * (r + max_out), ops, PEAK_F32)
            log(f"phase 23: vote long-row path ({name}) at ({rows}, {r}, {max_out}): "
                f"{t:.4f} ms, bound {bd[0]:.5f} ms by "
                f"{bd[1]} ({int(pairs.sum())} IoU pairs, {int(merged.sum())} merges); tiles a "
                f"row {int(tiles.min())}..{int(tiles.max())}, outputs "
                f"{int(steps.min())}..{int(steps.max())} ({smi})")
            res.setdefault(name, []).append(
                {"shape": [rows, r, max_out], "ms": t, "bound_ms": bd[0], "bound_by": bd[1],
                 "tiles": int(tiles.max())})
    res["err"] = err
    return res


def long_gt_batch(size, rng):
    """(4, 1024) seeded gts on a size x size image: image 0 has 700 valid gts
    in random slots, gt 600 a copy of gt 5 (ties between the chunks);
    image 1 every slot valid; image 2 none; image 3 100
    valid gts, all in slots past 512.  -> boxes, mask (numpy)."""
    def faces(k):
        xy = rng.uniform(0, size - 16, (k, 2))
        return np.concatenate([xy, np.minimum(xy + rng.uniform(6, 120, (k, 2)), size)], -1)

    boxes = np.zeros((4, LONG_GT, 4), np.float32)
    mask = np.zeros((4, LONG_GT), bool)
    slots = np.union1d(rng.choice(LONG_GT, LONG_FACES - 1, replace=False), [5])[:LONG_FACES]
    boxes[0, slots], mask[0, slots] = faces(len(slots)), True
    boxes[0, 600], mask[0, 600] = boxes[0, 5], True
    boxes[1], mask[1] = faces(LONG_GT), True
    late = rng.choice(np.arange(512, LONG_GT), 100, replace=False)
    boxes[3, late], mask[3, late] = faces(100), True
    return boxes, mask


def phase23_matcher(cfg, dev, smi):
    """The matcher at G = 1,024 (several chunks of gts) against the plain
    version on long_gt_batch, and at G = 512 / 513 either side of one
    chunk; two runs bit-identical; the call's time and its bounds."""
    size = cfg.preprocess.train_image_size
    anchors = generate_anchors(cfg.anchors, size, size, dev)
    mcfg = dataclasses.replace(cfg.match, max_gt=LONG_GT)
    boxes, mask = (torch.from_numpy(a).to(dev)
                   for a in long_gt_batch(size, np.random.default_rng(SEED + 231)))
    margs = (anchors, boxes, mask, mcfg, cfg.anchors)
    got = compare_matcher(margs, "long_gt_batch (700 / 1,024 / 0 / 100 valid gts)", "phase 23")
    if matching_cuda.LAST_PATH != matching_cuda.LONG_ROW:
        raise AssertionError("phase 23: the matcher at G = 1,024 took one chunk")
    if not all(same_bits(a, b) for a, b in zip(got, matching_cuda.match_anchors_cuda(*margs))):
        raise AssertionError("phase 23: two runs of the matcher differ")
    chunk = matching_cuda.build().match_chunk_gts()
    for g_n, code in ((chunk, matching_cuda.SHARED), (chunk + 1, matching_cuda.LONG_ROW)):
        compare_matcher((anchors, boxes[:2, :g_n].contiguous(), mask[:2, :g_n].contiguous(),
                         mcfg, cfg.anchors), f"G = {g_n}", "phase 23")
        if matching_cuda.LAST_PATH != code:
            raise AssertionError(f"phase 23: the matcher at G = {g_n} took path "
                                 f"{matching_cuda.LAST_PATH}")
    t = cuda_ms(lambda: matching_cuda.match_anchors_cuda(*margs), 20)
    # Bounds as phase 11 counts them, pass by pass.
    bsz, n_anchor = boxes.shape[0], anchors.shape[0]
    pair_ops = 14 * n_anchor * int(mask.sum())
    bounds = {
        "matcher pass 1": bound(nbytes(anchors, boxes, mask) + bsz * n_anchor * 8
                                + 16 * mask.numel(), pair_ops, PEAK_F32),
        "matcher pass 2": bound(nbytes(anchors, boxes, mask) + 16 * mask.numel()
                                + bsz * n_anchor * 24, pair_ops, PEAK_F32)}
    log(f"phase 23: matcher call at B={bsz} A={n_anchor} G={LONG_GT} ({int(mask.sum())} valid "
        f"gts, {-(-LONG_GT // chunk)} chunks of {chunk}): {t:.4f} ms; bounds " + ", ".join(
            f"{k} {v[0]:.5f} ms by {v[1]}" for k, v in bounds.items()) + f" ({smi})")
    return {"shape": [bsz, n_anchor, LONG_GT], "ms": t, "bounds": bounds,
            "valid_gts": int(mask.sum())}


def phase23_detect(det, cfg, smi):
    """detect_batch of 8 WIDER-sized images and detect() of one at
    pre_nms_topk 34,125, counted: every NMS row must take the long-row tile
    scan.  -> {'K1': launches, 'K2': launches}."""
    post = det.config.postprocess
    rng = np.random.default_rng(SEED + 232)
    reqs = [rng.integers(0, 255, hw + (3,), dtype=np.uint8) for hw in TTA_SIZES]
    nms_cuda.LAUNCHES = 0
    with launch_batches() as seen:
        t0 = time.perf_counter()
        dets = det.detect_batch(reqs)
        one = det.detect(reqs[0])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    check_dets(dets + [one], reqs + reqs[:1], post.max_detections)
    rows = torch.cat([p for _, p in seen["nms"]])
    launches = {"K1": sum(r > 1 for r, _ in seen["nms"]), "K2": sum(r == 1 for r, _ in seen["nms"])}
    log(f"phase 23: detect_batch of {len(reqs)} images {list(TTA_SIZES)} and detect() at "
        f"pre_nms_topk {post.pre_nms_topk}: {[len(d['scores']) for d in dets]} and "
        f"{len(one['scores'])} detections in {secs:.2f} s (host clock, first calls); NMS paths "
        f"{rows.tolist()}; launches {launches} ({smi})")
    if nms_cuda.LAUNCHES != 2 or launches != {"K1": 1, "K2": 1} or not bool(
            (rows == (nms_cuda.TILE_SCAN | nms_cuda.LONG_ROW)).all()):
        raise AssertionError("phase 23: detect at pre_nms_topk 34,125 did not launch K1 and K2 "
                             "once each on the long-row tile scan")
    return launches


def phase23_tta(cfg, dev, smi):
    """detect_tta and run_dataset (detect_tta_dataset) on 16 WIDER-shaped
    images at max_detections 1,000: vote rows of max_variants x 1,000, every
    vote launch on the long-row path and its rows held against the plain
    version, counters against last_run_stats, a second run bit-identical.
    -> {'K1': ..., 'K7': ..., 'K8': ..., 'err': ...}."""
    tcfg = post_config(cfg, max_detections=LONG_MAX_DET)
    post = tcfg.postprocess
    det = Detector.from_random(SEED, tcfg, dev)
    runner = det._tta_runner = RecordingRunner(det.model, tcfg, device=dev)
    items = profile_tool.tta_images(LONG_TTA_IMAGES)
    keyed = [(k, im) for k, im, _ in items]
    want_stats, _ = expected_stats(items, runner, 16, 128)
    vmax = bbox_vote_cuda.build().bbox_vote_shared_max_rows()
    if runner.vote_rows() <= vmax:
        raise AssertionError(f"phase 23: {runner.vote_rows()} vote rows fit in shared memory")
    det.warmup_tta([im.shape[:2] for _, im in keyed])
    for lst in (runner.vote_inputs, runner.vote_tiles, runner.nms_paths, runner.vote_paths):
        lst.clear()
    nms_cuda.LAUNCHES = bbox_vote_cuda.LAUNCHES = 0
    with launch_batches() as seen:
        t0 = time.perf_counter()
        one = det.detect_tta(keyed[0][1])
        got = det.detect_tta_dataset(keyed)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    stats = dict(runner.last_run_stats)
    launches = {"K1": sum(r > 1 for r, _ in seen["nms"]), "K2": sum(r == 1 for r, _ in seen["nms"]),
                "K7": sum(r > 1 for r, _ in seen["vote"]),
                "K8": sum(r == 1 for r, _ in seen["vote"])}
    log(f"phase 23: TTA at max_detections {LONG_MAX_DET} ({runner.vote_rows()} vote rows an "
        f"image): detect_tta of one image + detect_tta_dataset of {len(keyed)} in {secs:.2f} s "
        f"(host clock, after warmup_tta); stats {stats}; launches {launches}; vote paths "
        f"{runner.vote_paths} ({smi})")
    if stats != want_stats or bbox_vote_cuda.LAUNCHES != 1 + stats["vote_launches"] or (
            nms_cuda.LAUNCHES != len(runner.nms_paths)):
        raise AssertionError(f"phase 23: stats {stats} (planned {want_stats}), vote launches "
                             f"{bbox_vote_cuda.LAUNCHES}")
    if runner.vote_paths != [bbox_vote_cuda.LONG_ROW] * len(runner.vote_paths) or not bool(
            (torch.cat(runner.nms_paths) == nms_cuda.TILE_SCAN).all()):
        raise AssertionError("phase 23: a vote launch left the long-row path, or an NMS row "
                             "left the shared-memory tile scan")
    for t, a in runner.vote_tiles:
        check_tiles(t, a, "the TTA run at max_detections 1,000")
    check_dets([one] + [got[k] for k, _ in keyed], [keyed[0][1]] + [im for _, im in keyed],
               post.max_detections)
    same = lambda a, b: (np.array_equal(a["bboxes"], b["bboxes"])  # noqa: E731
                         and np.array_equal(a["scores"], b["scores"]))
    again = det.detect_tta_dataset(keyed)
    if not all(same(got[k], again[k]) for k in got):
        raise AssertionError("phase 23: a second dataset run differs")
    n_det = [len(got[k]["scores"]) for k, _ in keyed]
    err = 0.0
    for vi in runner.vote_inputs[:2]:
        b, s, v = (torch.from_numpy(a).to(dev) for a in vi[:3])
        err = max(err, compare_vote(b, s, v, post.vote_iou_threshold, post.max_detections,
                                    "the TTA run's vote rows"))
    log(f"  detections an image {min(n_det)}..{max(n_det)}; a second dataset run bit-identical")
    launches["err"] = err
    return launches


def phase23_train(cfg, dev, smi):
    """Two train steps at batch 8, 640x640, max_gt 1,024, image 0 from
    synthetic_sample(n_faces=700): the matcher must see > 512 valid gts in
    one image and take several chunks; its targets on the batch held
    against the plain version.  -> matcher calls."""
    tcfg = train_config(cfg)
    tcfg = dataclasses.replace(
        tcfg, match=dataclasses.replace(tcfg.match, max_gt=LONG_GT),
        train=dataclasses.replace(tcfg.train, batch_size=LONG_TRAIN_BATCH))
    batch = synthetic_batch(tcfg, LONG_TRAIN_BATCH, seed=SEED + 23)
    img, bx, mk = synthetic_sample(np.random.default_rng(SEED + 233),
                                   tcfg.preprocess.canvas_size, LONG_GT, n_faces=LONG_FACES)
    batch["canvas"][0], batch["boxes"][0], batch["mask"][0] = img, bx, mk
    size = tcfg.preprocess.train_image_size
    _, pb, pm = preprocessed(batch, tcfg, dev)
    compare_matcher((generate_anchors(tcfg.anchors, size, size, dev), pb, pm, tcfg.match,
                     tcfg.anchors), "the 700-face train batch", "phase 23")
    seen = []
    call = matching_cuda.match_anchors_cuda

    def spy(anchors, gt_boxes, gt_mask, *args):
        seen.append(gt_mask.sum(dim=1).tolist())
        return call(anchors, gt_boxes, gt_mask, *args)

    state = create_train_state(tcfg, SEED, dev)
    for mod, _, _ in TRAIN_KERNELS.values():
        mod.LAUNCHES = 0
    matching_cuda.match_anchors_cuda = spy
    try:
        t0 = time.perf_counter()
        losses = [float(train_step(state, batch)["loss"]) for _ in range(2)]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        matching_cuda.match_anchors_cuda = call
    launches = {name: mod.LAUNCHES for name, (mod, _, _) in TRAIN_KERNELS.items()}
    log(f"phase 23: 2 train steps at batch {LONG_TRAIN_BATCH}, {size}x{size}, max_gt {LONG_GT}: "
        f"loss {losses}, {secs:.2f} s (host clock, first steps); valid gts the matcher saw a "
        f"call {seen}; launches {launches}; matcher path {matching_cuda.LAST_PATH} ({smi})")
    if not (np.isfinite(losses).all() and train_launches_ok(launches, 2) and len(seen) == 2
            and all(max(c) > 512 for c in seen)
            and matching_cuda.LAST_PATH == matching_cuda.LONG_ROW):
        raise AssertionError("phase 23: the long-gt train steps are not finite, launched other "
                             "counts, or no image reached the matcher with > 512 valid gts")
    return launches["matcher"]


def phase23(cfg, dev, smi):
    """Long rows: each long-row path against its plain version, then each
    through its entry points at full width."""
    t0 = time.perf_counter()
    det, nms = phase23_nms(cfg, dev, smi)
    vote = phase23_vote(cfg, dev, smi)
    matcher = phase23_matcher(cfg, dev, smi)
    torch.cuda.empty_cache()
    nms["launches"] = phase23_detect(det, cfg, smi)
    del det
    torch.cuda.empty_cache()
    tta = phase23_tta(cfg, dev, smi)
    torch.cuda.empty_cache()
    matcher["launches"] = phase23_train(cfg, dev, smi)
    log(f"phase 23: {time.perf_counter() - t0:.1f} s")
    return {"nms": nms, "vote": vote, "matcher": matcher, "tta": tta}


def seeded_biases(model, seed):
    """Every bias of `model` drawn from the seed, its first three set to
    BIAS_ACT_BIASES (a bf16 tie at 1.0, -0 and +0)."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.1)
                p[:3] = torch.tensor(BIAS_ACT_BIASES[: p.shape[0]], device=dev)


def pixel_rows(y):
    """The (pixels, C) view of the pass's buffer."""
    c = bias_act_cuda.channels(y)
    return (y.permute(0, 2, 3, 1) if y.dim() == 4 else y).reshape(-1, c)


def aten_bias_act(y, bias, relu):
    """What ATen runs after cuDNN's convolution: `out.add_(b)`, then F.relu."""
    c = bias_act_cuda.channels(y)
    y.add_(bias.to(y.dtype).reshape((c, 1, 1) if y.dim() == 4 else (c,)))
    return torch.nn.functional.relu(y) if relu else y


@contextlib.contextmanager
def checked_bias_act(calls):
    """Each call of the pass, checked where it runs: specials written into
    the first and last pixel, the kernel against ATen's add-then-clamp and
    the plain version on copies, bit for bit; appends (shape, dtype, bias,
    relu) to `calls`."""
    real = bias_act_cuda.bias_act

    def check(y, bias, relu):
        rows = pixel_rows(y)
        spec = torch.tensor(BIAS_ACT_SPECIALS, dtype=y.dtype, device=y.device)
        row = spec[torch.arange(rows.shape[1], device=y.device) % len(spec)]
        rows[0], rows[-1] = row, row.flip(0)
        want = aten_bias_act(y.clone(), bias, relu)
        plain = bias_act_cuda.bias_act_plain(y, bias, relu)
        got = real(y, bias, relu)
        as_int = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
        for other, what in ((want, "ATen's add-then-clamp"), (plain, "the plain version")):
            if not same_bits(got, other):
                bad = int((got.view(as_int) != other.view(as_int)).sum())
                raise AssertionError(f"phase 24: bias_act != {what} at {tuple(y.shape)} "
                                     f"{y.dtype} relu={relu}: {bad} elements differ")
        calls.append((tuple(y.shape), y.dtype, bias.clone(), relu))
        del want, plain
        return got

    bias_act_cuda.bias_act = check
    try:
        yield calls
    finally:
        bias_act_cuda.bias_act = real


def bias_act_edge_cases(dev):
    """The kernel against ATen's add-then-clamp off the forward's shapes:
    bf16 and float32, widths 6 (one value a thread), 8, 64, 256 and 1,000
    (a grid of 125 packs a pixel), channels-last and flat (pixels, C), a
    view one value off 16 bytes (one value a thread), with and without
    relu, the bias in float32 and in y's dtype, specials in the first and
    last pixel.  -> the number of cases."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 124)
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for c in (6, 8, 64, 256, 1000):
            for layout in ("nchw", "flat", "offset"):
                for relu in (True, False):
                    for b_dtype in (torch.float32, dtype):
                        base = torch.randn(37 * c + 1, generator=gen, device=dev).to(dtype)
                        if layout == "nchw":
                            y = base[: 35 * c].view(1, 7, 5, c).permute(0, 3, 1, 2)
                        elif layout == "flat":
                            y = base[: 37 * c].view(37, c)
                        else:
                            y = base[1:].view(37, c)
                        bias = (torch.randn(c, generator=gen, device=dev) * 3).to(b_dtype)
                        bias[:3] = torch.tensor(BIAS_ACT_BIASES, device=dev)
                        rows = pixel_rows(y)
                        spec = torch.tensor(BIAS_ACT_SPECIALS, dtype=dtype, device=dev)
                        row = spec[torch.arange(c, device=dev) % len(spec)]
                        rows[0], rows[-1] = row, row.flip(0)
                        want = aten_bias_act(y.clone(), bias, relu)
                        got = bias_act_cuda.bias_act(y, bias, relu)
                        if not same_bits(got, want):
                            raise AssertionError(
                                f"phase 24: bias_act != ATen at {layout} {tuple(y.shape)} "
                                f"{dtype} bias {b_dtype} relu={relu}")
                        n += 1
    return n


def time_bias_act(calls):
    """Each call's shape timed alone (CUDA events): the kernel and ATen's
    add + clamp, summed; and the bound."""
    out = {"ms": 0.0, "aten_ms": 0.0, "bound_ms": 0.0}
    gen = torch.Generator(device=calls[0][2].device).manual_seed(SEED)
    for shape, dtype, bias, relu in calls:
        buf = torch.empty(shape, dtype=dtype, device=bias.device,
                          memory_format=torch.channels_last if len(shape) == 4
                          else torch.contiguous_format)
        buf.normal_(generator=gen)
        fns = {"ms": (lambda: bias_act_cuda.bias_act(buf, bias, relu), 5),
               "aten_ms": (lambda: aten_bias_act(buf, bias, relu), 3)}
        for key, (fn, iters) in fns.items():
            fn()
            torch.cuda.synchronize()
            out[key] += cuda_ms(fn, iters)
        out["bound_ms"] += 2 * nbytes(buf) / PEAK_BYTES * 1e3
        del buf
    torch.cuda.empty_cache()
    return out


def aten_residual(y, bias, r):
    """What ATen runs for a bottleneck's close: `out.add_(b)`, `+ r`, F.relu."""
    return torch.nn.functional.relu(aten_bias_act(y, bias, False) + r)


def residual_case(y, r, bias, what):
    """Specials in the first and last pixel of y and r, then the residual
    kernel against ATen's add, add and clamp and the plain version, bit for
    bit; -> the kernel's output."""
    spec = torch.tensor(BIAS_ACT_SPECIALS, dtype=y.dtype, device=y.device)
    for t, flip in ((y, False), (r, True)):
        rows = pixel_rows(t)
        row = spec[torch.arange(rows.shape[1], device=y.device) % len(spec)]
        row = row.flip(0) if flip else row
        rows[0], rows[-1] = row, row.roll(3)
    want = aten_residual(y.clone(), bias, r)
    plain = bias_act_cuda.bias_residual_relu_plain(y, bias, r)
    got = bias_act_cuda.bias_residual_relu(y, bias, r)
    for other, name in ((want, "ATen's add, add and clamp"), (plain, "the plain version")):
        if not same_bits(got, other):
            raise AssertionError(f"phase 24: the residual pass != {name} at {what}")
    return got


def residual_edge_cases(dev):
    """The residual kernel off the forward's shapes: bf16 and float32,
    widths 6, 8, 64 and 1,000, channels-last and flat, y and r one value off
    16 bytes, the bias in float32 and in y's dtype.  -> the number of cases."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 224)
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for c in (6, 8, 64, 1000):
            for layout in ("nchw", "flat", "offset"):
                for b_dtype in (torch.float32, dtype):
                    y, r = (torch.randn(37 * c + 1, generator=gen, device=dev).to(dtype) * 2
                            for _ in range(2))
                    if layout == "nchw":
                        y, r = (t[: 35 * c].view(1, 7, 5, c).permute(0, 3, 1, 2) for t in (y, r))
                    elif layout == "flat":
                        y, r = (t[: 37 * c].view(37, c) for t in (y, r))
                    else:
                        y, r = (t[1:].view(37, c) for t in (y, r))
                    bias = (torch.randn(c, generator=gen, device=dev) * 3).to(b_dtype)
                    bias[:3] = torch.tensor(BIAS_ACT_BIASES, device=dev)
                    residual_case(y, r, bias, f"{layout} {tuple(y.shape)} {dtype} bias {b_dtype}")
                    n += 1
    return n


def phase24_retinaface(dev, smi):
    """RetinaFace-R50's forward at batch 128, 840x840: its launches of the
    two passes counted; the residual pass at each of the 16 bottleneck
    shapes bit for bit against ATen and the plain version, then timed beside
    ATen's three passes and the bound (3 accesses a value)."""
    rcfg = RetinaFaceConfig()
    det = Detector.from_random(SEED, rcfg, dev)
    seeded_biases(det.model, SEED + 25)
    x = torch.randn((BATCH, RETINAFACE_SIZE, RETINAFACE_SIZE, 3), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(SEED + 25)) * 60
    counts = {}
    with torch.inference_mode():
        det.model(x)
        torch.cuda.synchronize()
        before = (bias_act_cuda.LAUNCHES, bias_act_cuda.RESIDUAL_LAUNCHES, l2norm_cuda.LAUNCHES,
                  lfpn_fuse_cuda.LAUNCHES)
        det.model(x)
        torch.cuda.synchronize()
        counts = {"bias_act": bias_act_cuda.LAUNCHES - before[0],
                  "residual": bias_act_cuda.RESIDUAL_LAUNCHES - before[1]}
        off = {"l2norm": l2norm_cuda.LAUNCHES - before[2],
               "lfpn_fuse": lfpn_fuse_cuda.LAUNCHES - before[3]}
    del det, x
    torch.cuda.empty_cache()
    if counts != RETINAFACE_PASSES:
        raise AssertionError(f"phase 24: a RetinaFace forward launched {counts}, expected "
                             f"{RETINAFACE_PASSES}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    t = {"ms": 0.0, "aten_ms": 0.0, "bound_ms": 0.0}
    shapes = resnet.bottleneck_shapes(rcfg.model, RETINAFACE_SIZE)
    for c, h, w in shapes:
        y, r = (torch.empty((BATCH, c, h, w), dtype=torch.bfloat16, device=dev,
                            memory_format=torch.channels_last).normal_(generator=gen)
                for _ in range(2))
        bias = torch.randn(c, generator=gen, device=dev) * 0.1
        bias[:3] = torch.tensor(BIAS_ACT_BIASES, device=dev)
        residual_case(y, r, bias, f"{(BATCH, c, h, w)}")
        fns = {"ms": (lambda: bias_act_cuda.bias_residual_relu(y, bias, r), 5),
               "aten_ms": (lambda: aten_residual(y, bias, r), 3)}
        for key, (fn, iters) in fns.items():
            fn()
            torch.cuda.synchronize()
            t[key] += cuda_ms(fn, iters)
        t["bound_ms"] += 3 * nbytes(y) / PEAK_BYTES * 1e3
        del y, r
        torch.cuda.empty_cache()
    log(f"phase 24: RetinaFace-R50 forward at batch {BATCH}, {RETINAFACE_SIZE}x{RETINAFACE_SIZE}: "
        f"{counts} launches; the residual pass at its {len(shapes)} bottleneck shapes bit for bit "
        f"equal to ATen's add, add and clamp and the plain version (NaN, -0, +0, +-inf, bf16 "
        f"ties in the first and last pixel of y and r); summed (CUDA events): kernel "
        f"{t['ms']:.4f} ms, ATen {t['aten_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ms (3 accesses a value); bound/kernel "
        f"{t['bound_ms'] / t['ms']:.1%}; {smi}")
    return {"launches": dict(counts, **off), **t}


def ulps_apart(a, b):
    """|a - b| element by element in units in the last place of their
    dtype (int64), 0 where both are NaN, -1 where one alone is."""
    bits, mag = (torch.int16, 0x7FFF) if a.dtype == torch.bfloat16 else (torch.int32, 0x7FFFFFFF)

    def key(t):
        i = t.view(bits).to(torch.int64)
        return torch.where(i < 0, -(i & mag), i)

    d = (key(a) - key(b)).abs()
    na, nb = a.isnan(), b.isnan()
    d = torch.where(na & nb, 0, d)
    return torch.where(na ^ nb, -1, d)


def l2norm_twice(x, scale, what):
    """Two launches of the kernel on x: bit for bit the same, x's dtype and
    layout; -> the output."""
    got = l2norm_cuda.l2norm(x, scale, L2NORM_EPS)
    if got.dtype != x.dtype or not got.is_contiguous(memory_format=torch.channels_last):
        raise AssertionError(f"phase 24: l2norm gave {got.dtype} {got.stride()} for {what}")
    if not same_bits(got, l2norm_cuda.l2norm(x, scale, L2NORM_EPS)):
        raise AssertionError(f"phase 24: l2norm differs from launch to launch at {what}")
    return got


def l2norm_ulps(got, want, what, exact=False):
    """The kernel's output against ATen's: NaN where ATen's is, every
    element within L2NORM_ULPS (0 where `exact`); -> the ulps (int64)."""
    u = ulps_apart(got, want)
    limit = 0 if exact else L2NORM_ULPS[got.dtype]
    if bool((u < 0).any()) or int(u.max()) > limit:
        raise AssertionError(f"phase 24: l2norm != ATen's expression at {what}: "
                             f"{int((u < 0).sum())} NaNs apart, up to {int(u.max())} ulps "
                             f"(limit {limit})")
    return u


def l2norm_edge_cases(dev):
    """The kernel against ATen's expression off the forward's shapes: bf16
    and float32; widths 6 (the scalar path), 8 and 24 (groups of fewer lanes
    than a warp), 256 and 512 (the taps'), 1,000 (packs past the pixel's
    masked) and 4,096 (past the registers: the scalar path); a fresh
    channels-last tensor and a view one value off 16 bytes (the scalar
    path); pixels 0-6 NaN, +inf, -inf, all zero, one value 3, values of
    1e-20 (subnormal squares) and of 1e30 (squares that overflow), the rest
    normal: NaN where ATen's is, every element within L2NORM_ULPS, pixels
    0-4 and 6 bit for bit.  Then one nonzero value a pixel over 60 decades,
    at C = 1 (scalar) and 8 (vector) in float32: sums that are exact in any
    order, so every bit must be ATen's, rsqrt included.  -> the number of
    cases."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 324)
    n = 0
    for dtype in (torch.bfloat16, torch.float32):
        for c in (6, 8, 24, 256, 512, 1000, 4096):
            for layout in ("fresh", "offset"):
                v = torch.randn((37, c), generator=gen, device=dev) * 3
                v[0, c // 2] = float("nan")
                v[1, 0] = float("inf")
                v[2, -1] = -float("inf")
                v[3] = 0.0
                v[4] = 0.0
                v[4, 1 % c] = 3.0
                v[5] *= 1e-20
                v[6] *= 1e30
                buf = torch.empty(37 * c + 1, dtype=dtype, device=dev)
                flat = buf[1:] if layout == "offset" else buf[: 37 * c]
                flat.copy_(v.reshape(-1))
                x = flat.view(1, 37, 1, c).permute(0, 3, 1, 2)
                scale = torch.rand(c, generator=gen, device=dev) * 10
                what = f"{layout} {tuple(x.shape)} {dtype}"
                got = l2norm_twice(x, scale, what)
                want = l2norm_cuda.l2norm_plain(x, scale, L2NORM_EPS)
                l2norm_ulps(got, want, what)
                for r in (0, 1, 2, 3, 4, 6):
                    l2norm_ulps(pixel_rows(got)[r], pixel_rows(want)[r], f"{what} pixel {r}",
                                exact=True)
                n += 1
    for c in (1, 8):
        v = torch.zeros((4096, c), device=dev)
        mag = 10.0 ** (torch.rand(4096, generator=gen, device=dev) * 60 - 30)
        v[torch.arange(4096, device=dev), torch.arange(4096, device=dev) % c] = (
            torch.randn(4096, generator=gen, device=dev) * mag)
        x = v.view(1, 64, 64, c).permute(0, 3, 1, 2)
        scale = torch.rand(c, generator=gen, device=dev) * 10
        what = f"one value a pixel {tuple(x.shape)}"
        l2norm_ulps(l2norm_twice(x, scale, what), l2norm_cuda.l2norm_plain(x, scale, L2NORM_EPS),
                    what, exact=True)
        n += 1
    return n


def l2norm_tap_shapes(cfg):
    """(C, H) of the three L2Norm taps at the configuration's size."""
    size = cfg.model.image_size
    return [(c, size // s) for c, s in zip(cfg.model.lfpn_channels, (4, 8, 16))]


def l2norm_taps(cfg, dev, smi):
    """The kernel at the three taps' shapes at batch 128 in bf16 and
    float32, on normal values: against ATen's expression (NaN nowhere,
    every element within L2NORM_ULPS, the share that differs), both against
    a float64 normalisation (relative L2; the kernel's no larger than
    ATen's, to 1 %: the two differ only in the order of one sum a pixel);
    on small integers at batch 8 (sums exact in any order) bit for bit;
    then, in bf16, each shape timed (CUDA events) beside ATen's six passes
    and the bound (each value read and written once).  -> the readings."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 325)
    shapes = l2norm_tap_shapes(cfg)
    res = {"ms": 0.0, "aten_ms": 0.0, "bound_ms": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        worst, differ, total, err, aten_err, ref_sq = 0, 0, 0, 0.0, 0.0, 0.0
        for c, h in shapes:
            what = f"{(BATCH, c, h, h)} {dtype}"
            x = torch.empty((BATCH, c, h, h), dtype=dtype, device=dev,
                            memory_format=torch.channels_last).normal_(generator=gen)
            scale = torch.rand(c, generator=gen, device=dev) * 10
            got = l2norm_twice(x, scale, what)
            s64 = scale.double()[:, None, None]
            for i in range(0, BATCH, 16):
                xs = x[i: i + 16]
                want = l2norm_cuda.l2norm_plain(xs, scale, L2NORM_EPS)
                u = l2norm_ulps(got[i: i + 16], want, what)
                worst, differ, total = max(worst, int(u.max())), differ + int((u > 0).sum()), \
                    total + u.numel()
                del u
                x64 = xs.double()
                ref = x64 * torch.rsqrt((x64 * x64).sum(dim=1, keepdim=True) + L2NORM_EPS) * s64
                err += float((got[i: i + 16].double() - ref).square().sum())
                aten_err += float((want.double() - ref).square().sum())
                ref_sq += float(ref.square().sum())
                del want, x64, ref
            xi = torch.randint(-8, 9, (8, h, h, c), generator=gen, device=dev).to(dtype)
            xi = xi.permute(0, 3, 1, 2)
            l2norm_ulps(l2norm_twice(xi, scale, f"integers {what}"),
                        l2norm_cuda.l2norm_plain(xi, scale, L2NORM_EPS), f"integers {what}",
                        exact=True)
            del xi, got
            if dtype == torch.bfloat16:
                fns = {"ms": (lambda: l2norm_cuda.l2norm(x, scale, L2NORM_EPS), 5),
                       "aten_ms": (lambda: l2norm_cuda.l2norm_plain(x, scale, L2NORM_EPS), 3)}
                for key, (fn, iters) in fns.items():
                    fn()
                    torch.cuda.synchronize()
                    res[key] += cuda_ms(fn, iters)
                res["bound_ms"] += 2 * nbytes(x) / PEAK_BYTES * 1e3
            del x
            torch.cuda.empty_cache()
        err, aten_err = (err / ref_sq) ** 0.5, (aten_err / ref_sq) ** 0.5
        if err > 1.01 * aten_err:
            raise AssertionError(f"phase 24: l2norm's error against float64 {err:.4e} exceeds "
                                 f"ATen's {aten_err:.4e} ({dtype})")
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        res[name] = {"max_ulps": worst, "share_differing": differ / total,
                     "rel_l2_f64": err, "aten_rel_l2_f64": aten_err}
        log(f"phase 24: l2norm at the taps {shapes} x batch {BATCH}, {dtype}: every element "
            f"within {worst} ulp of ATen's expression ({differ / total:.4%} of "
            f"{total} differ), NaN nowhere, two launches bit for bit; relative L2 against "
            f"float64 {err:.4e} (ATen {aten_err:.4e}); small integers bit for bit")
    log(f"phase 24: l2norm at the three taps, bf16, summed (CUDA events): kernel "
        f"{res['ms']:.4f} ms, ATen's six passes {res['aten_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms (each value read and written once); bound/kernel "
        f"{res['bound_ms'] / res['ms']:.1%}; {smi}")
    return res


def off_path_launches(det, dev):
    """Launches of the one-pass L2Norm and of the LFPN's fused upsample
    where neither may run: a recorded forward and backward at batch 2 (the
    train step's), a detect_tta of one image (the TTA runner's NCHW
    canvases).  -> {kernel: {path: launches}}."""
    counters = {"l2norm": l2norm_cuda, "lfpn_fuse": lfpn_fuse_cuda}
    out = {name: {} for name in counters}

    def counted_path(path, fn):
        before = {name: mod.LAUNCHES for name, mod in counters.items()}
        fn()
        torch.cuda.synchronize()
        for name, mod in counters.items():
            out[name][path] = mod.LAUNCHES - before[name]

    def train():
        cls, loc = det.model(torch.randn((2, 128, 128, 3), device=dev) * 50)
        (cls.float().sum() + loc.float().sum()).backward()
        det.model.zero_grad(set_to_none=True)

    counted_path("train", train)
    counted_path("tta", lambda: det.detect_tta(np.random.default_rng(SEED).integers(
        0, 255, (300, 400, 3), dtype=np.uint8)))
    return out


def lfpn_fuse_twice(td, lat, op, what):
    """Two launches of the kernel: bit for bit the same, lat's dtype and
    layout; -> the output."""
    got = lfpn_fuse_cuda.lfpn_fuse(td, lat, op)
    if (got.dtype != lat.dtype or got.shape != lat.shape
            or not got.is_contiguous(memory_format=torch.channels_last)):
        raise AssertionError(f"phase 24: lfpn_fuse gave {got.dtype} {tuple(got.shape)} "
                             f"{got.stride()} for {what}")
    if not same_bits(got, lfpn_fuse_cuda.lfpn_fuse(td, lat, op)):
        raise AssertionError(f"phase 24: lfpn_fuse differs from launch to launch at {what}")
    return got


def lfpn_fuse_check(got, want, what):
    """The kernel's output against ATen's upsample-then-op: bit for bit in
    bf16 and in float32 from LFPN_FUSE_NHWC_C channels; below, in float32,
    NaN and infinities where ATen's are and the rest within
    LFPN_FUSE_F32_RTOL of the largest value.  -> (differing values, ulps of
    the largest difference)."""
    u = ulps_apart(got, want)
    differ, worst = int((u != 0).sum()), int(u.max())
    if got.dtype == torch.bfloat16 or got.shape[1] >= LFPN_FUSE_NHWC_C:
        if not same_bits(got, want):
            raise AssertionError(f"phase 24: lfpn_fuse != ATen's upsample-then-op at {what}: "
                                 f"{differ} values differ, by up to {worst} ulps")
        return 0, 0
    finite = want.isfinite()
    inf_got, inf_want = (torch.where(t.isinf(), t, 0) for t in (got, want))
    diff, mag = (got - want).abs()[finite], want.abs()[finite]
    if (not torch.equal(got.isnan(), want.isnan()) or not torch.equal(inf_got, inf_want)
            or (diff.numel() and float(diff.max()) > LFPN_FUSE_F32_RTOL * float(mag.max()))):
        raise AssertionError(f"phase 24: lfpn_fuse is off ATen's NCHW upsample at {what}")
    return differ, worst


def lfpn_fuse_pair(shape, dtype, gen, dev, specials=False, offset=False):
    """A channels-last topdown (b, c, h, w) and lateral (b, c, H, W) of
    normal values times 3; with `specials`, NaN, +-inf and -0 at topdown's
    corners, edges and their neighbours and in lateral; with `offset`, both
    one value off 16 bytes (the kernel's one-value path)."""
    b, c, h, w, big_h, big_w = shape
    td = torch.randn((b, h, w, c), generator=gen, device=dev) * 3
    lat = torch.randn((b, big_h, big_w, c), generator=gen, device=dev) * 3
    if specials:
        td[0, 0, 0, 0] = float("nan")
        td[0, h - 1, w - 1, c - 1] = float("inf")
        td[-1, h // 2, 0, c // 2] = -float("inf")
        td[-1, 0, w // 2, 1 % c] = -0.0
        td[-1, h - 1, w // 2, 0] = float("nan")
        td[0, min(1, h - 1), min(1, w - 1), c - 1] = -float("inf")
        lat[0, big_h - 1, 0, 0] = float("inf")
        lat[-1, 0, big_w - 1, c - 1] = -0.0
        lat[-1, big_h // 2, big_w // 2, 0] = 0.0

    def placed(v):
        if not offset:
            return v.to(dtype).permute(0, 3, 1, 2)
        buf = torch.empty(v.numel() + 1, dtype=dtype, device=dev)
        buf[1:].copy_(v.reshape(-1))
        return buf[1:].view(v.shape).permute(0, 3, 1, 2)

    return placed(td), placed(lat)


def lfpn_fuse_edge_cases(dev):
    """The kernel against ATen's upsample-then-op off the forward's shapes,
    in bf16 and float32, under both ops: widths 1 and 6 (the one-value
    path), 8 (one pack), 16, 24, 256, 512, 1,000 and 1,024; even sizes and
    odd ones (the crop) in either direction, a 1 x 1 source; NaN, +-inf and
    -0 at the corners, the edges and beside them; a fresh tensor and one a
    value off 16 bytes.  -> (cases, float32 values below LFPN_FUSE_NHWC_C
    channels that differ, their largest distance in ulps)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 327)
    sizes = ((5, 4, 10, 8), (5, 4, 9, 7), (3, 6, 5, 12), (1, 1, 2, 1), (2, 3, 4, 6))
    n, differ, worst = 0, 0, 0
    for dtype in (torch.bfloat16, torch.float32):
        for op in lfpn_fuse_cuda.OPS:
            for c in (1, 6, 8, 16, 24, 256, 512, 1000, 1024):
                for h, w, big_h, big_w in sizes:
                    for specials, offset in ((False, False), (True, False), (True, True)):
                        shape = (3, c, h, w, big_h, big_w)
                        td, lat = lfpn_fuse_pair(shape, dtype, gen, dev, specials, offset)
                        what = (f"{shape} {dtype} {op} specials={specials} offset={offset}")
                        got = lfpn_fuse_twice(td, lat, op, what)
                        d, u = lfpn_fuse_check(got, lfpn_fuse_cuda.lfpn_fuse_plain(td, lat, op),
                                               what)
                        differ, worst, n = differ + d, max(worst, u), n + 1
    return n, differ, worst


def lfpn_fuse_shapes(cfg):
    """(C, h, w, H, W) of the LFPN's three blocks at the configuration's
    size, top-down: fc7 -> conv5_3, conv5_3 -> conv4_3, conv4_3 -> conv3_3."""
    size = cfg.model.image_size
    widths = dict(zip(("conv3_3", "conv4_3", "conv5_3"), cfg.model.lfpn_channels))
    out = []
    for lo, stride in (("conv5_3", 16), ("conv4_3", 8), ("conv3_3", 4)):
        big = -(-size // stride)
        small = -(-big // 2)
        out.append((widths[lo], small, small, big, big))
    return out


def lfpn_fuse_blocks(cfg, dev, smi):
    """The kernel at the LFPN's three shapes at batch 128: in bf16 under
    both ops and in float32 under the product, bit for bit against ATen's
    upsample-then-op, two launches bit for bit; then in bf16 under the
    product each shape timed in turns with ATen's two passes (CUDA events),
    beside the bound (top-down values read once, lateral values read once,
    fused values written once).  -> the readings."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 328)
    res = {"ms": 0.0, "aten_ms": 0.0, "bound_ms": 0.0, "shapes": lfpn_fuse_shapes(cfg)}
    for c, h, w, big_h, big_w in res["shapes"]:
        for dtype, ops in ((torch.bfloat16, lfpn_fuse_cuda.OPS), (torch.float32, ("product",))):
            td, lat = lfpn_fuse_pair((BATCH, c, h, w, big_h, big_w), dtype, gen, dev)
            td = td.contiguous(memory_format=torch.channels_last)
            lat = lat.contiguous(memory_format=torch.channels_last)
            for op in ops:
                what = f"{(BATCH, c, big_h, big_w)} {dtype} {op}"
                got = lfpn_fuse_twice(td, lat, op, what)
                lfpn_fuse_check(got, lfpn_fuse_cuda.lfpn_fuse_plain(td, lat, op), what)
                del got
            if dtype == torch.bfloat16:
                t = turns(lambda: lfpn_fuse_cuda.lfpn_fuse(td, lat, "product"),
                          lambda: lfpn_fuse_cuda.lfpn_fuse_plain(td, lat, "product"),
                          kernel_iters=10, library_iters=3)
                res["ms"] += t["kernel"]
                res["aten_ms"] += t["library"]
                res["bound_ms"] += (nbytes(td) + 2 * nbytes(lat)) / PEAK_BYTES * 1e3
            del td, lat
            torch.cuda.empty_cache()
    log(f"phase 24: lfpn_fuse at the LFPN's blocks {res['shapes']} x batch {BATCH}: bit for bit "
        f"equal to ATen's upsample-then-op (bf16 product and sum, float32 product), two "
        f"launches bit for bit; bf16 product, summed, in turns (CUDA events): kernel "
        f"{res['ms']:.4f} ms, ATen's two passes {res['aten_ms']:.4f} ms, bound "
        f"{res['bound_ms']:.4f} ms (bytes); bound/kernel {res['bound_ms'] / res['ms']:.1%}; {smi}")
    return res


def phase24(cfg, dev, smi):
    """The bias + ReLU pass: each call of a bf16 and an int8 forward at
    batch 128 checked bit for bit, its launches counted a forward, its time
    beside ATen's two passes and the bound; then its residual variant
    (phase24_retinaface) and the one-pass L2Norm."""
    t0 = time.perf_counter()
    log(f"phase 24: bias_act == ATen's add-then-clamp bit for bit in "
        f"{bias_act_edge_cases(dev)} edge cases")
    det = Detector.from_random(SEED, cfg, dev)
    seeded_biases(det.model, SEED + 24)
    rng = np.random.default_rng(SEED + 24)
    images = torch.from_numpy(rng.integers(0, 255, (BATCH, cfg.model.image_size,
                                                    cfg.model.image_size, 3),
                                           dtype=np.uint8)).to(dev)
    res = {"launches": {}, "l2norm_launches": {}, "lfpn_fuse_launches": {}}
    calls = {}
    with torch.inference_mode():
        x = normalize_image(images.float(), cfg.preprocess).to(compute_dtype(cfg.model))
        del images
        scales = calibrate_act_scales(det.model, [x[:8]], cfg.model)
        models = {"bf16": det.model,
                  "int8": QuantizedDetector(det.model, scales).to(dev).eval()}
        for which, model in models.items():
            with checked_bias_act([]) as calls[which]:
                model(x)
            torch.cuda.synchronize()
            before = bias_act_cuda.LAUNCHES, l2norm_cuda.LAUNCHES, lfpn_fuse_cuda.LAUNCHES
            model(x)
            torch.cuda.synchronize()
            n = bias_act_cuda.LAUNCHES - before[0]
            if n != BIAS_ACT_PER_FORWARD[which] or len(calls[which]) != n:
                raise AssertionError(f"phase 24: {which} forward launched bias_act {n} times "
                                     f"({len(calls[which])} calls checked), expected "
                                     f"{BIAS_ACT_PER_FORWARD[which]}")
            n_norm = l2norm_cuda.LAUNCHES - before[1]
            if n_norm != L2NORM_PER_FORWARD:
                raise AssertionError(f"phase 24: {which} forward launched l2norm {n_norm} times, "
                                     f"expected {L2NORM_PER_FORWARD}")
            n_fuse = lfpn_fuse_cuda.LAUNCHES - before[2]
            if n_fuse != LFPN_FUSE_PER_FORWARD:
                raise AssertionError(f"phase 24: {which} forward launched lfpn_fuse {n_fuse} "
                                     f"times, expected {LFPN_FUSE_PER_FORWARD}")
            res["launches"][which] = n
            res["l2norm_launches"][which] = n_norm
            res["lfpn_fuse_launches"][which] = n_fuse
            relus = sum(r for *_, r in calls[which])
            log(f"phase 24: {which} forward at batch {BATCH}: {n} calls of the pass ({relus} "
                f"with ReLU), each bit for bit equal to ATen's add-then-clamp and the plain "
                f"version with NaN, -0, +0, +-inf and bf16 ties in its first and last pixel")
        del models, x
    off = off_path_launches(det, dev)
    del det
    torch.cuda.empty_cache()
    for which in ("bf16", "int8"):
        t = time_bias_act(calls[which])
        for k, v in t.items():
            res.setdefault(k, {})[which] = v
        log(f"phase 24: {which}, summed over a forward's {len(calls[which])} shapes (CUDA "
            f"events): kernel {t['ms']:.4f} ms, ATen add + clamp {t['aten_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms (bytes: each value read and "
            f"written once); bound/kernel {t['bound_ms'] / t['ms']:.1%}; {smi}")
    log(f"phase 24: the residual pass == ATen's add, add and clamp bit for bit in "
        f"{residual_edge_cases(dev)} edge cases")
    res["retinaface"] = phase24_retinaface(dev, smi)
    for name in off:
        off[name]["retinaface"] = res["retinaface"]["launches"].pop(name)
    if any(n for paths in off.values() for n in paths.values()):
        raise AssertionError(f"phase 24: l2norm or lfpn_fuse launched off the inference path: "
                             f"{off}")
    log(f"phase 24: l2norm launched {L2NORM_PER_FORWARD} times a bf16 and an int8 forward, "
        f"{off['l2norm']} in a recorded forward and backward, a detect_tta and a RetinaFace "
        f"forward; == ATen's expression in {l2norm_edge_cases(dev)} edge cases")
    res["l2norm"] = l2norm_taps(cfg, dev, smi)
    n, differ, worst = lfpn_fuse_edge_cases(dev)
    log(f"phase 24: lfpn_fuse launched {LFPN_FUSE_PER_FORWARD} times a bf16 and an int8 forward, "
        f"{off['lfpn_fuse']} in a recorded forward and backward, a detect_tta and a RetinaFace "
        f"forward; == ATen's upsample-then-op bit for bit in {n} edge cases, but for float32 "
        f"below {LFPN_FUSE_NHWC_C} channels (ATen's NCHW kernel): {differ} values differ there, "
        f"by up to {worst} ulps")
    res["lfpn_fuse"] = lfpn_fuse_blocks(cfg, dev, smi)
    log(f"phase 24: {time.perf_counter() - t0:.1f} s")
    return res


if __name__ == "__main__":
    sys.exit(main())
