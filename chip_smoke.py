#!/usr/bin/env python
"""Drive the PyTorch port's detect path, train step and TTA evaluation path
on one CUDA card and check them.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is 0 only if all pass):
  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build every CUDA source (csrc/*.cu, one nvcc each, all at once) and
     print the NMS kernel's build time;
  3. compare the NMS kernel with its plain PyTorch version on the card,
     ranks, indices and valid flags identical, and the path each row took
     (`nms_cuda.LAST_PATHS`: tile scan for a sorted row, argmax loop
     otherwise) as expected and as `rows_sorted` says: the (128, 5000) rows
     of a random-init 640x640 forward (sorted, with exact ties: all tile
     scan); the same rows shuffled (all argmax loop, the same boxes kept
     with the same ranks); both kinds in one launch; one sorted row with
     max_out 20 and 65, a score threshold of 0.5, a tail of zeros from box
     0, 64 and 100, one swapped pair (argmax loop); 300 equal boxes with
     equal scores; N = 257, 64 and 1 sorted; N = 257 unsorted with
     max_out > N, all-zero scores and a score threshold; a bench row with a
     NaN x1 and a NaN y2 on two boxes, sorted (tile scan) and shuffled
     (argmax loop);
  4. serve requests through dan_tpu_torch.api.Detector at the default
     config (640x640, bf16): detect() on 3 images of different sizes and
     one detect_batch() of 4, checking shapes, finiteness and boxes inside
     each image; every NMS row must have taken the tile scan;
  5. run the bench path at batch 128 (normalize -> forward ->
     postprocess_batch), timed with CUDA events after warm-up; the kernel
     launch counts of phases 4-5 must be > 0 and every NMS row of every
     bench step must have taken the tile scan;
  6. numeric check: the float32 forward on the card (TF32 off) against the
     same forward on the CPU, and the bf16 forward against the float32 one;
  7. time the NMS kernel against the plain version at (128, 5000, 750) and
     (1, 5000, 750), and beside it the argmax loop (the design the tile
     scan replaced on sorted rows) on the same rows shuffled and on the
     sorted rows with one swapped pair; the tile scan must be the faster;
  8. print the build time and the ptxas registers, spills and shared
     memory of the train-step kernels (matching.cu, phase_pool.cu,
     conv12_wgrad.cu);
  9. hold each train-step kernel against its plain version on the card at
     the train shapes (batch 32, 640x640): the matcher (A = 34125, G = 256)
     with all four MatchTargets leaves bit-identical, on the
     train-preprocessed synthetic batch, on the same with an image without
     gts and one with a gt in slot >= 128, and on that with one image
     added whose 256 gts are all valid; the phase-pool
     backward bit for bit on winners from a real packed forward; the
     conv1_2' weight grad within relative L2 1e-4 of float32 and
     bit-identical across two runs, at the train shape, at batch 1 and 3,
     at o1 (2, 37, 53, 256) and (1, 64, 65, 256) (rows that end inside a
     64-pixel segment), on a border-only o1 and dr, and exactly 0 on an
     all-negative o1;
 10. train the default config at batch 32, 640x640, bf16, on synthetic
     data (warm-up 50, clip 10): 6 steps on one batch must lower the loss;
     10 timed steps on fresh batches give ms/step, img/s, the split into
     H2D + preprocess + match, forward + backward and optimizer, and peak
     memory; each train kernel must have launched its expected count per
     step; then 2 steps through `python -m dan_tpu_torch.train`'s main(),
     the second resumed from the first one's checkpoint;
 11. time each train-step kernel against its plain version at the train
     shapes, the matcher call beside its three kernels' own device time
     (torch.profiler), and cuDNN's weight gradient beside the conv1_2'
     kernel (the one PyTorch call that computes a ported kernel's
     function);
 12. hold the vote kernel and the blocked-NMS kernel against their plain
     versions on the card: the vote at (7, 6000) -> 750 on seeded rows
     (clusters, an empty row, a full row, score ties, a pair at IoU exactly
     the threshold, scores <= 0, a packed prefix) at thresholds 0.3, 0 and
     1, at B = 1, on edge rows at 6000 (300 near-equal boxes merging into
     one output across tiles, max_out 20 and 70 cutting inside a tile, a
     zero-area box selected first, NaN coordinates and a NaN score), at
     R = 1, and -- after phase 13 -- at (128, 6000) on the pre-vote
     detections of the real TTA run: valid, scores and counts identical,
     boxes within rtol 1e-5 / atol 1e-4 (NaN where the plain version's
     are), two kernel runs bit-identical, and every row's tiles
     (`bbox_vote_cuda.LAST_TILES`) positive exactly when it has an active
     detection and at most one a 64 active ones; the blocked NMS at
     N = 5000 on the bench path's candidates, on the NaN row of phase 3 and
     at N = 257: kept set identical to its plain version and to the ranks
     of greedy_nms_rank (the tile scan);
 13. the TTA path at the default config (full width, bf16, random weights):
     160 seeded images of 8 WIDER-like sizes that reach every bucket,
     `warmup_tta`, `detect_tta` on one image of each size, then
     `detect_tta_dataset` on all (tta_batch 16, vote_batch 128,
     max_pending 32).  Its launch statistics must equal the planners'
     arithmetic and the kernels' launch counters those statistics; every
     NMS row of every bucket launch must have taken the tile scan; outputs
     finite, inside the image, at most 750, scores descending; every vote
     row's tiles as in phase 12; a second run, each image alone through
     the dataset runner, and a second detect_tta of each image (timed warm)
     bit-identical.
     Against per-image detect_tta (other launch shapes, so other cuDNN
     kernels) the bf16 run is held as a set of boxes (>= 90 % with a
     partner at IoU > 0.5 and >= 70 % at IoU > 0.9) and the same weights in
     float32 by value: a float32 dataset run over all 160 images against
     detect_tta on one image of each size from its middle (equal counts;
     all but 1 % of an image's boxes paired within rtol 1e-4 / atol 1e-2 px
     and score rtol 1e-4).  Then the eval CLI's tail: write the
     detections, read them back, score them against seeded ground truth
     (the APs are printed, not gated: random weights), and the same files
     through `python -m dan_tpu_torch.eval --score_only`'s main(), which
     must print the same AP line.
     Prints images/s, ms per bucket launch by bucket, ms per vote launch,
     peak memory overall and for one 2048-bucket launch of 8 units, and the
     device's busy share from one profiler pass;
 14. time the vote kernel at (128, 6000, 750) and (1, 6000, 750) with its
     own device time (torch.profiler) and the blocked NMS at (5000, 750)
     against their plain versions (the blocked
     NMS's wrapper and its two passes alone, beside greedy_nms_rank's kernel
     at B = 1), and replay the selections to count the IoUs and merges that
     this run's rows need, for the bounds.

Phase 12's first half runs before phase 13, its real-data half after it.
The line before the last is a JSON object describing each kernel, with the
least time the card could take for this run's inputs (`bound_ms`); the last
line is {"ok": true, "device": {...}}.  Imports no JAX and nothing of the
JAX package.
"""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dan_tpu_torch.config import default_config
from dan_tpu_torch.data.synthetic import synthetic_batch
from dan_tpu_torch.api import Detector
from dan_tpu_torch.box.anchors import generate_anchors
from dan_tpu_torch.box.iou import iou_one_to_many, pairwise_iou
from dan_tpu_torch.box.matching import MatchTargets, match_anchors
from dan_tpu_torch.ckpt import train_state as ckpt
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.models.vgg import phase_pool_with_winner, nhwc
from dan_tpu_torch.eval import __main__ as eval_cli
from dan_tpu_torch.eval.tta import TTARunner, VoteRows, plan_variant_buckets
from dan_tpu_torch.eval.widerface_ap import evaluate_widerface
from dan_tpu_torch.eval.writer import load_detection_dir, write_wider_detections
from dan_tpu_torch.ops import (
    _cuda_build,
    bbox_vote_cuda,
    conv12_wgrad_cuda,
    matching_cuda,
    nms_blocked_cuda,
    nms_cuda,
    phase_pool_cuda,
)
from dan_tpu_torch.ops.bbox_vote import bbox_vote_batched
from dan_tpu_torch.ops.preprocess import sample_augment_batch, train_preprocess
from dan_tpu_torch.train import __main__ as train_cli
from dan_tpu_torch.train.loop import (
    create_train_state,
    loss_and_grads,
    preprocess_and_match,
    to_device,
)
from dan_tpu_torch.train.optim import sgd_update
from dan_tpu_torch.ops.nms import NMSResult, rank_to_result
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
    "conv12_wgrad": (conv12_wgrad_cuda, "conv12_wgrad",
                     "dan_tpu/ops/conv12_wgrad_pallas.py:51"),
}
# Launches per train step: one each (the matcher counts calls of its C
# entry point, each of which launches both of its passes).
PER_STEP = {"matcher": 1, "phase_pool_bwd": 1, "conv12_wgrad": 1}
# The matcher's kernels: pass 1 (K3) is the first two, pass 2 (K4) the last.
MATCHER_KERNELS = ("anchor_best_kernel", "gt_stats_kernel", "assign_kernel")
TTA_SOURCES = ("bbox_vote", "nms_blocked")
# (h, w) of the TTA run's images: sizes WIDER FACE has, reaching every
# bucket class (640x480 takes the extra 2.0 scale; 1024x400 is under 0.42 MP,
# so its 2.0 pass fills the 2048 bucket).
TTA_SIZES = ((768, 1024), (1024, 768), (683, 1024), (1366, 1024), (1024, 1024),
             (480, 640), (400, 1024), (200, 300))
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


def log(msg: str) -> None:
    print(msg, flush=True)


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


def turns(kernel, plain, kernel_iters=10, plain_iters=2):
    """Mean ms of kernel() and plain(), timed in turns plain, kernel,
    kernel, plain after one warm call of each.  Each kernel turn follows
    three untimed calls, so that no turn starts cold after the plain
    version's run."""
    kernel()
    plain()
    torch.cuda.synchronize()
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn, iters = (kernel, kernel_iters) if which == "kernel" else (plain, plain_iters)
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


def device_ms(fn, iters, names):
    """Device time per call of fn() spent in the CUDA kernels whose names
    contain each of `names`, from torch.profiler over `iters` calls after
    one warm call -> {name: ms}.  Raises if a named kernel shows no time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":
            for name in names:
                if name in e.key:
                    out[name] += e.self_device_time_total / 1e3 / iters
    if not all(v > 0.0 for v in out.values()):
        raise AssertionError(f"the profiler shows no device time for some of {names}: {out}")
    return out


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (float32 compared as int32: a NaN equals its copy)."""
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
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
    (1 = tile scan, 0 = argmax loop; an int for all rows or one per row),
    unless each row took that path.  Returns max |rank diff|."""
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
    if not torch.equal(paths.bool(), nms_cuda.rows_sorted(scores)):
        raise AssertionError(f"{what}: the kernel's path choice is not rows_sorted()'s")
    if path is not None:
        expect = torch.as_tensor(path, dtype=torch.uint8, device=paths.device).expand_as(paths)
        if not torch.equal(paths, expect):
            raise AssertionError(
                f"NMS {what} at {tuple(scores.shape)}: rows took paths {paths.tolist()[:16]}..., "
                f"expected {expect.tolist()[:16]}... (1 = tile scan)")
    log(f"  kernel == plain at B={scores.shape[0]} N={scores.shape[1]} "
        f"max_out={max_out} thr={thr} score_thr={score_thr}{' ' + what if what else ''}: "
        f"{int((got >= 0).sum())} kept; tile scan on {int(paths.sum())} of {paths.numel()} rows, "
        f"at most {int(nms_cuda.LAST_TILES.max())} tiles")
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
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _cuda_build.build_all(["nms"] + [src for _, src, _ in TRAIN_KERNELS.values()]
                          + list(TTA_SOURCES))
    secs = _cuda_build.BUILDS["nms"].seconds
    log(f"phase 2: built all CUDA sources in {time.perf_counter() - t0:.3f} s; "
        f"{KERNEL_SOURCE} " + (f"in {secs:.3f} s" if secs is not None else "was already built"))
    for line in _cuda_build.ptxas_summary("nms"):
        log(f"  ptxas: {line}")

    # -- 3. kernel vs plain on the card ---------------------------------------
    cfg = default_config()
    post = cfg.postprocess
    size = cfg.model.image_size
    det = Detector.from_random(SEED, cfg, dev)
    rng = np.random.default_rng(SEED)
    images_u8 = torch.from_numpy(
        rng.integers(0, 255, (BATCH, size, size, 3), dtype=np.uint8)
    ).to(dev)
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
    nan_row = (b_nan[0].clone(), s1[0].clone())
    # Rows of the bench path's candidates (descending scores) for phase 12,
    # and the dependent steps and IoU pairs that this run's NMS rows need.
    nms_rows = (boxes_k[:4].clone(), scores_k[:4].clone())
    kept_rows = (nms_cuda.greedy_nms_rank(
        boxes_k, scores_k, post.nms_iou_threshold, post.max_detections) >= 0).sum(dim=1)
    nms_tiles = nms_cuda.LAST_TILES.clone()
    nms_steps, nms_pairs, _ = selection_work(
        boxes_k, scores_k, scores_k > 0.0, post.nms_iou_threshold, post.max_detections, False)
    if not torch.equal(nms_steps, kept_rows):
        raise AssertionError("the replay of the NMS selection counts other steps than the kernel")

    # -- 4 + 5. the main path, counted --------------------------------------
    nms_cuda.LAUNCHES = 0
    req = [rng.integers(0, 255, hw + (3,), dtype=np.uint8)
           for hw in ((480, 640), (720, 1280), (300, 200))]
    nms_paths = []  # LAST_PATHS of every launch of phases 4-5: all must be 1

    def took_tile_scan(what):
        """Every row of the recorded launches took the tile scan, or raise: a
        fast path that the main path never reaches is a hidden fallback."""
        rows = torch.cat(nms_paths)
        nms_paths.clear()
        if not bool(rows.all()):
            raise AssertionError(f"{what}: {int((rows == 0).sum())} of {rows.numel()} NMS rows "
                                 f"took the argmax loop")
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

    anchors = det.anchors

    def bench_step():
        with torch.inference_mode():
            x = normalize_image(images_u8.float(), cfg.preprocess)
            cls, loc = det.model(x)
            out = postprocess_batch(cls, loc, anchors, cfg.anchors, post,
                                    float(size), float(size))
            nms_paths.append(nms_cuda.LAST_PATHS)
            return out

    for _ in range(2):
        out = bench_step()
    torch.cuda.synchronize()
    iters = 10
    bench_ms = cuda_ms(bench_step, iters)
    img_s = BATCH / (bench_ms / 1e3)
    out = bench_step()
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
        f"{bench_ms:.3f} ms/batch = {img_s:.1f} img/s ({smi}); "
        f"valid detections per image {int(n_valid.min())}..{int(n_valid.max())}")
    log(f"  NMS kernel launches in phases 4-5: {launches_one} at B=1, "
        f"{launches_batched} batched; all {n_rows_scanned} rows of the bench steps took the "
        f"tile scan")
    if launches_one == 0 or launches_batched == 0:
        raise AssertionError("the main path did not launch the NMS kernel")

    # Where the batch-128 time goes: forward and postprocess apart.
    with torch.inference_mode():
        x = normalize_image(images_u8.float(), cfg.preprocess)
        fwd_ms = cuda_ms(lambda: det.model(x), 5)
        cls, loc = det.model(x)
        post_ms = cuda_ms(lambda: postprocess_batch(
            cls, loc, anchors, cfg.anchors, post, float(size), float(size)), 5)
    log(f"  split: forward {fwd_ms:.3f} ms, postprocess {post_ms:.3f} ms per batch")
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
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  peak device memory so far {peak:.2f} GiB")
    nms_paths.clear()

    # -- 6. numerics ----------------------------------------------------------
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

    # -- 7. NMS kernel vs plain timing ----------------------------------------
    # The tile scan on the bench rows, and the argmax loop (the design of the
    # earlier kernel, kept for unsorted rows) on the same rows shuffled: the
    # same launch shape, the same boxes kept, the same run on the same card.
    args = (post.nms_iou_threshold, post.max_detections)
    b1, s1 = boxes_k[:1], scores_k[:1]
    bu1, su1 = boxes_u[:1], scores_u[:1]
    # A third input: the sorted rows with one neighbouring pair of scores
    # swapped in each.  They take the argmax loop too, but their active boxes
    # stay packed at the row's end as in a sorted row (in a shuffled row they
    # are spread over every warp), which is what the loop saw before the tile
    # scan took the sorted rows.
    first = (scores_k[:, :-1] > scores_k[:, 1:]).float().argmax(dim=1)
    rows = torch.arange(BATCH, device=dev)
    scores_w = scores_k.clone()
    scores_w[rows, first], scores_w[rows, first + 1] = (scores_k[rows, first + 1],
                                                        scores_k[rows, first])
    for _ in range(3):
        nms_cuda.greedy_nms_rank(boxes_k, scores_k, *args)
        nms_cuda.greedy_nms_rank(boxes_u, scores_u, *args)
        nms_cuda.greedy_nms_rank(boxes_k, scores_w, *args)
    if bool(nms_cuda.LAST_PATHS.any()):
        raise AssertionError("a row with a swapped pair took the tile scan")
    times = {k: [] for k in ("plain", "kernel", "argmax", "swapped", "plain1", "kernel1",
                             "argmax1", "swapped1")}
    for name in ("plain", "kernel", "kernel", "plain"):
        if name == "plain":
            times["plain"].append(cuda_ms(
                lambda: nms_cuda.greedy_nms_rank_plain(boxes_k, scores_k, *args), 2))
            times["plain1"].append(cuda_ms(
                lambda: nms_cuda.greedy_nms_rank_plain(b1, s1, *args), 2))
            continue
        for key, (bx, sc) in (("kernel", (boxes_k, scores_k)), ("argmax", (boxes_u, scores_u)),
                              ("swapped", (boxes_k, scores_w)), ("kernel1", (b1, s1)),
                              ("argmax1", (bu1, su1)), ("swapped1", (b1, scores_w[:1]))):
            times[key].append(cuda_ms(lambda: nms_cuda.greedy_nms_rank(bx, sc, *args), 20))
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    log(f"phase 7: NMS at ({BATCH}, {boxes_k.shape[1]}, {post.max_detections}): "
        f"kernel (tile scan, at most {int(nms_tiles.max())} tiles a row) {ms['kernel']:.4f} ms, the "
        f"argmax loop on the shuffled rows {ms['argmax']:.4f} ms and on the sorted rows with one "
        f"swapped pair {ms['swapped']:.4f} ms, plain {ms['plain']:.4f} ms; at B=1: kernel "
        f"({int(nms_tiles[0])} tiles) {ms['kernel1']:.4f} ms, argmax loop {ms['argmax1']:.4f} ms "
        f"shuffled and {ms['swapped1']:.4f} ms swapped, plain {ms['plain1']:.4f} ms ({smi})")
    if not (ms["kernel"] < min(ms["argmax"], ms["swapped"])
            and ms["kernel1"] < min(ms["argmax1"], ms["swapped1"])):
        raise AssertionError("the tile scan is not faster than the argmax loop")

    del det, model32, images_u8, boxes_k, scores_k, boxes_u, scores_u, scores_w, out
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

    # -- 10. the train step, counted ------------------------------------------
    launches = phase10(tcfg, dev, smi)

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

    n_rows, n_box = BATCH, post.pre_nms_topk
    # NMS: 20 bytes a box in, its rank out; for every selected box an IoU, a
    # threshold test and (the input need not be sorted) an argmax compare
    # for every box that is still active, counted from this run's rows.  The
    # chain of dependent steps is the tile scan's tiles; the argmax loop's
    # time on the same rows shuffled stands beside the kernel's.
    pair_ops = IOU_OPS + TEST_OPS + ARGMAX_OPS
    b_nms = bound(n_rows * n_box * 24, int(nms_pairs.sum()) * pair_ops, PEAK_F32)
    b_nms1 = bound(n_box * 24, int(nms_pairs[0]) * pair_ops, PEAK_F32)
    kernels = [
        {"name": "greedy_nms_rank (batched)", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "dan_tpu/ops/nms_batched_pallas.py:29", "launches": launches_batched,
         "launches_tta": tta["nms_launches"], "max_abs_err": err_b, "ms": ms["kernel"],
         "argmax_loop_ms": ms["argmax"], "argmax_loop_swapped_ms": ms["swapped"],
         "plain_ms": ms["plain"], "bound_ms": b_nms[0],
         "bound_by": b_nms[1], "dependent_steps": int(nms_tiles.max()),
         "kept": int(kept_rows.max()), "library_ms": None},
        {"name": "greedy_nms_rank (B=1)", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "dan_tpu/ops/nms_pallas.py:34", "launches": launches_one,
         "max_abs_err": err_1, "ms": ms["kernel1"], "argmax_loop_ms": ms["argmax1"],
         "argmax_loop_swapped_ms": ms["swapped1"],
         "plain_ms": ms["plain1"], "bound_ms": b_nms1[0], "bound_by": b_nms1[1],
         "dependent_steps": int(nms_tiles[0]), "kept": int(kept_rows[0]), "library_ms": None},
    ]
    for name, (_, src, replaces) in TRAIN_KERNELS.items():
        entry = {
            "name": name, "route": "cuda", "source": f"dan_tpu_torch/csrc/{src}.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": errs[name],
            "ms": train_ms[name]["kernel"], "plain_ms": train_ms[name]["plain"],
            "library_ms": train_ms[name].get("library")}
        if name == "conv12_wgrad":
            plan = train_bounds["conv12_wgrad tiling"]
            seg = conv12_wgrad_cuda.SEGMENT
            entry.update(partials=plan.partials, flush_pixels=plan.flush_segs * seg,
                         pixels_per_block=plan.segs_per_range * seg)
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
            kernels.append(dict(
                entry, name=pass_name, replaces=f"dan_tpu/ops/matching_pallas.py:{line}",
                bound_ms=ms_b, bound_by=by, device_ms=sum(dev_t[k] for k in names),
                ms_covers="one match_anchors_cuda call: both passes and the wrapper"))
    vote_src = "dan_tpu_torch/csrc/bbox_vote.cu"
    kernels += [
        {"name": "bbox_vote (batched)", "route": "cuda", "source": vote_src,
         "replaces": "dan_tpu/ops/bbox_vote_pallas.py:162", "launches": tta["vote_launches"],
         "max_abs_err": vote_err, "ms": tta_ms["vote"]["kernel"],
         "device_ms": tta_ms["vote"]["device"], "plain_ms": tta_ms["vote"]["plain"],
         "bound_ms": tta_bounds["vote"][0], "bound_by": tta_bounds["vote"][1],
         "dependent_steps": tta_bounds["vote"][2], "outputs": tta_bounds["vote"][3],
         "library_ms": None},
        {"name": "bbox_vote (B=1)", "route": "cuda", "source": vote_src,
         "replaces": "dan_tpu/ops/bbox_vote_pallas.py:30", "launches": tta["vote_launches_one"],
         "max_abs_err": vote_err, "ms": tta_ms["vote1"]["kernel"],
         "device_ms": tta_ms["vote1"]["device"], "plain_ms": tta_ms["vote1"]["plain"],
         "bound_ms": tta_bounds["vote1"][0], "bound_by": tta_bounds["vote1"][1],
         "dependent_steps": tta_bounds["vote1"][2], "outputs": tta_bounds["vote1"][3],
         "library_ms": None},
        {"name": "greedy_nms_blocked", "route": "cuda",
         "source": "dan_tpu_torch/csrc/nms_blocked.cu",
         "replaces": "dan_tpu/ops/nms_blocked_pallas.py:39",
         "launches": tta["blocked_launches"], "max_abs_err": blocked_err,
         "ms": tta_ms["blocked"]["kernel"], "launch_ms": tta_ms["blocked"]["launch"],
         "ms_covers": "the wrapper: order check that waits for the device, both passes, "
                      "rank_to_result; launch_ms is the two passes alone",
         "plain_ms": tta_ms["blocked"]["plain"],
         "bound_ms": tta_bounds["blocked"][0], "bound_by": tta_bounds["blocked"][1],
         "dependent_steps": tta_bounds["blocked"][2], "library_ms": None},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


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


def compare_wgrad(o1, dr, what) -> float:
    """The conv1_2' weight-gradient kernel against its plain version in
    float32 (TF32 off): relative L2 <= 1e-4 and two runs bit-identical, or
    raise.  Returns max |diff|."""
    k_a = conv12_wgrad_cuda.conv12_wgrad(o1, dr)
    plan = conv12_wgrad_cuda.LAST_TILING
    k_b = conv12_wgrad_cuda.conv12_wgrad(o1, dr)
    plain = conv12_wgrad_cuda.conv12_wgrad_plain(o1, dr)
    torch.cuda.synchronize()
    e_w = rel_l2(k_a, plain)
    e_abs = float((k_a - plain).abs().max())
    same = torch.equal(k_a, k_b)
    log(f"phase 9: conv12 wgrad kernel vs plain (f32, TF32 off) at o1 {tuple(o1.shape)}, dr "
        f"{tuple(dr.shape)} ({what}): rel L2 {e_w:.3e} (limit 1e-4), max |diff| {e_abs:.3e}; "
        f"two runs identical: {same}; {plan.partials} partials of {plan.segs_per_range} "
        f"segments, a chain ends every {plan.flush_segs * conv12_wgrad_cuda.SEGMENT} pixels")
    if not (e_w <= 1e-4 and same and bool(torch.isfinite(k_a).all())):
        raise AssertionError(f"conv12 wgrad kernel out of tolerance or not deterministic ({what})")
    return e_abs


def preprocessed(batch, cfg, dev):
    """A host train batch through train_preprocess on the card, with the
    draws of its own seeds -> (images, boxes, mask)."""
    t = to_device(batch, dev)
    draws = sample_augment_batch(batch["seed"], cfg.preprocess)
    return train_preprocess(
        t["canvas"], (t["crop_x0"], t["crop_y0"], t["crop_size"]), t["boxes"],
        t["mask"], draws, cfg.preprocess)


def compare_matcher(margs, what) -> MatchTargets:
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
    log(f"phase 9: matcher kernel == plain on {what} (B={margs[1].shape[0]} "
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

    # conv1_2' weight grad at the train shape, then at other shapes.
    o1 = nhwc(o1_pre)
    del o1_pre
    dr = torch.randn((TRAIN_BATCH, o1.shape[1] + 1, o1.shape[2] + 1, 256),
                     generator=gen, device=dev, dtype=torch.bfloat16)
    e_abs = compare_wgrad(o1, dr, "the train shape, o1 from a real packed forward")
    compare_wgrad(o1[:1].contiguous(), dr[:1].contiguous(), "batch 1 at 640x640")
    compare_wgrad(o1[:3].contiguous(), dr[:3].contiguous(), "batch 3 at 640x640")
    # Rows that are no multiple of the 64-pixel segment: a ragged last
    # segment, and one pixel over a segment (the kernel reads zeros past W).
    for shape in ((2, 37, 53, 256), (1, 64, 65, 256)):
        small = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
        small_dr = torch.randn((shape[0], shape[1] + 1, shape[2] + 1, 256), generator=gen,
                               device=dev, dtype=torch.bfloat16)
        compare_wgrad(small, small_dr, "an odd size")
    # Nothing passes the relu: dW is exactly 0.
    zero = conv12_wgrad_cuda.conv12_wgrad(-o1[:2].abs() - 1.0, dr[:2].contiguous())
    if float(zero.abs().max()) != 0.0:
        raise AssertionError("conv12 wgrad of an all-negative o1 is not exactly 0")
    log("  all-negative o1: dW exactly 0")
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
    del zero, edge, edge_dr
    errs = {"matcher": 0.0, "phase_pool_bwd": 0.0, "conv12_wgrad": e_abs}
    cases = {"matcher": margs, "phase_pool_bwd": (g, win), "conv12_wgrad": (o1, dr)}
    return errs, cases


def phase10(cfg, dev, smi):
    """The train step on the card; returns each train kernel's launches."""
    state = create_train_state(cfg, SEED, dev)
    batch = synthetic_batch(cfg, TRAIN_BATCH, seed=SEED)
    fresh = [synthetic_batch(cfg, TRAIN_BATCH, seed=100 + i) for i in range(12)]
    named = dict(state.model.named_parameters())

    def step(b, ev=None):
        if ev:
            ev[0].record()
        images, targets = preprocess_and_match(b, cfg, dev)
        if ev:
            ev[1].record()
        grads, metrics = loss_and_grads(state, images, targets)
        if ev:
            ev[2].record()
        metrics["grad_norm"] = sgd_update(named, grads, state.momentum, state.step, cfg.train)
        state.step += 1
        if ev:
            ev[3].record()
        return metrics

    for mod, _, _ in TRAIN_KERNELS.values():
        mod.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [float(step(batch)["loss"]) for _ in range(6)]
    log(f"phase 10: 6 steps on one batch ({TRAIN_BATCH}x640x640, bf16, warm-up 50, "
        f"clip 10): loss {' '.join(f'{x:.4f}' for x in losses)} "
        f"({time.perf_counter() - t0:.2f} s, first step cold)")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError("the loss did not fall over 6 steps")
    for b in fresh[:2]:  # warm-up on fresh batches
        step(b)
    torch.cuda.synchronize()
    evs = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in fresh[2:]]
    t0 = time.perf_counter()
    for b, ev in zip(fresh[2:], evs):
        metrics = step(b, ev)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / len(evs)
    split = np.array([[ev[i].elapsed_time(ev[i + 1]) for i in range(3)] for ev in evs])
    step_ms = np.array([ev[0].elapsed_time(ev[3]) for ev in evs])
    gaps = np.array([a[3].elapsed_time(b[0]) for a, b in zip(evs[:-1], evs[1:])])
    peak = torch.cuda.max_memory_allocated() / 2**30
    m = {k: float(v) for k, v in metrics.items()}
    log(f"phase 10: train step at batch {TRAIN_BATCH}: {step_ms.mean():.3f} ms/step on the "
        f"card's clock (events, mean of {len(evs)}) = {TRAIN_BATCH / step_ms.mean() * 1e3:.1f} "
        f"img/s; host clock {wall:.3f} ms/step = {TRAIN_BATCH / wall * 1e3:.1f} img/s "
        f"({smi})")
    log(f"  split: H2D + preprocess + match {split[:, 0].mean():.3f} ms, forward + backward "
        f"{split[:, 1].mean():.3f} ms, optimizer {split[:, 2].mean():.3f} ms; between steps "
        f"{gaps.mean():.3f} ms; peak device memory {peak:.2f} GiB")
    log(f"  last step: {' '.join(f'{k}={v:.5g}' for k, v in m.items())}")
    if not all(np.isfinite(v) for v in m.values()):
        raise AssertionError("non-finite metrics")
    n_steps = 6 + len(fresh)
    launches = {name: mod.LAUNCHES for name, (mod, _, _) in TRAIN_KERNELS.items()}
    profile_steps(step, fresh[2:5])
    log(f"  train kernel launches over {n_steps} steps: {launches}")
    for name, n in launches.items():
        if n != PER_STEP[name] * n_steps:
            raise AssertionError(f"{name} launched {n} times, expected "
                                 f"{PER_STEP[name] * n_steps}")
    del state, batch, fresh

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


def profile_steps(step, batches):
    """torch.profiler over a few steady train steps: device kernel time
    per step against the steps' event time (the device's busy share), and
    the kernels that take the most of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for b in batches:
            step(b)
        end.record()
        torch.cuda.synchronize()
    span = start.elapsed_time(end) / len(batches)
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = lambda e: e.self_device_time_total  # noqa: E731
    busy = sum(dev_us(e) for e in events) / 1e3 / len(batches)
    log(f"  profiler over {len(batches)} steps: device kernel time {busy:.3f} ms/step of "
        f"{span:.3f} ms/step (event clock) = busy share {busy / span:.3f}")
    top = sorted(events, key=dev_us, reverse=True)[:12]
    for e in top:
        log(f"    {dev_us(e) / 1e3 / len(batches):9.3f} ms/step  {e.count // len(batches):4d}x  "
            f"{e.key[:90]}")


def phase11(cases, smi):
    """Each train kernel against its plain version, same inputs, in turns
    plain, kernel, kernel, plain."""
    fns = {
        "matcher": (matching_cuda.match_anchors_cuda, match_anchors),
        "phase_pool_bwd": (phase_pool_cuda.phase_pool_bwd,
                           phase_pool_cuda.phase_pool_bwd_plain),
        "conv12_wgrad": (conv12_wgrad_cuda.conv12_wgrad,
                         conv12_wgrad_cuda.conv12_wgrad_plain),
    }
    out = {}
    for name, (kernel, plain) in fns.items():
        args = cases[name]
        out[name] = turns(lambda: kernel(*args), lambda: plain(*args), 10, 3)
        log(f"phase 11: {name}: kernel {out[name]['kernel']:.4f} ms, plain "
            f"{out[name]['plain']:.4f} ms ({smi})")
    # The matcher call (host work, allocations, three launches) beside its
    # kernels' own device time.
    margs = cases["matcher"]
    call = lambda: matching_cuda.match_anchors_cuda(*margs)  # noqa: E731
    dev_t = device_ms(call, 20, MATCHER_KERNELS)
    out["matcher"]["device"] = dev_t
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
    }
    for name, (ms_b, by) in bounds.items():
        log(f"  bound {name}: {ms_b:.4f} ms by {by}")
    conv12_wgrad_cuda.conv12_wgrad(o1, dr)
    bounds["conv12_wgrad tiling"] = conv12_wgrad_cuda.LAST_TILING
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


def phase12_blocked(nms_rows, nan_row, post, dev) -> float:
    """The blocked NMS kernel: kept set against its plain version and
    against greedy_nms_rank's ranks (the tile scan: these rows are sorted),
    on the bench rows, on the bench row with two NaN coordinates, and on
    257 seeded boxes."""
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
    log("phase 12: blocked NMS kernel against its plain version and the ranks of greedy_nms_rank")
    diff = 0
    for bx, sc, t, sthr in cases:
        # max_out = N gives the whole kept set; then the path's max_out.
        for out in (sc.shape[0], max_out):
            got = nms_blocked_cuda.greedy_nms_blocked_cuda(bx, sc, t, out, sthr)
            want = nms_blocked_cuda.greedy_nms_blocked_plain(bx, sc, t, out, sthr)
            k1 = rank_to_result(
                nms_cuda.greedy_nms_rank(bx[None].contiguous(), sc[None].contiguous(), t, out,
                                         sthr), bx[None], sc[None], out)
            torch.cuda.synchronize()
            off = [int((got.indices != w.indices).sum()) + int((got.valid != w.valid).sum())
                   for w in (want, NMSResult(*(leaf[0] for leaf in k1)))]
            diff = max(diff, *off)
            if any(off):
                raise AssertionError(
                    f"blocked NMS at N={sc.shape[0]} thr={t} score_thr={sthr} max_out={out}: "
                    f"{off[0]} kept entries differ from plain, {off[1]} from "
                    f"greedy_nms_rank")
        log(f"  blocked NMS == plain == greedy_nms_rank at N={sc.shape[0]} thr={t} "
            f"score_thr={sthr}: kept sets identical, {int(got.valid.sum())} within max_out")
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

    def _run_bucket(self, *args, **kwargs):
        out = super()._run_bucket(*args, **kwargs)
        self.nms_paths.append(nms_cuda.LAST_PATHS)
        return out

    def _run_vote(self, boxes_b, scores_b, valid_b, buffer):
        fetch = super()._run_vote(boxes_b, scores_b, valid_b, buffer)
        self.vote_inputs.append(VoteRows(boxes_b, scores_b, valid_b, buffer))
        self.vote_tiles.append((bbox_vote_cuda.LAST_TILES,
                                torch.from_numpy((valid_b & (scores_b > 0.0)).sum(axis=1))))
        return fetch


def tta_images(n):
    """n seeded uint8 images cycling over TTA_SIZES: low-resolution noise
    upsampled 4x plus a few brighter rectangles, keyed like WIDER stems."""
    rng = np.random.default_rng(SEED + 13)
    out = []
    for i in range(n):
        h, w = TTA_SIZES[i % len(TTA_SIZES)]
        coarse = rng.integers(0, 120, (h // 4 + 1, w // 4 + 1, 3), dtype=np.uint8)
        img = np.ascontiguousarray(np.repeat(np.repeat(coarse, 4, 0), 4, 1)[:h, :w])
        gts = []
        for _ in range(int(rng.integers(1, 6))):
            size = int(rng.integers(12, max(min(h, w) // 3, 14)))
            x, y = int(rng.integers(0, w - size)), int(rng.integers(0, h - size))
            img[y:y + size, x:x + size] = rng.integers(150, 255, 3, dtype=np.uint8)
            gts.append([x, y, x + size, y + size])
        out.append((f"{i % 4}--Event/img_{i}", img, np.asarray(gts, np.float64)))
    return out


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
    items = tta_images(TTA_IMAGES)
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
        f"{nms_rows_tta.numel()} took the tile scan ({len(runner.nms_paths)} launches)")
    if len(runner.nms_paths) != nms_one + nms_ds or not bool(nms_rows_tta.all()):
        raise AssertionError("an NMS row of the TTA run took the argmax loop, or a launch "
                             "was not recorded")
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


def phase14(vote_inputs, nms_rows, post, dev, smi):
    """Times of the vote and blocked-NMS kernels beside their plain
    versions, the vote's own device time, and their bounds from these
    inputs."""
    thr, max_out = post.vote_iou_threshold, post.max_detections
    b, s, v = (torch.from_numpy(a).to(dev) for a in vote_inputs[0][:3])
    b1, s1, v1 = b[:1].contiguous(), s[:1].contiguous(), v[:1].contiguous()
    out = {
        "vote": turns(lambda: bbox_vote_cuda.bbox_vote_batched_cuda(b, s, v, thr, max_out),
                      lambda: bbox_vote_batched(b, s, v, thr, max_out), 20, 2),
        "vote1": turns(lambda: bbox_vote_cuda.bbox_vote_batched_cuda(b1, s1, v1, thr, max_out),
                       lambda: bbox_vote_batched(b1, s1, v1, thr, max_out), 20, 2),
    }
    bx, sc = nms_rows[0][0], nms_rows[1][0]
    nthr = post.nms_iou_threshold
    out["blocked"] = turns(
        lambda: nms_blocked_cuda.greedy_nms_blocked_cuda(bx, sc, nthr, max_out),
        lambda: nms_blocked_cuda.greedy_nms_blocked_plain(bx, sc, nthr, max_out), 20, 2)
    # The wrapper's check of the descending order waits for the device, and
    # rank_to_result follows the kernel: the two launches alone, beside it.
    out["blocked"]["launch"] = cuda_ms(
        lambda: nms_blocked_cuda._launch(bx, sc, nthr, 0.0), 20)
    k1_ms = cuda_ms(lambda: rank_to_result(
        nms_cuda.greedy_nms_rank(bx[None], sc[None], nthr, max_out), bx[None], sc[None],
        max_out), 20)
    k1_launch_ms = cuda_ms(
        lambda: nms_cuda.greedy_nms_rank(bx[None], sc[None], nthr, max_out), 20)
    for key, args in (("vote", (b, s, v)), ("vote1", (b1, s1, v1))):
        call = lambda: bbox_vote_cuda.bbox_vote_batched_cuda(*args, thr, max_out)  # noqa: E731
        out[key]["device"] = device_ms(call, 20, ("bbox_vote_kernel",))["bbox_vote_kernel"]
        out[key]["host"] = host_ms(call)
    log(f"phase 14: bbox_vote at {tuple(s.shape)} -> {max_out}: kernel "
        f"{out['vote']['kernel']:.4f} ms (its device time {out['vote']['device']:.4f} ms, the "
        f"wrapper's host time {out['vote']['host']:.4f} ms), plain {out['vote']['plain']:.4f} ms; "
        f"at B=1: kernel {out['vote1']['kernel']:.4f} ms (device {out['vote1']['device']:.4f} ms, "
        f"host {out['vote1']['host']:.4f} ms), plain {out['vote1']['plain']:.4f} ms ({smi})")
    log(f"phase 14: greedy_nms_blocked at ({sc.shape[0]}, {max_out}): the wrapper (order check "
        f"that waits for the device, both passes, rank_to_result) "
        f"{out['blocked']['kernel']:.4f} ms, its two passes alone "
        f"{out['blocked']['launch']:.4f} ms, plain {out['blocked']['plain']:.4f} ms; "
        f"greedy_nms_rank (tile scan) at B=1 with rank_to_result {k1_ms:.4f} ms, alone "
        f"{k1_launch_ms:.4f} ms ({smi})")

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


if __name__ == "__main__":
    sys.exit(main())
