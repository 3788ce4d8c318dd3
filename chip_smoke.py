#!/usr/bin/env python
"""Drive the PyTorch port's detect path, train step and TTA evaluation path
on one CUDA card and check them.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is 0 only if all pass):
  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build every CUDA source (csrc/*.cu, one nvcc each, all at once) and
     print the NMS kernel's build time;
  3. compare the kernel with its plain PyTorch version on the card:
     (128, 5000) rows from a random-init 640x640 forward, and B=1 rows with
     N=257, max_out > N, all-zero scores and a score threshold -- ranks,
     indices and valid flags must be identical;
  4. serve requests through dan_tpu_torch.api.Detector at the default
     config (640x640, bf16): detect() on 3 images of different sizes and
     one detect_batch() of 4, checking shapes, finiteness and boxes inside
     each image;
  5. run the bench path at batch 128 (normalize -> forward ->
     postprocess_batch), timed with CUDA events after warm-up; the kernel
     launch counts of phases 4-5 must be > 0;
  6. numeric check: the float32 forward on the card (TF32 off) against the
     same forward on the CPU, and the bf16 forward against the float32 one;
  7. time the NMS kernel against the plain version at (128, 5000, 750) and
     (1, 5000, 750);
  8. print the build time and the ptxas registers, spills and shared
     memory of the train-step kernels (matching.cu, phase_pool.cu,
     conv12_wgrad.cu);
  9. hold each train-step kernel against its plain version on the card at
     the train shapes (batch 32, 640x640): the matcher (A = 34125, G = 256,
     on train-preprocessed synthetic gts plus an image without gts and one
     with a gt in slot >= 128) with identical targets; the phase-pool
     backward bit for bit on winners from a real packed forward; the
     conv1_2' weight grad within relative L2 1e-4 of float32 and
     bit-identical across two runs;
 10. train the default config at batch 32, 640x640, bf16, on synthetic
     data (warm-up 50, clip 10): 6 steps on one batch must lower the loss;
     10 timed steps on fresh batches give ms/step, img/s, the split into
     H2D + preprocess + match, forward + backward and optimizer, and peak
     memory; each train kernel must have launched its expected count per
     step; then 2 steps through `python -m dan_tpu_torch.train`'s main(),
     the second resumed from the first one's checkpoint;
 11. time each train-step kernel against its plain version at the train
     shapes, and cuDNN's weight gradient beside the conv1_2' kernel (the
     one PyTorch call that computes a ported kernel's function);
 12. hold the vote kernel and the blocked-NMS kernel against their plain
     versions on the card: the vote at (7, 6000) -> 750 on seeded rows
     (clusters, an empty row, a full row, score ties, a pair at IoU exactly
     the threshold, scores <= 0, a packed prefix), at B = 1, and -- after
     phase 13 -- at (128, 6000) on the pre-vote detections of the real TTA
     run: valid, scores and counts identical, boxes within rtol 1e-5 /
     atol 1e-4, two kernel runs bit-identical; the blocked NMS at N = 5000
     on the bench path's candidates and at N = 257: kept set identical to
     its plain version and to the ranks of the argmax-loop kernel;
 13. the TTA path at the default config (full width, bf16, random weights):
     160 seeded images of 8 WIDER-like sizes that reach every bucket,
     `warmup_tta`, `detect_tta` on one image of each size, then
     `detect_tta_dataset` on all (tta_batch 16, vote_batch 128,
     max_pending 32).  Its launch statistics must equal the planners'
     arithmetic and the kernels' launch counters those statistics; outputs
     finite, inside the image, at most 750, scores descending; a second
     run, and each image alone through the dataset runner, bit-identical.
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
 14. time the vote kernel at (128, 6000, 750) and (1, 6000, 750) and the
     blocked NMS at (5000, 750) against their plain versions (the blocked
     NMS's wrapper and its two passes alone, beside the argmax-loop kernel
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
from dan_tpu_torch.box.matching import match_anchors
from dan_tpu_torch.ckpt import train_state as ckpt
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.models.vgg import phase_pool_with_winner, nhwc
from dan_tpu_torch.eval import __main__ as eval_cli
from dan_tpu_torch.eval.tta import TTARunner, plan_variant_buckets
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
# Launches per train step: the matcher's two passes, one each for the rest.
PER_STEP = {"matcher": 2, "phase_pool_bwd": 1, "conv12_wgrad": 1}
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
    kernel, plain after one warm call of each."""
    kernel()
    plain()
    torch.cuda.synchronize()
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn, iters = (kernel, kernel_iters) if which == "kernel" else (plain, plain_iters)
        times[which].append(cuda_ms(fn, iters))
    return {k: float(np.mean(v)) for k, v in times.items()}


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


def compare_kernel(boxes, scores, thr, max_out, score_thr=0.0) -> int:
    """Kernel vs plain version on the same CUDA tensors; raises unless the
    ranks, indices and valid flags are identical.  Returns max |rank diff|."""
    got = nms_cuda.greedy_nms_rank(boxes, scores, thr, max_out, score_thr)
    want = nms_cuda.greedy_nms_rank_plain(boxes, scores, thr, max_out, score_thr)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    rg = rank_to_result(got, boxes, scores, max_out)
    rw = rank_to_result(want, boxes, scores, max_out)
    if not (torch.equal(got, want) and torch.equal(rg.indices, rw.indices)
            and torch.equal(rg.valid, rw.valid)):
        raise AssertionError(
            f"NMS kernel != plain at {tuple(scores.shape)} max_out={max_out}: "
            f"{int((got != want).sum())} ranks differ"
        )
    log(f"  kernel == plain at B={scores.shape[0]} N={scores.shape[1]} "
        f"max_out={max_out} thr={thr} score_thr={score_thr}: "
        f"{int((got >= 0).sum())} kept")
    return err


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
    err_b = compare_kernel(boxes_k, scores_k, post.nms_iou_threshold, post.max_detections)
    err_1 = compare_kernel(boxes_k[:1], scores_k[:1],
                           post.nms_iou_threshold, post.max_detections)
    b = torch.from_numpy(random_boxes(rng, 257)[None]).to(dev)
    s = torch.from_numpy(rng.uniform(0.01, 1.0, (1, 257)).astype(np.float32)).to(dev)
    err_1 = max(err_1, compare_kernel(b, s, 0.4, 20))
    err_1 = max(err_1, compare_kernel(b, s, 0.3, 750))  # max_out > N
    err_1 = max(err_1, compare_kernel(b, s, 0.3, 750, score_thr=0.5))
    err_1 = max(err_1, compare_kernel(b, torch.zeros_like(s), 0.3, 750))
    if int((nms_cuda.greedy_nms_rank(b, torch.zeros_like(s), 0.3, 750) >= 0).sum()):
        raise AssertionError("all-zero scores kept a box")
    # Rows of the bench path's candidates (descending scores) for phase 12,
    # and the dependent steps and IoU pairs that this run's NMS rows need.
    nms_rows = (boxes_k[:4].clone(), scores_k[:4].clone())
    kept_rows = (nms_cuda.greedy_nms_rank(
        boxes_k, scores_k, post.nms_iou_threshold, post.max_detections) >= 0).sum(dim=1)
    nms_steps, nms_pairs, _ = selection_work(
        boxes_k, scores_k, scores_k > 0.0, post.nms_iou_threshold, post.max_detections, False)
    if not torch.equal(nms_steps, kept_rows):
        raise AssertionError("the replay of the NMS selection counts other steps than the kernel")

    # -- 4 + 5. the main path, counted --------------------------------------
    nms_cuda.LAUNCHES = 0
    req = [rng.integers(0, 255, hw + (3,), dtype=np.uint8)
           for hw in ((480, 640), (720, 1280), (300, 200))]
    t0 = time.perf_counter()
    dets = [det.detect(im) for im in req]
    log(f"phase 4: detect() on {[im.shape[:2] for im in req]}: "
        f"{[len(d['scores']) for d in dets]} detections, "
        f"{time.perf_counter() - t0:.3f} s for the 3 (cold)")
    check_dets(dets, req, post.max_detections)
    launches_one = nms_cuda.LAUNCHES
    batch_req = [rng.integers(0, 255, hw + (3,), dtype=np.uint8)
                 for hw in ((640, 640), (500, 375), (1024, 768), (100, 160))]
    dets = det.detect_batch(batch_req)
    log(f"  detect_batch() of 4: {[len(d['scores']) for d in dets]} detections")
    check_dets(dets, batch_req, post.max_detections)

    anchors = det.anchors

    def bench_step():
        with torch.inference_mode():
            x = normalize_image(images_u8.float(), cfg.preprocess)
            cls, loc = det.model(x)
            return postprocess_batch(cls, loc, anchors, cfg.anchors, post,
                                     float(size), float(size))

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
    log(f"phase 5: bench path batch {BATCH} at {size}x{size} bf16: "
        f"{bench_ms:.3f} ms/batch = {img_s:.1f} img/s ({smi}); "
        f"valid detections per image {int(n_valid.min())}..{int(n_valid.max())}")
    log(f"  NMS kernel launches in phases 4-5: {launches_one} at B=1, "
        f"{launches_batched} batched")
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
    args = (post.nms_iou_threshold, post.max_detections)
    b1, s1 = boxes_k[:1], scores_k[:1]
    for _ in range(3):
        nms_cuda.greedy_nms_rank(boxes_k, scores_k, *args)
    times = {"plain": [], "kernel": [], "plain1": [], "kernel1": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = (nms_cuda.greedy_nms_rank_plain if name == "plain"
              else nms_cuda.greedy_nms_rank)
        times[name].append(cuda_ms(lambda: fn(boxes_k, scores_k, *args),
                                   2 if name == "plain" else 20))
        times[name + "1"].append(cuda_ms(lambda: fn(b1, s1, *args),
                                         2 if name == "plain" else 20))
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    log(f"phase 7: NMS at ({BATCH}, {boxes_k.shape[1]}, {post.max_detections}): "
        f"kernel {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms; at B=1: kernel "
        f"{ms['kernel1']:.4f} ms, plain {ms['plain1']:.4f} ms ({smi})")

    del det, model32, images_u8, boxes_k, scores_k, out
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
    blocked_err = phase12_blocked(nms_rows, post, dev)
    tta = phase13(cfg, dev, smi)
    vote_err = max(vote_err, phase12_real(tta["vote_inputs"], post, dev))
    tta_ms, tta_bounds = phase14(tta["vote_inputs"], nms_rows, post, dev, smi)

    n_rows, n_box = BATCH, post.pre_nms_topk
    # The argmax-loop NMS: 20 bytes a box in, its rank out; in each dependent
    # step an IoU, a threshold test and an argmax compare for every box that
    # is still active, counted from this run's rows.
    pair_ops = IOU_OPS + TEST_OPS + ARGMAX_OPS
    b_nms = bound(n_rows * n_box * 24, int(nms_pairs.sum()) * pair_ops, PEAK_F32)
    b_nms1 = bound(n_box * 24, int(nms_pairs[0]) * pair_ops, PEAK_F32)
    kernels = [
        {"name": "greedy_nms_rank (batched)", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "dan_tpu/ops/nms_batched_pallas.py:29", "launches": launches_batched,
         "launches_tta": tta["nms_launches"], "max_abs_err": err_b, "ms": ms["kernel"],
         "plain_ms": ms["plain"], "bound_ms": b_nms[0], "bound_by": b_nms[1],
         "dependent_steps": int(kept_rows.max()), "library_ms": None},
        {"name": "greedy_nms_rank (B=1)", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "dan_tpu/ops/nms_pallas.py:34", "launches": launches_one,
         "max_abs_err": err_1, "ms": ms["kernel1"], "plain_ms": ms["plain1"],
         "bound_ms": b_nms1[0], "bound_by": b_nms1[1],
         "dependent_steps": int(kept_rows[0]), "library_ms": None},
    ]
    for name, (_, src, replaces) in TRAIN_KERNELS.items():
        entry = {
            "name": name, "route": "cuda", "source": f"dan_tpu_torch/csrc/{src}.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": errs[name],
            "ms": train_ms[name]["kernel"], "plain_ms": train_ms[name]["plain"],
            "library_ms": train_ms[name].get("library")}
        if name != "matcher":
            ms_b, by = train_bounds[name]
            kernels.append(dict(entry, bound_ms=ms_b, bound_by=by))
            continue
        # The matcher's wrapper launches both passes: one entry for each TPU
        # kernel, its own bound and half of the launches; the times are the
        # wrapper's (both passes and the tensor work between them).
        for pass_name, line in (("matcher pass 1", 87), ("matcher pass 2", 208)):
            ms_b, by = train_bounds[pass_name]
            kernels.append(dict(
                entry, name=pass_name, replaces=f"dan_tpu/ops/matching_pallas.py:{line}",
                launches=launches[name] // 2, bound_ms=ms_b, bound_by=by,
                ms_covers="both passes through match_anchors_cuda"))
    vote_src = "dan_tpu_torch/csrc/bbox_vote.cu"
    kernels += [
        {"name": "bbox_vote (batched)", "route": "cuda", "source": vote_src,
         "replaces": "dan_tpu/ops/bbox_vote_pallas.py:162", "launches": tta["vote_launches"],
         "max_abs_err": vote_err, "ms": tta_ms["vote"]["kernel"],
         "plain_ms": tta_ms["vote"]["plain"], "bound_ms": tta_bounds["vote"][0],
         "bound_by": tta_bounds["vote"][1], "dependent_steps": tta_bounds["vote"][2],
         "library_ms": None},
        {"name": "bbox_vote (B=1)", "route": "cuda", "source": vote_src,
         "replaces": "dan_tpu/ops/bbox_vote_pallas.py:30", "launches": tta["vote_launches_one"],
         "max_abs_err": vote_err, "ms": tta_ms["vote1"]["kernel"],
         "plain_ms": tta_ms["vote1"]["plain"], "bound_ms": tta_bounds["vote1"][0],
         "bound_by": tta_bounds["vote1"][1], "dependent_steps": tta_bounds["vote1"][2],
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


def phase9(cfg, dev):
    """Each train kernel against its plain version at the train shapes;
    returns the max errors and the inputs phase 11 times."""
    size = cfg.preprocess.train_image_size
    batch = edge_case_batch(cfg)
    t = to_device(batch, dev)
    draws = sample_augment_batch(batch["seed"], cfg.preprocess)
    images, boxes, mask = train_preprocess(
        t["canvas"], (t["crop_x0"], t["crop_y0"], t["crop_size"]), t["boxes"],
        t["mask"], draws, cfg.preprocess)
    if not (bool(mask[31, 200]) and not bool(mask[30].any())):
        raise AssertionError("the edge-case gts did not survive the preprocess")
    anchors = generate_anchors(cfg.anchors, size, size, dev)
    margs = (anchors, boxes, mask, cfg.match, cfg.anchors)
    got = matching_cuda.match_anchors_cuda(*margs)
    want = match_anchors(*margs)
    torch.cuda.synchronize()
    if not (torch.equal(got.cls_target, want.cls_target)
            and torch.equal(got.matched_gt, want.matched_gt.to(torch.int32))):
        raise AssertionError(
            f"matcher kernel != plain: {int((got.cls_target != want.cls_target).sum())} "
            f"cls targets, {int((got.matched_gt != want.matched_gt).sum())} matched gts differ")
    e_iou = float((got.matched_iou - want.matched_iou).abs().max())
    e_loc = float((got.loc_target - want.loc_target).abs().max())
    npos = (got.cls_target == 1).sum(dim=1)
    log(f"phase 9: matcher kernel == plain at B={TRAIN_BATCH} A={anchors.shape[0]} "
        f"G={boxes.shape[1]}: cls_target and matched_gt identical; max |diff| "
        f"matched_iou {e_iou:.3e}, loc_target {e_loc:.3e}; positives per image "
        f"{int(npos.min())}..{int(npos.max())} (image 30: {int(npos[30])}, "
        f"gt 200 of image 31 matched: {bool(((got.matched_gt[31] == 200) & (got.cls_target[31] == 1)).any())})")
    if int(npos[30]) != 0 or not bool(((got.matched_gt[31] == 200)
                                       & (got.cls_target[31] == 1)).any()):
        raise AssertionError("edge cases: image 30 has positives or gt 200 is unmatched")

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

    # conv1_2' weight grad at full shape.
    o1 = nhwc(o1_pre)
    del o1_pre
    dr = torch.randn((TRAIN_BATCH, o1.shape[1] + 1, o1.shape[2] + 1, 256),
                     generator=gen, device=dev, dtype=torch.bfloat16)
    k_a = conv12_wgrad_cuda.conv12_wgrad(o1, dr)
    k_b = conv12_wgrad_cuda.conv12_wgrad(o1, dr)
    plain = conv12_wgrad_cuda.conv12_wgrad_plain(o1, dr)
    torch.cuda.synchronize()
    e_w = rel_l2(k_a, plain)
    same = torch.equal(k_a, k_b)
    log(f"phase 9: conv12 wgrad kernel vs plain (f32, TF32 off) at o1 "
        f"{tuple(o1.shape)}, dr {tuple(dr.shape)}: rel L2 {e_w:.3e} (limit 1e-4), "
        f"max |diff| {float((k_a - plain).abs().max()):.3e}; two runs identical: {same}")
    if not (e_w <= 1e-4 and same):
        raise AssertionError("conv12 wgrad kernel out of tolerance or not deterministic")
    errs = {"matcher": max(e_iou, e_loc), "phase_pool_bwd": 0.0,
            "conv12_wgrad": float((k_a - plain).abs().max())}
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
    return out, bounds


# ---------------------------------------------------------------------------
# the TTA evaluation path: phases 12-14
# ---------------------------------------------------------------------------


def compare_vote(boxes, scores, valid, thr, max_out, what) -> float:
    """Vote kernel vs plain version on the same CUDA tensors.  Raises unless
    valid, scores and output counts are identical, boxes within rtol 1e-5 /
    atol 1e-4, and two kernel runs give the same bits.  Returns max |box
    diff|."""
    got = bbox_vote_cuda.bbox_vote_batched_cuda(boxes, scores, valid, thr, max_out)
    again = bbox_vote_cuda.bbox_vote_batched_cuda(boxes, scores, valid, thr, max_out)
    want = bbox_vote_batched(boxes, scores, valid, thr, max_out)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"vote kernel: two runs differ on {what}")
    if not (torch.equal(got.valid, want.valid) and torch.equal(got.scores, want.scores)):
        raise AssertionError(
            f"vote kernel != plain on {what}: {int((got.valid != want.valid).sum())} valid "
            f"flags, {int((got.scores != want.scores).sum())} scores differ")
    err = float((got.boxes - want.boxes).abs().max())
    if not torch.allclose(got.boxes, want.boxes, rtol=1e-5, atol=1e-4):
        raise AssertionError(f"vote kernel boxes off by {err:.3e} on {what}")
    counts = got.valid.sum(dim=1)
    log(f"  vote kernel == plain on {what} {tuple(scores.shape)} -> {max_out}: valid and "
        f"scores identical, max |box diff| {err:.3e} (rtol 1e-5, atol 1e-4), two runs "
        f"identical; outputs per row {int(counts.min())}..{int(counts.max())}")
    return err


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
    for row in (0, 2, 6):  # the same kernel at B = 1
        err = max(err, compare_vote(b[row:row + 1], s[row:row + 1], v[row:row + 1],
                                    thr, max_out, f"edge row {row} at B=1"))
    err = max(err, compare_vote(b[:, :257].contiguous(), s[:, :257].contiguous(),
                                v[:, :257].contiguous(), thr, 20, "257-long rows, max_out 20"))
    return err


def phase12_real(vote_inputs, post, dev) -> float:
    """The vote kernel on the packed pre-vote detections of the TTA run."""
    b, s, v = (torch.from_numpy(a).to(dev) for a in vote_inputs[0])
    log(f"phase 12: vote kernel on the TTA run's own pre-vote rows; valid detections per "
        f"image {int(v.sum(dim=1).min())}..{int(v.sum(dim=1).max())}")
    return compare_vote(b, s, v, post.vote_iou_threshold, post.max_detections,
                        "the TTA run's first vote chunk")


def phase12_blocked(nms_rows, post, dev) -> float:
    """The blocked NMS kernel: kept set against its plain version and
    against the argmax-loop kernel's ranks."""
    boxes, scores = nms_rows
    thr, max_out = post.nms_iou_threshold, post.max_detections
    rng = np.random.default_rng(SEED + 9)
    small_b = torch.from_numpy(random_boxes(rng, 257)).to(dev)
    small_s = torch.from_numpy(np.sort(rng.uniform(0.01, 1.0, 257).astype(np.float32))[::-1]
                               .copy()).to(dev)
    cases = [(boxes[i], scores[i], thr, 0.0) for i in range(boxes.shape[0])]
    cases += [(small_b, small_s, 0.4, 0.0), (small_b, small_s, 0.3, 0.5),
              (small_b, torch.zeros_like(small_s), 0.3, 0.0)]
    log("phase 12: blocked NMS kernel against its plain version and the argmax-loop kernel")
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
                    f"{off[0]} kept entries differ from plain, {off[1]} from the argmax-loop "
                    f"kernel")
        log(f"  blocked NMS == plain == argmax-loop kernel at N={sc.shape[0]} thr={t} "
            f"score_thr={sthr}: kept sets identical, {int(got.valid.sum())} within max_out")
    return float(diff)


class RecordingRunner(TTARunner):
    """The TTA runner, keeping the host arrays of every vote launch so that
    phase 12 can hold the kernel against its plain version on them."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.vote_inputs = []

    def _run_vote(self, boxes_b, scores_b, valid_b):
        self.vote_inputs.append((boxes_b, scores_b, valid_b))
        return super()._run_vote(boxes_b, scores_b, valid_b)


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
    if stats != want_stats:
        raise AssertionError(f"last_run_stats {stats} != planned {want_stats}")
    if (nms_ds, vote_ds) != (stats["bucket_launches"], stats["vote_launches"]):
        raise AssertionError("the kernels' launch counters do not match last_run_stats")
    if (nms_one, vote_one) != (single_groups, len(singles)):
        raise AssertionError(f"detect_tta launched {nms_one} NMS / {vote_one} vote kernels, "
                             f"expected {single_groups} / {len(singles)}")
    if list(got) != [k for k, _ in keyed]:
        raise AssertionError("run_dataset lost or reordered keys")

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
    versions, and their bounds from these inputs."""
    thr, max_out = post.vote_iou_threshold, post.max_detections
    b, s, v = (torch.from_numpy(a).to(dev) for a in vote_inputs[0])
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
    argmax_ms = cuda_ms(lambda: rank_to_result(
        nms_cuda.greedy_nms_rank(bx[None], sc[None], nthr, max_out), bx[None], sc[None],
        max_out), 20)
    argmax_launch_ms = cuda_ms(
        lambda: nms_cuda.greedy_nms_rank(bx[None], sc[None], nthr, max_out), 20)
    log(f"phase 14: bbox_vote at {tuple(s.shape)} -> {max_out}: kernel "
        f"{out['vote']['kernel']:.4f} ms, plain {out['vote']['plain']:.4f} ms; at B=1: kernel "
        f"{out['vote1']['kernel']:.4f} ms, plain {out['vote1']['plain']:.4f} ms ({smi})")
    log(f"phase 14: greedy_nms_blocked at ({sc.shape[0]}, {max_out}): the wrapper (order check "
        f"that waits for the device, both passes, rank_to_result) "
        f"{out['blocked']['kernel']:.4f} ms, its two passes alone "
        f"{out['blocked']['launch']:.4f} ms, plain {out['blocked']['plain']:.4f} ms; the "
        f"argmax-loop kernel at B=1 with rank_to_result {argmax_ms:.4f} ms, alone "
        f"{argmax_launch_ms:.4f} ms ({smi})")

    # Bounds, from what these inputs need.  Vote: 21 bytes a detection in,
    # 21 an output slot; in each dependent step an IoU, a test and an argmax
    # compare for every detection still active, and five multiply-adds once
    # for every detection that merges.
    res = bbox_vote_cuda.bbox_vote_batched_cuda(b, s, v, thr, max_out)
    steps, pairs, merged = selection_work(b, s, v & (s > 0.0), thr, max_out, True)
    if not torch.equal(steps, res.valid.sum(dim=1)):
        raise AssertionError("the replay of the vote counts other steps than the kernel")
    n_rows, r = s.shape
    pair_ops = IOU_OPS + TEST_OPS + ARGMAX_OPS
    vote_ops = pairs * pair_ops + merged * MERGE_OPS
    bounds = {
        "vote": bound(n_rows * 21 * (r + max_out), int(vote_ops.sum()), PEAK_F32)
        + (int(steps.max()),),
        "vote1": bound(21 * (r + max_out), int(vote_ops[0]), PEAK_F32) + (int(steps[0]),),
    }
    # Blocked NMS: 20 bytes a box in, 1 out; an IoU and a test for every
    # (kept box, later box not yet removed) pair up to the max_out-th kept
    # box (sorted input: no argmax); the scan's chain is one step a 64-box
    # tile.
    n = sc.shape[0]
    _, k9_pairs, _ = selection_work(bx[None], sc[None], sc[None] > 0.0, nthr, max_out, False)
    bounds["blocked"] = bound(21 * n, int(k9_pairs[0]) * (IOU_OPS + TEST_OPS), PEAK_F32) + (
        -(-n // nms_blocked_cuda.TILE),)
    log(f"  this run's work: vote {int(pairs.sum())} IoU pairs and {int(merged.sum())} merges "
        f"over {n_rows} rows ({int(pairs[0])} and {int(merged[0])} in row 0); blocked NMS "
        f"{int(k9_pairs[0])} IoU pairs of {n * (n - 1) // 2}")
    for name, (ms_b, by, chain) in bounds.items():
        log(f"  bound {name}: {ms_b:.5f} ms by {by}; {chain} dependent steps")
    return out, bounds


if __name__ == "__main__":
    sys.exit(main())
