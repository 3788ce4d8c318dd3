#!/usr/bin/env python
"""Drive the PyTorch port's detect path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each raises on failure; the exit code is 0 only if all pass):
  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build the CUDA NMS kernel (csrc/nms.cu) with nvcc and print the time;
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
     (1, 5000, 750).

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.  Imports no JAX.
"""
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from dan_tpu.config import default_config
from dan_tpu_torch.api import Detector
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.ops import nms_cuda
from dan_tpu_torch.ops.nms import rank_to_result
from dan_tpu_torch.ops.postprocess import filter_and_topk, postprocess_batch
from dan_tpu_torch.ops.preprocess import normalize_image
from dan_tpu_torch.box.decode import decode_boxes

BATCH = 128
SEED = 0
KERNEL_SOURCE = "dan_tpu_torch/csrc/nms.cu"


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
    nms_cuda.build()
    log(f"phase 2: built {KERNEL_SOURCE} in {nms_cuda.BUILD_SECONDS:.3f} s")
    for line in (nms_cuda.BUILD_LOG or "").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

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

    kernels = [
        {"name": "greedy_nms_rank (batched)", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "dan_tpu/ops/nms_batched_pallas.py:29", "launches": launches_batched,
         "max_abs_err": err_b, "ms": ms["kernel"], "plain_ms": ms["plain"]},
        {"name": "greedy_nms_rank (B=1)", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "dan_tpu/ops/nms_pallas.py:34", "launches": launches_one,
         "max_abs_err": err_1, "ms": ms["kernel1"], "plain_ms": ms["plain1"]},
    ]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
