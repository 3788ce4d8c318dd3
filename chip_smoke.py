#!/usr/bin/env python
"""Drive the PyTorch port's detect path and train step on one CUDA card and
check them.

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
     shapes.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.  Imports no JAX.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dan_tpu.config import default_config
from dan_tpu.data.synthetic import synthetic_batch
from dan_tpu_torch.api import Detector
from dan_tpu_torch.box.anchors import generate_anchors
from dan_tpu_torch.box.matching import match_anchors
from dan_tpu_torch.ckpt import train_state as ckpt
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.models.vgg import phase_pool_with_winner, nhwc
from dan_tpu_torch.ops import (
    _cuda_build,
    conv12_wgrad_cuda,
    matching_cuda,
    nms_cuda,
    phase_pool_cuda,
)
from dan_tpu_torch.ops.preprocess import sample_augment_batch, train_preprocess
from dan_tpu_torch.train import __main__ as train_cli
from dan_tpu_torch.train.loop import (
    create_train_state,
    loss_and_grads,
    preprocess_and_match,
    to_device,
)
from dan_tpu_torch.train.optim import sgd_update
from dan_tpu_torch.ops.nms import rank_to_result
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
    t0 = time.perf_counter()
    _cuda_build.build_all(["nms"] + [src for _, src, _ in TRAIN_KERNELS.values()])
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

    # -- 8. build of the train-step kernels ---------------------------------
    for name, (_, src, _) in TRAIN_KERNELS.items():
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
    train_ms = phase11(cases, smi)

    kernels = [
        {"name": "greedy_nms_rank (batched)", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "dan_tpu/ops/nms_batched_pallas.py:29", "launches": launches_batched,
         "max_abs_err": err_b, "ms": ms["kernel"], "plain_ms": ms["plain"]},
        {"name": "greedy_nms_rank (B=1)", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "dan_tpu/ops/nms_pallas.py:34", "launches": launches_one,
         "max_abs_err": err_1, "ms": ms["kernel1"], "plain_ms": ms["plain1"]},
    ]
    for name, (_, src, replaces) in TRAIN_KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": f"dan_tpu_torch/csrc/{src}.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": errs[name],
            "ms": train_ms[name]["kernel"], "plain_ms": train_ms[name]["plain"]})
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
        kernel(*args)
        plain(*args)
        torch.cuda.synchronize()
        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = kernel if which == "kernel" else plain
            times[which].append(cuda_ms(lambda: fn(*args), 3 if which == "plain" else 10))
        out[name] = {k: float(np.mean(v)) for k, v in times.items()}
        log(f"phase 11: {name}: kernel {out[name]['kernel']:.4f} ms, plain "
            f"{out[name]['plain']:.4f} ms ({smi})")
    return out


if __name__ == "__main__":
    sys.exit(main())
