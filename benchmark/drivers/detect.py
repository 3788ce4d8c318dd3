"""Driver of the batch-detect mixes: offline batch evaluation through the
port's one bench path, `dan_tpu_torch.tools.bench.build_detect_fn`
(normalize -> forward -> decode -> top-k -> NMS), at the configuration's
precision (bfloat16, or the int8 body of `quant.QuantizedDetector`).

Traffic (the mix's "params"):
  batch, pool         images a call; seeded uint8 noise batches in pinned
                      host memory that the calls cycle through
  warmup_calls        calls made in set-up
  sample_calls,       calls of the window whose outputs are checked, drawn
  sample_within       from the seed among its first `sample_within`
  trace_calls         calls profiled in a --trace 1 run
  check_images        images of each sampled call that are checked, drawn
                      from the seed
  check_block         images the reference computes at a time

A call copies its batch to the card, runs the detect function and copies
the detections back; the next call is enqueued before the wait for the
previous one's detections.  The rate counts images whose detections
reached host memory over the whole window, its final drain included.

The check (see `check`): the program's logits of the sampled calls
against the reference's forward on the same images and weights
(`logit_rel_l2`, the worst image), and the program's detections against
the reference's tail run on the program's own logits (`det_mismatch`, the
slots that differ).
"""
from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from benchmark import program
from benchmark.harness import Outcome, Run, log
from benchmark.reference import detect as ref_detect
from benchmark.reference import model as ref
from benchmark.reference import quant as ref_quant
from benchmark.reference.lowp import Control
from benchmark.weights import generator, make_weights

FAULTS = ("alter_answer", "half_batch")


def _pool(run: Run, size: int):
    """The seeded uint8 batches, made on the device, kept in pinned host memory."""
    p = run.params
    g = generator(run.seed, run.device, 2)
    cuda = torch.device(run.device).type == "cuda"
    pool = []
    for _ in range(p["pool"]):
        b = torch.randint(0, 255, (p["batch"], size, size, 3), dtype=torch.uint8,
                          device=run.device, generator=g)
        pool.append(b.cpu().pin_memory() if cuda else b.cpu())
    return pool


def setup(run: Run) -> Dict:
    from dan_tpu_torch.tools import bench

    p, dan = run.params, run.dan
    cfg = program.dan_config(dan)
    size = cfg.model.image_size
    weights = make_weights(ref.param_spec(dan), run.seed, run.device)
    pool = _pool(run, size)
    precision = run.cell.config["precision"]
    n_cal = run.cell.config.get("calibration_images", 0)
    calib_u8 = pool[0][:n_cal].to(run.device) if n_cal else None
    if run.control:
        calib = ref.normalize(calib_u8, dan) if n_cal else None
        model = Control(weights, dan, precision, calib, p["check_block"])
    else:
        model = program.detector(cfg, weights, run.device).eval()
        if precision == "int8":
            from dan_tpu_torch import quant
            from dan_tpu_torch.models.detector import compute_dtype
            from dan_tpu_torch.ops.preprocess import normalize_image

            with torch.inference_mode():
                x_cal = normalize_image(calib_u8.float(), cfg.preprocess)
                scales = quant.calibrate_act_scales(
                    model, [x_cal.to(compute_dtype(cfg.model))], cfg.model)
                model = quant.QuantizedDetector(model, scales).to(run.device).eval()
    detect = bench.build_detect_fn(cfg, run.device)
    st = {"cfg": cfg, "weights": weights, "pool": pool, "model": model, "detect": detect,
          "bench": bench, "calib_u8": calib_u8, "size": size}
    _faults(run, st)
    bufs = [torch.empty_like(pool[0], device=run.device) for _ in range(2)]
    st["bufs"] = bufs
    rng = np.random.default_rng([run.seed, 3])
    st["sample"] = sorted(rng.choice(p["sample_within"], p["sample_calls"], replace=False).tolist())
    st["sample_images"] = torch.from_numpy(np.sort(rng.choice(
        p["batch"], p["check_images"], replace=False)))
    st["captured"], st["dets"], st["calls"] = {}, {}, 0
    # Pipelined as the window calls, so the pinned host pool holds the
    # buffers of two calls in flight before the window opens.
    _calls(run, st, n=p["warmup_calls"])
    st["dets"], st["calls"] = {}, 0

    def capture(mod, args, out):
        if st["calls"] in st["sample"]:
            st["captured"][st["calls"]] = (out[0], out[1])

    model.register_forward_hook(capture)
    return st


def _faults(run: Run, st: Dict) -> None:
    """Break the timed path underneath for a fault reading."""
    if run.fault is None:
        return
    if run.fault not in FAULTS:
        raise SystemExit(f"unknown fault {run.fault!r}; the detect driver has {FAULTS}")
    bench, inner = st["bench"], st["bench"].postprocess_batch
    if run.fault == "alter_answer":
        def altered(*a, **k):
            det = inner(*a, **k)
            det["scores"] = det["scores"].clone()
            det["scores"][:, 0] += 0.25
            return det
        run.patch(bench, "postprocess_batch", altered)
    else:
        model = st["model"]
        st["model"] = lambda x: tuple(torch.cat([t[: len(t) // 2], t[: len(t) - len(t) // 2]])
                                      for t in model(x[: len(x) // 2]))


def _enqueue(run: Run, st: Dict, i: int):
    """Start call i: H2D, detect, D2H into pinned memory; -> (i, event, host dets)."""
    cuda = torch.device(run.device).type == "cuda"
    src, buf = st["pool"][i % len(st["pool"])], st["bufs"][i % 2]
    buf.copy_(src, non_blocking=True)
    det = st["detect"](st["model"], buf)
    host = {k: (torch.empty(v.shape, dtype=v.dtype, pin_memory=True) if cuda else
                torch.empty(v.shape, dtype=v.dtype)) for k, v in det.items()}
    for k, v in det.items():
        host[k].copy_(v, non_blocking=True)
    ev = None
    if cuda:
        ev = torch.cuda.Event()
        ev.record()
    return i, ev, host


def _collect(st: Dict, pending) -> int:
    i, ev, host = pending
    if ev is not None:
        ev.synchronize()
    return len(host["valid"])


def _calls(run: Run, st: Dict, deadline=None, n=None):
    """Pipelined calls until the deadline (host clock), and at least until
    the sampled calls are made, or n calls; -> images done."""
    done, pending, k = 0, None, 0
    least = max(st["sample"]) + 1 if deadline is not None else 0
    while True:
        new = None
        if (n is not None and k < n) or (deadline is not None and (
                time.perf_counter() < deadline or st["calls"] < least)):
            new = _enqueue(run, st, st["calls"])
            st["calls"] += 1
            k += 1
        if pending is not None:
            done += _collect(st, pending)
            if pending[0] in st["sample"]:
                st["dets"][pending[0]] = pending[2]
        pending = new
        if pending is None:
            return done


def window(run: Run, st: Dict) -> Outcome:
    p = run.params
    units = {}
    t0 = time.perf_counter()
    done = 0
    if run.tracer is not None:
        with run.tracer.stretch():
            done += _calls(run, st, n=p["trace_calls"])
        units = {"calls": p["trace_calls"], "images": p["trace_calls"] * p["batch"]}
    done += _calls(run, st, deadline=t0 + run.seconds)
    elapsed = time.perf_counter() - t0
    return Outcome(done / elapsed, attempted=done, failed=0, units=units)


def check(run: Run, st: Dict) -> Dict[str, float]:
    """logit_rel_l2: the worst sampled image's ||program - reference|| /
    ||reference|| over its (cls, loc) logits; det_mismatch: detection slots
    of the sampled calls that differ from the reference tail's on the
    program's logits."""
    dan, block = run.dan, run.params["check_block"]
    captured, dets = st.pop("captured"), st.pop("dets")
    weights, pool, calib_u8 = st["weights"], st["pool"], st["calib_u8"]
    for k in ("model", "detect", "bufs"):
        st.pop(k)
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    int8 = run.cell.config["precision"] == "int8" and not run.control
    scales = ref_quant.calibrate(weights, dan, ref.normalize(calib_u8, dan)) if int8 else None
    pick = st["sample_images"]
    worst, mismatch = 0.0, 0
    for i in st["sample"]:
        if i not in captured or i not in dets:
            log(f"check: call {i} of the sample was not made")
            return {"logit_rel_l2": float("inf"), "det_mismatch": float("inf")}
        cls_p, loc_p = captured[i]
        images = pool[i % len(pool)]
        if len(cls_p) != len(images):
            log(f"check: call {i} returned logits of {len(cls_p)} images for {len(images)}")
            return {"logit_rel_l2": float("inf"), "det_mismatch": float("inf")}
        images = images[pick].to(run.device)
        cls_p, loc_p = cls_p[pick.to(cls_p.device)].float(), loc_p[pick.to(loc_p.device)].float()
        with torch.no_grad(), ref.float32_exact():
            for j in range(0, len(images), block):
                x = ref.normalize(images[j:j + block], dan)
                if scales is not None:
                    cls_r, loc_r = ref_quant.forward(weights, dan, x, scales)
                else:
                    cls_r, loc_r = ref.forward(weights, dan, x)
                got = torch.cat([cls_p[j:j + block], loc_p[j:j + block]], -1)
                want = torch.cat([cls_r, loc_r], -1)
                num = (got - want).double().flatten(1).norm(dim=1)
                rel = num / want.double().flatten(1).norm(dim=1)
                worst = max(worst, float(rel.max()))
            size = st["size"]
            det_r, _ = ref_detect.postprocess(cls_p, loc_p, dan, size, size)
        got = {k: v[pick].to(run.device) for k, v in dets[i].items()}
        mismatch += ref_detect.mismatched_rows(got, det_r)
    log(f"check: sampled calls {st['sample']}, images {pick.tolist()}")
    return {"logit_rel_l2": worst, "det_mismatch": float(mismatch)}
