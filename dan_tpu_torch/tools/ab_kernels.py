#!/usr/bin/env python
"""Time the NMS, matcher and vote kernels of two checkouts of this
repository on one CUDA card, in turns A, B, B, A, so that the two are
compared on the same card in the same call.

    python3 dan_tpu_torch/tools/ab_kernels.py DIR_A DIR_B [--reps 5]

Each turn is a fresh process started in its checkout (which builds that
checkout's kernels and imports its `dan_tpu_torch` and `chip_smoke.py`), at
the default shapes of `chip_smoke.py`: K1 on the (128, 5000) rows of a
random-init 640x640 forward (seed 0), K2 on the first of them, the matcher
call on the train batch (32, 640x640, `synthetic_batch` seed 0) with its
three kernels' profiler device time, K7 on 128 vote rows of 6,000 (the 7
seeded edge rows of `chip_smoke.vote_edge_rows`, repeated) and K8 on the
first.  Each time is the mean of 20 back-to-back calls (CUDA events), `--reps`
times; a reading gives their mean and min.  The last line is one JSON
object with every turn's readings, each checkout's ptxas register lines and
the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys

SOURCES = ("nms", "matching", "bbox_vote")


def child(reps: int) -> None:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from dan_tpu_torch.ops import _cuda_build, bbox_vote_cuda, matching_cuda, nms_cuda

    _cuda_build.build_all(SOURCES)
    dev = torch.device("cuda", 0)
    cfg = cs.default_config()
    post = cfg.postprocess
    det = cs.Detector.from_random(cs.SEED, cfg, dev)
    rng = np.random.default_rng(cs.SEED)
    images = torch.from_numpy(
        rng.integers(0, 255, (cs.BATCH, 640, 640, 3), dtype=np.uint8)).to(dev)
    boxes, scores = cs.nms_candidates(det, images)
    del det, images
    b1, s1 = boxes[:1].contiguous(), scores[:1].contiguous()
    tcfg = cs.train_config(cfg)
    size = tcfg.preprocess.train_image_size
    _, gts, mask = cs.preprocessed(cs.synthetic_batch(tcfg, cs.TRAIN_BATCH, seed=cs.SEED), tcfg,
                                   dev)
    margs = (cs.generate_anchors(tcfg.anchors, size, size, dev), gts, mask, tcfg.match,
             tcfg.anchors)
    rows = np.arange(cs.BATCH) % 7
    vb, vs, vv = (torch.from_numpy(np.ascontiguousarray(a[rows])).to(dev)
                  for a in cs.vote_edge_rows(np.random.default_rng(12), 6000))
    thr, vthr, max_out = post.nms_iou_threshold, post.vote_iou_threshold, post.max_detections
    calls = {
        "K1": lambda: nms_cuda.greedy_nms_rank(boxes, scores, thr, max_out),
        "K2": lambda: nms_cuda.greedy_nms_rank(b1, s1, thr, max_out),
        "matcher": lambda: matching_cuda.match_anchors_cuda(*margs),
        "K7": lambda: bbox_vote_cuda.bbox_vote_batched_cuda(vb, vs, vv, vthr, max_out),
        "K8": lambda: bbox_vote_cuda.bbox_vote_batched_cuda(vb[:1], vs[:1], vv[:1], vthr,
                                                            max_out),
    }
    out = {}
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ms = [cs.cuda_ms(fn, 20) for _ in range(reps)]
        out[name] = {"mean_ms": float(np.mean(ms)), "min_ms": min(ms)}
    out["matcher_device_ms"] = cs.device_ms(calls["matcher"], 20, cs.MATCHER_KERNELS)[0]
    out["ptxas"] = {s: [line for line in _cuda_build.ptxas_summary(s) if "registers" in line]
                    for s in SOURCES}
    print(json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.reps)
        return 0
    if len(args.dirs) != 2:
        ap.error("give two checkouts, DIR_A and DIR_B")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    turns = []
    for side, path in zip("ABBA", (args.dirs[0], args.dirs[1], args.dirs[1], args.dirs[0])):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--reps", str(args.reps)],
            cwd=path, capture_output=True, text=True, check=True).stdout
        reading = json.loads(out.strip().splitlines()[-1])
        print(side, path, json.dumps(reading), flush=True)
        turns.append(dict(reading, side=side, dir=path))
    print(json.dumps({"card": smi, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
