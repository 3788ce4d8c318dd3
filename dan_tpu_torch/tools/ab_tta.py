#!/usr/bin/env python
"""Time the TTA path of two checkouts of this repository on one CUDA card,
in turns A, B, B, A, so that the two are compared on the same card in the
same call.

    python3 dan_tpu_torch/tools/ab_tta.py DIR_A DIR_B [--images 160] [--reps 3]

Each turn is a fresh process started in its checkout (which builds that
checkout's kernels and imports its `dan_tpu_torch` and `chip_smoke.py`):
random-init weights (seed 0) at the default config, `warmup_tta` for the
images' sizes, then `detect_tta` on one image of each size `--reps` times
(host clock a call) and `detect_tta_dataset` over all `--images` images
twice (host clock, synchronised), on `chip_smoke.tta_images`.  The last line
is one JSON object with every turn's readings and the card's name and power
limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def child(n_images: int, reps: int) -> None:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from chip_smoke import SEED, TTA_SIZES, tta_images
    from dan_tpu_torch.api import Detector
    from dan_tpu_torch.config import default_config

    dev = torch.device("cuda", 0)
    cfg = default_config()
    det = Detector.from_random(SEED, cfg, dev)
    keyed = [(k, im) for k, im, _ in tta_images(n_images)]
    det.warmup_tta([im.shape[:2] for _, im in keyed])
    singles = keyed[:len(TTA_SIZES)]
    for _, im in singles:  # the first detect_tta builds the kernels
        det.detect_tta(im)
    torch.cuda.synchronize()
    one = []
    for _ in range(reps):
        for _, im in singles:
            t0 = time.perf_counter()
            det.detect_tta(im)
            one.append((time.perf_counter() - t0) * 1e3)
    runs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det.detect_tta_dataset(keyed)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    print(json.dumps({"detect_tta_ms_mean": float(np.mean(one)),
                      "detect_tta_ms_median": float(np.median(one)),
                      "dataset_images_per_s": [n_images / s for s in runs]}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*")
    ap.add_argument("--images", type=int, default=160)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.images, args.reps)
        return 0
    if len(args.dirs) != 2:
        ap.error("give two checkouts, DIR_A and DIR_B")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    turns = []
    for side, path in zip("ABBA", (args.dirs[0], args.dirs[1], args.dirs[1], args.dirs[0])):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", "--images", str(args.images),
             "--reps", str(args.reps)],
            cwd=path, capture_output=True, text=True, check=True).stdout
        reading = json.loads(out.strip().splitlines()[-1])
        print(side, path, reading, flush=True)
        turns.append(dict(reading, side=side, dir=path))
    print(json.dumps({"card": smi, "turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
