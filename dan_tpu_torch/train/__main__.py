"""Train the detector with the PyTorch port (counterpart of
scripts/train.py), on one device: the first CUDA card, else the CPU.

    python -m dan_tpu_torch.train --synthetic --steps 100 --model_dir /tmp/smoke
    python -m dan_tpu_torch.train --wider_root /data/widerface --model_dir /tmp/run
    python -m dan_tpu_torch.train ... --resume      # continue the newest checkpoint

From random init the reference recipe (lr 1e-3, no warm-up, no clip)
diverges within a few steps, so a --synthetic run defaults to
--warmup_steps 50 --grad_clip 10, as scripts/train.py does; explicit flags
win.  A non-finite loss at a logging step aborts with exit code 6 and
saves nothing.  Metrics go to stderr and to <model_dir>/train_metrics.jsonl.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time

import torch

from dan_tpu.config import default_config
from dan_tpu_torch.ckpt import train_state as ckpt
from dan_tpu_torch.train.loop import create_train_state, train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dan_tpu_torch.train")
    ap.add_argument("--wider_root", default=None, help="WIDER FACE root dir")
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true", help="synthetic data")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--grad_clip", type=float, default=None)
    ap.add_argument("--warmup_steps", type=int, default=None)
    ap.add_argument("--checkpoint_every", type=int, default=None)
    ap.add_argument("--log_every", type=int, default=None)
    return ap.parse_args(argv)


def make_config(args):
    cfg = default_config()
    overrides = {}
    if args.synthetic:
        if args.warmup_steps is None:
            overrides["warmup_steps"] = 50
        if args.grad_clip is None:
            overrides["grad_clip_norm"] = 10.0
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.lr is not None:
        overrides["learning_rate"] = args.lr
    if args.grad_clip is not None:
        overrides["grad_clip_norm"] = args.grad_clip
    if args.warmup_steps is not None:
        overrides["warmup_steps"] = args.warmup_steps
    if args.checkpoint_every is not None:
        overrides["checkpoint_every"] = args.checkpoint_every
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **overrides))


def batches(args, cfg, start: int):
    """Host batches for steps start, start+1, ...; synthetic batch i is
    seeded with seed + i, so a resumed run sees the batches it would have
    seen without the interruption."""
    if args.synthetic:
        from dan_tpu.data.synthetic import synthetic_batch

        i = start
        while True:
            yield synthetic_batch(cfg, cfg.train.batch_size, seed=args.seed + i)
            i += 1
    else:
        from dan_tpu.data.pipeline import TrainPipeline
        from dan_tpu.data.widerface import load_split

        records = load_split(args.wider_root, "train")
        print(f"loaded {len(records)} train images", file=sys.stderr)
        yield from TrainPipeline(records, cfg, seed=args.seed)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.synthetic and not args.wider_root:
        raise SystemExit("pass --synthetic or --wider_root")
    cfg = make_config(args)
    total_steps = args.steps or cfg.train.total_steps
    log_every = args.log_every or cfg.train.log_every
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    print(f"device: {device}", file=sys.stderr)

    state = create_train_state(cfg, args.seed, device)
    if args.resume and ckpt.latest_step(args.model_dir) is not None:
        ckpt.restore(args.model_dir, state)
        print(f"resumed from step {state.step}", file=sys.stderr)

    os.makedirs(args.model_dir, exist_ok=True)
    t0 = time.time()
    t_last, n_last = time.perf_counter(), 0
    data = batches(args, cfg, state.step)
    with open(os.path.join(args.model_dir, "train_metrics.jsonl"), "a") as log:
        while state.step < total_steps:
            metrics = train_step(state, next(data))
            n_last += 1
            step = state.step
            if step % log_every == 0:
                rec = {k: float(v) for k, v in metrics.items()}  # waits for the device
                if not math.isfinite(rec["loss"]):
                    print(
                        f"FATAL: non-finite loss at step {step}: training diverged. "
                        "From random init pass --warmup_steps 50 --grad_clip 10 "
                        "(or a lower --lr).",
                        file=sys.stderr,
                    )
                    return 6
                now = time.perf_counter()
                rec["images_per_sec"] = n_last * cfg.train.batch_size / (now - t_last)
                t_last, n_last = now, 0
                log.write(json.dumps({"step": step, "time": round(time.time() - t0, 3), **rec}) + "\n")
                log.flush()
                print(f"step {step} " + " ".join(f"{k}={v:.5g}" for k, v in rec.items()),
                      file=sys.stderr)
            if step % cfg.train.checkpoint_every == 0 or step == total_steps:
                print(f"saving {ckpt.save(args.model_dir, step, state)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
