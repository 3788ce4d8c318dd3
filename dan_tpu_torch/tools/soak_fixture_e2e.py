"""The real-data path end to end over the committed mini-WIDER fixture
(counterpart of scripts/soak_fixture_e2e.py): TFRecord conversion (the
TF-free data/tfrecords.py) -> read back to JPEG files -> the
multi-producer TrainPipeline -> device_prefetch -> train steps -> a train
checkpoint -> the eval CLI in a subprocess with the OFFICIAL .mat ground
truth, on the first CUDA card (or --device cpu).

    python -m dan_tpu_torch.tools.soak_fixture_e2e [--steps 300] [--batch 8] [--lr 5e-4]
        [--work_dir DIR] [--device cpu]

The recipe is the reference's: lr 5e-4, global-norm clip 10, warm-up 50,
from random weights (seed 0); the loss is read every 50 steps and at the
last step, and must be finite.  The eval CLI runs as `python -m
dan_tpu_torch.eval --wider_root FIX --ckpt <model_dir> --no_tta --gt_mats
FIX/eval_tools/ground_truth` and must exit 0 with its "WIDER FACE" AP line.
`run(args, config)` returns what the soak measured (img/s, the last loss,
the eval CLI's stdout); `config` takes a DANConfig for the train steps in
place of the default (the tests train at a small size).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

from dan_tpu_torch.ckpt import train_state as ckpt
from dan_tpu_torch.config import DANConfig, default_config
from dan_tpu_torch.data.pipeline import TrainPipeline, device_prefetch
from dan_tpu_torch.data.tfrecords import convert_to_tfrecords, read_tfrecords
from dan_tpu_torch.data.widerface import load_split
from dan_tpu_torch.device import resolve_device
from dan_tpu_torch.train.loop import create_train_state, train_step

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FIX = os.path.join(REPO, "tests", "fixtures", "mini_wider")
LOG_EVERY = 50


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dan_tpu_torch.tools.soak_fixture_e2e")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--work_dir", default=None)
    ap.add_argument("--device", default=None, help="torch device; default: the first CUDA card")
    return ap.parse_args(argv)


def tfrecord_roundtrip(work: str):
    """The fixture -> 4 shards -> records whose JPEGs are written back to
    files under work/roundtrip; image and box counts asserted.  Returns
    (records, seconds of the conversion, seconds of the read-back, bytes of
    the shards)."""
    records = load_split(FIX, "val")
    t0 = time.perf_counter()
    paths = convert_to_tfrecords(records, os.path.join(work, "tfr"), split="train",
                                 num_shards=4)
    t_write = time.perf_counter() - t0
    rt_dir = os.path.join(work, "roundtrip")
    rt_records = []
    t0 = time.perf_counter()
    for rec, encoded in read_tfrecords(paths):
        p = os.path.join(rt_dir, rec.rel_path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(encoded)
        rt_records.append(dataclasses.replace(rec, path=p))
    t_read = time.perf_counter() - t0
    n_in, n_rt = sum(len(r.boxes) for r in records), sum(len(r.boxes) for r in rt_records)
    if len(rt_records) != len(records) or n_rt != n_in:
        raise AssertionError(f"tfrecord roundtrip: {len(rt_records)} images / {n_rt} boxes "
                             f"back of {len(records)} / {n_in}")
    size = sum(os.path.getsize(p) for p in paths)
    print(f"tfrecord roundtrip OK: {len(rt_records)} images, {n_rt} boxes", file=sys.stderr)
    return rt_records, t_write, t_read, size


def run(args, config: Optional[DANConfig] = None) -> dict:
    device = resolve_device(args.device)
    work = args.work_dir or tempfile.mkdtemp(prefix="dan_torch_soak_")
    os.makedirs(work, exist_ok=True)
    model_dir = os.path.join(work, "model")

    # 1. TFRecord roundtrip in the loop: fixture -> shards -> records + JPEGs.
    rt_records, t_write, t_read, size = tfrecord_roundtrip(work)

    # 2. Train on the roundtripped files through the host pipeline.
    cfg = config or default_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, batch_size=args.batch, learning_rate=args.lr, grad_clip_norm=10.0,
        warmup_steps=50))
    state = create_train_state(cfg, 0, device)
    pipe = TrainPipeline(rt_records, cfg, seed=0, num_workers=4)
    it = device_prefetch(iter(pipe), device)
    t0 = time.time()
    loss = None
    try:
        for i in range(args.steps):
            m = train_step(state, next(it))
            if (i + 1) % LOG_EVERY == 0 or i + 1 == args.steps:
                loss = float(m["loss"])
                ips = (i + 1) * args.batch / (time.time() - t0)
                print(f"step {i + 1}: loss={loss:.3f} npos={float(m['num_pos']):.0f} "
                      f"({ips:.1f} img/s)", file=sys.stderr)
    finally:
        it.close()  # closes the pipeline's stream, which joins its producers
    if loss is None or not math.isfinite(loss):
        raise AssertionError(f"diverged: {loss}")
    path = ckpt.save(model_dir, args.steps, state)
    print(f"checkpoint {path}", file=sys.stderr)

    # 3. Official-protocol AP through the eval CLI (.mat ground truth).
    cmd = [sys.executable, "-m", "dan_tpu_torch.eval", "--wider_root", FIX, "--ckpt", model_dir,
           "--no_tta", "--output_dir", os.path.join(work, "preds"),
           "--gt_mats", os.path.join(FIX, "eval_tools", "ground_truth")]
    if args.device:
        cmd += ["--device", args.device]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=3600)
    sys.stderr.write(proc.stderr[-2000:])
    print(proc.stdout.strip())
    if proc.returncode != 0 or "WIDER FACE" not in proc.stdout:
        raise AssertionError(f"the eval CLI exited {proc.returncode}")
    print(f"soak artifacts in {work}", file=sys.stderr)
    return {"img_s": ips, "loss": loss, "eval_stdout": proc.stdout, "eval_stderr": proc.stderr,
            "tfrecord_write_s": t_write, "tfrecord_read_s": t_read, "tfrecord_bytes": size,
            "model_dir": model_dir}


def main(argv=None, config: Optional[DANConfig] = None) -> int:
    run(parse_args(argv), config)
    return 0


if __name__ == "__main__":
    sys.exit(main())
