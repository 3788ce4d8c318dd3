"""Train the detector on synthetic bright-square 'faces', then score the
detect path with the WIDER AP protocol on held-out synthetic images (the
port of scripts/smoke_e2e.py): train step, Detector, NMS and AP as one
system, on the first CUDA card (or --device cpu).

    python -m dan_tpu_torch.tools.smoke_e2e [--steps 300] [--batch 8] [--eval_n 24]
        [--lr 5e-4] [--int8] [--device cpu]

The default config trains at 640x640 from random weights with the
synthetic runs' recipe (warm-up 50 steps, global-norm clip 10) on
`synthetic_batch(cfg, batch, seed=i)`, then runs Detector.detect(score
threshold 0.05) over eval_n images drawn from np.random.default_rng(10_000).
The whole run is reproducible: it runs under deterministic() --
torch.use_deterministic_algorithms(True) with cuDNN's autotuner off, so
two runs on one card train the same model bit for bit.  (The LFPN's
upsample takes a gradient without atomic adds on the card in every mode,
models/layers.py; the mode holds every other op to a deterministic
algorithm.)
--int8 also quantizes the trained detector (Detector.quantize_int8, 8 more
held-out images for calibration) and scores the int8 detect path the same
way.  The reference's gates: exit 1 if the hard AP is under 0.5, or, with
--int8, if the int8 hard AP is more than 0.02 under the first.  Both
evaluations run before either gate is applied.

`run(args, config)` trains and evaluates and returns what it found (the
APs, the Detector and the held-out set); `gates(result)` applies the
reference's gates to it; `main(argv, config)` is the two.  `config`
takes a DANConfig in place of the default (the tests run it at a small
size).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from dan_tpu_torch.api import Detector
from dan_tpu_torch.config import DANConfig, default_config
from dan_tpu_torch.data.synthetic import synthetic_batch, synthetic_sample
from dan_tpu_torch.eval.widerface_ap import evaluate_widerface
from dan_tpu_torch.train.loop import create_train_state, train_step

MIN_HARD_AP = 0.5
MAX_INT8_DROP = 0.02


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dan_tpu_torch.tools.smoke_e2e")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--eval_n", type=int, default=24)
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--int8", action="store_true",
                    help="also evaluate the int8-quantized detect path (its hard AP must "
                    f"stay within {MAX_INT8_DROP} of the first)")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the first CUDA card")
    return ap.parse_args(argv)


@contextlib.contextmanager
def deterministic():
    """torch.use_deterministic_algorithms(True) and cuDNN's autotuner off,
    restored on exit.  The LFPN upsample does not depend on it on the card:
    its gradient is csrc/upsample2x_bwd.cu's gather in every mode
    (models/layers.py); the mode keeps cuBLAS's workspace and cuDNN to
    deterministic algorithms, and makes any op without one raise.  The
    mode refuses cuBLAS unless CUBLAS_WORKSPACE_CONFIG is set: it is set
    here (unless the environment sets it) and unset again on exit.  cuBLAS
    reads it once, at a process's first cuBLAS call, so it
    sizes the workspace only where nothing called cuBLAS before (as in
    `python -m dan_tpu_torch.tools.smoke_e2e`); elsewhere it only satisfies
    the mode's check.  The mode's filling of every new uninitialized tensor
    is turned off: no kernel of the port reads memory it has not written,
    and the fill costs about 5 % of a train step on an H100 (chip_smoke.py
    phase 18 times the modes)."""
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if env is None:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    fill = torch.utils.deterministic
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.benchmark, fill.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    fill.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        torch.backends.cudnn.benchmark = prev[2]
        fill.fill_uninitialized_memory = prev[3]
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def run(args, config: Optional[DANConfig] = None) -> Dict:
    """Train, then evaluate (and with args.int8 quantize and evaluate
    again) -> {'train_s', 'train_img_s', 'loss', 'aps': {tag: {'easy',
    'medium', 'hard'}}, 'tag', 'int8'}, and, unless the training diverged,
    'detector', 'eval_set' [(key, image)] and 'gts' {key: boxes}.  Runs
    under deterministic()."""
    with deterministic():
        return _run(args, config)


def _run(args, config: Optional[DANConfig] = None) -> Dict:
    base = config or default_config()
    cfg = dataclasses.replace(base, train=dataclasses.replace(
        base.train, batch_size=args.batch, learning_rate=args.lr, grad_clip_norm=10.0,
        warmup_steps=50))
    state = create_train_state(cfg, 0, args.device)
    t0 = time.time()
    loss = None
    for i in range(args.steps):
        m = train_step(state, synthetic_batch(cfg, args.batch, seed=i))
        if (i + 1) % 50 == 0 or i + 1 == args.steps:
            loss = float(m["loss"])
            print(f"step {i + 1}: loss={loss:.3f} npos={float(m['num_pos']):.0f} "
                  f"({(i + 1) * args.batch / (time.time() - t0):.1f} img/s)", file=sys.stderr)
    train_s = time.time() - t0
    tag = cfg.model.compute_dtype
    result = dict(train_s=train_s, train_img_s=args.steps * args.batch / max(train_s, 1e-9),
                  loss=loss, aps={}, tag=tag, int8=args.int8)
    if loss is None or not np.isfinite(loss):
        return result

    det = Detector(state.model, cfg, device=state.device)
    rng = np.random.default_rng(10_000)
    canvas = cfg.preprocess.canvas_size
    eval_set, gts = [], {}
    for i in range(args.eval_n):
        img, boxes, mask = synthetic_sample(rng, canvas, cfg.match.max_gt)
        eval_set.append((f"synthetic/img_{i}", img))
        gts[f"synthetic/img_{i}"] = boxes[mask].astype(np.float64)
    result.update(detector=det, eval_set=eval_set, gts=gts)

    def run_eval(tag):
        preds = {}
        for key, img in eval_set:
            out = det.detect(img, score_threshold=0.05)
            preds[key] = np.concatenate(
                [out["bboxes"], out["scores"][:, None]], axis=-1).astype(np.float64)
        aps = evaluate_widerface(preds, gts)
        print(f"synthetic-val AP after {args.steps} steps [{tag}]: easy={aps['easy']:.3f} "
              f"medium={aps['medium']:.3f} hard={aps['hard']:.3f}")
        result["aps"][tag] = aps

    run_eval(tag)
    if args.int8:
        calib = [synthetic_sample(rng, canvas, cfg.match.max_gt)[0] for _ in range(8)]
        det.quantize_int8(calib)
        run_eval("int8")
        print(f"int8 hard-AP delta vs {tag}: "
              f"{result['aps']['int8']['hard'] - result['aps'][tag]['hard']:+.4f}")
    return result


def gates(result: Dict) -> int:
    """The reference's gates on a run's result -> exit code: 1 if the
    training diverged, the hard AP is under MIN_HARD_AP, or (int8) the int8
    hard AP is more than MAX_INT8_DROP under the first; else 0."""
    if not result["aps"]:
        print(f"training diverged: loss {result['loss']}", file=sys.stderr)
        return 1
    tag = result["tag"]
    hard = result["aps"][tag]["hard"]
    rc = 0
    if result["int8"] and result["aps"]["int8"]["hard"] < hard - MAX_INT8_DROP:
        print(f"WARNING: int8 AP dropped > {MAX_INT8_DROP} vs {tag}", file=sys.stderr)
        rc = 1
    if hard < MIN_HARD_AP:
        print("WARNING: low AP — stack may be unhealthy", file=sys.stderr)
        rc = 1
    return rc


def main(argv=None, config: Optional[DANConfig] = None) -> int:
    return gates(run(parse_args(argv), config))


if __name__ == "__main__":
    sys.exit(main())
