"""Train the detector with the PyTorch port (counterpart of
scripts/train.py), on one device: the first CUDA card, or the CPU with
--device cpu (without a card and without that flag it raises).  Under
torchrun it trains data-parallel, one rank a device (cuda:LOCAL_RANK, NCCL;
--device cpu takes gloo), --batch_size being the global batch:

    python -m dan_tpu_torch.train --synthetic --steps 100 --model_dir /tmp/smoke
    python -m dan_tpu_torch.train --wider_root /data/widerface --model_dir /tmp/run
    python -m dan_tpu_torch.train ... --resume      # continue the newest checkpoint
    python -m dan_tpu_torch.train ... --warm_start /path/model.ckpt   # start from weights
    torchrun --nproc_per_node 4 -m dan_tpu_torch.train --synthetic --model_dir /tmp/dp
    torchrun --nproc_per_node 2 -m dan_tpu_torch.train ... --device cpu

A resumed run, in either branch, sees the batches that the uninterrupted
run would have seen from the restored step on.  Rank 0 logs and writes the
checkpoints; every rank restores them.

--warm_start takes the weights from a checkpoint of any format that
Detector.from_checkpoint reads (a TF1 prefix, a JAX-layout .npz, a .pt or a
model_dir; ckpt/load.py), with momentum zero and the step at 0; under
torchrun every rank loads the same file onto its own device.  --resume wins
when model_dir already holds a checkpoint.

From random init the reference recipe (lr 1e-3, no warm-up, no clip)
diverges within a few steps, so a --synthetic run without --warm_start
defaults to --warmup_steps 50 --grad_clip 10, as scripts/train.py does;
explicit flags win.  A non-finite loss at a logging step writes its record
and aborts with exit code 6, saving nothing.  Metrics go to stderr and to
<model_dir>/train_metrics.jsonl (utils/logging.py's MetricsLogger; the
throughput key is images_per_sec_per_chip, the global rate over the ranks).

    python -m dan_tpu_torch.train ... --trace_dir /tmp/trace   # torch.profiler trace of the steps
    python -m dan_tpu_torch.train ... --debug_nans             # raise at the first non-finite value

--trace_dir writes a Chrome trace of the step loop, one file a rank
(utils/profiling.py).  --debug_nans is the counterpart of the reference's
jax_debug_nans: train_step checks every module's output, runs the backward
in autograd's anomaly mode and checks the loss and the gradients before the
update, so the run exits non-zero with a FloatingPointError naming the
module (or the parameter) before any poisoned parameter is updated or
saved; under torchrun every rank raises at the same step, naming the same
module.  It waits for the device at every module; without it the step is
unchanged.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import sys


from dan_tpu_torch.config import default_config
from dan_tpu_torch.ckpt import train_state as ckpt
from dan_tpu_torch.ckpt.load import load_params
from dan_tpu_torch.data.pipeline import device_prefetch
from dan_tpu_torch.device import resolve_device
from dan_tpu_torch.parallel.mesh import place_replicated, shard_batch, torchrun_mesh
from dan_tpu_torch.train.loop import create_train_state, train_step
from dan_tpu_torch.utils.logging import MetricsLogger
from dan_tpu_torch.utils.profiling import ThroughputMeter, maybe_trace


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dan_tpu_torch.train")
    ap.add_argument("--wider_root", default=None, help="WIDER FACE root dir")
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true", help="synthetic data")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--warm_start", default=None,
                    help="initial weights: a TF1 checkpoint prefix, .npz, .pt or model_dir "
                    "(momentum zero, step 0); --resume wins when model_dir has a checkpoint")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--grad_clip", type=float, default=None)
    ap.add_argument("--warmup_steps", type=int, default=None)
    ap.add_argument("--checkpoint_every", type=int, default=None)
    ap.add_argument("--log_every", type=int, default=None)
    ap.add_argument("--debug_nans", action="store_true",
                    help="raise at the first non-finite module output, loss or gradient, "
                    "before the update (the counterpart of jax_debug_nans)")
    ap.add_argument("--trace_dir", default=None,
                    help="write a torch.profiler Chrome trace of the step loop here")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the first CUDA card (under torchrun "
                    "cuda:LOCAL_RANK); cpu under torchrun runs the ranks on gloo")
    return ap.parse_args(argv)


def make_config(args):
    cfg = default_config()
    overrides = {}
    if args.synthetic and not args.warm_start:
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


def batches(args, cfg, start: int, mesh=None):
    """Host batches (this rank's rows of each global batch) for steps
    start, start+1, ...; synthetic batch i is seeded with seed + i and the
    WIDER pipeline starts at step `start`, so a resumed run sees the
    batches it would have seen without the interruption."""
    if args.synthetic:
        from dan_tpu_torch.data.synthetic import synthetic_batch

        i = start
        while True:
            batch = synthetic_batch(cfg, cfg.train.batch_size, seed=args.seed + i)
            yield batch if mesh is None else shard_batch(batch, mesh)
            i += 1
    else:
        from dan_tpu_torch.data.pipeline import TrainPipeline
        from dan_tpu_torch.data.widerface import load_split

        records = load_split(args.wider_root, "train")
        print(f"loaded {len(records)} train images", file=sys.stderr)
        yield from TrainPipeline(
            records, cfg, seed=args.seed, start_step=start,
            rank=mesh.rank if mesh else 0, num_ranks=mesh.size if mesh else 1,
        )



def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.synthetic and not args.wider_root:
        raise SystemExit("pass --synthetic or --wider_root")
    cfg = make_config(args)
    mesh = torchrun_mesh(cfg.mesh, args.device)
    # On a mesh every rank meets a barrier before the teardown, unless it
    # raised; train() has joined its data threads by then.
    with mesh if mesh is not None else contextlib.nullcontext():
        return train(args, cfg, mesh)


def train(args, cfg, mesh) -> int:
    """The step loop; returns the exit code.  Whether it returns or raises,
    the batch stream's thread (and a TrainPipeline's producers) have ended
    by then, so that none is left inside torch while the caller tears down
    the process group and the interpreter."""
    total_steps = args.steps or cfg.train.total_steps
    log_every = args.log_every or cfg.train.log_every
    device = mesh.device if mesh else resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0  # logs and writes
    say = (lambda msg: print(msg, file=sys.stderr)) if lead else (lambda msg: None)
    say(f"device: {device}" + (f", {mesh.size} ranks on {mesh.backend}" if mesh else ""))

    state = create_train_state(cfg, args.seed, device)
    if mesh is not None:
        place_replicated(state, mesh)
    if args.resume and ckpt.latest_step(args.model_dir) is not None:
        ckpt.restore(args.model_dir, state)
        say(f"resumed from step {state.step}")
    elif args.warm_start:
        state.model.load_state_dict(load_params(args.warm_start, cfg, verbose=lead))
        say(f"warm-started from {args.warm_start}")

    data = device_prefetch(batches(args, cfg, state.step, mesh), device)
    logger = MetricsLogger(args.model_dir) if lead else None
    meter = ThroughputMeter(cfg.train.batch_size, mesh.size if mesh else 1)
    try:
        with maybe_trace(args.trace_dir):
            while state.step < total_steps:
                metrics = train_step(state, next(data), mesh=mesh, debug_nans=args.debug_nans)
                meter.tick()
                step = state.step
                if step % log_every == 0:
                    rec = {k: float(v) for k, v in metrics.items()}  # waits for the device
                    if not math.isfinite(rec["loss"]):  # the same on every rank
                        if logger:
                            logger.log(step, rec)
                        say(
                            f"FATAL: non-finite loss at step {step}: training diverged. "
                            "From random init pass --warmup_steps 50 --grad_clip 10 "
                            "(or a lower --lr)."
                        )
                        return 6
                    rec["images_per_sec_per_chip"] = meter.images_per_sec_per_chip
                    if logger:
                        logger.log(step, rec)
                    meter.reset()
                if step % cfg.train.checkpoint_every == 0 or step == total_steps:
                    say(f"saving {ckpt.save(args.model_dir, step, state, mesh)}")
    finally:
        data.close()
        if logger:
            logger.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
