"""Train-step throughput (img/s a card), the train-side companion of
tools/bench.py (counterpart of scripts/bench_train.py).

    python -m dan_tpu_torch.tools.bench_train [--batch 8] [--iters 20] [--device cpu]
    torchrun --nproc_per_node N -m dan_tpu_torch.tools.bench_train [--batch 8]

Measures the whole train step (train/loop.py::train_step: the host batch to
the card, the train preprocess, the anchor matcher kernel, forward and
backward with the phase-pool and conv1_2' weight-grad kernels, the SGD
update) at the default config on synthetic_batch(cfg, batch x ranks,
seed=0), from the JAX package's PRNGKey(0) weights, as the reference does.
--batch is per card; under torchrun every rank takes its rows of the global
batch (parallel/mesh.py, NCCL, cuda:LOCAL_RANK) and the gradients are
summed over the ranks.  Timing: one first step, 3 warm-up, then --iters
steps on the host clock, each stage ended by a synchronise.  The last line
of stdout is the reference's:

    train batch=B/chip x N chip(s): X img/s/chip (Y ms/step)

Without a card it raises unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time
from typing import Dict, Mapping, Optional

from dan_tpu_torch.api import Detector
from dan_tpu_torch.config import DANConfig, default_config
from dan_tpu_torch.data.synthetic import synthetic_batch
from dan_tpu_torch.device import resolve_device
from dan_tpu_torch.parallel.mesh import place_replicated, shard_batch, torchrun_mesh
from dan_tpu_torch.tools.bench import reference_params, sync
from dan_tpu_torch.train.loop import create_train_state, train_step

WARMUP_STEPS = 3


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dan_tpu_torch.tools.bench_train")
    ap.add_argument("--batch", type=int, default=8, help="per-card batch")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None, help="torch device; default: the first CUDA card "
                    "(cuda:LOCAL_RANK under torchrun)")
    return ap.parse_args(argv)


def run(args, config: Optional[DANConfig] = None, params: Optional[Mapping] = None,
        mesh=None) -> Dict[str, float]:
    """The bench on this process's device (mesh.device on a mesh); returns
    img/s a card, ms a step, the first step's loss and the rank count.
    `params` (a reference-layout tree) replaces the PRNGKey(0) draw."""
    cfg = config or default_config()
    device = mesh.device if mesh is not None else resolve_device(args.device)
    n_chips = mesh.size if mesh is not None else 1
    model = Detector.from_jax_params(reference_params(cfg, params), cfg, device).model
    state = create_train_state(cfg, device=device, model=model)
    if mesh is not None:
        place_replicated(state, mesh)
    batch = synthetic_batch(cfg, args.batch * n_chips, seed=0)
    if mesh is not None:
        batch = shard_batch(batch, mesh)

    def step():
        return train_step(state, batch, mesh=mesh)

    t0 = time.perf_counter()
    loss = float(step()["loss"])
    print(f"compile+first: {time.perf_counter() - t0:.1f}s loss={loss:.3f}", file=sys.stderr)
    for _ in range(WARMUP_STEPS):
        step()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        step()
    sync(device)
    dt = time.perf_counter() - t0
    return {"img_s": args.iters * args.batch / dt, "ms_step": dt / args.iters * 1e3,
            "loss": loss, "n_chips": n_chips}


def main(argv=None, config: Optional[DANConfig] = None, params: Optional[Mapping] = None) -> int:
    args = parse_args(argv)
    cfg = config or default_config()
    mesh = torchrun_mesh(cfg.mesh, args.device)
    with mesh if mesh is not None else contextlib.nullcontext():
        res = run(args, cfg, params, mesh)
        if mesh is None or mesh.rank == 0:
            print(f"train batch={args.batch}/chip x {res['n_chips']} chip(s): "
                  f"{res['img_s']:.2f} img/s/chip ({res['ms_step']:.2f} ms/step)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
