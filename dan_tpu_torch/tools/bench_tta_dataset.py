"""Dataset-scale TTA throughput sweep over (tta_batch, vote_batch) pairs
(counterpart of scripts/bench_tta_dataset.py).

    python -m dan_tpu_torch.tools.bench_tta_dataset [--images 300] \
        [--tta_batches 4,16,32] [--vote_batches 32,128] [--seed 0] [--device cpu]

The images have WIDER FACE val's shape: 1024 wide, heights from a
log-normal centred near 730 px truncated to [330, 1500] (`synth_sizes`),
which spreads the run over the same (scale bucket, canvas) groups as the
real set, the 2.0 pass of small images included.  Their pixels are
default_rng(seed + 1) uint8 noise, made before any timing.  The detector has
the JAX package's PRNGKey(0) weights, as the reference's.

Every pair's launch shapes are warmed (TTARunner.warmup) before the first
timed run, so each row is a warm TTARunner.run_dataset on the host clock
(it returns the fetched detections: the device is done).  Each row prints
as one JSON line on stdout with the reference's keys; the launch counts
come from the planners' arithmetic (`launch_counts`, the rule run_dataset
follows), exact, not estimated.  Last, {"rows": [...]} on stderr.  The run
launches the NMS kernel (K1) once a bucket launch and the vote kernel (K7)
once a vote launch.  Without a card it raises unless --device cpu is given.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np

from dan_tpu_torch.api import Detector
from dan_tpu_torch.config import DANConfig, default_config
from dan_tpu_torch.device import resolve_device
from dan_tpu_torch.eval.tta import TTARunner, plan_variant_buckets
from dan_tpu_torch.tools.bench import reference_params


def synth_sizes(n, seed=0):
    """(h, w) sizes with a WIDER-val-like distribution: w = 1024, h from a
    log-normal centered near 730 px, truncated to [330, 1500]."""
    rng = np.random.default_rng(seed)
    hs = np.exp(rng.normal(np.log(730.0), 0.35, size=n))
    hs = np.clip(hs, 330, 1500).astype(int)
    return [(int(h), 1024) for h in hs]


def launch_counts(sizes, runner, tta_batch, vote_chunk):
    """Exact launch counts for run_dataset over these sizes on one device:
    (bucket launches (the units grouped by (scale bucket, canvas), chunked
    by runner.bucket_chunk), vote launches, units, groups)."""
    groups = {}
    for h, w in sizes:
        for v, bucket, canvas in plan_variant_buckets(h, w, runner.config):
            groups.setdefault((bucket, canvas), []).append(v)
    bucket_launches = sum(
        -(-len(us) // runner.bucket_chunk(b, 1, tta_batch))
        for (b, _), us in groups.items()
    )
    n_units = sum(len(us) for us in groups.values())
    vote_launches = -(-len(sizes) // vote_chunk)
    return bucket_launches, vote_launches, n_units, len(groups)


def measure_pair(runner: TTARunner, sizes, images, tta_batch: int, vote_batch: int) -> Dict:
    """One timed run_dataset over the images at one pair -> its row."""
    vchunk = runner._vote_chunk(1, vote_batch)
    bl, vl, n_units, n_groups = launch_counts(sizes, runner, tta_batch, vchunk)
    t0 = time.time()
    results = runner.run_dataset(iter(images), batch_per_device=tta_batch, vote_batch=vote_batch)
    dt = time.time() - t0
    return {
        "tta_batch": tta_batch,
        "vote_batch": vote_batch,
        "images": len(results),
        "seconds": round(dt, 1),
        "img_per_s": round(len(results) / dt, 3),
        "bucket_launches": bl,
        "vote_launches": vl,
        "units": n_units,
        "groups": n_groups,
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dan_tpu_torch.tools.bench_tta_dataset")
    ap.add_argument("--images", type=int, default=300)
    ap.add_argument("--tta_batches", default="4,16,32")
    ap.add_argument("--vote_batches", default="32,128")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device; default: the first CUDA card")
    return ap.parse_args(argv)


def run(args, config: Optional[DANConfig] = None, params: Optional[Mapping] = None,
        measure: Callable = measure_pair) -> List[Dict]:
    """The sweep; prints each row and returns the rows.  `params` (a
    reference-layout tree) replaces the PRNGKey(0) draw; `measure` takes
    measure_pair's place (a caller that counts each run's launches wraps
    it)."""
    cfg = config or default_config()
    device = resolve_device(args.device)
    model = Detector.from_jax_params(reference_params(cfg, params), cfg, device).model
    runner = TTARunner(model, cfg, device=device)
    sizes = synth_sizes(args.images, args.seed)
    tta_batches = [int(x) for x in args.tta_batches.split(",")]
    vote_batches = [int(x) for x in args.vote_batches.split(",")]
    # Warm every pair's launch shapes before any timing.
    for tb in tta_batches:
        for vb in vote_batches:
            t0 = time.time()
            n = runner.warmup(sizes, batch_per_device=tb, vote_batch=vb)
            print(f"[warm] tta_batch={tb} vote_batch={vb}: {n} launch shapes "
                  f"in {time.time() - t0:.0f}s", file=sys.stderr)
    # The images are made outside the timed windows; every pair runs them.
    rng = np.random.default_rng(args.seed + 1)
    images = [(f"im{i:04d}", rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
              for i, (h, w) in enumerate(sizes)]
    rows = []
    for tb in tta_batches:
        for vb in vote_batches:
            row = measure(runner, sizes, images, tb, vb)
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps({"rows": rows}), file=sys.stderr)
    return rows


def main(argv=None, config: Optional[DANConfig] = None, params: Optional[Mapping] = None) -> int:
    run(parse_args(argv), config, params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
