"""The int8 detect path's throughput beside the bf16 headline on one card
(counterpart of scripts/bench_int8.py).

    python -m dan_tpu_torch.tools.bench_int8 [--batch 128] [--iters 20] [--skip_bf16]
        [--device cpu]

First tools/bench.py's bf16 path (build_detect_fn + measure) on its images
and weights, unless --skip_bf16; then the activation scales from one
statistics forward over the first 8 of those images, normalized, in the
compute dtype (quant.calibrate_act_scales), the int8 body built from them
(quant.QuantizedDetector: 18 int8 convolutions, ops/conv_i8_cuda.py, and
one fused relu + quantize, ops/quantize_i8_cuda.py, a forward), and the
same bench path through it at the same batch.  The last line of stdout is
the reference's:

    bf16 X -> int8 Y img/s/chip (Z.ZZx)        (int8 Y img/s/chip with --skip_bf16)

Not the headline: tools/bench.py stays bf16.  Without a card it exits 5
unless --device is given.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Mapping, Optional

import torch

from dan_tpu_torch.api import Detector
from dan_tpu_torch.config import DANConfig, default_config
from dan_tpu_torch.models.detector import compute_dtype
from dan_tpu_torch.ops.preprocess import normalize_image
from dan_tpu_torch.quant import QuantizedDetector, calibrate_act_scales
from dan_tpu_torch.tools import bench

CALIB_IMAGES = 8


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dan_tpu_torch.tools.bench_int8")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--skip_bf16", action="store_true")
    ap.add_argument("--device", default=None, help="torch device; default: the first CUDA card")
    return ap.parse_args(argv)


def quantize(cfg: DANConfig, model, images):
    """(scales, int8 model): the activation scales of one statistics
    forward over the first CALIB_IMAGES of the uint8 bench `images`,
    normalized and in the compute dtype, and quant.QuantizedDetector built
    from them on the images' device."""
    with torch.inference_mode():
        x_cal = normalize_image(images[:CALIB_IMAGES].float(), cfg.preprocess)
        scales = calibrate_act_scales(model, [x_cal.to(compute_dtype(cfg.model))], cfg.model)
        return scales, QuantizedDetector(model, scales).to(images.device).eval()


def run(args, config: Optional[DANConfig] = None, params: Optional[Mapping] = None,
        device=None) -> Dict[str, Optional[float]]:
    """Both measurements on `device` -> {'bf16': img/s or None, 'int8':
    img/s}.  `params` (a reference-layout tree) replaces the PRNGKey(0)
    draw."""
    cfg = config or default_config()
    device = torch.device(device)
    t0 = time.monotonic()

    def stage(what):
        print(f"t+{time.monotonic() - t0:.0f}s {what}", file=sys.stderr)

    model = Detector.from_jax_params(bench.reference_params(cfg, params), cfg, device).model
    images = torch.from_numpy(bench.bench_images(cfg, args.batch)).to(device)
    detect = bench.build_detect_fn(cfg, device)
    ips_f = None
    if not args.skip_bf16:
        ips_f = bench.measure(detect, model, images, args.iters, args.batch)
        stage(f"bf16: {ips_f:.2f} img/s/chip")
    _, qmodel = quantize(cfg, model, images)
    stage("calibrated; quantized params on device")
    ips_q = bench.measure(detect, qmodel, images, args.iters, args.batch)
    stage(f"int8: {ips_q:.2f} img/s/chip")
    return {"bf16": ips_f, "int8": ips_q}


def main(argv=None, config: Optional[DANConfig] = None, params: Optional[Mapping] = None) -> int:
    args = parse_args(argv)
    if args.device is not None:
        device = torch.device(args.device)
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        print("no CUDA device — aborting (pass --device cpu to run on the CPU)", file=sys.stderr)
        return bench.NO_CARD_EXIT
    print(f"device: {device}", file=sys.stderr)
    res = run(args, config, params, device)
    if res["bf16"]:
        print(f"bf16 {res['bf16']:.2f} -> int8 {res['int8']:.2f} img/s/chip "
              f"({res['int8'] / res['bf16']:.2f}x)")
    else:
        print(f"int8 {res['int8']:.2f} img/s/chip")
    return 0


if __name__ == "__main__":
    sys.exit(main())
