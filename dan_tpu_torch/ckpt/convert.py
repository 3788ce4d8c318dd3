"""Convert a TF1 checkpoint into a port weights file (counterpart of
scripts/convert_ckpt.py), on the host, without TensorFlow:

    python -m dan_tpu_torch.ckpt.convert --tf_ckpt /path/model.ckpt-120000 \\
        --out /path/weights.pt [--strict]

The file holds {"model": state_dict}, the payload key of the train CLI's
step files, so Detector.from_checkpoint, the eval CLI's --ckpt and the
train CLI's --warm_start take it.  Without --strict, detector parameters
the checkpoint does not cover get the JAX package's PRNGKey(0) init (a warm
start from the VGG-16 classifier); with it, any such parameter or shape mismatch fails.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from dan_tpu_torch.ckpt.load import load_params
from dan_tpu_torch.config import default_config


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dan_tpu_torch.ckpt.convert")
    ap.add_argument("--tf_ckpt", required=True, help="TF1 checkpoint prefix")
    ap.add_argument("--out", required=True, help="the .pt file to write")
    ap.add_argument("--strict", action="store_true",
                    help="fail unless every detector parameter is placed with its shape")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    state = load_params(args.tf_ckpt, default_config(), strict=args.strict)
    d = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(d, exist_ok=True)
    torch.save({"model": state}, args.out)
    print(f"wrote {len(state)} tensors to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
