"""Convert WIDER FACE annotations + JPEGs into reference-format TFRecords
without TensorFlow (counterpart of scripts/convert_tfrecords.py; the port's
pipeline itself reads JPEGs directly).

    python -m dan_tpu_torch.tools.convert_tfrecords --wider_root /data/widerface \
        --split train --output_dir /data/tfrecords [--num_shards 16]
"""
from __future__ import annotations

import argparse
import sys

from dan_tpu_torch.data.tfrecords import convert_to_tfrecords
from dan_tpu_torch.data.widerface import load_split


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dan_tpu_torch.tools.convert_tfrecords")
    ap.add_argument("--wider_root", required=True)
    ap.add_argument("--split", default="train")
    ap.add_argument("--output_dir", required=True)
    ap.add_argument("--num_shards", type=int, default=16)
    args = ap.parse_args(argv)

    records = load_split(args.wider_root, args.split)
    print(f"converting {len(records)} images -> {args.num_shards} shards")
    paths = convert_to_tfrecords(records, args.output_dir, args.split, args.num_shards)
    print(f"wrote {len(paths)} shards under {args.output_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
