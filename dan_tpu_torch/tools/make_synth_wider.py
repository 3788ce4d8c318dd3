"""Materialize a synthetic WIDER-FACE-shaped dataset on disk (the port's
copy of scripts/make_synth_wider.py, the same seeded images and
annotation file): a full-val-scale eval soak needs ~3,226 val-like images,
and the real dataset is not in the repository.

Layout matches data/widerface.py's loader: WIDER_val/images/<event>/*.jpg
plus wider_face_split/wider_face_val_bbx_gt.txt.  Image geometry follows
the real val set's shape: 1024 px wide, log-normal heights (330-1500,
including the <=410 rows that plan a 2.0x TTA pass), 1-8 bright-square
'faces' of 12-180 px.

    python -m dan_tpu_torch.tools.make_synth_wider --out /tmp/synth_wider --n 3226
    python -m dan_tpu_torch.eval --wider_root /tmp/synth_wider --score_only ...
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    import cv2

    ap = argparse.ArgumentParser(prog="python -m dan_tpu_torch.tools.make_synth_wider")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=3226)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--events", type=int, default=10)
    args = ap.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    split_dir = os.path.join(args.out, "wider_face_split")
    os.makedirs(split_dir, exist_ok=True)
    lines = []
    for i in range(args.n):
        event = f"{i % args.events}--Synth"
        img_dir = os.path.join(args.out, "WIDER_val", "images", event)
        os.makedirs(img_dir, exist_ok=True)
        rel = f"{event}/img_{i:05d}.jpg"
        h = int(np.clip(np.exp(rng.normal(6.6, 0.35)), 330, 1500))
        w = 1024
        img = rng.integers(0, 80, (h, w, 3), dtype=np.uint8)
        nb = int(rng.integers(1, 9))
        boxes = []
        for _ in range(nb):
            s = int(np.clip(np.exp(rng.normal(3.6, 0.8)), 12, 180))
            x = int(rng.integers(0, max(1, w - s)))
            y = int(rng.integers(0, max(1, h - s)))
            img[y: y + s, x: x + s] = rng.integers(150, 255, 3, dtype=np.uint8)
            boxes.append([x, y, s, s])
        cv2.imwrite(
            os.path.join(args.out, "WIDER_val", "images", rel),
            img[:, :, ::-1],
            [cv2.IMWRITE_JPEG_QUALITY, 85],
        )
        lines.append(rel)
        lines.append(str(len(boxes)))
        for x, y, bw, bh in boxes:
            lines.append(f"{x} {y} {bw} {bh} 0 0 0 0 0 0")
        if (i + 1) % 500 == 0:
            print(f"{i + 1}/{args.n}", file=sys.stderr)
    with open(os.path.join(split_dir, "wider_face_val_bbx_gt.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.n} images under {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
