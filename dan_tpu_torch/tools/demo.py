"""Single-image detection demo (counterpart of scripts/demo.py): load a
checkpoint, detect the faces of one image, print them and optionally draw
them, on the first CUDA card (or --device cpu).

    python -m dan_tpu_torch.tools.demo --image face.jpg [--ckpt PATH] [--out out.jpg]
        [--score_threshold 0.5] [--tta | --int8 [--calib_images a.jpg b.jpg ...]]
        [--device cpu]

--ckpt takes every format Detector.from_checkpoint loads (a TF1 prefix, a
JAX-layout .npz, a .pt or a train model_dir); without it the weights are
random (seed 0) and a warning says so.  --tta runs the full pyramid + flip
TTA (detect_tta); --int8 quantizes the detect path first, calibrated on
--calib_images or on the image itself, and is refused with --tta.  Prints
"<n> detections" and one line a box, as the reference does; `run(args)`
returns the detections and the Detector.
"""
from __future__ import annotations

import argparse
import sys

from dan_tpu_torch.api import Detector
from dan_tpu_torch.data.widerface import load_image_rgb


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dan_tpu_torch.tools.demo")
    ap.add_argument("--image", required=True)
    ap.add_argument("--ckpt", default=None,
                    help="TF1 checkpoint prefix, .npz, .pt or train model_dir")
    ap.add_argument("--out", default=None, help="write annotated image here")
    ap.add_argument("--score_threshold", type=float, default=0.5)
    ap.add_argument("--tta", action="store_true", help="full pyramid+flip TTA")
    ap.add_argument(
        "--int8",
        action="store_true",
        help="post-training-quantize the detect path to an int8 body "
        "(deployment mode); calibrates on --calib_images if given, else "
        "on the input image itself. Incompatible with --tta (bf16 policy)",
    )
    ap.add_argument("--calib_images", nargs="*", default=None,
                    help="with --int8: image paths to calibrate activation scales on")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the first CUDA card")
    args = ap.parse_args(argv)
    if args.int8 and args.tta:
        ap.error("--int8 requires the non-TTA path (TTA is bf16 accuracy mode)")
    return args


def run(args):
    """Detect, print and draw as main() does; returns (detections, Detector)."""
    if args.ckpt:
        det = Detector.from_checkpoint(args.ckpt, device=args.device)
    else:
        print("WARNING: no --ckpt, using random weights", file=sys.stderr)
        det = Detector.from_random(device=args.device)

    img = load_image_rgb(args.image)
    if args.int8:
        calib = [load_image_rgb(p) for p in args.calib_images] if args.calib_images else [img]
        det.quantize_int8(calib)
        print(f"[int8] quantized (calibrated on {len(calib)} images)", file=sys.stderr)
    if args.tta:
        out = det.detect_tta(img, score_threshold=args.score_threshold)
    else:
        out = det.detect(img, score_threshold=args.score_threshold)

    print(f"{len(out['scores'])} detections")
    for box, s in zip(out["bboxes"], out["scores"]):
        print(f"  [{box[0]:7.1f} {box[1]:7.1f} {box[2]:7.1f} {box[3]:7.1f}] {s:.3f}")

    if args.out:
        from dan_tpu_torch.utils.viz import draw_detections

        draw_detections(img, out["bboxes"], out["scores"], args.out)
        print(f"wrote {args.out}")
    return out, det


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
