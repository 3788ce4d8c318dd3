"""WIDER FACE evaluation with the PyTorch port (counterpart of
scripts/eval.py; BASELINE.json config 4): full-val TTA inference, detection
txt writing and easy/medium/hard AP, on one device: the first CUDA card, or
the CPU with --device cpu.

    python -m dan_tpu_torch.eval --wider_root /data/widerface --ckpt /path/run \\
        --output_dir /tmp/preds [--gt_mats /data/eval_tools/ground_truth]
    python -m dan_tpu_torch.eval --score_only --pred_dir /tmp/preds ...
    python -m dan_tpu_torch.eval --wider_root ... --no_tta --int8 --calib 16
    torchrun --nproc_per_node 4 -m dan_tpu_torch.eval --wider_root ... --output_dir ...

Under torchrun every rank (cuda:LOCAL_RANK on NCCL, or the CPU on gloo with
--device cpu) runs its share of the dataset (TTARunner.run_dataset over the
mesh; with --no_tta every N-th image), and rank 0 writes the txt files and
scores AP.

--ckpt is any checkpoint that Detector.from_checkpoint reads: a TF1
prefix, a JAX-layout .npz (scripts/export_params_npz.py makes one from an
orbax checkpoint), a .pt of the train or convert CLI, or a train model_dir
(its newest step); without it the weights are random and a warning says so.
--int8 (with --no_tta) quantizes the detect path first
(Detector.quantize_int8), calibrated on the first --calib images; under
torchrun every rank calibrates on the same images, so the ranks stay
replicas.
Progress and statistics go to stderr; the last line of stdout is

    WIDER FACE <split> AP  easy=...  medium=...  hard=...
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

from dan_tpu_torch.config import default_config
from dan_tpu_torch.eval.tta import TTARunner
from dan_tpu_torch.eval.widerface_ap import evaluate_widerface, load_official_gt
from dan_tpu_torch.eval.writer import load_detection_dir, write_wider_detections
from dan_tpu_torch.parallel.mesh import gather_objects, torchrun_mesh


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dan_tpu_torch.eval")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the first CUDA card")
    ap.add_argument("--wider_root", required=False)
    ap.add_argument("--ckpt", default=None,
                    help="weights: a TF1 checkpoint prefix, a JAX-layout .npz, a .pt of "
                    "the train or convert CLI, or a train model_dir")
    ap.add_argument("--output_dir", default=None)
    ap.add_argument("--split", default="val")
    ap.add_argument("--gt_mats", default=None, help="official eval_tools/ground_truth dir")
    ap.add_argument("--no_tta", action="store_true", help="single-scale forward only")
    ap.add_argument("--tta_batch", type=int, default=TTARunner.DEFAULT_TTA_BATCH,
                    help="TTA (image, variant) units per bucket launch; large buckets "
                    "are capped by the pixel budget regardless (TTARunner.bucket_chunk)")
    ap.add_argument("--vote_batch", type=int, default=TTARunner.DEFAULT_VOTE_BATCH,
                    help="images per batched bbox-vote launch")
    ap.add_argument("--max_pending", type=int, default=TTARunner.DEFAULT_MAX_PENDING,
                    help="launches kept un-fetched before the oldest is drained "
                    "(TTARunner.run_dataset max_pending)")
    ap.add_argument("--int8", action="store_true",
                    help="post-training-quantize the detect path to an int8 body "
                    "(Detector.quantize_int8) before evaluating; requires --no_tta "
                    "(the TTA path runs in the compute dtype)")
    ap.add_argument("--calib", type=int, default=8,
                    help="with --int8: calibrate the activation scales on the first N images")
    ap.add_argument("--limit", type=int, default=None, help="eval first N images")
    ap.add_argument("--score_only", action="store_true",
                    help="skip inference, read --pred_dir")
    ap.add_argument("--pred_dir", default=None)
    return ap, ap.parse_args(argv)


def _stem(record) -> str:
    return os.path.splitext(record.rel_path)[0]


def _with_scores(out) -> np.ndarray:
    return np.concatenate([out["bboxes"], out["scores"][:, None]], axis=-1)


def _image_size(path: str):
    """(h, w) from the image header, without decoding pixels."""
    from PIL import Image

    with Image.open(path) as im:
        w, h = im.size
    return h, w


def run_single_scale(det, records, t0):
    """One detect() per image, decoding the next images on a background
    thread meanwhile.  Returns (predictions, the clock restarted after the
    first image, which pays the kernel build)."""
    from dan_tpu_torch.data.pipeline import iter_prefetch
    from dan_tpu_torch.data.widerface import load_image_rgb

    predictions = {}
    decoded = iter_prefetch(records, depth=4, transform=lambda r: (r, load_image_rgb(r.path)))
    with contextlib.closing(decoded):
        for i, (rec, img) in enumerate(decoded):
            out = det.detect(img)
            if i == 0:
                print(f"first detect (incl. kernel build): {time.time() - t0:.1f}s",
                      file=sys.stderr)
                t0 = time.time()
            predictions[_stem(rec)] = _with_scores(out)
            if (i + 1) % 50 == 0:
                ips = i / max(time.time() - t0, 1e-9)
                print(f"{i + 1}/{len(records)} images ({ips:.2f} img/s)", file=sys.stderr)
    return predictions, t0


def run_tta(det, records, args, mesh=None):
    """Warm every launch shape from the image headers, then run_dataset with
    the JPEG decode on a background thread (every rank reads every image:
    each plans the whole dataset)."""
    import resource

    import torch

    from dan_tpu_torch.data.pipeline import iter_prefetch
    from dan_tpu_torch.data.widerface import load_image_rgb

    runner = det._get_tta_runner()
    t_w = time.time()
    n_warm = runner.warmup(
        (_image_size(r.path) for r in records),
        batch_per_device=args.tta_batch,
        vote_batch=args.vote_batch,
        mesh=mesh,
    )
    print(f"[tta] warmed {n_warm} launch shapes in {time.time() - t_w:.0f}s", file=sys.stderr)
    items = iter_prefetch(
        records, depth=4, transform=lambda r: (_stem(r), load_image_rgb(r.path))
    )
    t_run = time.time()
    with contextlib.closing(items):
        results = runner.run_dataset(
            items,
            batch_per_device=args.tta_batch,
            progress_every=50,
            vote_batch=args.vote_batch,
            max_pending=args.max_pending,
            mesh=mesh,
        )
    dt = time.time() - t_run
    print(
        f"[tta] {len(results)} images in {dt:.1f}s "
        f"({len(results) / max(dt, 1e-9):.2f} img/s, "
        f"tta_batch={args.tta_batch}, vote_batch={args.vote_batch})",
        file=sys.stderr,
    )
    stats = dict(runner.last_run_stats)
    stats["peak_host_rss_mb"] = round(
        resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    )
    if det.device.type == "cuda":
        stats["peak_device_mb"] = round(torch.cuda.max_memory_allocated(det.device) / 1e6)
    print(f"[tta] stats: {stats}", file=sys.stderr)
    return {k: _with_scores(v) for k, v in results.items()}


def infer(args, records, mesh=None):
    """Detections of every record, {stem: (N, 5) boxes + scores}, written to
    --output_dir.  On a mesh each rank runs its share; rank 0 gets them all
    and writes, the other ranks return {}."""
    from dan_tpu_torch.api import Detector

    device = mesh.device if mesh else args.device
    if args.ckpt:
        det = Detector.from_checkpoint(args.ckpt, device=device)
    else:
        print("WARNING: random weights", file=sys.stderr)
        det = Detector.from_random(device=device)
    print(f"device: {det.device}" + (f", rank {mesh.rank} of {mesh.size} on {mesh.backend}"
                                     if mesh else ""), file=sys.stderr)
    if args.int8:
        from dan_tpu_torch.data.widerface import load_image_rgb

        n_cal = max(1, min(args.calib, len(records)))
        t_q = time.time()
        det.quantize_int8([load_image_rgb(r.path) for r in records[:n_cal]],
                          batch_size=min(n_cal, 8))
        print(f"[int8] calibrated on {n_cal} images + quantized in {time.time() - t_q:.1f}s",
              file=sys.stderr)
    t0 = time.time()
    if args.no_tta:
        share = records if mesh is None else records[mesh.rank::mesh.size]
        predictions, t0 = run_single_scale(det, share, t0)
        if mesh is not None:
            for theirs in gather_objects(predictions, mesh):
                predictions.update(theirs)
    else:
        predictions = run_tta(det, records, args, mesh)
    if mesh is not None and mesh.rank != 0:
        return {}
    if args.output_dir:
        stem_to_rel = {_stem(r): r.rel_path for r in records}
        for stem, p in predictions.items():
            write_wider_detections(args.output_dir, stem_to_rel[stem], p[:, :4], p[:, 4])
    # With --no_tta the clock restarts after the first detect, so that
    # image is not in the numerator either.
    n_timed = max(len(records) - (1 if args.no_tta else 0), 1)
    ips = n_timed / max(time.time() - t0, 1e-9)
    print(f"inference: {ips:.2f} img/s over {len(records)}", file=sys.stderr)
    return predictions


def main(argv=None) -> int:
    ap, args = parse_args(argv)
    predictions = {}
    records = []
    if args.wider_root:
        from dan_tpu_torch.data.widerface import load_split

        records = load_split(args.wider_root, args.split, keep_invalid=True)
        if args.limit:
            records = records[: args.limit]

    if args.score_only:
        predictions = load_detection_dir(args.pred_dir)
    else:
        if not records:
            ap.error("--wider_root is required unless --score_only")
        if args.int8 and not args.no_tta:
            ap.error("--int8 requires --no_tta (the TTA path runs in the compute dtype)")
        mesh = torchrun_mesh(default_config().mesh, args.device)
        with mesh if mesh is not None else contextlib.nullcontext():
            predictions = infer(args, records, mesh)
        if mesh is not None and mesh.rank != 0:
            return 0

    # --- AP ---
    if args.gt_mats:
        gt_boxes, keep_lists, _ = load_official_gt(args.gt_mats)
    else:
        if not records:
            ap.error("need --gt_mats or --wider_root for ground truth")
        print("NOTE: no --gt_mats; using height-based difficulty approximation",
              file=sys.stderr)
        gt_boxes = {_stem(r): r.boxes.astype(np.float64) for r in records}
        keep_lists = None
    if args.limit:
        if not records:
            # --score_only --gt_mats --limit without --wider_root: an empty
            # record set would intersect gt down to nothing and print AP 0.0.
            ap.error("--limit needs --wider_root to know which images it keeps")
        kept = {_stem(r) for r in records}
        gt_boxes = {k: v for k, v in gt_boxes.items() if k in kept}
    aps = evaluate_widerface(predictions, gt_boxes, keep_lists)
    print(
        f"WIDER FACE {args.split} AP  easy={aps['easy']:.4f}  "
        f"medium={aps['medium']:.4f}  hard={aps['hard']:.4f}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
