"""Cost the host input feed of training (counterpart of
scripts/profile_host_feed.py): the per-image host CPU time of each stage
of the port's TrainPipeline (file read, JPEG decode, canvas window +
metadata + crop sampling, canvas placement, collation), the feed rate one
core gives, how many cores the H100's train step needs, and whether the
multi-producer TrainPipeline scales past one producer.

Host work only: no card is touched.  Run it alone on an idle host (every
concurrent process is part of the measurement).

    python -m dan_tpu_torch.tools.profile_host_feed [--n 64] [--batch 16] [--steps 8]

The port's pipeline decodes with cv2 (the reference's C++ batch decoder,
dan_tpu/native/, is not ported yet), so its decode stage is the whole image,
not a crop window.  The target rate is the port's train step on one H100:
TRAIN_IMG_S at batch 32, 640x640, bf16 (chip_smoke.py phase 10, PERF.md
section 5; NVIDIA H100 80GB HBM3, 700.00 W), and four times it for a
host with four cards.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from dan_tpu_torch.config import default_config
from dan_tpu_torch.data.pipeline import TrainPipeline, _collate, _finish_sample, _window_params
from dan_tpu_torch.data.widerface import ImageRecord

# The port's train step on one card: 208.0 img/s at batch 32 (153.816 ms a
# step; NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 10).
TRAIN_IMG_S = 208.0
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def make_dataset(n, tmpdir, rng):
    """WIDER-like JPEGs: 1024 px wide, log-normal heights, a few faces."""
    import cv2

    records = []
    for i in range(n):
        h = int(np.clip(np.exp(rng.normal(6.5, 0.35)), 330, 1500))
        w = 1024
        img = rng.integers(0, 90, (h, w, 3), dtype=np.uint8)
        nb = int(rng.integers(1, 6))
        boxes = []
        for _ in range(nb):
            s = int(rng.integers(16, 140))
            x = int(rng.integers(0, w - s))
            y = int(rng.integers(0, h - s))
            img[y: y + s, x: x + s] = rng.integers(150, 255, 3, dtype=np.uint8)
            boxes.append([x, y, x + s, y + s])
        p = os.path.join(tmpdir, f"img{i}.jpg")
        cv2.imwrite(p, img[:, :, ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90])
        records.append(ImageRecord(path=p, rel_path=f"e/img{i}.jpg", event="e",
                                   boxes=np.asarray(boxes, np.float32),
                                   attrs=np.zeros((len(boxes), 6), np.float32)))
    return records


def timeit(fn, reps=3):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def run(args) -> dict:
    with tempfile.TemporaryDirectory(prefix="hostfeed_") as tmpdir:
        records = make_dataset(args.n, tmpdir, np.random.default_rng(0))
        return measure(records, args)


def measure(records, args) -> dict:
    """The stage table, the pipeline rates and the scaling statement."""
    import cv2

    cfg = default_config()
    c = cfg.preprocess.canvas_size
    n = len(records)
    print(f"dataset: {n} JPEGs, canvas {c}", file=sys.stderr)

    # stage 1: file read
    def read_all():
        for r in records:
            with open(r.path, "rb") as f:
                f.read()

    t_read = timeit(read_all) / n
    bufs = []
    for r in records:
        with open(r.path, "rb") as f:
            bufs.append(f.read())
    mb = sum(len(b) for b in bufs) / 1e6 / n

    # stage 2: decode of the whole image (cv2, BGR -> RGB), as load_image_rgb
    def decode_all():
        for b in bufs:
            cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR)[:, :, ::-1].copy()

    t_dec = timeit(decode_all, reps=2) / n
    images = [cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR)[:, :, ::-1].copy()
              for b in bufs]

    # stage 3: canvas window + box bookkeeping + crop sampling
    def meta_all():
        for i, (r, img) in enumerate(zip(records, images)):
            g = np.random.default_rng(1000 + i)
            h, w = img.shape[:2]
            off_x, off_y = _window_params(r, w, h, c, g)
            _finish_sample(r, cfg, g, off_x, off_y, min(c, w - off_x), min(c, h - off_y))

    t_meta = timeit(meta_all) / n

    # stage 4: placing the window into a zeroed canvas
    def place_all():
        for img in images:
            canvas = np.zeros((c, c, 3), np.uint8)
            win = img[:c, :c]
            canvas[:win.shape[0], :win.shape[1]] = win

    t_place = timeit(place_all) / n

    # stage 5: collation (stack B canvases + scalars)
    canvases = [np.zeros((c, c, 3), np.uint8) for _ in range(args.batch)]
    samples = [{"crop_x0": np.float32(0), "crop_y0": np.float32(0),
                "crop_size": np.float32(640),
                "boxes": np.zeros((cfg.match.max_gt, 4), np.float32),
                "mask": np.zeros((cfg.match.max_gt,), bool), "seed": np.uint32(1),
                "canvas": canvases[j]} for j in range(args.batch)]
    t_coll = timeit(lambda: _collate(samples), reps=5) / args.batch

    print("\nper-image host cost (ms, single-threaded, min of reps):")
    print(f"  file read           {t_read * 1e3:7.3f}   ({mb:.2f} MB/img)")
    print(f"  decode full image   {t_dec * 1e3:7.3f}")
    print(f"  window+meta+crop    {t_meta * 1e3:7.3f}")
    print(f"  canvas placement    {t_place * 1e3:7.3f}")
    print(f"  collation           {t_coll * 1e3:7.3f}")
    serial = t_read + t_meta + t_coll
    per_img = serial + t_dec + t_place
    print(f"  => serial (non-decode) {serial * 1e3:.3f} ms; total "
          f"{per_img * 1e3:.3f} ms/img = {1 / per_img:.0f} img/s/core")

    # pipeline level: one producer against several
    ips = {}
    for n_prod in (1, 2, 4):
        pipe = TrainPipeline(records, cfg, batch_size=args.batch, seed=0,
                             num_workers=max(1, os.cpu_count() or 1), num_producers=n_prod)
        it = iter(pipe)
        next(it)  # warm: thread start + first batch
        t0 = time.perf_counter()
        for _ in range(args.steps):
            next(it)
        dt = time.perf_counter() - t0
        it.close()
        pipe.stop()
        ips[n_prod] = args.steps * args.batch / dt
        print(f"pipeline num_producers={n_prod}: {ips[n_prod]:.1f} img/s "
              f"(batch {args.batch}, {os.cpu_count()} host cores)")

    # the scaling statement, for one card and for a host of four
    for cards in (1, 4):
        target = cards * TRAIN_IMG_S
        print(f"scaling: {1 / per_img:.0f} img/s/core => {cards} x H100 ({CARD}) training at "
              f"{TRAIN_IMG_S:.1f} img/s a card needs {target:.0f} img/s, ~{target * per_img:.1f} "
              f"cores of host decode+meta work; the serial non-decode share is "
              f"{serial / per_img:.0%}, so one producer caps at {1 / serial:.0f} img/s whatever "
              f"its decode threads; num_producers >= {int(np.ceil(target * serial))} removes "
              f"that ceiling")
    return {"ms": {"read": t_read * 1e3, "decode": t_dec * 1e3, "meta": t_meta * 1e3,
                   "place": t_place * 1e3, "collate": t_coll * 1e3},
            "per_img_ms": per_img * 1e3, "serial_ms": serial * 1e3, "pipeline_img_s": ips}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m dan_tpu_torch.tools.profile_host_feed")
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=8, help="pipeline-level steps to time per mode")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
