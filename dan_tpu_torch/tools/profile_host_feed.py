"""Cost the host input feed of training (counterpart of
scripts/profile_host_feed.py): the per-image host CPU time of each stage
of the port's TrainPipeline on its two decode paths, the feed rate one core
gives, how many cores the H100's train step needs, and whether the
multi-producer TrainPipeline scales past one producer.

The native path (the default): file read, JPEG header + metadata + crop
sampling, the C++ window decode (native/loader.cc, one thread) of the crop
window + 2 px and, for comparison, of the whole placed image, and
collation.  The cv2 path (the fallback): file read, cv2's decode of the
whole image, canvas window + metadata + crop sampling, canvas placement and
collation.  The pipeline's rate is measured on both paths at 1, 2 and 4
producers.

Host work only: no card is touched.  Run it alone on an idle host (every
concurrent process is part of the measurement).

    python -m dan_tpu_torch.tools.profile_host_feed [--n 64] [--batch 16] [--steps 8]

The target rate is the port's train step on one H100: TRAIN_IMG_S at batch
32, 640x640, bf16 (chip_smoke.py phase 10, PERF.md section 5; NVIDIA H100
80GB HBM3, 700.00 W), and four times it for a host with four cards.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from dan_tpu_torch import native
from dan_tpu_torch.config import default_config
from dan_tpu_torch.data.pipeline import (
    TrainPipeline,
    _collate,
    _finish_sample,
    _native_plan,
    _window_params,
)
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
    # the native batch stacks the scalars only: its canvases are decoded in place
    for sm in samples:
        del sm["canvas"]
    t_coll_native = timeit(lambda: _collate(samples), reps=5) / args.batch

    print("\nper-image host cost (ms, single-threaded, min of reps):")
    print(f"  file read           {t_read * 1e3:7.3f}   ({mb:.2f} MB/img)")
    print("cv2 path:")
    print(f"  decode full image   {t_dec * 1e3:7.3f}")
    print(f"  window+meta+crop    {t_meta * 1e3:7.3f}")
    print(f"  canvas placement    {t_place * 1e3:7.3f}")
    print(f"  collation           {t_coll * 1e3:7.3f}")
    serial = t_read + t_meta + t_coll
    per_img = serial + t_dec + t_place
    print(f"  => serial (non-decode) {serial * 1e3:.3f} ms; total "
          f"{per_img * 1e3:.3f} ms/img = {1 / per_img:.0f} img/s/core")
    nat = native_stages(records, bufs, cfg, args) if native.load_loader() is not None else None
    if nat is None:
        print(f"native path: not run ({native.loader_unavailable_reason()})")
    else:
        print("native path:")
        print(f"  header+meta+crop    {nat['meta'] * 1e3:7.3f}")
        print(f"  decode crop-window  {nat['decode_crop'] * 1e3:7.3f}   (1 thread)")
        print(f"  decode full-image   {nat['decode_full'] * 1e3:7.3f}   (1 thread)")
        print(f"  collation           {t_coll_native * 1e3:7.3f}")
        nat["serial"] = t_read + nat["meta"] + t_coll_native
        nat["per_img"] = nat["serial"] + nat["decode_crop"]
        print(f"  => serial (non-decode) {nat['serial'] * 1e3:.3f} ms; total "
              f"{nat['per_img'] * 1e3:.3f} ms/img = {1 / nat['per_img']:.0f} img/s/core")

    # pipeline level: one producer against several, on each decode path
    ips = {"native": {}, "cv2": {}}
    for use_native in ([True] if nat is not None else []) + [False]:
        path = "native" if use_native else "cv2"
        for n_prod in (1, 2, 4):
            pipe = TrainPipeline(records, cfg, batch_size=args.batch, seed=0,
                                 num_workers=max(1, os.cpu_count() or 1),
                                 num_producers=n_prod, use_native=use_native)
            it = iter(pipe)
            next(it)  # warm: thread start + first batch
            t0 = time.perf_counter()
            for _ in range(args.steps):
                next(it)
            dt = time.perf_counter() - t0
            it.close()  # joins the producers
            ips[path][n_prod] = args.steps * args.batch / dt
            print(f"pipeline {path} num_producers={n_prod}: {ips[path][n_prod]:.1f} img/s "
                  f"(batch {args.batch}, {os.cpu_count()} host cores; images by path "
                  f"{dict(pipe.decoded)})")

    # the scaling statement, for one card and for a host of four, each path
    paths = [("cv2", per_img, serial)]
    if nat is not None:
        paths.insert(0, ("native", nat["per_img"], nat["serial"]))
    for path, per, ser in paths:
        for cards in (1, 4):
            target = cards * TRAIN_IMG_S
            print(f"scaling ({path}): {1 / per:.0f} img/s/core => {cards} x H100 ({CARD}) "
                  f"training at {TRAIN_IMG_S:.1f} img/s a card needs {target:.0f} img/s, "
                  f"~{target * per:.1f} cores of host decode+meta work; the serial non-decode "
                  f"share is {ser / per:.0%}, so one producer caps at {1 / ser:.0f} img/s "
                  f"whatever its decode threads; num_producers >= {int(np.ceil(target * ser))} "
                  f"removes that ceiling")
    ms = {"read": t_read * 1e3, "decode": t_dec * 1e3, "meta": t_meta * 1e3,
          "place": t_place * 1e3, "collate": t_coll * 1e3}
    out = {"ms": ms, "per_img_ms": per_img * 1e3, "serial_ms": serial * 1e3,
           "pipeline_img_s": ips, "native": None}
    if nat is not None:
        out["native"] = {"ms": {"read": t_read * 1e3, "meta": nat["meta"] * 1e3,
                                "decode_crop": nat["decode_crop"] * 1e3,
                                "decode_full": nat["decode_full"] * 1e3,
                                "collate": t_coll_native * 1e3},
                         "per_img_ms": nat["per_img"] * 1e3, "serial_ms": nat["serial"] * 1e3,
                         "fallback": nat["fallback"]}
    return out


def native_stages(records, bufs, cfg, args) -> dict:
    """Seconds an image of the native path's metadata pass and of its C++
    decode on one thread, at window 'crop' and 'full', batch by batch;
    "fallback": the images the decoder refused (0 on these JPEGs)."""
    n = len(records)
    seeds = list(range(1000, 1000 + n))
    out = {"meta": timeit(lambda: _native_plan(records, bufs, cfg, seeds, "crop")) / n,
           "fallback": 0}
    c = cfg.preprocess.canvas_size
    for window in ("crop", "full"):
        samples, windows = _native_plan(records, bufs, cfg, seeds, window)
        out["fallback"] += sum(s is None for s in samples)
        chunks = [(bufs[i:i + args.batch], [w[i:i + args.batch] for w in windows])
                  for i in range(0, n, args.batch)]
        canvases = np.empty((args.batch, c, c, 3), np.uint8)
        status = []

        def decode():
            for b, w in chunks:
                status.append(native.decode_batch_into(b, *w, canvases[:len(b)], nthreads=1))

        out[f"decode_{window}"] = timeit(decode, reps=2) / n
        out["fallback"] += int(sum((s != 0).sum() for s in status))
    return out


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
