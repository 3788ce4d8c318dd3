#!/usr/bin/env python
"""Compare the bf16 and int8 logits of two checkouts of this repository
on one CUDA card: a change that should keep every bit (a kernel that redoes
PyTorch's arithmetic) is held to the checkout before it bit for bit, one
that changes only the order of a sum to a relative L2 distance.

    python3 dan_tpu_torch/tools/ab_logits.py DIR_A DIR_B [--batch 16] [--max_rel_l2 0]

Each side is a fresh process started in its checkout (which builds that
checkout's kernels and imports its `dan_tpu_torch`).  It draws the default
config's detector from seed 0 (`Detector.from_random`), replaces every bias
with seeded normal values (the init's zeros would hide a wrong bias), and
runs `--batch` seeded 640x640 uint8 images through normalize -> forward in
bf16, then the int8 deployment (`quant.calibrate_act_scales` on the first 8
images, `quant.QuantizedDetector`) on the same images, all under
inference_mode.  The parent compares the four logit tensors and the
calibration scales as integers of their width.  The last line is one JSON
object: the card's name and power limit, each side's launches of the
bias + ReLU pass, of the one-pass L2Norm and of the LFPN's one-pass
upsample x lateral (ops/lfpn_fuse_cuda.py) where the checkout has them,
the number of differing elements of each tensor, each logit tensor's
relative L2 distance ||B - A|| / ||A||, and `same` (every bit); the exit
code is 0 only if the scales are the same bit for bit and every logit
tensor is within `--max_rel_l2` (0: bit for bit).
"""
import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile

SEED = 0
# The hand-written inference passes whose launches each side counts.
KERNELS = ("bias_act", "l2norm", "lfpn_fuse")


def child(out: str, batch: int) -> None:
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    from dan_tpu_torch import quant
    from dan_tpu_torch.api import Detector
    from dan_tpu_torch.config import default_config
    from dan_tpu_torch.models.detector import compute_dtype
    from dan_tpu_torch.ops.preprocess import normalize_image

    counters = {}
    for name in KERNELS:
        try:
            counters[name] = importlib.import_module(f"dan_tpu_torch.ops.{name}_cuda")
        except ImportError:
            pass
    dev = torch.device("cuda", 0)
    cfg = default_config()
    det = Detector.from_random(SEED, cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    with torch.no_grad():
        for name, p in det.model.named_parameters():
            if name.endswith(".bias"):
                p.copy_(torch.randn(p.shape, generator=gen, device=dev) * 0.1)
    size = cfg.model.image_size
    images = torch.randint(0, 255, (batch, size, size, 3), dtype=torch.uint8, device=dev,
                           generator=gen)
    got = {}
    launches = {}
    with torch.inference_mode():
        x = normalize_image(images.float(), cfg.preprocess).to(compute_dtype(cfg.model))
        for which in ("bf16", "int8"):
            if which == "int8":
                scales = quant.calibrate_act_scales(det.model, [x[:8]], cfg.model)
                got.update({f"scale_{k}": torch.from_numpy(v) for k, v in scales.items()})
                model = quant.QuantizedDetector(det.model, scales).to(dev).eval()
            else:
                model = det.model
            before = {name: mod.LAUNCHES for name, mod in counters.items()}
            cls, loc = model(x)
            torch.cuda.synchronize()
            launches[which] = {name: counters[name].LAUNCHES - before[name]
                               if name in counters else None for name in KERNELS}
            got[f"{which}_cls"], got[f"{which}_loc"] = cls, loc
    np.savez(out, **{k: v.float().cpu().numpy().view(np.uint32) for k, v in got.items()})
    print(json.dumps({"launches": launches}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--max_rel_l2", type=float, default=0.0,
                    help="the largest relative L2 distance a logit tensor may have (0: every bit)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.batch)
        return 0
    if len(args.dirs) != 2:
        ap.error("give two checkouts, DIR_A and DIR_B")
    import numpy as np

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sides = {}
    with tempfile.TemporaryDirectory() as d:
        for side, path in zip("AB", args.dirs):
            out = os.path.join(d, f"{side}.npz")
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--child", out,
                 "--batch", str(args.batch)],
                cwd=path, capture_output=True, text=True)
            if res.returncode:
                print(f"{side} {path} failed ({res.returncode}):\n{res.stderr}", file=sys.stderr)
                return 2
            reading = json.loads(res.stdout.strip().splitlines()[-1])
            print(side, path, json.dumps(reading), flush=True)
            with np.load(out) as f:
                sides[side] = (reading, {k: f[k] for k in f.files})
    a, b = sides["A"][1], sides["B"][1]
    differ = {k: (int((a[k] != b[k]).sum()) if k in a and k in b and a[k].shape == b[k].shape
                  else -1)
              for k in sorted(set(a) | set(b))}
    same = all(v == 0 for v in differ.values())
    rel_l2 = {}
    for k in sorted(set(a) & set(b)):
        if k.startswith("scale_") or a[k].shape != b[k].shape:
            continue
        fa, fb = (t.view(np.float32).astype(np.float64) for t in (a[k], b[k]))
        rel_l2[k] = float(np.linalg.norm(fb - fa) / np.linalg.norm(fa))
    ok = (all(v == 0 for k, v in differ.items() if k.startswith("scale_"))
          and len(rel_l2) == 4
          and all(differ[k] == 0 or rel_l2[k] <= args.max_rel_l2 for k in rel_l2))
    print(json.dumps({"card": smi, "batch": args.batch,
                      "launches": {s: sides[s][0]["launches"] for s in "AB"},
                      "differing": differ, "rel_l2": rel_l2, "same": same, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
