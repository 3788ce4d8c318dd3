"""Driver of RetinaFace's batch-detect mixes: offline batch face detection
through the port's one bench path, `dan_tpu_torch.tools.bench.build_detect_fn`
(normalize -> the RetinaFace-R50 forward -> decode -> top-k -> NMS, with
each kept box's landmarks), at the configuration's precision.

The traffic, the window and the faults are the `detect` driver's
(drivers/detect.py: its parameters, `_pool`, `_calls`, `window`,
`_faults`); what differs is the model and its check.

Set-up draws the weights from the seed (reference/retinaface.py: He-normal
conv kernels, BN scale and shift near 1 and 0, the scale of each
bottleneck's last BN near 0.2) and sets every BN's running
statistics by one float32 pass of the reference over the configuration's
`calibration_images` (the first images of the first pool batch), so each
BN folds a non-trivial affine map and activations stay of order 1 through
the body.

The check: the program's (cls, loc, landm) logits of the sampled calls
against the reference's forward on the same images and weights
(`logit_rel_l2`, the worst image, over the three concatenated), and the
program's detections against the reference tail run on the program's own
logits (`det_mismatch`: slots whose valid flag, score, box or any landmark
coordinate differs).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.drivers.detect import FAULTS, _calls, _faults, _pool, window  # noqa: F401
from benchmark.harness import Run, log
from benchmark.reference import retinaface as ref
from benchmark.reference.lowp import rounding
from benchmark.reference.model import float32_exact, normalize
from benchmark.weights import make_weights
from dan_tpu_torch import config as pc
from dan_tpu_torch.models.factory import build_model

SECTIONS = {"model": pc.RetinaFaceModelConfig, "anchors": pc.RetinaFaceAnchorConfig,
            "preprocess": pc.PreprocessConfig, "postprocess": pc.PostprocessConfig}


def _tup(v):
    return tuple(_tup(x) for x in v) if isinstance(v, (list, tuple)) else v


def program_config(dan: Dict) -> pc.RetinaFaceConfig:
    """The program's RetinaFaceConfig holding exactly the file's settings."""
    return pc.RetinaFaceConfig(**{name: cls(**{k: _tup(v) for k, v in dan[name].items()})
                                  for name, cls in SECTIONS.items()})


class Control(torch.nn.Module):
    """The reference forward in the precision below `precision`, in the
    program's place: normalized (B, H, W, 3) -> (cls, loc, landm), a block
    of images at a time."""

    def __init__(self, weights, dan, precision: str, block: int):
        super().__init__()
        self.weights, self.dan, self.block = weights, dan, block
        self.quant = rounding(precision)

    @torch.no_grad()
    def forward(self, x):
        outs = []
        with float32_exact():
            for i in range(0, x.shape[0], self.block):
                outs.append(ref.forward(self.weights, self.dan, x[i:i + self.block].float(),
                                        quant=self.quant))
        return tuple(torch.cat(parts) for parts in zip(*outs))


def setup(run: Run) -> Dict:
    from dan_tpu_torch.tools import bench

    p, dan = run.params, run.dan
    cfg = program_config(dan)
    size = cfg.model.image_size
    weights = make_weights(ref.param_spec(dan), run.seed, run.device)
    weights.update(ref.bn_params(dan, run.seed, run.device))
    pool = _pool(run, size)
    n_cal = run.cell.config["calibration_images"]
    with torch.no_grad(), float32_exact():
        ref.calibrate(weights, dan, normalize(pool[0][:n_cal].to(run.device), dan))
    if run.control:
        model = Control(weights, dan, run.cell.config["precision"], p["check_block"])
    else:
        with torch.device(run.device):
            model = build_model(cfg, torch.Generator(device=run.device).manual_seed(0))
        model.load_state_dict(weights, strict=True)
        model.eval()
    detect = bench.build_detect_fn(cfg, run.device)
    st = {"cfg": cfg, "weights": weights, "pool": pool, "model": model, "detect": detect,
          "bench": bench, "size": size}
    _faults(run, st)
    st["bufs"] = [torch.empty_like(pool[0], device=run.device) for _ in range(2)]
    rng = np.random.default_rng([run.seed, 3])
    st["sample"] = sorted(rng.choice(p["sample_within"], p["sample_calls"], replace=False).tolist())
    st["sample_images"] = torch.from_numpy(np.sort(rng.choice(
        p["batch"], p["check_images"], replace=False)))
    st["captured"], st["dets"], st["calls"] = {}, {}, 0
    _calls(run, st, n=p["warmup_calls"])
    st["dets"], st["calls"] = {}, 0

    def capture(mod, args, out):
        if st["calls"] in st["sample"]:
            st["captured"][st["calls"]] = tuple(out)

    model.register_forward_hook(capture)
    return st


def check(run: Run, st: Dict) -> Dict[str, float]:
    """logit_rel_l2: the worst sampled image's ||program - reference|| /
    ||reference|| over its concatenated (cls, loc, landm) logits;
    det_mismatch: detection slots of the sampled calls that differ from the
    reference tail's on the program's logits."""
    dan, block = run.dan, run.params["check_block"]
    captured, dets = st.pop("captured"), st.pop("dets")
    weights, pool = st["weights"], st["pool"]
    for k in ("model", "detect", "bufs"):
        st.pop(k)
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    pick = st["sample_images"]
    worst, mismatch = 0.0, 0
    for i in st["sample"]:
        if i not in captured or i not in dets:
            log(f"check: call {i} of the sample was not made")
            return {"logit_rel_l2": float("inf"), "det_mismatch": float("inf")}
        images = pool[i % len(pool)]
        if len(captured[i][0]) != len(images):
            log(f"check: call {i} returned logits of {len(captured[i][0])} images for {len(images)}")
            return {"logit_rel_l2": float("inf"), "det_mismatch": float("inf")}
        images = images[pick].to(run.device)
        outs = [o[pick.to(o.device)].float() for o in captured[i]]
        with torch.no_grad(), float32_exact():
            for j in range(0, len(images), block):
                want = torch.cat(ref.forward(weights, dan, normalize(images[j:j + block], dan)),
                                 -1)
                got = torch.cat([o[j:j + block] for o in outs], -1)
                num = (got - want).double().flatten(1).norm(dim=1)
                rel = num / want.double().flatten(1).norm(dim=1)
                worst = max(worst, float(rel.max()))
            size = st["size"]
            det_r = ref.postprocess(*outs, dan, size, size)
        got = {k: v[pick].to(run.device) for k, v in dets[i].items()}
        mismatch += ref.mismatched_rows(got, det_r)
    log(f"check: sampled calls {st['sample']}, images {pick.tolist()}")
    return {"logit_rel_l2": worst, "det_mismatch": float(mismatch)}
