"""Tiny versions of the benchmark's cells for CPU tests: the cell's own
files, with the configuration cut to 64x64 images and the mix to a few
images, so that every path of a run fits in seconds."""
from __future__ import annotations

import copy
import dataclasses

from benchmark import harness

TINY_DAN = {"model": {"image_size": 64},
            "postprocess": {"pre_nms_topk": 300, "max_detections": 50},
            "preprocess": {"canvas_size": 128, "train_image_size": 64},
            "match": {"max_gt": 8}}
TINY_MIX = {"detect": dict(batch=4, pool=2, warmup_calls=1, sample_calls=1, sample_within=1,
                           check_images=2, check_block=2, trace_calls=1),
            "train": dict(batch=4, check_block=2, trace_steps=1)}


def tiny_cell(name: str, float32: bool = False) -> harness.Cell:
    cell = harness.find_cell(name)
    config, mix = copy.deepcopy(cell.config), copy.deepcopy(cell.mix)
    for section, kv in TINY_DAN.items():
        config["dan"][section].update(kv)
    if float32:
        config["dan"]["model"]["compute_dtype"] = "float32"
    mix["params"].update(TINY_MIX[mix["kind"]])
    return dataclasses.replace(cell, config=config, mix=mix)


def run(cell: harness.Cell, seed: int = 2**31 + 11, seconds: float = 0.0, **kw):
    import torch

    r = harness.Run(cell, seed, seconds, torch.device("cpu"), **kw)
    return harness.run_cell(r, 0.0)
