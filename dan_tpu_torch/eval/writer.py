"""WIDER FACE output writer (SURVEY.md §2 'WIDER output writer' [B]):
per-image `events/<event>/<img>.txt` with

    <image stem>
    <num dets>
    <x> <y> <w> <h> <score>
    ...
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np


def write_wider_detections(
    output_dir: str, rel_path: str, bboxes: np.ndarray, scores: np.ndarray
) -> str:
    """bboxes: (N, 4) corner boxes in original pixels; scores: (N,)."""
    stem = os.path.splitext(rel_path)[0]
    event = os.path.dirname(stem)
    name = os.path.basename(stem)
    out_dir = os.path.join(output_dir, event)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name + ".txt")
    with open(path, "w") as f:
        f.write(f"{name}\n")
        f.write(f"{len(bboxes)}\n")
        for (x1, y1, x2, y2), s in zip(bboxes, scores):
            f.write(f"{x1:.1f} {y1:.1f} {x2 - x1:.1f} {y2 - y1:.1f} {s:.6f}\n")
    return path


def read_wider_detections(path: str) -> np.ndarray:
    """Inverse of write_wider_detections -> (N, 5) [x1 y1 x2 y2 score]."""
    with open(path) as f:
        lines = [ln.strip() for ln in f]
    n = int(lines[1])
    out = np.zeros((n, 5), np.float64)
    for i in range(n):
        x, y, w, h, s = (float(v) for v in lines[2 + i].split())
        out[i] = [x, y, x + w, y + h, s]
    return out


def load_detection_dir(pred_dir: str) -> Dict[str, np.ndarray]:
    """Read a full events/<event>/<img>.txt tree -> {event/stem: (N, 5)}."""
    preds = {}
    for event in sorted(os.listdir(pred_dir)):
        evt_dir = os.path.join(pred_dir, event)
        if not os.path.isdir(evt_dir):
            continue
        for fname in sorted(os.listdir(evt_dir)):
            if fname.endswith(".txt"):
                stem = f"{event}/{fname[:-4]}"
                preds[stem] = read_wider_detections(
                    os.path.join(evt_dir, fname)
                )
    return preds
