"""WIDER FACE annotation parsing and dataset indexing.

Replaces the reference's TFRecord conversion step (SURVEY.md §2 'TFRecord
converter', §3.5): instead of re-serializing JPEGs into TFRecords, we parse
`wider_face_split/wider_face_{train,val}_bbx_gt.txt` directly into an
in-memory index of (image path, boxes, event) records; the host pipeline
reads JPEGs straight from disk.

Annotation format (one record):
    <event>/<image>.jpg
    <num_faces>
    <x> <y> <w> <h> <blur> <expression> <illumination> <invalid> <occlusion> <pose>
    ... (num_faces rows; a 0-face image has one all-zeros row)

Filtering matches the reference converter [K]: drop faces with w<=0 or
h<=0 or invalid==1.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class ImageRecord:
    path: str  # absolute path to the JPEG
    rel_path: str  # '<event>/<image>.jpg' (WIDER output-writer key)
    event: str
    boxes: np.ndarray  # (n, 4) float32 corner boxes (x1, y1, x2, y2)
    # Raw attribute columns for the eval protocol's difficulty sub-setting
    # (blur, expression, illumination, invalid, occlusion, pose), (n, 6).
    attrs: np.ndarray


def parse_bbx_gt(
    gt_file: str,
    images_root: str,
    keep_invalid: bool = False,
) -> List[ImageRecord]:
    """Parse a wider_face_*_bbx_gt.txt file into ImageRecords."""
    records: List[ImageRecord] = []
    with open(gt_file) as f:
        lines = [ln.strip() for ln in f]
    i = 0
    while i < len(lines):
        rel = lines[i]
        if not rel:
            i += 1
            continue
        n = int(lines[i + 1])
        rows = lines[i + 2 : i + 2 + max(n, 1)]
        i += 2 + max(n, 1)
        boxes, attrs = [], []
        for row in rows[:n]:
            vals = [float(v) for v in row.split()]
            x, y, w, h = vals[:4]
            attr = vals[4:10] if len(vals) >= 10 else [0.0] * 6
            invalid = attr[3] if len(attr) > 3 else 0.0
            if w <= 0 or h <= 0:
                continue
            if invalid and not keep_invalid:
                continue
            boxes.append([x, y, x + w, y + h])
            attrs.append(attr)
        records.append(
            ImageRecord(
                path=os.path.join(images_root, rel),
                rel_path=rel,
                event=rel.split("/")[0],
                boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
                attrs=np.asarray(attrs, np.float32).reshape(-1, 6),
            )
        )
    return records


def load_split(
    wider_root: str, split: str = "train", keep_invalid: bool = False
) -> List[ImageRecord]:
    """Load 'train' or 'val' given the standard WIDER directory layout:

        <root>/wider_face_split/wider_face_<split>_bbx_gt.txt
        <root>/WIDER_<split>/images/<event>/<img>.jpg
    """
    gt = os.path.join(
        wider_root, "wider_face_split", f"wider_face_{split}_bbx_gt.txt"
    )
    images = os.path.join(wider_root, f"WIDER_{split}", "images")
    return parse_bbx_gt(gt, images, keep_invalid=keep_invalid)


def load_image_rgb(path: str) -> np.ndarray:
    """Decode a JPEG to (H, W, 3) uint8 RGB (host I/O only — no math)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img[:, :, ::-1].copy()  # BGR -> RGB
