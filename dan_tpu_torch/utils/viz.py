"""Detection drawing (the port's copy of dan_tpu/utils/viz.py). Host-side;
cv2 is imported when a picture is drawn."""
from __future__ import annotations

import numpy as np


def draw_detections(
    image_rgb: np.ndarray,
    bboxes: np.ndarray,
    scores: np.ndarray,
    out_path: str,
    color=(0, 255, 0),
) -> None:
    """Write image_rgb with a box and its score for each detection to
    out_path (any format cv2.imwrite takes)."""
    import cv2

    img = image_rgb[:, :, ::-1].copy()  # RGB -> BGR for cv2
    for box, s in zip(np.asarray(bboxes), np.asarray(scores)):
        x1, y1, x2, y2 = (int(round(v)) for v in box)
        cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
        cv2.putText(
            img,
            f"{s:.2f}",
            (x1, max(y1 - 4, 10)),
            cv2.FONT_HERSHEY_SIMPLEX,
            0.4,
            color,
            1,
        )
    cv2.imwrite(out_path, img)
