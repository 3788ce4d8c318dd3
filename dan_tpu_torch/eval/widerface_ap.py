"""WIDER FACE easy/medium/hard AP evaluation (SURVEY.md §2 'WIDER output
writer + AP eval' [B][K]).  The port's copy of dan_tpu/eval/widerface_ap.py
on its numpy matcher (the C++ matcher of dan_tpu/native is not copied).

Self-contained vectorized re-implementation of the official
`widerface_evaluate` protocol (the reference vendors the official tool; its
Cython `bbox_overlaps` is replaced by vectorized numpy here):

  1. global min-max score normalization over the whole prediction set;
  2. per image: score-descending greedy IoU-0.5 matching, one det per gt;
     gts outside the difficulty subset are IGNORED (a det matching an
     ignored gt is neither TP nor FP);
  3. PR curve over 1000 score thresholds;
  4. AP = all-points interpolated area under the PR curve (VOC style).

Difficulty subsets come from the official eval-tool .mat files when
available (scipy.io); otherwise a documented height-based approximation is
used (easy h>=50px, medium h>=30px, hard all — [?], clearly flagged,
because the official subsets are hand-curated lists, not a rule).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SETTINGS = ("easy", "medium", "hard")


def _bbox_overlaps(dets: np.ndarray, gts: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) corner IoU matrix, vectorized."""
    if len(dets) == 0 or len(gts) == 0:
        return np.zeros((len(dets), len(gts)), np.float64)
    ix1 = np.maximum(dets[:, None, 0], gts[None, :, 0])
    iy1 = np.maximum(dets[:, None, 1], gts[None, :, 1])
    ix2 = np.minimum(dets[:, None, 2], gts[None, :, 2])
    iy2 = np.minimum(dets[:, None, 3], gts[None, :, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    area_d = (dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
    area_g = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    union = area_d[:, None] + area_g[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def _image_eval(
    dets: np.ndarray,
    gts: np.ndarray,
    keep_index: np.ndarray,
    iou_thresh: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Official per-image matching.

    dets: (N, 5) [x1 y1 x2 y2 score] sorted by descending score.
    gts: (M, 4); keep_index: indices of gts in the difficulty subset.
    Returns (pred_recall (N,), proposal (N,)): pred_recall[i] = matched
    subset-gts among dets[:i+1]; proposal[i] = 0 if det i matched an
    ignored gt (excluded from precision), else 1.
    """
    n = len(dets)
    pred_recall = np.zeros(n, np.int64)
    proposal = np.ones(n, np.int64)
    if n == 0:
        return pred_recall, proposal
    ignore = np.ones(len(gts), bool)  # True -> ignored
    ignore[keep_index] = False
    overlaps = _bbox_overlaps(dets[:, :4].astype(np.float64), gts.astype(np.float64))
    gt_matched = np.zeros(len(gts), bool)
    recall_count = 0
    for i in range(n):
        if len(gts):
            j = int(np.argmax(overlaps[i]))
            if overlaps[i, j] >= iou_thresh:
                if ignore[j]:
                    # Official rule: EVERY det whose best-overlap gt lies
                    # outside the difficulty subset is excluded from the
                    # proposal pool (no matched gate on this branch).
                    proposal[i] = 0
                elif not gt_matched[j]:
                    gt_matched[j] = True
                    recall_count += 1
        pred_recall[i] = recall_count
    return pred_recall, proposal


def _voc_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """All-points interpolated AP (official `voc_ap`)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _norm_scores(predictions: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Global min-max normalization of scores to (0, 1]."""
    all_scores = np.concatenate(
        [p[:, 4] for p in predictions.values() if len(p)] or [np.zeros(1)]
    )
    lo, hi = all_scores.min(), all_scores.max()
    rng = max(hi - lo, 1e-12)
    out = {}
    for k, p in predictions.items():
        p = p.astype(np.float64).copy()
        if len(p):
            p[:, 4] = (p[:, 4] - lo) / rng
        out[k] = p
    return out


def approx_difficulty_keep(
    boxes: np.ndarray, setting: str
) -> np.ndarray:
    """Height-based approximation of the official subsets [?]: used only
    when the official .mat lists are unavailable."""
    if len(boxes) == 0:
        return np.zeros((0,), np.int64)
    h = boxes[:, 3] - boxes[:, 1]
    if setting == "easy":
        return np.nonzero(h >= 50)[0]
    if setting == "medium":
        return np.nonzero(h >= 30)[0]
    return np.arange(len(boxes))


def evaluate_widerface(
    predictions: Dict[str, np.ndarray],
    gt_boxes: Dict[str, np.ndarray],
    keep_lists: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
    iou_thresh: float = 0.5,
    num_thresholds: int = 1000,
) -> Dict[str, float]:
    """Run the full protocol.

    Args:
      predictions: rel_path -> (N, 5) [x1 y1 x2 y2 score] (any order).
      gt_boxes: rel_path -> (M, 4) corner gt boxes.
      keep_lists: setting -> rel_path -> gt indices in that subset.  If
        None, the height-based approximation is used.
    Returns {'easy': AP, 'medium': AP, 'hard': AP}.
    """
    predictions = _norm_scores(predictions)
    results: Dict[str, float] = {}
    for setting in SETTINGS:
        count_gt = 0
        pr_curve = np.zeros((num_thresholds, 2), np.float64)
        for key, gts in gt_boxes.items():
            dets = predictions.get(key, np.zeros((0, 5)))
            order = np.argsort(-dets[:, 4], kind="stable") if len(dets) else []
            dets = dets[order] if len(dets) else dets
            if keep_lists is not None:
                keep = np.asarray(
                    keep_lists[setting].get(key, np.zeros(0)), np.int64
                )
            else:
                keep = approx_difficulty_keep(gts, setting)
            count_gt += len(keep)
            if len(gts) == 0 or len(dets) == 0:
                continue
            pred_recall, proposal = _image_eval(dets, gts, keep, iou_thresh)
            # PR info over thresholds (official `img_pr_info`), vectorized:
            # dets are score-descending, so the last det with score >=
            # thresh_t is a searchsorted position.
            thresh = 1.0 - (np.arange(1, num_thresholds + 1) / num_thresholds)
            # r[t] = #dets with score >= thresh_t (scores descending).
            r = np.searchsorted(-dets[:, 4], -thresh, side="right")
            has = r > 0
            cum_proposal = np.cumsum(proposal)
            pr_curve[has, 0] += cum_proposal[r[has] - 1]
            pr_curve[has, 1] += pred_recall[r[has] - 1]
        if count_gt == 0:
            results[setting] = 0.0
            continue
        with np.errstate(divide="ignore", invalid="ignore"):
            precision = np.where(
                pr_curve[:, 0] > 0, pr_curve[:, 1] / pr_curve[:, 0], 0.0
            )
        recall = pr_curve[:, 1] / count_gt
        results[setting] = _voc_ap(recall, precision)
    return results


def load_official_gt(
    eval_tools_gt_dir: str,
) -> Tuple[Dict[str, np.ndarray], Dict[str, Dict[str, np.ndarray]], List[str]]:
    """Load the official eval-tool ground-truth .mat files
    (wider_face_val.mat, wider_{easy,medium,hard}_val.mat) via scipy.

    Returns (gt_boxes by rel_path-stem, keep_lists[setting][stem], stems).
    """
    from scipy.io import loadmat

    main = loadmat(os.path.join(eval_tools_gt_dir, "wider_face_val.mat"))
    setting_files = {
        "easy": "wider_easy_val.mat",
        "medium": "wider_medium_val.mat",
        "hard": "wider_hard_val.mat",
    }
    events = [str(e[0][0]) for e in main["event_list"]]
    gt_boxes: Dict[str, np.ndarray] = {}
    keep_lists: Dict[str, Dict[str, np.ndarray]] = {s: {} for s in SETTINGS}
    stems: List[str] = []
    settings_raw = {
        s: loadmat(os.path.join(eval_tools_gt_dir, f)) for s, f in setting_files.items()
    }
    for ei, event in enumerate(events):
        files = main["file_list"][ei][0]
        boxes_evt = main["face_bbx_list"][ei][0]
        for fi in range(len(files)):
            stem = f"{event}/{str(files[fi][0][0])}"
            stems.append(stem)
            b = boxes_evt[fi][0].astype(np.float64).reshape(-1, 4)
            # .mat boxes are (x, y, w, h) -> corners.
            b = np.stack(
                [b[:, 0], b[:, 1], b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]], -1
            )
            gt_boxes[stem] = b
            for s in SETTINGS:
                raw = settings_raw[s]["gt_list"][ei][0][fi][0]
                keep = (
                    raw.astype(np.int64).reshape(-1) - 1  # MATLAB 1-based
                    if raw.size
                    else np.zeros(0, np.int64)
                )
                keep_lists[s][stem] = keep
    return gt_boxes, keep_lists, stems
