"""The work of a greedy selection (NMS), counted from its rows: a frozen
copy of the port's card check's `selection_work`, so that the count is the
same whatever implements the kernel.

An IoU against the selected box costs 13 operations (4 max/min, 2
subtractions, 2 clamps, a product, 2 for the union, the union > 0 test, a
division; areas are made once), the threshold test 1 and the compare of
the running argmax 1, for every candidate still active in a dependent
step.  A row reads 20 bytes a box (box and score) and writes a 4-byte rank.
"""
from __future__ import annotations

import torch

from benchmark.counts.peaks import least_seconds
from benchmark.reference.detect import iou_one_to_many

IOU_OPS, TEST_OPS, ARGMAX_OPS = 13, 1, 1
NMS_BYTES_PER_BOX = 24


def selection_work(boxes, scores, active, thr, max_out):
    """Replay the greedy selection, all rows in lockstep: up to max_out
    times a row, take the active candidate of highest score (lowest index
    on ties) and deactivate it and every active candidate whose IoU with it
    is > thr.  -> per row, int64: the dependent
    steps, the (selected, other still active) pairs summed over the steps,
    and the candidates deactivated."""
    bsz, n = scores.shape
    dev = boxes.device
    col, rows = torch.arange(n, device=dev), torch.arange(bsz, device=dev)
    neg_inf = torch.tensor(-float("inf"), dtype=torch.float32, device=dev)
    thr_t = torch.tensor(thr, dtype=torch.float32, device=dev)
    steps = torch.zeros(bsz, dtype=torch.int64, device=dev)
    pairs = torch.zeros(bsz, dtype=torch.int64, device=dev)
    at_start = active.sum(dim=1)
    for i in range(max_out):
        if i % 16 == 0 and not bool(active.any()):
            break
        masked = torch.where(active, scores, neg_inf)
        best = masked.max(dim=1).values
        live = best > neg_inf
        j = torch.where(masked == best[:, None], col, n).min(dim=1).values
        j = torch.where(live, j, 0)
        iou = iou_one_to_many(boxes[rows, j], boxes)
        hit = iou > thr_t
        steps += live
        pairs += (active.sum(dim=1) - 1).clamp_min(0)
        active = active & ~(hit | (col == j[:, None]))
    return steps, pairs, at_start - active.sum(dim=1)


def nms_least_seconds(boxes, scores, thr, max_out) -> float:
    """The least time of one NMS launch over these (B, N) rows."""
    _, pairs, _ = selection_work(boxes, scores, scores > 0.0, thr, max_out)
    ops = int(pairs.sum()) * (IOU_OPS + TEST_OPS + ARGMAX_OPS)
    return least_seconds(scores.numel() * NMS_BYTES_PER_BOX, ops, "float32")
