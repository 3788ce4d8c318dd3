"""Blocked (bitmask) greedy NMS over score-sorted boxes: the CUDA kernel of
csrc/nms_blocked.cu and its plain PyTorch version (counterpart of
dan_tpu/ops/nms_blocked_pallas.py).

    res = greedy_nms_blocked_cuda(boxes (N, 4) f32, scores (N,) f32 sorted
                                  descending, iou_threshold, max_out)

Same contract as ops.nms.greedy_nms on sorted input: a box is kept unless
an earlier kept box overlaps it with IoU strictly greater than the
threshold; boxes with score <= score_threshold are never kept and never
suppress; the first max_out kept boxes are returned through
ops.nms.rank_to_result.  Nothing on the detect or TTA path calls it (as in
the JAX package, where the argmax-loop kernel is the dispatched one); it
is the path for one large sorted row.

The kernel writes the selection ranks itself and stops at the max_out-th
kept box; the plain version makes the kept mask and ranks it
(`kept_to_rank`).  Tensors on the CPU go through `greedy_nms_blocked_plain`;
CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from dan_tpu_torch.box.iou import pairwise_iou
from dan_tpu_torch.ops import _cuda_build
from dan_tpu_torch.ops.nms import NMSResult, rank_to_result

SOURCE = "nms_blocked"
TILE = 64  # boxes per bitmask word, as in the kernel

# Kernel launches since the last reset (set to 0 to reset).
LAUNCHES = 0


def build() -> ctypes.CDLL:
    """Compile csrc/nms_blocked.cu (once per source hash) and load it."""
    lib = _cuda_build.load(SOURCE)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.nms_blocked_mask_launch.argtypes = [ptr, ptr, i32, f32, ptr]
    lib.nms_blocked_mask_launch.restype = ctypes.c_int
    lib.nms_blocked_scan_launch.argtypes = [ptr, ptr, ptr, i32, f32, i32, ptr]
    lib.nms_blocked_scan_launch.restype = ctypes.c_int
    lib.nms_blocked_max_n.argtypes = []
    lib.nms_blocked_max_n.restype = ctypes.c_int
    lib.nms_blocked_mask_words.argtypes = [ctypes.c_int]
    lib.nms_blocked_mask_words.restype = ctypes.c_longlong
    return lib


def _check(boxes: torch.Tensor, scores: torch.Tensor) -> None:
    if boxes.dim() != 2 or boxes.shape[-1] != 4 or scores.shape != boxes.shape[:1]:
        raise ValueError(
            f"expected boxes (N, 4) and scores (N,), got "
            f"{tuple(boxes.shape)} and {tuple(scores.shape)}"
        )
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"expected float32, got {boxes.dtype} and {scores.dtype}")
    if boxes.device != scores.device:
        raise ValueError(f"boxes on {boxes.device}, scores on {scores.device}")
    if scores.numel() > 1 and not bool((scores[1:] <= scores[:-1]).all()):
        raise ValueError("blocked NMS takes scores sorted in descending order")


def kept_to_rank(kept: torch.Tensor, max_out: int) -> torch.Tensor:
    """(N,) bool kept mask of a sorted row -> (N,) int32 selection ranks:
    the k-th kept box gets k, everything else (and every kept box past
    max_out) gets -1."""
    order = torch.cumsum(kept.to(torch.int32), dim=0, dtype=torch.int32) - 1
    return torch.where(kept & (order < max_out), order, -1)


def greedy_nms_blocked_cuda(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    score_threshold: float = 0.0,
) -> NMSResult:
    """Drop-in greedy NMS for a row sorted by descending score -> the first
    max_out kept boxes as a fixed-shape NMSResult.  CPU tensors take the
    plain version; CUDA tensors launch the kernel.  The check of the
    descending order waits for the device on a CUDA tensor."""
    _check(boxes, scores)
    if boxes.device.type == "cpu":
        rank = kept_to_rank(_kept_plain(boxes, scores, iou_threshold, score_threshold), max_out)
    else:
        rank = _launch(boxes, scores, iou_threshold, score_threshold, max_out)
    return rank_to_result(rank, boxes, scores, max_out)


def greedy_nms_blocked_plain(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    score_threshold: float = 0.0,
) -> NMSResult:
    """The plain PyTorch version of greedy_nms_blocked_cuda, on any device."""
    _check(boxes, scores)
    kept = _kept_plain(boxes, scores, iou_threshold, score_threshold)
    return rank_to_result(kept_to_rank(kept, max_out), boxes, scores, max_out)


def _kept_plain(boxes, scores, iou_threshold, score_threshold=0.0):
    """The (N,) bool kept mask by the blocked formulation in tensor ops:
    tile by tile in score order, resolve the tile serially on its own IoU
    tile, then let its kept boxes suppress every later box in one sweep."""
    n = scores.shape[0]
    dev = boxes.device
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=dev)
    removed = scores <= torch.tensor(score_threshold, dtype=torch.float32, device=dev)
    for start in range(0, n, TILE):
        stop = min(start + TILE, n)
        over = pairwise_iou(boxes[start:stop], boxes[start:]) > thr  # (T, N - start)
        rem = removed[start:stop].tolist()
        intra = over[:, : stop - start].tolist()
        for i in range(stop - start):
            if not rem[i]:
                row = intra[i]
                for j in range(i + 1, stop - start):
                    if row[j]:
                        rem[j] = True
        rem_t = torch.tensor(rem, dtype=torch.bool, device=dev)
        removed[start:stop] = rem_t
        if stop < n:
            removed[stop:] |= (over[:, stop - start:] & ~rem_t[:, None]).any(dim=0)
    return ~removed


def _launch(boxes, scores, iou_threshold, score_threshold, max_out) -> torch.Tensor:
    """Launch both passes on checked CUDA tensors (one counted launch) ->
    the (N,) int32 ranks."""
    global LAUNCHES
    if boxes.device.type != "cuda":
        raise ValueError(f"the blocked NMS kernel takes CUDA tensors, got {boxes.device}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("the blocked NMS kernel takes contiguous boxes and scores")
    n = scores.shape[0]
    lib = build()
    if n > lib.nms_blocked_max_n():
        raise ValueError(f"N={n} boxes exceed the kernel's limit ({lib.nms_blocked_max_n()})")
    rank = torch.empty((n,), dtype=torch.int32, device=boxes.device)
    if n == 0:
        return rank
    mask = torch.empty((lib.nms_blocked_mask_words(n),), dtype=torch.int64, device=boxes.device)
    if mask.data_ptr() % 16:
        raise ValueError("the blocked NMS scan's bulk copies need a 16-byte aligned mask")
    stream = _cuda_build.stream_of(boxes)
    with torch.cuda.device(boxes.device):
        _cuda_build.check(lib.nms_blocked_mask_launch(
            boxes.data_ptr(), mask.data_ptr(), n, float(iou_threshold), stream),
            "nms_blocked_mask_launch")
        _cuda_build.check(lib.nms_blocked_scan_launch(
            scores.data_ptr(), mask.data_ptr(), rank.data_ptr(), n, float(score_threshold),
            int(max_out), stream), "nms_blocked_scan_launch")
    LAUNCHES += 1
    return rank
