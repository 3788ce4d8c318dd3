"""Batched greedy NMS as selection ranks: the CUDA kernel
(csrc/nms.cu) and its plain PyTorch version.

    rank = greedy_nms_rank(boxes (B, N, 4) f32, scores (B, N) f32,
                           iou_threshold, max_out, score_threshold)

rank[b, n] = k when box n of row b was the k-th box kept, -1 when it was
not kept.  Per row: greedy by descending score, lowest index on ties, a box
is suppressed when its IoU with a kept box is strictly greater than the
threshold, boxes with score <= score_threshold never take part.  The input
need not be sorted.  ops.nms.rank_to_result turns ranks into the ordered
fixed-shape NMSResult.

The kernel picks one of two paths for each row, on the device: a row whose
scores are non-increasing (`rows_sorted`; what filter_and_topk's stable sort
hands over on the detect and TTA paths) takes the tile scan, one dependent
step for every 64 boxes still active; any other row takes the argmax loop, one step for
every box kept.  A row of up to `nms_rank_shared_max_n()` boxes (9,557) is
held in shared memory; a longer one, up to the 32-bit index, runs both
paths from global scratch that the wrapper allocates (24 bytes a box).  All
give the ranks of `greedy_nms_rank_plain` bit for bit.  `LAST_PATHS` holds
which path each row of the last launch took: bit 0 (TILE_SCAN) the tile
scan, bit 1 (LONG_ROW) the long-row path.

A tensor on the CPU goes through `greedy_nms_rank_plain`; a CUDA tensor
launches the kernel, which ops/_cuda_build.py builds with nvcc on first
use into dan_tpu_torch/_build/ (keyed by a hash of the source).  There is no
fallback between the two: a CUDA tensor that cannot be handled raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dan_tpu_torch.box.iou import iou_one_to_many
from dan_tpu_torch.ops import _cuda_build

SOURCE = "nms"
# The longest row the kernel takes: its row index is a 32-bit int that
# steps by the block's 1024 threads.
MAX_N = 2**31 - 1 - 1024

# Kernel launches since the last reset (set to 0 to reset).
LAUNCHES = 0
# (B,) uint8 on the device, written by the last launch without a wait: bit
# TILE_SCAN where the row took the tile scan (else the argmax loop), bit
# LONG_ROW where it ran from global scratch (else from shared memory).
LAST_PATHS: Optional[torch.Tensor] = None
TILE_SCAN = 1
LONG_ROW = 2
# (B,) int32, likewise: the tiles (dependent steps) each row's scan took; 0
# where the row took the argmax loop.
LAST_TILES: Optional[torch.Tensor] = None


def build() -> ctypes.CDLL:
    """Compile csrc/nms.cu (once per source hash) and load it."""
    lib = _cuda_build.load(SOURCE)
    lib.nms_rank_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.nms_rank_launch.restype = ctypes.c_int
    lib.nms_rank_shared_max_n.argtypes = []
    lib.nms_rank_shared_max_n.restype = ctypes.c_int
    lib.nms_rank_scratch_floats.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.nms_rank_scratch_floats.restype = ctypes.c_longlong
    return lib


def _check(boxes: torch.Tensor, scores: torch.Tensor) -> None:
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or scores.dim() != 2:
        raise ValueError(
            f"expected boxes (B, N, 4) and scores (B, N), got "
            f"{tuple(boxes.shape)} and {tuple(scores.shape)}"
        )
    if boxes.shape[:2] != scores.shape:
        raise ValueError(f"boxes {tuple(boxes.shape)} vs scores {tuple(scores.shape)}")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"expected float32, got {boxes.dtype} and {scores.dtype}")
    if boxes.device != scores.device:
        raise ValueError(f"boxes on {boxes.device}, scores on {scores.device}")


def greedy_nms_rank(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    score_threshold: float = 0.0,
) -> torch.Tensor:
    """(B, N, 4) f32 boxes + (B, N) f32 scores -> (B, N) int32 ranks.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check(boxes, scores)
    if boxes.device.type == "cpu":
        return greedy_nms_rank_plain(
            boxes, scores, iou_threshold, max_out, score_threshold
        )
    return _launch(boxes, scores, iou_threshold, max_out, score_threshold)


def rows_sorted(scores: torch.Tensor) -> torch.Tensor:
    """(B, N) scores -> (B,) bool: the rule by which the kernel sends a row
    to the tile scan.  A row is sorted when no score is followed by a larger
    one; ties and a tail of zeros are in order, a NaN anywhere is not."""
    return (scores[:, :-1] >= scores[:, 1:]).all(dim=1)


def _launch(boxes, scores, iou_threshold, max_out, score_threshold):
    global LAUNCHES, LAST_PATHS, LAST_TILES
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("the NMS kernel takes contiguous boxes and scores")
    if boxes.device.type != "cuda":
        raise ValueError(f"the NMS kernel takes CUDA tensors, got {boxes.device}")
    bsz, n = scores.shape
    if n > MAX_N:
        raise ValueError(f"N={n} boxes exceed the kernel's 32-bit row index ({MAX_N})")
    lib = build()
    rank = torch.empty((bsz, n), dtype=torch.int32, device=boxes.device)
    if bsz == 0 or n == 0:
        return rank
    paths = torch.empty((bsz,), dtype=torch.uint8, device=boxes.device)
    tiles = torch.empty((bsz,), dtype=torch.int32, device=boxes.device)
    # The long-row path's rows: (B, 6, N) floats, none for shared-memory rows.
    scratch = torch.empty((lib.nms_rank_scratch_floats(bsz, n),), dtype=torch.float32,
                          device=boxes.device)
    with torch.cuda.device(boxes.device):
        err = lib.nms_rank_launch(
            boxes.data_ptr(), scores.data_ptr(), rank.data_ptr(), paths.data_ptr(),
            tiles.data_ptr(), scratch.data_ptr() if scratch.numel() else None,
            bsz, n, int(max_out), float(iou_threshold), float(score_threshold),
            _cuda_build.stream_of(boxes),
        )
    _cuda_build.check(err, "nms_rank_launch")
    LAUNCHES += 1
    LAST_PATHS, LAST_TILES = paths, tiles
    return rank


def greedy_nms_rank_plain(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    iou_threshold: float,
    max_out: int,
    score_threshold: float = 0.0,
) -> torch.Tensor:
    """The plain PyTorch version: all rows in lockstep as (B, N) tensor ops,
    in the operation order of the TPU kernel (nms_batched_pallas.py)."""
    _check(boxes, scores)
    bsz, n = scores.shape
    dev = boxes.device
    thr = torch.tensor(iou_threshold, dtype=torch.float32, device=dev)
    neg_inf = torch.tensor(-float("inf"), dtype=torch.float32, device=dev)
    active = scores > torch.tensor(score_threshold, dtype=torch.float32, device=dev)
    rank = torch.full((bsz, n), -1, dtype=torch.int32, device=dev)
    col = torch.arange(n, device=dev)
    rows = torch.arange(bsz, device=dev)
    for i in range(max_out):
        if i % 16 == 0 and not bool(active.any()):
            break
        masked = torch.where(active, scores, neg_inf)
        best = masked.max(dim=1, keepdim=True).values
        valid = best > neg_inf  # (B, 1)
        # Per-row argmax, lowest index on ties.
        j = torch.where(masked == best, col, n).min(dim=1).values
        sel = (col == j[:, None]) & valid
        suppress = (iou_one_to_many(boxes[rows, j], boxes) > thr) | sel
        rank = torch.where(sel, i, rank)
        active = active & ~(valid & suppress)
    return rank
