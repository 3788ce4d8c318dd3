"""Batched bbox-vote on the card: the CUDA kernel of csrc/bbox_vote.cu
behind the contract of ops/bbox_vote.py.

    res = bbox_vote_batched_cuda(boxes (B, N, 4) f32, scores (B, N) f32,
                                 valid (B, N) bool, iou_threshold, max_out)
    res.boxes (B, max_out, 4), res.scores (B, max_out), res.valid (B, max_out)

Tensors on the CPU go through the plain version,
`ops.bbox_vote.bbox_vote_batched`; CUDA tensors launch the kernel, which
ops/_cuda_build.py builds with nvcc on first use.  There is no fallback
between the two: a CUDA tensor that cannot be handled raises.  `valid`,
the scores and the number of outputs equal the plain version's bit for
bit; the fused boxes agree to float rounding (the kernel sums in another
order; a non-finite coordinate gives NaN where the plain version's does)
and are the same bits from run to run.

The kernel sorts each row's active detections and resolves them in tiles
of 64 (csrc/bbox_vote.cu); `LAST_TILES` holds each row's tiles (its chain
of dependent steps) from the last launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dan_tpu_torch.ops import _cuda_build
from dan_tpu_torch.ops.bbox_vote import (
    VoteResult,
    bbox_vote_batched,
    check_vote_inputs,
)

SOURCE = "bbox_vote"

# Kernel launches since the last reset (set to 0 to reset).
LAUNCHES = 0
# (B,) int32 on the device, written by the last launch without a wait: the
# tiles each row's scan took (0 for a row with no active detection).
LAST_TILES: Optional[torch.Tensor] = None
# A tile resolves this many detections.
TILE = 64


def build() -> ctypes.CDLL:
    """Compile csrc/bbox_vote.cu (once per source hash) and load it."""
    lib = _cuda_build.load(SOURCE)
    lib.bbox_vote_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p,
    ]
    lib.bbox_vote_launch.restype = ctypes.c_int
    lib.bbox_vote_max_rows.argtypes = []
    lib.bbox_vote_max_rows.restype = ctypes.c_int
    return lib


def bbox_vote_batched_cuda(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    in_valid: torch.Tensor,
    iou_threshold: float,
    max_out: int,
) -> VoteResult:
    """(B, N, 4) f32 boxes, (B, N) f32 scores, (B, N) bool validity ->
    VoteResult with (B, max_out, ...) leaves.

    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    check_vote_inputs(boxes, scores, in_valid)
    if boxes.device.type == "cpu":
        return bbox_vote_batched(boxes, scores, in_valid, iou_threshold, max_out)
    return _launch(boxes, scores, in_valid, iou_threshold, max_out)


def bbox_vote_cuda(boxes, scores, in_valid, iou_threshold: float, max_out: int) -> VoteResult:
    """One image, (N, 4) / (N,) / (N,): the batched kernel at B = 1."""
    res = bbox_vote_batched_cuda(
        boxes[None], scores[None], in_valid[None], iou_threshold, max_out
    )
    return VoteResult(*(t[0] for t in res))


def _launch(boxes, scores, in_valid, iou_threshold, max_out) -> VoteResult:
    global LAUNCHES, LAST_TILES
    if boxes.device.type != "cuda":
        raise ValueError(f"the vote kernel takes CUDA tensors, got {boxes.device}")
    if not (boxes.is_contiguous() and scores.is_contiguous() and in_valid.is_contiguous()):
        raise ValueError("the vote kernel takes contiguous boxes, scores and valid")
    if boxes.data_ptr() % 16:
        raise ValueError("the vote kernel reads boxes as 16-byte vectors: align them")
    if max_out <= 0:
        raise ValueError(f"max_out must be positive, got {max_out}")
    bsz, n = scores.shape
    lib = build()
    if n > lib.bbox_vote_max_rows():
        raise ValueError(
            f"N={n} detections a row exceed the kernel's shared-memory limit "
            f"({lib.bbox_vote_max_rows()})"
        )
    dev = boxes.device
    out_boxes = torch.empty((bsz, max_out, 4), dtype=torch.float32, device=dev)
    out_scores = torch.empty((bsz, max_out), dtype=torch.float32, device=dev)
    out_valid = torch.empty((bsz, max_out), dtype=torch.bool, device=dev)
    if bsz == 0:
        return VoteResult(out_boxes, out_scores, out_valid)
    if n == 0:
        return VoteResult(out_boxes.zero_(), out_scores.zero_(), out_valid.zero_())
    tiles = torch.empty((bsz,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.bbox_vote_launch(
            boxes.data_ptr(), scores.data_ptr(), in_valid.data_ptr(),
            out_boxes.data_ptr(), out_scores.data_ptr(), out_valid.data_ptr(),
            tiles.data_ptr(), bsz, n, int(max_out), float(iou_threshold),
            _cuda_build.stream_of(boxes),
        )
    _cuda_build.check(err, "bbox_vote_launch")
    LAUNCHES += 1
    LAST_TILES = tiles
    return VoteResult(out_boxes, out_scores, out_valid)
