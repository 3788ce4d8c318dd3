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

A tensor on the CPU goes through `greedy_nms_rank_plain`; a CUDA tensor
launches the kernel, which is built with nvcc on first use into
dan_tpu_torch/_build/ (keyed by a hash of the source).  There is no
fallback between the two: a CUDA tensor that cannot be handled raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

import torch

from dan_tpu_torch.box.iou import iou_one_to_many

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "nms.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

# Kernel launches since the last reset (set to 0 to reset).
LAUNCHES = 0
# Seconds the last nvcc build took and what nvcc printed (None until a
# build ran in this process).
BUILD_SECONDS = None
BUILD_LOG = None

_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build() -> ctypes.CDLL:
    """Compile csrc/nms.cu (once per source hash) and load it."""
    global _lib, BUILD_SECONDS, BUILD_LOG
    if _lib is not None:
        return _lib
    with open(SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"nms_{tag}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp, SOURCE],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        BUILD_SECONDS = time.perf_counter() - t0
        BUILD_LOG = proc.stdout + proc.stderr
    lib = ctypes.CDLL(so)
    lib.nms_rank_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    lib.nms_rank_launch.restype = ctypes.c_int
    lib.nms_rank_max_n.argtypes = []
    lib.nms_rank_max_n.restype = ctypes.c_int
    _lib = lib
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


def _launch(boxes, scores, iou_threshold, max_out, score_threshold):
    global LAUNCHES
    if boxes.device.type != "cuda":
        raise ValueError(f"the NMS kernel takes CUDA tensors, got {boxes.device}")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("the NMS kernel takes contiguous boxes and scores")
    bsz, n = scores.shape
    lib = build()
    if n > lib.nms_rank_max_n():
        raise ValueError(
            f"N={n} boxes exceed the kernel's shared-memory row limit "
            f"({lib.nms_rank_max_n()}); lower pre_nms_topk"
        )
    rank = torch.empty((bsz, n), dtype=torch.int32, device=boxes.device)
    if bsz == 0 or n == 0:
        return rank
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = lib.nms_rank_launch(
            boxes.data_ptr(), scores.data_ptr(), rank.data_ptr(),
            bsz, n, int(max_out), float(iou_threshold), float(score_threshold),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"nms_rank_launch failed: CUDA error {err}")
    LAUNCHES += 1
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
