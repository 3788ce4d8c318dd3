"""Anchor matching for a batch on the card: the CUDA matcher
(csrc/matching.cu) behind one C entry point.

    targets = match_anchors_cuda(anchors_center (A, 4), gt_boxes (B, G, 4),
                                 gt_mask (B, G), match_config, anchor_config)

It returns what dan_tpu_torch.box.matching.match_anchors (the plain
version) returns for the batch, bit for bit.  One call enqueues the three
kernels on the current stream with no PyTorch work between them: pass 1
(K3: per-anchor raw best IoU, per-gt stats), pass 2 (K4: `needs`, the
augmented argmax and the four MatchTargets leaves, written directly).  The
anchors go in as the centre-format (A, 4) tensor and the mask as its bool
bytes; the wrapper only allocates the outputs and one scratch buffer.

CUDA tensors only: the CPU path is the plain version, which
box.matching.match_anchors_batch takes for CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from dan_tpu_torch.config import AnchorConfig, MatchConfig
from dan_tpu_torch.box.matching import MatchTargets
from dan_tpu_torch.ops import _cuda_build

SOURCE = "matching"
# Gt slots an image may have (kMaxG in csrc/matching.cu, which refuses more).
MAX_GT = 512

# Calls of the C entry point since the last reset (set to 0 to reset): each
# launches pass 1 (K3, two kernels) and pass 2 (K4, one kernel) once.
LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class KernelParams(NamedTuple):
    """The scalars match_launch takes, as the plain version uses them."""

    k: int  # the scale-compensation top-k, at most A
    k_needs: int  # a gt needs compensation when its count < k_needs
    match_threshold: float
    ignore_threshold: float
    scale_comp_iou: float
    prior_scaling: tuple  # four float32 values


def kernel_params(
    match_config: MatchConfig, anchor_config: AnchorConfig, num_anchors: int
) -> KernelParams:
    """The kernel's scalar arguments.  Compensation off is k_needs = 0 (no
    count is < 0); the thresholds and the prior scaling are the float32
    values the plain version compares and divides by."""
    k = min(match_config.scale_comp_topk, num_anchors)
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    return KernelParams(
        k=k,
        k_needs=k if match_config.enable_scale_comp else 0,
        match_threshold=f32(match_config.match_threshold),
        ignore_threshold=f32(match_config.ignore_threshold),
        scale_comp_iou=f32(match_config.scale_comp_iou),
        prior_scaling=tuple(f32(s) for s in anchor_config.prior_scaling),
    )


def check_inputs(anchors_center, gt_boxes, gt_mask) -> None:
    """Raise unless the inputs are what the kernel takes: (A, 4) float32
    anchors, (B, G, 4) float32 gts and a (B, G) bool mask, contiguous, with
    1 <= G <= MAX_GT and A >= 1, on one CUDA device (checked last)."""
    if (anchors_center.dim() != 2 or anchors_center.shape[-1] != 4 or gt_boxes.dim() != 3
            or gt_boxes.shape[-1] != 4 or gt_mask.shape != gt_boxes.shape[:2]):
        raise ValueError(
            f"expected anchors (A, 4), gt_boxes (B, G, 4) and gt_mask (B, G), got "
            f"{tuple(anchors_center.shape)}, {tuple(gt_boxes.shape)} and {tuple(gt_mask.shape)}"
        )
    if anchors_center.dtype != torch.float32 or gt_boxes.dtype != torch.float32:
        raise TypeError(f"expected float32 anchors and gts, got {anchors_center.dtype} and "
                        f"{gt_boxes.dtype}")
    if gt_mask.dtype != torch.bool:
        raise TypeError(f"expected a bool gt mask, got {gt_mask.dtype}")
    if not (anchors_center.is_contiguous() and gt_boxes.is_contiguous()
            and gt_mask.is_contiguous()):
        raise ValueError("the matcher kernel takes contiguous anchors, gts and mask")
    g_n = gt_mask.shape[1]
    if not 1 <= g_n <= MAX_GT:
        raise ValueError(f"G={g_n} gt slots: the kernel takes 1..{MAX_GT}")
    if anchors_center.shape[0] == 0:
        raise ValueError("no anchors")
    dev = gt_boxes.device
    if dev.type != "cuda" or anchors_center.device != dev or gt_mask.device != dev:
        raise ValueError(
            f"the matcher kernel takes CUDA tensors on one device, got anchors on "
            f"{anchors_center.device}, gts on {dev}, mask on {gt_mask.device}"
        )


def build() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    lib.match_launch.argtypes = [_P] * 8 + [_I] * 5 + [_F] * 7 + [_P]
    lib.match_launch.restype = _I
    lib.match_scratch_ints.argtypes = [_I] * 3
    lib.match_scratch_ints.restype = ctypes.c_longlong
    return lib


def match_anchors_cuda(
    anchors_center: torch.Tensor,
    gt_boxes: torch.Tensor,
    gt_mask: torch.Tensor,
    match_config: MatchConfig,
    anchor_config: AnchorConfig,
) -> MatchTargets:
    """(A, 4) centre anchors, (B, G, 4) corner gts and (B, G) mask, all on
    one CUDA device -> MatchTargets with (B, A) leaves."""
    global LAUNCHES
    check_inputs(anchors_center, gt_boxes, gt_mask)
    lib = build()
    bsz, g_n = gt_mask.shape
    a_n = anchors_center.shape[0]
    p = kernel_params(match_config, anchor_config, a_n)
    dev = gt_boxes.device
    cls = torch.empty((bsz, a_n), dtype=torch.int32, device=dev)
    loc = torch.empty((bsz, a_n, 4), dtype=torch.float32, device=dev)
    matched_gt = torch.empty((bsz, a_n), dtype=torch.int32, device=dev)
    matched_iou = torch.empty((bsz, a_n), dtype=torch.float32, device=dev)
    scratch = torch.empty((lib.match_scratch_ints(bsz, a_n, g_n),), dtype=torch.int32,
                          device=dev)
    with torch.cuda.device(dev):
        err = lib.match_launch(
            anchors_center.data_ptr(), gt_boxes.data_ptr(), gt_mask.data_ptr(),
            cls.data_ptr(), loc.data_ptr(), matched_gt.data_ptr(), matched_iou.data_ptr(),
            scratch.data_ptr(), bsz, a_n, g_n, p.k, p.k_needs, p.match_threshold,
            p.ignore_threshold, p.scale_comp_iou, *p.prior_scaling,
            _cuda_build.stream_of(gt_boxes),
        )
    _cuda_build.check(err, "match_launch")
    LAUNCHES += 1
    return MatchTargets(cls_target=cls, loc_target=loc, matched_gt=matched_gt,
                        matched_iou=matched_iou)
