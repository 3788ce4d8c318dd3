"""Anchor matching for a batch on the card: the CUDA matcher
(csrc/matching.cu) around its two passes.

    targets = match_anchors_cuda(anchors_center (A, 4), gt_boxes (B, G, 4),
                                 gt_mask (B, G), match_config, anchor_config)

It returns what dan_tpu_torch.box.matching.match_anchors (the plain
version) returns for the batch, bit for bit: pass 1 (K3) gives the per-anchor
raw best IoU and the per-gt stats, the wrapper forms `needs` from them as
dan_tpu/ops/matching_pallas.py does between its kernels, pass 2 (K4) gives
the augmented argmax and the matched gt's centre, and the cls/loc targets
are finished in torch.  One launch of each pass covers the whole batch.

CUDA tensors only: the CPU path is the plain version, which
box.matching.match_anchors_batch takes for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from dan_tpu.config import AnchorConfig, MatchConfig
from dan_tpu_torch.box.anchors import center_to_corner, corner_to_center
from dan_tpu_torch.box.matching import MatchTargets, finish_targets
from dan_tpu_torch.ops import _cuda_build

SOURCE = "matching"

# Kernel launches since the last reset (set to 0 to reset): two per call,
# pass 1 and pass 2.
LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def build() -> ctypes.CDLL:
    lib = _cuda_build.load(SOURCE)
    lib.match_stats_launch.argtypes = [_P] * 9 + [_I] * 4 + [_F, _P]
    lib.match_stats_launch.restype = _I
    lib.match_assign_launch.argtypes = [_P] * 11 + [_I] * 3 + [_F, _P]
    lib.match_assign_launch.restype = _I
    lib.match_max_gt.argtypes = []
    lib.match_max_gt.restype = _I
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
    dev = gt_boxes.device
    if dev.type != "cuda" or anchors_center.device != dev or gt_mask.device != dev:
        raise ValueError(
            f"the matcher kernel takes CUDA tensors on one device, got anchors on "
            f"{anchors_center.device}, gts on {dev}, mask on {gt_mask.device}"
        )
    if gt_boxes.dim() != 3 or gt_boxes.shape[-1] != 4 or gt_mask.shape != gt_boxes.shape[:2]:
        raise ValueError(
            f"expected gt_boxes (B, G, 4) and gt_mask (B, G), got "
            f"{tuple(gt_boxes.shape)} and {tuple(gt_mask.shape)}"
        )
    lib = build()
    bsz, g_n = gt_mask.shape
    a_n = anchors_center.shape[0]
    if g_n > lib.match_max_gt():
        raise ValueError(f"G={g_n} gts exceed the kernel's limit {lib.match_max_gt()}")
    k = min(match_config.scale_comp_topk, a_n)
    anchors_t = center_to_corner(anchors_center.float()).t().contiguous()  # (4, A)
    gt = gt_boxes.float().contiguous()
    valid = gt_mask.to(torch.float32).contiguous()

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    best_iou, best_gt = empty(bsz, a_n), empty(bsz, a_n, dtype=torch.int32)
    gt_best_anchor = empty(bsz, g_n, dtype=torch.int32)
    gt_count = empty(bsz, g_n, dtype=torch.int32)
    kth_v, kth_i = empty(bsz, g_n), empty(bsz, g_n, dtype=torch.int32)
    stream = _cuda_build.stream_of(gt)
    with torch.cuda.device(dev):
        err = lib.match_stats_launch(
            anchors_t.data_ptr(), gt.data_ptr(), valid.data_ptr(),
            best_iou.data_ptr(), best_gt.data_ptr(), gt_best_anchor.data_ptr(),
            gt_count.data_ptr(), kth_v.data_ptr(), kth_i.data_ptr(),
            bsz, a_n, g_n, k, float(match_config.match_threshold), stream,
        )
    _cuda_build.check(err, "match_stats_launch")
    LAUNCHES += 1

    if match_config.enable_scale_comp:
        needs = ((gt_count < k) & gt_mask).to(torch.float32)
    else:
        needs = torch.zeros_like(valid)
    centers = corner_to_center(gt).contiguous()
    matched_gt = empty(bsz, a_n, dtype=torch.int32)
    matched_aug = empty(bsz, a_n)
    matched_center = empty(bsz, a_n, 4)
    with torch.cuda.device(dev):
        err = lib.match_assign_launch(
            anchors_t.data_ptr(), gt.data_ptr(), valid.data_ptr(),
            gt_best_anchor.data_ptr(), needs.data_ptr(), kth_v.data_ptr(),
            kth_i.data_ptr(), centers.data_ptr(), matched_gt.data_ptr(),
            matched_aug.data_ptr(), matched_center.data_ptr(),
            bsz, a_n, g_n, float(match_config.scale_comp_iou), stream,
        )
    _cuda_build.check(err, "match_assign_launch")
    LAUNCHES += 1
    return finish_targets(
        anchors_center, best_iou, matched_aug, matched_gt, matched_center,
        match_config, anchor_config,
    )
