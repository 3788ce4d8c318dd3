"""Image-pyramid + horizontal-flip TTA with bbox-vote fusion on the device
(counterpart of dan_tpu/eval/tta.py; SURVEY.md §3.2, BASELINE.json config 4).

Reference protocol [K — S3FD]:
  * det0: forward at shrink = min(1, sqrt(max_pixels / (h*w)));
  * flip test: forward the mirrored image, un-mirror boxes;
  * multi-scale test at st in {0.5, 0.75, 1.25, 1.5, 1.75} (+2.0 for small
    images), where st > 1 passes keep only small boxes and st < 1 only
    large ones;
  * all detections fused with bbox-vote.

The reference runs each (image, scale, flip) as a separate variable-shape
forward with host numpy post-processing.  Here a fixed set of square
resolution BUCKETS gives one input shape per bucket: each (image, variant)
unit is resized on the device into its bucket (zero-padded), the units of a
bucket run as one batch through forward, decode, filter, top-k and ONE
batched greedy-NMS launch (ops/nms_cuda.py), and the per-image fusion is
one batched bbox-vote launch (ops/bbox_vote_cuda.py).  On a CUDA device
both are the hand-written kernels; on the CPU their plain versions.

The planners (`plan_variants` ... `plan_variant_buckets`) are numpy-free
Python and equal the JAX package's bit for bit, so both packages launch
the same work.

On N ranks (`run_dataset(..., mesh=mesh)`, dan_tpu_torch/parallel/) every
rank plans the whole dataset; rank r runs the r-th block of
batch_per_device units of each chunk of N x batch_per_device and the r-th
share of each vote chunk, and the ranks gather the pre-vote rows and the
results over the host group, so every rank returns the whole dict.  Each
rank's launches are those of a one-device run at the same
batch_per_device, so the results are the same bits.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from dan_tpu_torch.box.anchors import generate_anchors
from dan_tpu_torch.box.decode import decode_boxes
from dan_tpu_torch.config import DANConfig
from dan_tpu_torch.device import resolve_device
from dan_tpu_torch.ops.bbox_vote_cuda import bbox_vote_batched_cuda
from dan_tpu_torch.ops.nms import rank_to_result
from dan_tpu_torch.ops.nms_cuda import greedy_nms_rank
from dan_tpu_torch.ops.postprocess import filter_and_topk
from dan_tpu_torch.ops.preprocess import bilinear_resample_batch, normalize_image
from dan_tpu_torch.parallel.mesh import Mesh, gather_objects


@dataclasses.dataclass(frozen=True)
class Variant:
    """One TTA forward pass: resize factor + optional mirror + size gate."""

    scale: float
    flip: bool
    # Post-hoc size gating in ORIGINAL pixels [K — S3FD multi-scale rule]:
    max_size: float = np.inf  # st > 1: keep only small boxes
    min_size: float = 0.0  # st < 1: keep only large boxes


def plan_variants(h: int, w: int, config: DANConfig) -> List[Variant]:
    """The S3FD TTA schedule for an (h, w) image.

    Gating is keyed on the ABSOLUTE capped scale s = min(st*shrink, cap):
    s > 1 (the pass enlarges the original image) keeps only small boxes,
    s < 1 keeps only large ones.  This matches the S3FD released eval
    code's `if bt > 1` test on the absolute factor, NOT the nominal st —
    for a large image (shrink < 1) a nominal st = 1.25 whose absolute
    factor stays below 1 is a shrinking pass and keeps large boxes.

    Every variant's scaled extent is capped to the largest resolution
    bucket.  With the 2048 bucket the cap does not bind for WIDER
    (1024px-wide) images: the largest pass is 2.0 * 1024 = 2048 exactly.
    """
    tta = config.tta
    cap = max(tta.buckets) / float(max(h, w))
    shrink = min(1.0, math.sqrt(tta.max_pixels / float(h * w)), cap)
    variants = [Variant(scale=shrink, flip=False)]
    if tta.enable_flip:
        variants.append(Variant(scale=shrink, flip=True))
    scales = list(tta.scales)
    if shrink >= 0.99 and tta.extra_scale_small_images:
        scales.append(tta.extra_scale_small_images)
    for st in scales:
        s = min(st * shrink, cap)
        # Strictly greater, per the `bt > 1` rule: an absolute factor of
        # exactly 1.0 did not enlarge the image, so it keeps LARGE boxes.
        if s > 1.0:
            gate = Variant(scale=s, flip=False, max_size=tta.small_box_max_size)
        else:
            gate = Variant(scale=s, flip=False, min_size=tta.large_box_min_size)
        variants.append(gate)
    # The bucket cap can collapse several st values onto the same absolute
    # scale (elongated images): identical (scale, flip, gate) variants are
    # redundant full forward passes — keep the first of each.
    seen = set()
    unique = []
    for v in variants:
        if v not in seen:
            seen.add(v)
            unique.append(v)
    return unique


def variant_gate(boxes: np.ndarray, v: Variant, measure: str = "sqrt_area") -> np.ndarray:
    """Size gate for one variant's detections, in original-image pixels.

    'sqrt_area': keep sqrt(w*h) in [v.min_size, v.max_size] (inclusive).
    'side': the S3FD released-code rule — enlarged passes keep boxes with
    min-side + 1 < max_size (strict), shrunk passes keep max-side + 1 >
    min_size; the +1 is the legacy inclusive-pixel convention.
    """
    bw = boxes[..., 2] - boxes[..., 0]
    bh = boxes[..., 3] - boxes[..., 1]
    if measure == "side":
        small_ok = (np.minimum(bw, bh) + 1.0) < v.max_size
        large_ok = (np.maximum(bw, bh) + 1.0) > v.min_size
        return small_ok & large_ok
    size = np.sqrt(np.maximum(bh * bw, 0.0))
    return (size <= v.max_size) & (size >= v.min_size)


def pick_bucket(extent: float, buckets: Sequence[int]) -> int:
    """Smallest bucket holding `extent` (the scaled network input)."""
    for b in sorted(buckets):
        if extent <= b:
            return b
    return max(buckets)


def canvas_bucket(extent: float, buckets: Sequence[int]) -> int:
    """Canvas size for the SOURCE image: must actually fit it, so oversized
    images round up to a /128 multiple beyond the largest bucket."""
    for b in sorted(buckets):
        if extent <= b:
            return b
    return -(-int(extent) // 128) * 128


def max_variants(config: DANConfig) -> int:
    """Static upper bound on len(plan_variants(h, w)) over ALL image sizes:
    det0 + optional flip + one pass per nominal scale + the optional extra
    small-image scale.  Depends only on config, so the vote stage has one
    shape across datasets."""
    tta = config.tta
    n = 1 + (1 if tta.enable_flip else 0) + len(tta.scales)
    if tta.extra_scale_small_images:
        n += 1
    return n


def plan_variant_buckets(h: int, w: int, config: DANConfig):
    """ONE definition of the grouping rule: for an (h, w) image, yield
    (variant, scale_bucket, canvas_bucket) per TTA variant.  detect_tta,
    run_dataset and warmup all group work by these pairs."""
    canvas = canvas_bucket(max(h, w), config.tta.buckets)
    for v in plan_variants(h, w, config):
        yield v, pick_bucket(max(h, w) * v.scale, config.tta.buckets), canvas


def vote_order(plan) -> List[int]:
    """For a plan (the list plan_variant_buckets yields), the position of
    each variant's detections in the image's vote rows: groups of one
    (bucket, canvas) pair in order of first appearance, variants in plan
    order inside a group.  Ties between equal scores go to the lower row, so
    detect_tta and run_dataset pack an image's variants in this one order,
    whatever order the dataset's launches were flushed in."""
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, (_, bucket, canvas) in enumerate(plan):
        groups.setdefault((bucket, canvas), []).append(i)
    slot = [0] * len(plan)
    for pos, i in enumerate(i for members in groups.values() for i in members):
        slot[i] = pos
    return slot


def _as_uint8(image) -> np.ndarray:
    image = np.asarray(image)
    if image.dtype != np.uint8:
        image = np.clip(image, 0, 255).astype(np.uint8)
    return image


class VoteRows(NamedTuple):
    """The inputs of one vote launch on the host: three arrays that are
    views of one byte buffer (pinned on a CUDA device), so that one copy
    takes them to the device.  Unpacks as (boxes, scores, valid, buffer)."""

    boxes: np.ndarray  # (B, R, 4) float32
    scores: np.ndarray  # (B, R) float32
    valid: np.ndarray  # (B, R) bool
    buffer: torch.Tensor  # (B * R * 21,) uint8: the bytes of all three


def _vote_views(buffer: torch.Tensor, b: int, r: int):
    """(boxes (b, r, 4) f32, scores (b, r) f32, valid (b, r) bool) as views of
    a (b * r * 21,) uint8 tensor, in that order."""
    nb, ns = b * r * 16, b * r * 4
    return (buffer[:nb].view(torch.float32).view(b, r, 4),
            buffer[nb:nb + ns].view(torch.float32).view(b, r),
            buffer[nb + ns:].view(torch.bool).view(b, r))


class _Fetch:
    """A device result on its way to the host: on a CUDA device a copy into
    pinned host memory queued on the current stream plus an event, so the
    host keeps enqueueing; `numpy()` waits for that copy alone."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t
            self._event = None

    def numpy(self) -> np.ndarray:
        if self._event is None:
            return self._host.numpy()
        self._event.synchronize()
        return self._host.numpy().copy()  # lets the pinned block go


class TTARunner:
    """Per-bucket TTA executor over one model on one device."""

    DEFAULT_VOTE_BATCH = 128  # images per batched vote launch
    DEFAULT_TTA_BATCH = 16  # (image, variant) units per launch
    DEFAULT_MAX_PENDING = 32  # launches queued before the oldest is fetched
    # Cap on bucket² x units for one bucket launch: activations and anchors
    # grow linearly with it, so large buckets take smaller launches.
    # 32M px = 2048² x 8 = 640² x 80.  The rule is the JAX package's, so
    # both launch the same chunks.
    DEFAULT_PIXEL_BUDGET = 32 << 20

    def __init__(
        self,
        model: torch.nn.Module,
        config: Optional[DANConfig] = None,
        pixel_budget: Optional[int] = None,
        device=None,
    ):
        """model: a DANDetector, moved to `device` (default: the first CUDA
        card; raises without one unless device="cpu").  pixel_budget:
        activation-pixel cap for one bucket launch (default
        DEFAULT_PIXEL_BUDGET)."""
        self.config = config or DANConfig()
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.pixel_budget = pixel_budget
        self._anchors: Dict[int, torch.Tensor] = {}
        # Filled by run_dataset: {'images', 'variants', 'bucket_launches',
        # 'vote_launches'}; the launches are this rank's.
        self.last_run_stats: Dict[str, int] = {}

    # -- stages ----------------------------------------------------------------

    def _bucket_anchors(self, bucket: int) -> torch.Tensor:
        a = self._anchors.get(bucket)
        if a is None:
            a = self._anchors[bucket] = generate_anchors(
                self.config.anchors, bucket, bucket, self.device
            )
        return a

    @torch.inference_mode()
    def _run_bucket(self, bucket: int, canvas_u8, src_h, src_w, scale, flip):
        """One bucket launch.  canvas_u8 (n, C, C, 3) uint8 on the device;
        src_h, src_w, scale (n,) float32 and flip (n,) bool numpy arrays.
        Returns (boxes (n, MAX_DET, 4) in original-image pixels, scores
        (n, MAX_DET), valid (n, MAX_DET)) on the device.

        Per unit: optional mirror of the canvas, bilinear resample of the
        image region into the bucket x bucket input, normalise, forward,
        softmax, decode, filter and top-k; then ONE batched greedy NMS over
        the units, un-mirror, and divide by the scale."""
        cfg = self.config
        dev = self.device
        c = canvas_u8.shape[1]
        any_flip = bool(np.any(flip))
        src_h = torch.from_numpy(np.asarray(src_h, np.float32)).to(dev)
        src_w = torch.from_numpy(np.asarray(src_w, np.float32)).to(dev)
        scale = torch.from_numpy(np.asarray(scale, np.float32)).to(dev)
        flip_t = torch.from_numpy(np.asarray(flip, bool)).to(dev)
        img = canvas_u8.float()
        if any_flip:
            img = torch.where(flip_t[:, None, None, None], img.flip(2), img)
        zero = torch.zeros_like(src_w)
        x_off = torch.where(flip_t, c - src_w, zero)
        out_h = src_h * scale
        out_w = src_w * scale
        resized = bilinear_resample_batch(
            img, bucket, bucket, scale, scale, zero, x_off,
            region=(zero, src_h, x_off, x_off + src_w),
            semantics=cfg.preprocess.resize_semantics,
        )
        del img
        cls_logits, loc_preds = self.model(normalize_image(resized, cfg.preprocess))
        del resized
        scores = torch.softmax(cls_logits, dim=-1)[..., 1]
        boxes = decode_boxes(
            loc_preds, self._bucket_anchors(bucket), cfg.anchors.prior_scaling,
            out_h[:, None], out_w[:, None],
        )
        boxes_k, scores_k = filter_and_topk(boxes, scores, cfg.postprocess)
        post = cfg.postprocess
        rank = greedy_nms_rank(
            boxes_k.contiguous(), scores_k.contiguous(),
            post.nms_iou_threshold, post.max_detections,
        )
        res = rank_to_result(rank, boxes_k, scores_k, post.max_detections)
        # Un-mirror, then map back to original pixels.
        flip_c = flip_t[:, None]
        ow = out_w[:, None]
        x1 = torch.where(flip_c, ow - res.boxes[..., 2], res.boxes[..., 0])
        x2 = torch.where(flip_c, ow - res.boxes[..., 0], res.boxes[..., 2])
        out_boxes = (
            torch.stack([x1, res.boxes[..., 1], x2, res.boxes[..., 3]], -1)
            / scale[:, None, None]
        )
        return out_boxes, res.scores, res.valid

    @staticmethod
    def _fetch(boxes, scores, valid) -> _Fetch:
        """Queue the host copy of one launch's (n, MAX_DET, ...) outputs,
        packed into one (n, MAX_DET, 6) float32 tensor so that it is one
        copy."""
        return _Fetch(torch.cat([boxes, scores[..., None], valid[..., None].float()], -1))

    @staticmethod
    def _unpack(packed: np.ndarray):
        """The (boxes, scores, valid) arrays of a fetched launch."""
        return packed[..., :4], packed[..., 4], packed[..., 5] > 0.5

    @torch.inference_mode()
    def _run_vote(self, boxes_b, scores_b, valid_b, buffer) -> _Fetch:
        """One batched bbox-vote launch on packed host rows (a VoteRows,
        unpacked); returns the queued fetch of a (B, MAX_DET, 6) tensor
        (boxes, score, valid).  The rows reach the device in one copy of
        their buffer, from pinned memory and not waited for on a CUDA
        device."""
        post = self.config.postprocess
        dev_buffer = buffer.to(self.device, non_blocking=True)
        vote = bbox_vote_batched_cuda(
            *_vote_views(dev_buffer, *scores_b.shape),
            post.vote_iou_threshold,
            post.max_detections,
        )
        return self._fetch(*vote)

    def _vote_buffer(self, b: int, r: int) -> VoteRows:
        """Zero host vote rows for b images of r rows in one byte buffer,
        pinned on a CUDA device."""
        buffer = torch.zeros((b * r * 21,), dtype=torch.uint8,
                             pin_memory=self.device.type == "cuda")
        return VoteRows(*(t.numpy() for t in _vote_views(buffer, b, r)), buffer)

    def _to_device(self, image: np.ndarray, canvas_size: int) -> torch.Tensor:
        """The image in the top-left of a zero (C, C, 3) uint8 canvas on the
        device: one host-to-device copy (from pinned memory, not waited for,
        on a CUDA device)."""
        h, w = image.shape[:2]
        cuda = self.device.type == "cuda"
        canvas = torch.zeros((canvas_size, canvas_size, 3), dtype=torch.uint8, pin_memory=cuda)
        canvas.numpy()[:h, :w] = image
        return canvas.to(self.device, non_blocking=True)

    def warmup(
        self,
        sizes,
        batch_per_device: int = DEFAULT_TTA_BATCH,
        vote_batch: int = DEFAULT_VOTE_BATCH,
        mesh: Optional[Mesh] = None,
    ) -> int:
        """Run one dummy launch for every (scale-bucket, canvas-bucket) pair
        the given (h, w) image sizes will need, at the launch size
        run_dataset will use with the same mesh, and one dummy vote launch.
        On a CUDA device that builds the kernels, lets the convolution
        library choose its algorithms for each shape and fills the
        allocator's pools, so the run that follows pays none of it.

        Returns the number of pairs + 1 (the vote), 0 without sizes."""
        n_dev = self._ranks(mesh)[1]
        pairs = set()
        for h, w in sizes:
            for _, bucket, canvas in plan_variant_buckets(h, w, self.config):
                pairs.add((bucket, canvas))
        if not pairs:
            return 0
        for bucket, canvas_size in sorted(pairs):
            chunk = self.bucket_chunk(bucket, n_dev, batch_per_device) // n_dev
            self._run_bucket(
                bucket,
                torch.zeros((chunk, canvas_size, canvas_size, 3), dtype=torch.uint8,
                            device=self.device),
                np.full((chunk,), float(canvas_size), np.float32),
                np.full((chunk,), float(canvas_size), np.float32),
                np.ones((chunk,), np.float32),
                np.zeros((chunk,), bool),
            )
        self._run_vote(*self._vote_buffer(self._vote_chunk(n_dev, vote_batch) // n_dev,
                                          self.vote_rows())).numpy()
        return len(pairs) + 1

    def _ranks(self, mesh: Optional[Mesh]) -> Tuple[int, int]:
        """(this rank, the number of ranks) of a run on `mesh`."""
        if mesh is None:
            return 0, 1
        if mesh.device != self.device:
            raise ValueError(f"the mesh's device {mesh.device} is not the runner's {self.device}")
        return mesh.rank, mesh.size

    def bucket_chunk(self, bucket: int, n_dev: int, batch_per_device: int) -> int:
        """(image, variant) units per launch for this resolution bucket:
        n_dev * batch_per_device, capped so that bucket² x units per device
        stays under the pixel budget.  ONE rule shared by warmup and
        run_dataset."""
        budget = self.pixel_budget or self.DEFAULT_PIXEL_BUDGET
        cap_per_dev = max(1, budget // (bucket * bucket))
        return n_dev * max(1, min(batch_per_device, cap_per_dev))

    def vote_rows(self) -> int:
        """Fixed per-image row count of the vote stage: max_variants *
        max_detections, static from config."""
        return max_variants(self.config) * self.config.postprocess.max_detections

    def _vote_chunk(self, n_dev: int, vote_batch: int) -> int:
        """Images per vote launch, padded up to a multiple of the device
        count.  ONE rule shared by warmup and run_dataset."""
        return -(-max(vote_batch, 1) // n_dev) * n_dev

    # -- single image ----------------------------------------------------------

    def detect_tta(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        """Full TTA on one (H, W, 3) uint8 RGB image -> detection dict."""
        boxes, scores, valid = self.collect_variant_dets(image)
        packed = self._run_vote(*self._pack_vote_rows([(boxes, scores, valid)])).numpy()
        vb, vs, vv = self._unpack(packed)
        keep = vv[0]
        return {"bboxes": vb[0][keep], "scores": vs[0][keep]}

    def collect_variant_dets(self, image: np.ndarray):
        """All TTA variants' post-NMS post-gate detections for one image,
        concatenated: (N, 4) boxes, (N,) scores, (N,) valid — the pre-vote
        stage of detect_tta, exposed so that tests can pin the vote's
        input independently of the vote."""
        image = _as_uint8(image)
        h, w = image.shape[:2]
        all_boxes, all_scores, all_valid = [], [], []
        groups: Dict[Tuple[int, int], List[Variant]] = {}
        for v, bucket, canvas in plan_variant_buckets(h, w, self.config):
            groups.setdefault((bucket, canvas), []).append(v)
        # One canvas and one host-to-device copy for the whole image:
        # canvas_bucket depends only on (h, w).
        canvas_size = canvas_bucket(max(h, w), self.config.tta.buckets)
        canvas_dev = self._to_device(image, canvas_size)
        for (bucket, _), vs in groups.items():
            n = len(vs)
            out = self._run_bucket(
                bucket,
                canvas_dev[None].expand(n, -1, -1, -1),
                np.full((n,), h, np.float32),
                np.full((n,), w, np.float32),
                np.asarray([v.scale for v in vs], np.float32),
                np.asarray([v.flip for v in vs]),
            )
            boxes, scores, valid = self._unpack(self._fetch(*out).numpy())
            for i, v in enumerate(vs):
                gate = variant_gate(boxes[i], v, self.config.tta.gate_measure)
                all_boxes.append(boxes[i])
                all_scores.append(scores[i])
                all_valid.append(valid[i] & gate)
        return (
            np.concatenate(all_boxes),
            np.concatenate(all_scores),
            np.concatenate(all_valid),
        )

    def _pack_vote_rows(self, images_dets) -> VoteRows:
        """Pack per-image (boxes, scores, valid) host arrays into fixed
        (B, R) vote inputs, in one buffer that _run_vote copies to the
        device at once.  Invalid rows are dropped before upload (they are
        never active in the vote, and the relative order of the valid rows —
        the tie-break key — is kept, so results are unchanged) and the rest
        is zero-padded to R = vote_rows()."""
        rows = self._vote_buffer(len(images_dets), self.vote_rows())
        boxes_b, scores_b, valid_b, _ = rows
        for i, (bx, sc, va) in enumerate(images_dets):
            sel = np.asarray(va, bool)
            nb = np.asarray(bx, np.float32)[sel]
            ns = np.asarray(sc, np.float32)[sel]
            k = len(ns)
            boxes_b[i, :k] = nb
            scores_b[i, :k] = ns
            valid_b[i, :k] = True
        return rows

    # -- dataset scale -----------------------------------------------------------

    def run_dataset(
        self,
        items,
        batch_per_device: int = DEFAULT_TTA_BATCH,
        progress_every: int = 0,
        vote_batch: int = DEFAULT_VOTE_BATCH,
        max_pending: int = DEFAULT_MAX_PENDING,
        mesh: Optional[Mesh] = None,
    ) -> Dict[str, Dict[str, np.ndarray]]:
        """Full-dataset TTA on one device, or shared by the ranks of a mesh.

        Args:
          items: iterable of (key, image_uint8) — e.g. WIDER rel-path stems;
            on a mesh every rank passes the same items.
          batch_per_device: (image, variant) units per bucket launch.
          vote_batch: images per batched vote launch, over all ranks
            (padded up to a multiple of the ranks).
          max_pending: launches (bucket launches, then vote launches) kept
            un-fetched before the oldest is drained: it bounds the host and
            device memory held by queued results while keeping the device's
            queue that deep.  Must be positive.
          mesh: the ranks to share the run with (dan_tpu_torch.parallel);
            None runs every launch on this runner's device.
        Returns {key: {'bboxes': (N, 4), 'scores': (N,)}}: every image's, on
        every rank.

        Units are grouped by (bucket, canvas) so that each group runs at one
        input shape, flushed in chunks of bucket_chunk, ranks x the units of
        one launch; rank r launches the r-th block of each chunk, a short
        block padded by repeating its first unit.  Each image's canvas is
        copied to a rank's device once, when that rank runs one of its
        units, and shared by them.
        """
        if max_pending <= 0:
            raise ValueError(f"max_pending must be positive, got {max_pending}")
        rank, n_dev = self._ranks(mesh)
        cfg = self.config
        # unit: (key, variant, h, w, device-resident canvas, vote slot).
        groups: Dict[Tuple[int, int], list] = {}
        # per_key[key][slot]: a variant's kept detections (boxes, scores,
        # valid), the valid rows only: _pack_vote_rows keeps no others.
        per_key: Dict[str, list] = {}
        pending: collections.deque = collections.deque()  # (part, _Fetch)
        n_images = 0
        n_variants = 0
        n_bucket_launches = 0

        def drain_oldest():
            part, fetch = pending.popleft()
            boxes, scores, valid = self._unpack(fetch.numpy())
            for i, (key, v, slot) in enumerate(part):
                keep = valid[i] & variant_gate(boxes[i], v, cfg.tta.gate_measure)
                per_key[key][slot] = (boxes[i][keep], scores[i][keep], keep[keep])

        def flush(group_key):
            nonlocal n_bucket_launches
            bucket, _ = group_key
            units = groups.pop(group_key, [])
            chunk = self.bucket_chunk(bucket, n_dev, batch_per_device)
            per_rank = chunk // n_dev
            for start in range(rank * per_rank, len(units), chunk):
                part = units[start : start + per_rank]
                pad = per_rank - len(part)
                padded = part + [part[0]] * pad
                out = self._run_bucket(
                    bucket,
                    torch.stack([u[4] for u in padded]),  # device-side stack
                    np.asarray([u[2] for u in padded], np.float32),
                    np.asarray([u[3] for u in padded], np.float32),
                    np.asarray([u[1].scale for u in part] + [1.0] * pad, np.float32),
                    np.asarray([u[1].flip for u in part] + [False] * pad),
                )
                n_bucket_launches += 1
                # Keep only (key, variant, slot) per unit: the unit tuples
                # hold every image's device-resident canvas.
                pending.append(([(u[0], u[1], u[5]) for u in part], self._fetch(*out)))
                while len(pending) > max_pending:
                    drain_oldest()

        for key, image in items:
            image = _as_uint8(image)
            h, w = image.shape[:2]
            plan = list(plan_variant_buckets(h, w, cfg))
            per_key[key] = [None] * len(plan)
            canvas_size = canvas_bucket(max(h, w), cfg.tta.buckets)
            # Which rank runs each unit: the block of its place in its chunk.
            units, added, mine = [], collections.Counter(), False
            for (v, bucket, _), slot in zip(plan, vote_order(plan)):
                gk = (bucket, canvas_size)
                chunk = self.bucket_chunk(bucket, n_dev, batch_per_device)
                place = (len(groups.get(gk, ())) + added[gk]) % chunk
                added[gk] += 1
                mine |= place // (chunk // n_dev) == rank
                units.append((gk, v, slot, chunk))
            # One copy per image, by the ranks that run one of its units.
            canvas_dev = self._to_device(image, canvas_size) if mine else None
            for gk, v, slot, chunk in units:
                n_variants += 1
                groups.setdefault(gk, []).append((key, v, h, w, canvas_dev, slot))
                if len(groups[gk]) >= chunk:
                    flush(gk)
            n_images += 1
            if progress_every and rank == 0 and n_images % progress_every == 0:
                import resource
                import sys

                rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
                print(f"[tta] {n_images} images planned (peak rss {rss} MB)", file=sys.stderr)

        for gk in list(groups):
            flush(gk)
        while pending:
            drain_oldest()
        if n_dev > 1:  # every rank gets every variant's rows
            ours = [(k, slot, d) for k, dets in per_key.items()
                    for slot, d in enumerate(dets) if d is not None]
            for theirs in gather_objects(ours, mesh):
                for k, slot, d in theirs:
                    per_key[k][slot] = d

        # Per-image fusion: batched bbox-vote in fixed (vote_chunk, R)
        # launches, rank r voting the r-th share of each chunk, the last
        # share padded with empty images (all-invalid rows vote to
        # nothing), fetches deferred at most max_pending deep.
        results: Dict[str, Dict[str, np.ndarray]] = {}
        vchunk = self._vote_chunk(n_dev, vote_batch)
        per_rank = vchunk // n_dev
        keys = list(per_key)
        vote_pending: collections.deque = collections.deque()  # (keys, _Fetch)
        n_vote_launches = 0

        def drain_vote():
            ks, fetch = vote_pending.popleft()
            vb, vs, vv = self._unpack(fetch.numpy())
            for i, k in enumerate(ks):
                keep = vv[i]
                results[k] = {"bboxes": vb[i][keep], "scores": vs[i][keep]}

        empty = (np.zeros((0, 4), np.float32), np.zeros(0, np.float32), np.zeros(0, bool))
        for start in range(rank * per_rank, len(keys), vchunk):
            ks = keys[start : start + per_rank]
            packed = [
                tuple(np.concatenate([d[j] for d in per_key[k]]) for j in range(3))
                if per_key[k] else empty
                for k in ks
            ]
            packed += [empty] * (per_rank - len(ks))
            vote_pending.append((ks, self._run_vote(*self._pack_vote_rows(packed))))
            n_vote_launches += 1
            while len(vote_pending) > max_pending:
                drain_vote()
        while vote_pending:
            drain_vote()
        if n_dev > 1:
            for theirs in gather_objects(results, mesh):
                results.update(theirs)
        # One count per bucket / vote launch of this rank: the dispatch
        # counts that tta_batch and vote_batch trade against.
        self.last_run_stats = {
            "images": n_images,
            "variants": n_variants,
            "bucket_launches": n_bucket_launches,
            "vote_launches": n_vote_launches,
        }
        return {k: results[k] for k in keys}
