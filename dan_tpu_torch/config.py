"""Frozen configuration tree of the PyTorch port: the port's own copy of
dan_tpu/config.py, with the same dataclass names, fields and defaults, so
that one set of settings describes both packages (`from_reference` turns the
JAX package's config into this one).  Fields that switch a Pallas kernel on
or off are kept for that round trip; the port does not read them.

Every parity-sensitive constant of the reference (HiKapok/DAN, a TF1
S3FD/PyramidBox-lineage face detector — see SURVEY.md §0/§2) lives here as
data, so that when the reference becomes inspectable, flipping a constant is a
one-line change rather than a refactor.

Provenance tags (see SURVEY.md §0):
  [B] the BASELINE.json capability contract (ground truth)
  [K] domain knowledge from the S3FD / PyramidBox / SSD papers
  [?] estimate — verify against the reference when available
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class AnchorLayerConfig:
    """Per-layer anchor configuration. [B]: '6 detection scales'.

    S3FD 'equal-proportion interval' rule [K]: one square anchor per position,
    size = 4 * stride, centers at (i + 0.5) * stride.
    """

    stride: int
    anchor_size: float
    # Anchor-center offset in units of stride.  S3FD centers anchors at
    # (i + offset) * stride with offset = 0.5 [K].
    offset: float = 0.5


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """All six detection scales [B] with S3FD strides/sizes [K]."""

    layers: Tuple[AnchorLayerConfig, ...] = (
        AnchorLayerConfig(stride=4, anchor_size=16.0),
        AnchorLayerConfig(stride=8, anchor_size=32.0),
        AnchorLayerConfig(stride=16, anchor_size=64.0),
        AnchorLayerConfig(stride=32, anchor_size=128.0),
        AnchorLayerConfig(stride=64, anchor_size=256.0),
        AnchorLayerConfig(stride=128, anchor_size=512.0),
    )
    # SSD prior-box variances / 'prior scaling' [K — SSD & author's template
    # use (0.1, 0.1, 0.2, 0.2)].
    prior_scaling: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)

    @property
    def strides(self) -> Tuple[int, ...]:
        return tuple(l.stride for l in self.layers)

    @property
    def sizes(self) -> Tuple[float, ...]:
        return tuple(l.anchor_size for l in self.layers)

    def feature_shapes(self, image_size: int) -> Tuple[Tuple[int, int], ...]:
        """Feature map (h, w) per detection layer for a square input.

        'SAME' conv/pool semantics -> ceil division by stride.
        """
        return tuple(
            (-(-image_size // l.stride), -(-image_size // l.stride))
            for l in self.layers
        )

    def num_anchors(self, image_size: int) -> int:
        return sum(h * w for (h, w) in self.feature_shapes(image_size))


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Anchor->gt assignment [B: 'jaccard-overlap matching/encoding']."""

    # S3FD matching threshold [K — S3FD uses 0.35; plain SSD uses 0.5].
    match_threshold: float = 0.35
    # Anchors with best-IoU in [ignore_threshold, match_threshold) are
    # ignored (excluded from the negative pool) [K — common in the family;
    # set equal to match_threshold to disable].
    ignore_threshold: float = 0.35
    # S3FD scale-compensation stage 2 [K]: a gt matched by fewer than
    # `scale_comp_topk` anchors additionally takes its top-k anchors with
    # IoU > scale_comp_iou.
    scale_comp_topk: int = 6
    scale_comp_iou: float = 0.1
    enable_scale_comp: bool = True
    # Fixed-shape padding for ground-truth boxes per image (WIDER-hard crops).
    max_gt: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """VGG-16 + L2Norm taps + LFPN + 6 multibox heads [B]."""

    num_classes: int = 2  # background, face
    image_size: int = 640
    # L2-normalization layers on shallow taps with learned scales
    # [K — S3FD: conv3_3 init 10, conv4_3 init 8, conv5_3 init 5].
    l2norm_taps: Tuple[str, ...] = ("conv3_3", "conv4_3", "conv5_3")
    l2norm_init: Tuple[float, ...] = (10.0, 8.0, 5.0)
    # LFPN fusion [B]: top-down from a middle layer (PyramidBox starts the
    # top-down path at conv_fc7, fusing into conv5_3, conv4_3, conv3_3) [K].
    # Fusion op: element-wise product after 1x1 conv [K — PyramidBox; set to
    # 'sum' for FPN-style addition].
    lfpn_fuse_op: str = "product"
    lfpn_channels: Tuple[int, ...] = (256, 512, 512)  # conv3_3, conv4_3, conv5_3 taps [?]
    # Max-in-out background prediction on the lowest level
    # [K — PyramidBox: cpn=1 face + cbn=3 bg channels on stride-4 level].
    maxout_bg_size: int = 3
    # fc6 dilated conv params [K — SSD: 3x3 rate-6 1024ch; fc7 1x1 1024ch].
    fc6_channels: int = 1024
    fc6_dilation: int = 6
    fc7_channels: int = 1024
    # Extra SSD feature layers for strides 64/128 [K]:
    # conv6: 1x1 256 -> 3x3/2 512 ; conv7: 1x1 128 -> 3x3/2 256.
    extra_channels: Tuple[Tuple[int, int], ...] = ((256, 512), (128, 256))
    # bf16 matmul/conv compute with f32 params.
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # Phase-packed (space-to-depth) conv1 block: mathematically identical
    # to the standard one (parity-tested) -- see models/vgg.py.  Falls back
    # to the standard path for odd H/W.
    conv1_packed: bool = True
    # Switches of the JAX package's Pallas kernels for the phase-pool
    # backward and the conv1_2' weight grad.  Kept so that a reference
    # config round-trips; the port's train step always runs its CUDA
    # kernels on a CUDA tensor (ops/phase_pool_cuda.py,
    # ops/conv12_wgrad_cuda.py).
    phase_pool_pallas_bwd: bool = True
    conv12_wgrad_pallas: bool = True


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """tf.image chain equivalents [B]: resize, data-anchor-sampling crops,
    color distortion, normalization."""

    # VGG mean subtraction [K — verify channel order against ckpt]:
    # reference family uses BGR means (104, 117, 123) OR RGB
    # (123.68, 116.779, 103.939).  We operate in RGB.
    mean_rgb: Tuple[float, float, float] = (123.68, 116.779, 103.939)
    # No std scaling in the family [K].
    std_rgb: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    train_image_size: int = 640
    # Fixed host->device canvas: images are padded (never resampled) into a
    # (canvas_size, canvas_size, 3) uint8 buffer on host; ALL resampling
    # happens on device (north-star: input pipeline math never on host).
    canvas_size: int = 1216
    # Data-anchor-sampling [B][K — PyramidBox]: resize a random face towards a
    # random smaller/equal anchor scale, then crop a train_image_size window.
    das_anchor_sizes: Tuple[float, ...] = (16.0, 32.0, 64.0, 128.0, 256.0, 512.0)
    das_max_scale_jitter: Tuple[float, float] = (0.75, 1.25)
    # Color distortion strengths [K — tf.image defaults in the template].
    brightness_max_delta: float = 32.0 / 255.0
    contrast_range: Tuple[float, float] = (0.5, 1.5)
    saturation_range: Tuple[float, float] = (0.5, 1.5)
    hue_max_delta: float = 0.2
    color_distort_prob: float = 0.5
    # Op-order policy for color distortion.  'fixed' (default): one
    # brightness->saturation->hue->contrast pass (branchless, one HSV
    # roundtrip).  'reference': the tf.slim `distort_color` behavior of
    # sampling one of 4 op orderings per image [K — inception/
    # ssd_preprocessing template; verify DAN uses num_cases=4 when the
    # mount appears] — parity runs only.
    color_distort_order: str = "fixed"
    # Bilinear sampling rule for EVERY resample (train crop, eval squash,
    # TTA pyramid).  'half_pixel': src = (dst+0.5)/scale-0.5 (TF2 /
    # half_pixel_centers=True — the current default and what all measured
    # numbers/goldens use).  'tf1_legacy': src = dst/scale (TF1
    # resize_images default, align_corners=False) — if the reference used
    # stock TF1 resize, bit-parity with its trained ckpt needs this
    # switch.  [?] verify which the reference passes when the mount
    # appears; this is a one-line config flip either way.
    resize_semantics: str = "half_pixel"
    flip_prob: float = 0.5
    # Drop gt boxes whose center falls outside the crop / degenerate boxes.
    min_box_size: float = 1.0  # pixels at the sampled scale [?]


@dataclasses.dataclass(frozen=True)
class PostprocessConfig:
    """Score filter + NMS -> detection dict [B]."""

    score_threshold: float = 0.05  # [K ~0.01-0.05; verify]
    # [K] reference constant; it sets the NMS input width.
    pre_nms_topk: int = 5000
    nms_iou_threshold: float = 0.3  # [K ~0.3-0.45; verify]
    max_detections: int = 750
    # bbox-vote fusion [B] IoU threshold [K ~0.3; verify vs 0.4].
    vote_iou_threshold: float = 0.3
    # The JAX package's switch for its Pallas NMS and vote kernels.  Kept
    # for the round trip; the port picks kernel or plain version by the
    # tensor's device alone.
    use_pallas_nms: bool = True


@dataclasses.dataclass(frozen=True)
class TTAConfig:
    """S3FD TTA protocol [B: image-pyramid + horizontal-flip]."""

    # Base shrink: min(1, sqrt(max_pixels / (h*w))) [K].
    # The family's released eval scripts derive the budget from a GPU/caffe
    # blob-size limit (S3FD: 0x7fffffff/577 ≈ 3.7MP; other forks use
    # 0.2-1MP); 0.42MP is tuned so the median WIDER val image (~0.75MP,
    # 1024px wide) shrinks to a det0 extent of ~760px (the 896 bucket) —
    # one bucket smaller and small-face recall drops, one larger and every
    # det0 pass pays 1280² compute.  [?] verify against the reference's
    # max_im_shrink formula when the mount appears.
    max_pixels: float = 0.42e6
    # Multi-scale test factors [K — verify list].
    scales: Tuple[float, ...] = (0.5, 0.75, 1.25, 1.5, 1.75)
    extra_scale_small_images: float = 2.0
    # Enlarging passes keep only small boxes; shrinking passes only large
    # ones [K].  Thresholds are in original-image pixels.
    small_box_max_size: float = 100.0
    large_box_min_size: float = 30.0
    # Gate measure [?]: 'sqrt_area' gates on sqrt(w*h) with inclusive
    # bounds; 'side' is the S3FD released-code rule (enlarged passes keep
    # min-side+1 < 100, shrunk passes keep max-side+1 > 30, strict).
    gate_measure: str = "sqrt_area"
    enable_flip: bool = True
    # Fixed resolution buckets (square, padded): one input shape per bucket.
    # WIDER images are 1024px wide: det0 after the 0.42MP shrink lands in
    # 896/1280; the largest scaled extent is the 2.0 extra pass on small
    # (h <= 410) images = 2048 — the 2048 bucket exists so that pass is not
    # silently capped (it was capped to 1792 in round 1).
    buckets: Tuple[int, ...] = (256, 384, 512, 640, 896, 1280, 1792, 2048)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Loss, HNM, optimizer, schedule [B][K]."""

    batch_size: int = 32  # global
    # Hard-negative mining ratio [K — 3 negatives per positive; verify].
    hnm_ratio: float = 3.0
    # Minimum negatives kept when an image has no positives [?].
    hnm_min_negatives: int = 64
    loc_loss_weight: float = 1.0  # alpha [K ~1]
    # SGD momentum + piecewise LR [K — author's standard recipe].
    learning_rate: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    lr_boundaries: Tuple[int, ...] = (80000, 100000, 120000)
    lr_factors: Tuple[float, ...] = (1.0, 0.1, 0.01, 0.001)
    warmup_steps: int = 0
    # Global-norm gradient clipping; 0 = off (reference-faithful — the
    # reference warm-starts from ImageNet VGG and never needs it; from-
    # scratch random-init runs at full 640 do [?]: measured, raw defaults
    # diverge to nan within ~3 steps at lr 1e-3 (He-init logits reach
    # |x|~300 on mean-subtracted pixels), while warmup_steps=50 +
    # grad_clip_norm=10 trains cleanly (the --synthetic defaults of
    # `python -m dan_tpu_torch.train`).
    grad_clip_norm: float = 0.0
    total_steps: int = 120000
    checkpoint_every: int = 2000
    log_every: int = 50
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Parallelism layout: data parallel [B]; other axes reserved."""

    data_axis: str = "data"
    # Reserved (unused: model is ~25M params — see SURVEY.md §2).
    model_axis: str = "model"
    data_parallel_size: int = -1  # -1 -> all devices


@dataclasses.dataclass(frozen=True)
class DANConfig:
    model: ModelConfig = ModelConfig()
    anchors: AnchorConfig = AnchorConfig()
    match: MatchConfig = MatchConfig()
    preprocess: PreprocessConfig = PreprocessConfig()
    postprocess: PostprocessConfig = PostprocessConfig()
    tta: TTAConfig = TTAConfig()
    train: TrainConfig = TrainConfig()
    mesh: MeshConfig = MeshConfig()


def default_config() -> DANConfig:
    return DANConfig()


_NESTED = {
    "model": ModelConfig,
    "anchors": AnchorConfig,
    "match": MatchConfig,
    "preprocess": PreprocessConfig,
    "postprocess": PostprocessConfig,
    "tta": TTAConfig,
    "train": TrainConfig,
    "mesh": MeshConfig,
}


def _tuplify(v):
    return tuple(_tuplify(x) for x in v) if isinstance(v, (list, tuple)) else v


def from_reference(cfg) -> DANConfig:
    """This package's DANConfig with the settings of `cfg`, any dataclass
    tree with the same field names (the JAX package's DANConfig).  Duck
    typed through dataclasses.asdict; a field this copy does not know
    raises TypeError."""
    tree = dataclasses.asdict(cfg)
    parts = {}
    for name, cls in _NESTED.items():
        sub = {k: _tuplify(v) for k, v in tree.pop(name).items()}
        if cls is AnchorConfig:
            sub["layers"] = tuple(
                AnchorLayerConfig(**layer)
                for layer in dataclasses.asdict(cfg.anchors)["layers"]
            )
        parts[name] = cls(**sub)
    if tree:
        raise TypeError(f"unknown config sections {sorted(tree)}")
    return DANConfig(**parts)
