from dan_tpu_torch.eval.tta import (
    TTARunner,
    Variant,
    canvas_bucket,
    max_variants,
    pick_bucket,
    plan_variant_buckets,
    plan_variants,
)
from dan_tpu_torch.eval.widerface_ap import (
    approx_difficulty_keep,
    evaluate_widerface,
    load_official_gt,
)
from dan_tpu_torch.eval.writer import (
    load_detection_dir,
    read_wider_detections,
    write_wider_detections,
)

__all__ = [
    "TTARunner",
    "Variant",
    "approx_difficulty_keep",
    "canvas_bucket",
    "evaluate_widerface",
    "load_detection_dir",
    "load_official_gt",
    "max_variants",
    "pick_bucket",
    "plan_variant_buckets",
    "plan_variants",
    "read_wider_detections",
    "write_wider_detections",
]
