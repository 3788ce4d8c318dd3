from dan_tpu_torch.data.augment import sample_data_anchor_crop
from dan_tpu_torch.data.pipeline import TrainPipeline, iter_prefetch
from dan_tpu_torch.data.synthetic import synthetic_batch, synthetic_sample
from dan_tpu_torch.data.widerface import (
    ImageRecord,
    load_image_rgb,
    load_split,
    parse_bbx_gt,
)

__all__ = [
    "ImageRecord",
    "TrainPipeline",
    "iter_prefetch",
    "load_image_rgb",
    "load_split",
    "parse_bbx_gt",
    "sample_data_anchor_crop",
    "synthetic_batch",
    "synthetic_sample",
]
