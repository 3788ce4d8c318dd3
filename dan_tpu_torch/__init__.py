"""dan_tpu_torch: the DAN face detector in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

It mirrors the module layout of the JAX package `dan_tpu`, which stays the
reference, and shares its configuration dataclasses (`dan_tpu.config`, which
imports no JAX).  Nothing here imports JAX.

    from dan_tpu_torch.api import Detector
    det = Detector.from_random(seed=0, device="cuda")
    out = det.detect(image_rgb_uint8)   # {'bboxes': (N, 4), 'scores': (N,)}
"""

__version__ = "0.1.0"
