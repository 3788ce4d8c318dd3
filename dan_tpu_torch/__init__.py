"""dan_tpu_torch: the DAN face detector in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

It mirrors the module layout of the JAX package `dan_tpu`, which stays the
reference, and shares its configuration dataclasses (`dan_tpu.config`) and
its numpy data code (`dan_tpu.data`), neither of which imports JAX.  Nothing
here imports JAX.

    from dan_tpu_torch.api import Detector
    det = Detector.from_random(seed=0, device="cuda")
    out = det.detect(image_rgb_uint8)   # {'bboxes': (N, 4), 'scores': (N,)}

    from dan_tpu_torch.train import create_train_state, train_step
    state = create_train_state(config, seed=0, device="cuda")
    metrics = train_step(state, host_batch)   # python -m dan_tpu_torch.train
"""

__version__ = "0.1.0"
