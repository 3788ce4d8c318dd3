"""dan_tpu_torch: the DAN face detector in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

It mirrors the module layout of the JAX package `dan_tpu`, which stays the
reference, and imports nothing of it and nothing of JAX: the configuration
dataclasses (`dan_tpu_torch.config`), the numpy data code
(`dan_tpu_torch.data`) and the numpy evaluation code are its own copies.
Entry points run on the first CUDA card unless the caller passes a device
(`device="cpu"`, `--device cpu`), and raise when there is no card.

    from dan_tpu_torch.api import Detector
    det = Detector.from_random(seed=0)
    out = det.detect(image_rgb_uint8)   # {'bboxes': (N, 4), 'scores': (N,)}
    out = det.detect_tta(image_rgb_uint8)      # pyramid + flip + bbox-vote
    # python -m dan_tpu_torch.eval --wider_root ... --output_dir ...

    from dan_tpu_torch.train import create_train_state, train_step
    state = create_train_state(config, seed=0)
    metrics = train_step(state, host_batch)   # python -m dan_tpu_torch.train
"""

__version__ = "0.1.0"
