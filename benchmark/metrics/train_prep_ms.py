"""train_prep_ms: ms of device time a step spends in
train/loop.py::preprocess_and_match (the H2D copy, ops/preprocess.py, the
matcher of ops/matching_cuda.py), from CUDA events around each call of the
profiled stretch."""

SPANS = {"preprocess_and_match": "dan_tpu_torch.train.loop:preprocess_and_match"}


def read(view):
    return view.span_mean_ms("preprocess_and_match")
