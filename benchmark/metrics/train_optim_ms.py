"""train_optim_ms: device ms a step spends in the program's span
dan.train.optimizer (train/optim.py::sgd_update: the global norm, the
clip, weight decay, momentum and the update), from the CUDA events the
span records."""
from benchmark.spans_common import device_ms_per_unit


def read(view):
    return device_ms_per_unit(view, "dan.train.optimizer")
