"""res_act_roofline.detect_retinaface: the residual pass that closes each
bottleneck (csrc/bias_act.cu's `residual_relu_kernel`: relu(y + b + r) in
place) as a share of its roofline in %: three accesses (y read, the
identity read, y written) of each value of the 16 bottleneck outputs
(counts/retinaface_ops.py::residual_values at the mix's batch) in the
compute dtype at 3.35 TB/s (the bias vectors, a few KB, left out), for
each call of the profiled stretch, over the kernel's device time there.
A tree without the pass has no such kernel: the reader then returns None."""

from benchmark.counts.peaks import BYTES_PER_S
from benchmark.counts.retinaface_ops import residual_values

KERNEL = "residual_relu_kernel"
_BYTES = {"bfloat16": 2, "float32": 4}


def read(view):
    t, calls = view.kernel_s(KERNEL), view.units.get("calls")
    if not t or not calls:
        return None
    m = view.config["dan"]["model"]
    values = residual_values(view.config["dan"], m["image_size"]) * view.params["batch"]
    return 100.0 * calls * 3 * values * _BYTES[m["compute_dtype"]] / BYTES_PER_S / t
