"""conv_i8_roofline.detect: the int8 body's convolutions (csrc/conv_i8.cu)
as a share of their roofline in %: the 18 layers' least time at the mix's
batch (counts/model_ops.py::conv_i8_least_s) for each call of the profiled
stretch, over the kernel's device time there."""

from benchmark.counts.model_ops import conv_i8_least_s

KERNEL = "conv_i8_kernel"


def read(view):
    t, calls = view.kernel_s(KERNEL), view.units.get("calls")
    if not t or not calls or view.config["precision"] != "int8":
        return None
    return 100.0 * calls * conv_i8_least_s(view.config["dan"], view.params["batch"]) / t
