"""k6_roofline.train: K6's (csrc/conv12_wgrad.cu: its partial sums and
their reduction) share of its roofline in %: the least time of one call at
the mix's batch (counts/model_ops.py::conv12_wgrad_least_s) times the steps
of the profiled stretch, over the two kernels' device time there."""

from benchmark.counts.model_ops import conv12_wgrad_least_s

KERNELS = ("::wgrad_kernel", "namespace)::reduce_kernel")


def read(view):
    t, steps = view.kernel_s(*KERNELS), view.units.get("steps")
    if not t or not steps:
        return None
    return 100.0 * steps * conv12_wgrad_least_s(view.config["dan"], view.params["batch"]) / t
