"""l2norm_roofline.detect: the one-pass L2Norm of the shallow taps
(csrc/l2norm.cu) as a share of its roofline in %: the taps' values, each
read once and written once in the compute dtype at 3.35 TB/s (the scale
vectors, a few KB, left out), for each call of the profiled stretch, over
the kernel's device time there.

The taps are the configuration's `l2norm_taps`, each of the width and size
at which the heads read it (counts/model_ops.py::conv_layers), at the mix's
batch; an int8 forward normalises the same bf16 taps.  A tree without the
kernel has none of its launches: the reader then returns None."""

from benchmark.counts.model_ops import conv_layers
from benchmark.counts.peaks import BYTES_PER_S

KERNEL = "l2norm_kernel"
_BYTES = {"bfloat16": 2, "float32": 4}


def tap_values(dan) -> int:
    """Values of the normalised taps in one image's forward."""
    m = dan["model"]
    taps = {f"head_{name}" for name in m["l2norm_taps"]}
    return sum(ho * ho * ci for name, _, _, ho, ci, _, _ in conv_layers(dan, m["image_size"])
               if name in taps)


def read(view):
    t, calls = view.kernel_s(KERNEL), view.units.get("calls")
    if not t or not calls:
        return None
    dan = view.config["dan"]
    n_bytes = 2 * tap_values(dan) * view.params["batch"] * _BYTES[dan["model"]["compute_dtype"]]
    return 100.0 * calls * n_bytes / BYTES_PER_S / t
