"""bias_act_roofline.detect: the in-place bias + ReLU pass after the
inference convolutions (csrc/bias_act.cu) as a share of its roofline in %:
the values it touches, each read once and written once in the compute
dtype at 3.35 TB/s (the bias vectors, a few KB, left out), for each call of
the profiled stretch, over the kernel's device time there.

The values are the outputs of the convolutions that run in the compute
dtype (counts/model_ops.py::conv_layers at the mix's batch): all of them in
a bfloat16 forward, with pool1 (64 x (S/2)^2) in place of conv1_2's output
where the conv1 block runs packed, since the pass follows the phase max
there; in an int8 forward only conv1_1, the LFPN and the heads (and conv1_2
on the unpacked path).  A tree without the pass has no such kernel: the
reader then returns None."""

from benchmark.counts.model_ops import conv_layers
from benchmark.counts.peaks import BYTES_PER_S

KERNEL = "bias_act_kernel"
_BYTES = {"bfloat16": 2, "float32": 4}


def pass_values(dan, int8_body: bool) -> int:
    """Values the pass touches in one image's forward."""
    m = dan["model"]
    size = m["image_size"]
    packed = m["conv1_packed"] and size % 2 == 0
    n = 0
    for name, part, _, ho, _, co, _ in conv_layers(dan, size):
        if int8_body and part == "body" and (name != "conv1_2" or packed):
            continue
        if name == "conv1_2" and packed:
            ho = -(-ho // 2)
        n += ho * ho * co
    return n


def read(view):
    t, calls = view.kernel_s(KERNEL), view.units.get("calls")
    if not t or not calls:
        return None
    dan = view.config["dan"]
    values = pass_values(dan, view.config["precision"] == "int8") * view.params["batch"]
    n_bytes = 2 * values * _BYTES[dan["model"]["compute_dtype"]]
    return 100.0 * calls * n_bytes / BYTES_PER_S / t
