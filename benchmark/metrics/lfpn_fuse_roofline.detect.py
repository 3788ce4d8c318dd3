"""lfpn_fuse_roofline.detect: the LFPN's upsample x lateral pass
(csrc/lfpn_fuse.cu) as a share of its roofline in %: the top-down maps
read once, the lateral maps read once and the fused maps written once, in
the compute dtype at 3.35 TB/s, for each call of the profiled stretch, over
the kernel's device time there.

The maps are the outputs of the LFPN's 1x1 convolutions
(counts/model_ops.py::conv_layers at the mix's batch): each `lfpn_td_*`
output (the map before its 2x upsample) once, each `lfpn_lat_*` output
twice, since the fused map has its shape.  An int8 forward fuses the same
bf16 maps.  A tree without the kernel has none of its launches: the reader
then returns None."""

from benchmark.counts.model_ops import conv_layers
from benchmark.counts.peaks import BYTES_PER_S

KERNEL = "lfpn_fuse_kernel"
_BYTES = {"bfloat16": 2, "float32": 4}


def fuse_values(dan) -> int:
    """Values the pass reads and writes in one image's forward."""
    n = 0
    for name, _, _, ho, _, co, _ in conv_layers(dan, dan["model"]["image_size"]):
        if name.startswith("lfpn_td_"):
            n += ho * ho * co
        elif name.startswith("lfpn_lat_"):
            n += 2 * ho * ho * co
    return n


def read(view):
    t, calls = view.kernel_s(KERNEL), view.units.get("calls")
    if not t or not calls:
        return None
    dan = view.config["dan"]
    n_bytes = fuse_values(dan) * view.params["batch"] * _BYTES[dan["model"]["compute_dtype"]]
    return 100.0 * calls * n_bytes / BYTES_PER_S / t
