"""The reader of lfpn_fuse_roofline.detect against a hand count of the
LFPN's maps at 640x640, and its silence on a trace without the kernel."""
import math

import pytest

from benchmark import harness
from benchmark.counts.peaks import BYTES_PER_S

METRIC = "lfpn_fuse_roofline.detect"
# One image at 640x640: the top-down maps before their upsample (20^2 x 512,
# 40^2 x 512, 80^2 x 256) read once, the lateral maps (40^2 x 512,
# 80^2 x 512, 160^2 x 256) read once and written once as the fused maps.
VALUES_640 = (20 ** 2 * 512 + 40 ** 2 * 512 + 80 ** 2 * 256
              + 2 * (40 ** 2 * 512 + 80 ** 2 * 512 + 160 ** 2 * 256))


class _View:
    def __init__(self, t, calls, config, params, kernels=("lfpn_fuse_kernel",)):
        self.t, self.units, self.config, self.params = t, {"calls": calls}, config, params
        self.kernels = kernels

    def kernel_s(self, *names):
        return self.t if any(k in n for n in self.kernels for k in names) else None


def test_the_count_is_the_hand_count():
    assert VALUES_640 == 23_961_600
    for cell in ("detect.bf16.b128", "detect.int8.b128"):
        dan = harness.find_cell(cell).config["dan"]
        assert dan["model"]["image_size"] == 640
        assert harness.metric_module(METRIC).fuse_values(dan) == VALUES_640


@pytest.mark.parametrize("cell", ["detect.bf16.b128", "detect.int8.b128"])
def test_the_reader(cell):
    c = harness.find_cell(cell)
    assert c.mix["params"]["batch"] == 128
    least = VALUES_640 * 128 * 2 / BYTES_PER_S  # bf16
    assert math.isclose(least, 1.831e-3, rel_tol=1e-3)
    view = _View(2 * least * 6, 6, c.config, c.mix["params"])
    assert math.isclose(harness.read_metric(METRIC, view), 50.0)


def test_a_trace_without_the_kernel_reads_nothing():
    c = harness.find_cell("detect.bf16.b128")
    others = ("bias_act_kernel", "l2norm_kernel", "upsample_bilinear2d_nhwc_out_frame")
    view = _View(1e-3, 6, c.config, c.mix["params"], kernels=others)
    assert harness.read_metric(METRIC, view) is None
    assert harness.read_metric(METRIC, _View(None, 6, c.config, c.mix["params"])) is None
    # The kernel's name holds none of the other passes' names, nor they its.
    name = harness.metric_module(METRIC).KERNEL
    assert not any(o in name or name in o for o in others + ("residual_relu_kernel",))
