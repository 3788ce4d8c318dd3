"""The RetinaFace cell (detect.retinaface_r50.bf16.b128) at a tiny size on
the CPU: its own files end to end (the driver `detect_retinaface`, the
reference, the configuration file and the cell's limits), the counts
against a hand count, and its readers."""
import copy
import dataclasses
import math

import pytest
import torch

from benchmark import harness
from benchmark.counts import retinaface_ops
from benchmark.counts.peaks import BYTES_PER_S, OPS_PER_S

torch.set_num_threads(2)
CELL = "detect.retinaface_r50.bf16.b128"
TINY = dict(batch=4, pool=2, warmup_calls=1, sample_calls=1, sample_within=1, check_images=2,
            check_block=2, trace_calls=1)


def tiny_cell() -> harness.Cell:
    """The cell's own files at 64x64 images, 4 a call, 4 calibration images."""
    cell = harness.find_cell(CELL)
    config, mix = copy.deepcopy(cell.config), copy.deepcopy(cell.mix)
    config["dan"]["model"]["image_size"] = 64
    config["dan"]["postprocess"].update(pre_nms_topk=300, max_detections=50)
    config["calibration_images"] = 4
    mix["params"].update(TINY)
    return dataclasses.replace(cell, config=config, mix=mix)


def run(cell, seed=2**31 + 11, **kw):
    return harness.run_cell(harness.Run(cell, seed, 0.2, torch.device("cpu"), **kw), 0.0)


def test_program_control_and_faults():
    c = tiny_cell()
    prog = run(c)
    assert prog["correct"] is True, prog["checks"]
    assert prog["attempted"] > 0 and prog["checks"]["det_mismatch"]["value"] == 0
    assert set(prog["metrics"]) == {"detect_img_s", "setup_s"}
    ctrl = run(c, seed=2**31 + 12, control=True)
    assert ctrl["correct"] is False
    assert ctrl["checks"]["logit_rel_l2"]["value"] > 3 * prog["checks"]["logit_rel_l2"]["value"]
    for fault in c.driver.FAULTS:
        res = run(c, seed=2**31 + 13, fault=fault)
        assert res["correct"] is False, (fault, res["checks"])


def test_a_traced_run_reports_its_metrics():
    res = run(tiny_cell(), trace=True)
    assert res["correct"] is True, res["checks"]
    assert "detect_img_s" not in res["metrics"]
    assert res["metrics"]["forward_ms.detect"]["unit"] == "ms"
    assert 0 < res["metrics"]["mfu.detect_retinaface"]["value"] < 100


def _dan():
    return harness.find_cell(CELL).config["dan"]


def test_one_bottleneck_by_hand():
    # layer2.0 at 840: conv1 1x1 256 -> 128 at 210^2 (before the stride),
    # conv2 3x3/2 128 -> 128 at 105^2, conv3 1x1 128 -> 512, downsample
    # 1x1/2 256 -> 512, both at 105^2.
    layers = {n: (ho, ci, co, k) for n, ho, ci, co, k in retinaface_ops.conv_layers(_dan(), 840)}
    block = {p: layers[f"body.layer2.0.{p}"] for p in ("conv1", "conv2", "conv3", "downsample.0")}
    assert block == {"conv1": (210, 256, 128, 1), "conv2": (105, 128, 128, 3),
                     "conv3": (105, 128, 512, 1), "downsample.0": (105, 256, 512, 1)}
    ops = sum(retinaface_ops.conv_ops(*v) for v in block.values())
    assert ops == (2 * 210 ** 2 * 256 * 128 + 2 * 105 ** 2 * 128 * 128 * 9
                   + 2 * 105 ** 2 * 128 * 512 + 2 * 105 ** 2 * 256 * 512)
    assert layers["body.conv1"] == (420, 3, 64, 7) and layers["body.layer4.2.conv3"] == (27, 512, 2048, 1)
    assert layers["fpn.merge1.0"] == (105, 256, 256, 3) and layers["ssh3.conv7x7_3.0"] == (27, 64, 64, 3)
    assert layers["LandmarkHead.0.conv1x1"] == (105, 256, 20, 1)
    assert len(layers) == 53 + 5 + 15 + 9


def test_the_whole_forward_and_the_residual_values():
    dan = _dan()
    assert retinaface_ops.forward_ops(dan, 840) == 154_681_178_112
    # The 16 bottleneck outputs: 3 x 256 x 210^2, 4 x 512 x 105^2,
    # 6 x 1024 x 53^2, 3 x 2048 x 27^2.
    assert retinaface_ops.residual_values(dan, 840) == (3 * 256 * 210 ** 2 + 4 * 512 * 105 ** 2
                                                      + 6 * 1024 * 53 ** 2 + 3 * 2048 * 27 ** 2)


class _View:
    def __init__(self, t, calls, config, params):
        self.t, self.units, self.config, self.params = t, {"calls": calls}, config, params

    def kernel_s(self, *names):
        return self.t if "residual_relu_kernel" in names else None


def test_the_residual_roofline_reader():
    cell = harness.find_cell(CELL)
    values = retinaface_ops.residual_values(cell.config["dan"], 840) * 128
    least = 3 * 2 * values / BYTES_PER_S
    view = _View(2 * least * 6, 6, cell.config, cell.mix["params"])
    assert math.isclose(harness.read_metric("res_act_roofline.detect_retinaface", view), 50.0)
    assert harness.read_metric("res_act_roofline.detect_retinaface",
                               _View(None, 6, cell.config, cell.mix["params"])) is None
    assert OPS_PER_S["bfloat16"] == 989e12


@pytest.mark.parametrize("metric", ["mfu.detect_retinaface", "res_act_roofline.detect_retinaface",
                                    "fpn_ms.detect_retinaface", "ssh_ms.detect_retinaface"])
def test_a_new_reader_of_an_empty_stretch_returns_nothing(metric):
    class Empty:
        spans, records, units, config, params, device, host, window = {}, {}, {}, None, {}, [], [], None
        program_spans = []

        def kernel_s(self, *names):
            return None

        def trace_window_s(self):
            return None

    assert harness.read_metric(metric, Empty()) is None
