"""The yardstick's counts against hand counts: convolution operations of
the layer shapes, the kernels' least times, the NMS work of tiny
rows."""
import torch

from benchmark import harness
from benchmark.counts import model_ops, peaks, selection

DAN = harness.find_cell("detect.bf16.b128").config["dan"]


def test_a_convolution_by_hand():
    assert model_ops.conv_ops(4, 3, 2, 3) == 2 * 4 * 4 * 2 * 3 * 3 * 3


def test_the_forward_by_hand_at_640():
    # conv1_1 at 640: 2 x 640^2 x 64 x 3 x 9; conv1_2: 2 x 640^2 x 64 x 64 x 9
    layers = {n: (hi, ho, ci, co, k) for n, _, hi, ho, ci, co, k in model_ops.conv_layers(DAN, 640)}
    assert layers["conv1_1"] == (640, 640, 3, 64, 3) and layers["conv2_1"] == (320, 320, 64, 128, 3)
    assert layers["fc6"] == (20, 20, 512, 1024, 3) and layers["conv7_2"] == (10, 5, 128, 256, 3)
    assert layers["lfpn_td_conv3_3"] == (80, 80, 512, 256, 1)
    assert layers["head_conv3_3"] == (160, 160, 256, 8, 3)
    ops = model_ops.forward_ops(DAN, 640)
    assert ops == {"bfloat16": 267_566_771_200, "int8": 0}
    i8 = model_ops.forward_ops(DAN, 640, int8_body=True)
    assert i8["int8"] + i8["bfloat16"] == ops["bfloat16"]
    assert i8["bfloat16"] == sum(model_ops.conv_ops(ho, ci, co, k) for _, part, _, ho, ci, co, k
                                 in model_ops.conv_layers(DAN, 640) if part != "body")


def test_least_times_match_the_card_checks_bounds():
    # chip_smoke's bounds of K6 at batch 32 (1.7371 ms) and of the 18 int8
    # convolutions at batch 128 (16.460 ms)
    assert abs(model_ops.conv12_wgrad_least_s(DAN, 32) * 1e3 - 1.7371) < 1e-3
    assert abs(model_ops.conv_i8_least_s(DAN, 128) * 1e3 - 16.460) < 1e-2


def test_selection_work_on_tiny_rows():
    boxes = torch.tensor([[[0, 0, 10, 10], [1, 1, 11, 11], [50, 50, 60, 60]]], dtype=torch.float32)
    scores = torch.tensor([[0.9, 0.8, 0.7]])
    steps, pairs, gone = selection.selection_work(boxes, scores, scores > 0, 0.3, 10)
    # step 1 takes box 0 against 2 others (box 1 suppressed), step 2 box 2 alone
    assert steps.tolist() == [2] and pairs.tolist() == [2] and gone.tolist() == [3]
    least = selection.nms_least_seconds(boxes, scores, 0.3, 10)
    assert least == max(3 * 24 / peaks.BYTES_PER_S, 2 * 15 / peaks.OPS_PER_S["float32"])


def test_peaks_table():
    assert peaks.OPS_PER_S["bfloat16"] == 989e12 and peaks.OPS_PER_S["int8"] == 1979e12
    assert peaks.least_seconds(3.35e12, 0, "bfloat16") == 1.0
