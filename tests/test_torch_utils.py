"""The port's utils (dan_tpu_torch/utils/) against the JAX package's
(dan_tpu/utils/): MetricsLogger's records and stderr lines equal the
reference's but for the time, ThroughputMeter equal on one clock,
maybe_trace writes a Chrome trace on the CPU, and draw_detections writes
files pixel-identical to the reference's."""
import json
import os

import cv2
import numpy as np
import pytest
import torch

from dan_tpu.utils import logging as jax_logging
from dan_tpu.utils import profiling as jax_profiling
from dan_tpu.utils import viz as jax_viz
from dan_tpu_torch.utils import logging as port_logging
from dan_tpu_torch.utils import profiling as port_profiling
from dan_tpu_torch.utils import viz as port_viz

torch.set_num_threads(1)

METRICS = [(1, {"loss": 3.25, "num_pos": np.float32(66), "grad_norm": 1e5}),
           (2, {"loss": float("nan"), "lr": 1e-3}),
           (7, {"images_per_sec_per_chip": 123.456789})]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _untimed(line):
    return line.split("] ", 1)[1]


def test_metrics_logger_equals_the_reference(tmp_path, capsys):
    loggers = {"port": port_logging.MetricsLogger(str(tmp_path / "port")),
               "jax": jax_logging.MetricsLogger(str(tmp_path / "jax"))}
    lines = {}
    for name, logger in loggers.items():
        for step, metrics in METRICS:
            logger.log(step, metrics)
        logger.log(9, {"x": 1.0}, echo=False)
        logger.close()
        lines[name] = capsys.readouterr().err.splitlines()
    assert loggers["port"].path.endswith(os.path.join("port", "train_metrics.jsonl"))
    got, want = (_records(loggers[k].path) for k in ("port", "jax"))
    # As JSON text, so that the NaN loss compares equal; keys in order.
    assert [json.dumps({k: v for k, v in r.items() if k != "time"}) for r in got] == \
        [json.dumps({k: v for k, v in r.items() if k != "time"}) for r in want]
    assert len(got) == 4 and [list(r)[:2] for r in got] == [["step", "time"]] * 4
    assert [_untimed(x) for x in lines["port"]] == [_untimed(x) for x in lines["jax"]]
    assert len(lines["port"]) == 3 and lines["port"][0].startswith("[")
    echo_only = port_logging.MetricsLogger(None, "eval")
    assert echo_only.path is None
    echo_only.log(1, {"ap": 0.5})
    assert _untimed(capsys.readouterr().err.strip()) == "step=1 ap=0.5"


def test_throughput_meter_equals_the_reference(monkeypatch):
    now = [10.0]
    monkeypatch.setattr(port_profiling.time, "perf_counter", lambda: now[0])
    port = port_profiling.ThroughputMeter(32, n_chips=4)
    jax_m = jax_profiling.ThroughputMeter(32, n_chips=4)
    for m in (port, jax_m):
        m.tick()
        m.tick(4)
    now[0] = 12.5
    assert port.images_per_sec == jax_m.images_per_sec == 5 * 32 / 2.5
    assert port.images_per_sec_per_chip == jax_m.images_per_sec_per_chip == 16.0
    port.reset()
    assert port._steps == 0


def test_maybe_trace_writes_a_chrome_trace(tmp_path):
    with port_profiling.maybe_trace(None) as prof:
        assert prof is None
    d = str(tmp_path / "trace")
    x = torch.randn(32, 32)
    with port_profiling.maybe_trace(d) as prof:
        y = x @ x
    assert prof is not None and y.shape == (32, 32)
    path = port_profiling.trace_path(d)
    assert os.listdir(d) == [os.path.basename(path)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


@pytest.mark.parametrize("ext", [".png", ".jpg"])
def test_draw_detections_pixel_identical(tmp_path, ext):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (120, 160, 3), dtype=np.uint8)
    boxes = np.array([[10.4, 20.6, 60.2, 80.9], [100, 5, 150, 40], [0, 0, 159, 119]],
                     np.float32)
    scores = np.array([0.987, 0.5, 0.05], np.float32)
    port_viz.draw_detections(img, boxes, scores, str(tmp_path / ("port" + ext)))
    jax_viz.draw_detections(img, boxes, scores, str(tmp_path / ("jax" + ext)))
    got, want = (cv2.imread(str(tmp_path / (k + ext))) for k in ("port", "jax"))
    assert got.shape == (120, 160, 3) and np.array_equal(got, want)
    assert not np.array_equal(got[:, :, ::-1], img)  # something was drawn
