"""Whole runs of every cell at a tiny size on the CPU, the card's look
skipped: the program's run is correct where the cell's limits hold at this
size, the control (the reference in the precision below the
configuration's) reads above the program, and every fault of a cell makes
`correct` come out false.  Tests marked `card` do the same at the cell's
own size on an H100."""
import math

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import run, tiny_cell

torch.set_num_threads(2)
CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def _finite(res):
    return all(c["value"] is not None and math.isfinite(c["value"]) for c in res["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_program_control_and_faults(cell):
    c = tiny_cell(cell)
    prog = run(c, seconds=0.2)
    assert _finite(prog), prog["checks"]
    assert prog["attempted"] > 0 and prog["failed"] == 0
    ctrl = run(c, seed=2**31 + 12, seconds=0.2, control=True)
    key = "loss_gap" if c.mix["kind"] == "train" else "logit_rel_l2"
    assert ctrl["checks"][key]["value"] > 3 * prog["checks"][key]["value"], (ctrl, prog)
    for fault in c.driver.FAULTS:
        res = run(c, seed=2**31 + 13, seconds=0.2, fault=fault)
        assert res["correct"] is False, (fault, res["checks"])
    exact = [k for k, v in c.limits.items() if v == 0]
    assert all(prog["checks"][k]["value"] == 0 for k in exact), prog["checks"]


def test_a_fault_that_starts_in_the_window_is_caught(monkeypatch):
    """From the second step on (the window's first), every step trains on
    the batch of the step before it, as a feed that reused its buffers
    would: the set-up's step alone is sound."""
    from dan_tpu_torch.train import loop

    inner, seen = loop.preprocess_and_match, []

    def stale(*a, **k):
        seen.append(inner(*a, **k))
        return seen[max(0, len(seen) - 2) if len(seen) > 1 else 0]

    monkeypatch.setattr(loop, "preprocess_and_match", stale)
    res = run(tiny_cell("train.bf16.b32"), seconds=0.2)
    assert res["correct"] is False, res["checks"]
    assert not res["checks"]["loss_gap"]["value"] <= res["checks"]["loss_gap"]["limit"]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from benchmark.reference.lowp import rounding, tf32

    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12, -3.0])
    assert tf32(x).tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-9, 1.0, -3.0]
    assert rounding("float32") is tf32 and rounding("int8") is None


@pytest.mark.parametrize("cell", [c for c in CELLS if not c.startswith("train")])
def test_a_tiny_detect_run_is_correct_under_the_cells_limits(cell):
    res = run(tiny_cell(cell), seconds=0.2)
    assert res["correct"] is True, res["checks"]


def test_a_traced_run_reports_per_layer_metrics_and_no_end_to_end():
    res = run(tiny_cell("detect.bf16.b128"), seconds=0.2, trace=True)
    assert "detect_img_s" not in res["metrics"] and "setup_s" not in res["metrics"]
    assert res["metrics"]["forward_ms.detect"]["unit"] == "ms"
    assert list(res)[-1] == "checks" and "breakdown" in res


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [3100000001, 3100000002, 3100000003])
def test_the_control_fails_at_the_cells_own_size(cell, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = harness.find_cell(cell)
    r = harness.Run(c, seed, 2.0, torch.device("cuda", 0), control=True)
    assert harness.run_cell(r, 0.0)["correct"] is False
