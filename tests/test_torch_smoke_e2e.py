"""`python -m dan_tpu_torch.tools.smoke_e2e` (the port of
scripts/smoke_e2e.py) at a small size on the CPU: two train steps, the
single-scale evaluation and, with --int8, the calibration and the int8
evaluation run and report their AP.  The AP of a two-step model is not
held to the reference's gates here (the run returns 1 for it); the card
runs the full recipe (chip_smoke.py phase 18).  The gates themselves are
held on made-up results."""
import numpy as np
import pytest
import torch

from dan_tpu_torch.config import (
    DANConfig,
    MatchConfig,
    ModelConfig,
    PostprocessConfig,
    PreprocessConfig,
    TTAConfig,
)
from dan_tpu_torch.quant import QuantizedDetector
from dan_tpu_torch.tools import smoke_e2e

torch.set_num_threads(1)


def tiny():
    return DANConfig(
        model=ModelConfig(image_size=64, compute_dtype="float32"),
        preprocess=PreprocessConfig(train_image_size=64, canvas_size=128),
        match=MatchConfig(max_gt=8),
        postprocess=PostprocessConfig(pre_nms_topk=64, max_detections=8),
        tta=TTAConfig(buckets=(64, 128)),
    )


def test_smoke_e2e_runs_two_steps_with_int8_on_the_cpu(capsys):
    args = smoke_e2e.parse_args(["--steps", "2", "--batch", "2", "--eval_n", "3", "--int8",
                                 "--device", "cpu"])
    run = smoke_e2e.run(args, config=tiny())
    rc = smoke_e2e.gates(run)
    out = capsys.readouterr().out
    assert rc in (0, 1)
    assert set(run["aps"]) == {"float32", "int8"}
    for aps in run["aps"].values():
        assert set(aps) == {"easy", "medium", "hard"}
        assert all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in aps.values())
    assert "[float32]" in out and "[int8]" in out and "int8 hard-AP delta" in out
    det = run["detector"]
    assert isinstance(det._quant, QuantizedDetector) and det.device.type == "cpu"
    assert len(run["eval_set"]) == 3 and run["train_img_s"] > 0


def _result(bf16, int8=None, loss=1.0):
    aps = {} if bf16 is None else {"bfloat16": {"easy": 1.0, "medium": 1.0, "hard": bf16}}
    if int8 is not None:
        aps["int8"] = {"easy": 1.0, "medium": 1.0, "hard": int8}
    return {"aps": aps, "tag": "bfloat16", "int8": int8 is not None, "loss": loss}


@pytest.mark.parametrize("result, rc", [
    (_result(0.95), 0),
    (_result(0.5), 0),
    (_result(0.49), 1),
    (_result(0.95, 0.94), 0),
    (_result(0.95, 0.9301), 0),
    (_result(0.95, 0.9299), 1),
    (_result(0.45, 0.97), 1),
    (_result(None, loss=float("nan")), 1),
], ids=["pass", "at-the-ap-gate", "low-ap", "int8-pass", "int8-at-the-drop",
        "int8-drop", "low-ap-int8-up", "diverged"])
def test_gates_are_the_references(result, rc):
    """scripts/smoke_e2e.py's gates: hard AP >= 0.5, int8 hard AP >= bf16
    hard AP - 0.02, and a diverged run fails."""
    assert smoke_e2e.gates(result) == rc


def test_main_is_run_then_gates(monkeypatch):
    seen = {}

    def fake_run(args, config=None):
        seen.update(args=args, config=config)
        return _result(0.95, 0.90)
    monkeypatch.setattr(smoke_e2e, "run", fake_run)
    cfg = tiny()
    assert smoke_e2e.main(["--int8", "--steps", "3"], config=cfg) == 1
    assert seen["config"] is cfg and seen["args"].steps == 3 and seen["args"].int8
