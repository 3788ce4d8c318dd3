"""`python -m dan_tpu_torch.tools.smoke_e2e` (the port of
scripts/smoke_e2e.py) at a small size on the CPU: two train steps, the
single-scale evaluation and, with --int8, the calibration and the int8
evaluation run and report their AP.  The AP of a two-step model is not
held to the reference's gates here (the run returns 1 for it); the card
runs the full recipe (chip_smoke.py phase 18).  The gates themselves are
held on made-up results."""
import os

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


def test_run_is_deterministic_and_restores_the_flags(monkeypatch):
    """smoke_e2e runs under torch.use_deterministic_algorithms (cuDNN's
    autotuner off, CUBLAS_WORKSPACE_CONFIG set) and puts all three back; two
    runs train the same model."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    prev = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.benchmark)
    seen = []
    real = smoke_e2e._run

    def spy(args, config=None):
        seen.append((torch.are_deterministic_algorithms_enabled(),
                     torch.backends.cudnn.benchmark, os.environ.get("CUBLAS_WORKSPACE_CONFIG")))
        return real(args, config)

    smoke_e2e._run = spy
    try:
        runs = [smoke_e2e.run(smoke_e2e.parse_args(
            ["--steps", "2", "--batch", "2", "--eval_n", "2", "--device", "cpu"]), tiny())
            for _ in range(2)]
    finally:
        smoke_e2e._run = real
    assert seen == [(True, False, ":4096:8")] * 2
    assert (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.benchmark) == prev
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ
    a, b = (r["detector"].model.state_dict() for r in runs)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert runs[0]["aps"] == runs[1]["aps"] and runs[0]["loss"] == runs[1]["loss"]


def _interpolate_grad(x, g):
    """autograd's gradient of F.interpolate's 2x bilinear upsample, in float64."""
    x = x.detach().double().requires_grad_()
    y = torch.nn.functional.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)
    return torch.autograd.grad(y, x, g.double())[0]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw", [(5, 7), (1, 1), (4, 3)])
def test_deterministic_upsample_gradient_equals_interpolate(dtype, hw):
    """Under the deterministic mode upsample2x's forward is F.interpolate's,
    bit for bit, and its gradient (sums of slices, in float32 or wider)
    equals autograd's through F.interpolate on the same (rounded) inputs:
    to float64 rounding in float64, and within a few units of the dtype's
    rounding (of the gradient's scale) in float32 and bf16."""
    from dan_tpu_torch.models.layers import upsample2x

    gen = torch.Generator().manual_seed(hw[0] * 10 + hw[1])
    x = torch.randn(2, 3, *hw, generator=gen, dtype=torch.float64).to(dtype).requires_grad_()
    g = torch.randn(2, 3, 2 * hw[0], 2 * hw[1], generator=gen, dtype=torch.float64).to(dtype)
    torch.use_deterministic_algorithms(True)
    try:
        y = upsample2x(x)
        (got,) = torch.autograd.grad(y, x, g)
    finally:
        torch.use_deterministic_algorithms(False)
    assert type(y.grad_fn).__name__ == "_Upsample2xBackward"
    assert torch.equal(y, torch.nn.functional.interpolate(
        x.detach(), scale_factor=2, mode="bilinear", align_corners=False))
    assert got.dtype == dtype
    want = _interpolate_grad(x, g)
    if dtype == torch.float64:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-13)
    else:  # four float32 products summed, rounded once to the dtype
        err = float((got.double() - want).abs().max())
        unit = {torch.float32: 2.0**-23, torch.bfloat16: 2.0**-8}[dtype]
        assert err <= 4 * unit * float(g.double().abs().max()), err
