"""The port's train and eval CLIs data-parallel under torchrun: two ranks on
the CPU (--device cpu takes gloo), at the CLIs' own default config.

Train: a global batch of 2 (one 640x640 image a rank) for one step, then
one more resumed from its checkpoint; rank 0 alone logs and writes, and the
first step's loss equals the one-device step's (rel 1e-5: only the order of
the sums differs).
Eval: --no_tta on two fixture images, one a rank; rank 0 writes both files
and prints the AP line once, equal to the one-device run's.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from dan_tpu_torch.eval.writer import load_detection_dir

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "mini_wider")
TIMEOUT = 400


def _run(module, *args, ranks=None):
    """`python -m module args` on one device, or under torchrun on `ranks`
    ranks with a rendezvous on a free port of localhost."""
    launch = [sys.executable, "-m"]
    if ranks:
        launch += ["torch.distributed.run", "--standalone", f"--nproc_per_node={ranks}", "-m"]
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([*launch, module, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


def _losses(model_dir):
    with open(os.path.join(model_dir, "train_metrics.jsonl")) as f:
        return [(r["step"], r["loss"]) for r in map(json.loads, f)]


def test_train_cli_on_two_ranks_resumes(tmp_path):
    common = ["--synthetic", "--batch_size", "2", "--log_every", "1", "--checkpoint_every", "1",
              "--device", "cpu"]
    dp, one = str(tmp_path / "dp"), str(tmp_path / "one")
    first = _run("dan_tpu_torch.train", *common, "--model_dir", dp, "--steps", "1", ranks=2)
    assert "2 ranks on gloo" in first.stderr
    second = _run("dan_tpu_torch.train", *common, "--model_dir", dp, "--steps", "2", "--resume",
                  ranks=2)
    assert second.stderr.count("resumed from step 1") == 1  # rank 0 alone speaks
    assert sorted(os.listdir(dp)) == ["step_00000001.pt", "step_00000002.pt",
                                      "train_metrics.jsonl"]
    _run("dan_tpu_torch.train", *common, "--model_dir", one, "--steps", "1")
    got, want = _losses(dp), _losses(one)
    assert [s for s, _ in got] == [1, 2] and [s for s, _ in want] == [1]
    assert got[0][1] == pytest.approx(want[0][1], rel=1e-5)


def test_eval_cli_on_two_ranks_no_tta(tmp_path):
    common = ["--wider_root", FIX, "--limit", "2", "--no_tta", "--device", "cpu"]
    dp = _run("dan_tpu_torch.eval", *common, "--output_dir", str(tmp_path / "dp"), ranks=2)
    one = _run("dan_tpu_torch.eval", *common, "--output_dir", str(tmp_path / "one"))
    assert "rank 1 of 2 on gloo" in dp.stderr
    lines = [ln for ln in dp.stdout.splitlines() if ln.startswith("WIDER FACE val AP")]
    assert lines == [one.stdout.strip().splitlines()[-1]]  # once, and the same AP
    got, want = (load_detection_dir(str(tmp_path / d)) for d in ("dp", "one"))
    assert sorted(got) == sorted(want) and len(got) == 2
    for k in want:
        assert (got[k] == want[k]).all(), k
