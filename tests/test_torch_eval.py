"""The port's evaluation tail: the WIDER txt writer / reader and the AP
protocol (own numpy copies) against the JAX package's on seeded detections
and on the committed official `.mat` fixture, and the CLI
`python -m dan_tpu_torch.eval` on the CPU."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import dan_tpu.eval as ref_eval
import dan_tpu_torch.eval as port_eval
from dan_tpu.data.widerface import load_split as ref_load_split
from dan_tpu.eval import widerface_ap as ref_ap
from dan_tpu.eval import writer as ref_writer
from dan_tpu_torch.api import Detector
from dan_tpu_torch.ckpt import train_state as ckpt
from dan_tpu_torch.config import DANConfig, MatchConfig, ModelConfig, PreprocessConfig, TrainConfig
from dan_tpu_torch.data.widerface import load_image_rgb, load_split
from dan_tpu_torch.eval import widerface_ap as port_ap
from dan_tpu_torch.eval import writer as port_writer
from dan_tpu_torch.train import create_train_state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "mini_wider")
GT_MATS = os.path.join(FIX, "eval_tools", "ground_truth")


def test_eval_package_exports_what_the_reference_exports():
    assert sorted(port_eval.__all__) == sorted(ref_eval.__all__)
    for name in port_eval.__all__:
        assert getattr(port_eval, name).__module__.startswith("dan_tpu_torch.")


def _seeded(rng, gt_boxes, miss=0.3, extra=4):
    """Noisy detections around the gt boxes plus random false positives."""
    preds = {}
    for stem, gts in gt_boxes.items():
        keep = rng.uniform(size=len(gts)) > miss
        det = gts[keep] + rng.normal(0, 2.0, (int(keep.sum()), 4))
        fp = rng.uniform(0, 300, (extra, 4))
        fp[:, 2:] += fp[:, :2]
        boxes = np.concatenate([det, fp]).astype(np.float32)
        scores = rng.uniform(0.05, 1.0, len(boxes)).astype(np.float32)
        preds[stem] = np.concatenate([boxes, scores[:, None]], axis=1)
    return preds


def test_load_split_and_official_gt_equal_the_reference():
    a, b = load_split(FIX, "val", keep_invalid=True), ref_load_split(FIX, "val", keep_invalid=True)
    assert [r.rel_path for r in a] == [r.rel_path for r in b] and len(a) == 20
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra.boxes, rb.boxes)
    gt_a, keep_a, stems_a = port_ap.load_official_gt(GT_MATS)
    gt_b, keep_b, stems_b = ref_ap.load_official_gt(GT_MATS)
    assert stems_a == stems_b
    for stem in stems_a:
        np.testing.assert_array_equal(gt_a[stem], gt_b[stem])
        for s in port_ap.SETTINGS:
            np.testing.assert_array_equal(keep_a[s][stem], keep_b[s][stem])


@pytest.mark.parametrize("official", [True, False], ids=["official_mats", "height_rule"])
def test_ap_equals_the_reference_on_seeded_detections(official):
    gt_boxes, keep_lists, _ = ref_ap.load_official_gt(GT_MATS)
    preds = _seeded(np.random.default_rng(0), gt_boxes)
    keep = keep_lists if official else None
    want = ref_ap.evaluate_widerface(preds, gt_boxes, keep)
    got = port_ap.evaluate_widerface(preds, gt_boxes, keep)
    assert set(got) == {"easy", "medium", "hard"}
    for s in got:
        assert got[s] == pytest.approx(want[s], abs=1e-12), s
        assert 0.0 < got[s] < 1.0


def test_writer_round_trip_equals_the_reference(tmp_path):
    gt_boxes, _, _ = ref_ap.load_official_gt(GT_MATS)
    preds = _seeded(np.random.default_rng(1), gt_boxes)
    for stem, p in preds.items():
        port_writer.write_wider_detections(str(tmp_path / "a"), stem + ".jpg", p[:, :4], p[:, 4])
        ref_writer.write_wider_detections(str(tmp_path / "b"), stem + ".jpg", p[:, :4], p[:, 4])
    for stem in preds:
        with open(tmp_path / "a" / (stem + ".txt")) as fa, open(tmp_path / "b" / (stem + ".txt")) as fb:
            assert fa.read() == fb.read()
    back = port_writer.load_detection_dir(str(tmp_path / "a"))
    ref_back = ref_writer.load_detection_dir(str(tmp_path / "b"))
    assert sorted(back) == sorted(ref_back) == sorted(preds)
    for stem in preds:
        np.testing.assert_array_equal(back[stem], ref_back[stem])
    np.testing.assert_array_equal(
        port_writer.read_wider_detections(str(tmp_path / "a" / (sorted(preds)[0] + ".txt"))),
        back[sorted(preds)[0]],
    )


def _cli(*args, timeout=900):
    return subprocess.run(
        [sys.executable, "-m", "dan_tpu_torch.eval", *args], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=timeout,
    )


def test_cli_score_only_perfect_predictions_ap_one(tmp_path):
    """The gt of the official .mat fixture written as detections scores
    AP 1.0 through `--score_only --gt_mats`."""
    gt_boxes, _, _ = port_ap.load_official_gt(GT_MATS)
    for stem, gts in gt_boxes.items():
        scores = np.linspace(0.9, 0.6, len(gts)).astype(np.float32)
        port_writer.write_wider_detections(str(tmp_path), stem + ".jpg",
                                           gts.astype(np.float32), scores)
    proc = _cli("--score_only", "--pred_dir", str(tmp_path), "--gt_mats", GT_MATS,
                "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert last.startswith("WIDER FACE val AP  easy=")
    aps = [float(tok.split("=")[1]) for tok in last.split()[-3:]]
    assert aps == pytest.approx([1.0, 1.0, 1.0], abs=1e-3)


def test_cli_no_tta_on_the_mini_fixture(tmp_path):
    proc = _cli("--wider_root", FIX, "--output_dir", str(tmp_path / "out"), "--limit", "2",
                "--no_tta", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "WARNING: random weights" in proc.stderr and "device: cpu" in proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("WIDER FACE val AP  easy=")
    written = port_writer.load_detection_dir(str(tmp_path / "out"))
    assert len(written) == 2 and all(p.shape[1] == 5 for p in written.values())


def test_cli_int8_on_the_mini_fixture(tmp_path):
    """--int8 calibrates on the first --calib images, then evaluates the
    int8 detect path (the plain int8 convolution on the CPU)."""
    proc = _cli("--wider_root", FIX, "--output_dir", str(tmp_path / "out"), "--limit", "2",
                "--no_tta", "--int8", "--calib", "2", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[int8] calibrated on 2 images" in proc.stderr
    assert proc.stdout.strip().splitlines()[-1].startswith("WIDER FACE val AP  easy=")
    written = port_writer.load_detection_dir(str(tmp_path / "out"))
    assert len(written) == 2 and all(p.shape[1] == 5 for p in written.values())


def test_cli_int8_requires_no_tta():
    proc = _cli("--wider_root", FIX, "--limit", "1", "--int8", "--device", "cpu", timeout=300)
    assert proc.returncode == 2 and "--int8 requires --no_tta" in proc.stderr


def test_cli_usage_errors(tmp_path):
    proc = _cli("--device", "cpu", timeout=300)
    assert proc.returncode != 0 and "--wider_root is required" in proc.stderr
    proc = _cli("--score_only", "--pred_dir", str(tmp_path), "--gt_mats", GT_MATS, "--limit", "2",
                "--device", "cpu", timeout=300)
    assert proc.returncode != 0 and "--limit needs --wider_root" in proc.stderr


def test_detector_from_train_checkpoint(tmp_path):
    """--ckpt's loader: a train-state checkpoint (file or model_dir) gives
    the detector the trained model's weights."""
    cfg = DANConfig(
        model=ModelConfig(image_size=64, compute_dtype="float32"),
        preprocess=PreprocessConfig(train_image_size=64, canvas_size=128),
        match=MatchConfig(max_gt=8), train=TrainConfig(batch_size=2),
    )
    state = create_train_state(cfg, seed=3, device="cpu")
    path = ckpt.save(str(tmp_path), 7, state)
    for where in (path, str(tmp_path)):
        det = Detector.from_train_checkpoint(where, cfg, device="cpu")
        for (name, a), b in zip(state.model.named_parameters(), det.model.parameters()):
            assert torch.equal(a, b), name
    with pytest.raises(FileNotFoundError):
        Detector.from_train_checkpoint(str(tmp_path / "none"), cfg, device="cpu")


def test_load_image_rgb_decodes_the_fixture():
    rec = load_split(FIX, "val")[0]
    img = load_image_rgb(rec.path)
    assert img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3
