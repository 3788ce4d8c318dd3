"""`python -m dan_tpu_torch.tools.demo` on the CPU: its printed detections
equal Detector.detect's on the same image and weights, --out writes the
image at the input's shape with the reference's drawing, and --int8 with
--tta is refused as in scripts/demo.py."""
import os
import subprocess
import sys

import cv2
import numpy as np
import torch

from dan_tpu.utils.viz import draw_detections as jax_draw
from dan_tpu_torch.api import Detector
from dan_tpu_torch.data.widerface import load_image_rgb
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.config import default_config
from dan_tpu_torch.tools import demo

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGES = os.path.join(REPO, "tests", "fixtures", "mini_wider", "WIDER_val", "images")


def _image():
    event = sorted(os.listdir(IMAGES))[0]
    return os.path.join(IMAGES, event, sorted(os.listdir(os.path.join(IMAGES, event)))[0])


def _demo(*args):
    return subprocess.run([sys.executable, "-m", "dan_tpu_torch.tools.demo", *args], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=600)


def test_demo_prints_detect_detections(tmp_path):
    pt = str(tmp_path / "w.pt")
    torch.save({"model": DANDetector(default_config().model,
                                     torch.Generator().manual_seed(3)).state_dict()}, pt)
    out = str(tmp_path / "out.jpg")
    proc = _demo("--image", _image(), "--ckpt", pt, "--score_threshold", "0.05", "--out", out,
                 "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no --ckpt" not in proc.stderr
    img = load_image_rgb(_image())
    want = Detector.from_checkpoint(pt, device="cpu").detect(img, score_threshold=0.05)
    lines = [f"{len(want['scores'])} detections"] + [
        f"  [{b[0]:7.1f} {b[1]:7.1f} {b[2]:7.1f} {b[3]:7.1f}] {s:.3f}"
        for b, s in zip(want["bboxes"], want["scores"])] + [f"wrote {out}"]
    assert proc.stdout.splitlines() == lines and len(want["scores"]) > 0
    drawn = cv2.imread(out)
    assert drawn.shape == img.shape
    jax_draw(img, want["bboxes"], want["scores"], str(tmp_path / "ref.jpg"))
    assert np.array_equal(drawn, cv2.imread(str(tmp_path / "ref.jpg")))


def test_demo_run_in_process_equals_detect_bit_for_bit(capsys):
    out, det = demo.run(demo.parse_args(["--image", _image(), "--score_threshold", "0.2",
                                         "--device", "cpu"]))
    assert "WARNING: no --ckpt, using random weights" in capsys.readouterr().err
    want = Detector.from_random(device="cpu").detect(load_image_rgb(_image()),
                                                     score_threshold=0.2)
    assert np.array_equal(out["bboxes"], want["bboxes"])
    assert np.array_equal(out["scores"], want["scores"])


def test_demo_refuses_int8_with_tta():
    proc = _demo("--image", _image(), "--int8", "--tta", "--device", "cpu")
    assert proc.returncode == 2
    assert "--int8 requires the non-TTA path" in proc.stderr
