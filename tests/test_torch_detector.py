"""The port's Detector against dan_tpu.api.Detector on the same weights:
fixture JPEGs of different sizes through squash-resize (both resize
semantics), forward, postprocess and the box scaling back to image pixels.
Also checks that the port runs without importing JAX."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from dan_tpu.api import Detector as JaxDetector
from dan_tpu.config import (
    DANConfig,
    ModelConfig,
    PostprocessConfig,
    PreprocessConfig,
    TTAConfig,
)
from dan_tpu.data.widerface import load_image_rgb
from dan_tpu.ops.squash import eval_preprocess as jax_eval_preprocess
from dan_tpu_torch.api import Detector
from dan_tpu_torch.config import from_reference
from dan_tpu_torch.ops.squash import eval_preprocess

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGES = os.path.join(REPO, "tests", "fixtures", "mini_wider", "WIDER_val", "images")
FIXTURE_JPEGS = (  # 480x640, 352x352, 560x420
    "0--Fixture/0_Fixture_img_0.jpg",
    "0--Fixture/10_Fixture_img_10.jpg",
    "0--Fixture/14_Fixture_img_14.jpg",
)


def tiny_config(semantics: str = "half_pixel") -> DANConfig:
    return DANConfig(
        model=ModelConfig(image_size=64, compute_dtype="float32"),
        preprocess=PreprocessConfig(
            train_image_size=64, canvas_size=128, resize_semantics=semantics
        ),
        postprocess=PostprocessConfig(pre_nms_topk=64, max_detections=16),
        tta=TTAConfig(buckets=(64, 128, 256)),
    )


@pytest.fixture(autouse=True)
def _plain_cpu_conv():
    # PyTorch's plain CPU convolution is as accurate as XLA's; its oneDNN
    # path is 2-3x less so (see test_torch_model.py).
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


@pytest.fixture(scope="module")
def images():
    return [load_image_rgb(os.path.join(IMAGES, rel)) for rel in FIXTURE_JPEGS]


def _pair(semantics):
    cfg = tiny_config(semantics)
    jdet = JaxDetector.from_random(jax.random.PRNGKey(0), cfg)
    tree = jax.tree_util.tree_map(np.asarray, jdet.params)
    return jdet, Detector.from_jax_params(tree, from_reference(cfg), device="cpu")


def _same_dets(got, want):
    assert got.keys() == want.keys() == {"bboxes", "scores"}
    assert got["bboxes"].shape == want["bboxes"].shape
    assert len(got["scores"]) > 0
    np.testing.assert_allclose(got["bboxes"], want["bboxes"], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("semantics", ["half_pixel", "tf1_legacy"])
@pytest.mark.parametrize("h,w,out", [(100, 75, 64), (30, 50, 80)])
def test_eval_preprocess_matches_jax(semantics, h, w, out):
    """Squash-resize of the (h, w) region of a larger canvas, clamped at
    the region's edge (down- and upsampling): bit-identical on the CPU,
    since each output mixes at most two pixels a stage."""
    cfg = tiny_config(semantics).preprocess
    canvas = np.random.default_rng(h).integers(0, 255, (128, 128, 3), dtype=np.uint8)
    want = jax_eval_preprocess(jax.numpy.asarray(canvas), jax.numpy.float32(h),
                               jax.numpy.float32(w), out, cfg)
    got = eval_preprocess(torch.from_numpy(canvas), h, w, out, cfg)
    assert got.dtype == torch.float32 and got.shape == (out, out, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("semantics", ["half_pixel", "tf1_legacy"])
def test_detect_and_detect_batch_match_jax(images, semantics):
    jdet, tdet = _pair(semantics)
    for im in images:
        _same_dets(tdet.detect(im), jdet.detect(im))
    for got, want in zip(tdet.detect_batch(images), jdet.detect_batch(images)):
        _same_dets(got, want)


def test_score_threshold_float_input_and_warmup(images):
    _, tdet = _pair("half_pixel")
    tdet.warmup((64, 128))
    im = images[1]
    full = tdet.detect(im)
    cut = tdet.detect(im, score_threshold=float(np.median(full["scores"])))
    assert 0 < len(cut["scores"]) < len(full["scores"])
    np.testing.assert_array_equal(
        tdet.detect(im.astype(np.float32) / 255.0)["scores"].shape, full["scores"].shape
    )
    with pytest.raises(ValueError):
        tdet.detect(np.zeros((64, 64), np.uint8))


def test_port_runs_without_jax():
    """`import dan_tpu_torch` plus one CPU detect leaves JAX unimported."""
    code = (
        "import sys, numpy as np\n"
        "from dan_tpu_torch.config import DANConfig, ModelConfig, PostprocessConfig, TTAConfig\n"
        "from dan_tpu_torch.api import Detector\n"
        "cfg = DANConfig(model=ModelConfig(image_size=64, compute_dtype='float32'),\n"
        "                postprocess=PostprocessConfig(pre_nms_topk=64, max_detections=16),\n"
        "                tta=TTAConfig(buckets=(64, 128)))\n"
        "Detector.from_random(0, cfg, device='cpu').detect(np.full((40, 50, 3), 7, np.uint8))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dan_tpu'))\n"
        "assert not bad, bad\n"
        "print('no-jax-ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "no-jax-ok" in proc.stdout
