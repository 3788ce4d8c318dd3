"""The port's host C++ helpers (dan_tpu_torch/native/): the AP matcher of
overlaps.cc held bit for bit against the numpy matcher of both packages, the
fixture's AP against the JAX package's numpy AP, the build's cache key, and
four processes building at once.  The libraries are built here with g++;
a test skips only where g++ itself is absent, never because a build failed.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from dan_tpu import native as ref_native
from dan_tpu.eval import widerface_ap as ref_ap
from dan_tpu_torch import native
from dan_tpu_torch.eval import widerface_ap as port_ap

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GT_MATS = os.path.join(REPO, "tests", "fixtures", "mini_wider", "eval_tools", "ground_truth")


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = native.load()
    assert lib is not None, "overlaps.cc did not build"
    return lib


def _boxes(r, n, lo=0.0, hi=1000.0, size=(1.0, 200.0)):
    xy = r.uniform(lo, hi, (n, 2))
    wh = r.uniform(*size, (n, 2))
    return np.concatenate([xy, xy + wh], axis=-1)


def _minmax(a):
    return np.concatenate([np.minimum(a[:, :2], a[:, 2:]), np.maximum(a[:, :2], a[:, 2:])], -1)


def _case(name):
    r = np.random.default_rng(0)
    if name == "reference":  # tests/unit/test_native.py's shapes
        return _minmax(r.uniform(0, 100, (23, 4))), _minmax(r.uniform(0, 100, (11, 4)))
    if name == "3000x1000":
        return _boxes(r, 3000), _boxes(r, 1000)
    # Zero-area gts (a point, a vertical and a horizontal line) among boxes
    # that touch or nest, integer corners so that ties are exact.
    gts = np.array([[10, 10, 10, 10], [20, 0, 20, 50], [0, 30, 60, 30],
                    [0, 0, 40, 40], [0, 0, 40, 40], [40, 40, 80, 80]], np.float64)
    dets = np.round(_boxes(r, 40, 0, 60, (0, 40)))
    return np.concatenate([dets, gts]), gts


@pytest.mark.parametrize("case", ["reference", "3000x1000", "degenerate"])
def test_bbox_overlaps_bitwise_equal_to_numpy(lib, case):
    dets, gts = _case(case)
    got = native.bbox_overlaps(dets, gts)
    want = ref_ap._bbox_overlaps(dets, gts)
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    np.testing.assert_array_equal(got.view(np.int64),
                                  port_ap._bbox_overlaps(dets, gts).view(np.int64))
    if case == "3000x1000":  # the size on which FMA contraction showed
        assert (got > 0).sum() > 100_000


def _matcher_inputs(seed):
    """tests/unit/test_native.py's seeded images; seeds 5 and 6 add
    zero-area gts and a det equal to two tied gts."""
    r = np.random.default_rng(seed)
    n, m = int(r.integers(1, 40)), int(r.integers(0, 15))
    xy = r.uniform(0, 80, (n, 2))
    wh = r.uniform(2, 30, (n, 2))
    dets = np.concatenate([xy, xy + wh, r.uniform(0, 1, (n, 1))], axis=-1)
    dets = dets[np.argsort(-dets[:, 4], kind="stable")]
    gxy = r.uniform(0, 80, (m, 2))
    gwh = r.uniform(2, 30, (m, 2))
    gts = np.concatenate([gxy, gxy + gwh], axis=-1)
    if seed >= 5:
        gts = np.concatenate([gts, [[5, 5, 5, 5], [0, 0, 30, 30], [0, 0, 30, 30],
                                    [10, 0, 10, 40]]])
        dets = np.concatenate([[[0, 0, 30, 30, 1.0], [5, 5, 5, 5, 0.99]], dets])
    keep = np.nonzero(r.uniform(size=len(gts)) > 0.3)[0]
    return dets, gts, keep


@pytest.mark.parametrize("seed", range(7))
def test_image_eval_bitwise_equal_to_numpy(lib, seed, monkeypatch):
    dets, gts, keep = _matcher_inputs(seed)
    ignore = np.ones(len(gts), bool)
    ignore[keep] = False
    got = native.image_eval(dets, gts, ignore, 0.5)
    assert got is not None
    monkeypatch.setattr(native, "image_eval", lambda *a, **k: None)
    monkeypatch.setattr(ref_native, "image_eval", lambda *a, **k: None)
    for want in (port_ap._image_eval(dets, gts, keep), ref_ap._image_eval(dets, gts, keep)):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.int64
            np.testing.assert_array_equal(g, w)


def test_ap_identical_with_and_without_native(lib, monkeypatch):
    gt = {
        "e/a": np.array([[0, 0, 60, 60], [100, 100, 160, 170]], np.float64),
        "e/b": np.array([[10, 10, 50, 55]], np.float64),
    }
    preds = {
        "e/a": np.array([[1, 1, 59, 61, 0.9], [200, 200, 250, 260, 0.7]]),
        "e/b": np.array([[10, 10, 50, 55, 0.8]]),
    }
    calls = []
    image_eval = native.image_eval
    monkeypatch.setattr(native, "image_eval", lambda *a: calls.append(1) or image_eval(*a))
    with_native = port_ap.evaluate_widerface(preds, gt)
    assert calls, "the AP did not take the native matcher"
    monkeypatch.setattr(native, "image_eval", lambda *a, **k: None)
    without = port_ap.evaluate_widerface(preds, gt)
    assert with_native == without


@pytest.mark.parametrize("official", [True, False], ids=["official_mats", "height_rule"])
def test_fixture_ap_equals_the_reference_numpy_ap(lib, official, monkeypatch):
    """The fixture's gt with seeded noisy detections: the port's AP on its
    native matcher == the JAX package's AP on its numpy matcher, exactly."""
    from tests.test_torch_eval import _seeded

    gt_boxes, keep_lists, _ = ref_ap.load_official_gt(GT_MATS)
    preds = _seeded(np.random.default_rng(1), gt_boxes)
    keep = keep_lists if official else None
    got = port_ap.evaluate_widerface(preds, gt_boxes, keep)
    monkeypatch.setattr(ref_native, "image_eval", lambda *a, **k: None)
    want = ref_ap.evaluate_widerface(preds, gt_boxes, keep)
    assert got == want
    assert all(0.0 < v < 1.0 for v in got.values())


def test_cache_key_follows_flags_and_libjpeg(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib_a = tmp_path / "a" / "libjpeg.so.62"
    lib_a.parent.mkdir()
    lib_a.write_bytes(b"\x7fELF one")
    lib_b = tmp_path / "b" / "libjpeg.so.62"
    lib_b.parent.mkdir()
    lib_b.write_bytes(b"\x7fELF two")
    flags = native.FLAGS["loader"]
    base = native.cache_key("loader", flags, str(lib_a))
    assert base == native.cache_key("loader", flags, str(lib_a))
    assert base != native.cache_key("loader", flags + ("-DX",), str(lib_a))
    assert base != native.cache_key("loader", flags, str(lib_b))  # other bytes
    lib_c = tmp_path / "c.so.62"
    lib_c.write_bytes(lib_a.read_bytes())
    assert base != native.cache_key("loader", flags, str(lib_c))  # other path
    assert (native.cache_key("overlaps", native.FLAGS["overlaps"])
            != native.cache_key("overlaps", ("-O3", "-march=native")))


_LOAD_BOTH = (
    "import sys, time\n"
    "from dan_tpu_torch import native\n"
    "native.BUILD_DIR = sys.argv[1]\n"
    "while time.time() < float(sys.argv[2]):\n"
    "    time.sleep(0.005)\n"
    "assert native.load() is not None, native._reasons\n"
    "assert native.load_loader() is not None, native.loader_unavailable_reason()\n"
    "assert native.bbox_overlaps([[0, 0, 2, 2]], [[1, 1, 3, 3]])[0, 0] == 1 / 7\n"
    "assert 'PIL' not in sys.modules\n"
    "print('ok', native.BUILD_SECONDS)\n"
)


def test_four_processes_building_at_once_make_one_library_each(tmp_path):
    """Four processes load both libraries into one empty build directory at
    the same moment: each loads a whole library (every building process
    writes its own file and renames it into place), one file a library
    remains, and none of them imports PIL to find the libjpeg."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    import time

    build = tmp_path / "build"
    start = str(time.time() + 3.0)
    procs = [subprocess.Popen([sys.executable, "-c", _LOAD_BOTH, str(build), start], cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert out.startswith("ok")
    files = sorted(os.listdir(build))
    assert len(files) == 2, files
    assert files[0].startswith("loader_") and files[1].startswith("overlaps_")
    assert all(f.endswith(".so") for f in files)


def test_loader_unavailable_without_libjpeg(monkeypatch):
    """Neither PIL's libjpeg nor a system one: load_loader() is None and the
    reason says so, and nothing is built."""
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native, "_reasons", {})
    monkeypatch.setattr(native, "pil_libjpeg", lambda: None)
    monkeypatch.setattr(native, "_system_libjpeg", lambda: None)
    assert native.load_loader() is None
    assert native.loader_unavailable_reason().startswith("no libjpeg")
    assert native.jpeg_dims(b"\xff\xd8") is None
