"""The port's native batch decode (dan_tpu_torch/native/loader.cc through
data/pipeline.py::_prepare_batch_native and TrainPipeline): the cases of
tests/unit/test_data.py's TestNativeLoader held bit for bit, the batch
against the JAX package's native batch and the cv2 batch, and the pipeline
with the native decoder against the same pipeline on cv2 after the train
preprocess.  The loader is built here with g++ against PIL's libjpeg; a
test skips only where g++ itself is absent.  Decode threads are pinned to
at most 2 (six test workers share the host).
"""
import collections
import io
import shutil
import struct

import cv2
import numpy as np
import pytest
import torch

from dan_tpu import native as ref_native
from dan_tpu.config import DANConfig as RefConfig
from dan_tpu.config import MatchConfig as RefMatch
from dan_tpu.config import ModelConfig as RefModel
from dan_tpu.config import PreprocessConfig as RefPre
from dan_tpu.data import pipeline as ref_pipeline
from dan_tpu.data.widerface import ImageRecord as RefRecord
from dan_tpu_torch import native
from dan_tpu_torch.config import DANConfig, MatchConfig, ModelConfig, PreprocessConfig
from dan_tpu_torch.data.pipeline import (
    TrainPipeline,
    _collate,
    _prepare_batch_native,
    _prepare_sample,
    _window_params,
)
from dan_tpu_torch.data.widerface import ImageRecord, load_split
from dan_tpu_torch.train.loop import preprocess_and_match

from tests.test_torch_parallel_tta import FIX

torch.set_num_threads(1)

META = ("crop_x0", "crop_y0", "crop_size", "boxes", "mask", "seed")


@pytest.fixture(scope="module", autouse=True)
def loader():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    lib = native.load_loader()
    assert lib is not None, native.loader_unavailable_reason()
    return lib


def tiny_config(canvas=128):
    return DANConfig(
        model=ModelConfig(image_size=64, compute_dtype="float32"),
        preprocess=PreprocessConfig(train_image_size=64, canvas_size=canvas),
        match=MatchConfig(max_gt=8),
    )


def ref_config(canvas=128):
    return RefConfig(model=RefModel(image_size=64),
                     preprocess=RefPre(train_image_size=64, canvas_size=canvas),
                     match=RefMatch(max_gt=8))


def make_records(tmp_path, rng, sizes, params=()):
    """Random-noise JPEGs (the hardest case for a decoder) of the given
    (h, w), one face box each; params: cv2.imwrite's, one list a size."""
    records = []
    for i, (h, w) in enumerate(sizes):
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        p = str(tmp_path / f"img{i}.jpg")
        cv2.imwrite(p, img[:, :, ::-1], list(params[i]) if params else [])
        records.append(ImageRecord(path=p, rel_path=f"e/img{i}.jpg", event="e",
                                   boxes=np.array([[5, 5, min(w, 60), min(h, 70)]], np.float32),
                                   attrs=np.zeros((1, 6), np.float32)))
    return records


def cv2_batch(records, cfg, seeds):
    return _collate([_prepare_sample(r, cfg, s) for r, s in zip(records, seeds)])


def assert_batches_equal(a, b, keys=META + ("canvas",)):
    for k in keys:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- the cases of tests/unit/test_data.py::TestNativeLoader --------------------


def test_native_batch_matches_fallback(tmp_path):
    """The C++ batch decode gives the cv2 batch at window='full', canvases
    included, byte for byte: canvas-sized, small and oversized (windowed)
    images, the windows at even and odd offsets."""
    cfg = tiny_config()
    records = make_records(tmp_path, np.random.default_rng(1),
                           [(100, 120), (128, 128), (300, 400), (64, 200), (333, 517)])
    seeds = [11, 12, 13, 14, 15]
    counts = collections.Counter()
    nb = _prepare_batch_native(records, cfg, seeds, nthreads=2, window="full", counts=counts)
    assert counts == {"native": 5, "fallback": 0}
    assert_batches_equal(nb, cv2_batch(records, cfg, seeds))


def test_crop_window_decode_preprocess_identical(tmp_path):
    """window='crop' decodes only the sampled crop window (+2 px); the train
    preprocess gives the same sample from it as from the fully decoded
    canvas and from the cv2 batch (the +2 px halo suffices and nothing
    else of the canvas is read)."""
    cfg = tiny_config()
    records = make_records(tmp_path, np.random.default_rng(3),
                           [(100, 120), (128, 128), (300, 400), (64, 200)])
    seeds = [21, 22, 23, 24]
    cb = _prepare_batch_native(records, cfg, seeds, nthreads=2, window="crop")
    fb = _prepare_batch_native(records, cfg, seeds, nthreads=2, window="full")
    assert_batches_equal(cb, fb, META)
    assert (cb["canvas"] != fb["canvas"]).any()  # the crop left zeros
    want_img, want_t = preprocess_and_match(cv2_batch(records, cfg, seeds), cfg, "cpu")
    for b in (cb, fb):
        img, t = preprocess_and_match(b, cfg, "cpu")
        np.testing.assert_array_equal(img.numpy(), want_img.numpy())
        for k, v in t._asdict().items():
            np.testing.assert_array_equal(v.numpy(), getattr(want_t, k).numpy(), err_msg=k)


def test_exif_rotated_jpeg_uses_cv2_fallback(tmp_path):
    """cv2 applies EXIF orientation, libjpeg doesn't: a rotated JPEG takes
    the fallback, so its pixels align with its display-oriented gt."""
    from PIL import Image

    arr = np.random.default_rng(5).integers(0, 255, (100, 80, 3), dtype=np.uint8)
    exif = Image.Exif()
    exif[0x0112] = 6  # rotate 90 CW on display
    b = io.BytesIO()
    Image.fromarray(arr).save(b, format="JPEG", exif=exif.tobytes())
    p = str(tmp_path / "rot.jpg")
    with open(p, "wb") as f:
        f.write(b.getvalue())
    assert native.jpeg_exif_orientation(b.getvalue()) == 6
    rec = ImageRecord(path=p, rel_path="e/rot.jpg", event="e",
                      boxes=np.array([[5, 5, 40, 50]], np.float32),
                      attrs=np.zeros((1, 6), np.float32))
    counts = collections.Counter()
    nb = _prepare_batch_native([rec], tiny_config(), [9], nthreads=1, counts=counts)
    fs = _prepare_sample(rec, tiny_config(), 9)
    assert counts == {"native": 0, "fallback": 1}
    assert fs["canvas"][:80, :100].any() and not fs["canvas"][100:].any()  # rotated: 80 high
    np.testing.assert_array_equal(nb["canvas"][0], fs["canvas"])
    for k in META:
        np.testing.assert_array_equal(nb[k][0], fs[k], err_msg=k)


def _jpeg_with_tag(type_code, count, value_bytes):
    """SOI + APP1 (Exif, big-endian TIFF, one IFD entry: tag 0x0112 with the
    given type, count and value) + EOI."""
    ifd = struct.pack(">H", 1) + struct.pack(">HHI4s", 0x0112, type_code, count,
                                             value_bytes) + b"\x00" * 4
    tiff = b"MM\x00\x2a" + struct.pack(">I", 8) + ifd
    app1 = b"Exif\x00\x00" + tiff
    return b"\xff\xd8" + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + b"\xff\xd9"


@pytest.mark.parametrize("tag,want", [
    ((3, 1, struct.pack(">HH", 6, 0)), 6),  # well-formed SHORT, count 1
    ((4, 1, struct.pack(">I", 6)), -1),  # LONG-typed: reads 0 as a SHORT
    ((3, 2, struct.pack(">HH", 6, 6)), -1),  # count 2
], ids=["short", "long", "count2"])
def test_exif_malformed_orientation_tag_is_untrusted(tag, want):
    """A malformed Orientation tag gives the sentinel -1, which survives the
    pipeline's `or 1` guard and so takes the cv2 fallback; the reference's
    parser says the same."""
    buf = _jpeg_with_tag(*tag)
    got = native.jpeg_exif_orientation(buf)
    assert got == want and (got or 1) != 1
    assert got == ref_native.jpeg_exif_orientation(buf)


def test_pipeline_uses_native_and_falls_back(tmp_path):
    """A non-JPEG file in the batch does not kill the native batch: that
    image alone takes the cv2 path."""
    cfg = tiny_config()
    rng = np.random.default_rng(2)
    records = make_records(tmp_path, rng, [(90, 110), (128, 128)])
    png = str(tmp_path / "img_png.png")
    img = rng.integers(0, 255, (80, 100, 3), dtype=np.uint8)
    cv2.imwrite(png, img[:, :, ::-1])
    records.append(ImageRecord(path=png, rel_path="e/img_png.png", event="e",
                               boxes=np.array([[5, 5, 50, 50]], np.float32),
                               attrs=np.zeros((1, 6), np.float32)))
    counts = collections.Counter()
    nb = _prepare_batch_native(records, cfg, [1, 2, 3], nthreads=2, window="full",
                               counts=counts)
    assert counts == {"native": 2, "fallback": 1}
    np.testing.assert_array_equal(nb["canvas"][2][:80, :100], img)
    assert nb["mask"].sum() == 3
    assert_batches_equal(nb, cv2_batch(records, cfg, [1, 2, 3]))


# -- against the JAX package's native batch ------------------------------------


def _columns(records, cfg, seeds, batch, window):
    """(x0, x1): the canvas columns of each image's native decode, as
    _prepare_batch_native computes them."""
    c = cfg.preprocess.canvas_size
    out = []
    for i, (r, s) in enumerate(zip(records, seeds)):
        h, w = cv2.imread(r.path).shape[:2]
        off_x, _ = _window_params(r, w, h, c, np.random.default_rng(s))
        placed_w = min(c, w - off_x)
        if window == "crop":
            x0 = max(0, int(np.floor(batch["crop_x0"][i])) - 2)
            x1 = min(placed_w, int(np.ceil(batch["crop_x0"][i] + batch["crop_size"][i])) + 2)
        else:
            x0, x1 = 0, placed_w
        out.append((x0, x1))
    return out


def _parity_records(tmp_path):
    """The fixture's 20 images and 12 synthetic JPEGs: 4:2:0 and 4:4:4 at
    quality 60-99, one progressive, widths that put windows at even and odd
    offsets and on the edges of the 16-pixel chroma blocks."""
    fixture = load_split(FIX, "val", keep_invalid=True)
    sizes = [(300, 400), (333, 517), (640, 1024), (200, 144), (700, 900), (129, 131)] * 2
    params = []
    for k, q in enumerate([60, 75, 90, 95, 99, 85] * 2):
        p = [cv2.IMWRITE_JPEG_QUALITY, q]
        if k >= 6:
            p += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444]
        if k == 5:
            p += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
        params.append(p)
    return fixture + make_records(tmp_path, np.random.default_rng(7), sizes, params)


@pytest.mark.parametrize("window", ["full", "crop"])
@pytest.mark.parametrize("canvas", [128, 640])
def test_native_batch_equals_the_jax_packages(tmp_path, window, canvas):
    """The same records and seeds through the JAX package's
    _prepare_batch_native and the port's: every key but the canvas equal;
    the canvases equal except where the reference's window decode is not
    the whole-image decode.  The reference asks libjpeg for the window's
    columns alone, and fancy chroma upsampling takes a crop edge on a
    16-pixel block boundary for the image's edge: the first or last column
    of a window then differs from cv2.  The port asks for one column more
    on each side and equals cv2 there (at 'full' everywhere)."""
    cfg, rcfg = tiny_config(canvas), ref_config(canvas)
    records = _parity_records(tmp_path)
    refs = [RefRecord(path=r.path, rel_path=r.rel_path, event=r.event, boxes=r.boxes,
                      attrs=r.attrs) for r in records]
    seeds = [100 + i for i in range(len(records))]
    got = _prepare_batch_native(records, cfg, seeds, nthreads=2, window=window)
    want = ref_pipeline._prepare_batch_native(refs, rcfg, seeds, nthreads=2, window=window)
    assert_batches_equal(got, want, META)
    whole = cv2_batch(records, cfg, seeds)["canvas"]
    if window == "full":
        np.testing.assert_array_equal(got["canvas"], whole)
    edge_images = 0
    for i, (x0, x1) in enumerate(_columns(records, cfg, seeds, got, window)):
        diff = (got["canvas"][i] != want["canvas"][i]).any(-1)
        if not diff.any():
            continue
        edge_images += 1
        rows, cols = np.nonzero(diff)
        assert set(cols.tolist()) <= {x0, x1 - 1}, (records[i].path, x0, x1, set(cols.tolist()))
        np.testing.assert_array_equal(got["canvas"][i][rows, cols], whole[i][rows, cols])
    if canvas == 128:  # windows inside wider images: the reference's edge shows
        assert edge_images > 0


# -- TrainPipeline ---------------------------------------------------------------


def _take(pipe, n):
    it = iter(pipe)
    try:
        return [next(it) for _ in range(n)]
    finally:
        it.close()
        pipe.stop()


@pytest.mark.parametrize("kw", [dict(rank=1, num_ranks=2), dict(start_step=3)],
                         ids=["rank1_of_2", "start_step3"])
def test_pipeline_native_equals_cv2_after_train_preprocess(kw):
    """TrainPipeline on the native decoder (the default, window 'crop') and
    on cv2: the same records, crops, boxes and seeds, and the same train
    preprocess output and targets, at a rank's rows and from a start step;
    every image of the fixture took the native decode."""
    cfg = tiny_config()
    records = load_split(FIX, "val", keep_invalid=True)
    common = dict(batch_size=4, seed=3, num_workers=2, num_producers=2, **kw)
    nat = TrainPipeline(records, cfg, **common)
    assert nat.use_native and nat.native_window == "crop"
    got = _take(nat, 6)
    plain = TrainPipeline(records, cfg, use_native=False, **common)
    want = _take(plain, 6)
    assert nat.decoded["native"] >= 6 * 2 and nat.decoded["fallback"] == 0
    assert nat.decoded["cv2"] == 0 and plain.decoded["native"] == 0
    rows = 2 if "rank" in kw else 4
    for a, b in zip(got, want):
        assert a["canvas"].shape[0] == rows
        assert_batches_equal(a, b, META)
        img_a, t_a = preprocess_and_match(a, cfg, "cpu")
        img_b, t_b = preprocess_and_match(b, cfg, "cpu")
        np.testing.assert_array_equal(img_a.numpy(), img_b.numpy())
        for k, v in t_a._asdict().items():
            np.testing.assert_array_equal(v.numpy(), getattr(t_b, k).numpy(), err_msg=k)


def test_pipeline_without_the_library_takes_cv2(monkeypatch):
    """A host without the loader library: the producer finds it missing once
    and builds every batch on cv2, equal to use_native=False."""
    calls = []
    monkeypatch.setattr(native, "load_loader", lambda: calls.append(1))
    cfg = tiny_config()
    records = load_split(FIX, "val", keep_invalid=True)
    pipe = TrainPipeline(records, cfg, batch_size=4, num_workers=2, num_producers=1)
    got = _take(pipe, 3)
    want = _take(TrainPipeline(records, cfg, batch_size=4, num_workers=2, num_producers=1,
                               use_native=False), 3)
    assert len(calls) == 1 and set(pipe.decoded) == {"cv2"}
    for a, b in zip(got, want):
        assert_batches_equal(a, b)


def test_native_window_is_checked():
    with pytest.raises(ValueError, match="native_window"):
        TrainPipeline(load_split(FIX, "val", keep_invalid=True), tiny_config(),
                      native_window="half")
