"""The port's TTA path against the JAX package on shared weights: the numpy
planners over a grid of image sizes, `TTARunner` (pre-vote detections,
detect_tta, run_dataset and its launch statistics) on the tiny config of
tests/e2e/test_tta.py, the committed tta.npz golden, and a bucket whose
feature pyramid has odd sizes.

Tolerances: `valid` exact everywhere; pre-vote boxes rtol 1e-4 / atol 1e-3
and scores rtol 1e-5 / atol 1e-6 (the golden-drift test's own, for two f32
forwards whose sums run in different orders); fused boxes rtol 1e-4 /
atol 2e-2 between the two packages (the score-weighted mean amplifies
pre-vote differences when few boxes merge); against the committed golden
rtol 1e-4 / atol 3e-2 for boxes (see GOLDEN_ATOL) and the golden test's own
rtol 1e-5 / atol 1e-6 for scores."""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax

from dan_tpu.config import (
    DANConfig,
    MatchConfig,
    ModelConfig,
    PostprocessConfig,
    PreprocessConfig,
    TTAConfig,
    default_config,
)
from dan_tpu.data.widerface import load_image_rgb
from dan_tpu.eval import tta as jax_tta
from dan_tpu.models.detector import init_detector_params
from dan_tpu_torch.api import Detector
from dan_tpu_torch.config import from_reference
from dan_tpu_torch.eval import tta as port_tta
from dan_tpu_torch.ops import bbox_vote_cuda, nms_cuda

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "mini_wider")


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


def tiny_config(**tta_kw):
    """The config of tests/e2e/test_tta.py."""
    tta = dict(buckets=(64, 128), scales=(0.5, 1.5), extra_scale_small_images=0.0,
               max_pixels=1e9)
    tta.update(tta_kw)
    return DANConfig(
        model=ModelConfig(image_size=64, compute_dtype="float32"),
        preprocess=PreprocessConfig(train_image_size=64, canvas_size=128),
        match=MatchConfig(max_gt=8),
        postprocess=PostprocessConfig(pre_nms_topk=64, max_detections=8),
        tta=TTAConfig(**tta),
    )


def _pair(cfg):
    """(JAX runner, port Detector on the CPU) on the same random weights."""
    params = init_detector_params(jax.random.PRNGKey(0), cfg.model)
    tree = jax.tree_util.tree_map(np.asarray, params)
    det = Detector.from_jax_params(tree, from_reference(cfg), device="cpu")
    return jax_tta.TTARunner(params, cfg), det


@pytest.fixture(scope="module")
def pair():
    return _pair(tiny_config())


# -- planners ------------------------------------------------------------------

SIZES = [(1, 1), (2, 100), (100, 2), (1, 200), (64, 64), (80, 100), (300, 200), (480, 640),
         (768, 1024), (1024, 683), (1366, 1024), (1024, 1024), (400, 1024), (410, 1024),
         (411, 1024), (2048, 2048), (2049, 100), (3000, 4000), (5000, 300), (648, 648)]


@pytest.mark.parametrize("cfg_name", ["default", "tiny", "side_no_flip"])
def test_planners_equal_the_reference(cfg_name):
    ref = {
        "default": default_config(),
        "tiny": tiny_config(),
        "side_no_flip": dataclasses.replace(
            default_config(),
            tta=TTAConfig(enable_flip=False, gate_measure="side", max_pixels=1e6,
                          extra_scale_small_images=0.0),
        ),
    }[cfg_name]
    port = from_reference(ref)
    assert port_tta.max_variants(port) == jax_tta.max_variants(ref)
    rng = np.random.default_rng(0)
    boxes = rng.uniform(0, 300, (50, 4)).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    for h, w in SIZES:
        want = list(jax_tta.plan_variant_buckets(h, w, ref))
        got = list(port_tta.plan_variant_buckets(h, w, port))
        assert len(got) == len(want) <= port_tta.max_variants(port)
        for (gv, gb, gc), (wv, wb, wc) in zip(got, want):
            assert dataclasses.astuple(gv) == dataclasses.astuple(wv), (h, w)
            assert (gb, gc) == (wb, wc), (h, w)
            np.testing.assert_array_equal(
                port_tta.variant_gate(boxes, gv, port.tta.gate_measure),
                jax_tta.variant_gate(boxes, wv, ref.tta.gate_measure),
            )
    for extent in (0.5, 64, 65, 640, 2048, 2049, 5000.7):
        assert port_tta.pick_bucket(extent, port.tta.buckets) == jax_tta.pick_bucket(
            extent, ref.tta.buckets)
        assert port_tta.canvas_bucket(extent, port.tta.buckets) == jax_tta.canvas_bucket(
            extent, ref.tta.buckets)


def test_chunk_and_row_rules_equal_the_reference():
    ref = default_config()
    jr = jax_tta.TTARunner(params={}, config=ref)
    det = Detector.from_random(0, from_reference(tiny_config()), device="cpu")
    tr = port_tta.TTARunner(det.model, from_reference(ref), device="cpu")
    assert tr.DEFAULT_PIXEL_BUDGET == jr.DEFAULT_PIXEL_BUDGET
    assert (tr.DEFAULT_TTA_BATCH, tr.DEFAULT_VOTE_BATCH) == (16, 128)
    for bucket in ref.tta.buckets:
        for n_dev, per in ((1, 16), (1, 1), (1, 32), (4, 16)):
            assert tr.bucket_chunk(bucket, n_dev, per) == jr.bucket_chunk(bucket, n_dev, per)
    assert tr.bucket_chunk(2048, 1, 16) == 8
    assert tr.vote_rows() == jr.vote_rows() == 6000
    assert tr._vote_chunk(1, 128) == jr._vote_chunk(1, 128) == 128
    small = port_tta.TTARunner(det.model, from_reference(ref), pixel_budget=640 * 640,
                               device="cpu")
    assert small.bucket_chunk(640, 1, 8) == 1


# -- the runner against the JAX runner -------------------------------------------


def _assert_prevote(got, want):
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-6)


def _assert_final(got, want, atol=2e-2):
    assert got["bboxes"].shape == want["bboxes"].shape
    np.testing.assert_allclose(got["bboxes"], want["bboxes"], rtol=1e-4, atol=atol)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("hw", [(80, 100), (64, 64), (200, 150), (2, 100)])
def test_collect_variant_dets_and_detect_tta(pair, hw):
    jr, det = pair
    img = np.random.default_rng(sum(hw)).integers(0, 255, hw + (3,), dtype=np.uint8)
    tr = det._get_tta_runner()
    want = jr.collect_variant_dets(img)
    got = tr.collect_variant_dets(img)
    assert got[2].any()
    _assert_prevote(got, want)
    _assert_final(det.detect_tta(img), jr.detect_tta(img))
    # The vote of the port on the JAX runner's pre-vote rows: same inputs,
    # so only the vote's own summation order differs.
    packed = tr._run_vote(*tr._pack_vote_rows([want])).numpy()
    vb, vs, vv = tr._unpack(packed)
    jout = jr.detect_tta(img)
    np.testing.assert_allclose(vb[0][vv[0]], jout["bboxes"], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(vs[0][vv[0]], jout["scores"])


def test_detect_tta_score_threshold_and_float_input(pair):
    _, det = pair
    img = np.random.default_rng(1).integers(0, 255, (80, 100, 3), dtype=np.uint8)
    full = det.detect_tta(img)
    thr = float(np.median(full["scores"]))
    cut = det.detect_tta(img, score_threshold=thr)
    assert len(cut["scores"]) == int((full["scores"] >= thr).sum())
    as_float = det.detect_tta(img.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(as_float["bboxes"], full["bboxes"])


def _dataset(rng):
    images = {
        f"e/img{i}": rng.integers(0, 255, (60 + 8 * i, 80, 3), dtype=np.uint8)
        for i in range(3)
    }
    images["e/big"] = rng.integers(0, 255, (200, 150, 3), dtype=np.uint8)  # > 128
    return images


def test_run_dataset_and_stats(pair):
    jr, det = pair
    tr = det._get_tta_runner()
    images = _dataset(np.random.default_rng(0))
    want = jr.run_dataset(list(images.items()), batch_per_device=4, vote_batch=3)
    want_stats = dict(jr.last_run_stats)
    nms_cuda.LAUNCHES = bbox_vote_cuda.LAUNCHES = 0
    got = det.detect_tta_dataset(list(images.items()), tta_batch=4, vote_batch=3)
    assert tr.last_run_stats == want_stats
    assert want_stats["vote_launches"] == 2 and want_stats["images"] == 4
    assert nms_cuda.LAUNCHES == bbox_vote_cuda.LAUNCHES == 0  # CPU: plain versions
    assert list(got) == list(want)
    for k, img in images.items():
        _assert_final(got[k], want[k])
        one = det.detect_tta(img)
        # run_dataset == per-image detect_tta, at tests/e2e/test_tta.py's tolerance.
        np.testing.assert_allclose(got[k]["bboxes"], one["bboxes"], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got[k]["scores"], one["scores"], rtol=1e-6)
        assert (got[k]["scores"][:-1] >= got[k]["scores"][1:]).all()


def test_vote_rows_keep_one_order_whatever_the_launch_order(pair):
    """An image's variants enter the vote in plan-group order, so a run over
    many images, whose launches flush in another order, gives each image the
    bits it gets alone through the runner."""
    _, det = pair
    plan = list(port_tta.plan_variant_buckets(400, 1024, from_reference(default_config())))
    order = port_tta.vote_order(plan)
    assert sorted(order) == list(range(len(plan)))
    groups = {}
    for i, (_, b, c) in enumerate(plan):
        groups.setdefault((b, c), []).append(i)
    assert [order[i] for members in groups.values() for i in members] == list(range(len(plan)))
    assert len(groups) > 2 and order != list(range(len(plan)))  # a reordering case
    images = _dataset(np.random.default_rng(0))
    full = det.detect_tta_dataset(list(images.items()), tta_batch=2)
    for k, img in images.items():
        alone = det.detect_tta_dataset([(k, img)], tta_batch=2)[k]
        np.testing.assert_array_equal(alone["bboxes"], full[k]["bboxes"])
        np.testing.assert_array_equal(alone["scores"], full[k]["scores"])


def test_reference_vote_rows_follow_the_flush_order_and_ties_follow_the_rows(pair):
    """Why the port fixes the row order: the JAX runner appends an image's
    variants to its vote rows as their launches drain, so the same image
    gets other row orders alone and inside a dataset; and the vote breaks
    score ties by row index, so with tied scores (a saturated softmax) the
    two orders fuse to different boxes."""
    jr, det = pair
    images = _dataset(np.random.default_rng(0))
    seen = []
    pack = jr._pack_vote_rows

    def recording(packed):
        seen.append([tuple(np.array(a) for a in p) for p in packed])
        return pack(packed)

    jr._pack_vote_rows = recording
    try:
        jr.run_dataset(list(images.items()), batch_per_device=2, vote_batch=4)
        key = "e/img1"
        in_full = seen[-1][list(images).index(key)]
        jr.run_dataset([(key, images[key])], batch_per_device=2, vote_batch=4)
        alone = seen[-1][0]
    finally:
        del jr._pack_vote_rows
    # Same detections, another order.
    assert not np.array_equal(alone[1], in_full[1])
    for a, b in zip(alone, in_full):
        np.testing.assert_array_equal(np.sort(a.reshape(len(a), -1), axis=0),
                                      np.sort(b.reshape(len(b), -1), axis=0))
    tr = det._get_tta_runner()
    fused = []
    for boxes, scores, valid in (alone, in_full):
        tied = np.where(valid, np.float32(1.0), np.float32(0.0))
        vb, vs, vv = tr._unpack(tr._run_vote(*tr._pack_vote_rows([(boxes, tied, valid)])).numpy())
        fused.append(vb[0][vv[0]])
    assert fused[0].shape != fused[1].shape or not np.array_equal(fused[0], fused[1])


def test_max_pending(pair):
    _, det = pair
    tr = det._get_tta_runner()
    items = list(_dataset(np.random.default_rng(0)).items())
    base = tr.run_dataset(items, batch_per_device=2, vote_batch=1)  # max_pending 32
    stats = dict(tr.last_run_stats)
    assert stats["vote_launches"] == 4 and stats["bucket_launches"] > 4
    tight = tr.run_dataset(items, batch_per_device=2, vote_batch=1, max_pending=1)
    assert tr.last_run_stats == stats
    for k in base:
        np.testing.assert_array_equal(tight[k]["bboxes"], base[k]["bboxes"])
        np.testing.assert_array_equal(tight[k]["scores"], base[k]["scores"])
    for bad in (0, -3):
        with pytest.raises(ValueError, match="max_pending"):
            tr.run_dataset(items, max_pending=bad)
        with pytest.raises(ValueError, match="max_pending"):
            det.detect_tta_dataset(items, max_pending=bad)


def test_warmup_contract_and_results_unchanged(pair):
    _, det = pair
    items = list(_dataset(np.random.default_rng(0)).items())
    sizes = [im.shape[:2] for _, im in items]
    base = det.detect_tta_dataset(items)
    fresh = Detector(det.model, det.config, device="cpu")
    n = fresh.warmup_tta(sizes)
    pairs = {(b, c) for h, w in sizes for _, b, c in port_tta.plan_variant_buckets(h, w, det.config)}
    assert n == len(pairs) + 1  # the reference's contract: pairs + the vote
    assert fresh.warmup_tta([]) == 0
    warmed = fresh.detect_tta_dataset(items)
    for k in base:
        np.testing.assert_array_equal(base[k]["bboxes"], warmed[k]["bboxes"])
        np.testing.assert_array_equal(base[k]["scores"], warmed[k]["scores"])


def test_pack_vote_rows_drops_invalid_keeps_order_and_pads(pair):
    jr, det = pair
    tr = det._get_tta_runner()
    rng = np.random.default_rng(2)
    dets = []
    for n in (5, 0, 24):
        dets.append((rng.uniform(0, 50, (n, 4)).astype(np.float32),
                     rng.uniform(0, 1, n).astype(np.float32), rng.uniform(size=n) > 0.4))
    got = tr._pack_vote_rows(dets)
    want = jr._pack_vote_rows(dets)
    assert got[0].shape == (3, tr.vote_rows(), 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_odd_pyramid_bucket():
    """A 112 bucket: feature maps 28, 14, 7, 4, 2, 1 and VGG activations
    112 -> 56 -> 28 -> 14 -> 7, so the stride-2 SAME pools and convs see odd
    sizes (asymmetric padding) and ceil-division anchor grids."""
    cfg = tiny_config(buckets=(112,), scales=(0.5, 1.25))
    jr, det = _pair(cfg)
    img = np.random.default_rng(5).integers(0, 255, (90, 75, 3), dtype=np.uint8)
    assert {b for _, b, _ in port_tta.plan_variant_buckets(90, 75, det.config)} == {112}
    _assert_prevote(det._get_tta_runner().collect_variant_dets(img), jr.collect_variant_dets(img))
    _assert_final(det.detect_tta(img), jr.detect_tta(img))


# -- the committed golden ----------------------------------------------------------


@pytest.fixture(scope="module")
def golden_pair():
    sys.path.insert(0, os.path.dirname(FIX))
    from make_mini_wider import tta_golden_config

    golden = np.load(os.path.join(FIX, "goldens", "tta.npz"))
    images = [load_image_rgb(os.path.join(FIX, "WIDER_val", "images", rel))
              for rel in golden["rels"]]
    _, det = _pair(tta_golden_config())
    return golden, images, det


# Box tolerance against the golden, in original-image pixels.  The golden's
# own test allows rtol 1e-4 / atol 1e-3 for the code that wrote it; the JAX
# runner itself now sits 0.02 px from it on a 408-px coordinate.  The port's
# f32 forward sums in another order, and the pyramid's 1 / scale (up to 10
# for a 640-px image in the 64 bucket) multiplies that noise: measured
# 0.0204 px on an 82.6-px coordinate (0.002 px at the network input).
GOLDEN_ATOL = 3e-2


def test_golden_plan_is_bit_exact(golden_pair):
    golden, _, det = golden_pair
    for gi in range(len(golden["rels"])):
        h, w = golden[f"size_{gi}"]
        plan = np.asarray(
            [(v.scale, float(v.flip), v.max_size, v.min_size, float(b), float(c))
             for v, b, c in port_tta.plan_variant_buckets(int(h), int(w), det.config)],
            np.float64,
        )
        np.testing.assert_array_equal(plan, golden[f"plan_{gi}"])


def test_golden_prevote_and_final(golden_pair):
    golden, images, det = golden_pair
    tr = det._get_tta_runner()
    assert len(images) >= 2
    for gi, img in enumerate(images):
        boxes, scores, valid = tr.collect_variant_dets(img)
        np.testing.assert_array_equal(valid, golden[f"prevote_valid_{gi}"])
        np.testing.assert_allclose(boxes, golden[f"prevote_boxes_{gi}"], rtol=1e-4, atol=GOLDEN_ATOL)
        np.testing.assert_allclose(scores, golden[f"prevote_scores_{gi}"], rtol=1e-5, atol=1e-6)
        out = det.detect_tta(img)
        np.testing.assert_allclose(out["bboxes"], golden[f"final_boxes_{gi}"],
                                   rtol=1e-4, atol=GOLDEN_ATOL)
        np.testing.assert_allclose(out["scores"], golden[f"final_scores_{gi}"],
                                   rtol=1e-5, atol=1e-6)
