"""The port's anchor matcher against the JAX package: the plain PyTorch
version (the oracle of the CUDA matcher) against both JAX `match_anchors`
and `match_anchors_pallas` in interpret mode, on the cases of
tests/unit/test_matching_pallas.py, plus one case at the train shape
(640x640: A = 34125, G = 256).

cls_target, and matched_gt on positives, must be identical (selection
logic).  matched_iou is held at rtol 1e-6 and loc_target at 1e-5, the JAX
test's own tolerances (float32 division and log).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dan_tpu.box.anchors import generate_anchors_np
from dan_tpu.box.matching import match_anchors as jax_match
from dan_tpu.config import AnchorConfig, MatchConfig
from dan_tpu.ops.matching_pallas import match_anchors_pallas
from dan_tpu_torch.box.anchors import corner_to_center, generate_anchors
from dan_tpu_torch.box.iou import pairwise_iou
from dan_tpu_torch.box.matching import match_anchors, match_anchors_batch
from dan_tpu_torch.ops import matching_cuda

torch.set_num_threads(1)

ACFG = AnchorConfig()


def _random_case(seed, n_gt, img=128, max_gt=16):
    rng = np.random.default_rng(seed)
    gt = np.zeros((max_gt, 4), np.float32)
    mask = np.zeros((max_gt,), bool)
    xy = rng.uniform(0, img - 20, (n_gt, 2))
    wh = rng.uniform(4, img / 2, (n_gt, 2))
    gt[:n_gt] = np.concatenate([xy, np.minimum(xy + wh, img)], -1)
    mask[:n_gt] = True
    return gt, mask


def _port(anchors, gt, mask, cfg):
    return match_anchors(torch.from_numpy(anchors.copy()), torch.from_numpy(gt),
                         torch.from_numpy(mask), cfg, ACFG)


def assert_same_targets(got, want):
    """got: the port's MatchTargets (torch), want: JAX's (arrays)."""
    cls = np.asarray(want.cls_target)
    np.testing.assert_array_equal(got.cls_target.numpy(), cls)
    pos = cls == 1
    np.testing.assert_array_equal(got.matched_gt.numpy()[pos],
                                  np.asarray(want.matched_gt)[pos])
    np.testing.assert_allclose(got.matched_iou.numpy(), np.asarray(want.matched_iou),
                               rtol=1e-6)
    np.testing.assert_allclose(got.loc_target.numpy()[pos],
                               np.asarray(want.loc_target)[pos], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "seed,n_gt,comp", [(0, 3, True), (1, 9, True), (2, 0, True), (3, 5, False), (4, 16, True)]
)
def test_plain_matches_jax_and_pallas(seed, n_gt, comp):
    anchors = generate_anchors_np(ACFG, 128, 128)
    cfg = MatchConfig(max_gt=16, enable_scale_comp=comp)
    gt, mask = _random_case(seed, n_gt)
    got = _port(anchors, gt, mask, cfg)
    args = (jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(mask), cfg, ACFG)
    assert_same_targets(got, jax_match(*args))
    assert_same_targets(got, match_anchors_pallas(*args, interpret=True))
    assert got.cls_target.dtype == torch.int32 and got.matched_gt.dtype == torch.int32


def test_every_valid_gt_matched():
    anchors = generate_anchors_np(ACFG, 128, 128)
    gt, mask = _random_case(7, 10)
    got = _port(anchors, gt, mask, MatchConfig(max_gt=16))
    assert set(range(10)) <= set(got.matched_gt[got.cls_target == 1].tolist())


def test_heavy_ties_grid_aligned_gts():
    """Identical and grid-aligned gts: exact IoU ties across anchors and
    gts, the stress case of the lowest-index tie-breaks."""
    anchors = generate_anchors_np(ACFG, 128, 128)
    gt = np.zeros((16, 4), np.float32)
    mask = np.zeros((16,), bool)
    gt[0] = gt[1] = gt[2] = [32, 32, 64, 64]
    gt[3] = [64, 32, 96, 64]
    gt[4] = [32, 64, 64, 96]
    mask[:5] = True
    cfg = MatchConfig(max_gt=16)
    got = _port(anchors, gt, mask, cfg)
    args = (jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(mask), cfg, ACFG)
    assert_same_targets(got, jax_match(*args))
    assert_same_targets(got, match_anchors_pallas(*args, interpret=True))


def test_batch_gts_beyond_slot_128_and_empty_image():
    """A batch at G = 160: one image with its gts in the first slots, one
    with valid gts at slots 150 and 155, one with no valid gt.  The port
    has no G = 128 dispatch; its batched plain version must equal JAX's
    per-image match_anchors and the Pallas batch dispatch."""
    from dan_tpu.box.matching import match_anchors_batch as jax_batch

    max_gt = 160
    anchors = generate_anchors_np(ACFG, 128, 128)
    cfg = MatchConfig(max_gt=max_gt)
    rng = np.random.default_rng(11)
    gt = np.zeros((3, max_gt, 4), np.float32)
    mask = np.zeros((3, max_gt), bool)
    for b, slots in enumerate([range(5), list(range(3)) + [150, 155], []]):
        for s in slots:
            xy = rng.uniform(0, 100, 2)
            wh = rng.uniform(6, 60, 2)
            gt[b, s] = [*xy, *np.minimum(xy + wh, 128)]
            mask[b, s] = True
    got = match_anchors_batch(torch.from_numpy(anchors.copy()), torch.from_numpy(gt),
                              torch.from_numpy(mask), cfg, ACFG)
    ja = jnp.asarray(anchors)
    want = jax.vmap(lambda b, m: jax_match(ja, b, m, cfg, ACFG))(jnp.asarray(gt), jnp.asarray(mask))
    pallas = jax_batch(ja, jnp.asarray(gt), jnp.asarray(mask), cfg, ACFG,
                       use_pallas=True, interpret=True)
    for i in range(3):
        for ref in (want, pallas):
            assert_same_targets(
                type(got)(*(t[i] for t in got)), type(ref)(*(np.asarray(t)[i] for t in ref))
            )
    assert {150, 155} <= set(got.matched_gt[1][got.cls_target[1] == 1].tolist())
    assert (got.cls_target[2] == 0).all()
    assert torch.isfinite(got.loc_target).all()


def test_train_shape_640():
    """One image at the train shape: A = 34125 anchors, G = 256 slots,
    gts spread over the image including one in slot 200."""
    anchors = generate_anchors_np(ACFG, 640, 640)
    rng = np.random.default_rng(5)
    gt = np.zeros((256, 4), np.float32)
    mask = np.zeros((256,), bool)
    for s in list(range(12)) + [200]:
        xy = rng.uniform(0, 600, 2)
        wh = rng.uniform(4, 200, 2)
        gt[s] = [*xy, *np.minimum(xy + wh, 640)]
        mask[s] = True
    cfg = MatchConfig()
    got = _port(anchors, gt, mask, cfg)
    assert got.cls_target.shape == (34125,)
    args = (jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(mask), cfg, ACFG)
    assert_same_targets(got, jax_match(*args))
    assert 200 in set(got.matched_gt[got.cls_target == 1].tolist())


def test_pairwise_iou_and_centers_match_jax():
    from dan_tpu.box.anchors import corner_to_center as jc2c
    from dan_tpu.box.iou import pairwise_iou as jiou

    rng = np.random.default_rng(3)
    a = rng.uniform(0, 100, (40, 4)).astype(np.float32)
    b = rng.uniform(0, 100, (7, 4)).astype(np.float32)
    b[3] = [10, 10, 10, 30]  # zero area
    np.testing.assert_array_equal(
        pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jiou(jnp.asarray(a), jnp.asarray(b))),
    )
    np.testing.assert_array_equal(
        corner_to_center(torch.from_numpy(a)).numpy(), np.asarray(jc2c(jnp.asarray(a)))
    )


def test_cpu_tensors_take_the_plain_version():
    """match_anchors_batch on CPU tensors never reaches the kernel, and the
    kernel wrapper refuses CPU tensors instead of falling back."""
    anchors = generate_anchors(ACFG, 64, 64)
    gt = torch.zeros((2, 4, 4))
    gt[:, 0] = torch.tensor([8.0, 8.0, 40.0, 40.0])
    mask = torch.zeros((2, 4), dtype=torch.bool)
    mask[:, 0] = True
    before = matching_cuda.LAUNCHES
    out = match_anchors_batch(anchors, gt, mask, MatchConfig(max_gt=4), ACFG)
    assert matching_cuda.LAUNCHES == before
    assert out.cls_target.shape == (2, anchors.shape[0])
    with pytest.raises(ValueError):
        matching_cuda.match_anchors_cuda(anchors, gt, mask, MatchConfig(max_gt=4), ACFG)
