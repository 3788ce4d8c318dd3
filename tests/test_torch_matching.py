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


@pytest.mark.parametrize("enable", [True, False])
def test_kernel_params_are_the_plain_versions_scalars(enable):
    """The scalars the CUDA matcher takes: k = min(top-k, A); compensation
    off is k_needs = 0 (no count is < 0); thresholds and prior scaling as
    the float32 values the plain version compares and divides by."""
    mc = MatchConfig(enable_scale_comp=enable)
    p = matching_cuda.kernel_params(mc, ACFG, 34125)
    assert (p.k, p.k_needs) == (6, 6 if enable else 0)
    assert matching_cuda.kernel_params(MatchConfig(scale_comp_topk=9), ACFG, 4).k == 4
    for got, want in ((p.match_threshold, mc.match_threshold),
                      (p.ignore_threshold, mc.ignore_threshold),
                      (p.scale_comp_iou, mc.scale_comp_iou)):
        assert got == float(torch.tensor(want, dtype=torch.float32))
    assert list(p.prior_scaling) == torch.tensor(ACFG.prior_scaling, dtype=torch.float32).tolist()


@pytest.mark.parametrize("enable", [True, False])
def test_kernel_needs_rule_equals_the_plain_version(enable):
    """Pass 1's per-anchor argmax (strict improvements over the valid gts
    from (0, gt 0)) and the count and needs rule of pass 2 (count <
    k_needs), in numpy, against the plain version's own expressions."""
    anchors = generate_anchors(ACFG, 128, 128)
    rng = np.random.default_rng(5)
    cases = [_random_case(s, n) for s, n in ((1, 3), (2, 9), (3, 0), (4, 16))]
    gt = torch.from_numpy(np.stack([c[0] for c in cases]))
    mask = torch.from_numpy(np.stack([c[1] for c in cases]))
    mask[1, 4] = False  # a masked gt between valid ones
    gt[1, 4] = torch.from_numpy(rng.uniform(0, 60, 4).astype(np.float32))
    mc = MatchConfig(max_gt=16, enable_scale_comp=enable)
    p = matching_cuda.kernel_params(mc, ACFG, anchors.shape[0])
    iou = (pairwise_iou(match_corner(anchors), gt) * mask[:, None, :].float()).numpy()
    # The plain version's expressions (box/matching.py::match_anchors).
    raw = iou.max(-1)
    plain_arg = iou.argmax(-1)
    count = np.zeros(mask.shape, np.float32)
    for b in range(len(cases)):
        np.add.at(count[b], plain_arg[b], (raw[b] >= np.float32(mc.match_threshold)).astype(
            np.float32))
    plain_needs = (count < p.k) & mask.numpy() if enable else np.zeros(mask.shape, bool)
    # The kernel's rules.
    kern_best = np.zeros(raw.shape, np.float32)
    kern_arg = np.zeros(raw.shape, np.int64)
    for b in range(len(cases)):
        for g in np.flatnonzero(mask[b].numpy()):
            better = iou[b, :, g] > kern_best[b]
            kern_best[b, better], kern_arg[b, better] = iou[b, better, g], g
    np.testing.assert_array_equal(kern_best, raw)
    np.testing.assert_array_equal(kern_arg[raw > 0], plain_arg[raw > 0])
    kern_count = np.zeros(mask.shape, np.int64)
    for b in range(len(cases)):
        hit = (raw[b] >= np.float32(p.match_threshold)) & (raw[b] > 0)
        np.add.at(kern_count[b], kern_arg[b][hit], 1)
    kern_needs = (kern_count < p.k_needs) & mask.numpy()
    np.testing.assert_array_equal(kern_needs, plain_needs)
    assert kern_needs.any() == enable


def match_corner(anchors):
    from dan_tpu_torch.box.anchors import center_to_corner

    return center_to_corner(anchors)


@pytest.mark.parametrize("what", ["g_0", "g_513", "f64_gts", "float_mask", "strided_gts",
                                  "bad_shape", "no_anchors", "cpu"])
def test_kernel_wrapper_refuses(what):
    """What the CUDA matcher does not take raises before anything is built
    or launched (checked here on CPU tensors; the device is checked last)."""
    anchors = generate_anchors(ACFG, 64, 64)
    gt, mask = torch.zeros((2, 8, 4)), torch.zeros((2, 8), dtype=torch.bool)
    err, match = ValueError, "CUDA tensors"
    if what == "g_0":
        gt, mask, match = gt[:, :0], mask[:, :0], "gt slots"
    elif what == "g_513":
        # More gt slots than one shared-memory chunk holds: taken (the
        # kernel walks the gts in chunks), so only the device check refuses.
        gt, mask = torch.zeros((1, 513, 4)), torch.zeros((1, 513), dtype=torch.bool)
    elif what == "f64_gts":
        gt, err, match = gt.double(), TypeError, "float32"
    elif what == "float_mask":
        mask, err, match = mask.float(), TypeError, "bool"
    elif what == "strided_gts":
        gt, match = torch.zeros((2, 4, 8)).transpose(1, 2), "contiguous"
    elif what == "bad_shape":
        mask, match = mask[:, :5], "expected"
    elif what == "no_anchors":
        anchors, match = anchors[:0], "no anchors"
    before = matching_cuda.LAUNCHES
    with pytest.raises(err, match=match):
        matching_cuda.match_anchors_cuda(anchors, gt, mask, MatchConfig(max_gt=8), ACFG)
    assert matching_cuda.LAUNCHES == before
