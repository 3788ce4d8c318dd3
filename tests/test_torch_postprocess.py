"""The port's anchors, decode and postprocess against the JAX package and
the committed goldens (tests/fixtures/mini_wider/goldens)."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dan_tpu.box.anchors import generate_anchors_np as jax_anchors
from dan_tpu.box.decode import decode_boxes as jax_decode
from dan_tpu.config import AnchorConfig, default_config
from dan_tpu.ops.nms import greedy_nms as jax_greedy_nms
from dan_tpu.ops.postprocess import filter_and_topk as jax_filter_and_topk
from dan_tpu_torch.box.anchors import generate_anchors, generate_anchors_np
from dan_tpu_torch.box.decode import decode_boxes
from dan_tpu_torch.ops.nms import rank_to_result
from dan_tpu_torch.ops.nms_cuda import greedy_nms_rank
from dan_tpu_torch.ops.postprocess import postprocess_batch, postprocess_one

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "fixtures", "mini_wider", "goldens")


def _cfg():
    cfg = default_config()
    return dataclasses.replace(
        cfg, postprocess=dataclasses.replace(cfg.postprocess, use_pallas_nms=False)
    )


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDENS, "model_io.npz")), np.load(
        os.path.join(GOLDENS, "postprocess.npz")
    )


@pytest.mark.parametrize("h,w", [(640, 640), (64, 64), (480, 640), (66, 66)])
def test_anchors_bit_identical(h, w):
    got = generate_anchors_np(AnchorConfig(), h, w)
    want = jax_anchors(AnchorConfig(), h, w)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(generate_anchors(AnchorConfig(), h, w).numpy(), want)
    if (h, w) == (640, 640):
        assert got.shape == (34125, 4)


def test_decode_and_softmax_within_ulps(golden):
    g, _ = golden
    cfg = _cfg()
    anchors = jax_anchors(cfg.anchors, 640, 640)
    loc, cls = g["loc_preds"], g["cls_logits"]
    want = np.asarray(jax_decode(jnp.asarray(loc), jnp.asarray(anchors),
                                 cfg.anchors.prior_scaling, 640.0, 640.0))
    got = decode_boxes(torch.from_numpy(loc), torch.from_numpy(anchors.copy()),
                       cfg.anchors.prior_scaling, 640.0, 640.0).numpy()
    # x1 = cx - w/2 cancels, so count ulps of the operands (640 px), not
    # of the result.
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * np.spacing(np.float32(640)))
    want_s = np.asarray(jax.nn.softmax(jnp.asarray(cls), axis=-1))
    got_s = torch.softmax(torch.from_numpy(cls), dim=-1).numpy()
    # XLA's CPU code flushes denormal results to zero; PyTorch keeps them.
    tiny = np.finfo(np.float32).tiny
    np.testing.assert_array_max_ulp(
        np.where(got_s < tiny, 0, got_s), np.where(want_s < tiny, 0, want_s), maxulp=4
    )


def test_nms_on_jax_topk_bit_identical(golden):
    """JAX's filter_and_topk rows (2, 5000) through the port's NMS and
    through the JAX NMS: identical valid flags and indices."""
    g, _ = golden
    cfg = _cfg()
    post = cfg.postprocess
    anchors = jnp.asarray(jax_anchors(cfg.anchors, 640, 640))

    def prep(c, l):
        s = jax.nn.softmax(c, axis=-1)[:, 1]
        b = jax_decode(l, anchors, cfg.anchors.prior_scaling, 640.0, 640.0)
        return jax_filter_and_topk(b, s, post)

    bk, sk = jax.jit(jax.vmap(prep))(jnp.asarray(g["cls_logits"]), jnp.asarray(g["loc_preds"]))
    want = jax.jit(jax.vmap(
        lambda b, s: jax_greedy_nms(b, s, post.nms_iou_threshold, post.max_detections)
    ))(bk, sk)
    tb, ts = torch.from_numpy(np.array(bk)), torch.from_numpy(np.array(sk))
    rank = greedy_nms_rank(tb, ts, post.nms_iou_threshold, post.max_detections)
    got = rank_to_result(rank, tb, ts, post.max_detections)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))


def test_postprocess_matches_golden(golden):
    """The full port postprocess from the frozen logits: same valid count
    per image, and >= 98% of rows matching the golden detections under the
    criterion of test_golden_drift.py (ulp-level exp/softmax differences
    can flip near-ties)."""
    g, gp = golden
    cfg = _cfg()
    anchors = generate_anchors(cfg.anchors, 640, 640)
    res = postprocess_batch(
        torch.from_numpy(g["cls_logits"]), torch.from_numpy(g["loc_preds"]),
        anchors, cfg.anchors, cfg.postprocess, 640.0, 640.0,
    )
    assert res["bboxes"].shape == (2, 750, 4)
    for b in range(2):
        valid = res["valid"][b].numpy()
        n = int(gp["valid"][b].sum())
        assert int(valid.sum()) == n
        row_ok = (
            np.isclose(res["bboxes"][b, :n].numpy(), gp["boxes"][b, :n], rtol=1e-4, atol=5e-3).all(-1)
            & np.isclose(res["scores"][b, :n].numpy(), gp["scores"][b, :n], rtol=1e-5, atol=1e-5)
        )
        assert row_ok.mean() >= 0.98, (b, int((~row_ok).sum()), n)
    one = postprocess_one(
        torch.from_numpy(g["cls_logits"][1]), torch.from_numpy(g["loc_preds"][1]),
        anchors, cfg.anchors, cfg.postprocess, 640.0, 640.0,
    )
    for k in ("bboxes", "scores", "valid"):
        assert torch.equal(one[k], res[k][1]), k
