"""The port's NMS against the JAX package's Pallas NMS kernels, run in
interpret mode on the CPU: indices and valid flags must be identical (the
selection is integer logic, so no tolerance).  Cases follow
tests/unit/test_nms_pallas.py: unsorted scores, max_out > N, all-zero
scores, a score threshold."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dan_tpu.ops import nms as jnms
from dan_tpu.ops.nms_batched_pallas import greedy_nms_pallas_batched
from dan_tpu.ops.nms_pallas import greedy_nms_pallas
from dan_tpu_torch.ops import nms_cuda
from dan_tpu_torch.ops.nms import greedy_nms, rank_to_result, topk_select

from tests import oracles

torch.set_num_threads(1)


def _random_boxes(rng, n):
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(2, 40, (n, 2))
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


def _same(got, want):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(want.boxes))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))


@pytest.mark.parametrize(
    "seed,n,thresh,max_out",
    [(0, 50, 0.3, 20), (1, 130, 0.5, 20), (2, 257, 0.4, 20), (9, 20, 0.3, 750)],
)
def test_greedy_nms_vs_pallas_single(seed, n, thresh, max_out):
    rng = np.random.default_rng(seed)
    boxes = _random_boxes(rng, n)
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)  # unsorted
    want = greedy_nms_pallas(
        jnp.asarray(boxes), jnp.asarray(scores), thresh, max_out, interpret=True
    )
    got = greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores), thresh, max_out)
    assert got.boxes.shape == (max_out, 4)
    _same(got, want)


def test_greedy_nms_vs_numpy_oracle():
    rng = np.random.default_rng(3)
    boxes = _random_boxes(rng, 40)
    scores = rng.uniform(0.01, 1.0, 40).astype(np.float32)
    want_idx = oracles.greedy_nms(boxes, scores, 0.3, max_out=10)
    got = greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.3, 10)
    got_idx = got.indices[got.valid].numpy()
    np.testing.assert_array_equal(got_idx, want_idx[: len(got_idx)])


def test_all_zero_scores_and_score_threshold():
    got = greedy_nms(torch.zeros((10, 4)), torch.zeros(10), 0.3, 5)
    want = greedy_nms_pallas(jnp.zeros((10, 4)), jnp.zeros((10,)), 0.3, 5, interpret=True)
    assert not got.valid.any()
    _same(got, want)
    boxes = np.asarray([[0, 0, 10, 10], [20, 20, 30, 30]], np.float32)
    scores = np.asarray([0.9, 0.01], np.float32)
    got = greedy_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.3, 5,
                     score_threshold=0.05)
    want = greedy_nms_pallas(jnp.asarray(boxes), jnp.asarray(scores), 0.3, 5,
                             score_threshold=0.05, interpret=True)
    assert int(got.valid.sum()) == 1
    _same(got, want)


@pytest.mark.parametrize("b,n,thresh,max_out", [(5, 150, 0.4, 25), (3, 20, 0.3, 100)])
def test_batched_rank_vs_pallas_batched(b, n, thresh, max_out):
    """The wrapper on CPU tensors (the plain version) against the batched
    Pallas kernel, rows unsorted."""
    rng = np.random.default_rng(11 + b)
    boxes = np.stack([_random_boxes(rng, n) for _ in range(b)])
    scores = rng.uniform(0.01, 1.0, (b, n)).astype(np.float32)
    want = greedy_nms_pallas_batched(
        jnp.asarray(boxes), jnp.asarray(scores), thresh, max_out, interpret=True
    )
    launches = nms_cuda.LAUNCHES
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    rank = nms_cuda.greedy_nms_rank(tb, ts, thresh, max_out)
    assert nms_cuda.LAUNCHES == launches  # CPU tensors never count a launch
    assert rank.dtype == torch.int32 and rank.shape == (b, n)
    _same(rank_to_result(rank, tb, ts, max_out), want)


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError):
        nms_cuda.greedy_nms_rank(torch.zeros((2, 5, 4)), torch.zeros((2, 6)), 0.3, 5)
    with pytest.raises(TypeError):
        nms_cuda.greedy_nms_rank(torch.zeros((2, 5, 4), dtype=torch.float64),
                                 torch.zeros((2, 5)), 0.3, 5)


@pytest.mark.parametrize("n,k", [(30, 10), (12, 50)])
def test_topk_select_ties(n, k):
    """Many exactly tied scores: the stable order must match JAX's."""
    rng = np.random.default_rng(n)
    boxes = rng.uniform(0, 50, (2, n, 4)).astype(np.float32)
    scores = rng.choice(np.float32([0.0, 0.25, 0.5, 1.0]), (2, n))
    wb, ws = jnms.topk_select(jnp.asarray(boxes), jnp.asarray(scores), k)
    gb, gs = topk_select(torch.from_numpy(boxes), torch.from_numpy(scores), k)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


@pytest.mark.parametrize("n,max_out", [(40, 10), (15, 30)])
def test_rank_to_result(n, max_out):
    rng = np.random.default_rng(max_out)
    boxes = rng.uniform(0, 50, (3, n, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, (3, n)).astype(np.float32)
    rank = np.full((3, n), -1, np.int32)
    for r in range(3):
        kept = rng.choice(n, size=min(n, max_out) - r, replace=False)
        rank[r, kept] = np.arange(len(kept))
    want = jnms.rank_to_result(jnp.asarray(rank), jnp.asarray(boxes), jnp.asarray(scores), max_out)
    got = rank_to_result(torch.from_numpy(rank), torch.from_numpy(boxes),
                         torch.from_numpy(scores), max_out)
    _same(got, want)
