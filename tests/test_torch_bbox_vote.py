"""The port's plain bbox-vote (the oracle of the CUDA kernel) against the
JAX package: dan_tpu.ops.bbox_vote (XLA), the Pallas batched kernel in
interpret mode, and the independent f64 numpy oracle.  `valid` and the
scores must be identical; boxes agree to rtol 1e-5 / atol 1e-4 (the JAX
package's own Pallas-vs-XLA tolerance; the sums are taken in another
order) and to rtol 1e-4 / atol 5e-3 against the f64 oracle."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from dan_tpu.ops.bbox_vote import bbox_vote as jax_vote
from dan_tpu.ops.bbox_vote import bbox_vote_batched as jax_vote_batched
from dan_tpu.ops.bbox_vote_pallas import bbox_vote_pallas_batched
from dan_tpu_torch.ops import bbox_vote_cuda
from dan_tpu_torch.ops.bbox_vote import bbox_vote, bbox_vote_batched
from tests import oracles

torch.set_num_threads(1)


def _random_dets(rng, n):
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(2, 40, (n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    return boxes, scores


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _assert_same(got, want, rtol=1e-5, atol=1e-4):
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(np.asarray(got.scores), np.asarray(want.scores))
    np.testing.assert_allclose(
        np.asarray(got.boxes), np.asarray(want.boxes), rtol=rtol, atol=atol
    )


@pytest.mark.parametrize("seed,n,thresh", [(0, 40, 0.3), (1, 150, 0.4), (3, 257, 0.3)])
def test_single_image_vs_xla(seed, n, thresh):
    rng = np.random.default_rng(seed)
    boxes, scores = _random_dets(rng, n)
    valid = rng.uniform(size=n) > 0.2
    want = jax_vote(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thresh, 20)
    got = bbox_vote(*_t(boxes, scores, valid), thresh, 20)
    assert got.boxes.shape == (20, 4) and got.valid.dtype == torch.bool
    _assert_same(got, want)


@pytest.mark.parametrize("seed,b,n,thresh", [(0, 5, 96, 0.3), (2, 9, 200, 0.4)])
def test_batched_vs_xla_and_pallas_interpret(seed, b, n, thresh):
    rng = np.random.default_rng(seed)
    boxes = np.stack([_random_dets(rng, n)[0] for _ in range(b)])
    scores = rng.uniform(0.01, 1.0, (b, n)).astype(np.float32)
    valid = rng.uniform(size=(b, n)) > 0.3
    valid[1] = False  # an empty row mid-batch
    valid[2, 5:] = False  # a row exhausted long before max_out
    got = bbox_vote_batched(*_t(boxes, scores, valid), thresh, 20)
    args = (jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thresh, 20)
    _assert_same(got, jax_vote_batched(*args))
    _assert_same(got, bbox_vote_pallas_batched(*args, interpret=True))
    assert not bool(got.valid[1].any())
    assert float(got.boxes[1].abs().max()) == 0.0


def _edge(n=96, max_out=20):
    boxes, scores, valid = chip_smoke.vote_edge_rows(np.random.default_rng(7), n)
    got = bbox_vote_batched(*_t(boxes, scores, valid), 0.3, max_out)
    return boxes, scores, valid, got


def test_edge_rows_vs_xla_and_pallas_interpret():
    boxes, scores, valid, got = _edge()
    args = (jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.3, 20)
    _assert_same(got, jax_vote_batched(*args))
    _assert_same(got, bbox_vote_pallas_batched(*args, interpret=True))


@pytest.mark.parametrize("row", range(7))
def test_edge_rows_vs_f64_oracle(row):
    boxes, scores, valid, got = _edge()
    sel = valid[row] & (scores[row] > 0.0)
    dets = np.concatenate([boxes[row][sel], scores[row][sel, None]], axis=1)
    want = oracles.bbox_vote(dets, iou_threshold=0.3, max_out=20)
    n = int(got.valid[row].sum())
    assert n == len(want)
    assert bool(got.valid[row, :n].all())  # outputs fill the front slots
    np.testing.assert_allclose(got.boxes[row, :n].numpy(), want[:, :4], rtol=1e-4, atol=5e-3)
    np.testing.assert_allclose(got.scores[row, :n].numpy(), want[:, 4], rtol=1e-6)
    assert float(got.boxes[row, n:].abs().sum()) == 0.0


def test_edge_row_contents():
    boxes, scores, valid, got = _edge()
    assert not bool(got.valid[1].any())  # the empty row
    assert int(got.valid[2].sum()) == 20  # the full row runs to max_out
    # The pair at IoU exactly 0.3 merges (>=), weights 0.9 and 0.8.
    w = np.float32([0.9, 0.8])
    fused = (boxes[4, :2] * w[:, None]).sum(0) / w.sum()
    np.testing.assert_allclose(got.boxes[4, 0].numpy(), fused, rtol=1e-6)
    assert float(got.scores[4, 0]) == np.float32(0.9)
    assert float(got.scores[4, 1]) < 0.8  # the second of the pair is gone
    # Scores <= 0 never come out, ties resolve to distinct descending outputs.
    assert float(got.scores[5][got.valid[5]].min()) > 0.0
    s3 = got.scores[3][got.valid[3]].numpy()
    assert (s3[:-1] >= s3[1:]).all()


def test_scores_descend_and_output_is_deterministic():
    boxes, scores, valid, got = _edge(n=200, max_out=750)  # max_out > N
    again = bbox_vote_batched(*_t(boxes, scores, valid), 0.3, 750)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    for row in range(7):
        s = got.scores[row][got.valid[row]].numpy()
        assert (s[:-1] >= s[1:]).all()


def test_wrapper_takes_the_plain_version_on_cpu_and_checks_its_inputs():
    boxes, scores, valid, got = _edge()
    bbox_vote_cuda.LAUNCHES = 0
    via = bbox_vote_cuda.bbox_vote_batched_cuda(*_t(boxes, scores, valid), 0.3, 20)
    for a, b in zip(via, got):
        assert torch.equal(a, b)
    one = bbox_vote_cuda.bbox_vote_cuda(*_t(boxes[0], scores[0], valid[0]), 0.3, 20)
    assert torch.equal(one.boxes, got.boxes[0])
    assert bbox_vote_cuda.LAUNCHES == 0  # no kernel launch for CPU tensors
    b, s, v = _t(boxes, scores, valid)
    with pytest.raises(TypeError):
        bbox_vote_cuda.bbox_vote_batched_cuda(b.double(), s, v, 0.3, 20)
    with pytest.raises(TypeError):
        bbox_vote_cuda.bbox_vote_batched_cuda(b, s, v.float(), 0.3, 20)
    with pytest.raises(ValueError):
        bbox_vote_cuda.bbox_vote_batched_cuda(b[:, :-1], s, v, 0.3, 20)
    with pytest.raises(ValueError):
        bbox_vote_cuda._launch(b, s, v, 0.3, 20)  # the kernel path refuses CPU tensors


@pytest.mark.parametrize("thresh", [0.3, 0.0])
def test_nan_coordinates_vs_xla_and_pallas_interpret(thresh):
    """A NaN x1, a NaN y2 and an invalid NaN box: a NaN box has IoU 0 with
    every box, so at 0.3 it merges only itself and at 0 everything merges;
    valid and scores identical to both JAX versions, and the boxes too,
    NaN where theirs are (every box of the row is weighted in their sums,
    so a NaN coordinate reaches every output that does not merge it)."""
    rng = np.random.default_rng(17)
    boxes = np.stack([_random_dets(rng, 120)[0] for _ in range(3)])
    scores = rng.uniform(0.01, 1.0, (3, 120)).astype(np.float32)
    valid = np.ones((3, 120), bool)
    boxes[0, 7, 0] = np.nan
    boxes[0, 30, 3] = np.nan
    boxes[1, 50, 1] = np.nan
    valid[1, 50] = False
    scores[2, 9] = np.nan  # never active
    got = bbox_vote_batched(*_t(boxes, scores, valid), thresh, 40)
    args = (jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thresh, 40)
    for want in (jax_vote_batched(*args), bbox_vote_pallas_batched(*args, interpret=True)):
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
        np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-5,
                                   atol=1e-4, equal_nan=True)
    out = got.boxes.numpy()[got.valid.numpy()]
    assert np.isnan(out).any() and not np.isnan(got.boxes.numpy()[2]).any()


def test_empty_shapes():
    out = bbox_vote_batched(torch.zeros((2, 0, 4)), torch.zeros((2, 0)),
                            torch.zeros((2, 0), dtype=torch.bool), 0.3, 5)
    assert out.boxes.shape == (2, 5, 4) and not bool(out.valid.any())
