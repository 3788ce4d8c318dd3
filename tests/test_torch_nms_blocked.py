"""The port's blocked greedy NMS (plain version, the oracle of the CUDA
kernel) against the JAX package: the Pallas blocked kernel in interpret
mode and dan_tpu.ops.nms.greedy_nms, on score-sorted input.  The kept set
(indices, valid) must be identical."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dan_tpu.ops.nms import greedy_nms as jax_greedy_nms
from dan_tpu.ops.nms_blocked_pallas import greedy_nms_blocked as jax_blocked
from dan_tpu_torch.ops import nms_blocked_cuda
from dan_tpu_torch.ops.nms import greedy_nms, topk_select
from dan_tpu_torch.ops.nms_blocked_cuda import (
    greedy_nms_blocked_cuda,
    greedy_nms_blocked_plain,
    kept_to_rank,
)
from dan_tpu_torch.ops.nms_cuda import greedy_nms_rank_plain

torch.set_num_threads(1)


def _sorted_case(seed, n, ties=False):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(2, 40, (n, 2))
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    if ties:
        scores = np.round(scores * 8) / 8
    bs, ss = topk_select(torch.from_numpy(boxes), torch.from_numpy(scores), n)
    return bs.contiguous(), ss.contiguous()


def _assert_same(got, want):
    np.testing.assert_array_equal(np.asarray(got.valid), np.asarray(want.valid))
    np.testing.assert_array_equal(np.asarray(got.indices), np.asarray(want.indices))
    np.testing.assert_array_equal(np.asarray(got.boxes), np.asarray(want.boxes))
    np.testing.assert_array_equal(np.asarray(got.scores), np.asarray(want.scores))


# N below, at and off the multiples of the CUDA tile (64) and the TPU block (128).
@pytest.mark.parametrize(
    "seed,n,thresh",
    [(0, 50, 0.3), (1, 130, 0.5), (2, 300, 0.4), (5, 1000, 0.3), (6, 64, 0.3), (7, 257, 0.3)],
)
def test_vs_pallas_interpret_and_xla(seed, n, thresh):
    bs, ss = _sorted_case(seed, n)
    got = greedy_nms_blocked_plain(bs, ss, thresh, 40)
    jb, js = jnp.asarray(bs.numpy()), jnp.asarray(ss.numpy())
    _assert_same(got, jax_blocked(jb, js, thresh, 40, interpret=True))
    _assert_same(got, jax_greedy_nms(jb, js, thresh, 40))
    _assert_same(got, greedy_nms(bs, ss, thresh, 40))


@pytest.mark.parametrize("score_thr", [0.25, 0.5, 2.0])
def test_score_threshold(score_thr):
    bs, ss = _sorted_case(3, 200, ties=True)  # ties sit right at 0.25 and 0.5
    got = greedy_nms_blocked_plain(bs, ss, 0.3, 40, score_threshold=score_thr)
    want = jax_blocked(jnp.asarray(bs.numpy()), jnp.asarray(ss.numpy()), 0.3, 40,
                       score_threshold=score_thr, interpret=True)
    _assert_same(got, want)
    _assert_same(got, greedy_nms(bs, ss, 0.3, 40, score_threshold=score_thr))
    assert bool((got.scores[got.valid] > score_thr).all())
    assert bool(got.valid.any()) == (score_thr < 1.0)


def test_ranks_equal_the_argmax_loop_kernels_plain_version():
    """The kept mask as ranks equals greedy_nms_rank_plain (the plain
    version of the batched kernel) on the same sorted row, ties included."""
    bs, ss = _sorted_case(4, 500, ties=True)
    for max_out in (20, 750):
        kept = nms_blocked_cuda._kept_plain(bs, ss, 0.3)
        rank = kept_to_rank(kept, max_out)
        want = greedy_nms_rank_plain(bs[None], ss[None], 0.3, max_out)[0]
        assert torch.equal(rank, want)


def test_max_out_exceeds_input_and_empty():
    bs, ss = _sorted_case(9, 20)
    got = greedy_nms_blocked_plain(bs, ss, 0.3, 750)
    assert got.boxes.shape == (750, 4)
    _assert_same(got, jax_blocked(jnp.asarray(bs.numpy()), jnp.asarray(ss.numpy()), 0.3, 750,
                                  interpret=True))
    none = greedy_nms_blocked_plain(torch.zeros((10, 4)), torch.zeros((10,)), 0.3, 5)
    assert not bool(none.valid.any())


def test_wrapper_takes_the_plain_version_on_cpu_and_checks_its_inputs():
    bs, ss = _sorted_case(0, 130)
    nms_blocked_cuda.LAUNCHES = 0
    _assert_same(greedy_nms_blocked_cuda(bs, ss, 0.5, 40), greedy_nms_blocked_plain(bs, ss, 0.5, 40))
    assert nms_blocked_cuda.LAUNCHES == 0
    with pytest.raises(ValueError, match="descending"):
        greedy_nms_blocked_cuda(bs, ss.flip(0), 0.5, 40)
    with pytest.raises(TypeError):
        greedy_nms_blocked_cuda(bs.double(), ss, 0.5, 40)
    with pytest.raises(ValueError):
        greedy_nms_blocked_cuda(bs[None], ss[None], 0.5, 40)
    with pytest.raises(ValueError):
        nms_blocked_cuda._launch(bs, ss, 0.5, 0.0)  # the kernel path refuses CPU tensors
