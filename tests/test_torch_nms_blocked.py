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
from dan_tpu_torch.box.iou import pairwise_iou
from dan_tpu_torch.ops import nms_blocked_cuda
from dan_tpu_torch.ops.nms import greedy_nms, rank_to_result, topk_select
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
        nms_blocked_cuda._launch(bs, ss, 0.5, 0.0, 40)  # the kernel path refuses CPU tensors


# -- the redesigned scan (csrc/nms_blocked.cu pass 2) as a numpy model ------


def _mask_words(bs, thresh):
    """Pass 1: (N, ld) uint64 words, ld the tile count rounded up to even;
    bit b of word (i, c) set when box 64 c + b comes after box i and
    overlaps it with IoU > thresh (the plain version's IoU)."""
    n = bs.shape[0]
    tiles = -(-n // 64)
    ld = (tiles + 1) & ~1
    over = (pairwise_iou(bs, bs) > torch.tensor(thresh)).numpy()
    over &= np.triu(np.ones((n, n), bool), 1)
    padded = np.zeros((n, ld * 64), bool)
    padded[:, :n] = over
    weights = np.uint64(1) << np.arange(64, dtype=np.uint64)
    return (padded.reshape(n, ld, 64).astype(np.uint64) * weights).sum(axis=2, dtype=np.uint64)


def _scan_model(bs, ss, thresh, max_out, score_thr=0.0, wcap=None):
    """The chain of pass 2, step for step: removed words from the scores;
    per tile the diagonal words, a walk over the alive bits only that stops
    at the max_out-th kept box, ranks from the count so far and the popcount
    below the bit, then the kept boxes' words ORed into every later tile,
    from the staged columns c0 .. c0 + w - 1 or, past them, from the mask
    itself.  wcap None: whole rows staged (c0 = 0, w = ld, the kernel's
    stage up to N = 8,192); else c0 = the tile rounded down to even and
    w = min(wcap, ld - c0)."""
    n = ss.shape[0]
    mask = _mask_words(bs, thresh)
    tiles, ld = -(-n // 64), mask.shape[1]
    whole = wcap is None
    out_of_play = np.ones(tiles * 64, bool)
    out_of_play[:n] = ss.numpy() <= np.float32(score_thr)
    removed = [int(sum(1 << b for b in range(64) if out_of_play[t * 64 + b])) for t in range(tiles)]
    rank = np.full(n, -1, np.int32)
    full = (1 << 64) - 1
    count = 0
    if max_out <= 0:
        return torch.from_numpy(rank)
    for r in range(tiles):
        rows = min(64, n - 64 * r)
        c0 = 0 if whole else r & ~1
        w = ld if whole else min(wcap, ld - c0)
        stage = mask[64 * r: 64 * r + rows, c0: c0 + w]
        diag = [int(stage[b, r - c0]) if b < rows else 0 for b in range(64)]
        rem, kept, nk = removed[r], 0, 0
        alive = ~rem & full
        while alive and nk < max_out - count:
            b = (alive & -alive).bit_length() - 1
            kept |= 1 << b
            nk += 1
            rem |= diag[b]
            alive = 0 if b == 63 else ~rem & full & (full << (b + 1))
        for b in range(64):
            if kept >> b & 1:
                rank[64 * r + b] = count + bin(kept & ((1 << b) - 1)).count("1")
        count += nk
        if count >= max_out or r + 1 == tiles:
            break
        for t in range(r + 1, tiles):
            words = [int(stage[b, t - c0]) if t < c0 + w else int(mask[64 * r + b, t])
                     for b in range(64) if kept >> b & 1]
            for word in words:
                removed[t] |= word
    return torch.from_numpy(rank)


def _kept_counts(bs, ss, thresh):
    """Kept boxes of the whole row, and the count kept in tiles 0..k."""
    kept = nms_blocked_cuda._kept_plain(bs, ss, thresh)
    per_tile = np.add.reduceat(kept.numpy().astype(int), np.arange(0, kept.shape[0], 64))
    return int(kept.sum()), np.cumsum(per_tile)


def _nan_case(seed, n):
    bs, ss = _sorted_case(seed, n)
    bs = bs.clone()
    bs[3, 0] = float("nan")  # kept first: a NaN box has IoU 0 with every box
    bs[70, 3] = float("nan")
    bs[130, 1] = float("nan")
    return bs, ss


@pytest.mark.parametrize("case", ["plain", "ties", "nan"])
def test_scan_model_ranks_stop_at_max_out(case):
    """The fused ranks and the stop at max_out: the model's ranks equal
    kept_to_rank of the plain kept mask, and its NMSResult the Pallas
    kernel's (interpret mode), with max_out below the kept count cutting
    inside a tile and exactly at a tile's edge, at 1 and at 0, with whole
    rows staged and with the staged columns of a row capped at 2
    (most words from the mask) and at 6."""
    n, thresh = 600, 0.3
    if case == "nan":
        bs, ss = _nan_case(11, n)
    else:
        bs, ss = _sorted_case(12, n, ties=case == "ties")
    total, upto = _kept_counts(bs, ss, thresh)
    edge = int(upto[2])  # the last kept box of tile 2
    inside = edge + (int(upto[3]) - edge) // 2  # inside tile 3
    assert 0 < edge < inside < int(upto[3]) < total
    jb, js = jnp.asarray(bs.numpy()), jnp.asarray(ss.numpy())
    for max_out in (edge, inside, 1, 0, total, total + 5):
        want = kept_to_rank(nms_blocked_cuda._kept_plain(bs, ss, thresh), max_out)
        for wcap in (None, 2, 6):
            got = _scan_model(bs, ss, thresh, max_out, wcap=wcap)
            assert torch.equal(got, want), (max_out, wcap)
        assert int((got >= 0).sum()) == min(max_out, total)
        if max_out > 0:
            _assert_same(rank_to_result(got, bs, ss, max_out),
                         jax_blocked(jb, js, thresh, max_out, interpret=True))


@pytest.mark.parametrize("score_thr", [0.25, 2.0])
def test_scan_model_score_threshold_and_partial_tile(score_thr):
    """Boxes at or under the score threshold never take part, and the last
    tile's rows past N are out of play (N = 257: one box in tile 4)."""
    bs, ss = _sorted_case(3, 257, ties=True)
    for max_out in (7, 750):
        want = kept_to_rank(nms_blocked_cuda._kept_plain(bs, ss, 0.4, score_thr), max_out)
        assert torch.equal(_scan_model(bs, ss, 0.4, max_out, score_thr), want)
        _assert_same(rank_to_result(want, bs, ss, max_out),
                     jax_blocked(jnp.asarray(bs.numpy()), jnp.asarray(ss.numpy()), 0.4, max_out,
                                 score_threshold=score_thr, interpret=True))


def test_plain_version_on_nan_rows_vs_pallas_and_the_argmax_loop():
    """A row with NaN coordinates: the plain version (the kernel's oracle on
    the card) keeps what the Pallas kernel and greedy_nms_rank_plain keep,
    with max_out below the kept count."""
    bs, ss = _nan_case(13, 300)
    total, upto = _kept_counts(bs, ss, 0.3)
    for max_out in (int(upto[1]), total):
        got = greedy_nms_blocked_plain(bs, ss, 0.3, max_out)
        _assert_same(got, jax_blocked(jnp.asarray(bs.numpy()), jnp.asarray(ss.numpy()), 0.3,
                                      max_out, interpret=True))
        rank = greedy_nms_rank_plain(bs[None], ss[None], 0.3, max_out)[0]
        assert torch.equal(kept_to_rank(nms_blocked_cuda._kept_plain(bs, ss, 0.3), max_out), rank)
