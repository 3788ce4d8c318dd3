"""The tile scan of the port's NMS kernel (csrc/nms.cu), proven on the CPU.

A CUDA kernel cannot run here, so the algorithm is written out below as a
small numpy model, step for step as the kernel does it -- the next 64 active
boxes of a sorted row form a tile; diagonal suppression bits; a serial
resolve with the max_out cut; ranks by popcount; one sweep that drops the
later boxes a kept box suppresses and compacts the rest -- and held against
`greedy_nms_rank_plain` and the JAX package's batched Pallas kernel in
interpret mode.  The selection is integer logic on float32 IoUs computed in
one operation order, so every comparison is exact (no tolerance).

A box with a NaN coordinate has IoU 0 with every box in the JAX package
and in the port (NaN-propagating max / min, then the union > 0 guard): rows
with NaN coordinates, sorted and not, give the same ranks through the plain
version, the Pallas kernel in interpret mode and the XLA `greedy_nms`.

Also here: the rule that sends a row to the tile scan (`rows_sorted`), and
what the wrapper refuses.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dan_tpu.ops.nms import greedy_nms
from dan_tpu.ops.nms_batched_pallas import greedy_nms_pallas_batched
from dan_tpu_torch.ops import nms_cuda
from dan_tpu_torch.ops.nms import rank_to_result

torch.set_num_threads(1)

TILE = 64
f32 = np.float32


def _suppresses(boxes, area, j, k, thr):
    """IoU(j, k) > thr in float32, in the kernel's operation order, with
    np.maximum / np.minimum, which return NaN when either operand is NaN as
    the kernel's max / min do (Python's max / min drop a NaN in second
    place)."""
    with np.errstate(invalid="ignore"):
        ix1, iy1 = np.maximum(boxes[j, 0], boxes[k, 0]), np.maximum(boxes[j, 1], boxes[k, 1])
        ix2, iy2 = np.minimum(boxes[j, 2], boxes[k, 2]), np.minimum(boxes[j, 3], boxes[k, 3])
        inter = np.maximum(ix2 - ix1, f32(0)) * np.maximum(iy2 - iy1, f32(0))
        uni = (area[j] + area[k]) - inter
        iou = inter / uni if uni > 0 else f32(0)
    return iou > f32(thr)


def tile_scan_model(boxes, scores, thr, max_out, score_thr=0.0):
    """One sorted row -> (ranks (N,) int32, tiles).  Mirrors tile_scan()."""
    n = len(scores)
    assert all(scores[k] >= scores[k + 1] for k in range(n - 1)), "the row must be sorted"
    with np.errstate(invalid="ignore"):
        area = (np.maximum(boxes[:, 2] - boxes[:, 0], f32(0))
                * np.maximum(boxes[:, 3] - boxes[:, 1], f32(0))).astype(f32)
    rank = np.full(n, -1, np.int32)
    # Boxes with score > score_thr are a prefix of a sorted row.
    act = list(range(int((scores > f32(score_thr)).sum())))
    count = tiles = 0
    while act and count < max_out:
        tiles += 1
        tile, rest = act[:TILE], act[TILE:]
        # a. bit j of sup[i]: tile box i suppresses tile box j > i.
        sup = [sum(1 << j for j in range(i + 1, len(tile))
                   if _suppresses(boxes, area, tile[i], tile[j], thr))
               for i in range(len(tile))]
        # b. resolve in order, up to max_out.
        alive, kept, base = (1 << len(tile)) - 1, 0, count
        while alive and count < max_out:
            i = (alive & -alive).bit_length() - 1
            kept |= 1 << i
            count += 1
            alive &= ~(sup[i] | (1 << i))
        # c. rank = running count + popcount of the kept word below the bit.
        for i in range(len(tile)):
            if kept >> i & 1:
                rank[tile[i]] = base + bin(kept & ((1 << i) - 1)).count("1")
        if count >= max_out:
            break
        # d. the sweep: drop at the first hit, keep the order of the rest.
        kept_boxes = [tile[i] for i in range(len(tile)) if kept >> i & 1]
        act = [k for k in rest
               if not any(_suppresses(boxes, area, j, k, thr) for j in kept_boxes)]
    return rank, tiles


def _boxes(rng, n, clustered=False):
    if clustered:  # many overlaps: boxes jittered around a few centres
        centres = rng.uniform(0, 100, (max(n // 8, 1), 2))
        xy = centres[rng.integers(0, len(centres), n)] + rng.normal(0, 2, (n, 2))
    else:
        xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(2, 40, (n, 2))
    return np.concatenate([xy, xy + wh], axis=-1).astype(f32)


def _sorted_scores(rng, n, values=None):
    s = rng.choice(f32(values), n) if values else rng.uniform(0.01, 1.0, n).astype(f32)
    return np.sort(s)[::-1].copy()


def _edge_rows():
    """name -> (boxes, scores, thr, max_out, score_thr): the sorted rows the
    card check feeds the kernel, at sizes the CPU can take."""
    rng = np.random.default_rng(4)
    rows = {}
    b300, ties = _boxes(rng, 300, clustered=True), _sorted_scores(rng, 300, [1.0, 1.0, 0.9, 0.5])
    rows["ties_at_1"] = (b300, ties, 0.3, 750, 0.0)
    rows["max_out_20_inside_a_tile"] = (b300, ties, 0.3, 20, 0.0)
    rows["max_out_65_past_a_tile_edge"] = (_boxes(rng, 300), _sorted_scores(rng, 300), 0.3, 65, 0.0)
    rows["max_out_64_at_a_tile_edge"] = (_boxes(rng, 300), _sorted_scores(rng, 300), 0.9, 64, 0.0)
    for n in (257, 64, 1):
        rows[f"n_{n}"] = (_boxes(rng, n, clustered=True), _sorted_scores(rng, n), 0.4, 750, 0.0)
    for start in (0, 64, 100):
        s = _sorted_scores(rng, 200)
        s[start:] = 0.0
        rows[f"zeros_from_{start}"] = (_boxes(rng, 200), s, 0.3, 750, 0.0)
    rows["score_threshold_half"] = (_boxes(rng, 257, clustered=True), _sorted_scores(rng, 257),
                                    0.3, 750, 0.5)
    rows["equal_boxes_equal_scores"] = (np.tile(f32([[5, 5, 30, 40]]), (130, 1)),
                                        np.full(130, 0.7, f32), 0.3, 750, 0.0)
    rows["no_overlap_keeps_all"] = (
        (np.arange(150, dtype=f32)[:, None] * 50 + f32([0, 0, 10, 10])), _sorted_scores(rng, 150),
        0.3, 750, 0.0)
    rows["nan_x1_and_y2"] = (_nan_boxes(rng, 300), _sorted_scores(rng, 300), 0.3, 750, 0.0)
    return rows


def _nan_boxes(rng, n):
    """Clustered boxes with a NaN x1 on one box and a NaN y2 on another,
    among the first tile."""
    boxes = _boxes(rng, n, clustered=True)
    boxes[3, 0] = np.nan
    boxes[40, 3] = np.nan
    return boxes


EDGE_ROWS = _edge_rows()


@pytest.mark.parametrize("name", sorted(EDGE_ROWS))
def test_tile_scan_model_equals_plain_and_pallas(name):
    boxes, scores, thr, max_out, score_thr = EDGE_ROWS[name]
    assert bool(nms_cuda.rows_sorted(torch.from_numpy(scores[None]))[0])
    got, tiles = tile_scan_model(boxes, scores, thr, max_out, score_thr)
    tb, ts = torch.from_numpy(boxes[None]), torch.from_numpy(scores[None])
    plain = nms_cuda.greedy_nms_rank_plain(tb, ts, thr, max_out, score_thr)
    np.testing.assert_array_equal(got, plain[0].numpy())
    # The chain is the tiles, never more than one for every 64 boxes.
    assert tiles <= -(-len(scores) // TILE)
    want = greedy_nms_pallas_batched(jnp.asarray(boxes[None]), jnp.asarray(scores[None]), thr,
                                     max_out, score_threshold=score_thr, interpret=True)
    res = rank_to_result(torch.from_numpy(got[None]), tb, ts, max_out)
    np.testing.assert_array_equal(res.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(res.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(res.boxes.numpy(), np.asarray(want.boxes))
    np.testing.assert_array_equal(res.scores.numpy(), np.asarray(want.scores))


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_nan_coordinates_plain_equals_pallas_and_xla(order):
    """A NaN x1 and a NaN y2: both boxes have IoU 0 with every box, in the
    port's plain version as in the JAX package's kernel and XLA version."""
    rng = np.random.default_rng(21)
    boxes, scores = _nan_boxes(rng, 300), _sorted_scores(rng, 300)
    if order == "shuffled":
        perm = rng.permutation(300)
        boxes, scores = boxes[perm], scores[perm]
    tb, ts = torch.from_numpy(boxes[None]), torch.from_numpy(scores[None])
    assert bool(nms_cuda.rows_sorted(ts)[0]) == (order == "sorted")
    rank = nms_cuda.greedy_nms_rank_plain(tb, ts, 0.3, 750)
    got = rank_to_result(rank, tb, ts, 750)
    for want in (greedy_nms_pallas_batched(jnp.asarray(boxes[None]), jnp.asarray(scores[None]),
                                           0.3, 750, interpret=True),
                 greedy_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.3, 750)):
        np.testing.assert_array_equal(got.indices.numpy().reshape(-1),
                                      np.asarray(want.indices).reshape(-1))
        np.testing.assert_array_equal(got.valid.numpy().reshape(-1),
                                      np.asarray(want.valid).reshape(-1))
        np.testing.assert_array_equal(got.scores.numpy().reshape(-1),
                                      np.asarray(want.scores).reshape(-1))
    # The NaN boxes are kept, and suppress nothing: without them every
    # other box keeps its fate.
    nan_rows = np.isnan(boxes).any(axis=1)
    assert (rank[0].numpy()[nan_rows] >= 0).all()
    rest = nms_cuda.greedy_nms_rank_plain(tb[:, ~nan_rows].contiguous(),
                                          ts[:, ~nan_rows].contiguous(), 0.3, 750)
    np.testing.assert_array_equal(rank[0].numpy()[~nan_rows] >= 0, rest[0].numpy() >= 0)


def test_thinning_row_takes_fewer_tiles():
    """A tile is the next 64 ACTIVE boxes: a row that suppression thins out
    is resolved in fewer tiles than N / 64."""
    rng = np.random.default_rng(8)
    boxes, scores = _boxes(rng, 600, clustered=True), _sorted_scores(rng, 600)
    rank, tiles = tile_scan_model(boxes, scores, 0.3, 750)
    plain = nms_cuda.greedy_nms_rank_plain(torch.from_numpy(boxes[None]),
                                           torch.from_numpy(scores[None]), 0.3, 750)
    np.testing.assert_array_equal(rank, plain[0].numpy())
    assert tiles < 600 // TILE


@pytest.mark.parametrize(
    "scores,want",
    [
        ([1.0, 1.0, 0.9, 0.9, 0.2], True),          # ties are in order
        ([0.9, 0.5, 0.0, 0.0, 0.0], True),          # a tail of zeros
        ([0.0, 0.0, 0.0, 0.0, 0.0], True),
        ([0.9, 0.5, 0.6, 0.2, 0.1], False),         # one swapped pair
        ([0.1, 0.2, 0.3, 0.4, 0.5], False),
        ([0.9, float("nan"), 0.3, 0.2, 0.1], False),  # a NaN is never in order
        ([float("nan")] * 5, False),
        ([float("inf"), 1.0, 0.5, -1.0, -float("inf")], True),
    ],
)
def test_rows_sorted_rule(scores, want):
    rows = torch.tensor([scores, [0.5, 0.4, 0.3, 0.2, 0.1]], dtype=torch.float32)
    got = nms_cuda.rows_sorted(rows)
    assert got.dtype == torch.bool and got.tolist() == [want, True]


def test_rows_sorted_one_box_and_paths_unset_on_cpu():
    assert nms_cuda.rows_sorted(torch.tensor([[0.3]])).tolist() == [True]
    # The CPU path launches nothing, so it reports no paths.
    before = nms_cuda.LAST_PATHS
    nms_cuda.greedy_nms_rank(torch.zeros((1, 3, 4)), torch.zeros((1, 3)), 0.3, 5)
    assert nms_cuda.LAST_PATHS is before


@pytest.mark.parametrize("what", ["cpu_tensor", "not_contiguous"])
def test_kernel_launch_refuses(what):
    """A CUDA tensor launches the kernel or raises; the launch itself takes
    nothing else (there is no fallback inside it)."""
    boxes, scores, match = torch.zeros((2, 8, 4)), torch.zeros((2, 8)), "CUDA tensors"
    if what == "not_contiguous":
        boxes, match = torch.zeros((2, 4, 8)).transpose(1, 2), "contiguous"
    with pytest.raises(ValueError, match=match):
        nms_cuda._launch(boxes, scores, 0.3, 5, 0.0)
