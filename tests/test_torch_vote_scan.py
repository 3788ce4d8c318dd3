"""The vote kernel's algorithm (csrc/bbox_vote.cu), proven on the CPU.

A CUDA kernel cannot run here, so the algorithm is written out below as a
numpy model, step for step as the kernel does it -- compact the active
detections; sort them by one 64-bit key (bit-inverted score bits, then the
index); tiles of the next 64 still-active detections with diagonal merge
bits (IoU >= threshold); a serial walk with the max_out cut that gives each
merged tile member its owner's slot; one sweep that gives every later
detection the slot of the first kept one that merges it and compacts the
rest; per-slot weighted sums over the members in index order -- and held
against the port's plain `bbox_vote_batched`, the JAX package's
`bbox_vote_batched` (XLA) and `bbox_vote_pallas_batched` in interpret mode.
`valid` and scores must be identical, boxes within rtol 1e-5 / atol 1e-4
(NaN where the references give NaN), and the model's owner sets must equal
the plain version's step-by-step merge sets exactly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dan_tpu.ops.bbox_vote import bbox_vote_batched as jax_vote_batched
from dan_tpu.ops.bbox_vote_pallas import bbox_vote_pallas_batched
from dan_tpu_torch.box.iou import iou_one_to_many
from dan_tpu_torch.ops.bbox_vote import bbox_vote_batched

torch.set_num_threads(1)

TILE = 64
f32 = np.float32


def _iou(sel, boxes):
    """IoU of one selected (4,) box against (K, 4) boxes in float32, in
    iou_one_to_many's operation order (NaN-propagating max / min)."""
    area = lambda b: (np.maximum(b[..., 2] - b[..., 0], f32(0))  # noqa: E731
                      * np.maximum(b[..., 3] - b[..., 1], f32(0)))
    w = np.maximum(np.minimum(sel[2], boxes[:, 2]) - np.maximum(sel[0], boxes[:, 0]), f32(0))
    h = np.maximum(np.minimum(sel[3], boxes[:, 3]) - np.maximum(sel[1], boxes[:, 1]), f32(0))
    inter = w * h
    uni = (area(sel) + area(boxes)) - inter
    return np.where(uni > 0, inter / np.where(uni > 0, uni, f32(1)), f32(0)).astype(f32)


def vote_scan_model(boxes, scores, valid, thr, max_out):
    """One row -> (out_boxes, out_scores, out_valid, owner (N,) int, tiles).
    Mirrors bbox_vote_kernel: owner[k] is the output slot that detection k
    merges into, -1 if none."""
    n = len(scores)
    thr = f32(thr)
    with np.errstate(invalid="ignore", over="ignore", divide="ignore"):
        # 1. compact and sort: ascending keys are descending scores, lowest
        # index on ties (a positive float's bits keep its order).
        act = np.nonzero(valid & (scores > 0))[0]
        keys = ((~scores[act].view(np.uint32)).astype(np.uint64) << np.uint64(32)) | act.astype(
            np.uint64)
        act = [int(k & np.uint64(0xFFFFFFFF)) for k in np.sort(keys)]
        owner = np.full(n, -1, np.int64)
        count = tiles = 0
        while act and count < max_out:
            tiles += 1
            tile, rest = act[:TILE], act[TILE:]
            # a. bit j of sup[i]: tile member i merges tile member j > i.
            sup = []
            for i in range(len(tile)):
                hits = _iou(boxes[tile[i]], boxes[tile]) >= thr
                sup.append(sum(1 << j for j in range(i + 1, len(tile)) if hits[j]))
            # b. the walk, up to max_out: a kept member's slot is the running
            # count; a member it merges takes that slot.
            alive, kept, base = (1 << len(tile)) - 1, 0, count
            while alive and count < max_out:
                i = (alive & -alive).bit_length() - 1
                hit = sup[i] & alive
                owner[tile[i]] = count
                for j in range(len(tile)):
                    if hit >> j & 1:
                        owner[tile[j]] = count
                kept |= 1 << i
                alive &= ~(hit | (1 << i))
                count += 1
            # d. the sweep (after the cut too): the first kept member that
            # merges a later detection owns it; the rest keep their order.
            kept_ids = [tile[i] for i in range(len(tile)) if kept >> i & 1]
            first = np.full(len(rest), -1)
            for c in range(len(kept_ids) - 1, -1, -1):
                if rest:
                    first[_iou(boxes[kept_ids[c]], boxes[rest]) >= thr] = c
            for e, k in enumerate(rest):
                if first[e] >= 0:
                    owner[k] = base + first[e]
            act = [k for e, k in enumerate(rest) if first[e] < 0]
        # 3 + 4. per-slot sums over the members in index order; a non-finite
        # coordinate of the row that a slot does not merge makes it NaN.
        out_boxes = np.zeros((max_out, 4), f32)
        out_scores = np.zeros(max_out, f32)
        out_valid = np.zeros(max_out, bool)
        bad = (~np.isfinite(boxes)).sum(0)
        for s in range(count):
            mem = np.nonzero(owner == s)[0]
            w = scores[mem]
            sel = mem[np.lexsort((mem, -w.astype(np.float64)))[0]]
            fused = (boxes[mem] * w[:, None]).sum(0, dtype=f32) / max(w.sum(dtype=f32), f32(1e-12))
            out_boxes[s] = np.where(bad > (~np.isfinite(boxes[mem])).sum(0), np.nan, fused)
            out_scores[s] = scores[sel]
            out_valid[s] = True
    return out_boxes, out_scores, out_valid, owner, tiles


def plain_merge_sets(boxes, scores, valid, thr, max_out):
    """The plain version's loop (ops/bbox_vote.py) on one row, recording
    the detections each step merges -> owner (N,) int, -1 if never merged."""
    b, s = torch.from_numpy(boxes[None]), torch.from_numpy(scores[None])
    active = torch.from_numpy(valid[None]) & (s > 0.0)
    thr_t = torch.tensor(thr, dtype=torch.float32)
    col = torch.arange(len(scores))
    owner = np.full(len(scores), -1, np.int64)
    for i in range(max_out):
        if not bool(active.any()):
            break
        masked = torch.where(active, s, torch.tensor(-float("inf")))
        best = masked.max(dim=1).values
        j = torch.where(masked == best[:, None], col, len(scores)).min(dim=1).values
        merge = active & ((iou_one_to_many(b[0, j], b) >= thr_t) | (col == j[:, None]))
        owner[merge[0].numpy()] = i
        active = active & ~merge
    return owner


def _dets(rng, n, clustered=False, spread=4.0):
    if clustered:  # jittered around a few centres: many merges
        centres = rng.uniform(0, 300, (max(n // 12, 1), 2))
        xy = centres[rng.integers(0, len(centres), n)] + rng.normal(0, spread, (n, 2))
    else:
        xy = rng.uniform(0, 300, (n, 2))
    wh = rng.uniform(8, 60, (n, 2))
    return np.concatenate([xy, xy + wh], axis=-1).astype(f32)


def _rows():
    """name -> (boxes (N, 4), scores (N,), valid (N,), thr, max_out)."""
    rng = np.random.default_rng(11)
    rows = {}
    n = 200
    rows["seeded_clusters"] = (_dets(rng, n, True), rng.uniform(0.05, 1, n).astype(f32),
                               rng.uniform(size=n) > 0.2, 0.3, 100)
    rows["seeded_spread"] = (_dets(rng, n), rng.uniform(0.05, 1, n).astype(f32),
                             np.ones(n, bool), 0.4, 100)
    # Eight "variants" of the same 25 detections: equal scores in eight
    # places, the lowest index selects.
    base_b, base_s = _dets(rng, 25, True), rng.choice(f32([0.3, 0.6, 0.9]), 25)
    rows["ties_across_variants"] = (
        np.concatenate([base_b + rng.normal(0, 1.5, (25, 4)).astype(f32) for _ in range(8)]),
        np.tile(base_s, 8), np.ones(200, bool), 0.3, 100)
    # A pair at IoU exactly 0.3 (inter 3, union 10) on top of far boxes.
    far = np.arange(60, dtype=f32)[:, None] * 50 + f32([2000, 0, 2010, 10])
    far[0], far[1] = [0.0, 0.0, 6.5, 1.0], [3.5, 0.0, 10.0, 1.0]
    s_far = rng.uniform(0.05, 0.5, 60).astype(f32)
    s_far[:2] = [0.9, 0.8]
    rows["iou_exactly_the_threshold"] = (far, s_far, np.ones(60, bool), 0.3, 100)
    b, s = _dets(rng, 150, True), rng.uniform(0.05, 1, 150).astype(f32)
    rows["threshold_0"] = (b, s, np.ones(150, bool), 0.0, 100)
    rows["threshold_1"] = (b, s, np.ones(150, bool), 1.0, 100)
    # More than 64 detections active, max_out cutting inside the first tile
    # and inside the second.
    b, s = _dets(rng, 180), rng.uniform(0.05, 1, 180).astype(f32)
    rows["cut_inside_tile_20"] = (b, s, np.ones(180, bool), 0.3, 20)
    rows["cut_inside_tile_70"] = (b, s, np.ones(180, bool), 0.3, 70)
    # One cluster of 150 near-identical boxes: one output, its members in
    # three tiles' worth of detections.
    big = f32([100, 100, 160, 170]) + rng.normal(0, 0.5, (150, 4)).astype(f32)
    rows["one_slot_of_150"] = (big, rng.uniform(0.05, 1, 150).astype(f32), np.ones(150, bool),
                               0.3, 100)
    # NaN boxes: a NaN x1 and a NaN y2 among clusters, one NaN box invalid,
    # and a NaN score (never active).
    b, s = _dets(rng, 160, True), rng.uniform(0.05, 1, 160).astype(f32)
    v = np.ones(160, bool)
    b[5, 0], b[40, 3], b[70, 1] = np.nan, np.nan, np.nan
    v[70] = False
    s[90] = np.nan
    rows["nan_boxes"] = (b, s, v, 0.3, 100)
    # A zero-area detection selected first, and a row with one detection.
    b, s = _dets(rng, 50, True), rng.uniform(0.05, 0.9, 50).astype(f32)
    b[0] = [20.0, 20.0, 20.0, 40.0]
    s[0] = 1.0
    rows["zero_area_selected"] = (b, s, np.ones(50, bool), 0.3, 100)
    rows["one_detection"] = (b[:1].copy(), s[:1].copy(), np.ones(1, bool), 0.3, 100)
    rows["nothing_active"] = (b, s, np.zeros(50, bool), 0.3, 100)
    return rows


ROWS = _rows()


def _assert_same(got, want_boxes, want_scores, want_valid):
    np.testing.assert_array_equal(got[2], np.asarray(want_valid))
    np.testing.assert_array_equal(got[1], np.asarray(want_scores))
    np.testing.assert_allclose(got[0], np.asarray(want_boxes), rtol=1e-5, atol=1e-4,
                               equal_nan=True)


@pytest.mark.parametrize("name", sorted(ROWS))
def test_vote_scan_model_equals_plain_xla_and_pallas(name):
    boxes, scores, valid, thr, max_out = ROWS[name]
    got = vote_scan_model(boxes, scores, valid, thr, max_out)
    owner, tiles = got[3], got[4]
    np.testing.assert_array_equal(owner, plain_merge_sets(boxes, scores, valid, thr, max_out))
    n_active = int((valid & (scores > 0)).sum())
    assert tiles <= -(-n_active // TILE) and (tiles > 0) == (n_active > 0)
    plain = bbox_vote_batched(torch.from_numpy(boxes[None]), torch.from_numpy(scores[None]),
                              torch.from_numpy(valid[None]), thr, max_out)
    _assert_same(got, plain.boxes[0], plain.scores[0], plain.valid[0])
    args = (jnp.asarray(boxes[None]), jnp.asarray(scores[None]), jnp.asarray(valid[None]), thr,
            max_out)
    for want in (jax_vote_batched(*args), bbox_vote_pallas_batched(*args, interpret=True)):
        _assert_same(got, want.boxes[0], want.scores[0], want.valid[0])


def test_rows_hold_their_edges():
    """The edge rows do what their names say, on the model's own output."""
    _, _, v, owner, tiles = vote_scan_model(*ROWS["one_slot_of_150"])
    assert int(v.sum()) == 1 and int((owner == 0).sum()) == 150 and tiles == 1
    b, s, va, thr, _ = ROWS["cut_inside_tile_20"]
    out = vote_scan_model(b, s, va, thr, 20)
    assert int(out[2].sum()) == 20 and out[4] == 1
    out = vote_scan_model(b, s, va, thr, 70)
    assert int(out[2].sum()) == 70 and out[4] == 2
    out = vote_scan_model(*ROWS["threshold_0"])
    assert int(out[2].sum()) == 1  # IoU >= 0 holds for every pair
    out = vote_scan_model(*ROWS["iou_exactly_the_threshold"])
    assert out[3][1] == 0  # the pair at IoU == 0.3 merges
    bx, sc, va, thr, mo = ROWS["nan_boxes"]
    out = vote_scan_model(bx, sc, va, thr, mo)
    assert out[3][90] == -1  # a NaN score is never active
    assert np.isnan(out[0][out[2]][:, [0, 1, 3]]).all()  # every output takes the NaN columns
    assert not np.isnan(out[0][out[2]][:, 2]).any()
    out = vote_scan_model(*ROWS["zero_area_selected"])
    assert out[3][0] == 0 and out[1][0] == f32(1.0)
