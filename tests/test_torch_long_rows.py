"""Rows longer than the kernels' shared memory holds, proven on the CPU.

The NMS kernel (K1/K2) keeps a row of up to 9,557 boxes in shared memory,
the vote kernel (K7/K8) one of up to 7,136 detections, and the matcher
(K3/K4) lists an image's gts 512 slots at a time; past those, each runs a
long-row path (csrc/nms.cu, csrc/bbox_vote.cu, csrc/matching.cu).  Here:

  * the port against the JAX package at configurations above the old
    caps: NMS at pre_nms_topk 12,000, the vote at 8,000 rows (8 variants x
    1,000 detections), the matcher at G = 1,024 with more than 512 valid
    gts in an image;
  * numpy models of the long-row paths, step for step as the kernels take
    them (the row in a scratch array, the current tile staged, the sweeps
    in chunks of 1,024 threads that compact the active list in place, the
    vote's bitonic network with positions past N as +infinity and its
    per-slot sums in lane order, the matcher's running best over chunks of
    gt slots), held against the plain versions at lengths either side of
    a sweep chunk (1,024 entries), of a power of two (the sort) and of one
    chunk of gt slots (512).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dan_tpu.box.anchors import generate_anchors_np as jax_anchors
from dan_tpu.box.decode import decode_boxes as jax_decode
from dan_tpu.box.matching import match_anchors as jax_match
from dan_tpu.config import AnchorConfig as JaxAnchorConfig
from dan_tpu.config import MatchConfig as JaxMatchConfig
from dan_tpu.config import default_config as jax_default_config
from dan_tpu.ops.bbox_vote import bbox_vote_batched as jax_vote_batched
from dan_tpu.ops.nms import greedy_nms as jax_greedy_nms
from dan_tpu.ops.postprocess import filter_and_topk as jax_filter_and_topk
from dan_tpu.ops.postprocess import postprocess_batch as jax_postprocess_batch
import chip_smoke
from dan_tpu_torch.box.anchors import center_to_corner, generate_anchors
from dan_tpu_torch.box.iou import pairwise_iou
from dan_tpu_torch.box.matching import match_anchors
from dan_tpu_torch.config import AnchorConfig, MatchConfig, default_config
from dan_tpu_torch.ops import matching_cuda
from dan_tpu_torch.ops.bbox_vote import bbox_vote_batched
from dan_tpu_torch.ops.nms import rank_to_result
from dan_tpu_torch.ops.nms_cuda import greedy_nms_rank, greedy_nms_rank_plain
from dan_tpu_torch.ops.postprocess import postprocess_batch
from tests.test_torch_vote_scan import plain_merge_sets

torch.set_num_threads(1)

f32 = np.float32
TILE = 64
THREADS = 1024  # a block's threads: the sweeps' chunk
LONG_TOPK = 12000
VOTE_ROWS = 8000  # 8 variants x max_detections 1,000
LONG_GT = 1024


# ---------------------------------------------------------------------------
# the port against the JAX package above the old caps
# ---------------------------------------------------------------------------


def _post(cfg, **fields):
    return dataclasses.replace(cfg, postprocess=dataclasses.replace(
        cfg.postprocess, use_pallas_nms=False, **fields))


def test_nms_at_pre_nms_topk_12000_equals_jax():
    """JAX's softmax / decode / filter_and_topk rows at pre_nms_topk 12,000
    on 2 images of seeded logits, through the port's NMS (the CPU path of
    greedy_nms_rank) and through the JAX package's XLA greedy_nms: valid
    flags, indices, boxes and scores bit for bit."""
    cfg = _post(jax_default_config(), pre_nms_topk=LONG_TOPK)
    post = cfg.postprocess
    rng = np.random.default_rng(17)
    anchors = jnp.asarray(jax_anchors(cfg.anchors, 640, 640))
    cls = jnp.asarray(rng.normal(0, 2, (2, anchors.shape[0], 2)).astype(f32))
    loc = jnp.asarray(rng.normal(0, 0.5, (2, anchors.shape[0], 4)).astype(f32))

    def prep(c, l):
        s = jax.nn.softmax(c, axis=-1)[:, 1]
        return jax_filter_and_topk(jax_decode(l, anchors, cfg.anchors.prior_scaling, 640.0, 640.0),
                                   s, post)

    bk, sk = jax.jit(jax.vmap(prep))(cls, loc)
    assert bk.shape == (2, LONG_TOPK, 4)
    want = jax.jit(jax.vmap(
        lambda b, s: jax_greedy_nms(b, s, post.nms_iou_threshold, post.max_detections)))(bk, sk)
    tb, ts = torch.from_numpy(np.array(bk)), torch.from_numpy(np.array(sk))
    got = rank_to_result(greedy_nms_rank(tb, ts, post.nms_iou_threshold, post.max_detections),
                         tb, ts, post.max_detections)
    assert int(got.valid.sum()) > 2 * 64  # more than a tile a row
    for g, w in zip(got, (want.boxes, want.scores, want.indices, want.valid)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_postprocess_batch_at_pre_nms_topk_12000_equals_jax():
    """postprocess_batch end to end at pre_nms_topk 12,000 against the JAX
    package's postprocess_batch (XLA NMS), bit for bit.  The logits and
    offsets are chosen so that softmax and decode are exact in both
    (scores 0.5 and 1, ties broken by index; offsets 0: each box is its
    anchor, clipped), so the two NMS inputs are the same floats."""
    jcfg = _post(jax_default_config(), pre_nms_topk=LONG_TOPK)
    cfg = _post(default_config(), pre_nms_topk=LONG_TOPK)
    rng = np.random.default_rng(18)
    a_n = jax_anchors(jcfg.anchors, 640, 640).shape[0]
    pick = rng.integers(0, 3, (2, a_n))
    cls = np.zeros((2, a_n, 2), f32)
    cls[..., 1] = np.where(pick == 1, f32(40), 0)  # score 1
    cls[..., 0] = np.where(pick == 2, f32(40), 0)  # score ~0: filtered out
    loc = np.zeros((2, a_n, 4), f32)
    want = jax_postprocess_batch(jnp.asarray(cls), jnp.asarray(loc),
                                 jnp.asarray(jax_anchors(jcfg.anchors, 640, 640)), jcfg.anchors,
                                 jcfg.postprocess, 640.0, 640.0)
    got = postprocess_batch(torch.from_numpy(cls), torch.from_numpy(loc),
                            generate_anchors(cfg.anchors, 640, 640), cfg.anchors,
                            cfg.postprocess, 640.0, 640.0)
    assert int(got["valid"].sum()) > 2 * 64
    for k in ("bboxes", "scores", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def _variant_rows(rng, n_variants, per_variant, n_rows):
    """Vote rows as the TTA stage packs them: n_variants blocks of
    per_variant slots, each block a jittered copy of one set of detections
    with a random count of valid slots at its front."""
    rows = [], [], []
    for _ in range(n_rows):
        centres = rng.uniform(0, 900, (per_variant // 6, 2))
        base = centres[rng.integers(0, len(centres), per_variant)]
        wh = rng.uniform(10, 120, (per_variant, 2))
        bx, sc, va = [], [], []
        for _ in range(n_variants):
            xy = base + rng.normal(0, 3, base.shape)
            bx.append(np.concatenate([xy, xy + wh * rng.uniform(0.9, 1.1, wh.shape)], -1))
            sc.append(rng.uniform(0.05, 1.0, per_variant))
            va.append(np.arange(per_variant) < rng.integers(per_variant // 2, per_variant + 1))
        for lst, parts in zip(rows, (bx, sc, va)):
            lst.append(np.concatenate(parts))
    return (np.stack(rows[0]).astype(f32), np.stack(rows[1]).astype(f32), np.stack(rows[2]))


def test_vote_at_8000_rows_equals_jax():
    """The batched vote at 8,000 rows (8 variants x max_detections 1,000,
    above the kernel's 7,136 in shared memory) against the JAX package's
    bbox_vote_batched: valid flags and scores identical, boxes at rtol 1e-5
    / atol 1e-4."""
    boxes, scores, valid = _variant_rows(np.random.default_rng(19), 8, 1000, 2)
    assert boxes.shape == (2, VOTE_ROWS, 4)
    got = bbox_vote_batched(torch.from_numpy(boxes), torch.from_numpy(scores),
                            torch.from_numpy(valid), 0.3, 1000)
    want = jax_vote_batched(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), 0.3,
                            1000)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-5, atol=1e-4)
    assert int(got.valid.sum(dim=1).min()) > 64


def test_match_anchors_at_g_1024_equals_jax():
    """match_anchors at G = 1,024 on chip_smoke.long_gt_batch (700, 1,024,
    0 and 100 valid gts, the last all past slot 512) on the 128 x 128
    anchor set against the JAX package's match_anchors, per image:
    cls_target, matched_gt and matched_iou bit for bit; loc_target at
    test_torch_matching.py's tolerance (XLA's division and log round the
    encoding a few ulps apart at every G)."""
    anchors = jax_anchors(JaxAnchorConfig(), 128, 128)
    gt, mask = chip_smoke.long_gt_batch(128, np.random.default_rng(20))
    cfg = MatchConfig(max_gt=LONG_GT)
    got = match_anchors(torch.from_numpy(anchors.copy()), torch.from_numpy(gt),
                        torch.from_numpy(mask), cfg, AnchorConfig())
    jcfg = JaxMatchConfig(max_gt=LONG_GT)
    assert int(mask[0].sum()) > 512 and int(mask[1].sum()) > 512
    for b in range(len(gt)):
        want = jax_match(jnp.asarray(anchors), jnp.asarray(gt[b]), jnp.asarray(mask[b]), jcfg,
                         JaxAnchorConfig())
        for name in ("cls_target", "matched_gt", "matched_iou"):
            np.testing.assert_array_equal(getattr(got, name)[b].numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)
        np.testing.assert_allclose(got.loc_target[b].numpy(), np.asarray(want.loc_target),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# numpy models of the long-row paths
# ---------------------------------------------------------------------------


def _area(b):
    with np.errstate(invalid="ignore"):
        return (np.maximum(b[..., 2] - b[..., 0], f32(0))
                * np.maximum(b[..., 3] - b[..., 1], f32(0))).astype(f32)


def _iou_one(sel, sel_area, boxes, areas):
    """IoU of one selected box against (K, 4) boxes in float32, selected
    box first, NaN-propagating max / min, the union > 0 guard."""
    with np.errstate(invalid="ignore", divide="ignore"):
        w = np.maximum(np.minimum(sel[2], boxes[:, 2]) - np.maximum(sel[0], boxes[:, 0]), f32(0))
        h = np.maximum(np.minimum(sel[3], boxes[:, 3]) - np.maximum(sel[1], boxes[:, 1]), f32(0))
        inter = w * h
        uni = (sel_area + areas) - inter
        return np.where(uni > 0, inter / np.where(uni > 0, uni, f32(1)), f32(0)).astype(f32)


def _beats(v, i, w, j):
    return v > w or (v == w and i < j)


def _compact(act, m, tn, live_of):
    """The sweep of the tile scans over act[tn:m] in chunks of THREADS, in
    place: each chunk reads its entries, then the live ones move to the
    front in order.  Every write lands on an entry that this chunk or an
    earlier one has read.  -> the new length."""
    out = 0
    for e0 in range(tn, m, THREADS):
        e = np.arange(e0, min(e0 + THREADS, m))
        vals = act[e].copy()
        live = live_of(vals)
        pos = out + np.cumsum(live) - live
        assert (pos[live] <= e[live]).all() and (pos[live] < e0 + THREADS).all()
        act[pos[live]] = vals[live]
        out += int(live.sum())
    return out


def nms_long_row_model(boxes, scores, thr, max_out, score_thr=0.0):
    """One row of nms_rank_kernel<true> -> (ranks, path, tiles): the row in a
    (6, N) scratch array, the key row doubling as the list of active boxes
    on the tile scan; the argmax loop with each thread's running best."""
    n = len(scores)
    thr = f32(thr)
    scratch = np.empty((6, n), f32)
    scratch[:4] = boxes.T
    scratch[4] = _area(boxes)
    with np.errstate(invalid="ignore"):
        keys = np.where(scores > f32(score_thr), scores, -np.inf).astype(f32)
        is_sorted = bool(np.all(scores[:-1] >= scores[1:]))
    scratch[5] = keys
    rank = np.full(n, -1, np.int32)
    box_of = lambda idx: scratch[:4, idx].T  # noqa: E731
    if not is_sorted:
        # The argmax loop: thread t holds the best (key, index) of its
        # entries k = t, t + 1024, ...; the block argmax takes the best of
        # the threads' bests.
        key = scratch[5]
        rows = -(-n // THREADS)
        for step in range(max_out):
            grid = np.full(rows * THREADS, -np.inf, f32)
            grid[:n] = key
            grid = grid.reshape(rows, THREADS)  # [c, t]: entry k = c * 1024 + t
            top = grid.max(axis=0)
            mine = np.argmax(grid == top, axis=0) * THREADS + np.arange(THREADS)
            best_v, best_i = -np.inf, n
            for t in np.flatnonzero(top > -np.inf):
                if _beats(top[t], mine[t], best_v, best_i):
                    best_v, best_i = top[t], mine[t]
            if best_v == -np.inf:
                break
            j = int(best_i)
            rank[j] = step
            iou = _iou_one(scratch[:4, j], scratch[4, j], box_of(slice(None)), scratch[4])
            hit = ~np.isneginf(key) & ((np.arange(n) == j) | (iou > thr))
            key[hit] = -np.inf
        return rank, 2, 0
    # The tile scan.  Boxes with score > score_thr are a prefix.
    n_live = int((keys > -np.inf).sum())
    act = scratch[5].view(np.int32)
    act[:n_live] = np.arange(n_live)
    m, count, tiles = n_live, 0, 0
    while m > 0 and count < max_out:
        tiles += 1
        tn = min(TILE, m)
        # The tile staged: its boxes and areas copied out of the scratch.
        t_box, t_area = box_of(act[:tn]).copy(), scratch[4, act[:tn]].copy()
        sup = [sum(1 << int(j) for j in np.flatnonzero(_iou_one(t_box[i], t_area[i], t_box, t_area)
                                                  > thr) if j > i) for i in range(tn)]
        alive, kept, base = (1 << tn) - 1, 0, count
        while alive and count < max_out:
            i = (alive & -alive).bit_length() - 1
            kept |= 1 << i
            count += 1
            alive &= ~(sup[i] | (1 << i))
        kept_ids = [i for i in range(tn) if kept >> i & 1]
        for c, i in enumerate(kept_ids):
            rank[act[i]] = base + c
        if count >= max_out:
            break
        k_box, k_area = t_box[kept_ids], t_area[kept_ids]

        def live_of(idx):
            b, a = box_of(idx), scratch[4, idx]
            hit = np.zeros(len(idx), bool)
            for c in range(len(kept_ids)):
                hit |= _iou_one(k_box[c], k_area[c], b, a) > thr
            return ~hit

        m = _compact(act, m, tn, live_of)
    return rank, 3, tiles


def _nms_rows(rng, n, clustered=True):
    if clustered:
        centres = rng.uniform(0, 200, (max(n // 10, 1), 2))
        xy = centres[rng.integers(0, len(centres), n)] + rng.normal(0, 3, (n, 2))
    else:
        xy = rng.uniform(0, 400, (n, 2))
    wh = rng.uniform(4, 40, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(f32)


# Lengths either side of one sweep chunk (1,024) and of two.
@pytest.mark.parametrize("n", [1023, 1025, 2049])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_nms_long_row_model_equals_plain(n, order):
    rng = np.random.default_rng(n)
    boxes = _nms_rows(rng, n, clustered=order == "sorted")
    scores = np.sort(rng.uniform(0.01, 1, n).astype(f32))[::-1].copy()
    scores[n * 7 // 10:] = 0.0  # a tail that never takes part
    boxes[7, 0] = np.nan  # a NaN x1 on a kept box
    max_out = 750
    if order == "shuffled":
        perm = rng.permutation(n)
        boxes, scores, max_out = boxes[perm], scores[perm], 60
    got, path, tiles = nms_long_row_model(boxes, scores, 0.3, max_out)
    assert path == (3 if order == "sorted" else 2)
    plain = greedy_nms_rank_plain(torch.from_numpy(boxes[None]), torch.from_numpy(scores[None]),
                                  0.3, max_out)
    np.testing.assert_array_equal(got, plain[0].numpy())
    if order == "sorted":
        assert 0 < tiles <= -(-n // TILE)


def test_nms_long_row_model_max_out_cut_and_score_threshold():
    rng = np.random.default_rng(3)
    boxes = _nms_rows(rng, 1500, clustered=False)
    scores = np.sort(rng.uniform(0.01, 1, 1500).astype(f32))[::-1].copy()
    for max_out, score_thr in ((70, 0.0), (750, 0.5)):
        got, _, _ = nms_long_row_model(boxes, scores, 0.4, max_out, score_thr)
        plain = greedy_nms_rank_plain(torch.from_numpy(boxes[None]),
                                      torch.from_numpy(scores[None]), 0.4, max_out, score_thr)
        np.testing.assert_array_equal(got, plain[0].numpy())


def bitonic_sort(key, n):
    """sort_keys of csrc/bbox_vote.cu on key[0, n): the bitonic network of
    the next power of two, the smaller key to the lower position, positions
    >= n neither read nor written."""
    lg = max(int(n - 1).bit_length(), 0) if n > 1 else 0
    half = (1 << lg) >> 1
    q = np.arange(half, dtype=np.int64)
    for lk in range(1, lg + 1):
        for lj in range(lk - 1, -1, -1):
            j = 1 << lj
            lo = ((q >> lj) << (lj + 1)) | (q & (j - 1))
            hi = lo ^ ((1 << lk) - 1) if lj == lk - 1 else lo + j
            ok = hi < n
            a, b = key[lo[ok]], key[hi[ok]]
            swap = b < a
            key[lo[ok][swap]], key[hi[ok][swap]] = b[swap], a[swap]


@pytest.mark.parametrize("n", [1, 2, 63, 1024, 1025, 7137, 8000])
def test_bitonic_network_sorts_every_length(n):
    rng = np.random.default_rng(n)
    key = rng.permutation(np.arange(n, dtype=np.uint64) * np.uint64(2654435761)) | (
        np.uint64(1) << np.uint64(40))
    tail = np.full(5, 7, np.uint64)  # past n: never read or written
    buf = np.concatenate([key, tail])
    bitonic_sort(buf, n)
    np.testing.assert_array_equal(buf[:n], np.sort(key))
    np.testing.assert_array_equal(buf[n:], tail)


def _warp_sum(v):
    """__shfl_xor_sync tree of warp_sum on 32 lanes' float32 partials."""
    v = v.astype(f32).copy()
    for off in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ off]).astype(f32)
    return v[0]


def vote_long_row_model(boxes, scores, valid, thr, max_out, rng):
    """One row of bbox_vote_kernel<true> -> (out_boxes, out_scores, out_valid,
    owner, tiles): keys appended in an arbitrary order (rng) and sorted by
    the bitonic network, the tile scan with the tile staged, the sweep in
    chunks of 1,024 compacting in place, the members keyed (slot, index)
    and sorted again, one warp a slot summing in lane order."""
    r = len(scores)
    thr = f32(thr)
    area = _area(boxes)
    with np.errstate(invalid="ignore"):
        active = np.flatnonzero(valid & (scores > 0))
    bits = scores.view(np.uint32)
    key = np.zeros(r, np.uint64)
    appended = rng.permutation(active)
    key[:len(active)] = ((~bits[appended]).astype(np.uint64) << np.uint64(32)) | appended.astype(
        np.uint64)
    bitonic_sort(key, len(active))
    act = (key[:len(active)] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    owner = np.full(r, -1, np.int64)
    m, count, tiles = len(active), 0, 0
    out_scores = np.zeros(max_out, f32)
    out_valid = np.zeros(max_out, bool)
    while m > 0 and count < max_out:
        tiles += 1
        tn = min(TILE, m)
        t_box, t_area = boxes[act[:tn]].copy(), area[act[:tn]].copy()
        sup = [sum(1 << int(j) for j in np.flatnonzero(_iou_one(t_box[i], t_area[i], t_box, t_area)
                                                  >= thr) if j > i) for i in range(tn)]
        alive, kept, base = (1 << tn) - 1, 0, count
        while alive and count < max_out:
            i = (alive & -alive).bit_length() - 1
            hit = sup[i] & alive
            for j in range(tn):
                if j == i or hit >> j & 1:
                    owner[act[j]] = count
            kept |= 1 << i
            alive &= ~(hit | (1 << i))
            count += 1
        kept_ids = [i for i in range(tn) if kept >> i & 1]
        for c, i in enumerate(kept_ids):
            out_scores[base + c], out_valid[base + c] = scores[act[i]], True
        k_box, k_area = t_box[kept_ids], t_area[kept_ids]

        def live_of(idx):
            first = np.full(len(idx), -1)
            for c in range(len(kept_ids) - 1, -1, -1):
                first[_iou_one(k_box[c], k_area[c], boxes[idx], area[idx]) >= thr] = c
            owner[idx[first >= 0]] = base + first[first >= 0]
            return first < 0

        m = _compact(act, m, tn, live_of)
    # Members keyed (slot << 32 | index), appended in any order, sorted.
    mem = rng.permutation(np.flatnonzero(owner >= 0))
    mkey = (owner[mem].astype(np.uint64) << np.uint64(32)) | mem.astype(np.uint64)
    bitonic_sort(mkey, len(mkey))
    slot = (mkey >> np.uint64(32)).astype(np.int64)
    idx = (mkey & np.uint64(0xFFFFFFFF)).astype(np.int64)
    out_boxes = np.zeros((max_out, 4), f32)
    bad = (~np.isfinite(boxes)).sum(0)
    with np.errstate(invalid="ignore", over="ignore"):
        for s in range(count):
            run = idx[slot == s]
            lanes = np.zeros((5, 32), f32)
            for p, k in enumerate(run):
                w = scores[k]
                part = np.array([w, boxes[k, 0] * w, boxes[k, 1] * w, boxes[k, 2] * w,
                                 boxes[k, 3] * w], f32)
                lanes[:, p % 32] = (lanes[:, p % 32] + part).astype(f32)
            aw, *ax = (_warp_sum(lanes[c]) for c in range(5))
            wsum = max(aw, f32(1e-12))
            mb = (~np.isfinite(boxes[run])).sum(0)
            out_boxes[s] = [np.nan if bad[c] > mb[c] else f32(ax[c]) / wsum for c in range(4)]
    return out_boxes, out_scores, out_valid, owner, tiles


@pytest.mark.parametrize("n", [1023, 1025, 2100])
def test_vote_long_row_model_equals_plain(n):
    """Rows of 8 variants either side of a sweep chunk, with a NaN x1 and a
    NaN score: owners equal the plain version's merge sets, valid and
    scores identical, boxes at rtol 1e-5 / atol 1e-4; two arbitrary append
    orders give the same bits."""
    boxes, scores, valid = _variant_rows(np.random.default_rng(n), 8, -(-n // 8), 1)
    boxes, scores, valid = boxes[0, :n].copy(), scores[0, :n].copy(), valid[0, :n].copy()
    boxes[3, 0] = np.nan
    scores[11] = np.nan
    max_out = 100
    got = vote_long_row_model(boxes, scores, valid, 0.3, max_out, np.random.default_rng(1))
    again = vote_long_row_model(boxes, scores, valid, 0.3, max_out, np.random.default_rng(2))
    for a, b in zip(got, again):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(got[3], plain_merge_sets(boxes, scores, valid, 0.3, max_out))
    plain = bbox_vote_batched(torch.from_numpy(boxes[None]), torch.from_numpy(scores[None]),
                              torch.from_numpy(valid[None]), 0.3, max_out)
    np.testing.assert_array_equal(got[2], plain.valid[0].numpy())
    np.testing.assert_array_equal(got[1], plain.scores[0].numpy())
    np.testing.assert_allclose(got[0], plain.boxes[0].numpy(), rtol=1e-5, atol=1e-4,
                               equal_nan=True)
    n_active = int((valid & (scores > 0)).sum())
    assert 0 < got[4] <= -(-n_active // TILE)


def matcher_chunked_model(anchors_center, gt, mask, cfg, acfg, chunk):
    """Passes 1a and 2 of csrc/matching.cu over gt slots in chunks of
    `chunk`: each chunk's valid gts in ascending order, a running (best,
    gt) from (0, gt 0) taking strict improvements only.  Pass 1b's per-gt
    statistics (best anchor, count, k-th entry) do not depend on the
    chunks and are taken from their definitions.  -> cls_target,
    matched_gt, matched_iou as numpy."""
    iou = pairwise_iou(center_to_corner(anchors_center), gt).numpy()  # (B, A, G)
    bsz, a_n, g_n = iou.shape
    p = matching_cuda.kernel_params(cfg, acfg, a_n)
    cls = np.zeros((bsz, a_n), np.int32)
    mgt = np.zeros((bsz, a_n), np.int32)
    miou = np.zeros((bsz, a_n), f32)
    a_idx = np.arange(a_n)
    for b in range(bsz):
        best, arg = np.zeros(a_n, f32), np.zeros(a_n, np.int64)
        for g0 in range(0, g_n, chunk):
            for g in np.flatnonzero(mask[b, g0:g0 + chunk]) + g0:
                better = iou[b, :, g] > best
                best[better], arg[better] = iou[b, better, g], g
        raw = best
        hit = (raw >= f32(p.match_threshold)) & (raw > 0)
        count = np.bincount(arg[hit], minlength=g_n)
        aug_best, aug_arg = np.zeros(a_n, f32), np.zeros(a_n, np.int64)
        for g0 in range(0, g_n, chunk):
            for g in np.flatnonzero(mask[b, g0:g0 + chunk]) + g0:
                col = iou[b, :, g]
                order = np.lexsort((a_idx, -col.astype(np.float64)))
                kv, ki = col[order[p.k - 1]], order[p.k - 1]
                forced = (a_idx == order[0]).astype(f32)
                in_topk = (col > kv) | ((col == kv) & (a_idx <= ki))
                comp = ((count[g] < p.k_needs) & in_topk & (col > f32(p.scale_comp_iou))).astype(f32)
                aug = ((col + f32(2) * forced) + np.minimum(comp, f32(1))).astype(f32)
                better = aug > aug_best
                aug_best[better], aug_arg[better] = aug[better], g
        positive = aug_best >= f32(p.match_threshold)
        ignore = (raw >= f32(p.ignore_threshold)) & (raw < f32(p.match_threshold)) & ~positive
        cls[b] = np.where(positive, 1, np.where(ignore, -1, 0))
        mgt[b], miou[b] = aug_arg, raw
    return cls, mgt, miou


@pytest.mark.parametrize("g_n,chunk", [(511, 512), (512, 512), (513, 512), (1024, 512),
                                       (200, 64)])
def test_matcher_chunked_model_equals_plain(g_n, chunk):
    """The chunked passes against the plain match_anchors at G either side
    of one chunk, at two chunks, and over many small chunks, on
    chip_smoke.long_gt_batch cut to G slots, with a copy of gt 5 in the
    last slot (a tie across chunks) and a masked gt between valid ones."""
    gt, mask = chip_smoke.long_gt_batch(128, np.random.default_rng(g_n))
    gt, mask = gt[:, :g_n].copy(), mask[:, :g_n].copy()
    gt[0, g_n - 1], mask[0, g_n - 1] = gt[0, 5], True
    mask[1, 3] = False
    anchors = generate_anchors(AnchorConfig(), 128, 128)
    cfg = MatchConfig(max_gt=g_n)
    got = matcher_chunked_model(anchors, torch.from_numpy(gt), mask, cfg, AnchorConfig(), chunk)
    want = match_anchors(anchors, torch.from_numpy(gt), torch.from_numpy(mask), cfg,
                         AnchorConfig())
    np.testing.assert_array_equal(got[0], want.cls_target.numpy())
    np.testing.assert_array_equal(got[1], want.matched_gt.numpy())
    np.testing.assert_array_equal(got[2], want.matched_iou.numpy())
