"""Host input pipeline: file I/O + JPEG decode + scalar crop sampling only
(the port's copy of dan_tpu/data/pipeline.py, on its numpy/cv2 path).

The counterpart of the reference's tf.data input_fn (SURVEY.md §3.1): the
host never resamples pixels — it decodes JPEGs, pads them into fixed uint8
canvases, samples data-anchor crop parameters, and hands batches to the
device, where dan_tpu_torch.ops.preprocess does all the math inside the
train step.  A worker pool overlaps decode with device compute, and
`device_prefetch` the host-to-device copy.  The original's C++ batch
decoder (dan_tpu/native/loader.cc) is not copied: every batch takes the
per-image cv2 decode, which yields the same batches.

Batch contract (all fixed shapes):
    canvas    (B, C, C, 3) uint8   padded source image
    crop_x0   (B,) f32             data-anchor crop window (source pixels)
    crop_y0   (B,) f32
    crop_size (B,) f32
    boxes     (B, G, 4) f32        gt corner boxes in canvas pixels
    mask      (B, G) bool
    seed      (B,) uint32          per-image augmentation seed
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from dan_tpu_torch.config import DANConfig
from dan_tpu_torch.data.augment import sample_data_anchor_crop
from dan_tpu_torch.data.widerface import ImageRecord, load_image_rgb


def _window_params(
    record: ImageRecord, w: int, h: int, c: int, rng
) -> Tuple[int, int]:
    """Canvas-window origin for an oversized image: slide the window to
    contain a random face (host-side CROP is allowed; host-side RESAMPLING
    is not). (0, 0) when the image fits."""
    if h <= c and w <= c:
        return 0, 0
    boxes = record.boxes
    if len(boxes):
        i = int(rng.integers(len(boxes)))
        cx = float(boxes[i, 0] + boxes[i, 2]) / 2
        cy = float(boxes[i, 1] + boxes[i, 3]) / 2
    else:
        cx, cy = w / 2, h / 2
    off_x = int(np.clip(cx - c / 2, 0, max(w - c, 0)))
    off_y = int(np.clip(cy - c / 2, 0, max(h - c, 0)))
    return off_x, off_y


def _finish_sample(
    record: ImageRecord,
    config: DANConfig,
    rng,
    off_x: int,
    off_y: int,
    w: int,
    h: int,
) -> Dict[str, np.ndarray]:
    """Box bookkeeping + crop-parameter sampling for one sample whose
    canvas pixels are already placed ((w, h) = placed size after the
    (off_x, off_y) window). Consumes `rng` in the same order for every
    sample."""
    c = config.preprocess.canvas_size
    boxes = record.boxes.copy()
    if off_x or off_y:
        boxes[:, [0, 2]] -= off_x
        boxes[:, [1, 3]] -= off_y

    # Keep boxes whose center survived the canvas window.
    if len(boxes):
        cxs = (boxes[:, 0] + boxes[:, 2]) / 2
        cys = (boxes[:, 1] + boxes[:, 3]) / 2
        keep = (cxs >= 0) & (cxs < w) & (cys >= 0) & (cys < h)
        boxes = np.clip(boxes[keep], 0, c)

    x0, y0, size = sample_data_anchor_crop(rng, boxes, h, w, config.preprocess)

    g = config.match.max_gt
    out_boxes = np.zeros((g, 4), np.float32)
    out_mask = np.zeros((g,), bool)
    n = min(len(boxes), g)
    out_boxes[:n] = boxes[:n]
    out_mask[:n] = True
    return {
        "crop_x0": np.float32(x0),
        "crop_y0": np.float32(y0),
        "crop_size": np.float32(size),
        "boxes": out_boxes,
        "mask": out_mask,
        "seed": np.uint32(rng.integers(0, 2**31)),
    }


def _prepare_sample(
    record: ImageRecord,
    config: DANConfig,
    seed: int,
    image: Optional[np.ndarray] = None,
) -> Dict[str, np.ndarray]:
    """Decode + pad one record into the batch contract (one sample, cv2
    decode)."""
    rng = np.random.default_rng(seed)
    img = image if image is not None else load_image_rgb(record.path)
    c = config.preprocess.canvas_size
    h, w = img.shape[:2]
    off_x, off_y = _window_params(record, w, h, c, rng)
    if off_x or off_y or h > c or w > c:
        img = img[off_y : off_y + c, off_x : off_x + c]
        h, w = img.shape[:2]
    canvas = np.zeros((c, c, 3), np.uint8)
    canvas[:h, :w] = img
    out = _finish_sample(record, config, rng, off_x, off_y, w, h)
    out["canvas"] = canvas
    return out


def _collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _put_or_stop(q, item, stop) -> bool:
    """put() that keeps checking the stop flag so a closed consumer can't
    strand the worker (and its device-resident payload) forever."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.5)
            return True
        except queue.Full:
            continue
    return False


def iter_prefetch(items, depth: int = 2, transform=None):
    """Run an iterator (plus an optional per-item `transform`) on a
    background thread, staying `depth` items ahead of the consumer.

    The eval CLI uses it to overlap host JPEG decode with device TTA work
    (decode releases the GIL, and the consumer's blocking device fetches
    leave the core idle otherwise).  Worker exceptions propagate to the consumer
    (they must not read as a clean end-of-stream); closing the consumer
    unblocks and stops the worker.
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END = object()

    def worker():
        try:
            for it in items:
                if stop.is_set():
                    return
                if transform is not None:
                    it = transform(it)
                if not _put_or_stop(q, it, stop):
                    return
            _put_or_stop(q, _END, stop)
        except BaseException as e:  # propagate, don't die silently
            _put_or_stop(q, e, stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def device_prefetch(batches, device, depth: int = 2):
    """Copy each batch's arrays to `device` on a background thread, `depth`
    batches ahead of the consumer (the counterpart of the JAX package's
    device_prefetch; on N ranks, each rank prefetches its own rows to its
    own device, mesh.device).  Yields dicts of device tensors with the
    host `seed` array kept, which train_step takes as they are.  On a card
    the thread pins each batch and queues its copy on the current stream,
    ahead of the steps that read it."""
    import torch  # not for the host-only users of this module

    from dan_tpu_torch.train.loop import to_device

    device = torch.device(device)

    def move(batch):
        if device.type == "cuda":
            # The thread's own current device, or pinning would open a
            # context on card 0 for every rank.
            torch.cuda.set_device(device)
        return dict(to_device(batch, device), seed=batch["seed"])

    return iter_prefetch(batches, depth=depth, transform=move)


class TrainPipeline:
    """Infinite shuffled loader over ImageRecords with threaded decode.

    `num_producers` producer threads each build WHOLE batches, striped by
    step (producer k builds steps k, k+K, k+2K, ...), and the
    consumer round-robins their queues so the yielded batch sequence is
    step-ordered and BIT-IDENTICAL for every K (tested): per-step sample
    seeds were already step-derived, and the shuffle is a per-epoch
    permutation derived from (seed, epoch) rather than a serially
    advanced rng, so any producer can compute any step's indices.
    `num_workers` decode threads are spawned PER producer (total host
    threads ~ num_producers * num_workers; size to the host's cores).

    start_step: the first step yielded; batches k, k+1, ... equal those of
    a pipeline started at 0, so a resumed run sees the batches it would
    have seen without the interruption.  rank / num_ranks: build only this
    rank's contiguous rows of each global batch of batch_size (the same
    records and sample seeds as slicing the global batch).
    """

    def __init__(
        self,
        records: List[ImageRecord],
        config: DANConfig,
        batch_size: Optional[int] = None,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 2,
        num_producers: Optional[int] = None,
        start_step: int = 0,
        rank: int = 0,
        num_ranks: int = 1,
    ):
        if not records:
            raise ValueError("empty dataset")
        self.records = records
        self.config = config
        self.batch_size = batch_size or config.train.batch_size
        if self.batch_size % num_ranks or not 0 <= rank < num_ranks:
            raise ValueError(
                f"batch {self.batch_size} does not split over {num_ranks} ranks at rank {rank}"
            )
        per = self.batch_size // num_ranks
        self._rows = range(rank * per, (rank + 1) * per)
        self.start_step = start_step
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = prefetch
        if num_producers is None:
            # One producer per ~2 cores up to 4: a handful of producers
            # keeps the decode threads fed without oversubscribing small
            # hosts.
            import os as _os

            num_producers = max(1, min(4, (_os.cpu_count() or 1) // 2))
        self.num_producers = max(1, int(num_producers))
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    def _epoch_perm(self, epoch: int) -> np.ndarray:
        """Shuffle for one epoch, derived from (seed, epoch) so any
        producer can materialize any epoch without replaying a stream."""
        return np.random.default_rng([self.seed, epoch]).permutation(
            len(self.records)
        )

    def _step_indices(self, step: int, perm_cache: Dict[int, np.ndarray]):
        """Record indices for global step `step` — positions
        [step*B, (step+1)*B) of the infinite epoch-permutation
        concatenation.  perm_cache is per-producer (steps within one
        producer are monotone, so epochs older than the previous one are
        evicted)."""
        n = len(self.records)
        out = []
        for t in range(step * self.batch_size, (step + 1) * self.batch_size):
            e, pos = divmod(t, n)
            perm = perm_cache.get(e)
            if perm is None:
                perm = perm_cache[e] = self._epoch_perm(e)
                for old in [k for k in perm_cache if k < e - 1]:
                    del perm_cache[old]
            out.append(int(perm[pos]))
        return out

    def _producer(self, k: int, stop: threading.Event, q: "queue.Queue"):
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        sample_seed = int(
            np.random.default_rng(self.seed).integers(0, 2**31)
        )
        perm_cache: Dict[int, np.ndarray] = {}
        try:
            step = self.start_step + k
            while not stop.is_set():
                idxs = self._step_indices(step, perm_cache)
                futures = [
                    pool.submit(
                        _prepare_sample, self.records[idxs[j]], self.config,
                        sample_seed + step * self.batch_size + j,
                    )
                    for j in self._rows
                ]
                batch = _collate([f.result() for f in futures])
                if not _put_or_stop(q, batch, stop):
                    return
                step += self.num_producers
        except BaseException as e:
            # A corrupt/missing JPEG must surface in the consumer, not
            # silently kill this thread and hang training on q.get().
            _put_or_stop(q, e, stop)
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # One queue per producer; the consumer walks them in step order so
        # batches arrive exactly as a single producer would emit them.
        qs = [
            queue.Queue(maxsize=self.prefetch)
            for _ in range(self.num_producers)
        ]
        # Fresh event per iteration: a previous generator's close() set the
        # old one, and a producer started against an already-set event would
        # exit without ever enqueuing (consumer hangs on q.get() forever).
        # Generators still holding the old event keep seeing it set.
        self._stop = stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._producer, args=(k, stop, qs[k]), daemon=True)
            for k in range(self.num_producers)
        ]
        for t in self._threads:
            t.start()
        try:
            i = 0
            while True:
                item = qs[i % self.num_producers].get()
                if isinstance(item, BaseException):
                    raise item
                yield item
                i += 1
        finally:
            stop.set()

    def stop(self):
        """Stop the producers and wait until they and their decode threads
        are done (a producer finishes the batch it is building), so that no
        read of a record's file outlives the call."""
        self._stop.set()
        for t in self._threads:
            t.join()
