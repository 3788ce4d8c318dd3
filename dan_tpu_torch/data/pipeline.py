"""Host input pipeline: file I/O + JPEG decode + scalar crop sampling only
(the port's copy of dan_tpu/data/pipeline.py, on its numpy/cv2 path).

The counterpart of the reference's tf.data input_fn (SURVEY.md §3.1): the
host never resamples pixels — it decodes JPEGs, pads them into fixed uint8
canvases, samples data-anchor crop parameters, and hands batches to the
device, where dan_tpu_torch.ops.preprocess does all the math inside the
train step.  A worker pool overlaps decode with device compute, and
`device_prefetch` the host-to-device copy.  By default a batch is decoded
in C++ (dan_tpu_torch/native/loader.cc, `_prepare_batch_native`): threaded,
straight into the canvas array, and only the window the train step will
read.  The per-image cv2 decode (`_prepare_sample`) is its fallback, for a
file libjpeg cannot take and for a host without the library.  The two give
the same batches at `native_window="full"`, canvases included, byte for
byte.  At the default `"crop"` every key but `canvas` is the same, and each
canvas is the same inside the sampled crop window + 2 px and zero outside
it: `train_preprocess` reads nothing else, so it gives the same output
from either.

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

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from dan_tpu_torch import native
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
    decode: the per-image fallback of the native batch decode)."""
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


Windows = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _native_plan(
    records: Sequence[ImageRecord],
    bufs: Sequence[bytes],
    config: DANConfig,
    seeds: Sequence[int],
    window: str,
) -> Tuple[List[Optional[Dict[str, np.ndarray]]], Windows]:
    """The native batch's metadata pass (no pixels): canvas window -> box
    bookkeeping -> crop params, consuming each sample's rng in the same
    order as _prepare_sample so native and fallback batches are
    interchangeable.  Returns the samples (None: the cv2 fallback takes
    that image) and the decode windows (src_x, src_y, dst_x, dst_y, win_w,
    win_h) of native.decode_batch_into."""
    c = config.preprocess.canvas_size
    n = len(records)
    samples: List[Optional[Dict[str, np.ndarray]]] = [None] * n
    src_x = np.zeros((n,), np.int32)
    src_y = np.zeros((n,), np.int32)
    dst_x = np.zeros((n,), np.int32)
    dst_y = np.zeros((n,), np.int32)
    win_w = np.zeros((n,), np.int32)
    win_h = np.zeros((n,), np.int32)
    for i, (r, b) in enumerate(zip(records, bufs)):
        wh = native.jpeg_dims(b)
        if wh is None:  # non-JPEG/corrupt header: full Python fallback
            continue
        # cv2 applies EXIF orientation; libjpeg does not. A rotated image
        # decoded natively would mis-align with its (display-oriented) gt
        # boxes — hand those to the cv2 fallback.
        if (native.jpeg_exif_orientation(b) or 1) != 1:
            continue
        rng = np.random.default_rng(seeds[i])
        off_x, off_y = _window_params(r, wh[0], wh[1], c, rng)
        placed_w = min(c, wh[0] - off_x)
        placed_h = min(c, wh[1] - off_y)
        s = _finish_sample(r, config, rng, off_x, off_y, placed_w, placed_h)
        samples[i] = s
        if window == "crop":
            # Decode the crop window +2 px (bilinear halo), clipped to the
            # placed region; everything else in the slot stays zero.
            x0 = max(0, int(np.floor(s["crop_x0"])) - 2)
            y0 = max(0, int(np.floor(s["crop_y0"])) - 2)
            x1 = min(placed_w, int(np.ceil(s["crop_x0"] + s["crop_size"])) + 2)
            y1 = min(placed_h, int(np.ceil(s["crop_y0"] + s["crop_size"])) + 2)
        else:
            x0, y0, x1, y1 = 0, 0, placed_w, placed_h
        dst_x[i], dst_y[i] = x0, y0
        src_x[i], src_y[i] = off_x + x0, off_y + y0
        win_w[i], win_h[i] = max(0, x1 - x0), max(0, y1 - y0)
    return samples, (src_x, src_y, dst_x, dst_y, win_w, win_h)


def _prepare_batch_native(
    records: Sequence[ImageRecord],
    config: DANConfig,
    seeds: Sequence[int],
    nthreads: int,
    window: str = "crop",
    counts: Optional[collections.Counter] = None,
) -> Optional[Dict[str, np.ndarray]]:
    """Whole-batch native path: file bytes -> C++ threaded JPEG window
    decode directly into the (B, C, C, 3) canvas array (zero collation
    copies, GIL-free decode).

    window='crop' exploits that the data-anchor crop sampler needs only
    box METADATA (never pixels): each sample's crop window is drawn first
    and the decoder reads just that window (+2 px of bilinear margin) —
    the only canvas region the device-side train preprocess ever samples.
    window='full' decodes the whole placed image.

    Returns None when the native library is unavailable; any single image
    the native decoder rejects falls back to the cv2 path in place.
    counts: when given, counts["native"] and counts["fallback"] grow by the
    images that took each path."""
    if native.load_loader() is None:
        return None
    c = config.preprocess.canvas_size
    n = len(records)
    bufs = []
    for r in records:
        with open(r.path, "rb") as f:
            bufs.append(f.read())
    samples, windows = _native_plan(records, bufs, config, seeds, window)
    canvases = np.empty((n, c, c, 3), np.uint8)
    status = native.decode_batch_into(bufs, *windows, canvases, nthreads=nthreads)
    fallback = 0
    for i, r in enumerate(records):
        if samples[i] is None or status[i] != 0:
            # cv2 fallback replays the SAME rng stream from the start.
            s = _prepare_sample(r, config, seeds[i])
            canvases[i] = s.pop("canvas")
            samples[i] = s
            fallback += 1
    if counts is not None:
        counts["native"] += n - fallback
        counts["fallback"] += fallback
    batch = _collate(samples)
    batch["canvas"] = canvases
    return batch


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


# The name of iter_prefetch's thread: a caller (or a test) can tell from
# threading.enumerate() whether a stream was left running.
PREFETCH_THREAD = "dan_tpu_torch.prefetch"
# How long closing a prefetch stream waits for its thread before it raises.
PREFETCH_JOIN_S = 60.0
_END = object()


def _prefetch_worker(items, q, stop, transform) -> None:
    """iter_prefetch's thread.  It closes the iterator it drew from on its
    way out (a generator's `finally`, such as TrainPipeline's join of its
    producers, runs here), so joining the thread waits for that too."""
    it = iter(items)
    try:
        while not stop.is_set():  # a closed stream draws nothing more
            item = next(it, _END)
            if item is not _END and transform is not None:
                item = transform(item)
            if not _put_or_stop(q, item, stop) or item is _END:
                return
    except BaseException as e:  # propagate, don't die silently
        _put_or_stop(q, e, stop)
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def _drain(q) -> None:
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


def iter_prefetch(items, depth: int = 2, transform=None):
    """Run an iterator (plus an optional per-item `transform`) on a
    background thread, staying `depth` items ahead of the consumer.

    The eval CLI uses it to overlap host JPEG decode with device TTA work
    (decode releases the GIL, and the consumer's blocking device fetches
    leave the core idle otherwise).  Worker exceptions propagate to the
    consumer (they must not read as a clean end-of-stream).

    The stream ends its thread before it ends, raises or is closed: it
    stops the thread, drops what is queued and joins the thread (which
    finishes the item it is building and closes `items`), and raises
    RuntimeError if the thread is still running PREFETCH_JOIN_S later.  A
    consumer that stops early must close() the stream: a thread left
    running when the interpreter shuts down can abort the process (it
    frees torch tensors after the interpreter has begun to finalize)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    t = threading.Thread(target=_prefetch_worker, args=(items, q, stop, transform),
                         name=PREFETCH_THREAD, daemon=True)
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
        _drain(q)  # a worker blocked on a full queue puts, sees stop, ends
        t.join(PREFETCH_JOIN_S)
        _drain(q)
        if t.is_alive():
            raise RuntimeError(
                f"the prefetch thread did not end within {PREFETCH_JOIN_S} s of the stream's end")


def device_prefetch(batches, device, depth: int = 2):
    """Copy each batch's arrays to `device` on a background thread, `depth`
    batches ahead of the consumer (the counterpart of the JAX package's
    device_prefetch; on N ranks, each rank prefetches its own rows to its
    own device, mesh.device).  Yields dicts of device tensors with the
    host `seed` array kept, which train_step takes as they are.  On a card
    the thread pins each batch and queues its copy on the current stream,
    ahead of the steps that read it.  An iter_prefetch stream: close() it
    when done, and it closes `batches`."""
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

    use_native: decode each batch with the C++ loader (`_prepare_batch_native`,
    `num_workers` threads), at native_window "crop" (the default: only the
    sampled crop window + 2 px) or "full"; a host without the library takes
    the cv2 path, and a producer that finds it missing does not try again.
    `decoded` counts the images of the yielded and pending batches by path:
    "native", "fallback" (cv2 inside a native batch) and "cv2".
    """

    def __init__(
        self,
        records: List[ImageRecord],
        config: DANConfig,
        batch_size: Optional[int] = None,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 2,
        use_native: bool = True,
        native_window: str = "crop",
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
        if native_window not in ("crop", "full"):
            raise ValueError(f"native_window must be 'crop' or 'full', got {native_window!r}")
        self.use_native = use_native
        self.native_window = native_window
        self.decoded: collections.Counter = collections.Counter()
        self._decoded_lock = threading.Lock()
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
        native_ok = self.use_native
        try:
            step = self.start_step + k
            while not stop.is_set():
                idxs = self._step_indices(step, perm_cache)
                records = [self.records[idxs[j]] for j in self._rows]
                seeds = [sample_seed + step * self.batch_size + j for j in self._rows]
                counts: collections.Counter = collections.Counter()
                batch = None
                if native_ok:
                    batch = _prepare_batch_native(
                        records, self.config, seeds, nthreads=self.num_workers,
                        window=self.native_window, counts=counts,
                    )
                    native_ok = batch is not None  # don't retry a dead lib
                if batch is None:
                    futures = [pool.submit(_prepare_sample, r, self.config, sd)
                               for r, sd in zip(records, seeds)]
                    batch = _collate([f.result() for f in futures])
                    counts["cv2"] += len(records)
                with self._decoded_lock:
                    self.decoded.update(counts)
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
        self._threads = threads = [
            threading.Thread(target=self._producer, args=(k, stop, qs[k]), daemon=True)
            for k in range(self.num_producers)
        ]
        for t in threads:
            t.start()
        try:
            i = 0
            while True:
                item = qs[i % self.num_producers].get()
                if isinstance(item, BaseException):
                    raise item
                yield item
                i += 1
        finally:  # closing the stream, or an error out of it, joins the producers
            _stop_and_join(stop, threads)

    def stop(self):
        """Stop the producers and wait until they and their decode threads
        are done (a producer finishes the batch it is building), so that no
        read of a record's file outlives the call.  Closing the stream that
        iter() returned does the same."""
        _stop_and_join(self._stop, self._threads)


def _stop_and_join(stop: threading.Event, threads) -> None:
    stop.set()
    for t in threads:
        t.join()
