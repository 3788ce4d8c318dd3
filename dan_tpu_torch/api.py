"""Public detector API (counterpart of dan_tpu/api.py): image in,
detection dict out.

    det = Detector.from_random(seed=0)         # on the first CUDA card
    det = Detector.from_checkpoint(path)       # TF1 prefix, .npz, .pt or model_dir
    out = det.detect(image_rgb_uint8)          # (H, W, 3), any size
    out["bboxes"], out["scores"]               # pixels of the input image
    out = det.detect_tta(image_rgb_uint8)      # pyramid + flip + bbox-vote
    det.quantize_int8(calib_images)            # int8 body from now on (quant.py)

Every constructor takes `device`; the default is the first CUDA card, and
without one it raises unless `device="cpu"` is passed.

Each image is placed in the top-left of a square uint8 canvas (the smallest
of config.tta.buckets that holds it), squash-resized on the device to the
network input, run through the model, decoded, filtered and NMS'd, and its
boxes are scaled back to the image's own pixels.  On a CUDA device the NMS
is the CUDA kernel of ops/nms_cuda.py, and the TTA path's fusion the one of
ops/bbox_vote_cuda.py.  After `quantize_int8` the detect path runs the
int8 body of quant.py (its convolutions the kernel of ops/conv_i8_cuda.py);
the TTA path stays in the compute dtype.

`warmup_tta` and `detect_tta_dataset` take a `mesh` (dan_tpu_torch.parallel)
to share a dataset over ranks; each rank builds its Detector on mesh.device.

A RetinaFaceConfig (config.py) builds RetinaFace-R50 (models/retinaface.py)
in place of DAN: `detect`, `detect_batch` and `warmup` run it, and each
detection dict then also holds 'landmarks' (N, 10), five (x, y) points in
the image's pixels.  TTA, int8 and the checkpoint constructors refuse it
(config.dan_only).
"""
from __future__ import annotations

import itertools
import warnings
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from dan_tpu_torch.config import DANConfig, dan_only, default_config
from dan_tpu_torch.box.anchors import generate_anchors
from dan_tpu_torch.ckpt.bridge import params_from_jax
from dan_tpu_torch.ckpt.load import load_params
from dan_tpu_torch.device import resolve_device
from dan_tpu_torch.eval.tta import TTARunner
from dan_tpu_torch.models.detector import DANDetector, compute_dtype
from dan_tpu_torch.models.factory import build_model
from dan_tpu_torch.ops.postprocess import postprocess_batch
from dan_tpu_torch.ops.squash import eval_preprocess
from dan_tpu_torch.parallel.mesh import Mesh
from dan_tpu_torch.quant import QuantizedDetector, calibrate_act_scales
from dan_tpu_torch.utils.profiling import span


class Detector:
    """Single-shot face detector on one torch device."""

    def __init__(self, model: DANDetector, config: DANConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        self._tta_runner: Optional[TTARunner] = None
        self._quant: Optional[QuantizedDetector] = None
        self._tta_quant_warned = False
        self._calls = itertools.count()  # detect_batch's unit ids
        self.model = model.to(self.device).eval()
        size = config.model.image_size
        self.anchors = generate_anchors(config.anchors, size, size, self.device)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_random(
        cls, seed: int = 0, config: Optional[DANConfig] = None, device=None
    ) -> "Detector":
        """Random He-normal weights from a torch.Generator seeded with `seed`
        (batch norm, where the model has it, at identity)."""
        config = config or default_config()
        gen = torch.Generator().manual_seed(seed)
        return cls(build_model(config, gen), config, device)

    @classmethod
    def from_jax_params(
        cls, tree: Mapping, config: Optional[DANConfig] = None, device=None
    ) -> "Detector":
        """Weights from the JAX package's parameter tree (numpy leaves)."""
        config = config or default_config()
        dan_only(config, "Detector.from_jax_params")
        model = DANDetector(config.model)
        model.load_state_dict(params_from_jax(tree))
        return cls(model, config, device)

    @classmethod
    def from_checkpoint(
        cls, path: str, config: Optional[DANConfig] = None, device=None
    ) -> "Detector":
        """Weights from a checkpoint of any format that ckpt/load.py reads:
        a TF1 prefix (non-strict: uncovered leaves get the JAX package's
        PRNGKey(0) init), a
        JAX-layout .npz, a .pt of the train or convert CLI, or a train
        model_dir (its newest step).  Loaded on the CPU, then moved to the
        device once."""
        config = config or default_config()
        dan_only(config, "Detector.from_checkpoint")
        device = resolve_device(device)
        model = DANDetector(config.model)
        model.load_state_dict(load_params(path, config))
        return cls(model, config, device)

    @classmethod
    def from_train_checkpoint(
        cls, path: str, config: Optional[DANConfig] = None, device=None
    ) -> "Detector":
        """Weights from a checkpoint of `python -m dan_tpu_torch.train`: one
        step file or a model_dir (its newest step); from_checkpoint."""
        return cls.from_checkpoint(path, config, device)

    # -- inference -----------------------------------------------------------

    @staticmethod
    def _check_image(image) -> np.ndarray:
        image = np.asarray(image)
        if image.ndim != 3 or image.shape[-1] != 3:
            raise ValueError(f"expected (H, W, 3) RGB image, got {image.shape}")
        if image.dtype != np.uint8:
            if np.issubdtype(image.dtype, np.floating):
                # [0, 1] floats are scaled up; [0, 255] floats are rounded.
                if image.size and float(np.nanmax(image)) <= 1.0 + 1e-6:
                    image = image * 255.0
                image = np.rint(image)
            image = np.clip(image, 0, 255).astype(np.uint8)
        return image

    def _canvas_for(self, h: int, w: int) -> int:
        m = max(h, w)
        for b in self.config.tta.buckets:
            if m <= b:
                return b
        return -(-m // 128) * 128  # round up to 128 for outsized inputs

    @staticmethod
    def _pack_canvases(images, c: int):
        """Images, each into the top-left of a (c, c) uint8 canvas ->
        (canvases (B, c, c, 3), heights (B,), widths (B,) float32)."""
        n = len(images)
        canvases = np.zeros((n, c, c, 3), np.uint8)
        hs = np.zeros((n,), np.float32)
        ws = np.zeros((n,), np.float32)
        for i, im in enumerate(images):
            h, w = im.shape[:2]
            canvases[i, :h, :w] = im
            hs[i], ws[i] = h, w
        return canvases, hs, ws

    def _on_device(self, canvases: np.ndarray, hs: np.ndarray, ws: np.ndarray):
        """_pack_canvases' arrays -> the same as tensors on the device."""
        return tuple(torch.from_numpy(a).to(self.device) for a in (canvases, hs, ws))

    def _preprocess(self, canv: torch.Tensor, h_t: torch.Tensor, w_t: torch.Tensor):
        """(B, C, C, 3) uint8 canvases on the device -> normalized network
        inputs (B, S, S, 3) float32."""
        size, prep = self.config.model.image_size, self.config.preprocess
        return torch.stack(
            [eval_preprocess(canv[i], h_t[i], w_t[i], size, prep) for i in range(len(canv))]
        )

    @torch.inference_mode()
    def _detect_canvases(self, canv: torch.Tensor, h_t: torch.Tensor, w_t: torch.Tensor):
        """(B, C, C, 3) uint8 canvases + true extents (B,) float32, on the
        device -> batched detection dict on the device, boxes in each
        image's own pixels."""
        cfg = self.config
        size = cfg.model.image_size
        with span("dan.detect"):
            with span("dan.detect.normalize"):
                imgs = self._preprocess(canv, h_t, w_t)
            model = self._quant if self._quant is not None else self.model
            cls_logits, loc_preds, *landm = model(imgs)
            with span("dan.detect.postprocess"):
                det = postprocess_batch(
                    cls_logits, loc_preds, self.anchors, cfg.anchors,
                    cfg.postprocess, float(size), float(size),
                    landm_preds=landm[0] if landm else None,
                )
                # Back to original pixels: the inverse of the squash resize.
                sx = w_t / size
                sy = h_t / size
                det["bboxes"] = det["bboxes"] * torch.stack([sx, sy, sx, sy], dim=-1)[:, None, :]
                if landm:
                    k = det["landmarks"].shape[-1] // 2
                    sxy = torch.stack([sx, sy], dim=-1).repeat(1, k)
                    det["landmarks"] = det["landmarks"] * sxy[:, None, :]
        return det

    def detect(
        self, image, score_threshold: Optional[float] = None
    ) -> Dict[str, np.ndarray]:
        """Detect faces in an (H, W, 3) uint8 or float RGB image.

        Returns {'bboxes': (N, 4) float32 corner boxes in input pixels,
        'scores': (N,) float32}, N <= config.postprocess.max_detections,
        by descending score; with RetinaFace also 'landmarks' (N, 10)."""
        return self.detect_batch([image], score_threshold)[0]

    def detect_batch(self, images, score_threshold: Optional[float] = None) -> list:
        """List of (H, W, 3) images -> list of detection dicts.  The images
        share the smallest canvas bucket that holds the largest of them and
        run as one batch (a single image launches the NMS kernel at B=1).
        Each call is a dan.detect_batch span (utils/profiling.py) whose unit
        is the call's number: the canvases packed in numpy, their copy to
        the device, the dan.detect call and the copy of the detections back."""
        images = [self._check_image(im) for im in images]
        if not images:
            return []
        with span("dan.detect_batch", unit=next(self._calls)):
            with span("dan.detect_batch.pack"):
                c = self._canvas_for(
                    max(im.shape[0] for im in images), max(im.shape[1] for im in images)
                )
                packed = self._pack_canvases(images, c)
            with span("dan.detect_batch.h2d"):
                on_device = self._on_device(*packed)
            det = self._detect_canvases(*on_device)
            with span("dan.detect_batch.d2h"):
                det = {k: v.cpu().numpy() for k, v in det.items()}
        out = []
        for i in range(len(images)):
            keep = det["valid"][i]
            if score_threshold is not None:
                keep = keep & (det["scores"][i] >= score_threshold)
            out.append({k: det[k][i][keep] for k in det if k != "valid"})
        return out

    def warmup(self, buckets=None) -> None:
        """Run one detect per canvas bucket on a blank canvas, so that the
        first request pays no kernel build or library autotuning (on the
        int8 path after quantize_int8)."""
        for c in buckets or self.config.tta.buckets:
            self._detect_canvases(*self._on_device(
                np.zeros((1, c, c, 3), np.uint8),
                np.full((1,), c, np.float32),
                np.full((1,), c, np.float32),
            ))

    # -- int8 deployment -------------------------------------------------------

    @torch.inference_mode()
    def quantize_int8(self, calib_images, batch_size: int = 8) -> Dict[str, np.ndarray]:
        """Post-training-quantize the detect path to an int8 body (quant.py).

        calib_images: (H, W, 3) uint8 or float RGB images representative of
        the deployment (8-64 is typical for absmax calibration).  Each goes
        through the detect path's own preprocess, in batches of batch_size
        (a short last batch repeats its last image: duplicates leave an
        absmax unchanged).  Returns the activation scales.  detect(),
        detect_batch() and warmup() run the int8 body from the next call on;
        the TTA path stays in the compute dtype and detect_tta() warns once.
        Call again to re-calibrate, dequantize() to go back."""
        dan_only(self.config, "Detector.quantize_int8")
        imgs = [self._check_image(im) for im in calib_images]
        if not imgs:
            raise ValueError("quantize_int8 needs at least one calibration image")
        c = self._canvas_for(max(im.shape[0] for im in imgs), max(im.shape[1] for im in imgs))
        dt = compute_dtype(self.config.model)

        def batches():
            for i in range(0, len(imgs), batch_size):
                chunk = imgs[i : i + batch_size]
                chunk = chunk + [chunk[-1]] * (batch_size - len(chunk))
                canv, hs, ws = self._on_device(*self._pack_canvases(chunk, c))
                yield self._preprocess(canv, hs, ws).to(dt)

        scales = calibrate_act_scales(self.model, batches(), self.config.model)
        self._quant = QuantizedDetector(self.model, scales).to(self.device).eval()
        self._tta_quant_warned = False
        return scales

    def dequantize(self) -> None:
        """Back to the compute-dtype detect path after quantize_int8()."""
        self._quant = None

    def _warn_tta_quant(self) -> None:
        if self._quant is not None and not self._tta_quant_warned:
            warnings.warn("Detector is int8-quantized but the TTA path always runs in the "
                          "compute dtype (accuracy mode); detect()/detect_batch() stay int8.")
            self._tta_quant_warned = True

    # -- test-time augmentation ------------------------------------------------

    def _get_tta_runner(self) -> TTARunner:
        dan_only(self.config, "The TTA path (detect_tta, warmup_tta, detect_tta_dataset)")
        if self._tta_runner is None:
            self._tta_runner = TTARunner(self.model, self.config, device=self.device)
        return self._tta_runner

    def warmup_tta(
        self,
        sizes,
        tta_batch: Optional[int] = None,
        vote_batch: Optional[int] = None,
        mesh: Optional[Mesh] = None,
    ) -> int:
        """Run every TTA launch shape the given (h, w) image sizes will need
        once, with the knobs the eval CLI exposes (--tta_batch /
        --vote_batch; None = TTARunner's defaults) and the mesh the dataset
        run will take.  Returns the number of shapes warmed
        (TTARunner.warmup)."""
        self._warn_tta_quant()
        return self._get_tta_runner().warmup(
            sizes,
            batch_per_device=(
                tta_batch if tta_batch is not None else TTARunner.DEFAULT_TTA_BATCH
            ),
            vote_batch=(
                vote_batch if vote_batch is not None else TTARunner.DEFAULT_VOTE_BATCH
            ),
            mesh=mesh,
        )

    def detect_tta(
        self, image, score_threshold: Optional[float] = None
    ) -> Dict[str, np.ndarray]:
        """Full pyramid + flip TTA with bbox-vote fusion on one image (the
        accuracy-mode eval path), same detection dict as detect().  The
        TTARunner is cached on the Detector; for dataset-scale work use
        detect_tta_dataset / warmup_tta."""
        self._warn_tta_quant()
        out = self._get_tta_runner().detect_tta(self._check_image(image))
        if score_threshold is not None:
            keep = out["scores"] >= score_threshold
            out = {k: v[keep] for k, v in out.items()}
        return out

    def detect_tta_dataset(
        self,
        items,
        tta_batch: Optional[int] = None,
        vote_batch: Optional[int] = None,
        progress_every: int = 0,
        max_pending: Optional[int] = None,
        mesh: Optional[Mesh] = None,
    ) -> Dict[str, Dict[str, np.ndarray]]:
        """Dataset-scale TTA: iterable of (key, image) -> {key: detection
        dict}, batched per resolution bucket: the API twin of the eval
        CLI's run_dataset path with the same tta_batch / vote_batch /
        max_pending knobs (None = TTARunner's defaults).  With a mesh every
        rank passes the same items and gets every image's detections."""
        return self._get_tta_runner().run_dataset(
            ((k, self._check_image(im)) for k, im in items),
            batch_per_device=(
                tta_batch if tta_batch is not None else TTARunner.DEFAULT_TTA_BATCH
            ),
            progress_every=progress_every,
            vote_batch=(
                vote_batch if vote_batch is not None else TTARunner.DEFAULT_VOTE_BATCH
            ),
            max_pending=(
                max_pending if max_pending is not None else TTARunner.DEFAULT_MAX_PENDING
            ),
            mesh=mesh,
        )
