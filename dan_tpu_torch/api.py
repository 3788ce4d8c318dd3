"""Public detector API (counterpart of dan_tpu/api.py): image in,
detection dict out.

    det = Detector.from_random(seed=0)         # on the first CUDA card
    out = det.detect(image_rgb_uint8)          # (H, W, 3), any size
    out["bboxes"], out["scores"]               # pixels of the input image
    out = det.detect_tta(image_rgb_uint8)      # pyramid + flip + bbox-vote

Every constructor takes `device`; the default is the first CUDA card, and
without one it raises unless `device="cpu"` is passed.

Each image is placed in the top-left of a square uint8 canvas (the smallest
of config.tta.buckets that holds it), squash-resized on the device to the
network input, run through the model, decoded, filtered and NMS'd, and its
boxes are scaled back to the image's own pixels.  On a CUDA device the NMS
is the CUDA kernel of ops/nms_cuda.py, and the TTA path's fusion the one of
ops/bbox_vote_cuda.py.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from dan_tpu_torch.config import DANConfig, default_config
from dan_tpu_torch.box.anchors import generate_anchors
from dan_tpu_torch.ckpt.bridge import params_from_jax
from dan_tpu_torch.ckpt.train_state import load_model_weights
from dan_tpu_torch.device import resolve_device
from dan_tpu_torch.eval.tta import TTARunner
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.ops.postprocess import postprocess_batch
from dan_tpu_torch.ops.squash import eval_preprocess


class Detector:
    """Single-shot face detector on one torch device."""

    def __init__(self, model: DANDetector, config: DANConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        self._tta_runner: Optional[TTARunner] = None
        self.model = model.to(self.device).eval()
        size = config.model.image_size
        self.anchors = generate_anchors(config.anchors, size, size, self.device)

    # -- construction --------------------------------------------------------

    @classmethod
    def from_random(
        cls, seed: int = 0, config: Optional[DANConfig] = None, device=None
    ) -> "Detector":
        """Random He-normal weights from a torch.Generator seeded with `seed`."""
        config = config or default_config()
        gen = torch.Generator().manual_seed(seed)
        return cls(DANDetector(config.model, gen), config, device)

    @classmethod
    def from_jax_params(
        cls, tree: Mapping, config: Optional[DANConfig] = None, device=None
    ) -> "Detector":
        """Weights from the JAX package's parameter tree (numpy leaves)."""
        config = config or default_config()
        model = DANDetector(config.model)
        model.load_state_dict(params_from_jax(tree))
        return cls(model, config, device)

    @classmethod
    def from_train_checkpoint(
        cls, path: str, config: Optional[DANConfig] = None, device=None
    ) -> "Detector":
        """Weights from a checkpoint of `python -m dan_tpu_torch.train`: one
        step file or a model_dir (its newest step)."""
        config = config or default_config()
        model = DANDetector(config.model)
        model.load_state_dict(load_model_weights(path))
        return cls(model, config, device)

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

    @torch.inference_mode()
    def _detect_canvases(self, canvases: np.ndarray, hs: np.ndarray, ws: np.ndarray):
        """(B, C, C, 3) uint8 canvases + true extents -> batched detection
        dict on the device, boxes in each image's own pixels."""
        cfg = self.config
        size = cfg.model.image_size
        dev = self.device
        canv = torch.from_numpy(canvases).to(dev)
        h_t = torch.from_numpy(hs).to(dev)
        w_t = torch.from_numpy(ws).to(dev)
        imgs = torch.stack(
            [
                eval_preprocess(canv[i], h_t[i], w_t[i], size, cfg.preprocess)
                for i in range(len(canvases))
            ]
        )
        cls_logits, loc_preds = self.model(imgs)
        det = postprocess_batch(
            cls_logits, loc_preds, self.anchors, cfg.anchors,
            cfg.postprocess, float(size), float(size),
        )
        # Back to original pixels: the inverse of the squash resize.
        sx = w_t / size
        sy = h_t / size
        det["bboxes"] = det["bboxes"] * torch.stack([sx, sy, sx, sy], dim=-1)[:, None, :]
        return det

    def detect(
        self, image, score_threshold: Optional[float] = None
    ) -> Dict[str, np.ndarray]:
        """Detect faces in an (H, W, 3) uint8 or float RGB image.

        Returns {'bboxes': (N, 4) float32 corner boxes in input pixels,
        'scores': (N,) float32}, N <= config.postprocess.max_detections,
        by descending score."""
        return self.detect_batch([image], score_threshold)[0]

    def detect_batch(self, images, score_threshold: Optional[float] = None) -> list:
        """List of (H, W, 3) images -> list of detection dicts.  The images
        share the smallest canvas bucket that holds the largest of them and
        run as one batch (a single image launches the NMS kernel at B=1)."""
        images = [self._check_image(im) for im in images]
        if not images:
            return []
        c = self._canvas_for(
            max(im.shape[0] for im in images), max(im.shape[1] for im in images)
        )
        n = len(images)
        canvases = np.zeros((n, c, c, 3), np.uint8)
        hs = np.zeros((n,), np.float32)
        ws = np.zeros((n,), np.float32)
        for i, im in enumerate(images):
            h, w = im.shape[:2]
            canvases[i, :h, :w] = im
            hs[i], ws[i] = h, w
        det = {k: v.cpu().numpy() for k, v in self._detect_canvases(canvases, hs, ws).items()}
        out = []
        for i in range(n):
            keep = det["valid"][i]
            if score_threshold is not None:
                keep = keep & (det["scores"][i] >= score_threshold)
            out.append({"bboxes": det["bboxes"][i][keep], "scores": det["scores"][i][keep]})
        return out

    def warmup(self, buckets=None) -> None:
        """Run one detect per canvas bucket on a blank canvas, so that the
        first request pays no kernel build or library autotuning."""
        for c in buckets or self.config.tta.buckets:
            self._detect_canvases(
                np.zeros((1, c, c, 3), np.uint8),
                np.full((1,), c, np.float32),
                np.full((1,), c, np.float32),
            )

    # -- test-time augmentation ------------------------------------------------

    def _get_tta_runner(self) -> TTARunner:
        if self._tta_runner is None:
            self._tta_runner = TTARunner(self.model, self.config, device=self.device)
        return self._tta_runner

    def warmup_tta(
        self,
        sizes,
        tta_batch: Optional[int] = None,
        vote_batch: Optional[int] = None,
    ) -> int:
        """Run every TTA launch shape the given (h, w) image sizes will need
        once, with the knobs the eval CLI exposes (--tta_batch /
        --vote_batch; None = TTARunner's defaults).  Returns the number of
        shapes warmed (TTARunner.warmup)."""
        return self._get_tta_runner().warmup(
            sizes,
            batch_per_device=(
                tta_batch if tta_batch is not None else TTARunner.DEFAULT_TTA_BATCH
            ),
            vote_batch=(
                vote_batch if vote_batch is not None else TTARunner.DEFAULT_VOTE_BATCH
            ),
        )

    def detect_tta(
        self, image, score_threshold: Optional[float] = None
    ) -> Dict[str, np.ndarray]:
        """Full pyramid + flip TTA with bbox-vote fusion on one image (the
        accuracy-mode eval path), same detection dict as detect().  The
        TTARunner is cached on the Detector; for dataset-scale work use
        detect_tta_dataset / warmup_tta."""
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
        max_pending: int = 32,
    ) -> Dict[str, Dict[str, np.ndarray]]:
        """Dataset-scale TTA: iterable of (key, image) -> {key: detection
        dict}, batched per resolution bucket: the API twin of the eval
        CLI's run_dataset path with the same tta_batch / vote_batch /
        max_pending knobs (None = TTARunner's defaults)."""
        return self._get_tta_runner().run_dataset(
            ((k, self._check_image(im)) for k, im in items),
            batch_per_device=(
                tta_batch if tta_batch is not None else TTARunner.DEFAULT_TTA_BATCH
            ),
            progress_every=progress_every,
            vote_batch=(
                vote_batch if vote_batch is not None else TTARunner.DEFAULT_VOTE_BATCH
            ),
            max_pending=max_pending,
        )
