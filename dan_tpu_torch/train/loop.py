"""The train step on one device (counterpart of dan_tpu/train/loop.py):

    uint8 canvases -> train preprocess (crop/resize, colour, flip,
    normalise) -> anchor matching -> forward -> loss (CE + HNM +
    smooth-L1) -> backward -> SGD update

    state = create_train_state(config, seed=0, device="cuda")
    metrics = train_step(state, synthetic_batch(config, 32, seed=0))

On N ranks (dan_tpu_torch/parallel/) every rank passes its own rows of the
global batch and the mesh:

    metrics = train_step(state, shard_batch(global_batch, mesh), mesh=mesh)

and the step runs: preprocess and match the rank's rows; all-reduce the
positive count, so every rank divides its loss by the GLOBAL max(num_pos,
1); forward, loss and backward; all-reduce the gradients as a SUM (one flat
buffer, which also carries the metrics); then the global norm, the clip and
SGD on every rank, as on one device.  The ranks' losses then sum to the
one-device loss and the summed gradients are its gradients: DDP's mean of
per-rank gradients, each normalised by its own positives, is another step.
The shard_map islands of the JAX package's sharded step (its matcher and
phase-pool backward) have no counterpart: each rank runs its own kernels on
its own rows.

Unlike the JAX package's pure step, `train_step` updates the state in
place: the model's parameters, the momentum buffers and the step count.
The host batch is the train-pipeline contract of dan_tpu/data/synthetic.py
and dan_tpu/data/pipeline.py (numpy arrays: canvas, crop_x0, crop_y0,
crop_size, boxes, mask, seed).  The per-image augmentation draws are taken
on the host from the batch's `seed`, as the JAX package's
jax.random.PRNGKey(seed) draws them (ops/threefry.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from dan_tpu_torch.config import DANConfig
from dan_tpu_torch.device import resolve_device
from dan_tpu_torch.box.anchors import generate_anchors
from dan_tpu_torch.box.matching import MatchTargets, match_anchors_batch
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.parallel.mesh import Mesh, all_reduce_grads, all_reduce_sum
from dan_tpu_torch.ops.preprocess import AugmentDraws, sample_augment_batch, train_preprocess
from dan_tpu_torch.train.loss import detection_loss
from dan_tpu_torch.train.optim import sgd_update

BATCH_KEYS = ("canvas", "crop_x0", "crop_y0", "crop_size", "boxes", "mask")


@dataclasses.dataclass
class TrainState:
    """model: the detector, on the train device; momentum: one buffer per
    parameter, by parameter name; step: the count of updates made."""

    model: DANDetector
    momentum: Dict[str, torch.Tensor]
    step: int
    config: DANConfig

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_train_state(config: DANConfig, seed: int = 0, device=None) -> TrainState:
    """Random He-normal weights from a torch.Generator seeded with `seed`,
    zero momentum, step 0."""
    device = resolve_device(device)
    model = DANDetector(config.model, torch.Generator().manual_seed(seed)).to(device)
    momentum = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    return TrainState(model=model, momentum=momentum, step=0, config=config)


def to_device(batch: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The host batch's arrays on `device`, copied from pinned memory
    without blocking the host when the device is a card.  Entries that are
    tensors on `device` already (data/pipeline.py::device_prefetch) are
    taken as they are."""
    device = torch.device(device)
    out = {}
    for k in BATCH_KEYS:
        if isinstance(batch[k], torch.Tensor) and batch[k].device == device:
            out[k] = batch[k]
            continue
        t = torch.from_numpy(np.ascontiguousarray(batch[k]))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    return out


def preprocess_and_match(
    batch: Mapping[str, np.ndarray],
    config: DANConfig,
    device,
    draws: Optional[AugmentDraws] = None,
):
    """Host batch -> (images (B, S, S, 3) f32 on `device`, MatchTargets).

    draws: the augmentation draws; by default sampled from the batch's
    seeds (tests pass the JAX package's own)."""
    if draws is None:
        draws = sample_augment_batch(batch["seed"], config.preprocess)
    t = to_device(batch, device)
    images, boxes, mask = train_preprocess(
        t["canvas"], (t["crop_x0"], t["crop_y0"], t["crop_size"]),
        t["boxes"], t["mask"], draws, config.preprocess,
    )
    size = config.preprocess.train_image_size
    anchors = generate_anchors(config.anchors, size, size, images.device)
    targets = match_anchors_batch(anchors, boxes, mask, config.match, config.anchors)
    return images, targets


def loss_and_grads(
    state: TrainState,
    images: torch.Tensor,
    targets: MatchTargets,
    total_pos: Optional[torch.Tensor] = None,
):
    """Forward, loss and the gradients of every parameter, by name.
    total_pos: the global batch's positives when these are one rank's rows
    (train/loss.py::detection_loss)."""
    named = dict(state.model.named_parameters())
    cls_logits, loc_preds = state.model(images)
    loss, metrics = detection_loss(
        cls_logits, loc_preds, targets.cls_target, targets.loc_target, state.config.train,
        total_pos,
    )
    grads = torch.autograd.grad(loss, list(named.values()))
    return dict(zip(named, grads)), metrics


# Metrics whose per-rank shares sum to the global batch's (num_pos is
# global already, and grad_norm is taken from the summed gradients).
_SUMMED_METRICS = ("loss", "cls_loss", "loc_loss", "num_neg_selected")


def train_step(
    state: TrainState,
    batch: Mapping[str, np.ndarray],
    draws: Optional[AugmentDraws] = None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, torch.Tensor]:
    """One step in place; returns the metrics as 0-d device tensors (loss,
    cls_loss, loc_loss, num_pos, num_neg_selected, grad_norm before the
    clip).  With a mesh, `batch` and `draws` are this rank's rows and the
    metrics are the global batch's, the same on every rank.  Nothing here
    waits for the device, but a gloo collective waits for its inputs."""
    images, targets = preprocess_and_match(batch, state.config, state.device, draws)
    total_pos = None
    if mesh is not None:
        total_pos = all_reduce_sum((targets.cls_target == 1).sum(), mesh)
    grads, metrics = loss_and_grads(state, images, targets, total_pos)
    if mesh is not None:
        grads, summed = all_reduce_grads(grads, {k: metrics[k] for k in _SUMMED_METRICS}, mesh)
        metrics.update(summed)
    named = dict(state.model.named_parameters())
    metrics["grad_norm"] = sgd_update(named, grads, state.momentum, state.step, state.config.train)
    state.step += 1
    return metrics
