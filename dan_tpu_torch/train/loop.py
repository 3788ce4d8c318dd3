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

`train_step(..., debug_nans=True)` is the counterpart of jax_debug_nans:
every module's output is checked as it is made (FloatingPointError naming
the first module whose output is not finite), the backward runs under
autograd's anomaly mode with its NaN check, and the loss and the gradients
are checked before the update, so a non-finite step raises before any
parameter changes.  The checks wait for the device at every module.  On a
mesh every rank raises together, as the JAX package's sharded step (one
program) does: no check raises before the gradients' all-reduce, where a
rank that raised alone would leave the others waiting in it.  The hooks
record the first module whose output is not finite, the backward runs
without anomaly mode's NaN check, and the all-reduce's flat buffer carries
a one-hot row over the model's sorted module names, summed over the ranks;
after it every rank raises FloatingPointError naming the first module of
that list that a rank recorded, then checks the summed loss and gradients.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from dan_tpu_torch.config import DANConfig, dan_only
from dan_tpu_torch.device import float32_arithmetic, resolve_device
from dan_tpu_torch.box.anchors import generate_anchors
from dan_tpu_torch.box.matching import MatchTargets, match_anchors_batch
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.parallel.mesh import Mesh, all_reduce_grads, all_reduce_sum
from dan_tpu_torch.ops.preprocess import AugmentDraws, sample_augment_batch, train_preprocess
from dan_tpu_torch.train.loss import detection_loss
from dan_tpu_torch.train.optim import sgd_update
from dan_tpu_torch.utils.profiling import span

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


def create_train_state(config: DANConfig, seed: int = 0, device=None,
                       model: Optional[DANDetector] = None) -> TrainState:
    """`model`'s weights (by default random He-normal ones from a
    torch.Generator seeded with `seed`) on `device`, zero momentum, step 0."""
    dan_only(config, "Training (create_train_state)")
    device = resolve_device(device)
    if model is None:
        model = DANDetector(config.model, torch.Generator().manual_seed(seed))
    model = model.to(device)
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
    with span("dan.train.h2d"):
        t = to_device(batch, device)
    with span("dan.train.preprocess"):
        images, boxes, mask = train_preprocess(
            t["canvas"], (t["crop_x0"], t["crop_y0"], t["crop_size"]),
            t["boxes"], t["mask"], draws, config.preprocess,
        )
    with span("dan.train.match"):
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
    (train/loss.py::detection_loss).

    A float32 model runs in float32 arithmetic (device.float32_arithmetic:
    no TF32) and under cuDNN's deterministic mode: on an H100 cuDNN's
    default choices for the float32 backward with TF32 off made two runs
    from one seed differ, while its bf16 choices are deterministic, so the
    step trains one model a seed in either dtype."""
    named = dict(state.model.named_parameters())
    with _float32_step(state):
        with span("dan.train.forward"):
            cls_logits, loc_preds = state.model(images)
        with span("dan.train.loss"):
            loss, metrics = detection_loss(
                cls_logits, loc_preds, targets.cls_target, targets.loc_target,
                state.config.train, total_pos,
            )
        with span("dan.train.backward"):
            grads = torch.autograd.grad(loss, list(named.values()))
    return dict(zip(named, grads)), metrics


def _float32_step(state: TrainState):
    return float32_arithmetic(state.config.model.compute_dtype == "float32",
                              deterministic=True)


def _all_finite(out) -> bool:
    if isinstance(out, torch.Tensor):
        return not out.is_floating_point() or bool(torch.isfinite(out).all())
    if isinstance(out, dict):
        return all(_all_finite(v) for v in out.values())
    if isinstance(out, (tuple, list)):
        return all(_all_finite(v) for v in out)
    return True


def _not_finite(name: str, module: torch.nn.Module) -> FloatingPointError:
    return FloatingPointError(
        f"debug_nans: the output of {name or 'the model'} ({type(module).__name__}) is not finite")


@contextlib.contextmanager
def nan_guard(model: torch.nn.Module, record: Optional[list] = None) -> Iterator[None]:
    """A forward hook on every module of `model` that raises
    FloatingPointError when the module's output is not finite (a module
    returns after its children, so the first to raise is the innermost
    one), and autograd's anomaly mode with its NaN check; both removed on
    exit.  record: a list instead of the raise, which gets the name of the
    first module whose output was not finite, and the backward runs without
    the NaN check (on a mesh, where every rank must reach the all-reduce)."""
    def hook(name):
        def check(module, inputs, output):
            if record or _all_finite(output):  # a list records the first only
                return
            if record is None:
                raise _not_finite(name, module)
            record.append(name)
        return check

    handles = [m.register_forward_hook(hook(name)) for name, m in model.named_modules()]
    try:
        with torch.autograd.set_detect_anomaly(True, check_nan=record is None):
            yield
    finally:
        for h in handles:
            h.remove()


def _first_not_finite(model: torch.nn.Module, record: list, device) -> torch.Tensor:
    """A float32 one-hot row over `model`'s module names, sorted (the same
    list on every rank): 1 at record[0], or all zeros when record is empty."""
    names = sorted(name for name, _ in model.named_modules())
    row = torch.zeros(len(names), dtype=torch.float32, device=device)
    if record:
        row[names.index(record[0])] = 1.0
    return row


def _raise_not_finite(model: torch.nn.Module, rows: torch.Tensor) -> None:
    """Raise FloatingPointError naming the first module of the sorted list
    whose entry in `rows` (_first_not_finite, summed over the ranks) is not
    0; return when there is none.  Waits for the device."""
    hit = rows.cpu().nonzero()
    if len(hit):
        modules = dict(model.named_modules())
        name = sorted(modules)[int(hit[0])]
        raise _not_finite(name, modules[name])


def check_finite(grads: Mapping[str, torch.Tensor], metrics: Mapping[str, torch.Tensor]) -> None:
    """Raise FloatingPointError naming a non-finite loss or the first
    parameter whose gradient is not finite (one wait for the device)."""
    if not bool(torch.isfinite(metrics["loss"])):
        raise FloatingPointError(f"debug_nans: the loss is {float(metrics['loss'])}")
    ok = torch.stack([torch.isfinite(g).all() for g in grads.values()]).cpu()
    if not bool(ok.all()):
        name = list(grads)[int((~ok).nonzero()[0])]
        raise FloatingPointError(f"debug_nans: the gradient of {name} is not finite")


# Metrics whose per-rank shares sum to the global batch's (num_pos is
# global already, and grad_norm is taken from the summed gradients).
_SUMMED_METRICS = ("loss", "cls_loss", "loc_loss", "num_neg_selected")


def train_step(
    state: TrainState,
    batch: Mapping[str, np.ndarray],
    draws: Optional[AugmentDraws] = None,
    mesh: Optional[Mesh] = None,
    debug_nans: bool = False,
) -> Dict[str, torch.Tensor]:
    """One step in place; returns the metrics as 0-d device tensors (loss,
    cls_loss, loc_loss, num_pos, num_neg_selected, grad_norm before the
    clip).  With a mesh, `batch` and `draws` are this rank's rows and the
    metrics are the global batch's, the same on every rank.  Nothing here
    reads a value back from the device, but each host constant copied to
    a card from pageable memory (the preprocess's and the anchors') waits
    for the stream, and a gloo collective waits for its inputs.  The step
    is a dan.train.step span (utils/profiling.py) whose unit is the step
    count.
    debug_nans: raise FloatingPointError before the update at the first
    non-finite module output, loss or gradient (see the module's
    docstring)."""
    dan_only(state.config, "Training (train_step)")
    with span("dan.train.step", unit=state.step):
        # A float32 model's preprocessing (its resize is two matrix products)
        # runs in float32 arithmetic too, as loss_and_grads does.
        with _float32_step(state):
            images, targets = preprocess_and_match(batch, state.config, state.device, draws)
        total_pos = None
        if mesh is not None:
            with span("dan.train.allreduce"):
                total_pos = all_reduce_sum((targets.cls_target == 1).sum(), mesh)
        record = [] if mesh is not None else None
        with nan_guard(state.model, record) if debug_nans else contextlib.nullcontext():
            grads, metrics = loss_and_grads(state, images, targets, total_pos)
        if mesh is not None:
            extra = {k: metrics[k] for k in _SUMMED_METRICS}
            if debug_nans:
                extra["not_finite"] = _first_not_finite(state.model, record, state.device)
            with span("dan.train.allreduce"):
                grads, summed = all_reduce_grads(grads, extra, mesh)
            if debug_nans:
                _raise_not_finite(state.model, summed.pop("not_finite"))
            metrics.update(summed)
        if debug_nans:
            check_finite(grads, metrics)
        named = dict(state.model.named_parameters())
        with span("dan.train.optimizer"):
            metrics["grad_norm"] = sgd_update(named, grads, state.momentum, state.step,
                                              state.config.train)
    state.step += 1
    return metrics
