"""Data parallelism on N ranks at the tiny config of the JAX package's
`__graft_entry__.py::dryrun_multichip`, in three legs (its counterpart):

  1. one DP train step on a global batch of 8 x N: a finite, positive loss;
  2. save / restore / step continuity: the state after leg 1 saved (rank 0
     writes) and restored into a fresh state on every rank, bit-identical;
     one more step on each: the same metrics and bit for bit the same
     parameters, on the CPU and on a card alike (the train step is
     deterministic on both: on a card the LFPN upsample's gradient is a
     gather kernel, not ATen's atomic adds, and the conv1_2' weight
     gradient's float32 kernel sums its partials in a fixed order);
  3. sharded TTA eval of 4 images at batch_per_device 1: every image has
     detections, and every rank returns every image.

    python -m dan_tpu_torch.tools.dryrun_multichip 4      # 4 cards, NCCL
    python -m dan_tpu_torch.tools.dryrun_multichip 2      # on a host with one card: 2 ranks
                                                          # sharing it, on gloo
    python -m dan_tpu_torch.tools.dryrun_multichip 2 --device cpu   # 2 ranks, CPU, gloo

Like every entry point of the port it runs on the CUDA cards unless
--device cpu is given, and raises without a card.  It trains in float32 on
either, as the JAX dryrun does.

Ranks are spawned processes (dan_tpu_torch/parallel/spawn.py); on cards
rank r takes cuda:(r % device count).  The rank functions `train_rank` and
`tta_rank` drive the DP train step and the sharded TTA run on any config,
and are what the tests and `chip_smoke.py` spawn too.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import sys
import tempfile
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from dan_tpu_torch.api import Detector
from dan_tpu_torch.ckpt import train_state as ckpt
from dan_tpu_torch.config import (
    DANConfig,
    MatchConfig,
    ModelConfig,
    PostprocessConfig,
    PreprocessConfig,
    TrainConfig,
    TTAConfig,
)
from dan_tpu_torch.data.synthetic import synthetic_batch
from dan_tpu_torch.device import resolve_device
from dan_tpu_torch.eval.tta import TTARunner
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.ops import (
    bbox_vote_cuda,
    conv12_wgrad_cuda,
    matching_cuda,
    nms_cuda,
    phase_pool_cuda,
    upsample_cuda,
)
from dan_tpu_torch.ops.preprocess import AugmentDraws
from dan_tpu_torch.parallel.mesh import Mesh, make_mesh, place_replicated, shard_batch
from dan_tpu_torch.train.loop import create_train_state, preprocess_and_match, train_step
from dan_tpu_torch.train.loss import class_ce, hard_negatives

# The kernels a rank launches: the train step's (K3 + K4 in one matcher
# call, K5, K6 -- the bf16 or the float32 kernel, by the compute dtype --,
# the LFPN's three upsample gradients) and the TTA run's (K1 a bucket
# launch, K7 a vote launch).
KERNEL_COUNTERS = {
    "matcher": matching_cuda,
    "phase_pool_bwd": phase_pool_cuda,
    "conv12_wgrad": conv12_wgrad_cuda.BF16,
    "conv12_wgrad_f32": conv12_wgrad_cuda.F32,
    "upsample2x_bwd": upsample_cuda,
    "nms": nms_cuda,
    "bbox_vote": bbox_vote_cuda,
}

# The part of a card's memory that the ranks sharing it may hold together;
# the rest is the launcher's and the CUDA contexts'.  Each rank is capped at
# its even part: uncapped, one rank's cached blocks can leave another's
# allocation without memory, and a convolution whose workspace fails to
# allocate runs cuDNN's next algorithm, whose results differ in the last bits.
# A capped rank flushes its own cache when it reaches its cap instead.
CARD_SHARE = 0.9


def tiny_config(n_ranks: int) -> DANConfig:
    """The JAX dryrun's config: 64 px, canvas 128, 8 gts, float32, a global
    batch of 8 a rank."""
    return DANConfig(
        model=ModelConfig(image_size=64, compute_dtype="float32"),
        preprocess=PreprocessConfig(train_image_size=64, canvas_size=128),
        match=MatchConfig(max_gt=8),
        train=TrainConfig(batch_size=8 * max(n_ranks, 1), hnm_min_negatives=8),
    )


def tiny_eval_config(cfg: DANConfig) -> DANConfig:
    """The JAX dryrun's TTA leg: two scales, flip, buckets 64 and 128."""
    return dataclasses.replace(
        cfg,
        postprocess=PostprocessConfig(pre_nms_topk=64, max_detections=16),
        tta=TTAConfig(max_pixels=1e9, scales=(0.5, 1.5), extra_scale_small_images=0.0,
                      buckets=(64, 128)),
    )


def tiny_items(seed: int = 0):
    """The JAX dryrun's 4 TTA images."""
    rng = np.random.default_rng(seed)
    return [(f"img{i}", rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
            for i, (h, w) in enumerate([(48, 48), (40, 56), (64, 48), (56, 56)])]


def card_share(rank: int, world_size: int, n_cards: int) -> Optional[float]:
    """The share of its card's memory that rank r may hold when rank r runs
    on card r % n_cards: CARD_SHARE split evenly between the ranks of that
    card, or None when the rank has the card to itself."""
    sharing = len(range(rank % n_cards, world_size, n_cards))
    return CARD_SHARE / sharing if sharing > 1 else None


def rank_mesh(rank: int, world_size: int, init_method: str, device: str,
              backend: Optional[str] = None) -> Mesh:
    """This rank's mesh: device "cpu" (gloo unless named) or "cuda" (rank r
    on cuda:(r % device count); NCCL unless named).  Ranks that share a card
    are held to card_share of its memory each."""
    if device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        share = card_share(rank, world_size, torch.cuda.device_count())
        if share is not None:
            torch.cuda.set_per_process_memory_fraction(share, dev)
    else:
        dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    return make_mesh(device=dev, backend=backend, rank=rank, world_size=world_size,
                     init_method=init_method)


def reset_counters() -> None:
    for mod in KERNEL_COUNTERS.values():
        mod.LAUNCHES = 0


def counters() -> Dict[str, int]:
    return {name: mod.LAUNCHES for name, mod in KERNEL_COUNTERS.items()}


def params_digest(state) -> str:
    """sha256 over every parameter's and momentum buffer's bytes, in order:
    equal digests mean bit-identical replicas."""
    h = hashlib.sha256()
    for name, p in state.model.named_parameters():
        h.update(p.detach().cpu().numpy().tobytes())
        h.update(state.momentum[name].cpu().numpy().tobytes())
    return h.hexdigest()


def _rows(draws: Optional[AugmentDraws], rows: slice) -> Optional[AugmentDraws]:
    return None if draws is None else AugmentDraws(*(v[rows] for v in draws))


def train_rank(
    rank: int,
    world_size: int,
    init_method: str,
    device: str,
    backend: Optional[str],
    cfg: DANConfig,
    init: Union[int, dict],
    batches: Union[Sequence[dict], Callable[[int], dict]],
    steps: int,
    draws: Optional[Sequence[AugmentDraws]] = None,
) -> dict:
    """`steps` DP train steps on this rank's rows of the global batches.

    init: a seed for create_train_state, or a checkpoint payload
    (ckpt.train_state.state_payload); rank 0's is broadcast.  batches: the
    global host batches, a list or a function of the step.  draws: each
    step's global augmentation draws (None: from the batch seeds).

    Returns, a step: "metrics" {name: float}, this rank's matcher
    "targets" and the "hard_negatives" of a forward on the pre-step
    parameters (outside the timed step), "ms" the step's host ms
    (synchronised) and on rank 0 the "states" after it; and "digest"
    (params_digest), "launches" (the kernels' counts in the steps),
    "allreduce_ms" (one all-reduce of a buffer of the gradients' size),
    "ooms" (allocator_ooms) and on rank 0 the final "state"."""
    with rank_mesh(rank, world_size, init_method, device, backend) as mesh:
        state = create_train_state(cfg, init if isinstance(init, int) else 0, mesh.device)
        if not isinstance(init, int):
            ckpt.load_payload(state, init)
        place_replicated(state, mesh)
        batch_of = batches if callable(batches) else batches.__getitem__
        rows = mesh.rows(cfg.train.batch_size)
        out = {"metrics": [], "targets": [], "hard_negatives": [], "states": []}
        launches = dict.fromkeys(KERNEL_COUNTERS, 0)
        ms = []
        for i in range(steps):
            local = shard_batch(batch_of(i), mesh)
            d = _rows(draws[i], rows) if draws is not None else None
            images, targets = preprocess_and_match(local, cfg, mesh.device, d)
            cls_logits, _ = state.model(images)
            neg = hard_negatives(class_ce(cls_logits, targets.cls_target),
                                 targets.cls_target, cfg.train)
            out["targets"].append({k: v.cpu().numpy() for k, v in targets._asdict().items()})
            out["hard_negatives"].append(neg.cpu().numpy())
            del images, targets, cls_logits, neg
            _sync(mesh.device)
            before = counters()
            t0 = time.perf_counter()
            metrics = train_step(state, local, d, mesh)
            _sync(mesh.device)
            ms.append((time.perf_counter() - t0) * 1e3)
            for name, n in counters().items():
                launches[name] += n - before[name]
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
            if rank == 0:
                out["states"].append(ckpt.state_payload(state))
        out["launches"] = launches
        out["ms"] = ms
        out["allreduce_ms"] = allreduce_ms(state, mesh)
        out["digest"] = params_digest(state)
        out["ooms"] = allocator_ooms(mesh.device)
        if rank == 0:
            out["state"] = ckpt.state_payload(state)
        return out


def tta_rank(
    rank: int,
    world_size: int,
    init_method: str,
    device: str,
    backend: Optional[str],
    cfg: DANConfig,
    model_state: dict,
    items: Union[list, Callable[[], list]],
    tta_batch: int,
    vote_batch: int,
) -> dict:
    """warmup_tta, then Detector.detect_tta_dataset over the mesh on every
    rank, on the same weights and items (a list, or a function that makes
    it).  Returns {"results": every image's, "stats": last_run_stats,
    "launches": kernel counts of the run, "s": seconds of the run, "ooms":
    allocations that ran out of device memory (allocator_ooms), "memory":
    memory_peaks}."""
    with rank_mesh(rank, world_size, init_method, device, backend) as mesh:
        model = DANDetector(cfg.model)
        model.load_state_dict(model_state)
        det = Detector(model, cfg, device=mesh.device)
        items = items() if callable(items) else items
        det.warmup_tta([im.shape[:2] for _, im in items], tta_batch, vote_batch, mesh)
        reset_counters()
        _sync(mesh.device)
        t0 = time.perf_counter()
        results = det.detect_tta_dataset(items, tta_batch, vote_batch, mesh=mesh)
        _sync(mesh.device)
        return {"results": results, "stats": dict(det._get_tta_runner().last_run_stats),
                "launches": counters(), "s": time.perf_counter() - t0,
                "ooms": allocator_ooms(mesh.device), "memory": memory_peaks(mesh.device)}


def allocator_ooms(device: torch.device) -> int:
    """Allocations on `device` that ran out of memory in this process (0 on
    the CPU).  cuDNN catches such a failure of a workspace and takes its next
    algorithm, so a run that must repeat another's bits needs 0."""
    if device.type != "cuda":
        return 0
    return int(torch.cuda.memory_stats(device).get("num_ooms", 0))


def memory_peaks(device: torch.device) -> Dict[str, float]:
    """This process's peak device memory in use and reserved (GiB), and the
    times its allocator flushed its cache to retry an allocation ({} on the
    CPU)."""
    if device.type != "cuda":
        return {}
    st = torch.cuda.memory_stats(device)
    return {"allocated_gib": st.get("allocated_bytes.all.peak", 0) / 2**30,
            "reserved_gib": st.get("reserved_bytes.all.peak", 0) / 2**30,
            "retries": int(st.get("num_alloc_retries", 0))}


def allreduce_ms(state, mesh: Mesh, iters: int = 3) -> float:
    """Host ms of one SUM all-reduce of a float32 buffer of the parameter
    count on the mesh's device, synchronised, mean of `iters` after one."""
    import torch.distributed as dist

    buf = torch.zeros(sum(p.numel() for p in state.model.parameters()), device=mesh.device)
    dist.all_reduce(buf)
    _sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        dist.all_reduce(buf)
    _sync(mesh.device)
    return (time.perf_counter() - t0) * 1e3 / iters


@torch.no_grad()
def update_rel_l2(a: Mapping[str, torch.Tensor], b: Mapping[str, torch.Tensor],
                  start: Mapping[str, torch.Tensor]) -> float:
    """Relative L2 of the parameter update a - start against b - start, over
    every parameter of b, by name (0.0 when a and b are bit-identical)."""
    num = den = 0.0
    for name, pb in b.items():
        ub = (pb - start[name]).double()
        num += float(((a[name] - start[name]).double() - ub).square().sum())
        den += float(ub.square().sum())
    return (num / den) ** 0.5 if den else float(num > 0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def legs_rank(rank: int, world_size: int, init_method: str, device: str,
              backend: Optional[str], model_dir: str) -> dict:
    """The three legs on this rank; returns what rank 0 reports, and the
    kernels' launches in them ("launches")."""
    with rank_mesh(rank, world_size, init_method, device, backend) as mesh:
        reset_counters()
        cfg = tiny_config(world_size)
        state = create_train_state(cfg, 0, mesh.device)
        place_replicated(state, mesh)

        def batch(seed):
            return shard_batch(synthetic_batch(cfg, cfg.train.batch_size, seed=seed), mesh)

        m1 = {k: float(v) for k, v in train_step(state, batch(0), mesh=mesh).items()}
        if not (np.isfinite(m1["loss"]) and m1["loss"] > 0):
            raise AssertionError(f"bad loss {m1['loss']}")

        ckpt.save(model_dir, state.step, state, mesh)
        restored = ckpt.restore(model_dir, create_train_state(cfg, 1, mesh.device))
        if params_digest(restored) != params_digest(state) or restored.step != state.step:
            raise AssertionError("the restored state differs from the saved one")
        start = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        ma = {k: float(v) for k, v in train_step(state, batch(1), mesh=mesh).items()}
        mb = {k: float(v) for k, v in train_step(restored, batch(1), mesh=mesh).items()}
        if {k: v for k, v in ma.items() if k != "grad_norm"} != \
                {k: v for k, v in mb.items() if k != "grad_norm"}:
            raise AssertionError(f"the restored state's step reports {mb}, not {ma}")
        rel = update_rel_l2(dict(restored.model.named_parameters()),
                            dict(state.model.named_parameters()), start)
        if rel > 0.0:
            raise AssertionError(f"the restored state's step moved its parameters {rel:.3e} "
                                 "(relative L2 of the update) from the original's")
        digest = params_digest(state)

        ecfg = tiny_eval_config(cfg)
        runner = TTARunner(state.model, ecfg, device=mesh.device)
        results = runner.run_dataset(tiny_items(), batch_per_device=1, mesh=mesh)
        keys = [k for k, _ in tiny_items()]
        if list(results) != keys:
            raise AssertionError(f"TTA keys {sorted(results)}")
        for key, det in results.items():
            if det["bboxes"].shape != (len(det["scores"]), 4) or not len(det["scores"]):
                raise AssertionError(f"no detections for {key}")
        return {"train": m1, "continuity": (ma["loss"], mb["loss"], rel),
                "digest": digest, "launches": counters(),
                "dets": {k: len(v["scores"]) for k, v in results.items()},
                "results": results, "tta_stats": dict(runner.last_run_stats)}


def dryrun_multichip(n: int, device: Optional[str] = None, backend: Optional[str] = None,
                     timeout: float = 600.0) -> List[dict]:
    """Spawn n ranks for the three legs; print a line for each leg and
    return every rank's report.  Raises if a leg fails on any rank or the
    ranks' parameters differ.

    device: "cuda" or "cpu"; None means the cards, and raises without one
    (device.resolve_device).  backend: default gloo on the CPU and where
    ranks share a card (NCCL refuses two ranks on one card), else NCCL."""
    from dan_tpu_torch.parallel.spawn import spawn

    device = resolve_device(device).type
    if backend is None and device == "cuda" and n > torch.cuda.device_count():
        backend = "gloo"
    with tempfile.TemporaryDirectory(prefix="dan_dryrun_") as d:
        reports = spawn(legs_rank, n, (device, backend, d + "/ckpt"), timeout=timeout,
                        workdir=d)
    if len({r["digest"] for r in reports}) != 1:
        raise AssertionError("the ranks' parameters differ")
    r0 = reports[0]
    print(f"dryrun_multichip({n}, {device}): OK — one DP train step, "
          f"loss={r0['train']['loss']:.4f}, num_pos={r0['train']['num_pos']:.0f}",
          file=sys.stderr)
    print(f"dryrun_multichip({n}, {device}): OK — save/restore/step continuity "
          f"(loss {r0['continuity'][0]:.4f} == {r0['continuity'][1]:.4f}, update rel L2 "
          f"{r0['continuity'][2]:.1e})", file=sys.stderr)
    print(f"dryrun_multichip({n}, {device}): OK — sharded TTA eval pass, "
          + ", ".join(f"{k}:{v} dets" for k, v in sorted(r0["dets"].items())), file=sys.stderr)
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dan_tpu_torch.tools.dryrun_multichip")
    ap.add_argument("n", type=int, nargs="?", default=2, help="ranks")
    ap.add_argument("--device", default=None, choices=("cpu", "cuda"),
                    help="default: the CUDA cards (raises without one)")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default: NCCL on cards, gloo on the CPU and where ranks share a card")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n, args.device, args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
