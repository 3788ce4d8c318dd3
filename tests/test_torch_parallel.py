"""The port's data-parallel train step on N ranks (gloo, spawned CPU
processes) against the JAX package's sharded step at mesh size N, against
the port's own one-device step, and on a batch where one rank's rows hold
no face.

The tiny config of tests/test_torch_train_step.py (64 px, canvas 128,
max_gt 8, float32), a global batch of 8, colour distortion off and flips
on with the JAX package's own draws, sliced by rank; the parity batch's
irregular crop; a gradient clip at norm 10, which binds.  From one JAX create_train_state(PRNGKey(0)) carried across
by the bridge, two steps.

Tolerances.  Against JAX: the positive and selected-negative counts equal,
the other metrics rtol 1e-4 (test_torch_train_step.py's, for two packages
that sum their float32 convolutions in different orders), and after each
step parameters and momentum within 1 % of each tensor's largest update
(momentum: largest entry).  With flipped images a near-tie in the first
forward (of the kind test_torch_train_step.py describes) moves conv1_2's
gradients by up to 0.49 % of their largest, in the one-device port as on N
ranks.  N ranks against the port's one device,
where only the order of the sums differs (the ranks' partial gradients are
summed by the all-reduce): matcher targets, hard negatives and both counts
identical, the loss rel 1e-5, and after the first step parameters rtol
1e-5 / atol 1e-7 (those of tests/e2e/test_train_step.py's 1- vs 8-device
test) and momentum rtol 1e-5 / atol 1e-5 of each tensor's largest entry;
every rank's replica identical.

After the second step this comparison too holds parameters and momentum to
1 % of each tensor's largest update (momentum: largest entry).  The first
step's summation-order differences (<= 1.5e-8 in a parameter, 2.1e-7 of a
momentum tensor's largest entry) meet a near-tie in the second forward
(the relu and max-pool near-ties of test_torch_train_step.py), which moves
a few gradients by up to 0.6 % of their tensor's largest (lfpn_lat_conv5_3
at 2 and 4 ranks).  A per-rank normalisation or an averaged gradient moves
every update by 50 % or more, which every one of these checks sees.
"""
import functools
import time

import numpy as np
import pytest
import torch

import jax

from dan_tpu.config import DANConfig, MatchConfig, ModelConfig, PreprocessConfig, TrainConfig
from dan_tpu.data.synthetic import synthetic_batch
from dan_tpu.parallel.mesh import make_mesh, place_replicated, shard_batch
from dan_tpu.train.loop import create_train_state as jax_create
from dan_tpu.train.loop import make_sharded_train_step
from dan_tpu_torch.ckpt import train_state as ckpt
from dan_tpu_torch.ckpt.bridge import opt_state_from_jax, params_from_jax
from dan_tpu_torch.config import from_reference
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.ops.preprocess import AugmentDraws, stack_draws
from dan_tpu_torch.parallel.spawn import spawn
from dan_tpu_torch.tools import dryrun_multichip as dry
from dan_tpu_torch.train.loop import TrainState, loss_and_grads, preprocess_and_match, train_step
from dan_tpu_torch.train.loss import class_ce, hard_negatives
from dan_tpu_torch.train.optim import sgd_update
from tests.test_torch_parallel_tta import plain_conv_rank
from tests.test_torch_train_preprocess import jax_draws

torch.set_num_threads(1)

STEPS = 2
TIMEOUT = 300


@pytest.fixture(autouse=True, scope="module")
def _plain_cpu_conv():  # module scope: in place before `runs`
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


def tiny_config(clip: float = 10.0) -> DANConfig:
    return DANConfig(
        model=ModelConfig(image_size=64, compute_dtype="float32"),
        preprocess=PreprocessConfig(train_image_size=64, canvas_size=128,
                                    color_distort_prob=0.0, flip_prob=0.5),
        match=MatchConfig(max_gt=8),
        # By default a clip that binds: every rank clips by the norm of the
        # summed gradients, so the replicas stay bit-identical.
        train=TrainConfig(batch_size=8, learning_rate=1e-3, hnm_min_negatives=8,
                          lr_boundaries=(1000,), lr_factors=(1.0, 0.1), grad_clip_norm=clip),
    )


def parity_batch(cfg, seed, empty_rows=None):
    batch = synthetic_batch(cfg, 8, seed=seed)
    batch["crop_x0"][:] = 7.0
    batch["crop_size"][:] = 111.0
    if empty_rows is not None:
        batch["mask"][empty_rows] = False
    return batch


def draws_of(batch, cfg) -> AugmentDraws:
    """The JAX package's draws for every image of the batch."""
    return stack_draws([jax_draws(int(s), cfg.preprocess) for s in batch["seed"]])


def payload_from_jax(js) -> dict:
    momentum, count = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js.opt_state))
    return {"model": params_from_jax(jax.tree_util.tree_map(np.asarray, js.params)),
            "momentum": momentum, "step": count}


def one_device(cfg, payload, batches, draws):
    """The port's train_step without a mesh, recording what train_rank
    records."""
    model = DANDetector(cfg.model)
    model.load_state_dict(payload["model"])
    state = TrainState(model=model, momentum={k: v.clone() for k, v in payload["momentum"].items()},
                       step=payload["step"], config=cfg)
    out = {"metrics": [], "targets": [], "hard_negatives": [], "states": []}
    for batch, d in zip(batches, draws):
        images, targets = preprocess_and_match(batch, cfg, "cpu", d)
        cls_logits, _ = state.model(images)
        out["targets"].append({k: v.numpy() for k, v in targets._asdict().items()})
        out["hard_negatives"].append(
            hard_negatives(class_ce(cls_logits, targets.cls_target), targets.cls_target,
                           cfg.train).numpy())
        out["metrics"].append({k: float(v) for k, v in train_step(state, batch, d).items()})
        out["states"].append(ckpt.state_payload(state))
    return out


def n_ranks(cfg, payload, batches, draws, n):
    return spawn(functools.partial(plain_conv_rank, dry.train_rank), n,
                 ("cpu", None, cfg, payload, batches, len(batches), draws),
                 timeout=TIMEOUT)


@pytest.fixture(scope="module")
def runs():
    """JAX's sharded step at mesh sizes 2 and 4, the port's one-device step
    and the port on 2 and 4 ranks, from the same state and batches."""
    jcfg = tiny_config()
    cfg = from_reference(jcfg)
    batches = [parity_batch(jcfg, s) for s in range(STEPS)]
    draws = [draws_of(b, cfg) for b in batches]
    assert any(d.flip.any() and not d.flip.all() for d in draws)
    payload = payload_from_jax(jax_create(jcfg, jax.random.PRNGKey(0)))
    out = {"start": payload, "one": one_device(cfg, payload, batches, draws), "jax": {},
           "port": {}}
    for n in (2, 4):
        mesh = make_mesh(jcfg.mesh, n_devices=n)
        step = make_sharded_train_step(jcfg, mesh)
        js = place_replicated(jax_create(jcfg, jax.random.PRNGKey(0)), mesh)
        metrics, states = [], []
        for b in batches:
            js, m = step(js, shard_batch(b, mesh))
            metrics.append({k: float(v) for k, v in m.items()})
            states.append(payload_from_jax(js))
        out["jax"][n] = (metrics, states)
        out["port"][n] = n_ranks(cfg, payload, batches, draws, n)
    return out


def _close(got, want, rtol, atol_of_max, atol=0.0, what=""):
    for name, w in want.items():
        w, g = w.detach().numpy(), got[name].detach().numpy()
        np.testing.assert_allclose(g, w, rtol=rtol, atol=max(atol, atol_of_max * np.abs(w).max()),
                                   err_msg=f"{what} {name}")


def assert_params_match_one_device(got: dict, ref: dict, what=""):
    """The 1- vs N-rank tolerance on the state after one step."""
    _close(got["model"], ref["model"], 1e-5, 0.0, 1e-7, what)
    _close(got["momentum"], ref["momentum"], 1e-5, 1e-5, 0.0, what)


def assert_update_close(got: dict, ref: dict, start: dict, what=""):
    """The tolerance after two steps: 1 % of each tensor's largest update
    and momentum entry."""
    for name, p in ref["model"].items():
        update = (p - start["model"][name]).abs().max().item()
        np.testing.assert_allclose(got["model"][name].numpy(), p.numpy(), rtol=0,
                                   atol=1e-2 * update, err_msg=f"{what} {name}")
    _close(got["momentum"], ref["momentum"], 0.0, 1e-2, 0.0, what)


@pytest.mark.parametrize("n", [2, 4])
def test_dp_step_matches_the_jax_sharded_step(runs, n):
    jax_metrics, jax_states = runs["jax"][n]
    ranks = runs["port"][n]
    for i, (jm, pm) in enumerate(zip(jax_metrics, ranks[0]["metrics"])):
        assert set(pm) == set(jm) and jm["grad_norm"] > 10.0  # the clip binds
        for k in ("num_pos", "num_neg_selected"):
            assert pm[k] == jm[k] > 0, (i, k)
        for k in ("loss", "cls_loss", "loc_loss", "grad_norm"):
            np.testing.assert_allclose(pm[k], jm[k], rtol=1e-4, err_msg=f"step {i} {k}")
    first, last = ranks[0]["states"][0], ranks[0]["states"][-1]
    assert (first["step"], last["step"]) == (jax_states[0]["step"], jax_states[-1]["step"]) \
        == (1, STEPS)
    assert_update_close(first, jax_states[0], runs["start"], "vs JAX, step 1")
    assert_update_close(last, jax_states[-1], runs["start"], "vs JAX, step 2")


@pytest.mark.parametrize("n", [2, 4])
def test_n_ranks_match_one_device(runs, n):
    one, ranks = runs["one"], runs["port"][n]
    assert len({r["digest"] for r in ranks}) == 1  # identical replicas
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)  # global metrics
    for i in range(STEPS):
        for k, want in one["targets"][i].items():
            got = np.concatenate([r["targets"][i][k] for r in ranks])
            np.testing.assert_array_equal(got, want, err_msg=f"step {i} {k}")
        np.testing.assert_array_equal(
            np.concatenate([r["hard_negatives"][i] for r in ranks]), one["hard_negatives"][i])
        got, want = ranks[0]["metrics"][i], one["metrics"][i]
        assert got["num_pos"] == want["num_pos"] and got["num_neg_selected"] == want["num_neg_selected"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    assert_params_match_one_device(ranks[0]["states"][0], one["states"][0], f"{n} ranks")
    assert_update_close(ranks[0]["states"][-1], one["states"][-1], runs["start"], f"{n} ranks")
    for r in ranks:  # each rank launched its own kernels: here their plain versions
        assert all(v == 0 for v in r["launches"].values())


def _faulty_step(cfg, payload, batch, draws, n, normalise_per_rank, average):
    """One step whose gradients are summed (or averaged) over n row blocks,
    each normalised by its own positives or by the global batch's: what a
    DDP-style step would do."""
    model = DANDetector(cfg.model)
    model.load_state_dict(payload["model"])
    state = TrainState(model=model, momentum={k: v.clone() for k, v in payload["momentum"].items()},
                       step=payload["step"], config=cfg)
    per = 8 // n
    parts = []
    images, targets = preprocess_and_match(batch, cfg, "cpu", draws)
    total = (targets.cls_target == 1).sum()
    for r in range(n):
        rows = slice(r * per, (r + 1) * per)
        t = type(targets)(*(v[rows] for v in targets))
        grads, _ = loss_and_grads(state, images[rows], t, None if normalise_per_rank else total)
        parts.append(grads)
    grads = {k: sum(p[k] for p in parts) / (n if average else 1) for k in parts[0]}
    sgd_update(dict(state.model.named_parameters()), grads, state.momentum, state.step, cfg.train)
    state.step += 1
    return ckpt.state_payload(state)


def test_empty_shard_is_normalised_over_the_global_batch():
    """Rank 1's rows hold no valid gt, so its own positive count is 0 while
    the global count is not.  The DP step must equal the one-device step;
    a step normalised per rank, or one that averages the gradients, must
    fail that same check.  No clip: a clip that binds rescales an averaged
    gradient to the summed one's norm."""
    jcfg = tiny_config(clip=0.0)
    cfg = from_reference(jcfg)
    batch = parity_batch(jcfg, 0, empty_rows=slice(4, 8))
    d = draws_of(batch, cfg)
    payload = payload_from_jax(jax_create(jcfg, jax.random.PRNGKey(0)))
    one = one_device(cfg, payload, [batch], [d])
    ranks = n_ranks(cfg, payload, [batch], [d], 2)
    assert (ranks[1]["targets"][0]["cls_target"] == 1).sum() == 0  # rank 1: no positive
    assert ranks[0]["metrics"][0]["num_pos"] == one["metrics"][0]["num_pos"] > 0
    assert ranks[0]["metrics"][0]["loss"] == pytest.approx(one["metrics"][0]["loss"], rel=1e-5)
    assert_params_match_one_device(ranks[0]["state"], one["states"][0], "2 ranks")
    # The same checks see both faults.
    sound = _faulty_step(cfg, payload, batch, d, 2, normalise_per_rank=False, average=False)
    assert_params_match_one_device(sound, one["states"][0], "summed over blocks")
    for per_rank, average in ((True, False), (False, True)):
        bad = _faulty_step(cfg, payload, batch, d, 2, per_rank, average)
        with pytest.raises(AssertionError):
            assert_params_match_one_device(bad, one["states"][0], f"per rank {per_rank}")
        with pytest.raises(AssertionError):
            assert_update_close(bad, one["states"][0], payload, f"averaged {average}")


def test_debug_nans_on_one_rank_raises_on_every_rank(tmp_path):
    """A NaN weight on rank 1 only, under debug_nans: both ranks raise
    FloatingPointError naming the module the one-rank step names, well
    inside the mesh's own timeout, and no checkpoint is written."""
    from tests.test_torch_parallel_tta import nan_rank

    cfg = tiny_config()
    t0 = time.monotonic()
    said = spawn(nan_rank, 2, args=(cfg, str(tmp_path / "run")), timeout=60)
    assert time.monotonic() - t0 < 60
    want = "debug_nans: the output of backbone.conv3_1 (Conv) is not finite"
    assert said == [want, want]
    assert not (tmp_path / "run").exists()
