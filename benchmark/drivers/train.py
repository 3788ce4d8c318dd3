"""Driver of the train mixes: `dan_tpu_torch.train.loop.train_step` back to
back on one train state, the way a trainer's loop calls it.

Traffic (the mix's "params"):
  batch, pool        images a step; seeded host batches (benchmark/synthetic.py)
                     that the steps cycle through
  warmup_steps       steps made in set-up, back to back as the window makes them
  checked_steps      the window's first steps, which the reference follows (it
                     follows the set-up's steps too, to reach them)
  check_block        images the reference computes at a time
  trace_steps        steps profiled in a --trace 1 run, after the checked ones

Every step gets its own augmentation draws from the seed, and the set-up's
and checked steps each take another batch of the pool.  The rate counts the
images of the steps completed over the window, which ends with a
synchronise; the step's metrics stay on the card, and the readings the
check needs are device copies taken between the steps, which wait for
nothing.

The check (`check`) follows the set-up's and the checked steps with the
reference in float32: each step's loss (`loss_gap`, the worst relative
gap); the gradient as the optimizer took it at the first step and at the
window's first step, worked out from the momentum and the parameters
around each (`grad_gap`: the median leaf's gap, the larger of the two);
and the parameters' change over the checked steps (`change_gap`: the
worst leaf's gap).  A leaf's gap is the gap between the program's norm and
the reference's over the larger of that leaf's and the median leaf's
reference norm.  The worst leaf's gradient gap is logged, not compared: it
is the noise of one small head leaf, another on every seed.  Leaves whose
reference gradient at the window's first step is under a thousandth of the
median leaf's are left out of the change (they move by round-off).
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import program, synthetic
from benchmark.harness import Outcome, Run, log
from benchmark.reference import model as ref
from benchmark.reference import train as ref_train
from benchmark.reference.lowp import rounding
from benchmark.weights import make_weights

FAULTS = ("half_batch", "unchanged_state")
SMALL_LEAF = 1e-3


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _program_draws(d: Dict[str, np.ndarray]):
    from dan_tpu_torch.ops.preprocess import AugmentDraws

    return AugmentDraws(**{k: torch.from_numpy(v) for k, v in d.items()})


def _followed(p: Dict) -> int:
    return p["warmup_steps"] + p["checked_steps"]


def _reference_steps(run: Run, st: Dict, quant=None) -> Dict:
    """The set-up's and the checked steps by the reference -> the readings
    the check compares: losses, the gradients as taken at step 0 and at the
    window's first step, the parameters before and after the checked
    steps (on the device)."""
    tc, w = run.dan["train"], run.params["warmup_steps"]
    p = {n: x.detach().clone() for n, x in st["weights"].items()}
    mom = {n: torch.zeros_like(x) for n, x in p.items()}
    out = {"losses": [], "grads": [], "before": None}
    with ref.float32_exact():
        for k in range(_followed(run.params)):
            if k == w:
                out["before"] = {n: x.clone() for n, x in p.items()}
            batch = _to_device(st["pool"][k % len(st["pool"])], run.device)
            d = {n: torch.from_numpy(v).to(run.device) for n, v in st["draws"][k].items()}
            loss, grads = ref_train.loss_and_grads(p, run.dan, batch, d,
                                                   run.params["check_block"], quant)
            taken = ref_train.sgd(p, grads, mom, k, tc)
            out["losses"].append(loss)
            if k in (0, w):
                out["grads"].append(ref_train.leaf_norms(taken))
            del grads, taken
    out["after"] = p
    return out


def setup(run: Run) -> Dict:
    from dan_tpu_torch.train import loop

    p, dan = run.params, run.dan
    cfg = program.dan_config(dan)
    weights = make_weights(ref.param_spec(dan), run.seed, run.device)
    rng = np.random.default_rng([run.seed, 4])
    pool = [synthetic.batch(dan, p["batch"], rng) for _ in range(p["pool"])]
    if len(pool) < _followed(p):
        raise SystemExit("the mix's pool must give each followed step its own batch")
    draw_rng = np.random.default_rng([run.seed, 5])
    draws = [synthetic.draws(dan["preprocess"], p["batch"], draw_rng) for _ in range(_followed(p))]
    queued = list(draws)
    st = {"weights": weights, "pool": pool, "loop": loop, "draws": draws,
          "next_draws": lambda: (queued.pop(0) if queued else
                                 synthetic.draws(dan["preprocess"], p["batch"], draw_rng))}
    if run.control:
        st["readings"] = _reference_steps(run, st, quant=rounding(run.cell.config["precision"]))
        return st
    model = program.detector(cfg, weights, run.device)
    st["state"] = loop.create_train_state(cfg, device=run.device, model=model)
    st["losses"], st["momentum"], st["params"] = [], {}, {}
    _faults(run, loop)
    _steps(run, st, n=p["warmup_steps"])
    return st


def _faults(run: Run, loop) -> None:
    if run.fault is None:
        return
    if run.fault not in FAULTS:
        raise SystemExit(f"unknown fault {run.fault!r}; the train driver has {FAULTS}")
    if run.fault == "half_batch":
        inner = loop.preprocess_and_match

        def half(*a, **k):
            images, targets = inner(*a, **k)
            h = len(images) // 2
            return images[:h], type(targets)(*(t[:h] for t in targets))
        run.patch(loop, "preprocess_and_match", half)
    else:
        def unchanged(named, grads, momentum, step, config):
            return torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
        run.patch(loop, "sgd_update", unchanged)


def _copy(named) -> Dict[str, torch.Tensor]:
    """A device copy of each tensor: it waits for nothing."""
    return {n: t.detach().clone() for n, t in named}


def _keep(run: Run, st: Dict, metrics) -> None:
    """After a followed step: its loss, and the momentum and parameters the
    check reads (after the first step, and around the checked steps)."""
    state, w = st["state"], run.params["warmup_steps"]
    k = state.step  # steps done
    st["losses"].append(metrics["loss"])
    if k in (1, w, w + 1):
        st["momentum"][k] = _copy(state.momentum.items())
    if k in (w, _followed(run.params)):
        st["params"][k] = _copy(state.model.named_parameters())


def _steps(run: Run, st: Dict, n=None, deadline=None, least=0) -> int:
    """train_step back to back: n steps, or until the deadline and at
    least until `least` steps are done in all."""
    loop, pool, state, k = st["loop"], st["pool"], st["state"], 0
    followed = _followed(run.params)
    while (n is not None and k < n) or (deadline is not None and (
            time.perf_counter() < deadline or state.step < least)):
        metrics = loop.train_step(state, pool[state.step % len(pool)],
                                  _program_draws(st["next_draws"]()))
        if state.step <= followed:
            _keep(run, st, metrics)
        k += 1
    return k


def window(run: Run, st: Dict) -> Outcome:
    p = run.params
    if run.control:
        return Outcome(0.0, attempted=0, failed=0)
    cuda = torch.device(run.device).type == "cuda"
    units = {}
    t0 = time.perf_counter()
    steps = 0
    if run.tracer is not None:
        # The checked steps first, so that the profiled stretch is steady
        # and holds none of the check's copies.
        steps += _steps(run, st, n=max(0, _followed(p) - st["state"].step))
        with run.tracer.stretch():
            steps += _steps(run, st, n=p["trace_steps"])
        units = {"steps": p["trace_steps"], "images": p["trace_steps"] * p["batch"]}
    steps += _steps(run, st, deadline=t0 + run.seconds, least=_followed(p))
    if cuda:
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    images = steps * p["batch"]
    return Outcome(images / elapsed, attempted=images, failed=0, units=units)


def _program_readings(run: Run, st: Dict) -> Dict:
    """The program's readings in the reference's form, from the device
    copies taken between its steps."""
    tc, w = run.dan["train"], run.params["warmup_steps"]
    mu, wd = tc["momentum"], tc["weight_decay"]
    mom, par = st.pop("momentum"), st.pop("params")
    p0 = st["weights"]

    def taken(m_after, m_before, params):
        out = {}
        for n, m in m_after.items():
            g = m.double()
            if m_before is not None:
                g = g - mu * m_before[n].double()
            if n.endswith(".weight"):
                g = g - wd * params[n].double()
            out[n] = float(g.norm())
        return out

    grads = [taken(mom[1], None, p0)]
    if w > 0:
        grads.append(taken(mom[w + 1], mom[w], par[w]))
    return {"losses": [float(x) for x in st.pop("losses")], "grads": grads,
            "before": par[w] if w > 0 else p0, "after": par[_followed(run.params)]}


def _changes(r: Dict) -> Dict[str, float]:
    return ref_train.leaf_norms({n: r["after"][n] - r["before"][n] for n in r["after"]})


def check(run: Run, st: Dict) -> Dict[str, float]:
    got = st.pop("readings") if run.control else _program_readings(run, st)
    st.pop("state", None)
    if torch.device(run.device).type == "cuda":
        torch.cuda.empty_cache()
    if len(got["losses"]) != _followed(run.params):
        log(f"check: {len(got['losses'])} followed steps, not {_followed(run.params)}")
        return {"loss_gap": float("inf"), "grad_gap": float("inf"), "change_gap": float("inf")}
    want = _reference_steps(run, st)
    g_r = want["grads"][-1]
    med = float(np.median(list(g_r.values())))
    moved = [n for n, v in g_r.items() if v >= SMALL_LEAF * med]
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
    grad_gaps = [ref_train.median_leaf_gap(a, b) for a, b in zip(got["grads"], want["grads"])]
    worst: List = [ref_train.worst_leaf_gap(a, b) for a, b in zip(got["grads"], want["grads"])]
    change_gap, c_leaf = ref_train.worst_leaf_gap(_changes(got), _changes(want), moved)
    log(f"check: losses {got['losses']} vs reference {want['losses']}; median-leaf gradient "
        f"gaps {grad_gaps}; worst gradient leaves {worst} (not compared); worst change leaf "
        f"{c_leaf}; {len(g_r) - len(moved)} leaves left out of the change")
    return {"loss_gap": loss_gap, "grad_gap": max(grad_gaps), "change_gap": change_gap}
