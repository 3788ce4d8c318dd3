"""The plain reference agrees with the port at a tiny size on the CPU: the
same parameter names and shapes, the forward, the detect tail bit for bit,
the int8 body and one train step."""
import numpy as np
import pytest
import torch

from benchmark import program, synthetic
from benchmark.reference import detect as ref_detect
from benchmark.reference import model as ref
from benchmark.reference import quant as ref_quant
from benchmark.reference import train as ref_train
from benchmark.tests.tiny import tiny_cell
from benchmark.weights import make_weights

torch.set_num_threads(2)
# oneDNN's float32 convolutions are less exact than the reference's
# tolerances on the CPU; its plain ATen path is not.
torch.backends.mkldnn.enabled = False
SEED = 2**31 + 77


@pytest.fixture(scope="module")
def f32():
    cell = tiny_cell("detect.bf16.b128", float32=True)
    dan = cell.config["dan"]
    cfg = program.dan_config(dan)
    w = make_weights(ref.param_spec(dan), SEED, "cpu")
    return dan, cfg, w, program.detector(cfg, w, "cpu").eval()


def _images(dan, n=2):
    s = dan["model"]["image_size"]
    g = torch.Generator().manual_seed(5)
    return torch.randint(0, 255, (n, s, s, 3), dtype=torch.uint8, generator=g)


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_param_spec_is_the_detectors_state_dict(f32):
    dan, _, _, model = f32
    got = {n: tuple(s) for n, s, _ in ref.param_spec(dan)}
    assert got == {n: tuple(t.shape) for n, t in model.state_dict().items()}


def test_weights_repeat_from_the_seed(f32):
    dan, _, w, _ = f32
    again = make_weights(ref.param_spec(dan), SEED, "cpu")
    other = make_weights(ref.param_spec(dan), SEED + 1, "cpu")
    assert all(torch.equal(w[n], again[n]) for n in w)
    assert not torch.equal(w["backbone.conv3_1.weight"], other["backbone.conv3_1.weight"])
    k = w["backbone.conv3_1.weight"]
    assert abs(float(k.std()) - (2.0 / (9 * 128)) ** 0.5) < 0.01 * (2.0 / (9 * 128)) ** 0.5 * 10


def test_forward_agrees_in_float32(f32):
    dan, cfg, w, model = f32
    from dan_tpu_torch.ops.preprocess import normalize_image

    u8 = _images(dan)
    with torch.no_grad():
        cls_p, loc_p = model(normalize_image(u8.float(), cfg.preprocess))
        cls_r, loc_r = ref.forward(w, dan, ref.normalize(u8, dan))
    assert _rel(cls_p, cls_r) < 1e-4 and _rel(loc_p, loc_r) < 1e-4


def test_detect_tail_is_bit_exact(f32):
    dan, cfg, w, model = f32
    from dan_tpu_torch.tools.bench import build_detect_fn

    u8 = _images(dan)
    captured = []
    h = model.register_forward_hook(lambda m, a, out: captured.append(out))
    det = build_detect_fn(cfg, "cpu")(model, u8)
    h.remove()
    s = dan["model"]["image_size"]
    want, _ = ref_detect.postprocess(captured[0][0], captured[0][1], dan, s, s)
    assert int(det["valid"].sum()) > 0
    assert ref_detect.mismatched_rows(det, want) == 0
    det = {k: v.clone() for k, v in det.items()}
    det["scores"][0, 0] += 1e-3
    assert ref_detect.mismatched_rows(det, want) == 1


def test_int8_body_agrees(f32):
    dan, cfg, w, model = f32
    from dan_tpu_torch import quant
    from dan_tpu_torch.ops.preprocess import normalize_image

    u8 = _images(dan, 3)
    x = normalize_image(u8.float(), cfg.preprocess)
    with torch.inference_mode():
        scales = quant.calibrate_act_scales(model, [x[:2]], cfg.model)
        cls_p, loc_p = quant.QuantizedDetector(model, scales).eval()(x)
    mine = ref_quant.calibrate(w, dan, ref.normalize(u8[:2], dan))
    for k, v in mine.items():
        np.testing.assert_allclose(v.numpy(), scales[k], rtol=1e-4, atol=1e-5)
    # Given the program's scales, the int8 body is exact: only the float
    # tail's order of sums differs.
    theirs = {k: torch.from_numpy(v) for k, v in scales.items()}
    cls_r, loc_r = ref_quant.forward(w, dan, ref.normalize(u8, dan), theirs)
    assert _rel(cls_p, cls_r) < 1e-5 and _rel(loc_p, loc_r) < 1e-5
    cls_4, loc_4 = ref_quant.forward(w, dan, ref.normalize(u8, dan),
                                     ref_quant.calibrate(w, dan, ref.normalize(u8[:2], dan), 7), 7)
    assert _rel(cls_4, cls_r) > 10 * _rel(cls_p, cls_r)


def test_train_step_agrees_in_float32():
    cell = tiny_cell("train.bf16.b32", float32=True)
    dan = cell.config["dan"]
    cfg = program.dan_config(dan)
    from dan_tpu_torch.ops.preprocess import AugmentDraws
    from dan_tpu_torch.train import loop

    w = make_weights(ref.param_spec(dan), SEED, "cpu")
    rng = np.random.default_rng(3)
    batch = synthetic.batch(dan, 4, rng)
    d = synthetic.draws(dan["preprocess"], 4, rng)
    d["on"][:] = True
    state = loop.create_train_state(cfg, device="cpu", model=program.detector(cfg, w, "cpu"))
    metrics = loop.train_step(state, batch, AugmentDraws(**{k: torch.from_numpy(v) for k, v in
                                                            d.items()}))
    p = {n: t.clone() for n, t in w.items()}
    mom = {n: torch.zeros_like(t) for n, t in p.items()}
    loss, grads = ref_train.loss_and_grads(
        p, dan, {k: torch.from_numpy(v) for k, v in batch.items()},
        {k: torch.from_numpy(v) for k, v in d.items()}, block=2)
    taken = ref_train.sgd(p, grads, mom, 0, dan["train"])
    assert abs(float(metrics["loss"]) - loss) < 1e-5 * abs(loss)
    wd = dan["train"]["weight_decay"]
    gap, _ = ref_train.worst_leaf_gap(ref_train.leaf_norms(
        {n: m - (wd * w[n] if n.endswith(".weight") else 0) for n, m in state.momentum.items()}),
        ref_train.leaf_norms(taken))
    change, _ = ref_train.worst_leaf_gap(
        ref_train.leaf_norms({n: q.detach() - w[n] for n, q in state.model.named_parameters()}),
        ref_train.leaf_norms({n: p[n] - w[n] for n in p}))
    assert gap < 1e-3 and change < 1e-3
