"""RetinaFace-R50 on the port's detect path (config.RetinaFaceConfig,
models/resnet.py, models/retinaface.py), on the CPU at the published
widths and depth with small images, against the benchmark's plain
reference (benchmark/reference/retinaface.py: float32, NCHW, BN unfolded),
on seeded weights whose BN statistics the reference calibrates:

  * the forward in float32 and in bf16, BN folding, the anchors at 840²,
    nearest resizing to a size, landmark decoding, the detect tail with
    landmarks against the reference tail on the same logits;
  * the residual pass's plain twin bit for bit against ATen's
    relu((y + b) + r) and a numpy model of the kernel's arithmetic, its
    wrapper's refusals, and its launches a forward (the card's dispatch
    taken with `layers._on_card` patched);
  * Detector.detect_batch with landmarks, and the paths that refuse the
    configuration by name.
"""
import copy
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dan_tpu_torch.api import Detector
from dan_tpu_torch.box.anchors import generate_anchors
from dan_tpu_torch.box.decode import decode_landmarks
from dan_tpu_torch.config import RetinaFaceConfig
from dan_tpu_torch.models import layers, resnet
from dan_tpu_torch.models.retinaface import RetinaFace
from dan_tpu_torch.ops import bias_act_cuda
from dan_tpu_torch.ops.postprocess import postprocess_batch
from dan_tpu_torch.train.loop import TrainState, create_train_state, train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from benchmark.reference import retinaface as ref  # noqa: E402
from benchmark.reference.lowp import fp8  # noqa: E402
from benchmark.reference.model import normalize  # noqa: E402
from benchmark.weights import make_weights  # noqa: E402

torch.set_num_threads(1)
SIZE = 96
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _dan(size=SIZE, dtype="float32"):
    """The configuration as the benchmark's file holds it, at `size`."""
    cfg = RetinaFaceConfig()
    out = {}
    for name in ("model", "anchors", "preprocess", "postprocess"):
        sec = dataclasses.asdict(getattr(cfg, name))
        out[name] = {k: (list(v) if isinstance(v, tuple) else v) for k, v in sec.items()}
    out["anchors"]["min_sizes"] = [list(s) for s in cfg.anchors.min_sizes]
    out["model"].update(image_size=size, compute_dtype=dtype)
    return out


def _config(size=SIZE, dtype="float32", **post):
    cfg = RetinaFaceConfig()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, image_size=size, compute_dtype=dtype),
        postprocess=dataclasses.replace(cfg.postprocess, **post))


@pytest.fixture(scope="module")
def seeded():
    """Weights from the benchmark's seeded draws, BN statistics calibrated
    by the reference over the images; (weights, images)."""
    dan = _dan()
    w = make_weights(ref.param_spec(dan), 2**31 + 5, "cpu")
    w.update(ref.bn_params(dan, 2**31 + 5, "cpu"))
    g = torch.Generator().manual_seed(5)
    images = normalize(torch.randint(0, 255, (2, SIZE, SIZE, 3), generator=g,
                                         dtype=torch.uint8), dan)
    with torch.no_grad():
        ref.calibrate(w, dan, images)
    return w, images


def _model(weights, dtype):
    model = RetinaFace(_config(dtype=dtype).model)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def _rel(got, want):
    g, w = torch.cat(got, -1), torch.cat(want, -1)
    return float(((g - w).flatten(1).norm(dim=1) / w.flatten(1).norm(dim=1)).max())


# float32: the program folds each BN into its conv in float32, the
# reference convolves and normalizes apart; those roundings, through 82
# convolutions, read 8.7e-6 to 9.1e-6 here on three seeds (1e-4 leaves ten
# times that).  bf16: activations and folded weights rounded to 8 bits at
# every layer read 0.075-0.079 of the logits (the random body amplifies a
# perturbation tens of times; the chip's 840² runs read 0.073-0.086), while
# the same forward with every conv input and kernel rounded to fp8 reads
# 0.61-0.63: 0.15 lies between.
TOLERANCE = {"f32": 1e-4, "bf16": 0.15}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_the_forward_matches_the_reference(seeded, dtype, monkeypatch):
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    weights, images = seeded
    dan = _dan()
    with torch.inference_mode():
        got = _model(weights, {"bf16": "bfloat16", "f32": "float32"}[dtype])(images)
        want = ref.forward(weights, dan, images)
    assert [t.shape[1] for t in got] == [RetinaFaceConfig().anchors.num_anchors(SIZE)] * 3
    assert [t.shape[2] for t in got] == [2, 4, 10] and all(t.dtype == torch.float32 for t in got)
    assert _rel(got, want) <= TOLERANCE[dtype]
    if dtype == "bf16":
        with torch.no_grad():
            assert _rel(ref.forward(weights, dan, images, quant=fp8), want) > 2 * TOLERANCE[dtype]


def test_bn_folding_equals_unfolded_bn():
    g = torch.Generator().manual_seed(1)
    conv, bn = resnet.Weight(64, 128, 3, g), resnet.BatchNorm(128)
    with torch.no_grad():
        for t, lo in ((bn.weight, 0.5), (bn.bias, -1.0), (bn.running_mean, -2.0),
                      (bn.running_var, 0.1)):
            t.copy_(lo + torch.rand(t.shape, generator=g) * 3)
    x = torch.randn(2, 64, 9, 9, generator=g)
    w, b = resnet.fold(conv.weight, bn, 1e-5, torch.float32)
    assert w.is_contiguous(memory_format=torch.channels_last) and b.dtype == torch.float32
    got = F.conv2d(x, w, b, 1, 1)
    want = F.batch_norm(F.conv2d(x, conv.weight, None, 1, 1), bn.running_mean, bn.running_var,
                        bn.weight, bn.bias, False, 0.0, 1e-5)
    assert torch.linalg.norm(got - want) <= 1e-5 * torch.linalg.norm(want)
    # The fold is cached while nothing changes, and made again after an
    # in-place update of a statistic.
    folded = resnet.FoldedConv(conv, bn, 1e-5)
    with torch.no_grad():
        first = folded.params(torch.float32)
        assert folded.params(torch.float32) is first
        bn.running_var.mul_(2)
        assert folded.params(torch.float32) is not first


def test_anchors_at_840():
    cfg = RetinaFaceConfig().anchors
    a = generate_anchors(cfg, 840, 840)
    assert cfg.feature_shapes(840) == ((105, 105), (53, 53), (27, 27))
    assert a.shape == (29126, 4) == (cfg.num_anchors(840), 4)
    # Position-major, size-minor: (j + 0.5) * step, row 0.
    assert a[:4].tolist() == [[4, 4, 16, 16], [4, 4, 32, 32], [12, 4, 16, 16], [12, 4, 32, 32]]
    assert a[2 * 105].tolist() == [4, 12, 16, 16]  # row 1
    assert a[2 * 105 * 105].tolist() == [8, 8, 64, 64]
    assert a[2 * (105 * 105 + 53 * 53) + 1].tolist() == [16, 16, 512, 512]
    assert a[-1].tolist() == [26.5 * 32, 26.5 * 32, 512, 512]
    assert torch.equal(a, ref.anchors(_dan(840), 840, 840, "cpu"))


@pytest.mark.parametrize("src,dst", [(53, 105), (27, 53)])
def test_nearest_resize_to_a_size(src, dst):
    x = torch.randn(2, 5, src, src).contiguous(memory_format=torch.channels_last)
    got = F.interpolate(x, size=(dst, dst), mode="nearest")  # models/retinaface.py's FPN
    idx = torch.arange(dst) * src // dst  # floor(i * in / out), exact in integers
    assert torch.equal(got, x[:, :, idx][:, :, :, idx])
    assert got.is_contiguous(memory_format=torch.channels_last)
    if src == 53:
        assert idx[:4].tolist() == [0, 0, 1, 1] and idx[-3:].tolist() == [51, 51, 52]


def test_landmark_decode():
    anchors = torch.tensor([[100.0, 50.0, 16.0, 32.0], [8.0, 8.0, 64.0, 64.0]])
    landm = torch.zeros(1, 2, 10)
    landm[0, 0, :4] = torch.tensor([1.0, -2.0, 0.5, 3.0])
    got = decode_landmarks(landm, anchors, (0.1, 0.1, 0.2, 0.2))
    # x = l * 0.1 * w + cx, y = l * 0.1 * h + cy
    assert torch.allclose(got[0, 0, :4], torch.tensor([101.6, 43.6, 100.8, 59.6]))
    assert torch.equal(got[0, 0, 4:], torch.tensor([100.0, 50.0] * 3))
    assert torch.equal(got[0, 1], torch.tensor([8.0, 8.0] * 5))
    landm = torch.randn(3, 2, 10)
    assert torch.equal(decode_landmarks(landm, anchors, (0.1, 0.1, 0.2, 0.2)),
                       ref.decode_landmarks(landm, anchors, (0.1, 0.1, 0.2, 0.2)))


@pytest.mark.parametrize("topk,max_det", [(300, 50), (40, 60)], ids=["topk300", "short_rows"])
def test_postprocess_with_landmarks_is_the_reference_tail(topk, max_det):
    """The port's tail on the CPU (the plain NMS) against the reference's,
    bit for bit on the same logits; DAN's dict keeps its three keys."""
    dan = _dan(64)
    dan["postprocess"].update(pre_nms_topk=topk, max_detections=max_det)
    cfg = _config(64, pre_nms_topk=topk, max_detections=max_det)
    g = torch.Generator().manual_seed(11)
    a = cfg.anchors.num_anchors(64)
    cls, loc, landm = (torch.randn(3, a, k, generator=g) * s for k, s in ((2, 2.0), (4, 1.0), (10, 1.0)))
    anchors = generate_anchors(cfg.anchors, 64, 64)
    got = postprocess_batch(cls, loc, anchors, cfg.anchors, cfg.postprocess, 64.0, 64.0,
                            landm_preds=landm)
    want = ref.postprocess(cls, loc, landm, dan, 64, 64)
    assert set(got) == {"bboxes", "scores", "valid", "landmarks"}
    assert got["landmarks"].shape == (3, max_det, 10)
    assert int(got["valid"].sum()) > 0
    assert ref.mismatched_rows(got, want) == 0
    for k in want:
        assert torch.equal(got[k], want[k]), k
    plain = postprocess_batch(cls, loc, anchors, cfg.anchors, cfg.postprocess, 64.0, 64.0)
    assert set(plain) == {"bboxes", "scores", "valid"}
    for k in plain:
        assert torch.equal(plain[k], got[k])


def _values(shape, dtype, seed):
    """Normal values with NaN, infinities, both zeros and bf16 ties mixed in."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(shape, generator=g) * 3
    flat = y.view(-1)
    specials = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.0, -0.0, 1.0,
                             1.0078125, -1.0, -1.0078125, 2.0 ** -8])
    idx = torch.randperm(flat.numel(), generator=g)[: 4 * len(specials)]
    flat[idx] = specials.repeat(4)
    return y.to(dtype)


def _round_bf16(x32: np.ndarray) -> np.ndarray:
    u = x32.view(np.uint32).astype(np.uint64)
    out = ((((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16).astype(np.uint32)).view(np.float32)
    return np.where(np.isnan(x32), np.float32("nan"), out)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_the_residual_pass_is_atens_add_add_clamp(dtype):
    dt = DTYPES[dtype]
    c = 64
    y = _values((2, 5, 3, c), dt, seed=1).permute(0, 3, 1, 2)  # channels-last (2, C, 5, 3)
    r = _values((2, 5, 3, c), dt, seed=2).permute(0, 3, 1, 2)
    b = torch.randn(c, generator=torch.Generator().manual_seed(3))
    b[:3] = torch.tensor([2.0 ** -8, -0.0, 0.0])
    want = F.relu((y + b.to(dt)[:, None, None]) + r)
    got = bias_act_cuda.bias_residual_relu(y, b, r)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(bias_act_cuda.bias_residual_relu(y, b.to(dt), r)), _bits(want))
    # The kernel's arithmetic in numpy over the (pixels, C) buffers: the sum
    # with the bias rounded to y's dtype, then the sum with r rounded, then
    # the clamp passing NaN.
    rnd = _round_bf16 if dt == torch.bfloat16 else (lambda v: v)
    yv, rv = (t.permute(0, 2, 3, 1).reshape(-1, c).float().numpy() for t in (y, r))
    v = rnd((rnd(yv + rnd(b.numpy())) + rv).astype(np.float32))
    v = np.where(np.isnan(v), v, np.maximum(v, np.float32(0)))
    out = got.permute(0, 2, 3, 1).reshape(-1, c).float().numpy()
    nan = np.isnan(v)
    assert np.array_equal(np.isnan(out), nan) and np.array_equal(out[~nan], v[~nan])
    if dt == torch.bfloat16:
        # Two roundings, not one: (1 + 2^-8) rounds to 1 before r = 2^-8 is
        # added, and 1 + 2^-8 ties to 1 again; one float32 sum would give 1 + 2^-7.
        one = torch.ones(1, 1, dtype=dt)
        tie = bias_act_cuda.bias_residual_relu_plain(one, torch.tensor([2.0 ** -8]),
                                                     torch.full((1, 1), 2.0 ** -8, dtype=dt))
        assert tie.float().item() == 1.0


@pytest.mark.parametrize("case", ["r_dtype", "r_shape", "r_strides", "cpu_launch"])
def test_the_residual_wrapper_refuses(case):
    y = torch.zeros(2, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    r = {"r_dtype": torch.zeros_like(y).bfloat16(),
         "r_shape": torch.zeros(2, 8, 4, 5).contiguous(memory_format=torch.channels_last),
         "r_strides": torch.zeros(2, 8, 4, 4),
         "cpu_launch": torch.zeros_like(y)}[case]
    call = bias_act_cuda._launch_residual if case == "cpu_launch" else bias_act_cuda.bias_residual_relu
    with pytest.raises(ValueError, match="CUDA" if case == "cpu_launch" else "r must"):
        call(y, torch.zeros(8), r)


def test_a_forward_takes_60_plain_passes_and_16_residual_ones(seeded, monkeypatch):
    """With the card's dispatch taken on the CPU (the plain versions in the
    kernels' place): the counts of chip_smoke.py's phase 24 and the logits
    of ATen's path."""
    monkeypatch.setattr(torch.backends.mkldnn, "enabled", False)
    calls = {"bias_act": 0, "residual": 0}
    real_plain, real_res = bias_act_cuda.bias_act, bias_act_cuda.bias_residual_relu

    def plain(y, b, relu):
        calls["bias_act"] += 1
        return real_plain(y, b, relu)

    def residual(y, b, r):
        calls["residual"] += 1
        return real_res(y, b, r)

    model = _model(seeded[0], "float32")
    x = seeded[1]
    with torch.inference_mode():
        want = model(x)
        assert calls == {"bias_act": 0, "residual": 0}
        monkeypatch.setattr(bias_act_cuda, "bias_act", plain)
        monkeypatch.setattr(bias_act_cuda, "bias_residual_relu", residual)
        monkeypatch.setattr(layers, "_on_card", lambda t: True)
        got = model(x)
    assert calls == {"bias_act": 60, "residual": 16}
    assert len(resnet.bottleneck_shapes(model.config, 840)) == 16
    for g, w in zip(got, want):
        assert torch.linalg.norm(g - w) <= 1e-5 * torch.linalg.norm(w)


def test_detect_batch_returns_landmarks():
    det = Detector.from_random(0, _config(64, pre_nms_topk=200, max_detections=20), device="cpu")
    rng = np.random.default_rng(0)
    images = [rng.integers(0, 255, (50, 60, 3), dtype=np.uint8),
              rng.integers(0, 255, (64, 40, 3), dtype=np.uint8)]
    out = det.detect_batch(images)
    assert len(out) == 2
    for o in out:
        assert set(o) == {"bboxes", "scores", "landmarks"}
        n = len(o["scores"])
        assert o["bboxes"].shape == (n, 4) and o["landmarks"].shape == (n, 10)
        assert np.isfinite(o["landmarks"]).all()
    one = det.detect(images[0])
    assert one["landmarks"].shape == (len(one["scores"]), 10)


@pytest.mark.parametrize("path", ["detect_tta", "warmup_tta", "quantize_int8", "train_step",
                                  "create_train_state", "from_checkpoint"])
def test_paths_that_refuse_the_configuration_name_it(path, tmp_path):
    cfg = _config(64)
    det = Detector.from_random(0, cfg, device="cpu")
    image = np.zeros((64, 64, 3), np.uint8)
    calls = {
        "detect_tta": lambda: det.detect_tta(image),
        "warmup_tta": lambda: det.warmup_tta([(64, 64)]),
        "quantize_int8": lambda: det.quantize_int8([image]),
        "train_step": lambda: train_step(TrainState(det.model, {}, 0, cfg), {}),
        "create_train_state": lambda: create_train_state(cfg, 0, "cpu"),
        "from_checkpoint": lambda: Detector.from_checkpoint(str(tmp_path / "x.pt"), cfg, "cpu"),
    }
    with pytest.raises(NotImplementedError, match="RetinaFace-R50"):
        calls[path]()


def test_the_configuration_file_is_the_ports_default():
    """benchmark/configs/retinaface_r50.bf16.json's model, anchors,
    preprocess and postprocess sections hold RetinaFaceConfig's defaults."""
    import json

    with open(os.path.join(REPO, "benchmark", "configs", "retinaface_r50.bf16.json")) as f:
        conf = json.load(f)
    want = _dan(840, "bfloat16")
    assert conf["reduced"] == [] and conf["precision"] == "bfloat16"
    for name in want:
        assert copy.deepcopy(conf["dan"][name]) == want[name], name
