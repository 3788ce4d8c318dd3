"""The port's own copies of the configuration and data code: equal to the
JAX package's, importable with `dan_tpu` and `jax` blocked, and entry
points that refuse to run without a card unless asked for the CPU."""
import dataclasses
import inspect
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import dan_tpu.config as ref_config
import dan_tpu.data.synthetic as ref_synthetic
import dan_tpu_torch
import dan_tpu_torch.config as port_config
from dan_tpu_torch.api import Detector
from dan_tpu_torch.ckpt.bridge import params_to_jax
from dan_tpu_torch.config import from_reference
from dan_tpu_torch.data.synthetic import synthetic_batch
from dan_tpu_torch.device import resolve_device
from dan_tpu_torch.eval.tta import TTARunner
from dan_tpu_torch.models.detector import DANDetector
from dan_tpu_torch.tools.entry import entry
from dan_tpu_torch.train import create_train_state

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_CLASSES = [
    name for name, obj in vars(ref_config).items()
    if dataclasses.is_dataclass(obj) and isinstance(obj, type)
]


def test_every_reference_dataclass_has_a_twin():
    assert len(CONFIG_CLASSES) == 10
    for name in CONFIG_CLASSES:
        assert dataclasses.is_dataclass(getattr(port_config, name)), name


@pytest.mark.parametrize("name", CONFIG_CLASSES)
def test_fields_and_defaults_equal_the_reference(name):
    ref, port = getattr(ref_config, name), getattr(port_config, name)
    rf, pf = dataclasses.fields(ref), dataclasses.fields(port)
    assert [f.name for f in pf] == [f.name for f in rf]
    required = [f.name for f in rf if f.default is dataclasses.MISSING]
    kwargs = {"stride": 4, "anchor_size": 16.0} if required else {}
    assert sorted(kwargs) == sorted(required)
    assert dataclasses.asdict(port(**kwargs)) == dataclasses.asdict(ref(**kwargs))


def test_from_reference_round_trip():
    ref = ref_config.DANConfig(
        model=ref_config.ModelConfig(image_size=64, compute_dtype="float32"),
        anchors=ref_config.AnchorConfig(
            layers=(ref_config.AnchorLayerConfig(8, 32.0, offset=0.25),)
        ),
        tta=ref_config.TTAConfig(buckets=(64, 128), scales=(0.5,)),
        train=ref_config.TrainConfig(lr_boundaries=(5, 9), batch_size=4),
    )
    port = from_reference(ref)
    assert isinstance(port, port_config.DANConfig)
    assert isinstance(port.anchors.layers[0], port_config.AnchorLayerConfig)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.tta.buckets == (64, 128) and port.train.lr_boundaries == (5, 9)
    hash(port)  # stays hashable: generate_anchors_np caches on it
    assert from_reference(port) == port
    assert from_reference(ref_config.default_config()) == port_config.default_config()


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_config_is_the_reference_dryrun_config(n):
    """tools/dryrun_multichip.py trains in float32 on the card and on the
    CPU alike: its config is the one the JAX package's dry run builds
    (__graft_entry__.py::dryrun_multichip), field by field, and takes no
    dtype or device."""
    from dan_tpu_torch.tools import dryrun_multichip as dry

    ref = ref_config.DANConfig(
        model=ref_config.ModelConfig(image_size=64, compute_dtype="float32"),
        preprocess=ref_config.PreprocessConfig(train_image_size=64, canvas_size=128),
        match=ref_config.MatchConfig(max_gt=8),
        train=ref_config.TrainConfig(batch_size=8 * max(n, 1), hnm_min_negatives=8),
    )
    got = dry.tiny_config(n)
    for field in dataclasses.fields(ref):
        assert dataclasses.asdict(getattr(got, field.name)) == dataclasses.asdict(
            getattr(ref, field.name)), field.name
    assert got == from_reference(ref) and got.model.compute_dtype == "float32"
    assert list(inspect.signature(dry.tiny_config).parameters) == ["n_ranks"]


def test_synthetic_batch_copy_equals_the_reference():
    ref = ref_config.DANConfig(
        preprocess=ref_config.PreprocessConfig(train_image_size=64, canvas_size=128),
        match=ref_config.MatchConfig(max_gt=8),
    )
    a = ref_synthetic.synthetic_batch(ref, 3, seed=5)
    b = synthetic_batch(from_reference(ref), 3, seed=5)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _port_modules():
    names = [
        m.name for m in pkgutil.walk_packages(dan_tpu_torch.__path__, "dan_tpu_torch.")
    ]
    return sorted(names + ["dan_tpu_torch", "chip_smoke"])


# What the port and chip_smoke.py must not import: the JAX package, JAX, and
# what the card's host lacks (TensorFlow, orbax, google_crc32c, protobuf).
BLOCKED = ("dan_tpu", "jax", "jaxlib", "tensorflow", "orbax", "google_crc32c", "google.protobuf")
# The bench entry points, each a CLI (tools/entry.py is a function).
BENCH_MODULES = ("bench", "bench_train", "bench_tta_dataset", "bench_int8")


def test_port_and_chip_smoke_import_with_dan_tpu_and_jax_blocked():
    """Every module of the port and chip_smoke.py import in an interpreter
    whose finder refuses `dan_tpu`, `jax`, `jaxlib`, `tensorflow`, `orbax`,
    `google_crc32c` and `google.protobuf`, and none of them is loaded; nor
    is PIL, after the native loader has looked for PIL's libjpeg."""
    mods = _port_modules()
    assert "dan_tpu_torch.eval.__main__" in mods and "dan_tpu_torch.data.pipeline" in mods
    assert {"dan_tpu_torch.parallel.mesh", "dan_tpu_torch.parallel.spawn",
            "dan_tpu_torch.tools.dryrun_multichip"} <= set(mods)
    assert {"dan_tpu_torch.quant", "dan_tpu_torch.ops.conv_i8", "dan_tpu_torch.ops.conv_i8_cuda",
            "dan_tpu_torch.ops.quantize_i8_cuda", "dan_tpu_torch.ops.threefry",
            "dan_tpu_torch.tools.smoke_e2e"} <= set(mods)
    assert {"dan_tpu_torch.utils.crc32c", "dan_tpu_torch.ckpt.tf_bundle",
            "dan_tpu_torch.ckpt.tf_import", "dan_tpu_torch.ckpt.load",
            "dan_tpu_torch.ckpt.convert"} <= set(mods)
    assert {"dan_tpu_torch.native", "dan_tpu_torch.data.pipeline",
            "dan_tpu_torch.tools.profile_host_feed"} <= set(mods)
    assert {f"dan_tpu_torch.tools.{m}" for m in BENCH_MODULES + ("entry",)} <= set(mods)
    code = (
        "import importlib, importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if any(name == b or name.startswith(b + '.') for b in {BLOCKED!r}):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules\n"
        f"             if any(m == b or m.startswith(b + '.') for b in {BLOCKED!r}))\n"
        "assert not bad, bad\n"
        # The native loader finds PIL's libjpeg without importing PIL.
        "sys.modules['dan_tpu_torch.native'].libjpeg()\n"
        "assert not [m for m in sys.modules if m == 'PIL' or m.startswith('PIL.')]\n"
        "print('blocked-import-ok', len(sys.modules))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "blocked-import-ok" in proc.stdout


def tiny():
    return port_config.DANConfig(
        model=port_config.ModelConfig(image_size=64, compute_dtype="float32"),
        preprocess=port_config.PreprocessConfig(train_image_size=64, canvas_size=128),
        match=port_config.MatchConfig(max_gt=8),
        postprocess=port_config.PostprocessConfig(pre_nms_topk=64, max_detections=8),
        tta=port_config.TTAConfig(buckets=(64, 128)),
        train=port_config.TrainConfig(batch_size=2),
    )


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device exists")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)


@pytest.mark.parametrize(
    "make",
    [
        lambda cfg, **kw: Detector.from_random(0, cfg, **kw),
        lambda cfg, **kw: Detector(DANDetector(cfg.model), cfg, **kw),
        lambda cfg, **kw: TTARunner(DANDetector(cfg.model), cfg, **kw),
        lambda cfg, **kw: create_train_state(cfg, 0, **kw),
        # entry() -> (fn, (model, images)): the images' device.
        lambda cfg, **kw: entry(cfg, params=params_to_jax(DANDetector(cfg.model).state_dict()),
                                **kw)[1][1],
    ],
    ids=["from_random", "Detector", "TTARunner", "create_train_state", "entry"],
)
def test_entry_points_default_to_the_card_and_take_the_cpu_on_request(make):
    cfg = tiny()
    obj = make(cfg, device="cpu")
    assert obj.device.type == "cpu"
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(cfg)


@pytest.mark.parametrize("module", ["dan_tpu_torch.train", "dan_tpu_torch.eval"]
                         + [f"dan_tpu_torch.tools.{m}" for m in BENCH_MODULES])
def test_clis_raise_without_a_card(module, tmp_path):
    _no_card()
    args = {
        "dan_tpu_torch.train": ["--synthetic", "--steps", "1", "--model_dir", str(tmp_path)],
        "dan_tpu_torch.eval": ["--wider_root",
                               os.path.join(REPO, "tests", "fixtures", "mini_wider"),
                               "--limit", "1", "--no_tta"],
        "dan_tpu_torch.tools.bench_train": ["--iters", "1"],
        "dan_tpu_torch.tools.bench_tta_dataset": ["--images", "1"],
    }.get(module, [])
    env = {k: v for k, v in os.environ.items() if not k.startswith("DAN_BENCH_")}
    proc = subprocess.run(
        [sys.executable, "-m", module, *args], cwd=REPO,
        env=dict(env, PYTHONPATH=REPO), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_checkpoint_entry_points_need_the_card_or_the_cpu(tmp_path):
    """Detector.from_checkpoint and the train CLI's --warm_start: the CPU on
    request, an error without a card (before any file is read)."""
    from dan_tpu_torch.ckpt.load import save_npz
    from dan_tpu_torch.ckpt.bridge import params_to_jax

    cfg = tiny()
    npz = str(tmp_path / "w.npz")
    save_npz(params_to_jax(DANDetector(cfg.model).state_dict()), npz)
    assert Detector.from_checkpoint(npz, cfg, device="cpu").device.type == "cpu"
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Detector.from_checkpoint(npz, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Detector.from_checkpoint(str(tmp_path / "missing.npz"), cfg)
    proc = subprocess.run(
        [sys.executable, "-m", "dan_tpu_torch.train", "--synthetic", "--steps", "1",
         "--warm_start", npz, "--model_dir", str(tmp_path / "run")], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
