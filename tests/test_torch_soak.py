"""The port's soak and host-feed tools on the CPU: the fixture soak
(TF-free TFRecords -> TrainPipeline -> train steps -> checkpoint -> the
eval CLI with the official .mat ground truth) at 2 steps of batch 2 ends
with the AP line; make_synth_wider writes what scripts/make_synth_wider.py
writes; convert_tfrecords writes the shards the module writes;
profile_host_feed runs at a small --n; TrainPipeline.stop() joins its
producers; tools/profile.py's kernel table links kernels to their ops on
made-up events; and the tools raise without a card."""
import filecmp
import io
import os
import subprocess
import sys

import pytest
import torch

from dan_tpu_torch.config import DANConfig, MatchConfig, ModelConfig, PreprocessConfig
from dan_tpu_torch.data import tfrecords
from dan_tpu_torch.tools import convert_tfrecords, make_synth_wider, profile_host_feed
from dan_tpu_torch.tools import soak_fixture_e2e as soak

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_fixture_soak_two_steps(tmp_path, capsys):
    cfg = DANConfig(model=ModelConfig(image_size=64, compute_dtype="float32"),
                    preprocess=PreprocessConfig(train_image_size=64, canvas_size=128),
                    match=MatchConfig(max_gt=8))
    args = soak.parse_args(["--steps", "2", "--batch", "2", "--work_dir", str(tmp_path),
                            "--device", "cpu"])
    out = soak.run(args, cfg)
    lines = out["eval_stdout"].strip().splitlines()
    assert lines[-1].startswith("WIDER FACE val AP  easy=")
    assert out["loss"] > 0 and out["img_s"] > 0 and out["tfrecord_bytes"] > 0
    assert os.path.exists(os.path.join(out["model_dir"], "step_00000002.pt"))
    assert len(os.listdir(tmp_path / "tfr")) == 4
    assert "tfrecord roundtrip OK: 20 images" in capsys.readouterr().err


def test_make_synth_wider_equals_the_reference(tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    assert make_synth_wider.main(["--out", port, "--n", "12", "--events", "3"]) == 0
    proc = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "make_synth_wider.py"),
                           "--out", ref, "--n", "12", "--events", "3"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    split = os.path.join("wider_face_split", "wider_face_val_bbx_gt.txt")
    assert filecmp.cmp(os.path.join(port, split), os.path.join(ref, split), shallow=False)
    for event in sorted(os.listdir(os.path.join(ref, "WIDER_val", "images"))):
        d = os.path.join("WIDER_val", "images", event)
        names = sorted(os.listdir(os.path.join(ref, d)))
        assert sorted(os.listdir(os.path.join(port, d))) == names
        match, mismatch, errors = filecmp.cmpfiles(os.path.join(port, d), os.path.join(ref, d),
                                                   names, shallow=False)
        assert not mismatch and not errors


def test_convert_tfrecords_cli(tmp_path, capsys):
    fix = os.path.join(REPO, "tests", "fixtures", "mini_wider")
    assert convert_tfrecords.main(["--wider_root", fix, "--split", "val", "--output_dir",
                                   str(tmp_path), "--num_shards", "3"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        "converting 20 images -> 3 shards", f"wrote 3 shards under {tmp_path}"]
    paths = tfrecords.shard_paths(str(tmp_path), "val", 3)
    assert sum(1 for _ in tfrecords.read_tfrecords(paths)) == 20


def test_profile_host_feed_small(capsys):
    out = profile_host_feed.run(profile_host_feed.parse_args(
        ["--n", "6", "--batch", "2", "--steps", "2"]))
    printed = capsys.readouterr().out
    assert set(out["ms"]) == {"read", "decode", "meta", "place", "collate"}
    assert all(v > 0 for v in out["ms"].values()) and out["per_img_ms"] > out["serial_ms"]
    assert sorted(out["pipeline_img_s"]) == ["cv2", "native"]
    assert all(sorted(v) == [1, 2, 4] for v in out["pipeline_img_s"].values())
    nat = out["native"]
    assert set(nat["ms"]) == {"read", "meta", "decode_crop", "decode_full", "collate"}
    assert all(v > 0 for v in nat["ms"].values()) and nat["per_img_ms"] > nat["serial_ms"]
    assert nat["fallback"] == 0
    assert "decode full image" in printed and "decode crop-window" in printed
    assert printed.count("scaling (cv2): ") == 2 and printed.count("scaling (native): ") == 2
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in printed


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device exists")


def test_tools_default_to_the_card(tmp_path):
    """Without --device the tools run on the first CUDA card, and raise
    without one (profile needs a card whatever --device says)."""
    _no_card()
    fix_img = os.path.join(REPO, "tests", "fixtures", "mini_wider", "WIDER_val", "images")
    event = sorted(os.listdir(fix_img))[0]
    image = os.path.join(fix_img, event, sorted(os.listdir(os.path.join(fix_img, event)))[0])
    for module, args in (("demo", ["--image", image]),
                         ("soak_fixture_e2e", ["--steps", "1", "--work_dir", str(tmp_path)]),
                         ("profile", ["detect", "--batch", "1"]),
                         ("profile", ["train", "--device", "cpu"]),
                         ("dryrun_multichip", ["2"])):
        proc = subprocess.run([sys.executable, "-m", f"dan_tpu_torch.tools.{module}", *args],
                              cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0, (module, args)
        assert "no CUDA device" in proc.stderr or "needs a CUDA device" in proc.stderr, \
            proc.stderr[-1000:]


def test_pipeline_stop_joins_its_producers():
    """TrainPipeline.stop() returns once every producer (and its decode
    pool) is done, so a caller may delete the files after it."""
    import threading

    from dan_tpu_torch.data.pipeline import TrainPipeline
    from dan_tpu_torch.data.widerface import load_split

    cfg = DANConfig(model=ModelConfig(image_size=64), preprocess=PreprocessConfig(
        train_image_size=64, canvas_size=128), match=MatchConfig(max_gt=8))
    records = load_split(os.path.join(REPO, "tests", "fixtures", "mini_wider"), "val")
    pipe = TrainPipeline(records, cfg, batch_size=4, num_workers=3, num_producers=4)
    it = iter(pipe)
    assert [next(it)["canvas"].shape for _ in range(3)] == [(4, 128, 128, 3)] * 3
    it.close()
    stopper = threading.Thread(target=pipe.stop)
    stopper.start()
    stopper.join(60)
    assert not stopper.is_alive()
    assert len(pipe._threads) == 4 and not any(t.is_alive() for t in pipe._threads)


def test_closing_the_pipeline_stream_joins_its_producers():
    """Closing the stream that iter(TrainPipeline) returned (as the train
    CLI's prefetch thread does at the end of train()) returns once every
    producer and its decode pool is done, without a call to stop()."""
    import threading

    from dan_tpu_torch.data.pipeline import TrainPipeline
    from dan_tpu_torch.data.widerface import load_split

    cfg = DANConfig(model=ModelConfig(image_size=64), preprocess=PreprocessConfig(
        train_image_size=64, canvas_size=128), match=MatchConfig(max_gt=8))
    records = load_split(os.path.join(REPO, "tests", "fixtures", "mini_wider"), "val")
    before = set(threading.enumerate())
    pipe = TrainPipeline(records, cfg, batch_size=4, num_workers=3, num_producers=2)
    it = iter(pipe)
    assert next(it)["canvas"].shape == (4, 128, 128, 3)
    closer = threading.Thread(target=it.close)
    closer.start()
    closer.join(60)
    assert not closer.is_alive()
    assert not [t for t in threading.enumerate() if t not in before and t.is_alive()]


def test_profile_kernel_table_links_kernels_to_ops():
    """tools/profile.py's table from made-up profiler events: a kernel under
    the op that launched it, the FLOPs of an enclosing op shared by kernel
    time, and a launch linked to no op under "-"."""
    from types import SimpleNamespace as NS

    from dan_tpu_torch.tools import profile as profile_tool

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    kern = lambda name, us: NS(name=name, duration=us)  # noqa: E731
    conv2d = NS(id=1, name="aten::conv2d", device_type=cpu, kernels=[], flops=6e9,
                cpu_parent=None, input_shapes=[[2, 3]])
    cudnn = NS(id=2, name="aten::cudnn_convolution", device_type=cpu, flops=0,
               kernels=[kern("sm90_fprop", 1000.0), kern("cast", 500.0)], cpu_parent=conv2d,
               input_shapes=[[2, 3], [4, 3]])
    mine = NS(id=3, name="Conv12Backward", device_type=cpu, flops=0, cpu_parent=None,
              kernels=[kern("wgrad_kernel(x)", 3000.0)], input_shapes=[])
    device = [NS(name=n, device_type=cuda, time_range=NS(elapsed_us=lambda us=us: us))
              for n, us in (("sm90_fprop", 1000.0), ("cast", 500.0), ("wgrad_kernel(x)", 3000.0),
                            ("nms_rank_kernel(y)", 250.0), ("nms_rank_kernel(y)", 250.0))]
    prof = NS(events=lambda: [conv2d, cudnn, mine] + device)
    total, rows = profile_tool.kernel_table(prof, iters=2)
    assert total == 5000.0 / 2
    by = {(r.name, r.op): r for r in rows}
    assert [r.name for r in rows][:1] == ["wgrad_kernel(x)"]
    assert by[("wgrad_kernel(x)", "Conv12Backward")].flops == 0
    fprop = by[("sm90_fprop", "aten::cudnn_convolution [[2, 3], [4, 3]]")]
    assert fprop.launches == 1 and fprop.flops == pytest.approx(4e9)
    assert by[("nms_rank_kernel(y)", "-")].launches == 2
    out = io.StringIO()
    profile_tool.print_table(total, rows, 2, 10, out)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("total device kernel time: 5.000 ms => 2.500 ms/iter")
    assert any("4000.0" in ln and "sm90_fprop" in ln for ln in lines)  # 4 GFLOP in 1 ms
