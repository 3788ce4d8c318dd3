"""The build of the port's CUDA sources (ops/_cuda_build.py), on the CPU:
a library's name hashes its source AND the headers it includes, so an edit
to a shared header rebuilds every source that includes it instead of
loading a stale library."""
import os

from dan_tpu_torch.ops import _cuda_build


def test_target_hashes_the_included_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include <math.h>\n#include "a.cuh"\nint f();\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  #  include "b.cuh"\n#include "a.cuh"\n')
    (tmp_path / "b.cuh").write_text("// one\n")
    monkeypatch.setattr(_cuda_build, "CSRC", str(tmp_path))
    assert [os.path.basename(p) for p in _cuda_build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    first = _cuda_build._target("k")
    (tmp_path / "b.cuh").write_text("// two\n")
    edited = _cuda_build._target("k")
    assert edited != first
    (tmp_path / "b.cuh").write_text("// one\n")
    assert _cuda_build._target("k") == first


def test_the_iou_sources_share_one_header():
    for name in ("nms", "nms_blocked", "matching", "bbox_vote"):
        assert [os.path.basename(p) for p in _cuda_build.sources(name)] == [
            f"{name}.cu", "box_iou.cuh"]
        assert "-fmad=false" in _cuda_build._flags(name)
    for name in ("phase_pool", "conv12_wgrad", "conv12_wgrad_f32"):
        assert len(_cuda_build.sources(name)) == 1


def test_every_source_is_built_for_sm_90a():
    """Every kernel source in csrc/, the float32 conv1_2' weight gradient's
    among them, gets its own library name and the sm_90a target."""
    names = sorted(f[:-3] for f in os.listdir(_cuda_build.CSRC) if f.endswith(".cu"))
    assert "conv12_wgrad_f32" in names and "conv12_wgrad" in names
    targets = {_cuda_build._target(n) for n in names}
    assert len(targets) == len(names)
    for name in names:
        assert "arch=compute_90a,code=sm_90a" in _cuda_build._flags(name)


def test_two_processes_building_one_source_leave_one_whole_library(tmp_path):
    """Ranks that find a library missing at once each compile it to a file
    of their own and rename it into place: the library under the target
    name is always whole, and nothing else is left behind.  A stand-in
    nvcc writes 4 MB slowly, so the two builds overlap."""
    import subprocess
    import sys

    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(
        "#!/usr/bin/env python3\n"
        "import sys, time\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "with open(out, 'wb') as f:\n"
        "    for _ in range(16):\n"
        "        f.write(b'x' * (1 << 18)); f.flush(); time.sleep(0.05)\n")
    nvcc.chmod(0o755)
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "k.cu").write_text("int f();\n")
    code = (
        "import sys\n"
        "from dan_tpu_torch.ops import _cuda_build as b\n"
        f"b.CSRC, b.BUILD_DIR = {str(tmp_path / 'src')!r}, {str(tmp_path / 'build')!r}\n"
        "b.build_all(['k'])\n"
        "print(b.BUILDS['k'].so)\n"
    )
    env = dict(os.environ, CUDA_HOME=str(tmp_path / "cuda"),
               PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    (so,) = {o.strip() for o, _ in outs}
    assert os.listdir(tmp_path / "build") == [os.path.basename(so)]
    assert os.path.getsize(so) == 16 << 18
