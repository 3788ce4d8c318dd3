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
    for name in ("phase_pool", "conv12_wgrad"):
        assert len(_cuda_build.sources(name)) == 1
