"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each `csrc/<name>.cu` becomes one shared library with a plain C interface,
`_build/<name>_<hash>.so`, where the hash covers the source, the headers it
includes from csrc/ (`#include "..."`, followed recursively) and the flags,
so a change to one kernel rebuilds only that one, and a change to a shared
header rebuilds every source that includes it.  Nothing is built when a
module is imported: the first CUDA call builds, or `build_all` builds
several sources at once with one nvcc process each, started together.

    lib = load("nms")                  # ctypes.CDLL, built on first use
    build_all(["matching", "phase_pool"])
    BUILDS["nms"].seconds, BUILDS["nms"].log   # nvcc time and ptxas output
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
BASE_FLAGS = ARCH + (
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Sources whose decisions compare floats (IoU thresholds, argmax), or whose
# sums must equal their plain versions' bit for bit, are built without FMA
# contraction, so they round as their plain versions do.
EXTRA_FLAGS = {
    "nms": ("-fmad=false",),
    "matching": ("-fmad=false",),
    "bbox_vote": ("-fmad=false",),
    "nms_blocked": ("-fmad=false",),
    "conv_i8": ("-fmad=false",),
    "quantize_i8": ("-fmad=false",),
    "bias_act": ("-fmad=false",),
    "l2norm": ("-fmad=false",),
    "lfpn_fuse": ("-fmad=false",),
    "upsample2x_bwd": ("-fmad=false",),
}


@dataclasses.dataclass
class Build:
    so: str
    seconds: Optional[float]  # None when the library was already built
    log: str


# name -> the build of that source in this process.
BUILDS: Dict[str, Build] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    for cand in (
        os.path.join(cuda_home, "bin", "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _flags(name: str):
    return BASE_FLAGS + EXTRA_FLAGS.get(name, ())


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str):
    """The files the build of csrc/<name>.cu reads from csrc/: the source,
    then each header it includes with quotes, in first-include order."""
    files = [os.path.join(CSRC, f"{name}.cu")]
    for path in files:  # grows while it is walked
        with open(path, "rb") as f:
            for inc in _INCLUDE.findall(f.read()):
                dep = os.path.join(os.path.dirname(path), inc.decode())
                if dep not in files:
                    files.append(dep)
    return files


def _target(name: str) -> str:
    h = hashlib.sha256()
    for path in sources(name):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(_flags(name)).encode())
    return os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")


def build_all(names: Iterable[str]) -> None:
    """Compile every named source that is not built yet, one nvcc process
    per source, all running at once.  Raises if any build fails."""
    names = [n for n in dict.fromkeys(names) if n not in BUILDS]
    pending = []
    for name in names:
        so = _target(name)
        if os.path.exists(so):
            BUILDS[name] = Build(so, None, "")
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *_flags(name), "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        pending.append((name, so, tmp, proc, time.perf_counter()))
    errors = []
    for name, so, tmp, proc, t0 in pending:
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode == 0:
            os.replace(tmp, so)
            BUILDS[name] = Build(so, seconds, out)
        else:
            errors.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n{out}")
        if os.path.exists(tmp):
            os.remove(tmp)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The library built from csrc/<name>.cu, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all([name])
        lib = _libs[name] = ctypes.CDLL(BUILDS[name].so)
    return lib


def ptxas_summary(name: str):
    """The lines of the ptxas log that give registers, spills and shared
    memory of each kernel in the source."""
    log = BUILDS[name].log if name in BUILDS else ""
    return [
        line.strip() for line in log.splitlines()
        if "registers" in line or "spill" in line or "smem" in line
        or "Compiling entry" in line
    ]


def check(err: int, what: str) -> None:
    """Raise on a nonzero CUDA error code returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what} failed: CUDA error {err}")


def stream_of(t) -> int:
    """The current CUDA stream of t's device, as an int for ctypes."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
