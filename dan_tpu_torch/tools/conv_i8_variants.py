"""Where the int8 convolution's time goes: csrc/conv_i8.cu built in variants
that each leave one part out, timed on the bench shapes (batch 128, 640x640).

    python -m dan_tpu_torch.tools.conv_i8_variants [--iters 5]

Variants (each a copy of the source with a few lines replaced, built with
the kernel's own flags into a temporary directory; the outputs of all but
`full` are wrong and are not checked):
  full         the kernel as it is;
  no_epilogue  the tile's epilogue skipped (loads + products);
  no_mma       no wgmma issued (loads + epilogue);
  no_load      no TMA load issued, the stages handed over empty (products +
               epilogue);
  mma_only     neither loads nor epilogue (the products alone);
  no_vec       the epilogue's per-channel vectors taken as constants (no
               loads of deq / bias / inv_next from shared memory).
The difference between two variants bounds what the part left out costs
where the kernel cannot overlap it.  Prints one line a layer with each
variant's ms (CUDA events, mean of --iters launches after one warm-up),
and the card's name and power limit.  Needs one CUDA card.

A manual diagnostic, run by hand: nothing in the port or chip_smoke.py
calls it.  It edits exact lines of the source, so an edit to those lines
needs one here too (tests/test_torch_conv_i8_plan.py checks that every
variant still applies).
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import torch

from dan_tpu_torch.models.vgg import pack_conv_kernel_2x2_phase
from dan_tpu_torch.ops import _cuda_build, conv_i8_cuda
from dan_tpu_torch.ops.conv_i8 import same_padding_2d
from dan_tpu_torch.quant import quantize_kernel

_SKIP_EPILOGUE = ("    // ---- epilogue", "    if (p.co_out >= 0) continue;\n    // ---- epilogue")
_SKIP_LOADS = [
    ("mbar_expect_tx(full, p.a_bytes + n_b * p.b_bytes);", "mbar_arrive(full);"),
    ("tma_load_4d(a, &p.map_x, full, st0.c, x0 + st0.dx, y0 + st0.dy, b);", ""),
    ("tma_load_2d(a + p.a_bytes + u * p.b_bytes, &p.map_k, full, st.k, n0 + st.n);", ""),
]
_CONST_VEC = (
    """  v.deq = *reinterpret_cast<const float2 *>(vecs + n);
  v.bias = *reinterpret_cast<const float2 *>(vecs + co + n);
  v.inv = *reinterpret_cast<const float2 *>(vecs + 2 * co + n);""",
    """  v.deq = make_float2(1e-5f, 1e-5f + n);
  v.bias = make_float2(0.1f, 0.2f);
  v.inv = make_float2(10.f, 11.f);""")
_MMA_CALL = re.compile(r"wgmma_n\d+<[^>]*>\(acc[^;]*;")

VARIANTS = {
    "full": [],
    "no_epilogue": [_SKIP_EPILOGUE],
    "no_mma": "no_mma",
    "no_load": _SKIP_LOADS,
    "mma_only": [_SKIP_EPILOGUE] + _SKIP_LOADS,
    "no_vec": [_CONST_VEC],
}

# (name, H = W, Ci, Co, k, tap dtype, phase max): the layers timed.
LAYERS = [
    ("conv1_2' + phase max", 320, 256, 256, 2, None, True),
    ("conv2_1", 320, 64, 128, 3, None, False),
    ("conv2_2", 320, 128, 128, 3, None, False),
    ("conv3_2", 160, 256, 256, 3, None, False),
    ("conv3_3 (bf16 tap + s8)", 160, 256, 256, 3, torch.bfloat16, False),
    ("conv4_2", 80, 512, 512, 3, None, False),
]


def variant_source(src: str, name: str) -> str:
    reps = VARIANTS[name]
    if reps == "no_mma":
        out, n = _MMA_CALL.subn("", src)
        if n == 0:
            raise RuntimeError("no wgmma call found in the source")
        return out
    for old, new in reps:
        if old not in src:
            raise RuntimeError(f"variant {name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    return src


def build_variants(tmp: str):
    """{variant: ctypes library}, one nvcc each, all at once."""
    with open(os.path.join(_cuda_build.CSRC, "conv_i8.cu")) as f:
        src = f.read()
    procs = {}
    for name in VARIANTS:
        path = os.path.join(tmp, f"{name}.cu")
        with open(path, "w") as f:
            f.write(variant_source(src, name))
        cmd = [_cuda_build._nvcc(), *_cuda_build._flags("conv_i8"), "-I", _cuda_build.CSRC,
               "-o", os.path.join(tmp, f"{name}.so"), path]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")
        spills = sorted({line.split(",")[1].strip() for line in out.splitlines()
                         if "spill stores" in line})
        print(f"built {name}: {', '.join(spills)}")
        lib = ctypes.CDLL(os.path.join(tmp, f"{name}.so"))
        ints = ctypes.POINTER(ctypes.c_int)
        lib.conv_i8_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ints] * 3
            + [ctypes.c_void_p])
        lib.conv_i8_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def cuda_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m dan_tpu_torch.tools.conv_i8_variants")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv_i8_variants: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev).to(torch.int8)

    def vec(co, lo, hi):
        return torch.empty(co, device=dev).uniform_(lo, hi, generator=g)

    real_build = conv_i8_cuda.build
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp)
        try:
            for name, hw, ci, co, k, tap_dtype, phase in LAYERS:
                x = rnd((args.batch, hw, hw, ci))
                if phase:
                    kf = torch.randn((co // 4, ci // 4, 3, 3), device=dev, generator=g)
                    kq = quantize_kernel(pack_conv_kernel_2x2_phase(kf))[0]
                    pad = (1, 1, 1, 1)
                else:
                    kq = rnd((co, k, k, ci))
                    pad = same_padding_2d(hw, hw, k, k, 1, 1)
                deq, bias, inv = vec(co, 1e-6, 1e-5), vec(co, -1, 1), vec(co, 1, 20)
                times = []
                for variant, lib in libs.items():
                    conv_i8_cuda.build = lambda lib=lib: lib
                    ms = cuda_ms(lambda: conv_i8_cuda.conv_i8(
                        x, kq, deq, bias, inv, 1, 1, pad, tap_dtype, phase_max=phase), args.iters)
                    times.append(f"{variant} {ms:.3f}")
                print(f"{name}: {', '.join(times)} ms | {conv_i8_cuda.LAST_PLAN.describe()} "
                      f"({smi})", flush=True)
                del x
        finally:
            conv_i8_cuda.build = real_build
    return 0


if __name__ == "__main__":
    sys.exit(main())
