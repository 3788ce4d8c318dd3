"""On-demand build + ctypes loaders for the port's host C++ helpers (the
counterpart of dan_tpu/native/).

Two libraries live here, each compiled with g++ into
dan_tpu_torch/_build/native/ (content-hashed) the first time it is needed,
then loaded via ctypes:

- overlaps.cc: the AP protocol's hot loops (IoU matrix, greedy gt
  matching), built with -ffp-contract=off so that it rounds as the numpy
  matcher of eval/widerface_ap.py does, bit for bit.
- loader.cc: the train feed's threaded JPEG window decode straight into the
  (B, C, C, 3) batch canvases.  It links the libjpeg-turbo (6.2 ABI) that
  PIL's wheel ships in site-packages/pillow.libs/, by path, compiled against
  the headers in native/include/; without it, the system's -ljpeg when its
  jpeglib.h compiles.

    native.image_eval(dets, gts, ignore, 0.5)   # None: use numpy
    native.load_loader()                        # None: use cv2
    native.loader_unavailable_reason()          # why it is None
    native.BUILD_SECONDS["loader"]              # g++ time, None if cached

Callers treat a loader returning None as 'use the Python fallback'.
Importing this module builds nothing, and it never imports PIL.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import importlib.util
import os
import subprocess
import sys
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
INCLUDE = os.path.join(_HERE, "include")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build", "native")
FLAGS = {
    # No FMA contraction: numpy, the oracle, rounds every product and sum.
    "overlaps": ("-O3", "-march=native", "-ffp-contract=off"),
    "loader": ("-O3", "-march=native", "-pthread"),
}

_lock = threading.Lock()
_libs: Dict[str, Optional[ctypes.CDLL]] = {}  # None = unavailable, don't retry
_reasons: Dict[str, str] = {}  # name -> why it is unavailable
# name -> seconds g++ took in this process, or None when the library was
# already built.
BUILD_SECONDS: Dict[str, Optional[float]] = {}


def pil_libjpeg() -> Optional[str]:
    """The libjpeg-turbo of the 6.2 ABI that PIL's wheel ships beside the
    installed PIL package (pillow.libs/libjpeg-*.so.62*), or None.  Found
    through the import system's spec of PIL: PIL itself is not imported."""
    spec = importlib.util.find_spec("PIL")
    if spec is None or not spec.submodule_search_locations:
        return None
    for pkg in spec.submodule_search_locations:
        hits = sorted(glob.glob(os.path.join(os.path.dirname(pkg), "pillow.libs",
                                             "libjpeg-*.so.62*")))
        if hits:
            return hits[0]
    return None


def _system_libjpeg() -> Optional[str]:
    """The system's libjpeg.so when its jpeglib.h compiles, else None."""
    probe = subprocess.run(
        ["g++", "-x", "c++", "-fsyntax-only", "-"],
        input="#include <cstdio>\n#include <jpeglib.h>\n", capture_output=True, text=True)
    if probe.returncode != 0:
        return None
    path = subprocess.run(["g++", "-print-file-name=libjpeg.so"], capture_output=True,
                          text=True).stdout.strip()
    return os.path.realpath(path) if os.path.isabs(path) and os.path.exists(path) else None


def libjpeg() -> Tuple[Optional[str], Tuple[str, ...], str]:
    """(the libjpeg file loader.cc links, the g++ arguments that link it,
    why there is none).  PIL's first, then the system's."""
    path = pil_libjpeg()
    if path is not None:
        return path, ("-I" + INCLUDE, path, "-Wl,-rpath," + os.path.dirname(path)), ""
    try:
        path = _system_libjpeg()
    except OSError as e:  # no g++
        return None, (), f"no libjpeg: {e}"
    if path is not None:
        return path, ("-ljpeg",), ""
    return None, (), ("no libjpeg: PIL ships no pillow.libs/libjpeg-*.so.62*, and the "
                      "system's jpeglib.h does not compile")


def _gxx_version() -> str:
    try:
        return subprocess.run(["g++", "--version"], capture_output=True,
                              text=True).stdout.splitlines()[0]
    except (OSError, IndexError):
        return "unknown"


def cache_key(name: str, flags: Sequence[str], libjpeg_path: Optional[str] = None) -> str:
    """The hash that names native/<name>.cc's library: the source, the
    headers of native/include/ when the flags use them, the flags, g++'s
    version, the machine and the libjpeg linked (its path and its bytes).
    -march=native binaries from another host would SIGILL instead of
    rebuilding, and a library built against another libjpeg would link it."""
    h = hashlib.sha256()
    files = [os.path.join(_HERE, f"{name}.cc")]
    if "-I" + INCLUDE in flags:
        files += sorted(glob.glob(os.path.join(INCLUDE, "*.h")))
    for path in files:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update("\0".join([*flags, _gxx_version(), os.uname().machine]).encode())
    if libjpeg_path is not None:
        h.update(libjpeg_path.encode())
        with open(libjpeg_path, "rb") as f:
            h.update(hashlib.sha256(f.read()).digest())
    return h.hexdigest()[:16]


def _load_lib(name: str) -> Optional[ctypes.CDLL]:
    """Build (once, content-hashed) and load native/<name>.cc; None, with
    the reason in _reasons, when it cannot be built or loaded."""
    with _lock:
        if name in _libs:
            return _libs[name]
        flags, jpeg, link = FLAGS[name], None, ()
        if name == "loader":
            jpeg, link, why = libjpeg()
            if jpeg is None:
                _reasons[name], _libs[name] = why, None
                return None
        try:
            so = os.path.join(BUILD_DIR, f"{name}_{cache_key(name, flags + link, jpeg)}.so")
            if os.path.exists(so):
                BUILD_SECONDS[name] = None
            else:
                os.makedirs(BUILD_DIR, exist_ok=True)
                # Each process writes its own file and renames it into place:
                # processes that build at once never load a half-written library.
                tmp = f"{so}.tmp{os.getpid()}"
                t0 = time.perf_counter()
                cmd = ["g++", *flags, "-shared", "-fPIC", "-o", tmp,
                       os.path.join(_HERE, f"{name}.cc"), *link]
                try:
                    proc = subprocess.run(cmd, capture_output=True, text=True)
                    if proc.returncode != 0:
                        raise RuntimeError(
                            f"g++ failed ({proc.returncode}): {proc.stderr[-2000:]}")
                    os.replace(tmp, so)
                finally:
                    if os.path.exists(tmp):
                        os.remove(tmp)
                BUILD_SECONDS[name] = time.perf_counter() - t0
            _libs[name] = ctypes.CDLL(so)
        except (OSError, RuntimeError) as e:  # toolchain/permissions missing -> fallback
            _reasons[name], _libs[name] = f"{name} unavailable: {e}", None
            print(f"[dan_tpu_torch.native] {_reasons[name]}", file=sys.stderr)
        return _libs[name]


def loader_unavailable_reason() -> Optional[str]:
    """Why load_loader() returns None (trying it first), or None when the
    loader library is loaded."""
    return None if load_loader() is not None else _reasons.get("loader")


def load() -> Optional[ctypes.CDLL]:
    """The eval-kernel library (overlaps.cc)."""
    lib = _load_lib("overlaps")
    if lib is not None and not getattr(lib, "_sigs_set", False):
        lib.bbox_overlaps.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.bbox_overlaps.restype = None
        lib.image_eval.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.image_eval.restype = None
        lib._sigs_set = True
    return lib


def load_loader() -> Optional[ctypes.CDLL]:
    """The JPEG data-loader library (loader.cc, links libjpeg)."""
    lib = _load_lib("loader")
    if lib is not None and not getattr(lib, "_sigs_set", False):
        lib.dan_jpeg_dims.argtypes = [
            ctypes.c_char_p,
            ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.dan_jpeg_dims.restype = ctypes.c_int
        lib.dan_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int,
        ] + [ctypes.POINTER(ctypes.c_int)] * 6 + [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.dan_decode_batch.restype = None
        lib._sigs_set = True
    return lib


def jpeg_dims(buf: bytes) -> Optional[Tuple[int, int]]:
    """(width, height) from the JPEG header, or None (bad file / no lib)."""
    lib = load_loader()
    if lib is None:
        return None
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.dan_jpeg_dims(buf, len(buf), ctypes.byref(w), ctypes.byref(h))
    return (w.value, h.value) if rc == 0 else None


def jpeg_exif_orientation(buf: bytes) -> Optional[int]:
    """EXIF Orientation tag (1..8) from JPEG bytes, or None if absent.

    libjpeg ignores EXIF, but cv2.imread applies it — so the native decode
    path must detect a non-default orientation and hand such images to the
    cv2 fallback, keeping the two paths geometrically identical."""
    try:
        if len(buf) < 4 or buf[0:2] != b"\xff\xd8":
            return None
        i = 2
        while i + 4 <= len(buf):
            if buf[i] != 0xFF:
                return None
            # Any number of 0xFF fill bytes may pad a marker (JPEG spec);
            # treat runs of 0xFF as one marker prefix.
            while i + 4 <= len(buf) and buf[i + 1] == 0xFF:
                i += 1
            marker = buf[i + 1]
            if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
                i += 2
                continue
            if marker == 0xDA:  # start of scan: no APP1 ahead
                return None
            seg_len = int.from_bytes(buf[i + 2 : i + 4], "big")
            if marker == 0xE1 and buf[i + 4 : i + 10] == b"Exif\x00\x00":
                tiff = i + 10
                order = buf[tiff : tiff + 2]
                if order == b"II":
                    end = "little"
                elif order == b"MM":
                    end = "big"
                else:
                    return None

                def u16(off):
                    return int.from_bytes(buf[off : off + 2], end)

                def u32(off):
                    return int.from_bytes(buf[off : off + 4], end)

                ifd = tiff + u32(tiff + 4)
                n = u16(ifd)
                for e in range(n):
                    entry = ifd + 2 + 12 * e
                    if entry + 12 > len(buf):
                        return None
                    if u16(entry) == 0x0112:  # Orientation
                        # Trust the value only for a well-formed tag:
                        # type 3 (SHORT), count 1.  A LONG-typed or
                        # malformed tag would read the wrong bytes (e.g.
                        # big-endian LONG -> 0 -> 'orientation 1' -> a
                        # rotated image decoded natively, mis-aligning gt
                        # boxes).  Return a non-1 sentinel instead so the
                        # caller takes the cv2 fallback — the safe
                        # direction.
                        if u16(entry + 2) == 3 and u32(entry + 4) == 1:
                            return u16(entry + 8)
                        return -1  # truthy non-1: pipeline's `or 1` guard
                        # maps 0/None to 'orientation 1' (native path), so
                        # the unknown sentinel must survive it
                return None
            i += 2 + seg_len
        return None
    except Exception:
        return None


def decode_batch_into(
    bufs: Sequence[bytes],
    src_x: np.ndarray,
    src_y: np.ndarray,
    dst_x: np.ndarray,
    dst_y: np.ndarray,
    win_w: np.ndarray,
    win_h: np.ndarray,
    canvases: np.ndarray,
    nthreads: int = 0,
):
    """Threaded window-decode: the source window (src_x, src_y, win_w,
    win_h) of bufs[i] lands at (dst_x, dst_y) of canvases[i]; all other
    canvas bytes are zeroed in C++. Returns a status int32 array —
    status[i] != 0 means image i failed and its slot is zeros (the caller
    decodes that one via its Python fallback; loader.cc names the codes).
    Returns None when the native library is unavailable."""
    lib = load_loader()
    if lib is None:
        return None
    n = len(bufs)
    if not (canvases.dtype == np.uint8 and canvases.flags["C_CONTIGUOUS"]
            and canvases.ndim == 4 and canvases.shape[0] == n and canvases.shape[3] == 3
            and canvases.shape[1] == canvases.shape[2]):
        raise ValueError(f"canvases must be C-contiguous uint8 ({n}, C, C, 3), got "
                         f"{canvases.dtype} {canvases.shape}")
    buf_ptrs = (ctypes.c_char_p * n)(*bufs)
    sizes = (ctypes.c_longlong * n)(*[len(b) for b in bufs])

    def _iptr(a):
        a = np.ascontiguousarray(a, np.int32)
        if a.shape != (n,):
            raise ValueError(f"window arrays must be ({n},), got {a.shape}")
        return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))

    keep = [_iptr(a) for a in (src_x, src_y, dst_x, dst_y, win_w, win_h)]
    status = np.zeros((n,), np.int32)
    if nthreads <= 0:
        nthreads = min(n, os.cpu_count() or 1)
    lib.dan_decode_batch(
        buf_ptrs,
        sizes,
        n,
        *[p for _, p in keep],
        int(canvases.shape[1]),
        canvases.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(nthreads),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return status


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _boxes(a: np.ndarray, cols: int, what: str) -> np.ndarray:
    a = np.ascontiguousarray(a, np.float64)
    if a.ndim != 2 or a.shape[1] < cols:
        raise ValueError(f"{what} must be (n, {cols}), got {a.shape}")
    return np.ascontiguousarray(a[:, :cols])


def bbox_overlaps(dets: np.ndarray, gts: np.ndarray) -> Optional[np.ndarray]:
    """(n, 4) x (m, 4) corner IoU matrix in float64, or None (no library)."""
    lib = load()
    if lib is None:
        return None
    dets = _boxes(dets, 4, "dets")
    gts = _boxes(gts, 4, "gts")
    out = np.empty((len(dets), len(gts)), np.float64)
    lib.bbox_overlaps(
        _ptr(dets, ctypes.c_double),
        len(dets),
        _ptr(gts, ctypes.c_double),
        len(gts),
        _ptr(out, ctypes.c_double),
    )
    return out


def image_eval(
    dets: np.ndarray, gts: np.ndarray, ignore: np.ndarray, iou_thresh: float
):
    """Native greedy matcher; returns (pred_recall, proposal) or None.
    dets (n, 5) score-descending, gts (m, 4), ignore (m,) bool."""
    lib = load()
    if lib is None:
        return None
    dets = _boxes(dets, 5, "dets")
    gts = _boxes(np.asarray(gts).reshape(-1, 4), 4, "gts")
    ignore = np.ascontiguousarray(ignore, np.uint8)
    n, m = len(dets), len(gts)
    if ignore.shape != (m,):
        raise ValueError(f"ignore must be ({m},), got {ignore.shape}")
    pred_recall = np.empty((n,), np.int64)
    proposal = np.empty((n,), np.int64)
    lib.image_eval(
        _ptr(dets, ctypes.c_double),
        n,
        _ptr(gts, ctypes.c_double),
        m,
        _ptr(ignore, ctypes.c_uint8),
        iou_thresh,
        _ptr(pred_recall, ctypes.c_int64),
        _ptr(proposal, ctypes.c_int64),
    )
    return pred_recall, proposal
