"""ctypes bridge to the native image-geometry kernel.

PyTorch-port counterpart of :mod:`tpu_compressed_dp.data.native`: builds
``tpu_compressed_dp_torch/native/image_ops.cpp`` with ``g++`` on first use
into ``build/native/`` at the root of the checkout (keyed by a hash of the
source; never beside the source) and exposes :func:`crop_resize`, the fused
crop + PIL-BILINEAR resize + horizontal flip on uint8 RGB arrays.  ctypes
releases the GIL for the call, so the loaders' thread pools parallelise
across images.

Unlike the JAX package, nothing falls back: a failed build raises, and the
loaders use PIL only where the caller asks for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

__all__ = ["crop_resize", "build", "lib_path"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "image_ops.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def lib_path() -> str:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(_BUILD_DIR, f"libimageops_{tag}.so")


def build() -> str:
    """Compile the kernel unless the library for this source exists; returns
    its path.  Raises ``RuntimeError`` if ``g++`` fails."""
    out = lib_path()
    if not os.path.exists(out):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-fPIC", "-shared", "-pthread", _SRC, "-o", tmp]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        except OSError as err:
            raise RuntimeError(f"native image kernel: cannot run g++: {err}") from err
        if res.returncode != 0:
            raise RuntimeError(f"native image kernel failed to build: {res.stderr[-500:]}")
        os.replace(tmp, out)  # atomic against a concurrent build
    return out


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            lib.crop_resize_bilinear.restype = ctypes.c_int
            lib.crop_resize_bilinear.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
            _LIB = lib
    return _LIB


def crop_resize(src: np.ndarray, box: Tuple[float, float, float, float],
                out_h: int, out_w: int, flip: bool = False) -> np.ndarray:
    """Crop ``box`` (x0, y0, x1, y1) from an HWC uint8 RGB array, resize to
    (out_h, out_w) with PIL-BILINEAR semantics, optionally mirror."""
    lib = _load()
    src = np.ascontiguousarray(src, dtype=np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"expected HWC RGB uint8, got {src.shape}")
    dst = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.crop_resize_bilinear(
        src.ctypes.data, src.shape[0], src.shape[1],
        float(box[0]), float(box[1]), float(box[2]), float(box[3]),
        dst.ctypes.data, out_h, out_w, int(bool(flip)),
    )
    if rc != 0:
        raise RuntimeError(f"crop_resize_bilinear failed with code {rc}")
    return dst
