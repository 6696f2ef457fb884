"""ctypes binding to the native C++ batch image loader (``native/loader.cpp``).

The port's own copy of the JAX package's ``data/loader_native.py``. The
native loader decodes, resizes and preprocesses a batch of images with a
pthread pool, writing straight into a caller-provided float32 buffer: the
'caffe' convention (BGR, ImageNet mean subtracted; vgg) and 'inception' (RGB
in [-1, 1]), at any square size. ``available()`` is False when
``native/libimgloader.so`` has not been built (``make -C native``, which
needs the libjpeg and libpng headers); the callers then take the PIL path.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for cand in (os.path.join(here, "native", "libimgloader.so"),
                 os.path.join(os.path.dirname(__file__), "libimgloader.so")):
        if os.path.exists(cand):
            try:
                lib = ctypes.CDLL(cand)
                lib.load_batch.restype = ctypes.c_int
                lib.load_batch.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                           ctypes.POINTER(ctypes.c_float), ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int]
                _LIB = lib
                break
            except (OSError, AttributeError):
                # AttributeError: a stale build without load_batch counts as absent
                continue
    return _LIB


def available() -> bool:
    return _lib() is not None


_MODES = {"caffe": 0, "inception": 1}


def load_batch(paths: list[str], size: int = 224, mode: str = "caffe",
               num_threads: int = 8) -> np.ndarray:
    """Decode + resize + preprocess a batch -> (B, size, size, 3) float32."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native loader not built (make -C native)")
    if mode not in _MODES or size <= 0:
        raise ValueError(f"invalid size/mode: {size}, {mode!r} (modes: {sorted(_MODES)})")
    n = len(paths)
    out = np.empty((n, size, size, 3), dtype=np.float32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.load_batch(arr, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                        size, _MODES[mode], num_threads)
    if rc == -1:
        raise ValueError(f"invalid size/mode: {size}, {mode}")
    if rc != 0:
        raise RuntimeError(f"native loader failed on {rc-1}-th image: {paths[rc-1]}")
    return out


def load_batch_vgg(paths: list[str], num_threads: int = 8) -> np.ndarray:
    """Decode + resize + VGG-preprocess a batch -> (B, 224, 224, 3) float32 BGR."""
    return load_batch(paths, 224, "caffe", num_threads)
