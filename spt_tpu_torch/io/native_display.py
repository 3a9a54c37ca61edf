"""ctypes bindings for the native display bridge (``native/display.cpp``).

The port of ``spt_tpu/io/native_display.py``, over the same library,
found from this package's own path (``native/libdisplay.so`` at the repo
root; ``make -C native`` builds it).  The host-side loops of the display
(resolve / tonemap / quantize / pack, and PNG encoding) run in C++ where
the library loads; each entry returns None where it does not, and the
callers take ``core.color`` and ``io.image``'s own paths, which compute the
same values (held in ``tests/test_torch_io.py``).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

from .image import _host

_SO_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "..", "..", "native", "libdisplay.so")

_TONEMAP_CODES = {"none": 0, "reinhard": 1, "aces": 2}

_lib = None
_tried = False


def _load_native():
    """The library, or None where it is missing or will not load."""
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = os.path.normpath(_SO_PATH)
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    fp = ctypes.POINTER(ctypes.c_float)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.spt_resolve_pack.restype = ctypes.c_int
    lib.spt_resolve_pack.argtypes = [
        fp, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, fp, u32p, u8p]
    lib.spt_png_bound.restype = ctypes.c_long
    lib.spt_png_bound.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.spt_encode_png.restype = ctypes.c_long
    lib.spt_encode_png.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, u8p, ctypes.c_long]
    _lib = lib
    return _lib


def available() -> bool:
    return _load_native() is not None


def resolve_pack(accum, n_samples: float, *, exposure: float = 1.0,
                 auto_exposure: bool = False, target_exposure: float = 0.18,
                 tonemap: str = "none", gamma: float = 1.0,
                 ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(H,W,3) float32 radiance sum -> (f32 display, u32 RGBA8888, u8 RGB)
    as host arrays.

    Native analog of ``color.finalize_image`` + ``pack_rgba8`` +
    ``to_u8_array``; returns None where the library does not load.
    """
    lib = _load_native()
    if lib is None:
        return None
    arr = np.ascontiguousarray(_host(accum), np.float32)
    h, w = arr.shape[:2]
    n = h * w
    out_f32 = np.empty((h, w, 3), np.float32)
    out_rgba = np.empty((h, w), np.uint32)
    out_u8 = np.empty((h, w, 3), np.uint8)
    fp = ctypes.POINTER(ctypes.c_float)
    rc = lib.spt_resolve_pack(
        arr.ctypes.data_as(fp), ctypes.c_int(n), ctypes.c_float(n_samples),
        ctypes.c_float(exposure), ctypes.c_int(int(auto_exposure)),
        ctypes.c_float(target_exposure),
        ctypes.c_int(_TONEMAP_CODES[tonemap]), ctypes.c_float(gamma),
        out_f32.ctypes.data_as(fp),
        out_rgba.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        out_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        return None
    return out_f32, out_rgba, out_u8


def encode_png(rgb_u8, compress_level: int = 6) -> Optional[bytes]:
    """(H,W,3) uint8 -> PNG bytes via the native encoder (None where the
    library does not load)."""
    lib = _load_native()
    if lib is None:
        return None
    arr = np.ascontiguousarray(_host(rgb_u8), np.uint8)
    h, w = arr.shape[:2]
    cap = int(lib.spt_png_bound(ctypes.c_int(w), ctypes.c_int(h)))
    out = np.empty(cap, np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = int(lib.spt_encode_png(arr.ctypes.data_as(u8p), ctypes.c_int(w),
                               ctypes.c_int(h), ctypes.c_int(compress_level),
                               out.ctypes.data_as(u8p), ctypes.c_long(cap)))
    if n <= 0:
        return None
    return out[:n].tobytes()
