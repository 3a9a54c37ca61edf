"""Image output: the host side of the display.

The port of ``spt_tpu/io/image.py``.  A tensor is brought to the host once
(``.detach().cpu().numpy()``); from there the writers are the JAX
package's: PNG by the native encoder (``native/libdisplay.so``), else
Pillow, else a dependency-free pure-Python writer (zlib); raw float
radiance as ``.npy``; binary PPM for debugging; Radiance ``.hdr`` and
float ``.exr`` through ``io.hdr`` and ``io.exr``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def _host(img) -> np.ndarray:
    """A tensor on any device, or an array-like, as a numpy array."""
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def to_uint8(img) -> np.ndarray:
    """(H,W,3) float [0,1] -> uint8, truncation quantize (reference rule)."""
    arr = _host(img)
    if arr.dtype == np.uint8:
        return arr
    return (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8)


def write_png(path: str, img) -> None:
    """Write (H,W,3) image (float [0,1] or uint8) as PNG.

    Encoder preference: native C++ (``native/display.cpp``) -> Pillow ->
    pure Python.
    """
    arr = to_uint8(img)
    from . import native_display
    data = native_display.encode_png(arr)
    if data is not None:
        with open(path, "wb") as f:
            f.write(data)
        return
    try:
        from PIL import Image
        Image.fromarray(arr).save(path)
        return
    except ImportError:
        pass
    _write_png_pure(path, arr)


def _write_png_pure(path: str, arr: np.ndarray) -> None:
    """Minimal RGB8 PNG writer (no deps): one IDAT, filter type 0."""
    h, w = arr.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    out = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(out)


def write_ppm(path: str, img) -> None:
    """Binary PPM (P6): zero-dependency debug output."""
    arr = to_uint8(img)
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())


def write_npy(path: str, img) -> None:
    """Raw float radiance dump (lossless; .hdr is the interchange format)."""
    np.save(path, np.asarray(_host(img), np.float32))


def write_image(path: str, img) -> None:
    """Dispatch on extension: .png / .ppm / .npy / .hdr (Radiance RGBE) /
    .exr (float OpenEXR)."""
    img = _host(img)
    lower = path.lower()
    if lower.endswith(".png"):
        write_png(path, img)
    elif lower.endswith(".ppm"):
        write_ppm(path, img)
    elif lower.endswith(".npy"):
        write_npy(path, img)
    elif lower.endswith(".hdr"):
        from .hdr import write_hdr
        write_hdr(path, img)
    elif lower.endswith(".exr"):
        from .exr import write_exr
        write_exr(path, img)
    else:
        raise ValueError(f"unsupported image extension: {path}")
