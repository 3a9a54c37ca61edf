"""Radiance RGBE (.hdr) float image reader/writer, pure numpy.

A copy of ``spt_tpu/io/hdr.py``: the same bytes from the same array.  RGBE
stores each pixel as a shared-exponent (r, g, b, e) byte quad, ``rgb =
mantissa * 2**(e-136)``: about 1% relative precision over a huge dynamic
range, enough for environment radiance and for archiving linear render
output.

Format reference: Radiance ``ray/src/common/color.c`` (public spec); reads
flat and new-style RLE scanlines, writes new-style RLE when the width
allows it (8 <= W < 32768), flat otherwise.  Writers take numpy arrays
(``io.image.write_image`` brings a tensor to the host first).
"""

from __future__ import annotations

import numpy as np

_HEADER_MAGIC = (b"#?RADIANCE", b"#?RGBE")


def _float_to_rgbe(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float -> (H, W, 4) uint8 RGBE."""
    img = np.maximum(np.asarray(img, np.float64), 0.0)
    maxc = img.max(axis=-1)
    out = np.zeros(img.shape[:2] + (4,), np.uint8)
    nz = maxc >= 1e-32
    # frexp: maxc = frac * 2**exp with frac in [0.5, 1).
    frac, exp = np.frexp(np.where(nz, maxc, 1.0))
    scale = frac * 256.0 / np.where(nz, maxc, 1.0)
    mant = np.clip(img * scale[..., None], 0.0, 255.0).astype(np.uint8)
    out[..., :3] = np.where(nz[..., None], mant, 0)
    out[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    return out


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32."""
    rgbe = np.asarray(rgbe, np.uint8)
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    return (rgbe[..., :3].astype(np.float32) * scale[..., None]).astype(
        np.float32)


def write_hdr(path: str, img) -> None:
    """Write (H, W, 3) linear float radiance as Radiance RGBE."""
    img = np.asarray(img, np.float32)
    if img.ndim != 3 or img.shape[2] < 3:
        raise ValueError("write_hdr expects (H, W, 3) float data")
    h, w = img.shape[:2]
    rgbe = _float_to_rgbe(img[..., :3])
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        if 8 <= w < 32768:
            for row in rgbe:
                f.write(bytes((2, 2, (w >> 8) & 0xFF, w & 0xFF)))
                for ch in range(4):
                    f.write(_rle_encode(row[:, ch]))
        else:
            f.write(rgbe.tobytes())


def _rle_encode(data: np.ndarray) -> bytes:
    """New-style Radiance RLE of one scanline channel."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        # Find a run of >= 4 identical bytes starting at or after i.
        run_start = i
        while run_start < n:
            run_len = 1
            while (run_start + run_len < n and run_len < 127
                   and data[run_start + run_len] == data[run_start]):
                run_len += 1
            if run_len >= 4:
                break
            run_start += run_len
        else:
            run_start = n
            run_len = 0
        # Literal segment [i, run_start) in <=128-byte chunks.
        j = i
        while j < run_start:
            chunk = min(128, run_start - j)
            out.append(chunk)
            out.extend(data[j:j + chunk].tobytes())
            j += chunk
        if run_start < n:
            out.append(128 + run_len)
            out.append(int(data[run_start]))
            i = run_start + run_len
        else:
            i = n
    return bytes(out)


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file -> (H, W, 3) float32 linear radiance."""
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.startswith(_HEADER_MAGIC[0]) and \
            not raw.startswith(_HEADER_MAGIC[1]):
        raise ValueError(f"{path!r} is not a Radiance HDR file")
    # Header: lines until the blank line, then the resolution line.
    pos = 0
    exposure = 1.0
    while True:
        nl = raw.index(b"\n", pos)
        line = raw[pos:nl]
        pos = nl + 1
        if line.startswith(b"EXPOSURE="):
            exposure *= float(line.split(b"=", 1)[1])
        if line == b"":
            break
    nl = raw.index(b"\n", pos)
    res = raw[pos:nl].split()
    pos = nl + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation {res!r} in {path!r}")
    h, w = int(res[1]), int(res[3])
    data = np.frombuffer(raw, np.uint8, offset=pos)
    rgbe = np.empty((h, w, 4), np.uint8)
    off = 0
    for y in range(h):
        if (w >= 8 and w < 32768 and off + 4 <= len(data)
                and data[off] == 2 and data[off + 1] == 2
                and (int(data[off + 2]) << 8 | int(data[off + 3])) == w):
            off += 4
            for ch in range(4):
                off = _rle_decode(data, off, rgbe[y, :, ch])
        else:  # flat scanline
            rgbe[y] = data[off:off + 4 * w].reshape(w, 4)
            off += 4 * w
    img = _rgbe_to_float(rgbe)
    if exposure != 1.0 and exposure > 0.0:
        img /= np.float32(exposure)
    return img


def _rle_decode(data: np.ndarray, off: int, out: np.ndarray) -> int:
    w = len(out)
    x = 0
    while x < w:
        code = int(data[off])
        off += 1
        if code > 128:  # run
            out[x:x + code - 128] = data[off]
            off += 1
            x += code - 128
        else:  # literal
            out[x:x + code] = data[off:off + code]
            off += code
            x += code
    return off
