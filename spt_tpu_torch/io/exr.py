"""Minimal OpenEXR 2.0 float I/O: scanline, uncompressed, RGB.

A copy of ``spt_tpu/io/exr.py``: the same bytes from the same array.
Scope: exactly the subset this renderer needs, 3 x FLOAT channels (B, G,
R per the spec's alphabetical channel order), NO_COMPRESSION, single part,
INCREASING_Y, written and read back without any third-party EXR
dependency.

Format reference: the OpenEXR file layout documented at openexr.com
(magic 0x762f3101, version 2, attribute list, scanline offset table,
per-scanline [y:int32][size:int32][channel-planar rows]).
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 20000630
_FLOAT = 2          # PixelType: UINT=0, HALF=1, FLOAT=2


def _attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(data)) + data


def _chlist_rgb() -> bytes:
    out = b""
    for ch in (b"B", b"G", b"R"):    # alphabetical, per spec
        out += ch + b"\0"
        out += struct.pack("<iiii", _FLOAT, 0, 1, 1)  # type, pLinear, x/y
    return out + b"\0"


def write_exr(path: str, img) -> None:
    """Write (H, W, 3) float radiance as an uncompressed FLOAT EXR."""
    arr = np.asarray(img, np.float32)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3), got {arr.shape}")
    h, w = arr.shape[:2]
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b"".join([
        _attr(b"channels", b"chlist", _chlist_rgb()),
        _attr(b"compression", b"compression", b"\0"),          # NONE
        _attr(b"dataWindow", b"box2i", box),
        _attr(b"displayWindow", b"box2i", box),
        _attr(b"lineOrder", b"lineOrder", b"\0"),              # INCREASING_Y
        _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)),
        _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0)),
        _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0)),
        b"\0",
    ])
    preamble = struct.pack("<ii", _MAGIC, 2) + header
    line_bytes = 8 + 3 * 4 * w
    table_off = len(preamble) + 8 * h
    offsets = [table_off + y * line_bytes for y in range(h)]
    with open(path, "wb") as f:
        f.write(preamble)
        f.write(struct.pack(f"<{h}Q", *offsets))
        for y in range(h):
            f.write(struct.pack("<ii", y, 3 * 4 * w))
            # channel-planar per scanline, B then G then R
            f.write(np.ascontiguousarray(arr[y, :, 2]).tobytes())
            f.write(np.ascontiguousarray(arr[y, :, 1]).tobytes())
            f.write(np.ascontiguousarray(arr[y, :, 0]).tobytes())


def read_exr(path: str) -> np.ndarray:
    """Read the uncompressed FLOAT RGB subset ``write_exr`` emits."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise ValueError("multi-part EXR not supported")
    pos = 8
    attrs = {}
    while buf[pos] != 0:
        nend = buf.index(b"\0", pos)
        name = buf[pos:nend].decode()
        pos = nend + 1
        tend = buf.index(b"\0", pos)
        typ = buf[pos:tend].decode()
        pos = tend + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (typ, buf[pos:pos + size])
        pos += size
    pos += 1
    if attrs["compression"][1] != b"\0":
        raise ValueError("only NO_COMPRESSION supported")
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    # channel list: names in file order (alphabetical); require 3x FLOAT
    chs = []
    cbuf, cpos = attrs["channels"][1], 0
    while cbuf[cpos] != 0:
        cend = cbuf.index(b"\0", cpos)
        cname = cbuf[cpos:cend].decode()
        (ptype,) = struct.unpack_from("<i", cbuf, cend + 1)
        if ptype != _FLOAT:
            raise ValueError("only FLOAT channels supported")
        chs.append(cname)
        cpos = cend + 1 + 16
    pos += 8 * h   # skip the offset table
    img = np.empty((h, w, len(chs)), np.float32)
    for y in range(h):
        yy, size = struct.unpack_from("<ii", buf, pos)
        pos += 8
        row = np.frombuffer(buf, np.float32, count=len(chs) * w, offset=pos)
        pos += size
        img[yy - y0] = row.reshape(len(chs), w).T
    idx = {c: i for i, c in enumerate(chs)}
    try:
        return np.stack([img[:, :, idx["R"]], img[:, :, idx["G"]],
                         img[:, :, idx["B"]]], axis=-1)
    except KeyError:
        return img
