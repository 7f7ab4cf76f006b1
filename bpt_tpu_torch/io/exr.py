"""Minimal OpenEXR scanline I/O in pure Python (numpy + zlib); a copy of
bpt_tpu/io/exr.py, which writes the same bytes.

Writes the same format the reference emits through tinyexr (reference:
src/core/utils.h:95-156): scanline EXR, half-float pixels, channels stored
in B, G, R order, ZIP compression.  The reader understands NONE / ZIPS /
ZIP compressed scanline images with HALF or FLOAT channels -- enough to
read back our own output and the reference renderer's artifacts for
golden-image comparison.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 0x01312F76

_PT_UINT = 0
_PT_HALF = 1
_PT_FLOAT = 2

_COMP_NONE = 0
_COMP_RLE = 1
_COMP_ZIPS = 2
_COMP_ZIP = 3


def _attr(name: str, type_name: str, data: bytes) -> bytes:
    return (
        name.encode() + b"\x00" + type_name.encode() + b"\x00"
        + struct.pack("<i", len(data)) + data
    )


def _chlist(channels, pixel_type: int) -> bytes:
    out = b""
    for name in channels:
        out += name.encode() + b"\x00"
        out += struct.pack("<i", pixel_type)
        out += struct.pack("<BBBB", 0, 0, 0, 0)  # pLinear + reserved
        out += struct.pack("<ii", 1, 1)          # x/y sampling
    return out + b"\x00"


def _zip_compress(raw: bytes) -> bytes:
    buf = np.frombuffer(raw, np.uint8)
    n = len(buf)
    half = (n + 1) // 2
    # Reorder: even-index bytes then odd-index bytes (OpenEXR ImfZip).
    tmp = np.empty(n, np.uint8)
    tmp[:half] = buf[0::2]
    tmp[half:] = buf[1::2]
    # Predictor: d[i] = t[i] - t[i-1] + 128 (mod 256).
    d = tmp.astype(np.int16)
    d[1:] = d[1:] - tmp[:-1].astype(np.int16) + 128
    out = (d & 0xFF).astype(np.uint8).tobytes()
    comp = zlib.compress(out)
    return comp if len(comp) < n else raw


def _zip_decompress(data: bytes, expected: int) -> bytes:
    if len(data) == expected:
        return data
    raw = zlib.decompress(data)
    t = np.frombuffer(raw, np.uint8).astype(np.int16)
    # Undo predictor: t[i] = t[i-1] + t[i] - 128 (mod 256).
    # out[0] = t[0]; out[i] = out[i-1] + t[i] - 128  =>  cumsum form:
    t = ((np.cumsum(t - 128) + 128) % 256).astype(np.uint8)
    n = len(t)
    half = (n + 1) // 2
    out = np.empty(n, np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def write_exr(path: str, rgb: np.ndarray, half: bool = True,
              compression: str = "zip") -> None:
    """Write (H, W, 3) linear RGB to a scanline EXR (channels B, G, R)."""
    rgb = np.asarray(rgb, np.float32)
    h, w, _ = rgb.shape
    pixel_type = _PT_HALF if half else _PT_FLOAT
    comp = {"none": _COMP_NONE, "zips": _COMP_ZIPS, "zip": _COMP_ZIP}[
        compression
    ]
    lines_per_chunk = 16 if comp == _COMP_ZIP else 1

    header = b""
    header += _attr("channels", "chlist", _chlist(["B", "G", "R"],
                                                  pixel_type))
    header += _attr("compression", "compression", struct.pack("<B", comp))
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", struct.pack("<B", 0))
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    dtype = np.float16 if half else np.float32
    # Channel-planar per scanline, channels in stored order B, G, R.
    planes = [rgb[..., 2], rgb[..., 1], rgb[..., 0]]
    planes = [p.astype(dtype) for p in planes]

    chunks = []
    for y0 in range(0, h, lines_per_chunk):
        y1 = min(y0 + lines_per_chunk, h)
        raw = b"".join(
            planes[c][y].tobytes()
            for y in range(y0, y1)
            for c in range(3)
        )
        data = _zip_compress(raw) if comp != _COMP_NONE else raw
        chunks.append((y0, data))

    with open(path, "wb") as f:
        f.write(struct.pack("<I", _MAGIC))
        f.write(struct.pack("<I", 2))  # version 2, scanline
        f.write(header)
        offset_pos = f.tell()
        offset = offset_pos + 8 * len(chunks)
        for (_, data) in chunks:
            f.write(struct.pack("<Q", offset))
            offset += 8 + len(data)
        for (y0, data) in chunks:
            f.write(struct.pack("<ii", y0, len(data)))
            f.write(data)


def read_exr(path: str) -> np.ndarray:
    """Read a scanline EXR into (H, W, 3) float32 RGB.

    Supports NONE/ZIPS/ZIP compression and HALF/FLOAT/UINT channels."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<Ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    pos = 8

    channels = []
    comp = _COMP_NONE
    dw = None
    while True:
        end = buf.index(b"\x00", pos)
        name = buf[pos:end].decode()
        pos = end + 1
        if name == "":
            break
        end = buf.index(b"\x00", pos)
        type_name = buf[pos:end].decode()
        pos = end + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        data = buf[pos:pos + size]
        pos += size
        if name == "channels" and type_name == "chlist":
            cpos = 0
            while data[cpos] != 0:
                cend = data.index(b"\x00", cpos)
                cname = data[cpos:cend].decode()
                cpos = cend + 1
                (ptype,) = struct.unpack_from("<i", data, cpos)
                cpos += 4 + 4 + 8  # ptype + pLinear/reserved + sampling
                channels.append((cname, ptype))
        elif name == "compression":
            comp = data[0]
        elif name == "dataWindow":
            dw = struct.unpack("<iiii", data)

    if comp not in (_COMP_NONE, _COMP_ZIPS, _COMP_ZIP):
        raise ValueError(f"{path}: unsupported compression {comp}")
    x0, y0, x1, y1 = dw
    w = x1 - x0 + 1
    h = y1 - y0 + 1
    lines_per_chunk = 16 if comp == _COMP_ZIP else 1
    n_chunks = (h + lines_per_chunk - 1) // lines_per_chunk
    offsets = struct.unpack_from(f"<{n_chunks}Q", buf, pos)

    sizes = {_PT_UINT: 4, _PT_HALF: 2, _PT_FLOAT: 4}
    dtypes = {_PT_UINT: np.uint32, _PT_HALF: np.float16,
              _PT_FLOAT: np.float32}
    line_bytes = sum(sizes[pt] for _, pt in channels) * w

    out = {name: np.zeros((h, w), np.float32) for name, _ in channels}
    for off in offsets:
        cy, dsize = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8: off + 8 + dsize]
        ly0 = cy - y0
        ly1 = min(ly0 + lines_per_chunk, h)
        raw = (
            _zip_decompress(data, line_bytes * (ly1 - ly0))
            if comp != _COMP_NONE else data
        )
        rpos = 0
        for y in range(ly0, ly1):
            for cname, pt in channels:
                nb = sizes[pt] * w
                arr = np.frombuffer(raw, dtypes[pt], count=w, offset=rpos)
                out[cname][y] = arr.astype(np.float32)
                rpos += nb

    img = np.zeros((h, w, 3), np.float32)
    for i, c in enumerate("RGB"):
        if c in out:
            img[..., i] = out[c]
    return img
