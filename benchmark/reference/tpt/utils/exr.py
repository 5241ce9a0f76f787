"""Minimal OpenEXR 2.0 scanline codec (numpy + zlib).

Counterpart of ``tpu_pathtracer/utils/exr.py``, the port's own copy: the
image stacks of the platforms the port runs on carry no EXR codec, and an
environment light is loaded from an EXR equirect HDRI.

Supported: single-part scanline images, compression NONE / ZIPS / ZIP,
pixel types HALF and FLOAT, any channel set (R, G, B[, A] returned in that
order when present, else file order).  The writer emits uncompressed FLOAT
scanlines.

Format reference: "OpenEXR File Layout" (openexr.com, public spec).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["read_exr", "write_exr"]

_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_COMP_NONE, _COMP_RLE, _COMP_ZIPS, _COMP_ZIP = 0, 1, 2, 3
_LINES_PER_BLOCK = {_COMP_NONE: 1, _COMP_ZIPS: 1, _COMP_ZIP: 16}


def _read_cstr(buf: bytes, off: int) -> tuple[str, int]:
    end = buf.index(b"\0", off)
    return buf[off:end].decode("latin-1"), end + 1


def _unpredict_deinterleave(raw: bytes) -> bytes:
    """Invert EXR's zip preprocessing: delta predictor + byte interleave."""
    t = np.frombuffer(raw, np.uint8).astype(np.int64)
    # invert d[i] = d[i] + d[i-1] - 128 (running): t[i] = cumsum(raw)[i] - 128*i
    t = ((np.cumsum(t - 128) + 128) % 256).astype(np.uint8)
    out = np.empty_like(t)
    half = (len(t) + 1) // 2
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def _interleave_predict(raw: bytes) -> bytes:
    """EXR zip preprocessing (the inverse of the above), for writing ZIP
    and ZIPS payloads; ``write_exr`` itself writes NONE."""
    t = np.frombuffer(raw, np.uint8)
    half = (len(t) + 1) // 2
    inter = np.empty_like(t)
    inter[:half] = t[0::2]
    inter[half:] = t[1::2]
    d = inter.astype(np.int16)
    d[1:] = (d[1:] - d[:-1]) + 128
    return (d % 256).astype(np.uint8).tobytes()


def read_exr(path: str) -> np.ndarray:
    """EXR file -> (H, W, C) float32 array (RGB[A] ordered when present)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise IOError(f"{path}: not an EXR file")
    if version & 0x200:
        raise IOError(f"{path}: tiled EXR not supported")
    off = 8

    channels: list[tuple[str, int]] = []
    compression = _COMP_NONE
    xmin = ymin = 0
    xmax = ymax = -1
    while True:
        name, off = _read_cstr(buf, off)
        if not name:
            break
        _type, off = _read_cstr(buf, off)
        size = struct.unpack_from("<I", buf, off)[0]
        off += 4
        data = buf[off:off + size]
        off += size
        if name == "channels":
            coff = 0
            while data[coff] != 0:
                cname, coff = _read_cstr(data, coff)
                ptype = struct.unpack_from("<i", data, coff)[0]
                coff += 16  # pixelType + pLinear/reserved + x/ySampling
                channels.append((cname, ptype))
        elif name == "compression":
            compression = data[0]
        elif name == "dataWindow":
            xmin, ymin, xmax, ymax = struct.unpack("<4i", data)

    if compression not in _LINES_PER_BLOCK:
        raise IOError(f"{path}: unsupported compression {compression}")
    width = xmax - xmin + 1
    height = ymax - ymin + 1
    lpb = _LINES_PER_BLOCK[compression]
    n_blocks = -(-height // lpb)

    # channels are stored per scanline in file (alphabetical) order
    dtypes = {_PT_HALF: np.float16, _PT_FLOAT: np.float32,
              _PT_UINT: np.uint32}
    itemsize = {_PT_HALF: 2, _PT_FLOAT: 4, _PT_UINT: 4}

    offsets = struct.unpack_from(f"<{n_blocks}q", buf, off)
    planes = {c: np.empty((height, width), np.float32) for c, _ in channels}
    for o in offsets:
        y, size = struct.unpack_from("<iI", buf, o)
        payload = buf[o + 8:o + 8 + size]
        y0 = y - ymin
        n_lines = min(lpb, height - y0)
        raw_len = n_lines * width * sum(itemsize[pt] for _, pt in channels)
        if compression in (_COMP_ZIPS, _COMP_ZIP) and size != raw_len:
            payload = _unpredict_deinterleave(zlib.decompress(payload))
        poff = 0
        for line in range(n_lines):
            for cname, ptype in channels:
                nb = width * itemsize[ptype]
                vals = np.frombuffer(payload, dtypes[ptype], width, poff)
                planes[cname][y0 + line] = vals.astype(np.float32)
                poff += nb

    names = [c for c, _ in channels]
    order = [c for c in ("R", "G", "B", "A") if c in names]
    if not order:
        order = names
    return np.stack([planes[c] for c in order], -1)


def write_exr(path: str, img: np.ndarray) -> None:
    """(H, W, 3|4|1) float array -> uncompressed FLOAT scanline EXR."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    names = {1: ["Y"], 3: ["R", "G", "B"], 4: ["R", "G", "B", "A"]}[c]
    file_order = sorted(names)  # EXR stores channels alphabetically

    def attr(name: str, typ: str, data: bytes) -> bytes:
        return (name.encode() + b"\0" + typ.encode() + b"\0"
                + struct.pack("<I", len(data)) + data)

    chlist = b"".join(
        n.encode() + b"\0" + struct.pack("<iBBBBii", _PT_FLOAT, 0, 0, 0, 0,
                                         1, 1)
        for n in file_order) + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (struct.pack("<ii", _MAGIC, 2)
              + attr("channels", "chlist", chlist)
              + attr("compression", "compression", bytes([_COMP_NONE]))
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")

    line_bytes = 8 + len(file_order) * w * 4
    table_off = len(header)
    data_off = table_off + 8 * h
    offsets = struct.pack(f"<{h}q", *(data_off + i * line_bytes
                                      for i in range(h)))
    chunks = []
    for y in range(h):
        payload = b"".join(
            np.ascontiguousarray(img[y, :, names.index(n)]).tobytes()
            for n in file_order)
        chunks.append(struct.pack("<iI", y, len(payload)) + payload)
    with open(path, "wb") as f:
        f.write(header + offsets + b"".join(chunks))
