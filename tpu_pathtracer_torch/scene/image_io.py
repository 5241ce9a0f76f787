"""Image file loading for textures and environment maps.

Counterpart of ``tpu_pathtracer/scene/image_io.py``: decodes an image file
into a numpy float array once, at scene-build time.

Formats:
  * 8-bit non-interlaced PNG of colour type 0, 2, 4 or 6 (grey, RGB, grey +
    alpha, RGBA): decoded here with ``zlib`` (every row filter), so that a
    machine without PIL or OpenCV loads the common textures.  The result
    equals PIL's ``convert("RGB")`` / ``convert("L")`` bit for bit: alpha
    is dropped, grey is repeated, and RGB -> grey is PIL's integer luma
    ``(R*19595 + G*38470 + B*7471 + 0x8000) >> 16``.
  * EXR through the port's own codec (``utils/exr.py``).
  * Every other format as the JAX package reads it, through a lazy import:
    palette, 16-bit and interlaced PNG, JPG, BMP, TGA through PIL; ``.hdr``
    through OpenCV.  Without that package the load raises ``ImportError``
    naming the format.

Options mirror the reference texture types:
  * ``load_normal(flip_y=...)``: a DirectX-style normal map's Y flip, baked
    into the stored encoding.
  * ``load_gray(linearize=...)``: a scalar texture's inverse-sRGB option.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

__all__ = ["load_rgb", "load_gray", "load_normal", "load_env",
           "texture_from_file"]

_EXR_EXTS = (".exr", ".hdr")
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for the types decoded here
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _srgb_to_linear(v: np.ndarray) -> np.ndarray:
    """Inverse sRGB EOTF (the curve of color/eotf.py, host-side)."""
    return np.where(v <= 0.04045, v / 12.92,
                    ((v + 0.055) / 1.055) ** 2.4).astype(np.float32)


def _format_of(path: str) -> str:
    ext = os.path.splitext(path)[1].lower()
    return ext[1:].upper() if ext else "extension-less"


# ---------------------------------------------------------------------------
# 8-bit PNG
# ---------------------------------------------------------------------------

def _unfilter_row(ftype: int, row: np.ndarray, prior: np.ndarray,
                  bpp: int) -> np.ndarray:
    """Undo one PNG row filter (PNG spec, section 9): ``row`` the filtered
    bytes, ``prior`` the previous row unfiltered, both (stride,) uint8."""
    if ftype == 0:                                    # None
        return row
    if ftype == 1:                                    # Sub: a running sum
        px = row.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(px, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
    if ftype == 2:                                    # Up
        return ((row.astype(np.int64) + prior) & 0xFF).astype(np.uint8)
    if ftype not in (3, 4):
        raise IOError(f"unknown PNG row filter {ftype}")
    # Average and Paeth predict from the unfiltered left neighbour: a
    # sequential loop, over Python ints
    r, b = row.tolist(), prior.tolist()
    for i in range(len(r)):
        a = r[i - bpp] if i >= bpp else 0
        if ftype == 3:
            pred = (a + b[i]) >> 1
        else:
            c = b[i - bpp] if i >= bpp else 0
            p = a + b[i] - c
            pa, pb, pc = abs(p - a), abs(p - b[i]), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b[i] if pb <= pc else c)
        r[i] = (r[i] + pred) & 0xFF
    return np.asarray(r, np.uint8)


def _read_png8(path: str):
    """8-bit non-interlaced PNG of colour type 0, 2, 4 or 6 -> (H, W, C)
    uint8 pixels (C = 1, 3, 2, 4), or None for any other PNG (palette,
    16-bit, interlaced) and for a file that is not a PNG."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(_PNG_SIGNATURE):
        return None
    off = len(_PNG_SIGNATURE)
    header = None
    idat = []
    while off + 8 <= len(buf):
        length, ctype = struct.unpack_from(">I4s", buf, off)
        data = buf[off + 8:off + 8 + length]
        crc = buf[off + 8 + length:off + 12 + length]
        if len(data) != length or len(crc) != 4:
            raise IOError(f"{path}: truncated PNG chunk {ctype!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(ctype + data):
            raise IOError(f"{path}: PNG chunk {ctype!r} fails its CRC")
        off += 12 + length                            # length, type, CRC
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif ctype == b"IDAT":
            idat.append(data)
        elif ctype == b"IEND":
            break
    if header is None:
        raise IOError(f"{path}: PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or interlace != 0 or color not in _PNG_CHANNELS:
        return None
    ch = _PNG_CHANNELS[color]
    stride = width * ch
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (stride + 1):
        raise IOError(f"{path}: PNG image data too short")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        prior = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prior,
                                       ch)
    return out.reshape(height, width, ch)


def _png_as(px: np.ndarray, mode: str) -> np.ndarray:
    """(H, W, C) uint8 PNG pixels -> PIL's ``convert(mode)`` of them, for
    mode "RGB" ((H, W, 3)) or "L" ((H, W))."""
    ch = px.shape[-1]
    if ch in (1, 2):                                  # grey [+ alpha]
        grey = px[..., 0]
        return np.repeat(grey[..., None], 3, -1) if mode == "RGB" else grey
    rgb = px[..., :3]                                 # RGB [+ alpha]
    if mode == "RGB":
        return np.ascontiguousarray(rgb)
    r, g, b = (rgb[..., k].astype(np.uint32) for k in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(
        np.uint8)


def _load_8bit(path: str, mode: str) -> np.ndarray:
    """8-bit image file -> uint8 pixels as PIL's ``convert(mode)`` gives
    them: the PNGs of ``_read_png8`` decoded here, the rest through PIL."""
    px = _read_png8(path)
    if px is not None:
        return _png_as(px, mode)
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"reading {_format_of(path)} files other than 8-bit "
            f"non-interlaced grey/RGB[A] PNG ({path}) needs PIL, which is "
            "not installed") from e
    return np.asarray(Image.open(path).convert(mode))


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------

def _load_float_image(path: str) -> np.ndarray:
    """EXR/HDR -> (H, W, 3) f32 (linear by definition of the formats):
    EXR through the port's codec, HDR through OpenCV."""
    if path.lower().endswith(".exr"):
        from ..utils.exr import read_exr

        img = np.asarray(read_exr(path), np.float32)
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, -1)
        return np.ascontiguousarray(img[..., :3])
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"reading {_format_of(path)} files ({path}) needs "
                          "OpenCV (cv2), which is not installed") from e

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH
                     | cv2.IMREAD_ANYCOLOR)
    if img is None:
        raise IOError(f"failed to decode {path}")
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    if img.shape[-1] >= 3:
        img = img[..., 2::-1]  # BGR(A) -> RGB
    return np.ascontiguousarray(img[..., :3])


def load_rgb(path: str, linearize: bool = True) -> np.ndarray:
    """Image file -> (H, W, 3) f32 LINEAR rgb.

    8-bit files are taken as sRGB-encoded and linearized when
    ``linearize`` (colour textures); EXR/HDR are linear already."""
    if path.lower().endswith(_EXR_EXTS):
        return _load_float_image(path)
    img = np.asarray(_load_8bit(path, "RGB"), np.float32) / 255.0
    return _srgb_to_linear(img) if linearize else img


def load_gray(path: str, linearize: bool = False) -> np.ndarray:
    """Image file -> (H, W) f32 greyscale; ``linearize`` applies the
    inverse sRGB EOTF."""
    if path.lower().endswith(_EXR_EXTS):
        img = _load_float_image(path).mean(-1)
        return np.asarray(img, np.float32)
    img = np.asarray(_load_8bit(path, "L"), np.float32) / 255.0
    return _srgb_to_linear(img) if linearize else img


def load_normal(path: str, flip_y: bool = False) -> np.ndarray:
    """Normal map file -> (H, W, 3) f32 in the [0, 1] encoding the shading
    decodes with ``n = raw*2 - 1``; ``flip_y`` (DirectX-convention maps)
    negates the decoded green channel, baked here as ``g -> 1 - g``."""
    img = np.asarray(_load_8bit(path, "RGB"), np.float32) / 255.0
    if flip_y:
        img = img.copy()
        img[..., 1] = 1.0 - img[..., 1]
    return img


def load_env(path: str) -> np.ndarray:
    """Equirect environment map (EXR/HDR/PNG) -> (H, W, 3) f32 linear
    radiance, ready for ``SceneBuilder.add_env_light``."""
    return load_rgb(path, linearize=True)


def texture_from_file(path: str, kind: str = "rgb", flip_y: bool = False,
                      linearize: bool | None = None):
    """File -> the builder's ``Texture`` of the given kind.

    kind "rgb": colour texture, linearized unless ``linearize=False``;
    kind "gray": scalar texture, not linearized unless ``linearize=True``;
    kind "normal": [0, 1]-encoded tangent-space normals, optional flip_y."""
    from .builder import Texture

    if kind == "rgb":
        data = load_rgb(path, linearize=True if linearize is None else linearize)
    elif kind == "gray":
        data = load_gray(path, linearize=bool(linearize))
    elif kind == "normal":
        data = load_normal(path, flip_y=flip_y)
    else:
        raise ValueError(f"unknown texture kind {kind!r}")
    return Texture(data=data, kind=kind)
