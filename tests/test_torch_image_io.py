"""File-backed inputs in the port: image loading (``scene/image_io.py``),
the EXR codec (``utils/exr.py``) and the OBJ assets (``scene/mesh.py``).

Port copies of tests/test_image_io.py's eight cases, and:

  * the port's own PNG decoder against PIL, bit for bit: colour types 0,
    2, 4 and 6, each with rows of every filter type (None, Sub, Up,
    Average, Paeth) written here, and PNGs PIL writes itself; ``load_rgb``
    and ``load_gray`` equal to the JAX package's (which read through PIL),
    bit for bit, ``load_gray`` of an RGB file with PIL's integer luma;
  * formats the port leaves to PIL (palette and 16-bit PNG, BMP) equal to
    the JAX package's, and without PIL an ``ImportError`` naming the format;
  * EXR: FLOAT, ZIPS/HALF and ZIP/HALF files read by both packages' readers
    to equal arrays;
  * OBJ: ``load_obj``, ``try_load_asset``, ``bunny()`` and ``dragon()`` from
    files in ``ASSET_DIR``, and ``box_interior``, equal to the JAX
    package's, array for array.
"""
import struct
import sys
import zlib

import numpy as np
import pytest

from tpu_pathtracer.scene import image_io as jimage_io
from tpu_pathtracer.scene import mesh as jmesh
from tpu_pathtracer.utils import exr as jexr
from tpu_pathtracer_torch.scene import image_io
from tpu_pathtracer_torch.scene import mesh
from tpu_pathtracer_torch.utils import exr

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402


# ---------------------------------------------------------------------------
# Port copies of tests/test_image_io.py
# ---------------------------------------------------------------------------

@pytest.fixture
def png_rgb(tmp_path):
    arr = np.zeros((4, 6, 3), np.uint8)
    arr[..., 0] = 255       # pure red
    arr[1, 1] = (0, 128, 0)
    p = tmp_path / "t.png"
    Image.fromarray(arr).save(p)
    return str(p), arr


def test_load_rgb_linearizes_srgb(png_rgb):
    path, arr = png_rgb
    img = image_io.load_rgb(path)
    assert img.shape == (4, 6, 3) and img.dtype == np.float32
    assert abs(img[0, 0, 0] - 1.0) < 1e-6          # 255 -> 1.0 (linear)
    # 128/255 sRGB-encoded -> ~0.2158 linear
    assert abs(img[1, 1, 1] - 0.2158) < 2e-3
    raw = image_io.load_rgb(path, linearize=False)
    assert abs(raw[1, 1, 1] - 128 / 255) < 1e-6


def test_load_gray_linearize_option(tmp_path):
    arr = np.full((3, 3), 128, np.uint8)
    p = tmp_path / "g.png"
    Image.fromarray(arr, "L").save(p)
    raw = image_io.load_gray(str(p))
    lin = image_io.load_gray(str(p), linearize=True)
    assert abs(raw[0, 0] - 128 / 255) < 1e-6
    assert abs(lin[0, 0] - 0.2158) < 2e-3


def test_load_normal_flip_y(tmp_path):
    # a normal tilted toward +Y: g > 0.5
    arr = np.zeros((2, 2, 3), np.uint8)
    arr[...] = (128, 200, 230)
    p = tmp_path / "n.png"
    Image.fromarray(arr).save(p)
    n = image_io.load_normal(str(p))
    nf = image_io.load_normal(str(p), flip_y=True)
    assert abs((n[0, 0, 1] * 2 - 1) + (nf[0, 0, 1] * 2 - 1)) < 1e-5
    assert np.allclose(n[..., 0], nf[..., 0])


def test_exr_round_trip(tmp_path):
    hdr = np.zeros((4, 8, 3), np.float32)
    hdr[..., 0] = 3.5     # R=3.5, beyond LDR range
    hdr[2, 3] = (0.25, 7.0, 0.125)
    p = str(tmp_path / "e.exr")
    exr.write_exr(p, hdr)
    img = image_io.load_env(p)
    assert img.shape == (4, 8, 3)
    assert np.array_equal(img, hdr)
    assert np.array_equal(jimage_io.load_env(p), img)


def _zip_half_exr(path, img, compression):
    """A HALF EXR compressed with ZIPS (2: one line a block) or ZIP (3:
    16 lines a block), built by hand as OpenEXR lays it out."""
    h, w, _ = img.shape
    lines = {2: 1, 3: 16}[compression]

    def attr(name, typ, data):
        return (name.encode() + b"\0" + typ.encode() + b"\0"
                + struct.pack("<I", len(data)) + data)

    names = ["B", "G", "R"]  # alphabetical file order
    chlist = b"".join(
        n.encode() + b"\0" + struct.pack("<iBBBBii", 1, 0, 0, 0, 0, 1, 1)
        for n in names) + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (struct.pack("<ii", 20000630, 2)
              + attr("channels", "chlist", chlist)
              + attr("compression", "compression", bytes([compression]))
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    rgb_of = {"R": 0, "G": 1, "B": 2}
    chunks = []
    for y0 in range(0, h, lines):
        raw = b"".join(img[y, :, rgb_of[n]].tobytes()
                       for y in range(y0, min(y0 + lines, h)) for n in names)
        comp = zlib.compress(exr._interleave_predict(raw))
        if len(comp) >= len(raw):  # spec: store raw if zip doesn't shrink
            comp = raw
        chunks.append(struct.pack("<iI", y0, len(comp)) + comp)
    offs, pos = [], len(header) + 8 * len(chunks)
    for c in chunks:
        offs.append(pos)
        pos += len(c)
    with open(path, "wb") as f:
        f.write(header + struct.pack(f"<{len(chunks)}q", *offs)
                + b"".join(chunks))


def test_exr_zip_compressed_half(tmp_path):
    """A ZIPS-compressed HALF EXR: the reader inverts the delta predictor
    and the byte interleave (OpenEXR's zip preprocessing)."""
    h, w = 3, 5
    rng = np.random.default_rng(7)
    img = (rng.random((h, w, 3)) * 4.0).astype(np.float16)
    p = str(tmp_path / "z.exr")
    _zip_half_exr(p, img, 2)
    out = exr.read_exr(p)
    assert out.shape == (h, w, 3)
    assert np.array_equal(out, img.astype(np.float32))


def test_texture_from_file_kinds(png_rgb):
    path, _ = png_rgb
    t = image_io.texture_from_file(path, kind="rgb")
    assert t.kind == "rgb" and t.data.shape == (4, 6, 3)
    t = image_io.texture_from_file(path, kind="normal", flip_y=True)
    assert t.kind == "normal"
    with pytest.raises(ValueError):
        image_io.texture_from_file(path, kind="height")


def test_asset_loader_prefers_real_obj(tmp_path, monkeypatch):
    # a real (non-stub) obj in the asset dir is picked up and height-fitted
    obj = tmp_path / "bunny.obj"
    obj.write_text("v 0 0 0\nv 2 0 0\nv 0 4 0\nf 1 2 3\n")
    monkeypatch.setattr(mesh, "ASSET_DIR", str(tmp_path))
    m = mesh.bunny(scale=1.0)
    ys = m.positions[:, 1]
    assert abs((ys.max() - ys.min()) - 1.15) < 1e-5
    assert ys.min() == 0.0


def test_asset_loader_skips_lfs_stub(tmp_path, monkeypatch):
    obj = tmp_path / "bunny.obj"
    obj.write_text("version https://git-lfs.github.com/spec/v1\noid sha256:x\n")
    monkeypatch.setattr(mesh, "ASSET_DIR", str(tmp_path))
    m = mesh.bunny()           # falls back to the procedural blob
    assert len(m.indices) > 1000


# ---------------------------------------------------------------------------
# The port's 8-bit PNG decoder against PIL
# ---------------------------------------------------------------------------

_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_MODES = {0: "L", 2: "RGB", 4: "LA", 6: "RGBA"}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_row(ftype, row, prior, bpp):
    """Apply one PNG row filter (the encoder's side) to uint8 rows."""
    x = row.astype(np.int64)
    b = prior.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
    pred = {0: 0, 1: a, 2: b, 3: (a + b) // 2, 4: _paeth(a, b, c)}[ftype]
    return ((x - pred) & 0xFF).astype(np.uint8)


def _write_png(path, px, color_type, filters):
    """(H, W, C) uint8 -> an 8-bit PNG of ``color_type``, row y filtered
    with ``filters[y % len(filters)]``, in two IDAT chunks."""
    h, w, ch = px.shape
    rows = px.reshape(h, w * ch)
    out = []
    prior = np.zeros(w * ch, np.uint8)
    for y in range(h):
        f = filters[y % len(filters)]
        out.append(bytes([f]) + _filter_row(f, rows[y], prior, ch).tobytes())
        prior = rows[y]
    data = zlib.compress(b"".join(out))

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    half = len(data) // 2
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                             0, 0, 0))
                + chunk(b"tEXt", b"Comment\0crafted rows")
                + chunk(b"IDAT", data[:half]) + chunk(b"IDAT", data[half:])
                + chunk(b"IEND", b""))


def _pixels(shape, seed):
    """Noise with runs of equal and of extreme values, so that every
    predictor wraps around 0 and 255."""
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, shape, dtype=np.uint8)
    px[1] = 255
    px[2, ::2] = 0
    px[:, 3] = px[:, 2]
    return px


@pytest.mark.parametrize("color_type", [0, 2, 4, 6])
@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4],
                                     [4, 3, 2, 1, 0, 2, 3]])
def test_png_decoder_equals_pil(tmp_path, color_type, filters):
    px = _pixels((7, 9, _CHANNELS[color_type]), color_type * 10 + filters[0])
    p = str(tmp_path / "c.png")
    _write_png(p, px, color_type, filters)
    assert np.array_equal(image_io._read_png8(p), px)
    pil = Image.open(p)
    assert pil.mode == _MODES[color_type]
    for mode in ("RGB", "L"):
        assert np.array_equal(image_io._load_8bit(p, mode),
                              np.asarray(pil.convert(mode))), mode
    # the public loaders against the JAX package's (PIL) ones
    for linearize in (False, True):
        assert np.array_equal(image_io.load_rgb(p, linearize),
                              jimage_io.load_rgb(p, linearize))
        assert np.array_equal(image_io.load_gray(p, linearize),
                              jimage_io.load_gray(p, linearize))
    assert np.array_equal(image_io.load_normal(p, flip_y=True),
                          jimage_io.load_normal(p, flip_y=True))


def test_png_damaged_raises(tmp_path):
    """A flipped bit in the image data fails its chunk's CRC (PIL does
    not check an IDAT chunk's CRC); a file cut short is refused."""
    px = _pixels((4, 5, 3), 1)
    p = str(tmp_path / "ok.png")
    _write_png(p, px, 2, [1])
    raw = bytearray(open(p, "rb").read())
    idat = raw.index(b"IDAT")
    raw[idat + 6] ^= 0x01
    bad = str(tmp_path / "bad.png")
    with open(bad, "wb") as f:
        f.write(raw)
    with pytest.raises(IOError, match="CRC"):
        image_io.load_rgb(bad)
    with open(bad, "wb") as f:
        f.write(open(p, "rb").read()[:idat + 10])
    with pytest.raises(IOError, match="truncated"):
        image_io.load_rgb(bad)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_written_by_pil_equals_pil(tmp_path, mode):
    """PNGs PIL writes itself (its own choice of filters), larger."""
    ch = len(mode)
    px = _pixels((33, 70, ch), ch).squeeze()
    p = str(tmp_path / "p.png")
    Image.fromarray(px, mode).save(p)
    for out in ("RGB", "L"):
        assert np.array_equal(image_io._load_8bit(p, out),
                              np.asarray(Image.open(p).convert(out)))
    assert image_io._read_png8(p).shape == (33, 70, ch)


def test_load_gray_of_rgb_is_pils_integer_luma(tmp_path):
    """An RGB file read as grey: PIL's (R*19595 + G*38470 + B*7471 +
    0x8000) >> 16, which a rounded float luma misses on the last 4 of
    these pixels."""
    px = np.array([[[255, 0, 0], [0, 255, 0], [64, 6, 253], [54, 206, 188],
                    [36, 144, 72], [99, 25, 116]]], np.uint8)
    p = str(tmp_path / "rgb.png")
    Image.fromarray(px).save(p)
    want = np.asarray(Image.open(p).convert("L"))
    r, g, b = (px[..., k].astype(np.int64) for k in range(3))
    assert np.array_equal(want, (r * 19595 + g * 38470 + b * 7471
                                 + 0x8000) >> 16)
    float_luma = np.round(0.299 * r + 0.587 * g + 0.114 * b)
    assert (want != float_luma).sum() == 4
    assert np.array_equal(image_io.load_gray(p), want.astype(np.float32)
                          / 255.0)
    assert np.array_equal(image_io.load_gray(p), jimage_io.load_gray(p))


@pytest.mark.parametrize("kind", ["palette_png", "png16", "bmp"])
def test_other_formats_through_pil(tmp_path, kind, monkeypatch):
    """What the port does not decode goes through PIL as in the JAX
    package; without PIL, an ImportError naming the format."""
    px = _pixels((5, 6, 3), 9)
    if kind == "palette_png":
        p = str(tmp_path / "pal.png")
        Image.fromarray(px).quantize(16).save(p)
    elif kind == "png16":
        p = str(tmp_path / "deep.png")
        Image.fromarray(px[..., 0].astype(np.uint16) * 257).save(p)
    else:
        p = str(tmp_path / "img.bmp")
        Image.fromarray(px).save(p)
    assert image_io._read_png8(p) is None
    assert np.array_equal(image_io.load_rgb(p), jimage_io.load_rgb(p))
    assert np.array_equal(image_io.load_gray(p), jimage_io.load_gray(p))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match=p.rsplit(".", 1)[1].upper()):
        image_io.load_rgb(p)


def test_hdr_without_opencv_raises(tmp_path, monkeypatch):
    p = str(tmp_path / "sky.hdr")
    with open(p, "wb") as f:
        f.write(b"#?RADIANCE\n")
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="HDR"):
        image_io.load_env(p)


# ---------------------------------------------------------------------------
# EXR against the JAX package's reader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["float_rgb", "float_rgba", "float_gray",
                                  "zips_half", "zip_half"])
def test_exr_read_equals_jax(tmp_path, kind):
    rng = np.random.default_rng(11)
    p = str(tmp_path / f"{kind}.exr")
    if kind.startswith("float"):
        c = {"float_rgb": 3, "float_rgba": 4, "float_gray": 1}[kind]
        img = (rng.random((19, 7, c)) * 50.0).astype(np.float32)
        img[0, 0] = 1e-40           # a denormal survives the round trip
        exr.write_exr(p, img)
        with open(p, "rb") as f:
            mine = f.read()
        jexr.write_exr(p + ".jax", img)
        with open(p + ".jax", "rb") as f:
            assert f.read() == mine
    else:
        img = (rng.random((37, 11, 3)) * 8.0).astype(np.float16)
        _zip_half_exr(p, img, 2 if kind == "zips_half" else 3)
    out = exr.read_exr(p)
    assert out.dtype == np.float32
    assert np.array_equal(out, img.astype(np.float32))
    assert np.array_equal(out, jexr.read_exr(p))
    assert np.array_equal(image_io.load_env(p), jimage_io.load_env(p))


# ---------------------------------------------------------------------------
# OBJ assets against the JAX package
# ---------------------------------------------------------------------------

def write_obj(path, m, with_vt=True, with_vn=True):
    """A Mesh as an OBJ file (``%.9g``: float32 values round-trip)."""
    with open(path, "w") as f:
        np.savetxt(f, m.positions, fmt="v %.9g %.9g %.9g")
        if with_vt:
            np.savetxt(f, m.uvs, fmt="vt %.9g %.9g")
        if with_vn:
            np.savetxt(f, m.normals, fmt="vn %.9g %.9g %.9g")
        i = m.indices + 1
        if with_vt and with_vn:
            np.savetxt(f, np.repeat(i, 3, axis=1),
                       fmt="f %d/%d/%d %d/%d/%d %d/%d/%d")
        elif with_vn:
            np.savetxt(f, np.repeat(i, 2, axis=1), fmt="f %d//%d %d//%d %d//%d")
        else:
            np.savetxt(f, i, fmt="f %d %d %d")


def _same_mesh(t, j):
    for f in ("positions", "normals", "uvs", "indices", "tangents"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.fixture
def assets(tmp_path, monkeypatch):
    monkeypatch.setattr(mesh, "ASSET_DIR", str(tmp_path))
    monkeypatch.setattr(jmesh, "ASSET_DIR", str(tmp_path))
    return tmp_path


def test_load_obj_equals_jax(assets):
    """v/vt/vn triples, v//vn pairs, bare v with quads and a pentagon (fan
    triangulation), negative (relative) indices, comments and blank
    lines; without vn the normals are area-weighted."""
    src = mesh.dragon(n_u=12, n_v=5)
    cases = {"full.obj": (True, True), "vn.obj": (False, True),
             "bare.obj": (False, False)}
    for name, (vt, vn) in cases.items():
        write_obj(assets / name, src, vt, vn)
    (assets / "poly.obj").write_text(
        "# a quad, a pentagon, relative indices\n\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 1.5 0.25\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "f 1/1 2/2 3/3 4/4\n"
        "f -5/-4 -4/-3 -3/-2 -1/-1 -2/-1\n")
    for name in (*cases, "poly.obj"):
        t = mesh.load_obj(str(assets / name))
        _same_mesh(t, jmesh.load_obj(str(assets / name)))
    full = mesh.load_obj(str(assets / "full.obj"))
    assert np.array_equal(full.positions[full.indices],
                          src.positions[src.indices])
    assert np.array_equal(full.normals[full.indices],
                          src.normals[src.indices])


def test_bunny_and_dragon_from_assets_equal_jax(assets):
    # the procedural meshes, made while ASSET_DIR is still empty
    small = mesh.dragon(n_u=8, n_v=3)
    write_obj(assets / "bunny.obj", mesh.bunny(subdiv=10))
    write_obj(assets / "dragon.obj", mesh.dragon(n_u=40, n_v=6), True,
              False)
    for scale in (1.0, 1.6):
        _same_mesh(mesh.bunny(scale), jmesh.bunny(scale))
        _same_mesh(mesh.dragon(scale), jmesh.dragon(scale))
    d = mesh.dragon(1.0)
    assert len(d.indices) == 2 * 40 * 6
    assert abs(float(np.ptp(d.positions[:, 1])) - 0.9) < 1e-6
    # dragon.min.obj is preferred to dragon.obj; an LFS stub is skipped
    write_obj(assets / "dragon.min.obj", small)
    _same_mesh(mesh.dragon(), jmesh.dragon())
    assert len(mesh.dragon().indices) == 2 * 8 * 3
    (assets / "dragon.min.obj").write_text(
        "version https://git-lfs.github.com/spec/v1\n")
    assert len(mesh.dragon().indices) == 2 * 40 * 6


def test_try_load_asset_equals_jax(assets):
    write_obj(assets / "m.obj", mesh.uv_sphere(0.7, 6, 9, center=(3, 1, 2)))
    (assets / "stub.obj").write_text(
        "version https://git-lfs.github.com/spec/v1\noid sha256:x\n")
    for name, fit in (("m.obj", None), ("m.obj", 2.5), ("stub.obj", 1.0),
                      ("missing.obj", 1.0)):
        t = mesh.try_load_asset(name, fit)
        j = jmesh.try_load_asset(name, fit)
        assert (t is None) == (j is None) == (name != "m.obj")
        if t is not None:
            _same_mesh(t, j)
    assert mesh._is_lfs_stub(str(assets / "stub.obj"))
    assert mesh._is_lfs_stub(str(assets / "missing.obj"))
    assert not mesh._is_lfs_stub(str(assets / "m.obj"))


def test_box_interior_equals_jax():
    for args in ((), (2.0, 0.5)):
        t, j = mesh.box_interior(*args), jmesh.box_interior(*args)
        assert list(t) == list(j) == ["floor", "ceiling", "back", "left",
                                      "right"]
        for k in t:
            _same_mesh(t[k], j[k])
