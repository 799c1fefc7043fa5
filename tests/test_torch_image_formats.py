"""The port's image codecs (`rnb_neus2_torch/io/{png,tiff,jpeg,exr}.py`)
against cv2 and the JAX package, at odd sizes (37x41 and smaller) so that
partial MCUs, strips and chunks are hit.

PNG, TIFF and JPEG decode equal `cv2.imread` (IMREAD_UNCHANGED, _COLOR,
_GRAYSCALE; BGR(A) flipped) exactly: PNG palette with and without tRNS,
1/2/4-bit grey, RGB colour keys and Adam7, each encoded here by hand with
zlib; TIFF at every compression x predictor x {u8, u16, f32} x {1, 3, 4}
channels cv2 writes, a big-endian file built here and an 8-bit
unassociated alpha; JPEG grey and five samplings, restart intervals,
optimized tables and EXIF orientations. cv2 reads the port's TIFF writer
back exactly, and the port's JPEG encoder writes cv2's bytes. EXR (the
tests' cv2 is built without OpenEXR) is held against an independent
writer that follows the OpenEXR file layout, and the JAX semantics come
from the JAX loaders with `cv2.imread` returning what cv2-with-OpenEXR
returns.
Refused variants raise by name; the read sites (prepare, masks, albedo
scaling, save_image, the Testbed) agree with the JAX package.
"""

import itertools
import json
import os
import struct
import types
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import rnb_neus2_tpu.io.albedo_scaling as jalbedo
import rnb_neus2_tpu.io.image_io as jimage_io
import rnb_neus2_tpu.io.prepare as jprepare
import rnb_neus2_tpu.io.scaling as jscaling
import rnb_neus2_torch.api as ngp
from rnb_neus2_torch.io import (albedo_scaling, exr, image_io, jpeg, png,
                                prepare, scaling, tiff)
from rnb_neus2_torch.io.errors import UnreadableImage, UnsupportedImage

H, W = 37, 41
READ_FLAGS = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
              "grey": cv2.IMREAD_GRAYSCALE}


def _cv2_rgb(path, mode="unchanged"):
    img = cv2.imread(str(path), READ_FLAGS[mode])
    assert img is not None, path
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def _assert_reads_like_cv2(path, modes=("unchanged", "color", "grey")):
    for mode in modes:
        got, want = image_io.read_image(path, mode), _cv2_rgb(path, mode)
        assert got.dtype == want.dtype, mode
        np.testing.assert_array_equal(got, want, err_msg=mode)


def _smooth(rng, shape, top=255):
    """Smooth content with noise: every predictor, run and code length."""
    y, x = np.mgrid[:shape[0], :shape[1]]
    ch = shape[2] if len(shape) == 3 else 1
    base = np.stack([0.5 + 0.4 * np.sin(x / 7.0 + c) * np.cos(y / 5.0 + 2 * c)
                     for c in range(ch)], -1)
    img = np.clip(base + rng.normal(0, 0.08, base.shape), 0, 1)
    return (img * top).reshape(shape)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _pack_rows(samples, depth):
    """(h, n) samples → filter-0 rows of `depth`-bit samples."""
    rows = []
    for r in samples:
        if depth == 16:
            b = r.astype(">u2").tobytes()
        elif depth == 8:
            b = r.astype(np.uint8).tobytes()
        else:
            bits = "".join(format(int(v), f"0{depth}b") for v in r)
            bits += "0" * (-len(bits) % 8)
            b = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
        rows.append(b"\0" + b)
    return b"".join(rows)


def _png(img, depth, ctype, extra=b"", interlace=False):
    """img (h, w, ch) samples; Adam7 passes packed one after another."""
    h, w, ch = img.shape
    if interlace:
        data = b""
        for x0, y0, dx, dy in png.ADAM7:
            sub = img[y0::dy, x0::dx]
            if sub.size:
                data += _pack_rows(sub.reshape(sub.shape[0], -1), depth)
    else:
        data = _pack_rows(img.reshape(h, -1), depth)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))
    return (png.SIGNATURE + _chunk(b"IHDR", ihdr) + extra
            + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b""))


PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
             (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", PNG_KINDS)
def test_png_kinds_match_cv2(tmp_path, ctype, depth, interlace):
    rng = np.random.default_rng(ctype * 17 + depth)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    img = rng.integers(0, 1 << depth, (H, W, ch)).astype(
        np.uint16 if depth == 16 else np.uint8)
    cases = {"plain": b""}
    if ctype == 3:
        n = 1 << depth
        plte = rng.integers(0, 256, (n, 3), dtype=np.uint8)
        plte[0] = plte[0, 0]                     # a grey entry
        cases = {"plain": _chunk(b"PLTE", plte.tobytes())}
        cases["trns"] = cases["plain"] + _chunk(
            b"tRNS", rng.integers(0, 256, max(1, n // 2),
                                  dtype=np.uint8).tobytes())
    elif ctype in (0, 2):
        key = img[3, 5].astype(np.uint16).tolist()
        cases["trns"] = _chunk(b"tRNS", struct.pack(f">{len(key)}H", *key))
    for name, extra in cases.items():
        path = tmp_path / f"{name}.png"
        path.write_bytes(_png(img, depth, ctype, extra, interlace))
        _assert_reads_like_cv2(path)


def test_png_exif_orientation(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
    for o in range(1, 9):
        exif = (b"MM\x00\x2a\x00\x00\x00\x08\x00\x01"
                + struct.pack(">HHIHH", 0x112, 3, 1, o, 0) + bytes(4))
        path = tmp_path / f"o{o}.png"
        path.write_bytes(_png(img, 8, 2, _chunk(b"eXIf", exif)))
        _assert_reads_like_cv2(path)


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

TIFF_CASES = [(dt, ch, comp, pred)
              for dt, ch, comp, pred in itertools.product(
                  ("u8", "u16", "f32"), (1, 3, 4),
                  (1, 5, 8, 32946, 32773), (1, 2, 3))
              if not (pred == 3 and dt != "f32")]
DTYPES = {"u8": (np.uint8, 255), "u16": (np.uint16, 65535),
          "f32": (np.float32, 1)}


@pytest.mark.parametrize("dt,ch,comp,pred", TIFF_CASES)
def test_tiff_matches_cv2(tmp_path, dt, ch, comp, pred):
    dtype, top = DTYPES[dt]
    img = _smooth(np.random.default_rng(ch + comp + pred), (H, W, ch),
                  top).astype(dtype)
    if ch == 1:
        img = img[..., 0]
    bgr = img if ch == 1 else img[..., [2, 1, 0, 3][:ch]]
    cv_path = tmp_path / "cv.tif"
    assert cv2.imwrite(str(cv_path), bgr, [cv2.IMWRITE_TIFF_COMPRESSION, comp,
                                           cv2.IMWRITE_TIFF_PREDICTOR, pred])
    np.testing.assert_array_equal(image_io.read_raw(cv_path), img)
    modes = ("unchanged",) if dt == "f32" else tuple(READ_FLAGS)
    _assert_reads_like_cv2(cv_path, modes)
    port_path = tmp_path / "port.tif"
    tiff.write_tiff(port_path, img, comp, pred)
    np.testing.assert_array_equal(_cv2_rgb(port_path), img)


def _tiff(tags, data, order="<"):
    """A one-strip TIFF built field by field (TIFF 6.0 section 2): `tags`
    {tag: (type, values)}, the strip after the IFD."""
    n = len(tags)
    ifd_end = 8 + 2 + 12 * n + 4
    extra, entries = b"", []
    strip_at = ifd_end
    sizes = {3: "H", 4: "I"}
    # out-of-line values after the IFD, then the strip
    for tag, (typ, vals) in sorted(tags.items()):
        packed = struct.pack(order + sizes[typ] * len(vals), *vals)
        if len(packed) > 4:
            extra += packed
    strip_at += len(extra)
    extra_at, out_of_line = ifd_end, b""
    for tag, (typ, vals) in sorted(tags.items()):
        if tag == 273:
            vals = (strip_at,)
        packed = struct.pack(order + sizes[typ] * len(vals), *vals)
        if len(packed) > 4:
            field = struct.pack(order + "I", extra_at + len(out_of_line))
            out_of_line += packed
        else:
            field = packed.ljust(4, b"\0")
        entries.append(struct.pack(order + "HHI", tag, typ, len(vals))
                       + field)
    head = (b"II*\0" if order == "<" else b"MM\0*") + struct.pack(
        order + "I", 8)
    return (head + struct.pack(order + "H", n) + b"".join(entries)
            + bytes(4) + out_of_line + data)


def _tiff_tags(h, w, bits, spp, comp, n, fmt=1, pred=1, extra=None):
    tags = {256: (4, (w,)), 257: (4, (h,)), 258: (3, (bits,) * spp),
            259: (3, (comp,)), 262: (3, (1 if spp == 1 else 2,)),
            273: (4, (0,)), 277: (3, (spp,)), 278: (4, (h,)),
            279: (4, (n,)), 284: (3, (1,)), 339: (3, (fmt,) * spp)}
    if pred != 1:
        tags[317] = (3, (pred,))
    tags.update(extra or {})
    return tags


@pytest.mark.parametrize("case", ["u16_raw", "u16_deflate_pred2",
                                  "f32_deflate_pred3", "u8_unassoc_alpha"])
def test_tiff_built_by_hand_matches_cv2(tmp_path, case):
    """Big-endian (MM) files, and libtiff's premultiplied read of an 8-bit
    unassociated alpha (ExtraSamples 2), which cv2 returns."""
    rng = np.random.default_rng(3)
    order = "<" if case == "u8_unassoc_alpha" else ">"
    if case.startswith("u16"):
        img = _smooth(rng, (H, W, 3), 65535).astype(np.uint16)
        stored = img.astype(">u2")
        if case == "u16_deflate_pred2":
            d = stored.astype(np.int64)
            d[:, 1:] -= stored[:, :-1].astype(np.int64)
            data = zlib.compress((d % 65536).astype(">u2").tobytes())
            tags = _tiff_tags(H, W, 16, 3, 8, len(data), pred=2)
        else:
            data = stored.tobytes()
            tags = _tiff_tags(H, W, 16, 3, 1, len(data))
    elif case == "f32_deflate_pred3":
        img = rng.normal(size=(H, W, 1)).astype(np.float32)
        planes = img.astype(">f4").view(np.uint8).reshape(H, W, 4) \
            .transpose(0, 2, 1).reshape(H, -1).astype(np.int64)
        d = planes.copy()
        d[:, 1:] -= planes[:, :-1]
        data = zlib.compress((d % 256).astype(np.uint8).tobytes())
        tags = _tiff_tags(H, W, 32, 1, 8, len(data), fmt=3, pred=3)
        img = img[..., 0]
    else:
        img = _smooth(rng, (H, W, 4), 255).astype(np.uint8)
        data = img.tobytes()
        tags = _tiff_tags(H, W, 8, 4, 1, len(data), extra={338: (3, (2,))})
    path = tmp_path / f"{case}.tif"
    path.write_bytes(_tiff(tags, data, order))
    modes = ("unchanged",) if case.startswith("f32") else tuple(READ_FLAGS)
    _assert_reads_like_cv2(path, modes)
    if case != "u8_unassoc_alpha":
        np.testing.assert_array_equal(image_io.read_raw(path), img)


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

SAMPLINGS = {"444": 0x111111, "422": 0x211111, "420": 0x221111,
             "440": 0x121111, "411": 0x411111}
JPEG_OPTIONS = {"default": [], "restart": [cv2.IMWRITE_JPEG_RST_INTERVAL, 2],
                "optimized": [cv2.IMWRITE_JPEG_OPTIMIZE, 1],
                "q40_restart1": [cv2.IMWRITE_JPEG_QUALITY, 40,
                                 cv2.IMWRITE_JPEG_RST_INTERVAL, 1]}


@pytest.mark.parametrize("option", list(JPEG_OPTIONS))
@pytest.mark.parametrize("sampling", ["grey", *SAMPLINGS])
def test_jpeg_decode_matches_cv2(tmp_path, sampling, option):
    rng = np.random.default_rng(len(sampling + option))
    path = tmp_path / "a.jpg"
    for h, w in ((H, W), (3, 2)):
        if sampling == "grey":
            img = _smooth(rng, (h, w), 255).astype(np.uint8)
            params = JPEG_OPTIONS[option]
        else:
            img = _smooth(rng, (h, w, 3), 255).astype(np.uint8)
            params = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling],
                      *JPEG_OPTIONS[option]]
        assert cv2.imwrite(str(path), img, params)
        _assert_reads_like_cv2(path)


def _with_segment(blob: bytes, marker: int, body: bytes,
                  drop_jfif=False) -> bytes:
    """A JPEG with one more segment after SOI (and its JFIF APP0 gone)."""
    rest = blob[2:]
    if drop_jfif:
        n, = struct.unpack(">H", rest[2:4])
        rest = rest[2 + n:]
    return (blob[:2] + struct.pack(">BBH", 0xFF, marker, len(body) + 2)
            + body + rest)


def test_jpeg_exif_orientation(tmp_path):
    """IMREAD_COLOR and IMREAD_GRAYSCALE apply orientations 1-8 (5-8 swap
    H and W: the loader's shape read); IMREAD_UNCHANGED applies none."""
    img = _smooth(np.random.default_rng(1), (13, 22, 3), 255) \
        .astype(np.uint8)
    ok, blob = cv2.imencode(".jpg", img)
    for o in range(1, 9):
        exif = (b"Exif\0\0II\x2a\x00\x08\x00\x00\x00\x01\x00"
                + struct.pack("<HHIHH", 0x112, 3, 1, o, 0) + bytes(4))
        path = tmp_path / f"o{o}.jpg"
        path.write_bytes(_with_segment(blob.tobytes(), 0xE1, exif))
        _assert_reads_like_cv2(path)
        assert image_io.color_shape(path) == cv2.imread(str(path)).shape[:2]


@pytest.mark.parametrize("size", [(H, W), (16, 16), (8, 9), (1, 1),
                                  (64, 33), (17, 40)])
@pytest.mark.parametrize("ch", [1, 3])
def test_jpeg_encoder_writes_cv2s_bytes(tmp_path, size, ch):
    """cv2's defaults (quality 95, 4:2:0, standard tables): the same
    bytes, so the same decode and PSNR (within 0.1 dB, trivially)."""
    img = _smooth(np.random.default_rng(size[0] + ch),
                  size + ((3,) if ch == 3 else ()), 255).astype(np.uint8)
    ok, want = cv2.imencode(".jpg", img if ch == 1 else img[..., ::-1])
    got = jpeg.encode_jpeg(img)
    assert got == want.tobytes()
    (tmp_path / "p.jpg").write_bytes(got)

    def psnr(a):
        mse = np.mean((a.astype(np.float64) - img) ** 2)
        return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))

    dec = _cv2_rgb(tmp_path / "p.jpg")
    ref = cv2.imdecode(want, cv2.IMREAD_UNCHANGED)
    ref = ref if ch == 1 else ref[..., ::-1]
    assert abs(psnr(dec) - psnr(ref)) <= 0.1


# ---------------------------------------------------------------------------
# EXR
# ---------------------------------------------------------------------------

EXR_TYPES = {"half": (1, "<f2"), "float": (2, "<f4"), "uint": (0, "<u4")}
EXR_LINES = {0: 1, 1: 1, 2: 1, 3: 16}


def _exr_reorder_predict(raw: bytes) -> bytes:
    """OpenEXR's ZIP/RLE pre-pass, as its C loops write it."""
    t1, t2 = bytearray(), bytearray()
    for i, b in enumerate(raw):
        (t1 if i % 2 == 0 else t2).append(b)
    t = t1 + t2
    out, p = bytearray(t[:1]), t[0] if t else 0
    for b in t[1:]:
        out.append((b - p + 128 + 256) & 0xFF)
        p = b
    return bytes(out)


def _exr_rle(data: bytes) -> bytes:
    """OpenEXR's rleCompress (runs of 3-128, literals up to 127)."""
    out, start, n = bytearray(), 0, len(data)
    end = 1
    while start < n:
        while end < n and data[start] == data[end] and end - start - 1 < 127:
            end += 1
        if end - start >= 3:
            out += bytes([(end - start - 1) & 0xFF, data[start]])
            start = end
        else:
            while end < n and ((end + 1 >= n or data[end] != data[end + 1])
                               or (end + 2 >= n
                                   or data[end + 1] != data[end + 2])) \
                    and end - start < 127:
                end += 1
            out += bytes([(start - end) & 0xFF]) + data[start:end]
            start = end
        end += 1
    return bytes(out)


def _exr_file(planes, comp, line_order=0, window=(3, -2), version_flags=0,
              extra_attrs=b""):
    """An OpenEXR file written field by field from the file-layout
    document: `planes` {name: (h, w) array of the channel's type}."""
    names = sorted(planes)
    h, w = next(iter(planes.values())).shape
    x0, y0 = window

    def attr(name, kind, value):
        return (name.encode() + b"\0" + kind.encode() + b"\0"
                + struct.pack("<i", len(value)) + value)

    chlist = b""
    for n in names:
        code = {np.dtype("<f2"): 1, np.dtype("<f4"): 2,
                np.dtype("<u4"): 0}[planes[n].dtype]
        chlist += n.encode() + b"\0" + struct.pack("<iB3xii", code, 0, 1, 1)
    chlist += b"\0"
    box = struct.pack("<4i", x0, y0, x0 + w - 1, y0 + h - 1)
    header = (b"\x76\x2f\x31\x01" + struct.pack("<I", 2 | version_flags)
              + attr("channels", "chlist", chlist)
              + attr("compression", "compression", bytes([comp]))
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", bytes([line_order]))
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + extra_attrs + b"\0")
    per = EXR_LINES.get(comp, 16)
    blocks = []
    for first in range(0, h, per):
        raw = b"".join(planes[n][y].tobytes() for y in
                       range(first, min(h, first + per)) for n in names)
        if comp == 1:
            packed = _exr_rle(_exr_reorder_predict(raw))
        elif comp in (2, 3):
            packed = zlib.compress(_exr_reorder_predict(raw))
        else:
            packed = raw
        if len(packed) >= len(raw):
            packed = raw
        blocks.append(struct.pack("<ii", y0 + first, len(packed)) + packed)
    order = range(len(blocks)) if line_order == 0 \
        else range(len(blocks) - 1, -1, -1)
    pos = len(header) + 8 * len(blocks)
    offsets, body = [0] * len(blocks), b""
    for i in order:
        offsets[i] = pos + len(body)
        body += blocks[i]
    return header + struct.pack(f"<{len(blocks)}Q", *offsets) + body


def _exr_image(rng, channels, kind):
    dt = EXR_TYPES[kind][1]
    img = (rng.normal(0.5, 0.6, (H, W, len(channels)))).astype(np.float32)
    img[::4] = np.round(img[::4], 1)            # runs for RLE
    img = img.astype(dt).astype(np.float32)     # exactly representable
    img[0, 0, 0] = 0.0 if kind == "float" else 65504.0
    return img, {c: img[..., i].astype(dt) for i, c in enumerate(channels)}


def _as_cv2(img):
    """What cv2-with-OpenEXR returns for the file: BGR(A) float32."""
    if img.ndim == 2 or img.shape[2] == 1:
        return img.reshape(img.shape[:2])
    return img[..., [2, 1, 0, 3][:img.shape[2]]].copy()


EXR_CASES = list(itertools.product(("NO", "RLE", "ZIPS", "ZIP"),
                                   ("half", "float"), ("Y", "RGB", "RGBA"),
                                   (0, 1)))


@pytest.mark.parametrize("comp,kind,chans,line_order", EXR_CASES)
def test_exr_reads_the_written_arrays(tmp_path, comp, kind, chans,
                                      line_order):
    rng = np.random.default_rng(len(comp + kind + chans) + line_order)
    img, planes = _exr_image(rng, tuple(chans), kind)
    path = tmp_path / "a.exr"
    code = {"NO": 0, "RLE": 1, "ZIPS": 2, "ZIP": 3}[comp]
    path.write_bytes(_exr_file(planes, code, line_order))
    got = image_io.read_raw(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, img[..., 0] if chans == "Y" else img)


@pytest.mark.parametrize("chans", ["Y", "RGB", "RGBA"])
def test_exr_jax_semantics_and_save_exr(tmp_path, monkeypatch, chans):
    """The JAX loaders on what cv2-with-OpenEXR gives equal the port's
    loaders on the file; `save_exr` writes the channels the JAX save_exr
    hands cv2, under cv2's names."""
    img, _ = _exr_image(np.random.default_rng(9), tuple(chans), "half")
    img[1, 2] = -0.25                           # clipped by raw16
    planes = {c: img[..., i].astype("<f2") for i, c in enumerate(chans)}
    img = img[..., 0] if chans == "Y" else img
    path = tmp_path / "n.exr"
    path.write_bytes(_exr_file(planes, 3))
    real = cv2.imread
    monkeypatch.setattr(cv2, "imread", lambda p, f=cv2.IMREAD_COLOR:
                        _as_cv2(img) if str(p) == str(path) else real(p, f))
    for name in ("load_image", "load_image_raw16", "load_normal"):
        got, want = (getattr(m, name)(path) for m in (image_io, jimage_io))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    # save_exr: the port's file holds, by channel name, the array the JAX
    # save_exr hands cv2, under cv2's EXR names B, G, R(, A) (this cv2 has
    # no OpenEXR, so imwrite is recorded, not run)
    handed = []
    monkeypatch.setattr(jimage_io, "cv2", types.SimpleNamespace(
        imwrite=lambda p, a, params=(): handed.append(a.copy()) or True,
        IMWRITE_EXR_TYPE=cv2.IMWRITE_EXR_TYPE,
        IMWRITE_EXR_TYPE_FLOAT=cv2.IMWRITE_EXR_TYPE_FLOAT))
    jimage_io.save_exr(img, tmp_path / "j.exr")
    image_io.save_exr(img, tmp_path / "s.exr")
    (want,) = handed
    np.testing.assert_array_equal(image_io.read_raw(tmp_path / "s.exr"),
                                  _as_cv2(want))
    stored = exr._channels(exr._header(
        (tmp_path / "s.exr").read_bytes(), "s")[0]["channels"][1], "s")
    assert [n for n, _, _ in stored] == sorted(chans)
    if chans == "RGBA":     # the file's R holds G, G B, B A and A R
        np.testing.assert_array_equal(image_io.read_raw(tmp_path / "s.exr"),
                                      img[..., [1, 2, 3, 0]])


# ---------------------------------------------------------------------------
# what is refused
# ---------------------------------------------------------------------------

def _refused_jpegs(tmp_path):
    """JPEG kinds that cv2 cannot read either (UnreadableImage)."""
    img = _smooth(np.random.default_rng(2), (9, 10, 3), 255).astype(np.uint8)
    ok, blob = cv2.imencode(".jpg", img)
    blob = blob.tobytes()
    sof = blob.index(b"\xff\xc0")
    out = {}
    for marker in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
        p = tmp_path / f"{marker:x}.jpg"
        p.write_bytes(blob[:sof + 1] + bytes([marker]) + blob[sof + 2:])
        out[p] = "hierarchical"
    p = tmp_path / "p12.jpg"
    p.write_bytes(blob[:sof + 4] + b"\x0c" + blob[sof + 5:])
    out[p] = "12-bit"
    p = tmp_path / "two.jpg"
    p.write_bytes(b"\xff\xd8\xff\xc0" + struct.pack(">HBHHB", 14, 8, 4, 4, 2)
                  + b"".join(bytes([i, 0x11, 0]) for i in range(2))
                  + b"\xff\xd9")
    out[p] = "2-component"
    return {p: (what, UnreadableImage) for p, what in out.items()}


EXR_FIXTURES = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                            "formats")


def _refused_exrs(tmp_path):
    """EXR kinds that cv2 (with OpenEXR) reads and the port refuses by
    name (UnsupportedImage): deep files, UINT and subsampled (Y/RY/BY)
    channels, other channel sets. The variants the port now reads must
    read: every compression (a chunk stored raw, as OpenEXR stores one
    that does not shrink), tiled and multi-part files (OpenEXR's own)."""
    planes = {c: np.zeros((3, 4), "<f4") for c in "BGR"}
    for code in range(4, 10):           # PIZ, PXR24, B44, B44A, DWAA, DWAB
        p = tmp_path / f"{code}.exr"
        p.write_bytes(_exr_file(planes, code))
        np.testing.assert_array_equal(image_io.load_image(p),
                                      np.zeros((3, 4, 3), np.float32))
    for name in ("exr_tiled_8x8_mipmap_down_decreasing_b44a.exr",
                 "exr_multipart_scanline.exr", "exr_multipart_tiled.exr"):
        assert image_io.load_image(os.path.join(EXR_FIXTURES, name)).ndim == 3
    out = {}
    p = tmp_path / "deep.exr"
    p.write_bytes(_exr_file(planes, 0, version_flags=0x800))
    out[p] = "deep"
    for name, what in (("exr_refused_deep.exr", "deep"),
                       ("exr_refused_uint.exr", "UINT"),
                       ("exr_refused_subsampled.exr", "subsampled")):
        out[tmp_path / name] = what
        (tmp_path / name).write_bytes(
            open(os.path.join(EXR_FIXTURES, name), "rb").read())
    p = tmp_path / "uint.exr"
    p.write_bytes(_exr_file({c: np.zeros((3, 4), "<u4") for c in "BGR"}, 0))
    out[p] = "UINT"
    p = tmp_path / "names.exr"
    p.write_bytes(_exr_file({"Z": np.zeros((3, 4), "<f4")}, 0))
    out[p] = "channel set"
    return {p: (f"{what}.*not supported", UnsupportedImage)
            for p, what in out.items()}


def _refused_tiffs(tmp_path):
    """TIFF kinds that cv2 cannot read either (UnreadableImage)."""
    out = {}
    data = bytes(64)
    for what, extra in (("2-bit", {258: (3, (2,))}),
                        ("4-bit", {258: (3, (4,))}),
                        ("float16", {258: (3, (16,)), 339: (3, (3,))}),
                        ("Orientation 5", {274: (3, (5,))}),
                        ("Orientation 8", {274: (3, (8,))})):
        p = tmp_path / f"{what}.tif"
        # 4x5: cv2 reads orientations 5-8 of square images only
        p.write_bytes(_tiff(_tiff_tags(4, 5, 8, 1, 1, len(data),
                                       extra=extra), data))
        out[p] = what
    p = tmp_path / "big.tif"
    p.write_bytes(b"II+\x00\x08\x00\x00\x00" + bytes(16))
    out[p] = "TIFF directory outside the file"
    return {p: (what, UnreadableImage) for p, what in out.items()}


@pytest.mark.parametrize("family", ["jpeg", "exr", "tiff"])
def test_refused_variants_raise_by_name(tmp_path, family):
    """Each refusal names the file's feature. JPEG and TIFF: what cv2
    cannot read either (cv2 returns None on the same bytes); EXR: what
    stays refused (and the variants that now read, read)."""
    cases = {"jpeg": _refused_jpegs, "exr": _refused_exrs,
             "tiff": _refused_tiffs}[family](tmp_path)
    for path, (what, cls) in cases.items():
        with pytest.raises(cls, match=what):
            image_io.load_image(path)
        if cls is UnreadableImage:
            assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None, path


def _segment_at(blob: bytes, marker: int) -> int:
    """Offset of the first segment with this marker, up to the scan."""
    pos = 2
    while blob[pos + 1] != marker:
        assert blob[pos + 1] != 0xDA, f"no marker {marker:#x}"
        pos += 2 + struct.unpack_from(">H", blob, pos + 2)[0]
    return pos


def _patched(blob: bytes, at: int, new: bytes) -> bytes:
    return blob[:at] + new + blob[at + len(new):]


def _malformed_jpegs():
    """Headers that once reached the Huffman decoder's fixed-size arrays
    out of bounds; each → (file, what the error names)."""
    img = _smooth(np.random.default_rng(3), (11, 13, 3), 255) \
        .astype(np.uint8)
    blob = cv2.imencode(".jpg", img)[1].tobytes()       # 4:2:0, std tables
    dht, sos, sof = (_segment_at(blob, m) for m in (0xC4, 0xDA, 0xC0))
    # the DC luma table's BITS (0 1 5 1 1 1 1 1 1 0 ...) with three 1-bit
    # codes, same total: codes overflow their length
    overfull = _patched(blob, dht + 5, bytes([3, 0, 3]))
    many = bytes(14) + bytes([2, 255])                  # 257 values
    sos_head = blob[sos:sos + 4]

    def scan(*comps):
        body = bytes([len(comps)]) + b"".join(
            bytes([c, 0 if c == 1 else 0x11]) for c in comps) + b"\0\x3f\0"
        return (blob[:sos] + struct.pack(">BBH", 0xFF, 0xDA, len(body) + 2)
                + body + blob[sos + 2 + struct.unpack(">H", sos_head[2:])[0]:])

    return {
        "overfull_code_lengths": (overfull, "bad Huffman table"),
        "short_bits": (_with_segment(blob, 0xC4, b"\0" + bytes(10)),
                       "bad JPEG Huffman table"),
        "257_values": (_with_segment(blob, 0xC4, b"\0" + many + bytes(257)),
                       "bad JPEG Huffman table"),
        "table_index_4": (_with_segment(blob, 0xC4, b"\x04" + bytes(15)
                                        + b"\x01\x00"),
                          "Huffman table index"),
        "scan_of_5": (scan(1, 2, 3, 1, 2), "scan header with 5"),
        "repeated_component": (scan(1, 1, 3), "component 1 twice"),
        "sampling_0": (_patched(blob, sof + 11, b"\x02"),
                       "sampling factors"),
        "mcu_of_18_blocks": (_patched(blob, sof + 11, b"\x44"),
                             "MCU of 18 blocks"),
    }


@pytest.mark.parametrize("case", sorted(_malformed_jpegs()))
def test_jpeg_refuses_malformed_headers(tmp_path, case):
    """Each raises ValueError naming the file, before the entropy decoder
    reads past a table; libjpeg-turbo (cv2) refuses each too."""
    data, what = _malformed_jpegs()[case]
    path = tmp_path / f"{case}.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"{case}.jpg.*{what}"):
        jpeg.read_jpeg(path)
    assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is None


# ---------------------------------------------------------------------------
# the read and write sites
# ---------------------------------------------------------------------------

def _views(root, n=3):
    """Three views around the origin, sphere normals, albedos and masks."""
    views = []
    yy, xx = np.mgrid[:H, :W]
    r = np.hypot(yy - H / 2, xx - W / 2)
    inside = r < 14
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = np.array([3 * np.sin(a), 0.2, 3 * np.cos(a)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, np.cross(fwd, right), fwd], 1)
        c2w[:3, 3] = eye
        K = np.array([[40.0, 0, W / 2], [0, 40.0, H / 2], [0, 0, 1]])
        views.append({"c2w": c2w, "K": K, "inside": inside, "i": i,
                      "root": root})
    return views


def _write_scene(root, normal_fmt, albedo_fmt, mask_fmt, exr_arrays):
    """The scene's data dict; every float array written to an .exr file
    is kept in exr_arrays by path."""
    rng = np.random.default_rng(4)
    views = _views(root)
    os.makedirs(root, exist_ok=True)
    out = []
    for v in views:
        i = v["i"]
        nrm = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
        alb = _smooth(rng, (H, W, 3), 1).astype(np.float32)
        msk = v["inside"].astype(np.float32)
        paths = {}
        for key, img, fmt in (("normal", (nrm + 1) / 2, normal_fmt),
                              ("albedo", alb, albedo_fmt),
                              ("mask", np.dstack([msk] * 3), mask_fmt)):
            p = os.path.join(root, f"{key}{i}.{fmt}")
            if fmt == "exr":
                exr_arrays[p] = img * 2 - 1 if key == "normal" else img
                image_io.save_exr(exr_arrays[p], p)
            else:
                image_io.save_image(img, p, 8 if fmt == "jpg" else 16)
            paths[key] = p
        out.append({"c2w": v["c2w"], "K": v["K"],
                    "normal_path": paths["normal"],
                    "albedo_path": paths["albedo"],
                    "mask_path": paths["mask"]})
    return {"views": out, "image_width": W, "image_height": H,
            "landmarks": None}


def _fake_exr_imread(monkeypatch, exr_arrays):
    """cv2.imread of an .exr returns the BGR(A) floats cv2-with-OpenEXR
    gives for the float32 array written there (FLOAT channels: exact)."""
    real = cv2.imread

    def imread(p, flags=cv2.IMREAD_COLOR):
        if str(p).endswith(".exr"):
            return _as_cv2(np.asarray(exr_arrays[str(p)], np.float32))
        return real(p, flags)
    monkeypatch.setattr(cv2, "imread", imread)


@pytest.mark.parametrize("fmts", [("tif", "tif", "jpg"),
                                  ("exr", "tif", "jpg"),
                                  ("png", "exr", "exr")])
def test_prepare_matches_jax_on_other_formats(tmp_path, monkeypatch, fmts):
    exr_arrays = {}
    data = _write_scene(str(tmp_path / "in"), *fmts, exr_arrays)
    prepare.prepare_testbed_data(data, str(tmp_path / "port"),
                                 scaling_mode="silhouettes")
    _fake_exr_imread(monkeypatch, exr_arrays)
    jprepare.prepare_testbed_data(data, str(tmp_path / "jax"),
                                  scaling_mode="silhouettes")
    tj, jtj = (json.load(open(tmp_path / d / "transform.json"))
               for d in ("port", "jax"))
    np.testing.assert_allclose(tj["n2w"], jtj["n2w"], rtol=1e-9)
    for fr, jfr in zip(tj["frames"], jtj["frames"]):
        np.testing.assert_allclose(fr["transform_matrix"],
                                   jfr["transform_matrix"], rtol=1e-9)
        for k in ("normal_path", "albedo_path"):
            np.testing.assert_array_equal(
                png.read_png(tmp_path / "port" / fr[k]),
                _cv2_rgb(tmp_path / "jax" / jfr[k]))


@pytest.mark.parametrize("fmt", ["jpg", "exr", "tif"])
def test_masks_match_jax(tmp_path, monkeypatch, fmt):
    """read_mask and load_mask_for_depth: float masks above 0.5, JPEG and
    TIFF masks on their blue channel, at both bit depths."""
    rng = np.random.default_rng(5)
    img = np.zeros((H, W, 3), np.float32)
    img[..., 2] = rng.random((H, W))          # blue decides
    img[..., 0] = 1 - img[..., 2]
    path = str(tmp_path / f"m.{fmt}")
    if fmt == "exr":
        image_io.save_exr(img, path)
    else:
        image_io.save_image(img, path, 8)
    _fake_exr_imread(monkeypatch, {path: img})
    for depth in (8, 16):
        np.testing.assert_array_equal(
            prepare.load_mask_for_depth(path, (H, W), depth),
            jprepare.load_mask_for_depth(path, (H, W), depth))
    view = {"mask_path": path, "c2w": np.eye(4), "K": np.eye(3)}
    _, (want,) = jscaling.cameras_for_silhouettes({"views": [view]})
    np.testing.assert_array_equal(scaling.read_mask(path), want)


@pytest.mark.parametrize("fmt", ["tif", "jpg"])
def test_scale_and_save_albedos_match_jax(tmp_path, fmt):
    """TIFF and JPEG albedos (under .png names, which the stage lists; cv2
    and the port find the format from the signature)."""
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(6)
    for i in range(3):
        img = _smooth(rng, (H, W, 4 if fmt == "tif" else 3), 1)
        image_io.save_image(img, src / f"x{i}.{fmt}", 16)
        os.rename(src / f"x{i}.{fmt}", src / f"{i:05d}.png")
    ratios = rng.uniform(0.7, 1.3, (3, 3))
    albedo_scaling.scale_and_save_albedos(str(src), str(tmp_path / "p"),
                                          ratios)
    jalbedo.scale_and_save_albedos(str(src), str(tmp_path / "j"), ratios)
    for name in sorted(os.listdir(src)):
        np.testing.assert_array_equal(png.read_png(tmp_path / "p" / name),
                                      _cv2_rgb(tmp_path / "j" / name))
    image_io.save_exr(np.zeros((4, 4, 3), np.float32), src / "00009.exr")
    with pytest.raises(ValueError, match="EXR"):
        albedo_scaling.scale_and_save_albedos(str(src), str(tmp_path / "q"),
                                              np.ones((4, 3)))


# formats whose cv2 encoder the port copies byte for byte
EXACT_WRITERS = (".jpg", ".jpeg", ".bmp", ".dib", ".ppm", ".pnm", ".pgm",
                 ".pbm", ".pam", ".pfm", ".hdr", ".pic", ".ras", ".sr")


@pytest.mark.parametrize("ext", [".png", ".tif", ".tiff", ".jpg", ".jpeg",
                                 ".bmp", ".dib", ".ppm", ".pnm", ".pgm",
                                 ".pbm", ".pam", ".pfm", ".hdr", ".pic",
                                 ".ras", ".sr"])
@pytest.mark.parametrize("bit_depth", [8, 16])
def test_save_image_by_extension_matches_jax(tmp_path, ext, bit_depth):
    """The port writes what the JAX save_image (cv2.imwrite) writes; where
    cv2.imwrite returns False both return and leave the same files (none,
    or the bytes cv2 leaves)."""
    img = np.random.default_rng(bit_depth).uniform(-0.1, 1.1, (H, W, 4)) \
        .astype(np.float32)
    img[0, 0, 0] = np.nan
    _assert_saves_as_jax(tmp_path, img, ext, bit_depth)


def _listing(d):
    return {name: (d / name).read_bytes() for name in sorted(os.listdir(d))}


def _assert_saves_as_jax(tmp_path, img, ext, bit_depth):
    """The JAX save_image and the port's into fresh folders: the same
    files, the same format, cv2's reads equal, cv2's bytes for the exact
    writers and wherever cv2.imwrite fails."""
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    pdir.mkdir()
    jimage_io.save_image(img, jdir / f"x{ext}", bit_depth)
    image_io.save_image(img, pdir / f"x{ext}", bit_depth)
    want, got = _listing(jdir), _listing(pdir)
    assert sorted(got) == sorted(want)
    samples = (np.clip(np.nan_to_num(img), 0, 1) * (2 ** bit_depth - 1)) \
        .astype(np.uint8 if bit_depth == 8 else np.uint16)
    if not cv2.imwrite(str(tmp_path / f"c{ext}"), _as_cv2(samples)):
        assert got == want                      # what cv2 leaves
        return
    got, want = got[f"x{ext}"], want[f"x{ext}"]
    assert got[:4] == want[:4]                      # the same format
    if ext != ".pam":   # cv2 cannot read back the 4-channel PAM it writes
        np.testing.assert_array_equal(_cv2_rgb(pdir / f"x{ext}"),
                                      _cv2_rgb(jdir / f"x{ext}"))
    if ext in EXACT_WRITERS:
        assert got == want


@pytest.mark.parametrize("ext,chans,side", [
    (".pgm", 3, 24), (".pbm", 4, 24), (".ppm", 1, 24), (".ppm", 4, 24),
    (".pnm", 4, 24), (".pfm", 4, 24), (".hdr", 4, 24), (".pic", 4, 24),
    (".gif", 1, 24), (".jp2", 1, 20), (".jp2", 3, 31), (".jp2", 4, 12),
    (".pgm", 1, 24), (".pnm", 1, 24), (".gif", 3, 24), (".jp2", 3, 32)])
@pytest.mark.parametrize("bit_depth", [8, 16])
def test_save_image_where_cv2_fails_matches_jax(tmp_path, ext, chans, side,
                                                bit_depth):
    """Channel counts and sizes that cv2.imwrite returns False for: the
    port returns as the JAX save_image does and leaves the same folder
    (nothing; an empty GIF; a PFM of "P"; a JP2 of its header boxes);
    beside each kind a case that writes."""
    shape = (side, side + 5) + ((chans,) if chans > 1 else ())
    img = np.random.default_rng(chans + side).uniform(0, 1, shape) \
        .astype(np.float32)
    _assert_saves_as_jax(tmp_path, img, ext, bit_depth)


def test_save_image_refuses_what_cv2_refuses(tmp_path):
    img = np.zeros((4, 4, 3), np.float32)
    with pytest.raises(ValueError, match="EXR"):
        image_io.save_image(img, tmp_path / "a.exr")
    with pytest.raises(cv2.error):
        jimage_io.save_image(img, tmp_path / "j.exr")
    with pytest.raises(ValueError, match="extension"):
        image_io.save_image(img, tmp_path / "a.xyz")


def test_testbed_screenshot_and_image_mode(tmp_path, monkeypatch):
    """`screenshot("x.jpg")` writes a JPEG (cv2's bytes for the 8-bit
    render), and the Image mode loads a TIFF as the JAX loader does."""
    tb = ngp.Testbed(ngp.TestbedMode.Nerf, device="cpu")
    frame = np.random.default_rng(8).random((H, W, 4)).astype(np.float32)
    monkeypatch.setattr(tb, "render_to_cpu", lambda view_idx=0: frame)
    tb.screenshot(str(tmp_path / "x.jpg"))
    blob = (tmp_path / "x.jpg").read_bytes()
    assert blob.startswith(jpeg.SIGNATURE)
    eight = (frame * 255).astype(np.uint8)[..., [2, 1, 0]]
    assert blob == cv2.imencode(".jpg", eight)[1].tobytes()
    image_io.save_image(frame, tmp_path / "i.tif", 16)
    im = ngp.Testbed(ngp.TestbedMode.Image, device="cpu")
    im.load_training_data(str(tmp_path / "i.tif"))
    np.testing.assert_array_equal(
        im._extra._data[0], jimage_io.load_image(str(tmp_path / "i.tif"))
        [..., :3])


def _jax_converter():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_data_format_from_neus",
        os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools",
                     "data_format_from_neus.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("image_ext,mask_ext", [(".jpg", ".tif"),
                                                (".tif", ".jpg"),
                                                (".png", ".png")])
def test_neus_converter_matches_jax_on_other_formats(tmp_path, image_ext,
                                                     mask_ext):
    """IMREAD_COLOR images and IMREAD_GRAYSCALE colour masks in JPEG,
    TIFF and PNG, each written back under its own name as cv2 writes it
    (a .jpg drops the mask)."""
    from rnb_neus2_torch.tools import data_format_from_neus
    rng = np.random.default_rng(11)
    root = tmp_path / "neus"
    (root / "image").mkdir(parents=True)
    (root / "mask").mkdir()
    mats = {}
    for i in range(2):
        P = np.array([[30.0, 0, W / 2, 0.1], [0, 31.0, H / 2, -0.2],
                      [0, 0, 1, 3.0 + i]], np.float32)
        mats[f"world_mat_{i}"] = np.vstack([P, [0, 0, 0, 1]])
        mats[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
        image_io.save_image(_smooth(rng, (H, W, 3), 1),
                            root / "image" / f"{i:03d}{image_ext}", 16)
        mask = np.dstack([rng.random((H, W)) > 0.5] * 3) * [1.0, 0.6, 0.2]
        image_io.save_image(mask, root / "mask" / f"{i:03d}{mask_ext}", 8)
    np.savez(root / "cameras_sphere.npz", **mats)
    data_format_from_neus.generate(str(root), str(tmp_path / "port"))
    _jax_converter().generate(str(root), str(tmp_path / "jax"))
    got, want = (json.load(open(tmp_path / d / "transform.json"))
                 for d in ("port", "jax"))
    assert (got["w"], got["h"]) == (want["w"], want["h"]) == (W, H)
    for f, jf in zip(got["frames"], want["frames"]):
        assert f["file_path"] == jf["file_path"]
        a, b = (tmp_path / d / f["file_path"] for d in ("port", "jax"))
        np.testing.assert_array_equal(_cv2_rgb(a), _cv2_rgb(b))
        if image_ext == ".jpg":
            assert a.read_bytes() == b.read_bytes()

