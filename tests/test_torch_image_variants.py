"""The JPEG and TIFF variants that cv2 decodes, held against cv2 in its
three read modes (IMREAD_UNCHANGED, _COLOR, _GRAYSCALE) at odd sizes, and
what cv2 cannot read either (the port's `UnreadableImage`, asserted
beside cv2's None on the same bytes, so that a change in cv2 shows up).

JPEG: progressive files (cv2's and PIL's), also cut after each of their
scans (libjpeg-turbo's block smoothing), files cut inside a scan or a
header (sequential and progressive), arithmetic-coded sequential and
progressive files with DAC conditioning and restarts, lossless files
(every predictor, point transforms, restarts), CMYK over a grid of
(c, m, y, k), YCCK and RGB. TIFF: tiles, planar-separate data, JPEG
compression, 1-bit grey, palettes, MinIsWhite, YCbCr, CMYK, signed and
64-bit samples, orientations, BigTIFF. Files that neither cv2 nor PIL
writes come from `torch_image_writers.py`. The committed fixtures
(`torch_fixtures/formats/`) equal cv2's decode in `expected.npz`.
"""

import io
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

import torch_image_writers as tw
from rnb_neus2_torch.io import image_io, jpeg, native
from rnb_neus2_torch.io.errors import UnreadableImage, UnsupportedImage

H, W = 37, 53
MODES = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "grey": cv2.IMREAD_GRAYSCALE}
FIXTURES = Path(__file__).parent / "torch_fixtures" / "formats"


def _cv2(path, mode):
    """cv2.imread in RGB(A) order; None where cv2 returns None (or
    raises, as it does for some TIFF orientations)."""
    try:
        img = cv2.imread(str(path), MODES[mode])
    except cv2.error:
        return None
    if img is not None and img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def _like_cv2(tmp_path, blob, name="f", suffix=".jpg"):
    """Every mode: the port's array equals cv2's, or both refuse (cv2
    None, the port UnreadableImage). → the modes cv2 read."""
    path = tmp_path / f"{name}{suffix}"
    path.write_bytes(blob)
    read = []
    for mode in MODES:
        want = _cv2(path, mode)
        if want is None:
            with pytest.raises(UnreadableImage):
                image_io.read_image(path, mode)
            continue
        got = image_io.read_image(path, mode)
        assert got.dtype == want.dtype, (name, mode)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {mode}")
        read.append(mode)
    return read


def _unreadable(tmp_path, blob, name, suffix=".jpg"):
    path = tmp_path / f"{name}{suffix}"
    path.write_bytes(blob)
    assert _cv2(path, "unchanged") is None, name
    with pytest.raises(UnreadableImage):
        image_io.read_image(path)
    # the JAX loaders' type for a None from cv2
    with pytest.raises(FileNotFoundError):
        image_io.load_image(path)


def _smooth(rng, shape):
    y, x = np.mgrid[:shape[0], :shape[1]]
    ch = shape[2] if len(shape) == 3 else 1
    base = np.stack([0.5 + 0.4 * np.sin(x / 6.0 + c) * np.cos(y / 4.0 + c)
                     for c in range(ch)], -1)
    img = np.clip(base + rng.normal(0, 0.1, base.shape), 0, 1)
    return (img * 255).astype(np.uint8).reshape(shape)


def _scan_starts(blob):
    """Offsets of the SOS markers of a JPEG."""
    out, pos = [], 2
    while pos + 4 <= len(blob):
        if blob[pos] != 0xFF or blob[pos + 1] in (0x00, 0xFF, 0x01) or \
                0xD0 <= blob[pos + 1] <= 0xD7:
            pos += 1
            continue
        if blob[pos + 1] == 0xD9:
            break
        if blob[pos + 1] == 0xDA:
            out.append(pos)
        pos += 2 + struct.unpack_from(">H", blob, pos + 2)[0]
    return out


# ---------------------------------------------------------------------------
# JPEG: progressive
# ---------------------------------------------------------------------------

SAMPLINGS = {"grey": None, "444": 0x111111, "420": 0x221111,
             "422": 0x211111, "411": 0x411111}


def _cv2_progressive(rng, sampling, extra=()):
    shape = (H, W) if sampling == "grey" else (H, W, 3)
    params = [cv2.IMWRITE_JPEG_PROGRESSIVE, 1, *extra]
    if SAMPLINGS[sampling]:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
    return cv2.imencode(".jpg", _smooth(rng, shape), params)[1].tobytes()


@pytest.mark.parametrize("option", ["default", "restart", "q30"])
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_progressive_jpeg_matches_cv2(tmp_path, sampling, option):
    extra = {"default": (), "restart": (cv2.IMWRITE_JPEG_RST_INTERVAL, 2),
             "q30": (cv2.IMWRITE_JPEG_QUALITY, 30)}[option]
    blob = _cv2_progressive(np.random.default_rng(len(sampling + option)),
                            sampling, extra)
    assert b"\xff\xc2" in blob
    assert len(_like_cv2(tmp_path, blob)) == 3


@pytest.mark.parametrize("sampling", ["grey", "420", "444"])
def test_progressive_jpeg_cut_after_each_scan(tmp_path, sampling):
    """A file that ends after k of its scans (libjpeg's EOF gives a fake
    EOI): coefficients still unrefined are estimated by libjpeg-turbo's
    block smoothing, which the port reproduces."""
    rng = np.random.default_rng(7)
    blob = _cv2_progressive(rng, sampling, (cv2.IMWRITE_JPEG_QUALITY, 75))
    starts = _scan_starts(blob)
    assert len(starts) >= 6
    for k in range(1, len(starts)):
        assert len(_like_cv2(tmp_path, blob[:starts[k]], f"cut{k}")) == 3


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("sampling", ["grey", "420", "444"])
@pytest.mark.parametrize("progressive", [False, True])
def test_truncated_jpeg_matches_cv2(tmp_path, progressive, sampling,
                                    restart):
    """Files that end inside a scan or a header segment, as libjpeg reads
    them through its fake EOI: the MCU where the data ends decodes on
    zero bits, later ones stay as the earlier scans left them, a restart
    marker lost to the end is skipped, and in a progressive file the
    iMCU rows past the one where the data ended are smoothed with the
    progression status from before that scan."""
    extra = (cv2.IMWRITE_JPEG_RST_INTERVAL, restart) if restart else ()
    if progressive:
        blob = _cv2_progressive(np.random.default_rng(13), sampling, extra)
    else:
        shape = (H, W) if sampling == "grey" else (H, W, 3)
        params = [*extra]
        if SAMPLINGS[sampling]:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
        blob = cv2.imencode(".jpg", _smooth(np.random.default_rng(13),
                                            shape), params)[1].tobytes()
    first = _scan_starts(blob)[0]
    read = [len(_like_cv2(tmp_path, blob[:cut], f"t{cut}"))
            for cut in np.linspace(first + 20, len(blob) - 3, 12).astype(int)]
    # a cut inside a scan header or a table leaves garbage that libjpeg
    # (and the port) refuse; most cuts fall in entropy-coded data
    assert set(read) <= {0, 3} and read.count(3) >= 8


def test_pil_progressive_jpeg_and_noise(tmp_path):
    rng = np.random.default_rng(8)
    for mode, shape in (("RGB", (H, W, 3)), ("L", (H, W))):
        bio = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, shape).astype(np.uint8),
                        mode).save(bio, "JPEG", progressive=True,
                                   quality=85)
        blob = bio.getvalue()
        _like_cv2(tmp_path, blob, f"pil{mode}")
        cut = blob[:_scan_starts(blob)[2]]
        _like_cv2(tmp_path, cut, f"pilcut{mode}")


# ---------------------------------------------------------------------------
# JPEG: arithmetic coding, lossless
# ---------------------------------------------------------------------------

def _coef_blocks(rng, hs, vs, h=H, w=W):
    """Quantized DCT blocks per component, padded to whole MCUs: a smooth
    DC field and sparse AC coefficients that shrink with frequency."""
    hmax, vmax = max(hs), max(vs)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    out = []
    for c in range(len(hs)):
        bh, bw = mcuy * vs[c], mcux * hs[c]
        b = np.zeros((bh, bw, 64), np.int64)
        yy, xx = np.mgrid[:bh, :bw]
        b[..., 0] = (40 * np.sin(yy / 3.0 + c) * np.cos(xx / 4.0)).astype(
            int) + rng.integers(-3, 4, (bh, bw))
        keep = rng.random((bh, bw, 63)) < np.linspace(0.7, 0.02, 63)
        b[..., 1:] = (rng.normal(0, np.linspace(30, 1, 63), (bh, bw, 63))
                      * keep).astype(int)
        out.append(b)
    return out


QTABLES = [np.clip(np.arange(64) // 4 + 2, 1, 255), np.full(64, 5)]
LAYOUTS = {"grey": ([1], [1]), "444": ([1, 1, 1], [1, 1, 1]),
           "420": ([2, 1, 1], [2, 1, 1]), "422": ([2, 1, 1], [1, 1, 1])}


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("dac", [None, (1, 3, 2), (0, 0, 20)])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_arithmetic_jpeg_matches_cv2(tmp_path, layout, dac, restart):
    """SOF9 and SOF10 of the same coefficients decode alike in cv2 (which
    checks the test's encoder) and in the port; progressive files cut
    after 1 and 3 scans too."""
    hs, vs = LAYOUTS[layout]
    blocks = _coef_blocks(np.random.default_rng(len(layout)), hs, vs)
    seq = tw.arith_jpeg(blocks, QTABLES, H, W, hs, vs, restart=restart,
                        dac=dac)
    prog = tw.arith_jpeg(blocks, QTABLES, H, W, hs, vs, progressive=True,
                         restart=restart, dac=dac)
    assert len(_like_cv2(tmp_path, seq, "seq")) == 3
    assert len(_like_cv2(tmp_path, prog, "prog")) == 3
    np.testing.assert_array_equal(_cv2(tmp_path / "seq.jpg", "unchanged"),
                                  _cv2(tmp_path / "prog.jpg", "unchanged"))
    for k in (1, 3):
        cut = tw.arith_jpeg(blocks, QTABLES, H, W, hs, vs, progressive=True,
                            restart=restart, dac=dac, cut_after=k)
        _like_cv2(tmp_path, cut, f"cut{k}")


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_jpeg_matches_cv2(tmp_path, predictor):
    """8-bit and 5-bit precision, point transform 0 and 2, restarts;
    grey, RGB (Adobe transform 0 or no marker) and CMYK. libjpeg-turbo
    converts no colour space in lossless mode, so cv2 refuses grey read
    as colour and RGB read as grey: the port raises UnreadableImage."""
    rng = np.random.default_rng(predictor)
    for precision, pt, rows, n, kw in ((8, 0, 0, 1, {}), (8, 2, 4, 3, {}),
                                       (5, 1, 0, 3, {"adobe": 0}),
                                       (8, 0, 5, 4, {"adobe": 0})):
        planes = rng.integers(0, 1 << precision, (n, 13, 17))
        blob = tw.lossless_jpeg(planes, precision, predictor, pt, rows, **kw)
        read = _like_cv2(tmp_path, blob, f"ll{precision}{n}")
        assert read == {1: ["unchanged", "grey"], 3: ["unchanged", "color"],
                        4: list(MODES)}[n]


# ---------------------------------------------------------------------------
# JPEG: four components, RGB
# ---------------------------------------------------------------------------

def _cmyk_grid():
    vals = np.array([0, 1, 64, 127, 128, 200, 254, 255], np.uint8)
    g = np.stack(np.meshgrid(vals, vals, vals, vals, indexing="ij"), -1)
    return g.reshape(64, 64, 4)


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("subsampling", [0, 2])
def test_cmyk_and_ycck_jpeg_match_cv2(tmp_path, subsampling, progressive):
    """PIL's Adobe CMYK over a grid of (c, m, y, k) (OpenCV's own CMYK →
    BGR step), and the same bytes as YCCK (Adobe transform 2)."""
    bio = io.BytesIO()
    Image.fromarray(_cmyk_grid(), "CMYK").save(
        bio, "JPEG", quality=100, subsampling=subsampling,
        progressive=progressive)
    blob = bio.getvalue()
    at = blob.index(b"Adobe")
    assert blob[at + 11] == 0
    assert len(_like_cv2(tmp_path, blob, "cmyk")) == 3
    ycck = blob[:at + 11] + b"\x02" + blob[at + 12:]
    assert len(_like_cv2(tmp_path, ycck, "ycck")) == 3


def test_rgb_jpegs_match_cv2(tmp_path):
    """Adobe transform 0, and component ids 'R', 'G', 'B' with no marker:
    no colour conversion; libjpeg's own grey."""
    img = _smooth(np.random.default_rng(9), (H, W, 3))
    blob = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                      0x221111])[1].tobytes()
    n, = struct.unpack(">H", blob[4:6])
    rest = blob[4 + n:]                                  # JFIF dropped
    adobe = tw._segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    assert len(_like_cv2(tmp_path, blob[:2] + adobe + rest, "adobe")) == 3
    ids = bytearray(blob[:2] + rest)
    sof, sos = ids.index(b"\xff\xc0"), ids.index(b"\xff\xda")
    for i, c in enumerate(b"RGB"):
        ids[sof + 10 + 3 * i] = c
        ids[sos + 5 + 2 * i] = c
    assert len(_like_cv2(tmp_path, bytes(ids), "ids")) == 3


# ---------------------------------------------------------------------------
# JPEG: what cv2 cannot read either
# ---------------------------------------------------------------------------

def _unreadable_jpegs():
    img = _smooth(np.random.default_rng(2), (9, 10, 3))
    blob = cv2.imencode(".jpg", img)[1].tobytes()
    sof = blob.index(b"\xff\xc0")
    out = {"12-bit": blob[:sof + 4] + b"\x0c" + blob[sof + 5:]}
    for m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
        out[f"hierarchical_{m:x}"] = blob[:sof + 1] + bytes([m]) \
            + blob[sof + 2:]
    planes = np.random.default_rng(3).integers(0, 4096, (1, 6, 7))
    for p in (9, 12, 16):
        out[f"lossless_{p}bit"] = tw.lossless_jpeg(planes % (1 << p), p, 1)
    ll = tw.lossless_jpeg(planes[:, :, :] % 256, 8, 1)
    out["lossless_arithmetic"] = ll.replace(b"\xff\xc3", b"\xff\xcb", 1)
    out["lossless_ycc"] = tw.lossless_jpeg(
        np.repeat(planes % 256, 3, 0), 8, 1, jfif=True)
    prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE,
                                      1])[1].tobytes()
    sos = prog.index(b"\xff\xda")
    body = 2 + 2 + 1 + 2 * prog[sos + 4]          # Ss after the comps
    out["bad_progression"] = prog[:sos + body] + b"\x00\x05" \
        + prog[sos + body + 2:]                    # a DC scan to Se = 5
    out["empty"] = b""
    out["unknown_format"] = b"\x00\x01garbage" * 4
    out["truncated_header"] = blob[:sof + 6]
    return out


@pytest.mark.parametrize("case", sorted(_unreadable_jpegs()))
def test_jpegs_cv2_cannot_read_are_unreadable(tmp_path, case):
    _unreadable(tmp_path, _unreadable_jpegs()[case], case)


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------

def _tags(h, w, bits, spp, photo, fmt=1, extra=None):
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
         259: (3, [1]), 262: (3, [photo]), 277: (3, [spp]), 278: (4, [h]),
         284: (3, [1]), 339: (3, [fmt] * spp)}
    t.update(extra or {})
    return t


def _rgb_or_grey(rng, dtype, spp, h=H, w=W):
    top = {np.uint8: 255, np.uint16: 65535}.get(dtype)
    x = rng.random((h, w, spp))
    return (x * top).astype(dtype) if top else x.astype(dtype)


TILED = [(dt, spp, comp) for dt in (np.uint8, np.uint16, np.float32)
         for spp in (1, 3, 4) for comp in (1, 5, 8)]


@pytest.mark.parametrize("dt,spp,comp", TILED,
                         ids=[f"{np.dtype(d).name}-{s}-{c}"
                              for d, s, c in TILED])
def test_tiled_tiff_matches_cv2(tmp_path, dt, spp, comp):
    """16x16 tiles with padded edge tiles, none / LZW / Deflate (LZW and
    Deflate with horizontal differencing for integers)."""
    rng = np.random.default_rng(spp * 10 + comp)
    img = _rgb_or_grey(rng, dt, spp)
    bits = np.dtype(dt).itemsize * 8
    fmt = 3 if dt == np.float32 else 1
    extra = {322: (3, [16]), 323: (3, [16]), 259: (3, [comp])}
    if spp == 4:
        extra[338] = (3, [2])
    pred = 2 if comp != 1 and fmt == 1 else 1
    if pred == 2:
        extra[317] = (3, [2])
    tags = _tags(H, W, bits, spp, 1 if spp == 1 else 2, fmt, extra)
    del tags[278]
    chunks = []
    for t in tw.tiles(img, 16, 16):
        raw = t
        if pred == 2:
            u = t.view(f"u{t.dtype.itemsize}").astype(np.int64)
            u[:, 1:] -= t.view(f"u{t.dtype.itemsize}")[:, :-1]
            raw = (u % (1 << bits)).astype(t.dtype.newbyteorder("<"))
        b = np.ascontiguousarray(raw).tobytes()
        chunks.append(b if comp == 1 else _compress(b, comp))
    blob = tw.tiff_file(tags, chunks, tiled=True)
    if dt == np.uint16 and spp == 1:
        # cv2 misreads all but the first row of each partial edge tile of
        # a 16-bit grey file in 8-bit colour or grey: the port refuses that
        path = tmp_path / "f.tif"
        path.write_bytes(blob)
        high = (img[..., 0] >> 8).astype(np.uint8)
        assert (_cv2(path, "color")[1:16, 48:, 0] != high[1:16, 48:]).any()
        np.testing.assert_array_equal(_cv2(path, "color")[:, :48, 0],
                                      high[:, :48])
        for mode in ("color", "grey"):
            with pytest.raises(UnsupportedImage, match="partial edge"):
                image_io.read_image(path, mode)
        np.testing.assert_array_equal(image_io.read_image(path),
                                      _cv2(path, "unchanged"))
    else:
        read = _like_cv2(tmp_path, blob, suffix=".tif")
        assert read == (["unchanged"] if fmt == 3 else list(MODES))
    if not (dt == np.uint8 and spp == 4):     # not premultiplied
        np.testing.assert_array_equal(
            image_io.read_raw(tmp_path / "f.tif").reshape(H, W, spp), img)


def _compress(b, comp):
    return zlib.compress(b) if comp == 8 else native.lzw_encode(b)


@pytest.mark.parametrize("spp,rps", [(1, 37), (3, 37), (3, 8), (4, 5)])
def test_planar_separate_tiff_matches_cv2(tmp_path, spp, rps):
    """PlanarConfiguration 2 at 8 bits (libtiff's RGBA interface), and a
    one-sample 16-bit file."""
    rng = np.random.default_rng(spp + rps)
    img = _rgb_or_grey(rng, np.uint8, spp)
    extra = {284: (3, [2]), 278: (4, [rps])}
    if spp == 4:
        extra[338] = (3, [2])
    chunks = [img[y:y + rps, :, c].tobytes() for c in range(spp)
              for y in range(0, H, rps)]
    blob = tw.tiff_file(_tags(H, W, 8, spp, 1 if spp == 1 else 2,
                              extra=extra), chunks)
    assert len(_like_cv2(tmp_path, blob, suffix=".tif")) == 3
    g16 = _rgb_or_grey(rng, np.uint16, 1)
    blob = tw.tiff_file(_tags(H, W, 16, 1, 1, extra={284: (3, [2])}),
                        [g16.tobytes()])
    assert len(_like_cv2(tmp_path, blob, "g16", ".tif")) == 3


@pytest.mark.parametrize("kind", ["grey", "rgb", "pil_ycbcr"])
def test_jpeg_compressed_tiff_matches_cv2(tmp_path, kind):
    """Compression 7 with JPEGTables: cv2's files (photometric RGB or
    MinIsBlack, no colour conversion) and PIL's (YCbCr, libjpeg's
    conversion)."""
    rng = np.random.default_rng(11)
    path = tmp_path / "j.tif"
    if kind == "pil_ycbcr":
        Image.fromarray(_smooth(rng, (H, W, 3))).save(
            path, compression="jpeg")
    else:
        img = _smooth(rng, (H, W) if kind == "grey" else (H, W, 3))
        cv2.imwrite(str(path), img, [cv2.IMWRITE_TIFF_COMPRESSION, 7])
    assert len(_like_cv2(tmp_path, path.read_bytes(), "j", ".tif")) == 3


def _palette(bits):
    n = 1 << bits
    return ([(i * 4111) % 65536 for i in range(n)]
            + [(i * 7919) % 65536 for i in range(n)]
            + [(i * 257) % 65536 for i in range(n)])


@pytest.mark.parametrize("case", ["bw1", "miniswhite1", "miniswhite8",
                                  "palette1", "palette4", "palette8",
                                  "palette8_small", "grey_alpha8",
                                  "grey_alpha16", "pil_1", "pil_P"])
def test_low_bit_grey_and_palette_tiff_match_cv2(tmp_path, case):
    rng = np.random.default_rng(len(case))
    if case.startswith("pil"):
        img = Image.fromarray(_smooth(rng, (H, W))).convert(case[-1])
        img.save(tmp_path / "p.tif")
        blob = (tmp_path / "p.tif").read_bytes()
    elif case.endswith("1") and case != "palette1":
        v = rng.integers(0, 2, (H, W))
        blob = tw.tiff_file(_tags(H, W, 1, 1, int(case == "bw1")),
                            [tw.pack_bits(v, 1)])
    elif case == "miniswhite8":
        blob = tw.tiff_file(_tags(H, W, 8, 1, 0),
                            [_smooth(rng, (H, W)).tobytes()])
    elif case.startswith("palette"):
        bits = int(case[7])
        cmap = _palette(bits)
        if case.endswith("small"):
            cmap = [c % 256 for c in cmap]
        v = rng.integers(0, 1 << bits, (H, W))
        data = tw.pack_bits(v, bits) if bits < 8 else \
            v.astype(np.uint8).tobytes()
        blob = tw.tiff_file(_tags(H, W, bits, 1, 3,
                                  extra={320: (3, cmap)}), [data])
    else:
        dt = np.uint8 if case.endswith("8") else np.uint16
        img = _rgb_or_grey(rng, dt, 2)
        blob = tw.tiff_file(_tags(H, W, 8 * img.itemsize, 2, 1,
                                  extra={338: (3, [2])}), [img.tobytes()])
    assert len(_like_cv2(tmp_path, blob, suffix=".tif")) == 3


YCBCR = {"11": {530: (3, [1, 1])}, "22": {}, "21": {530: (3, [2, 1])},
         "refbw": {530: (3, [1, 1]), 532: (5, [16, 1, 235, 1, 128, 1, 240,
                                                1, 128, 1, 240, 1])},
         "luma709": {530: (3, [1, 1]), 529: (5, [2126, 10000, 7152, 10000,
                                                  722, 10000])}}


@pytest.mark.parametrize("case", list(YCBCR))
def test_ycbcr_tiff_matches_cv2(tmp_path, case):
    """Uncompressed YCbCr (libtiff's TIFFYCbCrToRGB): subsampled blocks
    (default 2x2), ReferenceBlackWhite and YCbCrCoefficients."""
    sh, sv = YCBCR[case].get(530, (3, [2, 2]))[1]
    rng = np.random.default_rng(len(case))
    bw, bh = -(-W // sh), -(-H // sv)
    units = rng.integers(0, 256, (bh, bw, sh * sv + 2)).astype(np.uint8)
    blob = tw.tiff_file(_tags(H, W, 8, 3, 6, extra=YCBCR[case]),
                        [units.tobytes()])
    assert len(_like_cv2(tmp_path, blob, suffix=".tif")) == 3


@pytest.mark.parametrize("case", ["cmyk", "pil_cmyk", "int8", "int16",
                                  "int16_rgb", "int32", "uint32",
                                  "float64", "float64_rgb"])
def test_cmyk_signed_and_wide_tiff_match_cv2(tmp_path, case):
    """CMYK (libtiff's (255 - k)·(255 - v) / 255; 4 channels with alpha
    255 under IMREAD_UNCHANGED); signed and 32/64-bit samples, which cv2
    returns as they are and which the JAX loaders then refuse."""
    rng = np.random.default_rng(len(case))
    if case == "pil_cmyk":
        Image.fromarray(_cmyk_grid()[:H, :W].copy(), "CMYK").save(
            tmp_path / "c.tif")
        blob = (tmp_path / "c.tif").read_bytes()
    elif case == "cmyk":
        img = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
        blob = tw.tiff_file(_tags(H, W, 8, 4, 5), [img.tobytes()])
    else:
        dt = np.dtype(case.split("_")[0])
        spp = 3 if case.endswith("rgb") else 1
        x = rng.normal(0, 1, (H, W, spp))
        if dt.kind != "f":
            info = np.iinfo(dt)
            x = np.clip((np.abs(x) if dt.kind == "u" else x) * info.max / 3,
                        info.min, info.max)
        img = x.astype(dt)
        fmt = {"i": 2, "u": 1, "f": 3}[dt.kind]
        blob = tw.tiff_file(_tags(H, W, dt.itemsize * 8, spp,
                                  1 if spp == 1 else 2, fmt),
                            [img.tobytes()])
        path = tmp_path / "f.tif"
        _like_cv2(tmp_path, blob, suffix=".tif")
        np.testing.assert_array_equal(image_io.read_raw(path),
                                      img[..., 0] if spp == 1 else img)
        with pytest.raises(ValueError, match="Unsupported dtype"):
            image_io.load_image(path)
        return
    assert len(_like_cv2(tmp_path, blob, suffix=".tif")) == 3


@pytest.mark.parametrize("orientation", range(2, 9))
def test_tiff_orientations_match_cv2(tmp_path, orientation):
    """Every orientation in every mode, as EXIF orientations apply; 5-8
    (a transpose) only on square images, the others cv2 cannot read."""
    rng = np.random.default_rng(orientation)
    for dt, spp in ((np.uint8, 3), (np.uint16, 1), (np.float32, 3),
                    (np.uint8, 1)):
        for h, w in ((H, W), (W, W)):
            img = _rgb_or_grey(rng, dt, spp, h, w)
            fmt = 3 if dt == np.float32 else 1
            blob = tw.tiff_file(_tags(h, w, img.itemsize * 8, spp,
                                      1 if spp == 1 else 2, fmt,
                                      {274: (3, [orientation])}),
                                [img.tobytes()])
            read = _like_cv2(tmp_path, blob, f"{np.dtype(dt).name}{h}",
                             ".tif")
            assert bool(read) == (orientation < 5 or h == w)


def test_bigtiff_matches_cv2(tmp_path):
    rng = np.random.default_rng(12)
    for mode, shape in (("RGB", (H, W, 3)), ("L", (H, W)), ("P", (H, W))):
        img = Image.fromarray(_smooth(rng, shape))
        if mode == "P":
            img = img.convert("P")
        img.save(tmp_path / "b.tif", big_tiff=True)
        blob = (tmp_path / "b.tif").read_bytes()
        assert blob[2:4] == b"+\x00"
        assert len(_like_cv2(tmp_path, blob, mode, ".tif")) == 3
    img = _rgb_or_grey(rng, np.uint16, 3)
    blob = tw.tiff_file(_tags(H, W, 16, 3, 2), [img.tobytes()], order=">",
                        big=True)
    assert len(_like_cv2(tmp_path, blob, "mm", ".tif")) == 3


def _unreadable_tiffs():
    rng = np.random.default_rng(13)
    g = rng.integers(0, 4, (5, 6))
    out = {"grey2": tw.tiff_file(_tags(5, 6, 2, 1, 1),
                                 [tw.pack_bits(g, 2)]),
           "grey4": tw.tiff_file(_tags(5, 6, 4, 1, 1),
                                 [tw.pack_bits(g, 4)]),
           "palette2": tw.tiff_file(_tags(5, 6, 2, 1, 3, extra={
               320: (3, _palette(2))}), [tw.pack_bits(g, 2)])}
    img = rng.integers(0, 256, (5, 6, 3)).astype(np.uint8)
    for o in (5, 6, 7, 8):                  # of a non-square image
        out[f"orientation{o}"] = tw.tiff_file(
            _tags(5, 6, 8, 3, 2, extra={274: (3, [o])}), [img.tobytes()])
    out["cmyk16"] = tw.tiff_file(_tags(5, 6, 16, 4, 5),
                                 [bytes(5 * 6 * 8)])
    out["cmyk_alpha"] = tw.tiff_file(_tags(5, 6, 8, 5, 5,
                                           extra={338: (3, [2])}),
                                     [bytes(5 * 6 * 5)])
    out["float16"] = tw.tiff_file(_tags(5, 6, 16, 1, 1, 3),
                                  [bytes(5 * 6 * 2)])
    out["not_tiff"] = b"II*\x00" + bytes(4)
    return out


@pytest.mark.parametrize("case", sorted(_unreadable_tiffs()))
def test_tiffs_cv2_cannot_read_are_unreadable(tmp_path, case):
    _unreadable(tmp_path, _unreadable_tiffs()[case], case, ".tif")


@pytest.mark.parametrize("dt", [np.int32, np.float64, np.float32])
def test_wide_tiff_as_colour_is_unreadable(tmp_path, dt):
    """cv2 returns None for 32- and 64-bit samples in IMREAD_COLOR and
    _GRAYSCALE: so does the port, with the same first class."""
    img = np.ones((5, 6), dt)
    fmt = 2 if dt == np.int32 else 3
    blob = tw.tiff_file(_tags(5, 6, img.itemsize * 8, 1, 1, fmt),
                        [img.tobytes()])
    assert _like_cv2(tmp_path, blob, suffix=".tif") == ["unchanged"]


# ---------------------------------------------------------------------------
# the committed fixtures
# ---------------------------------------------------------------------------

def _fixture_expectations():
    with np.load(FIXTURES / "expected.npz") as z:
        return {k: z[k] for k in z.files}


def test_fixtures_decode_to_expected():
    """Every fixture decodes to cv2's array in `expected.npz` in each
    mode cv2 reads, and raises UnreadableImage where cv2 returned None
    (recorded as an empty array)."""
    expected = _fixture_expectations()
    files = sorted(p for p in FIXTURES.iterdir()
                   if p.suffix in (".jpg", ".tif"))
    assert len(files) >= 20
    assert sum(p.stat().st_size for p in files) <= 2 << 20
    for path in files:
        assert path.stat().st_size <= 64 << 10, path.name
        for mode in MODES:
            want = expected[f"{path.name}:{mode}"]
            if want.size == 0:
                with pytest.raises(UnreadableImage):
                    image_io.read_image(path, mode)
                continue
            got = image_io.read_image(path, mode)
            assert got.dtype == want.dtype, (path.name, mode)
            np.testing.assert_array_equal(got, want, err_msg=path.name)


def test_expected_npz_is_cv2s_decode():
    """`expected.npz` is what the installed cv2 gives for each fixture."""
    expected = _fixture_expectations()
    for key, want in expected.items():
        name, mode = key.split(":")
        got = _cv2(FIXTURES / name, mode)
        if want.size == 0:
            assert got is None, key
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


def test_decode_jpeg_takes_bytes():
    blob = _cv2_progressive(np.random.default_rng(1), "420")
    got = jpeg.decode_jpeg(blob, "<bytes>", "color")
    want = cv2.imdecode(np.frombuffer(blob, np.uint8),
                        cv2.IMREAD_COLOR)[..., ::-1]
    np.testing.assert_array_equal(got, want)
