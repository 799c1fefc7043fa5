"""The port's WebP, GIF and JPEG 2000 writers against the files that
cv2.imwrite writes (OpenCV 5.0: libwebp's lossless encoder, OpenCV's own
GIF encoder, OpenJPEG 2.5.3).

Each case writes one array with cv2.imwrite and with the port's
`write_raw`, and reads both files with cv2.imread in its three modes
(IMREAD_UNCHANGED, _COLOR, _GRAYSCALE): shape, dtype and every sample
agree, and the port's `read_image` agrees with cv2 on the port's file.
The GIF and JPEG 2000 files are equal byte for byte too, including JPEG
2000 files whose rate cap drops coding passes. A WebP's bytes are the
port's own (a simple VP8L stream), its pixels libwebp's, the colour under
alpha 0 included: libwebp's lossless encoder leaves there what its
predictor guessed, and the port's analysis (`native.vp8l_analyze`) makes
the same choices, which the analysis cases pin against the transforms
and the modes per tile that cv2's own files record. Where cv2 fails or
raises, `write_raw` raises ValueError and writes nothing. Sizes of 1 to
89 pixels a side keep the file fast.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import rnb_neus2_tpu.io.image_io as jimage_io
from rnb_neus2_torch import api
from rnb_neus2_torch.io import image_io, native

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "torch_fixtures" / "writers"
sys.path.insert(0, str(FIXTURES))
import make_fixtures  # noqa: E402

MODES = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "grey": cv2.IMREAD_GRAYSCALE}
EXTS = (".webp", ".gif", ".jp2")
KINDS = {"grey8": (1, np.uint8), "rgb8": (3, np.uint8),
         "rgba8": (4, np.uint8), "rgb16": (3, np.uint16),
         "rgba16": (4, np.uint16)}


def _bgr(img):
    if img.ndim == 2 or img.shape[2] not in (3, 4):
        return img
    return np.ascontiguousarray(img[..., [2, 1, 0, 3][:img.shape[2]]])


def _cv2_read(path, mode):
    """cv2.imread in RGB(A) order."""
    img = cv2.imread(str(path), MODES[mode])
    assert img is not None, (path, mode)
    return _bgr(img)


def _cv2_write(path, img) -> bool:
    """cv2.imwrite of an RGB(A) array; False where it fails or raises."""
    try:
        return cv2.imwrite(str(path), _bgr(img))
    except cv2.error:
        return False


def _image(kind, h, w, seed):
    """A smooth field with noise on it; an alpha channel of 0s (about a
    fifth), 255s and values between."""
    ch, dtype = KINDS[kind]
    top = np.iinfo(dtype).max
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([(x * 7 + y * 3 + 40 * c) % 256 for c in range(ch)], -1)
    img = base * (top / 255.0) + rng.normal(0, 6 * top / 255.0, (h, w, ch))
    img = np.clip(img, 0, top).astype(dtype)
    if ch == 4:
        a = rng.random((h, w))
        img[..., 3] = np.where(a < 0.2, 0, np.where(a < 0.6, top, img[..., 3]))
    return img[..., 0] if ch == 1 else img


def _assert_reads_as_cv2s(port_file, cv2_file, ext, img):
    """cv2.imread of the port's file equals cv2.imread of cv2's in the
    three modes, every pixel (a WebP's under alpha 0 too), and the port's
    reader agrees with cv2 on the port's file."""
    for mode in MODES:
        got, want = _cv2_read(port_file, mode), _cv2_read(cv2_file, mode)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), mode
        np.testing.assert_array_equal(got, want, err_msg=mode)
        mine = image_io.read_image(port_file, mode)
        assert (mine.dtype, mine.shape) == (got.dtype, got.shape), mode
        np.testing.assert_array_equal(mine, got, err_msg=mode)


def _size(case, seed):
    """Case 0 under 32 pixels a side (OpenJPEG refuses it at cv2's 5
    levels), the others from 32 to 89."""
    rng = np.random.default_rng(seed)
    lo, hi = (1, 32) if case == 0 else (32, 90)
    return tuple(int(v) for v in rng.integers(lo, hi, 2))


@pytest.mark.parametrize("case", [0, 1, 2])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("ext", EXTS)
def test_writer_matches_cv2(tmp_path, ext, kind, case):
    seed = 1000 * EXTS.index(ext) + 10 * list(KINDS).index(kind) + case
    h, w = _size(case, seed)
    if ext == ".jp2" and case == 0 and kind in ("rgb8", "rgba16"):
        h, w = (h, 40) if seed % 2 else (40, w)   # one side long enough
    img = _image(kind, h, w, seed)
    cv2_file, port_file = tmp_path / f"cv2{ext}", tmp_path / f"port{ext}"
    if not _cv2_write(cv2_file, img):
        with pytest.raises(ValueError):
            image_io.write_raw(port_file, img)
        assert not port_file.exists()
        return
    image_io.write_raw(port_file, img)
    _assert_reads_as_cv2s(port_file, cv2_file, ext, img)
    if ext != ".webp":
        assert port_file.read_bytes() == cv2_file.read_bytes()


def _webp_records(data: bytes) -> tuple:
    """The transform set of a VP8L file, as libwebp's analysis names it,
    and its predictor's (tile bits, modes per tile) or None."""
    body = data[data.index(b"VP8L") + 8:]
    bits = int.from_bytes(body[1:5], "little")
    w, h = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    _, tinfo, tdata, n = native.vp8l_decode(body[5:], w, h)
    assert n >= 0
    kinds, pred = [], None
    for kind, tbits, before, off in tinfo[:4 * n].reshape(-1, 4):
        kinds.append(int(kind))
        if kind == 0:
            tw, th = -(-before // (1 << tbits)), -(-h // (1 << tbits))
            pred = (int(tbits), ((tdata[off:off + tw * th] >> 8) & 0xFF)
                    .reshape(th, tw))
    if 3 in kinds:
        return "palette", pred
    if 0 in kinds:
        return ("spatial+subtract-green" if 2 in kinds else "spatial"), pred
    return ("subtract-green" if 2 in kinds else "direct"), pred


SETS = ("direct", "spatial", "subtract-green", "spatial+subtract-green",
        "palette")


def _analysis_image(kind, h, w, seed):
    """noise: independent channels, a quarter of alpha 0; grey / colour:
    a render of a shaded disc on an alpha-0 background (RGB 0 there);
    palette: 200 or 9 colours, a quarter of them at alpha 0."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        img[..., 3] = np.where(img[..., 3] < 64, 0, img[..., 3])
        return img
    if kind.startswith("palette"):
        n = int(kind[7:])
        colours = rng.integers(0, 256, (n, 4), dtype=np.uint8)
        colours[:n // 4, 3] = 0
        return colours[rng.integers(0, n, (h, w))]
    y, x = np.mgrid[:h, :w].astype(np.float32)
    disc = (x - w / 2) ** 2 + (y - h / 2) ** 2 < (0.42 * min(h, w)) ** 2
    v = 90 + 60 * np.cos(x / 11) + 40 * np.sin(y / 9)
    rgb = np.stack([v + c * 3 + (0 if kind == "grey" else
                                 30 * np.sin(x / 5 + c) + rng.normal(0, 2, v.shape))
                    for c in range(3)], -1)
    img = np.concatenate([np.clip(rgb, 0, 255), 255 * disc[..., None]],
                         -1).astype(np.uint8)
    img[~disc, :3] = 0
    return img


@pytest.mark.parametrize("kind,h,w,want", [
    ("noise", 64, 64, "direct"), ("noise", 77, 80, "direct"),
    ("noise", 89, 71, "subtract-green"),
    ("colour", 40, 48, "spatial"), ("colour", 45, 81, "spatial"),
    ("colour", 31, 64, "spatial"),
    ("colour", 160, 128, "spatial+subtract-green"),
    ("colour", 89, 71, "spatial+subtract-green"),
    ("grey", 40, 48, "spatial+subtract-green"),
    ("grey", 33, 17, "spatial+subtract-green"),
    ("palette200", 40, 48, "palette"), ("palette9", 50, 60, "palette"),
    ("colour", 13, 7, "palette"), ("colour", 1, 89, "palette"),
    ("colour", 89, 2, "palette")])
def test_webp_analysis_matches_libwebp(tmp_path, kind, h, w, want):
    """libwebp's lossless analysis at cv2's settings, case by case: the
    transform set cv2's file records, and for a spatial set the mode of
    every tile (cv2's file may merge equal tiles into larger ones), equal
    the port's analysis; then the port's file decodes to cv2's pixels,
    alpha 0 included, in the three modes. Edge tiles are cut at sizes
    that are no multiple of the tile."""
    img = _analysis_image(kind, h, w, h * 100 + w)
    cv2_file, port_file = tmp_path / "cv2.webp", tmp_path / "port.webp"
    assert _cv2_write(cv2_file, img)
    got_set, pred = _webp_records(cv2_file.read_bytes())
    out, info, tiles = native.vp8l_analyze(img)
    assert (SETS[info[0]], got_set) == (want, want)
    if pred is None:
        assert tiles is None
    else:
        bits, modes = pred
        k = bits - int(info[2])
        assert k >= 0
        grid = np.repeat(np.repeat(modes, 1 << k, 0), 1 << k, 1)
        np.testing.assert_array_equal(tiles, grid[:tiles.shape[0],
                                                  :tiles.shape[1]])
    np.testing.assert_array_equal(out, _cv2_read(cv2_file, "unchanged"))
    image_io.write_raw(port_file, img)
    _assert_reads_as_cv2s(port_file, cv2_file, ".webp", img)


@pytest.mark.parametrize("ext", EXTS)
def test_screenshot_like_render(tmp_path, ext):
    """`Testbed.screenshot` of a 256x256 RGBA render with an alpha-0
    background writes what the JAX screenshot (`save_image` at 8 bits
    through cv2.imwrite) writes."""
    y, x = np.mgrid[:256, :256].astype(np.float32)
    disc = (x - 127.5) ** 2 + (y - 120.5) ** 2 < 90.0 ** 2
    frame = np.zeros((256, 256, 4), np.float32)
    frame[..., 0] = 0.3 + 0.5 * x / 255
    frame[..., 1] = 0.2 + 0.6 * y / 255
    frame[..., 2] = 0.6 + 0.3 * np.sin(x / 17)
    frame[..., 3] = disc
    frame[~disc, :3] = 0
    tb = api.Testbed(api.TestbedMode.Nerf, device="cpu")
    tb.render_to_cpu = lambda view_idx=0: frame
    tb.screenshot(str(tmp_path / f"port{ext}"))
    jimage_io.save_image(frame, tmp_path / f"jax{ext}", bit_depth=8)
    eight = (frame * 255).astype(np.uint8)
    _assert_reads_as_cv2s(tmp_path / f"port{ext}", tmp_path / f"jax{ext}",
                          ext, eight)
    if ext != ".webp":
        assert (tmp_path / f"port{ext}").read_bytes() == \
            (tmp_path / f"jax{ext}").read_bytes()


@pytest.mark.parametrize("kind", ["grey8", "rgb8", "rgba8", "rgb16",
                                  "rgba16"])
def test_jp2_rate_cap_truncates(tmp_path, kind):
    """Noise that OpenJPEG's rate cap (a quarter of the raw samples, less
    the headers) truncates: cv2's file is lossy and the port's is the same
    file."""
    ch, dtype = KINDS[kind]
    rng = np.random.default_rng(77 + ch)
    img = rng.integers(0, np.iinfo(dtype).max + 1, (53, 61, ch)) \
        .astype(dtype)
    img = img[..., 0] if ch == 1 else img
    cv2_file, port_file = tmp_path / "cv2.jp2", tmp_path / "port.jp2"
    assert _cv2_write(cv2_file, img)
    assert not np.array_equal(_cv2_read(cv2_file, "unchanged"), img)
    assert cv2_file.stat().st_size < img.nbytes / 4 + 300
    image_io.write_raw(port_file, img)
    assert port_file.read_bytes() == cv2_file.read_bytes()
    _assert_reads_as_cv2s(port_file, cv2_file, ".jp2", img)


@pytest.mark.parametrize("alpha", ["rgb", "opaque", "clear"])
@pytest.mark.parametrize("bit_depth", [8, 16])
@pytest.mark.parametrize("ext", EXTS)
def test_save_image_matches_jax(tmp_path, ext, bit_depth, alpha):
    """The JAX save_image (cv2.imwrite) and the port's write files that
    read back equal (GIF and JPEG 2000: the same bytes) from one float
    image: RGB, RGBA with no alpha 0, RGBA with some."""
    rng = np.random.default_rng(bit_depth + len(alpha))
    y, x = np.mgrid[:48, :56].astype(np.float32)
    img = np.stack([x / 56, y / 48, (x + y) / 104, 0.2 + 0.8 * x / 56], -1)
    img = img + rng.uniform(-0.03, 0.03, img.shape).astype(np.float32)
    img[0, 0, 0] = np.nan
    if alpha == "rgb":
        img = img[..., :3]
    elif alpha == "clear":
        img[..., 3] = np.where(rng.random((48, 56)) < 0.3, 0, img[..., 3])
    jimage_io.save_image(img, tmp_path / f"jax{ext}", bit_depth)
    image_io.save_image(img, tmp_path / f"port{ext}", bit_depth)
    samples = (np.clip(np.nan_to_num(img), 0, 1) * (2 ** bit_depth - 1)) \
        .astype(np.uint8 if bit_depth == 8 else np.uint16)
    _assert_reads_as_cv2s(tmp_path / f"port{ext}", tmp_path / f"jax{ext}",
                          ext, samples)
    if ext != ".webp":
        assert (tmp_path / f"port{ext}").read_bytes() == \
            (tmp_path / f"jax{ext}").read_bytes()


@pytest.mark.parametrize("ext", EXTS)
def test_two_channels_refused_as_cv2_refuses(tmp_path, ext):
    img = np.zeros((40, 40, 2), np.uint8)
    assert not _cv2_write(tmp_path / f"cv2{ext}", img)
    with pytest.raises(ValueError):
        image_io.write_raw(tmp_path / f"port{ext}", img)
    assert not (tmp_path / f"port{ext}").exists()


def test_grey_gif_j2k_and_avif_refused(tmp_path):
    """cv2's GIF encoder fails on grey input and cv2 5 has no `.j2k`
    writer (so the JAX save_image raises); `.avif` is written, grey as a
    monochrome file that cv2 reads as the port's reader does."""
    grey = np.zeros((8, 8), np.uint8)
    assert not _cv2_write(tmp_path / "c.gif", grey)
    with pytest.raises(ValueError, match="3 or 4 channels"):
        image_io.write_raw(tmp_path / "p.gif", grey)
    with pytest.raises(cv2.error):
        jimage_io.save_image(np.zeros((40, 40, 3)), tmp_path / "j.j2k")
    with pytest.raises(ValueError, match="no image writer"):
        image_io.save_image(np.zeros((40, 40, 3)), tmp_path / "p.j2k")
    for name, img in (("p.avif", np.zeros((40, 40, 3), np.uint8)),
                      ("g.avif", grey)):
        image_io.write_raw(tmp_path / name, img)
        for mode in ("unchanged", "color", "grey"):
            np.testing.assert_array_equal(
                image_io.read_image(tmp_path / name, mode),
                _cv2_read(tmp_path / name, mode))
    assert image_io.read_image(tmp_path / "g.avif").shape == (8, 8)


@pytest.mark.parametrize("name", ["input.png", "cv2.webp", "cv2.gif",
                                  "cv2.jp2", "cv2.avif"])
def test_writer_fixtures_have_not_drifted(name):
    """The committed input and cv2's files of it, which phase 13 of
    chip_smoke.py holds the port's writers against on the card's host,
    are what make_fixtures.py and this cv2 write now."""
    rgba = make_fixtures.make_input()
    if name == "input.png":
        np.testing.assert_array_equal(
            image_io.read_image(FIXTURES / name), rgba)
        np.testing.assert_array_equal(_cv2_read(FIXTURES / name,
                                                "unchanged"), rgba)
    else:
        ext = Path(name).suffix
        assert (FIXTURES / name).read_bytes() == \
            make_fixtures.cv2_bytes(rgba, ext)


def test_port_writers_on_the_committed_input():
    """What phase 13 of chip_smoke.py checks on the card's host: the GIF
    and JPEG 2000 encoders write cv2's committed bytes, the WebP cv2's
    pixels wherever alpha is not 0."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    rows = chip_smoke.writer_fixture_checks()
    assert all(r["agree"] for r in rows.values())
    assert rows[".gif"]["same_bytes"] and rows[".jp2"]["same_bytes"]
