"""The port's AVIF writer (`io/avif.py:encode_avif`, `native/av1_enc.cc`)
against cv2.imwrite's `.avif` at its defaults (libavif 1.4 over libaom
3.14, the opencv-python wheel's): the same kind of file (boxes, brands,
properties, sequence header fields, quantizers), a stream libaom decodes
to exactly the encoder's reconstruction, and a reconstruction error no
worse than cv2's own file's within stated margins. cv2's bytes are
libaom's rate-distortion search and are not reproduced.
"""

import ctypes
import functools
import glob
import os
import struct

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
from hypothesis import given, settings, strategies as st  # noqa: E402

import rnb_neus2_tpu.io.image_io as jimage_io  # noqa: E402
from rnb_neus2_torch.io import avif, image_io, native  # noqa: E402
from rnb_neus2_torch.io.errors import ImwriteFailed  # noqa: E402
from rnb_neus2_torch.testing.synthetic import (render_sphere_views,  # noqa: E402
                                               ring_cameras)

from test_torch_image_writers import FIXTURES  # noqa: E402

MODES = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "grey": cv2.IMREAD_GRAYSCALE}
# the quality bounds: per channel, the PSNR of cv2's decode of the port's
# file at most this far below that of cv2's own file (not on PSNR_EXEMPT),
# the max abs error at most this far above, and (on SIZE_CAPPED) at most
# twice cv2's bytes
PSNR_MARGIN_DB = 0.5
MAX_ERR_MARGIN = 8
SIZE_RATIO = 2.0


def _bgr(img):
    return img[..., [2, 1, 0, 3][:img.shape[2]]] if img.ndim == 3 else img


def _cv2_bytes(img) -> bytes:
    ok, buf = cv2.imencode(".avif", np.ascontiguousarray(_bgr(img)))
    assert ok
    return buf.tobytes()


def _cv2_read(path, mode="unchanged"):
    img = cv2.imread(str(path), MODES[mode])
    assert img is not None, path
    return _bgr(img) if img.ndim == 3 else img


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


# ------------------------------------------------------------------ fixtures

def _sphere_maps(w=96, h=80):
    """The synthetic sphere's normal and albedo maps as
    `save_image(..., bit_depth=8)` takes [0, 1] floats to 8 bits."""
    cams = ring_cameras(1, 1.5, w, h, 90.0)
    normals, albedo, alphas = render_sphere_views(cams, radius=0.25)
    unit = np.clip((normals[0] * np.array([1.0, -1.0, -1.0]) + 1) / 2, 0, 1)
    to8 = lambda a: (np.clip(a, 0, 1) * 255.0).astype(np.uint8)  # noqa: E731
    return to8(unit), to8(np.asarray(albedo[0])[..., :3])


def _fixture(name: str) -> np.ndarray:
    rgba = image_io.read_image(FIXTURES / "input.png")
    rng = np.random.default_rng(24)
    if name == "input_rgba":
        return rgba
    if name == "input_rgb":
        return rgba[..., :3].copy()
    if name == "input_grey":
        return np.ascontiguousarray(rgba[..., 1])
    if name == "gradient":
        y, x = np.mgrid[:64, :96]
        return np.stack([x * 2 + 40, y * 3 + 20, 200 - x - y], -1).clip(0, 255).astype(np.uint8)
    if name == "sphere_normal":
        return _sphere_maps()[0]
    if name == "sphere_albedo":
        return _sphere_maps()[1]
    if name == "noise":
        return rng.integers(0, 256, (96, 64, 3)).astype(np.uint8)
    if name in ("1x1", "2x2", "33x17"):
        w, h = map(int, name.split("x"))
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    if name == "612x512":
        import sys
        sys.path.insert(0, str(FIXTURES.parents[2]))
        import chip_smoke
        return chip_smoke.codec_view()[1]
    if name == "alpha_255":
        out = rgba.copy()
        out[..., 3] = 255
        return out
    if name == "alpha_0":
        out = rgba.copy()
        out[..., 3] = 0
        return out
    if name == "alpha_mixed":
        out = rgba.copy()
        out[..., 3] = rng.integers(0, 256, out.shape[:2])
        return out
    raise KeyError(name)


FIXTURE_NAMES = ("input_rgba", "input_rgb", "input_grey", "gradient",
                 "sphere_normal", "sphere_albedo", "noise", "1x1", "2x2",
                 "33x17", "612x512", "alpha_255", "alpha_0", "alpha_mixed")
SIZE_CAPPED = ("input_rgba", "input_rgb", "input_grey", "gradient",
               "sphere_normal", "sphere_albedo")
# one or four random pixels: their error is 4:2:0's conversion of a single
# chroma sample, where cv2's lossy file lands nearer the input or further
# by chance (even the best YUV of the input's neighbourhood beats it on
# every channel in only 61 of 100 random 1x1 inputs, 18 of 100 2x2 ones)
PSNR_EXEMPT = ("1x1", "2x2")


@functools.lru_cache(maxsize=None)
def _encoded(name: str):
    """(input, the port's file, its reconstruction as read, cv2's file)."""
    img = _fixture(name)
    data, recon, arecon = avif.encode_avif_recon(img)
    return img, data, avif.reconstructed(recon, arecon), _cv2_bytes(img)


# ------------------------------------------------------------------ boxes

def _boxes(d: bytes, s: int, e: int, out: list) -> list:
    """(type, payload) of every box in file order, descending into the
    containers (meta, iinf and iref as full boxes)."""
    while s < e:
        size, kind = struct.unpack(">I4s", d[s:s + 8])
        body = d[s + 8:s + size]
        out.append((kind, body))
        skip = {b"meta": 4, b"iinf": 6, b"iref": 4, b"iprp": 0, b"ipco": 0}.get(kind)
        if skip is not None:
            _boxes(d, s + 8 + skip, s + size, out)
        s += size
    return out


def _signalling(d: bytes) -> dict:
    """What the port's file must share with cv2's: the box types in
    order, ftyp, the item properties and associations, and per AV1 item
    the sequence header's fields and base_q_idx."""
    boxes = _boxes(d, 0, len(d), [])
    out = {"order": [k for k, _ in boxes]}
    for kind in (b"ftyp", b"ipma", b"auxC", b"iref", b"iinf", b"hdlr", b"pitm"):
        out[kind] = [b for k, b in boxes if k == kind]
    for kind in (b"ispe", b"pixi", b"av1C", b"colr"):
        out[kind] = [b for k, b in boxes if k == kind]
    c = avif.parse(d, "x.avif")
    items = c.items.values() if isinstance(c.items, dict) else c.items
    keys = ("profile", "still", "reduced", "level", "tier", "bit_depth", "mono",
            "ssx", "ssy", "csp", "cp", "tc", "mc", "full_range", "width",
            "height", "base_q_idx")
    out["items"] = []
    for it in items:
        code, info, _, _ = native.av1_decode(avif.item_data(c, it, d, "x.avif"))
        assert code == 0
        out["items"].append({k: info[k] for k in keys})
    return out


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_signalling_is_cv2s(name):
    """Box types and order, brands, ispe, pixi, av1C, colr (nclx 1 / 13 /
    6 full range, or 2 / 2 / 2 for grey), auxC, ipma, the alpha item's
    presence (none for alpha all 255), the sequence header fields and
    base_q_idx of the colour and the alpha item: all as cv2's file of the
    same input."""
    img, ours, _, theirs = _encoded(name)
    a, b = _signalling(ours), _signalling(theirs)
    assert a == b
    assert [i["base_q_idx"] for i in a["items"]] == \
        [avif.COLOUR_QINDEX, avif.ALPHA_QINDEX][:len(a["items"])]
    has_alpha = img.ndim == 3 and img.shape[2] == 4 and (img[..., 3] < 255).any()
    assert len(a["items"]) == 1 + has_alpha


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_libaom_decodes_the_reconstruction(tmp_path, name):
    """cv2.imread (libavif over libaom) reads the port's file as exactly
    the encoder's reconstruction through libavif's YUV to RGB, in each of
    its modes, and so does the port's reader."""
    img, ours, want, _ = _encoded(name)
    path = tmp_path / "port.avif"
    path.write_bytes(ours)
    np.testing.assert_array_equal(_cv2_read(path), want)
    for mode in MODES:
        np.testing.assert_array_equal(image_io.read_image(path, mode),
                                      _cv2_read(path, mode))


@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_quality_no_worse_than_cv2s(tmp_path, name):
    """Per channel, cv2's decode of the port's file against the input:
    PSNR at most PSNR_MARGIN_DB under cv2's own file's (but on
    PSNR_EXEMPT), max abs error at most MAX_ERR_MARGIN over; at most
    SIZE_RATIO times cv2's bytes on SIZE_CAPPED."""
    img, ours, _, theirs = _encoded(name)
    (tmp_path / "p.avif").write_bytes(ours)
    (tmp_path / "c.avif").write_bytes(theirs)
    got, ref = _cv2_read(tmp_path / "p.avif"), _cv2_read(tmp_path / "c.avif")
    if name == "alpha_255":     # neither file has alpha
        img = img[..., :3]
    assert got.shape == ref.shape == img.shape
    chans = [(img, got, ref)] if img.ndim == 2 else \
        [(img[..., k], got[..., k], ref[..., k]) for k in range(img.shape[2])]
    for x, a, b in chans:
        if name not in PSNR_EXEMPT:
            assert _psnr(x, a) >= _psnr(x, b) - PSNR_MARGIN_DB
        err = np.abs(x.astype(int) - a).max()
        assert err <= np.abs(x.astype(int) - b).max() + MAX_ERR_MARGIN
    if name in SIZE_CAPPED:
        assert len(ours) <= SIZE_RATIO * len(theirs)


@pytest.mark.parametrize("size", [(384, 384), (385, 384), (2049, 16), (16, 1153)])
def test_level_follows_the_size_as_libaoms(size):
    """seq_level_idx is libaom's for the picture size (its
    set_bitstream_level_tier at 30 frames a second): 2.0 up to 147456
    samples and 2048x1152, 2.1 past either."""
    w, h = size
    img = np.full((h, w, 3), 90, np.uint8)
    a, b = _signalling(avif.encode_avif(img)), _signalling(_cv2_bytes(img))
    assert a["items"][0]["level"] == b["items"][0]["level"]
    assert a[b"av1C"] == b[b"av1C"]


def _content(kind: str, h: int, w: int, rng) -> np.ndarray:
    y, x = np.mgrid[:h, :w]
    if kind == "noise":
        return rng.integers(0, 256, (h, w))
    if kind == "gradient":
        return (x * rng.integers(1, 5) + y * rng.integers(1, 5) + rng.integers(0, 60)) % 256
    if kind == "flat":
        return np.full((h, w), rng.integers(0, 256))
    return np.where((x // rng.integers(2, 9) + y // rng.integers(2, 9)) % 2, 235, 15)


@settings(max_examples=30, deadline=None, database=None)
@given(w=st.integers(1, 130), h=st.integers(1, 130),
       kind=st.sampled_from(["noise", "gradient", "flat", "edge"]),
       channels=st.sampled_from([1, 3, 4]), seed=st.integers(0, 2 ** 32 - 1))
def test_libaom_decodes_every_draw_exactly(tmp_path_factory, w, h, kind,
                                           channels, seed):
    """Any size from 1 to 130 a side, noise, gradient, flat or edge
    content, grey, RGB or RGBA: libaom's decode (cv2.imread) and the port's
    reader give exactly the encoder's reconstruction."""
    rng = np.random.default_rng(seed)
    img = np.stack([_content(kind, h, w, rng) for _ in range(channels)], -1)
    img = img[..., 0] if channels == 1 else img
    data, recon, arecon = avif.encode_avif_recon(img.astype(np.uint8))
    path = tmp_path_factory.mktemp("draw") / "d.avif"
    path.write_bytes(data)
    want = avif.reconstructed(recon, arecon)
    np.testing.assert_array_equal(_cv2_read(path), want)
    np.testing.assert_array_equal(image_io.read_image(path), want)


# ------------------------------------------------------------------ colour

def _libavif():
    libdir = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)),
                          "opencv_python.libs")
    found = glob.glob(os.path.join(libdir, "libavif-*.so*"))
    if not found:
        pytest.skip("the opencv-python wheel's libavif is not here")
    lib = ctypes.CDLL(found[0])
    lib.avifImageCreate.restype = ctypes.c_void_p
    lib.avifImageCreate.argtypes = [ctypes.c_uint32] * 3 + [ctypes.c_int]
    lib.avifRGBImageSetDefaults.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.avifImageRGBToYUV.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.avifImageRGBToYUV.restype = ctypes.c_int
    lib.avifImageDestroy.argtypes = [ctypes.c_void_p]
    return lib


def _libavif_yuv(lib, rgb):
    """libavif 1.4's avifImageRGBToYUV of BGR(A) pixels as cv2's encoder
    sets it up: 4:2:0, 8 bits, BT.709 / sRGB / BT.601, full range, default
    avifRGBImage (field offsets of its 1.x structs)."""
    h, w, c = rgb.shape
    bgr = np.ascontiguousarray(_bgr(rgb))
    img = lib.avifImageCreate(w, h, 8, 3)          # AVIF_PIXEL_FORMAT_YUV420
    try:
        ctypes.c_uint32.from_address(img + 16).value = 1              # yuvRange: full
        for off, v in ((104, 1), (106, 13), (108, 6)):                # CICP
            ctypes.c_uint16.from_address(img + off).value = v
        rgbimg = ctypes.create_string_buffer(64)
        lib.avifRGBImageSetDefaults(rgbimg, img)
        base = ctypes.addressof(rgbimg)
        ctypes.c_uint32.from_address(base + 12).value = 3 if c == 3 else 4   # BGR / BGRA
        ctypes.c_void_p.from_address(base + 48).value = bgr.ctypes.data
        ctypes.c_uint32.from_address(base + 56).value = bgr.strides[0]
        assert lib.avifImageRGBToYUV(img, rgbimg) == 0
        planes = []
        for p in range(3):
            ptr = ctypes.c_void_p.from_address(img + 24 + 8 * p).value
            rb = ctypes.c_uint32.from_address(img + 48 + 4 * p).value
            pw, ph = (w, h) if p == 0 else ((w + 1) // 2, (h + 1) // 2)
            buf = (ctypes.c_uint8 * (rb * ph)).from_address(ptr)
            planes.append(np.ctypeslib.as_array(buf).reshape(ph, rb)[:, :pw].copy())
        return planes
    finally:
        lib.avifImageDestroy(img)


def test_rgb_to_yuv_is_libavifs_bit_for_bit():
    """`avif.rgb_to_yuv420` equals the wheel's avifImageRGBToYUV (which
    cv2's encoder calls) on random and saturated pixels, odd sizes, three
    and four channels."""
    lib = _libavif()
    rng = np.random.default_rng(3)
    for t in range(40):
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        c = 3 + t % 2
        img = rng.integers(0, 256, (h, w, c)).astype(np.uint8)
        if t % 3 == 0:
            img[..., :3] = np.where(rng.random((h, w, 1)) < 0.5, 0, 255)
        for a, b in zip(avif.rgb_to_yuv420(img), _libavif_yuv(lib, img)):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ refusals

def test_refusals_are_cv2s(tmp_path):
    """16-bit samples: cv2.imwrite returns False, the port raises
    ImwriteFailed (save_image returns); 2 channels: both raise
    ValueError. Neither writes a file."""
    for img, error in ((np.zeros((8, 8, 3), np.uint16), ImwriteFailed),
                       (np.zeros((8, 8), np.uint16), ImwriteFailed),
                       (np.zeros((8, 8, 2), np.uint8), ValueError)):
        c, p = tmp_path / "c.avif", tmp_path / "p.avif"
        if error is ImwriteFailed:
            assert not cv2.imwrite(str(c), _bgr(img))
        else:
            with pytest.raises(cv2.error):
                cv2.imwrite(str(c), img)
        with pytest.raises(error):
            image_io.write_raw(p, img)
        assert not c.exists() and not p.exists()
    # save_image at its default 16 bits: neither package writes a file
    jimage_io.save_image(np.zeros((8, 8, 3)), tmp_path / "j16.avif")
    image_io.save_image(np.zeros((8, 8, 3)), tmp_path / "p16.avif")
    assert not (tmp_path / "j16.avif").exists()
    assert not (tmp_path / "p16.avif").exists()


def test_save_image_as_the_jax_package(tmp_path):
    """The JAX save_image (cv2) and the port's, on the same float RGBA, at
    8 bits to `.avif`: both files hold an alpha item and, against the
    8-bit input, the port's is within the bounds of the JAX package's."""
    rng = np.random.default_rng(11)
    y, x = np.mgrid[:40, :56] / 60.0
    img = np.stack([x, y, 1 - x * y, (x + y) < 1.0], -1).astype(np.float32)
    img[..., :3] += rng.normal(0, 0.02, img[..., :3].shape).astype(np.float32)
    jimage_io.save_image(img, tmp_path / "j.avif", bit_depth=8)
    image_io.save_image(img, tmp_path / "p.avif", bit_depth=8)
    want = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    a, b = _cv2_read(tmp_path / "p.avif"), _cv2_read(tmp_path / "j.avif")
    assert a.shape == b.shape == want.shape
    for k in range(4):
        assert _psnr(want[..., k], a[..., k]) >= _psnr(want[..., k], b[..., k]) - PSNR_MARGIN_DB
        assert np.abs(want[..., k].astype(int) - a[..., k]).max() <= \
            np.abs(want[..., k].astype(int) - b[..., k]).max() + MAX_ERR_MARGIN
    assert _signalling((tmp_path / "p.avif").read_bytes()) == \
        _signalling((tmp_path / "j.avif").read_bytes())
