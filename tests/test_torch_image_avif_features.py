"""AVIF film grain, superres and grid images read as cv2 reads them.

Film grain: a key frame of libaom's encoder under each of its 16 film
grain test vectors (luma and chroma points, chroma scaling from luma,
auto-regression lags 0-3, overlap, restricted range), at 8 and 10 bits.
Superres: every denominator from 9 to 16 at widths that round, with loop
restoration on, and a frame too narrow to shrink. For each, the Y, U and
V planes of `native/av1.cc` equal libaom's own decode (its grain applied,
as libavif gets the frame), and the port's `read_image` equals cv2 in the
three modes. Grids: hand-built `grid` derived items over cv2's one-item
files, the ones libavif reads and the ones it refuses (UnreadableImage
where cv2 returns None).
"""

import struct

import cv2
import numpy as np
import pytest

import torch_image_writers as tw
from rnb_neus2_torch.io import image_io, native
from rnb_neus2_torch.io.errors import UnreadableImage
from torch_avif_reference import libaom_planes

MODES = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "grey": cv2.IMREAD_GRAYSCALE}


def _texture(seed, h, w):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w].astype(np.float64)
    img = np.stack([120 + 60 * np.sin(x / (5 + c) + y / 9) for c in range(3)],
                   -1) + rng.normal(0, 8, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _like_cv2(path):
    for mode, flag in MODES.items():
        want = cv2.imread(str(path), flag)
        if want is None:
            with pytest.raises(UnreadableImage):
                image_io.read_image(path, mode)
            continue
        if want.ndim == 3:
            want = want[..., [2, 1, 0, 3][:want.shape[2]]]
        got = image_io.read_image(path, mode)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), mode
        np.testing.assert_array_equal(got, want, err_msg=mode)


def _check(tmp_path, obus, census_index):
    code, info, planes, census = native.av1_decode(obus)
    assert code == 0 and census[census_index], code
    ref = libaom_planes(obus)
    assert len(planes) == len(ref)
    for a, b in zip(planes, ref):
        np.testing.assert_array_equal(a, b)
    path = tmp_path / "x.avif"
    path.write_bytes(tw.avif_still(obus, info, colr=(1, 13, 6, 1)))
    _like_cv2(path)


@pytest.mark.parametrize("vector", range(1, 17))
def test_film_grain_vectors(tmp_path, vector):
    """libaom's film grain test vector `vector` on an 8-bit key frame."""
    h, w = 2 * (20 + vector), 2 * (25 + 3 * vector)
    obus = tw.aom_encode(tw.rgb_to_yuv420(_texture(vector, h, w)), cq=30,
                         options={"cpu-used": 6, "film-grain-test": vector})
    _check(tmp_path, obus, 96)


@pytest.mark.parametrize("vector", [2, 7, 10, 16])
def test_film_grain_10bit(tmp_path, vector):
    yuv = [p.astype(np.uint16) * 4 + 1
           for p in tw.rgb_to_yuv420(_texture(vector, 40, 58))]
    obus = tw.aom_encode(yuv, bit_depth=10, cq=30,
                         options={"cpu-used": 6, "film-grain-test": vector})
    code, info, planes, census = native.av1_decode(obus)
    assert code == 0 and census[96]
    for a, b in zip(planes, libaom_planes(obus)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("denom,h,w", [(9, 34, 70), (10, 48, 98),
                                       (11, 20, 130), (12, 64, 64),
                                       (13, 30, 146), (14, 38, 62),
                                       (15, 52, 90), (16, 16, 200)])
def test_superres(tmp_path, denom, h, w):
    """Coded (w·8 + denom/2) / denom wide, upscaled by the normative
    filter between CDEF and loop restoration (on: its units are counted
    in the upscaled width)."""
    obus = tw.aom_encode(tw.rgb_to_yuv420(_texture(denom, h, w)), cq=35,
                         options={"cpu-used": 5, "enable-restoration": 1},
                         cfg={19: 1, 20: denom, 21: denom})
    _check(tmp_path, obus, 95)


def test_superres_too_narrow_to_shrink(tmp_path):
    """16 samples wide: libaom keeps a superres frame at least 16 wide,
    so no upscaling happens although the header asks for it."""
    obus = tw.aom_encode(tw.rgb_to_yuv420(_texture(3, 64, 16)), cq=30,
                         options={"cpu-used": 6}, cfg={19: 1, 20: 10, 21: 10})
    code, info, planes, census = native.av1_decode(obus)
    assert code == 0 and not census[95] and info["width"] == 16
    for a, b in zip(planes, libaom_planes(obus)):
        np.testing.assert_array_equal(a, b)


def _cv2_avif(rgb):
    ok, blob = cv2.imencode(".avif", np.ascontiguousarray(rgb[..., ::-1]))
    assert ok
    return blob.tobytes()


def _tile(blob):
    """(OBUs, width, height, props) of a one-item AVIF's item."""
    from rnb_neus2_torch.io import avif
    c = avif.parse(blob, "tile")
    it = c.items[c.primary]
    w, h = struct.unpack(">II", avif.prop(it, b"ispe")[4:12])
    return (avif.item_data(c, it, blob, "tile"), w, h,
            [tw.ispe(w, h), tw.isobmff_box(b"av1C", avif.prop(it, b"av1C")),
             tw.pixi(8, 3)])


def _grid(tiles, rows, cols, out_w, out_h, refs_to=None, ispe=None,
          version=0):
    desc = bytes([version, 0, rows - 1, cols - 1]) \
        + struct.pack(">HH", out_w, out_h)
    items = [dict(id=1, type=b"grid", data=desc, method=1,
                  props=[tw.ispe(*(ispe or (out_w, out_h))), tw.pixi(8, 3)])]
    for k, (obus, w, h, props) in enumerate(tiles):
        items.append(dict(id=2 + k, type=b"av01", data=obus, hidden=True,
                          props=props))
    to = refs_to or list(range(2, 2 + len(tiles)))
    return tw.avif_file(items, refs=[(b"dimg", 1, to)])


@pytest.mark.parametrize("kind", [
    "1x3", "3x1_cropped", "2x2_distinct", "mismatched_sizes",
    "too_few_refs", "not_covering", "past_the_last_column",
    "odd_output_420", "version_1", "tile_not_av01", "ispe_differs"])
def test_grids(tmp_path, kind):
    """A grid libavif reads equals cv2's decode; one it refuses, or whose
    ispe is not its output size (cv2 fails on it), is UnreadableImage
    (cv2: None)."""
    rng = np.random.default_rng(len(kind))
    tex = [_tile(_cv2_avif(_texture(int(s), 64, 64)))
           for s in rng.integers(0, 1000, 4)]
    one = tex[0]
    blob = {
        "1x3": lambda: _grid([one] * 3, 1, 3, 192, 64),
        "3x1_cropped": lambda: _grid(tex[:3], 3, 1, 50 + 14, 130),
        "2x2_distinct": lambda: _grid(tex, 2, 2, 128, 128),
        "mismatched_sizes": lambda: _grid(
            [one, _tile(_cv2_avif(_texture(5, 64, 80)))], 1, 2, 128, 64),
        "too_few_refs": lambda: _grid(tex, 2, 2, 128, 128,
                                      refs_to=[2, 3, 4]),
        "not_covering": lambda: _grid(tex, 2, 2, 130, 128),
        "past_the_last_column": lambda: _grid(tex, 2, 2, 64, 128),
        "odd_output_420": lambda: _grid(tex, 2, 2, 127, 128),
        "version_1": lambda: _grid(tex, 2, 2, 128, 128, version=1),
        "tile_not_av01": lambda: _grid(tex, 2, 2, 128, 128,
                                       refs_to=[2, 3, 4, 1]),
        "ispe_differs": lambda: _grid(tex, 2, 2, 128, 128, ispe=(120, 128)),
    }[kind]()
    path = tmp_path / "g.avif"
    path.write_bytes(blob)
    _like_cv2(path)
    readable = kind in ("1x3", "3x1_cropped", "2x2_distinct")
    assert (cv2.imread(str(path)) is not None) == readable
