"""Layered AVIF images read as cv2 reads them, through the AV1 inter path
of `native/av1.cc`.

libavif writes a layered image as one item whose payload holds each
layer's frames back to back, `a1lx` sizing them: libaom encodes the
first layer as a key frame and every later one as an inter frame whose
only reference is LAST, the layer before it, at its own scale (½ then
1/1 for spatial layers). cv2 (libavif, progressive decoding off) decodes
them all and shows the last frame, or with `lsel` the first frame of that
spatial layer, scaled to the item's `ispe`.

The fixtures (`torch_fixtures/formats/avif_layers_*`, written by
make_fixtures.py through `torch_image_writers.aom_encode_layers`, which
drives libaom as libavif's codec_aom.c does) cover 2 and 4 layers,
quality and spatial, `lsel` on a middle layer, alpha (straight and
premultiplied), 10 and 12 bits, screen content and the slow encoder
speeds' tools; more streams are encoded here at several speeds. Each
stream's planes equal libaom's own decode; the files equal cv2 in the
three modes (test_torch_image_avif.py's fixture test covers them too).
The inter tools the fixtures reach are counted by the decoder's census
(`PYTHONPATH=.:tests python tests/test_torch_image_avif_layers.py`
prints it, with the slots of the tools of libaom's plain multi-frame
streams summed over `avif_inter_*` and `avif_refused_*`, which
test_torch_image_avif_inter_tools.py holds against libaom).
"""

import hashlib
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

import torch_image_writers as tw
from rnb_neus2_torch.io import avif, image_io, native
from rnb_neus2_torch.io.errors import UnreadableImage
from torch_avif_reference import libaom_planes

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "torch_fixtures" / "formats"
SCENE = REPO / "tests" / "torch_fixtures" / "avis_scene"
LAYERED = sorted(p.name for p in FIXTURES.glob("avif_layers_*.avif"))
MODES = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "grey": cv2.IMREAD_GRAYSCALE}
QUALITY2 = [(40, (1, 1)), (12, (1, 1))]
SPATIAL2 = [(30, (1, 2)), (20, (1, 1))]
SPATIAL4 = [(50, (1, 4)), (40, (1, 2)), (30, (1, 2)), (10, (1, 1))]
QUALITY4 = [(60, (1, 1)), (40, (1, 1)), (20, (1, 1)), (5, (1, 1))]
# native/av1.cc's census of inter tools (see its Census enum)
INTER_TOOLS = {
    97: "inter frames", 98: "inter blocks", 99: "intra blocks in inter frames",
    100: "NEARESTMV", 101: "NEARMV", 102: "GLOBALMV", 103: "NEWMV", 104: "DRL index",
    105: "scaled reference", 106: "regular filter", 107: "smooth filter", 108: "sharp filter",
    109: "wedge inter-intra", 110: "split inter transform", 111: "extra MV search",
    112: "high-precision MVs", 113: "switchable filters", 114: "CDFs from a reference",
    115: "local warp left as translation", 116: "loop restoration (inter frame)",
    117: "sub-8x8 chroma from several blocks", 118: "spatial layer above 0",
    119: "skipped inter block", 120: "deblocking (inter frame)", 121: "temporal MV",
    122: "motion mode read", 123: "reference frame MVs", 124: "OBMC",
    125: "local warped motion", 126: "CDEF (inter frame)", 127: "inter-intra",
}
# reached by no layered stream of libaom's: the fallback that keeps
# translation for a warp model the shear test rejects
UNREACHED = {115}


def _texture(seed, h, w):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w].astype(np.float64)
    img = np.stack([128 + 60 * np.sin(x / (7 + c) + seed) + 30 * np.cos(y / 5)
                    for c in range(3)], -1) + rng.normal(0, 6, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _items(name):
    """The OBUs of a fixture's colour item (and alpha item)."""
    path = FIXTURES / name
    data = path.read_bytes()
    c = avif.parse(data, path)
    out = [c.items[c.primary]] + [c.items[f] for k, f, to in c.refs
                                  if k == b"auxl" and c.primary in to]
    return [(it, avif.item_data(c, it, data, path)) for it in out]


def _equal_libaom(obus):
    code, info, planes, census = native.av1_decode(obus)
    assert code == 0, (code, info.get("tool"))
    ref = libaom_planes(obus)
    assert len(planes) == len(ref)
    for a, b in zip(planes, ref):
        np.testing.assert_array_equal(a, b)
    return census


@pytest.mark.parametrize("name", LAYERED)
def test_layered_fixtures_equal_libaom(name):
    """Every layered item's frames (the last one shown) equal libaom's
    decode of the same stream, colour and alpha."""
    for it, obus in _items(name):
        assert avif.prop(it, b"a1lx") is not None
        _equal_libaom(obus)


@pytest.mark.parametrize("speed", [2, 6, 9])
@pytest.mark.parametrize("layers", [QUALITY2, SPATIAL4], ids=["quality2", "spatial4"])
def test_encoder_speeds(speed, layers):
    """libaom's layers at more of libavif's speeds equal libaom's
    decode."""
    yuv = tw.rgb_to_yuv420(_texture(speed, 64, 96))
    obus = tw.aom_encode_layers(yuv, layers, speed=speed)
    _equal_libaom(b"".join(obus))


def test_deep_layers(tmp_path):
    """10- and 12-bit layers equal libaom's decode and cv2."""
    for depth, layers in ((10, SPATIAL2), (12, QUALITY4)):
        yuv = [p.astype(np.uint16) << (depth - 8) for p in tw.rgb_to_yuv420(_texture(depth, 48, 64))]
        obus = tw.aom_encode_layers(yuv, layers, bit_depth=depth)
        _equal_libaom(b"".join(obus))
        code, info, _, _ = native.av1_decode(b"".join(obus))
        path = tmp_path / f"d{depth}.avif"
        path.write_bytes(tw.layered_avif(obus, info, colr=(1, 13, 6, 1)))
        _like_cv2(path)


def _like_cv2(path):
    from rnb_neus2_tpu.io import image_io as jimage_io
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
    if cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is not None:
        np.testing.assert_array_equal(image_io.load_image(path), jimage_io.load_image(str(path)))
    else:
        for load in (image_io.load_image, jimage_io.load_image):
            with pytest.raises(FileNotFoundError):
                load(str(path))


@pytest.fixture(scope="module")
def four_layers():
    yuv = tw.rgb_to_yuv420(_texture(4, 64, 96))
    obus = tw.aom_encode_layers(yuv, SPATIAL4)
    code, info, _, _ = native.av1_decode(b"".join(obus))
    assert code == 0
    return obus, info


@pytest.mark.parametrize("kind", ["lsel_0", "lsel_1", "lsel_2", "lsel_3", "lsel_4",
                                  "lsel_ffff", "a1op_1", "a1op_9", "essential_a1lx",
                                  "nonessential_lsel", "nonessential_a1op", "a1lx_overfull",
                                  "no_a1lx_lsel_1"])
def test_layer_selection(tmp_path, four_layers, kind):
    """`lsel` picks the first frame of its spatial layer from the layers
    `a1lx` sizes up to it (a smaller frame is scaled to the ispe); past
    the layers, or without a frame of that layer, cv2 reads nothing;
    `a1op` names the operating point (one the stream lacks is point 0);
    libavif wants `a1op` and `lsel` essential and `a1lx` not."""
    obus, info = four_layers
    blob = {
        "lsel_ffff": lambda: tw.layered_avif(obus, info, lsel=0xFFFF),
        "a1op_1": lambda: tw.layered_avif(obus, info, a1op=1),
        "a1op_9": lambda: tw.layered_avif(obus, info, a1op=9),
        "essential_a1lx": lambda: tw.layered_avif(obus, info, essential_a1lx=True),
        "no_a1lx_lsel_1": lambda: tw.avif_still(b"".join(obus), info, extra_props=[
            tw.isobmff_box(b"lsel", struct.pack(">H", 1))]),
    }.get(kind)
    if kind.startswith("lsel_") and kind != "lsel_ffff":
        blob = tw.layered_avif(obus, info, lsel=int(kind[5:]))
    elif kind.startswith("nonessential_"):
        box = tw.isobmff_box(b"lsel", struct.pack(">H", 1)) if kind.endswith("lsel") \
            else tw.isobmff_box(b"a1op", b"\0")
        blob = tw.avif_still(b"".join(obus), info, extra_props=[(box, False)])
    elif kind == "a1lx_overfull":
        blob = tw.avif_still(b"".join(obus), info, extra_props=[(tw.isobmff_box(
            b"a1lx", bytes([0]) + struct.pack(">HHH", len(b"".join(obus)), 0, 0)), False)])
    else:
        blob = blob()
    path = tmp_path / "l.avif"
    path.write_bytes(blob)
    _like_cv2(path)
    readable = cv2.imread(str(path)) is not None
    assert readable == (kind not in ("lsel_4", "essential_a1lx", "nonessential_lsel",
                                     "nonessential_a1op", "a1lx_overfull"))


def test_whole_sequences_decode_as_libaom():
    """The inter path beyond layers: all ten frames of a cv2 sequence of a
    moving picture (good-quality mode, several references) decoded as one
    stream equal libaom's last frame."""
    from test_torch_image_avif_sequences import cv2_sequence, tracks_of
    base = _texture(9, 48, 64).astype(np.int64)
    frames = [np.clip(np.roll(base, 2 * k, axis=1) + 3 * k, 0, 255).astype(np.uint8)
              for k in range(10)]
    (track, samples), = tracks_of(cv2_sequence(frames))
    census = _equal_libaom(b"".join(samples))
    assert census[97] == 9


@pytest.mark.parametrize("name,tool", [("avif_refused_compound.avif", 128),
                                       ("avif_refused_global_motion.avif", 144)])
def test_tools_refused_by_name(name, tool):
    """The inter tools no layered image of libavif's uses, once refused by
    name (compound prediction and global motion, from libaom's plain
    multi-frame streams), now decode: the stream equals libaom's decode,
    uses the tool (census slot `tool`: compound blocks, rotation-zoom
    models) and the file reads as cv2 reads it."""
    for it, obus in _items(name):
        assert _equal_libaom(obus)[tool] > 0
    _like_cv2(FIXTURES / name)


def census_table(names=None, tools=INTER_TOOLS) -> dict:
    """The inter tools' census summed over `names` (the layered fixtures)
    → {slot: count}."""
    total = np.zeros(native.AV1_CENSUS, np.int64)
    for name in names or LAYERED:
        for it, obus in _items(name):
            total += native.av1_decode(obus)[3]
    return {k: int(total[k]) for k in tools}


def test_inter_tool_census():
    """Together the layered fixtures reach every inter tool of the
    decoder (but the warp shear test's fallback)."""
    table = census_table()
    missing = [INTER_TOOLS[k] for k, v in table.items() if not v and k not in UNREACHED]
    assert not missing, missing


def test_committed_scene_prepares_as_jax(tmp_path):
    """The sphere of `torch_fixtures/avis_scene` (normals as 3-frame AVIF
    sequences whose first frame is the view, albedos as 2-layer spatial
    AVIFs, PNG masks; phase 19 of chip_smoke.py trains it on the card):
    the port's `prepare_testbed_data` gives the JAX package's transform
    and prepared arrays, whose digests `expected.json` holds."""
    from rnb_neus2_torch.io import png
    from rnb_neus2_torch.io.dataloaders import load_data
    from rnb_neus2_torch.io.prepare import prepare_testbed_data
    from rnb_neus2_tpu.io.dataloaders import load_data as jload
    from rnb_neus2_tpu.io.prepare import prepare_testbed_data as jprepare

    kw = dict(albedo_sfm_path=str(SCENE / "albedos.sfm.json"),
              mask_sfm_path=str(SCENE / "masks.sfm.json"))
    prepare_testbed_data(load_data(str(SCENE / "normals.sfm.json"), **kw), str(tmp_path / "port"))
    jprepare(jload(str(SCENE / "normals.sfm.json"), **kw), str(tmp_path / "jax"))
    expected = json.loads((SCENE / "expected.json").read_text())
    tj, jtj = (json.loads((tmp_path / d / "transform.json").read_text()) for d in ("port", "jax"))
    assert tj["n2w"] == jtj["n2w"] == expected["n2w"]
    assert len(tj["frames"]) == len(expected["frames"]) == 16
    for kind, check in (("normals", lambda c: avif.source(c) == "tracks" and c.tracks),
                        ("albedos", lambda c: avif.prop(c.items[c.primary], b"a1lx") is not None)):
        for view in json.loads((SCENE / f"{kind}.sfm.json").read_text())["views"]:
            data = (SCENE / view["path"]).read_bytes()
            assert check(avif.parse(data, view["path"])), view["path"]

    def digest(a):
        a = np.ascontiguousarray(a)
        return hashlib.sha256(f"{a.dtype}{a.shape}".encode() + a.tobytes()).hexdigest()
    for fr, jfr in zip(tj["frames"], jtj["frames"]):
        want = expected["frames"][Path(fr["normal_path"]).name]
        for key in ("normal", "albedo"):
            got = png.read_png(tmp_path / "port" / fr[f"{key}_path"])
            jax = cv2.imread(str(tmp_path / "jax" / jfr[f"{key}_path"]),
                             cv2.IMREAD_UNCHANGED)[..., [2, 1, 0, 3]]
            np.testing.assert_array_equal(got, jax)
            assert digest(got) == want[key]


if __name__ == "__main__":
    from test_torch_image_avif_inter_tools import PLAIN_STREAMS, STREAM_TOOLS
    for k, v in census_table().items():
        print(f"{k:4d}  {INTER_TOOLS[k]:40s} {v}")
    for k, v in census_table(PLAIN_STREAMS, STREAM_TOOLS).items():
        print(f"{k:4d}  {STREAM_TOOLS[k]:40s} {v}")
