"""The AV1 inter tools of libaom's plain multi-frame streams, decoded by
`native/av1.cc` as libaom decodes them: compound prediction (average,
distance weights, wedge and difference-weight masks, unidirectional
references, the compound modes), the skip mode, shown-existing frames,
global motion (its models' warps), segmentation in inter frames (map and
temporal updates), superres and film grain in inter frames, and switch
frames.

The fixtures (`torch_fixtures/formats/avif_inter_*`, written by
`make_fixtures.py twentieth` through `torch_image_writers.aom_encode_stream`,
libaom's encoder with look-ahead) are streams of 12 frames or fewer in one
item, the last shown frame the output; the two `avif_refused_*` files of
the seventeenth slice use compound prediction and global motion too. For
each: the planes equal libaom's decode, the census slots of its tools
are above 0, and the stream cut half way through the tile data of its
first frame with compound blocks (or first inter frame) is
UnreadableImage, as libaom fails on it
(test_torch_image_avif.py holds every file against cv2 in the three
modes). The tools no libaom setting writes (dual and bilinear filters,
loop filter delta updates in inter frames, short reference signalling)
stay refused by name. `../avif_inter_scene/` is phase 19's sphere in such
streams.
"""

import hashlib
import json
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
SCENE = REPO / "tests" / "torch_fixtures" / "avif_inter_scene"
PLAIN_STREAMS = sorted(p.name for p in FIXTURES.glob("avif_inter_*.avif")) + [
    "avif_refused_compound.avif", "avif_refused_global_motion.avif"]
# native/av1.cc's census slots of these tools (see its Census enum)
STREAM_TOOLS = {
    128: "compound blocks", 129: "compound average", 130: "compound distance",
    131: "compound wedge", 132: "compound difference weights", 133: "skip mode",
    134: "unidirectional compound references", 135: "NEAREST_NEARESTMV",
    136: "NEAR_NEARMV", 137: "NEAREST_NEWMV", 138: "NEW_NEARESTMV", 139: "NEAR_NEWMV",
    140: "NEW_NEARMV", 141: "GLOBAL_GLOBALMV", 142: "NEW_NEWMV",
    143: "global motion: translation", 144: "global motion: rotation-zoom",
    145: "global motion: affine", 146: "global motion warps",
    147: "global motion shear left as translation", 148: "shown-existing frames",
    149: "shown-existing key frames", 150: "segmentation (inter frame)",
    151: "segment map updates (inter frame)", 152: "segment map temporal updates",
    153: "predicted segment ids", 154: "segment feature: reference",
    155: "segment feature: skip", 156: "segment feature: global motion",
    157: "segment features from a reference", 161: "superres (inter frame)",
    162: "film grain (inter frame)", 163: "film grain from a reference",
    164: "switch frames",
}
# reached by none of the fixtures' libaom settings: libaom searches
# rotation-zoom models only (a translation or affine one, and a shear the
# warp test rejects, never came); nor a key frame shown again, a predicted
# segment id, segment features other than the quantizer, film grain
# loaded from a reference, or these two compound modes
UNREACHED = {139, 140, 143, 145, 147, 149, 153, 154, 155, 156, 157, 163}
# the tools each fixture is written for
FIXTURE_TOOLS = {
    "avif_inter_compound.avif": (128, 131, 133), "avif_inter_compound_10bit.avif": (128, 133, 148),
    "avif_inter_compound_types.avif": (129, 130, 131, 132, 134), "avif_inter_skip_mode.avif": (133,),
    "avif_inter_show_existing.avif": (148,), "avif_inter_global_motion.avif": (141, 144, 146),
    "avif_inter_global_motion_10bit.avif": (141, 144, 146), "avif_inter_segmentation.avif": (150, 151),
    "avif_inter_segmentation_temporal.avif": (150, 152), "avif_inter_superres.avif": (161,),
    "avif_inter_film_grain.avif": (162,), "avif_inter_film_grain_10bit.avif": (162,),
    "avif_inter_switch_frame.avif": (164,), "avif_inter_tools_612x512.avif": (128, 144, 146),
    "avif_refused_compound.avif": (128,), "avif_refused_global_motion.avif": (144,),
}


def _obus(name):
    path = FIXTURES / name
    data = path.read_bytes()
    c = avif.parse(data, path)
    return avif.item_data(c, c.items[c.primary], data, path)


def _split(obus: bytes) -> list:
    """[(header bytes, payload)] of each OBU (libaom writes their sizes)."""
    out, pos = [], 0
    while pos < len(obus):
        start, h = pos, obus[pos]
        pos += 1 + ((h >> 2) & 1)
        size, shift = 0, 0
        while True:
            byte = obus[pos]
            pos += 1
            size |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                break
        out.append((obus[start:start + 1 + ((h >> 2) & 1)], obus[pos:pos + size]))
        pos += size
    return out


def _leb128(n: int) -> bytes:
    out = b""
    while True:
        byte = n & 0x7F
        n >>= 7
        out += bytes([byte | (0x80 if n else 0)])
        if not n:
            return out


def test_fixture_set():
    assert set(FIXTURE_TOOLS) == set(PLAIN_STREAMS)
    for name in PLAIN_STREAMS:
        limit = 512 << 10 if "612x512" in name else 64 << 10
        assert (FIXTURES / name).stat().st_size <= limit, name


@pytest.mark.parametrize("name", PLAIN_STREAMS)
def test_planes_equal_libaom(name):
    """The stream's last shown frame equals libaom's decode, and the
    stream uses the fixture's tools."""
    obus = _obus(name)
    code, info, planes, census = native.av1_decode(obus)
    assert code == 0, (code, info.get("tool"))
    ref = libaom_planes(obus)
    assert len(planes) == len(ref)
    for a, b in zip(planes, ref):
        np.testing.assert_array_equal(a, b, err_msg=name)
    for k in FIXTURE_TOOLS[name]:
        assert census[k] > 0, STREAM_TOOLS[k]


@pytest.mark.parametrize("name", PLAIN_STREAMS)
def test_truncated_compound_frame_is_unreadable(name, tmp_path):
    """The stream up to its first frame with compound blocks (or, in a
    stream without any, its first inter frame), that frame cut half way
    through its tile data: libaom fails on it, cv2 reads nothing, the port
    raises UnreadableImage."""
    obus = _split(_obus(name))
    slot = 128 if native.av1_decode(_obus(name))[3][128] else 97
    done = b""
    for head, payload in obus:
        whole = done + head + _leb128(len(payload)) + payload
        if (head[0] >> 3) & 15 == 6 and native.av1_decode(whole)[3][slot] > native.av1_decode(done)[3][slot]:
            cut = payload[:len(payload) // 2]
            truncated = done + head + _leb128(len(cut)) + cut
            break
        done = whole
    else:
        pytest.fail("no inter frame")
    assert libaom_planes(truncated) is None
    with pytest.raises(UnreadableImage):
        avif.decode_av1(truncated, name)
    info = native.av1_decode(done)[1]
    path = tmp_path / "cut.avif"
    path.write_bytes(tw.avif_still(truncated, info, colr=(1, 13, 6, 1)))
    assert cv2.imread(str(path)) is None
    with pytest.raises(UnreadableImage):
        image_io.read_image(path)


def test_stream_tool_census():
    """Together the fixtures reach every slot of these tools but those no
    libaom setting tried wrote (UNREACHED)."""
    total = np.zeros(native.AV1_CENSUS, np.int64)
    for name in PLAIN_STREAMS:
        total += native.av1_decode(_obus(name))[3]
    missing = [STREAM_TOOLS[k] for k in STREAM_TOOLS if not total[k] and k not in UNREACHED]
    assert not missing, missing


def test_committed_scene_prepares_as_jax(tmp_path):
    """The sphere of `torch_fixtures/avif_inter_scene` (normals and albedos
    as libaom streams whose last shown frame is the view, PNG masks;
    phase 19 of chip_smoke.py trains it on the card): every view uses
    inter tools, together compound prediction, global motion and
    shown-existing frames; the port's `prepare_testbed_data` gives the JAX
    package's transform and prepared arrays, whose digests
    `expected.json` holds."""
    from rnb_neus2_torch.io import png
    from rnb_neus2_torch.io.dataloaders import load_data
    from rnb_neus2_torch.io.prepare import prepare_testbed_data
    from rnb_neus2_tpu.io.dataloaders import load_data as jload
    from rnb_neus2_tpu.io.prepare import prepare_testbed_data as jprepare

    used = np.zeros(native.AV1_CENSUS, np.int64)
    for kind in ("normals", "albedos"):
        for view in json.loads((SCENE / f"{kind}.sfm.json").read_text())["views"]:
            path = SCENE / view["path"]
            data = path.read_bytes()
            c = avif.parse(data, path)
            code, info, _, census = native.av1_decode(avif.item_data(c, c.items[c.primary], data, path))
            assert code == 0 and census[97] and census[128], view["path"]
            used += census
    assert used[128] and used[144] and used[146] and used[148]

    kw = dict(albedo_sfm_path=str(SCENE / "albedos.sfm.json"),
              mask_sfm_path=str(SCENE / "masks.sfm.json"))
    prepare_testbed_data(load_data(str(SCENE / "normals.sfm.json"), **kw), str(tmp_path / "port"))
    jprepare(jload(str(SCENE / "normals.sfm.json"), **kw), str(tmp_path / "jax"))
    expected = json.loads((SCENE / "expected.json").read_text())
    tj, jtj = (json.loads((tmp_path / d / "transform.json").read_text()) for d in ("port", "jax"))
    assert tj["n2w"] == jtj["n2w"] == expected["n2w"]
    assert len(tj["frames"]) == len(expected["frames"]) == 16

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
