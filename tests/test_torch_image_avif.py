"""AVIF read as cv2 reads it (`rnb_neus2_torch/io/avif.py` over the AV1
decoder `native/av1.cc`): every committed fixture in the three modes
against cv2 5.0's decode in `expected.npz`, the decoded Y, U and V
planes (and alpha planes) against libaom 3.14's own decoder reached
through ctypes, a census of the coding tools the fixtures use, cv2's
None cases, the AV1 tables against
libaom's read-only data, and the committed AVIF scene prepared as the
JAX package prepares it."""

import hashlib
import io
import json
import struct
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

import torch_av1_tables as tables
import torch_image_writers as tw
from rnb_neus2_torch.io import avif, image_io, native
from rnb_neus2_torch.io.errors import UnreadableImage
from torch_avif_reference import libaom_planes

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "torch_fixtures" / "formats"
SCENE = Path(__file__).parent / "torch_fixtures" / "avif_scene"
MODES = ("unchanged", "color", "grey")
FILES = sorted(p.name for p in FIXTURES.glob("*.avif"))
# broken on purpose: no AV1 item or sample to decode, or one libaom fails on
BROKEN = {"unreadable_avif_truncated.avif", "unreadable_avif_bad_iloc.avif",
          "unreadable_avif_bad_obu.avif", "unreadable_avif_layers_essential_a1lx.avif",
          "unreadable_avis_no_stsd.avif", "unreadable_avis_not_a_key_frame.avif",
          "unreadable_avis_sample_past_end.avif"}


@pytest.fixture(scope="module")
def expected():
    with np.load(FIXTURES / "expected.npz") as z:
        return {k: z[k] for k in z.files if k.split(":")[0].endswith(".avif")}


def _av1_items(path: Path):
    """The OBUs of the primary item and of its alpha item, or of their
    grids' tiles; of a file whose tracks libavif decodes, each track's
    first sample."""
    data = path.read_bytes()
    c = avif.parse(data, path)
    if avif.source(c) == "tracks":
        return [data[o:o + n] for t in c.tracks for o, n in t.samples(len(data), path)[:1]]
    out = []
    primary = c.items[c.primary]
    items = [primary] + [c.items[f] for k, f, to in c.refs
                         if k == b"auxl" and c.primary in to]
    for it in items:
        if it.type == b"grid":
            tiles = [c.items[t] for k, f, to in c.refs
                     if k == b"dimg" and f == it.id for t in to]
        else:
            tiles = [it]
        for t in tiles:
            if t.type == b"av01":
                out.append(avif.item_data(c, t, data, path))
    return out


def test_fixture_set():
    assert len(FILES) >= 45
    assert sum((FIXTURES / n).stat().st_size for n in FILES) <= 512 << 10
    for name in FILES:
        limit = 512 << 10 if "612x512" in name else 64 << 10
        assert (FIXTURES / name).stat().st_size <= limit, name


@pytest.mark.parametrize("name", FILES)
def test_fixture_reads_as_cv2(name, expected):
    """Each mode equals cv2's decode; cv2's None is UnreadableImage (the
    files once refused for compound prediction and global motion,
    `avif_refused_*`, decode as cv2 reads them)."""
    path = FIXTURES / name
    for mode in MODES:
        want = expected[f"{name}:{mode}"]
        if want.size == 0:
            with pytest.raises(UnreadableImage):
                image_io.read_image(path, mode)
            continue
        got = image_io.read_image(path, mode)
        assert got.dtype == want.dtype, mode
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {mode}")


@pytest.mark.parametrize("name", [n for n in FILES if n not in BROKEN])
def test_planes_equal_libaom(name):
    """The Y, U and V planes of every item native/av1.cc decodes equal
    libaom's decode of the same OBUs."""
    items = _av1_items(FIXTURES / name)
    assert items
    for obus in items:
        code, info, planes, _ = native.av1_decode(obus)
        assert code == 0
        ref = libaom_planes(obus)
        assert len(planes) == len(ref)
        for a, b in zip(planes, ref):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_tool_census():
    """Together the fixtures use every tool of the decoder: each
    partition kind, luma and chroma mode (CFL included), palette, filter
    intra, intra block copy, every transform type and size, deblocking,
    CDEF, the three restoration types, segmentation, delta q and lf,
    several tiles, 128x128 superblocks, at 8, 10 and 12 bits in 4:0:0,
    4:2:0, 4:2:2 and 4:4:4."""
    total = np.zeros(native.AV1_CENSUS, np.int64)
    depths, formats, tiles = set(), set(), 1
    for name in FILES:
        if name in BROKEN:
            continue
        for obus in _av1_items(FIXTURES / name):
            code, info, _, census = native.av1_decode(obus)
            total += census > 0
            tiles = max(tiles, int(census[84]))
            depths.add(info["bit_depth"])
            formats.add("400" if info["mono"] else
                        {(1, 1): "420", (1, 0): "422", (0, 0): "444"}[(info["ssx"], info["ssy"])])
    names = {0: (10, "partition"), 10: (13, "y mode"), 23: (14, "uv mode"),
             41: (16, "transform type"), 57: (19, "transform size")}
    for start, (n, what) in names.items():
        missing = [i for i in range(n) if not total[start + i]]
        assert not missing, (what, missing)
    for idx, what in ((37, "palette y"), (38, "palette uv"),
                      (39, "filter intra"), (40, "intra block copy"),
                      (76, "deblocking"), (77, "CDEF"), (78, "Wiener"),
                      (79, "self-guided"), (80, "switchable restoration"),
                      (81, "segmentation"), (94, "segment ids"),
                      (82, "delta q"), (83, "delta lf"), (85, "128x128"),
                      (86, "quantizer matrices"), (87, "lossless")):
        assert total[idx], what
    assert tiles == 4
    assert depths == {8, 10, 12}
    assert formats == {"400", "420", "422", "444"}


def _still(rgb=None):
    rgb = np.full((16, 16, 3), 90, np.uint8) if rgb is None else rgb
    obus = tw.aom_encode(tw.rgb_to_yuv420(rgb), cq=20, options={"cpu-used": 6})
    code, info, _, _ = native.av1_decode(obus)
    assert code == 0
    return obus, info


@pytest.mark.parametrize("kind,error,what", [
    # an image sequence, a layer selection and an ispe other than the
    # frame's size were refused by name until the port read them; they keep
    # their ids
    pytest.param("sequence", None, None, id="sequence-UnsupportedImage-sequence"),
    pytest.param("lsel", None, None, id="lsel-UnsupportedImage-layered"),
    pytest.param("ispe", None, None, id="ispe-UnsupportedImage-ispe"),
    ("a1lx", UnreadableImage, "a1lx"),
    ("tile_list", UnreadableImage, "large-scale tile")])
def test_other_refusals_by_name(tmp_path, kind, error, what):
    """`a1lx` whose first layer fills the item and large-scale tile (a
    tile list OBU), which libavif fails on (cv2: None), raise
    UnreadableImage naming the file and the feature. An image sequence
    (`avis` with a track: cv2 gives its first frame), a layer selection
    (`lsel` 0 of a one-layer item) and an `ispe` other than the frame's
    size (libavif scales the frame to it) read as cv2 reads them."""
    from PIL import Image
    path = tmp_path / "x.avif"
    obus, info = _still()
    if kind == "sequence":
        frames = [Image.fromarray(np.full((16, 16, 3), v, np.uint8))
                  for v in (40, 200)]
        bio = io.BytesIO()
        frames[0].save(bio, "AVIF", save_all=True, append_images=frames[1:])
        blob = bio.getvalue()
    elif kind in ("a1lx", "lsel"):
        body = bytes([0]) + struct.pack(">HHH", len(obus), 0, 0) \
            if kind == "a1lx" else struct.pack(">H", 0)
        blob = tw.avif_still(obus, info, extra_props=[
            tw.isobmff_box(kind.encode(), body)])
    elif kind == "ispe":
        good = tw.avif_still(obus, info)
        i = good.find(b"ispe") + 8
        blob = good[:i] + struct.pack(">I", info["width"] + 1) + good[i + 4:]
    else:
        seq_end = 2 + obus[1]             # the sequence header OBU first
        blob = tw.avif_still(obus[:seq_end] + bytes([0x42, 0x00])
                             + obus[seq_end:], info)
    path.write_bytes(blob)
    assert (cv2.imread(str(path)) is None) == (error is UnreadableImage)
    if error is None:
        want = cv2.imread(str(path), cv2.IMREAD_COLOR)[..., ::-1]
        np.testing.assert_array_equal(image_io.read_image(path, "color"), want)
        return
    with pytest.raises(error, match=what) as e:
        image_io.read_image(path, "color")
    assert str(path) in str(e.value)


@pytest.mark.parametrize("kind", ["no_meta", "no_pitm", "handler", "ipma",
                                  "extent", "ftyp_only"])
def test_broken_containers_are_unreadable(tmp_path, kind):
    """Boxes cv2 (libavif) cannot parse: UnreadableImage, as cv2 returns
    None for each."""
    obus, info = _still()
    good = tw.avif_still(obus, info)
    if kind == "no_meta":
        blob = good.replace(b"meta", b"xeta", 1)
    elif kind == "no_pitm":
        blob = good.replace(b"pitm", b"xitm", 1)
    elif kind == "handler":
        blob = good.replace(b"pict", b"vide", 1)
    elif kind == "ipma":
        i = good.find(b"ipma") + 4 + 4 + 4 + 2 + 1
        blob = good[:i] + bytes([0x80 | 9]) + good[i + 1:]
    elif kind == "extent":
        blob = good[:-10]
    else:
        blob = good[:good.find(b"meta") - 4]
    path = tmp_path / "x.avif"
    path.write_bytes(blob)
    assert cv2.imread(str(path)) is None
    with pytest.raises(UnreadableImage):
        image_io.read_image(path)


@pytest.mark.parametrize("major,compatible,reads", [
    (b"avif", [b"mif1"], True), (b"mif1", [b"avif", b"miaf"], True),
    (b"avis", [b"avif"], False), (b"heic", [b"mif1"], False)])
def test_signature_is_libavifs(tmp_path, major, compatible, reads):
    """avifPeekCompatibleFileType: the major brand or any compatible brand
    `avif`/`avis`; otherwise cv2 does not recognise the file. An `avis`
    major brand makes libavif decode a track, and without one it fails."""
    obus, info = _still()
    blob = tw.avif_still(obus, info)
    ftyp_len = struct.unpack(">I", blob[:4])[0]
    brands = (list(compatible) + [b"MA1A", b"MA1B"])[:3]   # the same length
    ftyp = tw.isobmff_box(b"ftyp", major + bytes(4) + b"".join(brands))
    assert len(ftyp) == ftyp_len
    path = tmp_path / "x.bin"
    path.write_bytes(ftyp + blob[ftyp_len:])
    assert (cv2.imread(str(path)) is not None) == reads
    if reads:
        np.testing.assert_array_equal(
            image_io.read_image(path, "color"), cv2.imread(str(path))[..., ::-1])
    else:
        with pytest.raises(UnreadableImage):
            image_io.read_image(path)


def test_av1_tables_are_libaoms():
    """native/av1_tables.h is what tests/torch_av1_tables.py writes from
    libaom's read-only data, and the CDFs written out by hand are found
    in the library; the compound prediction CDFs read from libaom's
    FRAME_CONTEXT are inverse CDFs (falling to the terminal 0, then the
    zero counter)."""
    lib = tables.Rodata(tables.libaom_path())
    assert tables.check_small_cdfs(lib) == []
    built = tables.build(lib)
    assert tables.HEADER.read_text() == tables.render(built)
    for name in ("compound_mode_cdf", "compound_type_cdf", "comp_ref_type_cdf",
                 "uni_comp_ref_cdf", "comp_ref_cdf", "comp_bwdref_cdf",
                 "compound_idx_cdf", "comp_group_idx_cdf"):
        rows = built[name].reshape(-1, built[name].shape[-1]).astype(np.int64)
        assert (rows[:, -2:] == 0).all(), name
        assert (rows[:, 0] > 0).all() and (np.diff(rows[:, :-1], axis=1) <= 0).all(), name


def test_deep_samples_load_as_the_jax_package_loads_them():
    """A 10- or 12-bit AVIF is uint16 raw values (0-1023, 0-4095), which
    load_image divides by 65535 as the JAX package does."""
    from rnb_neus2_tpu.io import image_io as jimage_io
    for name in ("avif_cv2_10bit.avif", "avif_cv2_12bit.avif",
                 "avif_cv2_rgba_10bit.avif"):
        path = FIXTURES / name
        raw = image_io.read_image(path)
        assert raw.dtype == np.uint16
        assert raw.max() < (1024 if "10bit" in name else 4096)
        np.testing.assert_array_equal(image_io.load_image(path),
                                      jimage_io.load_image(str(path)))
        np.testing.assert_array_equal(image_io.load_image_raw16(path),
                                      jimage_io.load_image_raw16(str(path)))


def test_the_port_loads_neither_libavif_nor_libaom(tmp_path):
    """Reading every kind of fixture leaves libavif and libaom unloaded:
    the decoder is the port's own."""
    names = [n for n in FILES if not n.startswith("unreadable")]
    code = ("import sys\nfrom pathlib import Path\n"
            "from rnb_neus2_torch.io import image_io\n"
            f"for n in {names!r}:\n"
            f"    image_io.read_image(Path({str(FIXTURES)!r}) / n, 'color')\n"
            "maps = open('/proc/self/maps').read()\n"
            "print(sorted(m for m in ('libavif', 'libaom', 'libdav1d', 'cv2')\n"
            "             if m in maps or m in sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_committed_scene_prepares_as_jax(tmp_path):
    """The AVIF sphere of `torch_fixtures/avif_scene` (phase 19 of
    chip_smoke.py trains it on the card): the port's
    `prepare_testbed_data` gives the JAX package's transform and prepared
    arrays, whose digests `expected.json` holds."""
    from rnb_neus2_torch.io import png
    from rnb_neus2_torch.io.dataloaders import load_data
    from rnb_neus2_torch.io.prepare import prepare_testbed_data
    from rnb_neus2_tpu.io.dataloaders import load_data as jload
    from rnb_neus2_tpu.io.prepare import prepare_testbed_data as jprepare

    kw = dict(albedo_sfm_path=str(SCENE / "albedos.sfm.json"),
              mask_sfm_path=str(SCENE / "masks.sfm.json"))
    prepare_testbed_data(load_data(str(SCENE / "normals.sfm.json"), **kw),
                         str(tmp_path / "port"))
    jprepare(jload(str(SCENE / "normals.sfm.json"), **kw),
             str(tmp_path / "jax"))
    expected = json.loads((SCENE / "expected.json").read_text())
    tj, jtj = (json.loads((tmp_path / d / "transform.json").read_text())
               for d in ("port", "jax"))
    assert tj["n2w"] == jtj["n2w"] == expected["n2w"]
    assert len(tj["frames"]) == len(expected["frames"]) == 16
    suffixes = {Path(v["path"]).suffix for k in ("normals", "albedos", "masks")
                for v in json.loads((SCENE / f"{k}.sfm.json").read_text())["views"]}
    assert suffixes == {".avif"}

    def digest(a):
        a = np.ascontiguousarray(a)
        return hashlib.sha256(f"{a.dtype}{a.shape}".encode()
                              + a.tobytes()).hexdigest()
    for fr, jfr in zip(tj["frames"], jtj["frames"]):
        want = expected["frames"][Path(fr["normal_path"]).name]
        for key in ("normal", "albedo"):
            got = png.read_png(tmp_path / "port" / fr[f"{key}_path"])
            jax = cv2.imread(str(tmp_path / "jax" / jfr[f"{key}_path"]),
                             cv2.IMREAD_UNCHANGED)[..., [2, 1, 0, 3]]
            np.testing.assert_array_equal(got, jax)
            assert digest(got) == want[key]
