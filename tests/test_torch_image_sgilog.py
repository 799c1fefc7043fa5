"""TIFF SGILog (34676) and SGILog24 (34677), read as cv2 reads them
(libtiff 4.7.1's tif_luv.c under OpenCV 5's TIFF decoder).

Files are written by the host's libtiff through ctypes
(`torch_image_writers.libtiff_sgilog`) from float XYZ or Y, at sizes
whose strips and tiles end part-way, and held against cv2 in its three
read modes, exactly: LogLuv as float XYZ converted to RGB under
IMREAD_UNCHANGED (cvtColor's XYZ2BGR), otherwise through libtiff's RGBA
interface (XYZtoRGB24, L16toGry). Also the cases that libtiff decodes
from partial data, the tags cv2 refuses, and the uv table against the
libtiff in cv2.
"""

import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import torch_image_writers as tw
from rnb_neus2_torch.io import image_io
from rnb_neus2_torch.io.errors import UnreadableImage, UnsupportedImage

MODES = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "grey": cv2.IMREAD_GRAYSCALE}
REPO = Path(__file__).resolve().parents[1]


def _cv2(path, mode):
    try:
        img = cv2.imread(str(path), MODES[mode])
    except cv2.error:
        return None
    if img is not None and img.ndim == 3:
        img = img[..., ::-1]
    return img


def _like_cv2(path):
    """Every mode equals cv2's decode, or both refuse. → the modes read."""
    read = []
    for mode in MODES:
        want = _cv2(path, mode)
        if want is None:
            with pytest.raises(UnreadableImage):
                image_io.read_image(path, mode)
            continue
        got = image_io.read_image(path, mode)
        assert (got.dtype, got.shape) == (want.dtype, want.shape), mode
        np.testing.assert_array_equal(got, want, err_msg=mode)
        read.append(mode)
    return read


def _xyz(seed, h, w):
    """Smooth colours, dark to past 1, with zeros and saturated spots."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w].astype(np.float32)
    xyz = np.stack([0.5 + 0.4 * np.sin(x / 5 + c) * np.cos(y / 7 - c)
                    for c in range(3)], -1) ** 2 * 1.8
    xyz *= rng.uniform(0.5, 1.5, (h, w, 1)).astype(np.float32)
    xyz[rng.random((h, w)) < 0.05] = 0
    xyz[rng.random((h, w)) < 0.05] *= 50
    return xyz.astype(np.float32)


@pytest.mark.parametrize("kind", ["luv32", "luv24", "logl"])
@pytest.mark.parametrize("h,w,layout", [
    (1, 1, None), (9, 70, 4), (33, 17, (16, 16)), (40, 41, (32, 16))])
def test_sgilog_reads_as_cv2(tmp_path, kind, h, w, layout):
    xyz = _xyz(h * 100 + w, h, w)
    data = xyz if kind != "logl" else xyz[..., 1] * np.where(
        np.arange(w) % 3 == 0, -1, 1)
    path = tmp_path / "s.tif"
    tiled = isinstance(layout, tuple)
    tw.libtiff_sgilog(path, data, 34677 if kind == "luv24" else 34676,
                      rows_per_strip=None if tiled else layout,
                      tile=layout if tiled else None)
    assert _like_cv2(path) == list(MODES)


def _set_tag(blob: bytes, tag: int, value: int) -> bytes:
    """A little-endian TIFF with every value of SHORT tag `tag` set."""
    b = bytearray(blob)
    off = struct.unpack_from("<I", b, 4)[0]
    for i in range(struct.unpack_from("<H", b, off)[0]):
        t, typ, n, v = struct.unpack_from("<HHII", b, off + 2 + 12 * i)
        if t == tag:
            at = off + 2 + 12 * i + 8 if n <= 2 else v
            struct.pack_into(f"<{n}H", b, at, *[value] * n)
    return bytes(b)


@pytest.mark.parametrize("kind,fmt", [("luv32", 1), ("logl", 1),
                                      ("logl", 3)])
def test_sample_formats(tmp_path, kind, fmt):
    """SampleFormat decides LogL's type under IMREAD_UNCHANGED (uint8 for
    1, int8 for libtiff's 2); cv2 refuses float LogL."""
    data = _xyz(5, 12, 20)
    blob = tw.libtiff_sgilog(tmp_path / "a.tif",
                             data if kind == "luv32" else data[..., 1])
    path = tmp_path / "b.tif"
    path.write_bytes(_set_tag(blob, 339, fmt))
    assert _like_cv2(path) == ([] if fmt == 3 else list(MODES))


@pytest.mark.parametrize("kind", ["luv32", "luv24", "logl"])
def test_data_that_ends_inside_a_row(tmp_path, kind):
    """The second of three strips cut short: libtiff's RGBA interface
    keeps the rows it decoded and zeros the rest of that strip (the port
    too); LogLuv read as float is refused by name."""
    data = _xyz(7, 12, 30)
    blob = tw.libtiff_sgilog(tmp_path / "a.tif",
                             data if kind != "logl" else data[..., 1],
                             34677 if kind == "luv24" else 34676,
                             rows_per_strip=4)
    off = struct.unpack_from("<I", blob, 4)[0]
    entries = {}
    for i in range(struct.unpack_from("<H", blob, off)[0]):
        t, typ, n, v = struct.unpack_from("<HHII", blob, off + 2 + 12 * i)
        entries[t] = (n, v)
    counts_at = entries[279][1]
    count = struct.unpack_from("<I", blob, counts_at + 4)[0]
    path = tmp_path / "b.tif"
    path.write_bytes(blob[:counts_at + 4] + struct.pack("<I", count * 2 // 3)
                     + blob[counts_at + 8:])
    for mode in ("color", "grey") + (("unchanged",) if kind == "logl"
                                     else ()):
        got, want = image_io.read_image(path, mode), _cv2(path, mode)
        np.testing.assert_array_equal(got, want, err_msg=mode)
        assert not want[4:8].all()
    if kind != "logl":
        with pytest.raises(UnsupportedImage, match="ends inside a row"):
            image_io.read_image(path, "unchanged")


def test_uv_table_is_libtiffs():
    """native/sgilog_uv.h is libtiff's uv_row as cv2's libtiff holds it."""
    out = subprocess.run([sys.executable, str(REPO / "tests" /
                                              "torch_sgilog_table.py"),
                          "--check"], capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_committed_scene_prepares_as_jax(tmp_path):
    """The sphere of `torch_fixtures/sgilog_scene` (SGILog and SGILog24
    albedos, grid AVIF normals, PNG masks; phase 19 of chip_smoke.py
    trains it on the card): the port's `prepare_testbed_data` gives the
    JAX package's transform and prepared arrays, whose digests
    `expected.json` holds."""
    import hashlib
    import json

    from rnb_neus2_torch.io import png
    from rnb_neus2_torch.io.dataloaders import load_data
    from rnb_neus2_torch.io.prepare import prepare_testbed_data
    from rnb_neus2_tpu.io.dataloaders import load_data as jload
    from rnb_neus2_tpu.io.prepare import prepare_testbed_data as jprepare

    scene = REPO / "tests" / "torch_fixtures" / "sgilog_scene"
    kw = dict(albedo_sfm_path=str(scene / "albedos.sfm.json"),
              mask_sfm_path=str(scene / "masks.sfm.json"))
    prepare_testbed_data(load_data(str(scene / "normals.sfm.json"), **kw),
                         str(tmp_path / "port"))
    jprepare(jload(str(scene / "normals.sfm.json"), **kw),
             str(tmp_path / "jax"))
    expected = json.loads((scene / "expected.json").read_text())
    tj, jtj = (json.loads((tmp_path / d / "transform.json").read_text())
               for d in ("port", "jax"))
    assert tj["n2w"] == jtj["n2w"] == expected["n2w"]
    assert len(tj["frames"]) == len(expected["frames"]) == 16
    views = {k: json.loads((scene / f"{k}.sfm.json").read_text())["views"]
             for k in ("normals", "albedos", "masks")}
    assert {Path(v["path"]).suffix for v in views["normals"]} == {".avif"}
    assert {Path(v["path"]).suffix for v in views["albedos"]} == {".tif"}
    codes = {struct.unpack_from("<H", _tag_value(scene / v["path"], 259))[0]
             for v in views["albedos"]}
    assert codes == {34676, 34677}

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


def _tag_value(path, tag) -> bytes:
    """The 4 value bytes of a little-endian TIFF's first-IFD entry."""
    blob = Path(path).read_bytes()
    off = struct.unpack_from("<I", blob, 4)[0]
    for i in range(struct.unpack_from("<H", blob, off)[0]):
        if struct.unpack_from("<H", blob, off + 2 + 12 * i)[0] == tag:
            return blob[off + 2 + 12 * i + 8:off + 2 + 12 * i + 12]
    raise KeyError(tag)
