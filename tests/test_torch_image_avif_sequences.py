"""AVIF sequences and scaled frames read as cv2 reads them.

The source rule: libavif's AVIF_DECODER_SOURCE_AUTO decodes the tracks of
a file whose major brand is `avis`, the primary item of one whose major
brand is `avif`, and for any other major brand the tracks where there are
any. A hand-built file whose primary item and first sample differ shows
which one each brand reads.

Sequences: cv2's own `imwriteanimation` files (RGB and RGBA with the
alpha track, 8, 10 and 12 bits, grey, lossless 4:4:4; frames after the
first differ from it), Pillow's `save_all` files, and hand-built
containers (`co64`, several chunks, one sample size, no `elst` or
`stss`, `prem`, an alpha track without `auxi` or listed first, a track
size that scales the frame) read as cv2 gives their first frame; what
libavif refuses (no sample table, no `stsd`, a chunk past the file, a
first sample that is no key frame, `stz2`, ...) is UnreadableImage, as
cv2 returns None.

Scaling: `native/scale.cc` equals libyuv's ScalePlane and ScalePlane_12
(called through ctypes in cv2's libavif) at every ratio class, and still
items whose `ispe` scales the frame down, up, by a non-integer ratio or
on one axis read as cv2 reads them at 8, 10 and 12 bits, with alpha.

Every case runs in cv2's three modes, and the port's `load_image` is held
against the JAX package's (a file cv2 cannot read raises
FileNotFoundError in both).
"""

import ctypes
import functools
import glob
import io
import os
import struct
import tempfile

import cv2
import numpy as np
import pytest

import torch_image_writers as tw
from rnb_neus2_torch.io import avif, image_io, native
from rnb_neus2_torch.io.errors import UnreadableImage

MODES = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "grey": cv2.IMREAD_GRAYSCALE}
BRANDS = (b"avis", b"mif1", b"miaf", b"msf1", b"iso8")


def like_cv2(path):
    """The port's read_image equals cv2.imread in the three modes (dtype
    and shape too), or raises UnreadableImage where cv2 gives None; its
    load_image equals the JAX package's."""
    from rnb_neus2_tpu.io import image_io as jimage_io
    readable = cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is not None
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
    if readable:
        np.testing.assert_array_equal(image_io.load_image(path),
                                      jimage_io.load_image(str(path)))
    else:
        for load in (image_io.load_image, jimage_io.load_image):
            with pytest.raises(FileNotFoundError):
                load(str(path))
    return readable


def _frames(seed, h, w, c, depth=8):
    """Three frames: a smooth texture with noise, then two others."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w].astype(np.float64)
    top = (1 << depth) - 1
    base = np.stack([0.5 + 0.4 * np.sin(x / (4 + k) + y / (7 + k)) for k in range(c)], -1)
    base = np.clip(base + rng.normal(0, 0.03, base.shape), 0, 1)
    out = [base, 1 - base, base[::-1] * 0.7]
    dtype = np.uint8 if depth == 8 else np.uint16
    return [np.ascontiguousarray((f * top).round().astype(dtype)[..., 0] if c == 1
                                 else (f * top).round().astype(dtype)) for f in out]


def cv2_sequence(frames, *params) -> bytes:
    anim = cv2.Animation()
    anim.frames = frames
    anim.durations = [100] * len(frames)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "seq.avif")
        assert cv2.imwriteanimation(path, anim, list(params))
        with open(path, "rb") as f:
            return f.read()


def tracks_of(blob):
    """[(track, [sample bytes])] of an AVIF sequence, in file order, read
    by the tests' own box walker."""
    return [(t, t["samples"]) for t in tw.sequence_tracks(blob)]


def entry_props(track):
    return track["props"]


def _write(tmp_path, blob, name="x.avif"):
    path = tmp_path / name
    path.write_bytes(blob)
    return path


# ------------------------------------------------------------------ source rule

@pytest.mark.parametrize("major", [b"mif1", b"avis", b"avif", b"miaf"])
def test_source_rule(tmp_path, major):
    """One file, a 3-frame track and a primary item that is another
    image: `avis` and any brand but `avif` read the track's first frame,
    `avif` the primary item, as cv2 does."""
    (track, samples), = tracks_of(cv2_sequence(_frames(1, 48, 64, 3)))
    ok, still = cv2.imencode(".avif", _frames(2, 48, 64, 3)[0])
    still = still.tobytes()
    c = avif.parse(still, "still")
    it = c.items[c.primary]
    item = dict(id=1, type=b"av01", data=avif.item_data(c, it, still, "still"),
                props=[tw.isobmff_box(k, b) for k, b in it.props])
    blob = tw.avis_file([dict(id=1, width=64, height=48, samples=samples,
                              props=entry_props(track))], items=[item], major=major)
    path = _write(tmp_path, blob)
    like_cv2(path)
    want_track = major != b"avif"
    frame = cv2.imread(str(_write(tmp_path, tw.avis_file(
        [dict(id=1, width=64, height=48, samples=samples, props=entry_props(track))],
        brands=BRANDS), "t.avif")), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(image_io.read_image(path)[..., ::-1],
                                  frame if want_track else cv2.imread(
                                      str(_write(tmp_path, still, "s.avif")),
                                      cv2.IMREAD_UNCHANGED))


# ------------------------------------------------------------------ sequences

@pytest.mark.parametrize("kind", ["rgb", "rgba", "10bit", "12bit", "rgba_10bit",
                                  "rgba_12bit", "grey", "grey_10bit", "lossless_444",
                                  "q30"])
def test_cv2_sequences(tmp_path, kind):
    """cv2.imwriteanimation's files: the first frame, as cv2.imread reads
    it (the later frames differ from it)."""
    depth = 12 if "12bit" in kind else 10 if "10bit" in kind else 8
    channels = 4 if "rgba" in kind else 1 if "grey" in kind else 3
    frames = _frames(len(kind), 40, 56, channels, depth)
    params = [cv2.IMWRITE_AVIF_DEPTH, depth]
    if kind == "lossless_444":
        params += [cv2.IMWRITE_AVIF_QUALITY, 100]
    if kind == "q30":
        params += [cv2.IMWRITE_AVIF_QUALITY, 30]
    blob = cv2_sequence(frames, *params)
    assert blob[8:12] == b"avis" and len(tracks_of(blob)) == (2 if channels == 4 else 1)
    assert like_cv2(_write(tmp_path, blob))


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_pillow_sequences(tmp_path, mode):
    from PIL import Image
    frames = [Image.fromarray(f, mode) for f in _frames(5, 36, 52, len(mode))]
    bio = io.BytesIO()
    frames[0].save(bio, "AVIF", save_all=True, append_images=frames[1:], quality=60)
    assert like_cv2(_write(tmp_path, bio.getvalue()))


@functools.lru_cache(maxsize=None)
def _rgba_tracks():
    (color, cs), (alpha, als) = tracks_of(cv2_sequence(_frames(7, 48, 64, 4)))
    return cs, entry_props(color), als, entry_props(alpha)


def _sequence(color=None, alpha=None):
    cs, cp, als, ap = _rgba_tracks()
    c = dict(id=1, width=64, height=48, samples=cs, props=cp)
    c.update(color or {})
    tracks = [c]
    if alpha is not False:
        a = dict(id=2, width=64, height=48, samples=als, props=ap, aux_for=1,
                 handler=b"auxv")
        a.update(alpha or {})
        tracks.append(a)
    return tw.avis_file(tracks, brands=BRANDS)


def _patched(blob, box, at, value):
    b = bytearray(blob)
    i = b.find(box)
    b[i + at:i + at + len(value)] = value
    return bytes(b)


def _variant(kind):
    cs, cp, als, ap = _rgba_tracks()
    return {
        "co64": lambda: _sequence(dict(co64=True), dict(co64=True)),
        "several_chunks": lambda: _sequence(dict(chunks=[1, 2]), dict(chunks=[1, 1, 1])),
        "one_sample_size": lambda: _sequence(dict(samples=[cs[0]] * 3, all_size=True), False),
        "no_elst": lambda: _sequence(dict(elst=False), dict(elst=False)),
        "prem": lambda: _sequence(dict(prem_by=2)),
        "no_auxi": lambda: _sequence(alpha=dict(props=[p for p in ap if p[4:8] != b"auxi"])),
        "alpha_track_first": lambda: tw.avis_file(
            [dict(id=2, width=64, height=48, samples=als, props=ap, aux_for=1),
             dict(id=1, width=64, height=48, samples=cs, props=cp)], brands=BRANDS),
        "no_stss": lambda: _sequence(dict(skip=[b"stss"])),
        "first_sample_not_listed_sync": lambda: _sequence(dict(stss=[2])),
        "no_colr": lambda: _sequence(dict(props=[p for p in cp if p[4:8] != b"colr"])),
        "stsd_version_1": lambda: _patched(_sequence(), b"stsd", 4, b"\x01"),
        "track_half_size": lambda: _sequence(dict(tkhd_size=(32, 24)), dict(tkhd_size=(32, 24))),
        "track_double_size": lambda: _sequence(dict(tkhd_size=(128, 96)), dict(tkhd_size=(128, 96))),
        "track_odd_size": lambda: _sequence(dict(tkhd_size=(61, 37)), dict(tkhd_size=(61, 37))),
        "track_one_axis": lambda: _sequence(dict(tkhd_size=(64, 30)), dict(tkhd_size=(64, 30))),
        # refused by libavif
        "empty_sample_table": lambda: _sequence(dict(samples=[], chunks=[])),
        "no_stsd": lambda: _sequence(dict(skip=[b"stsd"])),
        "no_stsc": lambda: _sequence(dict(skip=[b"stsc"])),
        "no_stsz": lambda: _sequence(dict(skip=[b"stsz"])),
        "no_stco": lambda: _sequence(dict(skip=[b"stco"])),
        "no_tkhd": lambda: _sequence(dict(skip=[b"tkhd"])),
        "stz2": lambda: _patched(_sequence(), b"stsz", 0, b"stz2"),
        "stsc_from_chunk_2": lambda: _patched(_sequence(), b"stsc", 12, struct.pack(">I", 2)),
        "stsz_version_1": lambda: _patched(_sequence(), b"stsz", 4, b"\x01"),
        "mdhd_version_2": lambda: _patched(_sequence(), b"mdhd", 4, b"\x02"),
        "tkhd_version_2": lambda: _patched(_sequence(), b"tkhd", 4, b"\x02"),
        "track_size_zero": lambda: _sequence(dict(tkhd_size=(0, 48))),
        "chunk_past_the_file": lambda: _patched(_sequence(), b"stco", 12, struct.pack(">I", 1 << 20)),
        "first_sample_not_a_key_frame": lambda: _sequence(dict(samples=cs[1:] + cs[:1]), False),
        "alpha_of_another_size": lambda: _sequence(alpha=dict(tkhd_size=(32, 24))),
        "no_av1C": lambda: _sequence(dict(props=[p for p in cp if p[4:8] != b"av1C"]), False),
        "avis_without_moov": lambda: cv2.imencode(".avif", _frames(3, 16, 16, 3)[0])[1]
        .tobytes().replace(b"miaf", b"avis", 1),
    }[kind]()


READ = ["co64", "several_chunks", "one_sample_size", "no_elst", "prem", "no_auxi",
        "alpha_track_first", "no_stss", "first_sample_not_listed_sync", "no_colr",
        "stsd_version_1", "track_half_size", "track_double_size", "track_odd_size",
        "track_one_axis"]
REFUSED = ["empty_sample_table", "no_stsd", "no_stsc", "no_stsz", "no_stco", "no_tkhd",
           "stz2", "stsc_from_chunk_2", "stsz_version_1", "mdhd_version_2",
           "tkhd_version_2", "track_size_zero", "chunk_past_the_file",
           "first_sample_not_a_key_frame", "alpha_of_another_size", "no_av1C",
           "avis_without_moov"]


@pytest.mark.parametrize("kind", READ + REFUSED)
def test_hand_built_sequences(tmp_path, kind):
    """Containers written box by box around cv2's RGBA samples: the ones
    libavif reads equal cv2, the ones it refuses are UnreadableImage."""
    assert like_cv2(_write(tmp_path, _variant(kind))) == (kind in READ)


# ------------------------------------------------------------------ scaling

def _libyuv():
    libs = glob.glob(os.path.join(os.path.dirname(cv2.__file__), os.pardir,
                                  "opencv_python.libs", "libavif-*.so*"))
    return ctypes.CDLL(libs[0])


def libyuv_scale(plane, w, h, deep):
    """libyuv's ScalePlane (8-bit) or ScalePlane_12, kFilterBox."""
    lib = _libyuv()
    sh, sw = plane.shape
    dtype = np.uint16 if deep else np.uint8
    src = np.ascontiguousarray(plane, dtype)
    dst = np.zeros((h, w), dtype)
    fn = lib.ScalePlane_12 if deep else lib.ScalePlane   # strides in samples
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] + [ctypes.c_int] * 4
    fn(src.ctypes.data_as(ctypes.c_void_p), sw, sw, sh,
       dst.ctypes.data_as(ctypes.c_void_p), w, w, h, 3)
    return dst.astype(np.uint16)


# source sizes and target factors that reach each of libyuv's routines:
# copy, vertical only, 3/4, 1/2, 3/8, 1/4, box, 2x linear and bilinear,
# bilinear up and down, point sampling (one axis by 1/3)
SOURCES = [(64, 48), (33, 25), (96, 64), (306, 256), (5, 9), (3, 1)]
FACTORS = [0.125, 0.25, 1 / 3, 0.375, 0.49, 0.5, 0.6, 0.75, 1, 1.1, 1.5, 2, 2.5, 4]


@pytest.mark.parametrize("deep", [0, 1], ids=["8bit", "12bit"])
def test_scaler_is_libyuvs(deep):
    rng = np.random.default_rng(deep)
    for sw, sh in SOURCES:
        src = rng.integers(0, 4096 if deep else 256, (sh, sw))
        sizes = {(max(1, round(sw * fx)), max(1, round(sh * fy)))
                 for fx in FACTORS for fy in FACTORS}
        for w, h in sorted(sizes):
            np.testing.assert_array_equal(
                native.scale_plane(src, w, h, 12 if deep else 8),
                libyuv_scale(src, w, h, deep), err_msg=f"{sw}x{sh} -> {w}x{h}")


def _with_ispe(blob, sizes):
    b, pos = bytearray(blob), 0
    for w, h in sizes:
        i = b.find(b"ispe", pos)
        b[i + 8:i + 16] = struct.pack(">II", w, h)
        pos = i + 4
    return bytes(b)


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("alpha", [False, True], ids=["rgb", "rgba"])
def test_ispe_scales_the_frame(tmp_path, depth, alpha):
    """A 64x48 item whose ispe (its alpha item's too) says another size:
    down, up, non-integer, one axis, odd; a zero size, or an alpha item
    scaled to another size than the colour, is refused."""
    frame = _frames(depth, 48, 64, 4 if alpha else 3, depth)[0]
    ok, blob = cv2.imencode(".avif", frame, [cv2.IMWRITE_AVIF_DEPTH, depth])
    blob = blob.tobytes()
    n = blob.count(b"ispe")
    for size in [(32, 24), (128, 96), (60, 40), (64, 30), (100, 48), (17, 13),
                 (24, 18), (16, 12), (65, 49)]:
        assert like_cv2(_write(tmp_path, _with_ispe(blob, [size] * n))), size
    assert not like_cv2(_write(tmp_path, _with_ispe(blob, [(0, 48)] * n)))
    if alpha:
        assert not like_cv2(_write(tmp_path, _with_ispe(blob, [(64, 48), (32, 24)])))
