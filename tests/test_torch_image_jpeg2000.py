"""JPEG 2000 read as cv2 reads it (`io/jpeg2000.py`): JP2 files and raw
codestreams held against cv2.imread in its three read modes, exactly, 9/7
files included (no fixture differs).

Writers: cv2.imwrite (its default, lossy rate and the lossless
IMWRITE_JPEG2000_COMPRESSION_X1000 = 1000), PIL (tiles, layers, precincts,
code-block sizes, resolutions, PLT and COM) and PIL's own libopenjp2
through ctypes (`torch_image_writers.openjpeg_encode`) for what PIL hides:
every progression order with precincts, layers and tiles, POC, each
code-block style (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM), SOP/EPH,
RGN, tile-parts, odd tile sizes, 12- and 20-bit and mixed precisions,
sYCC, signed and subsampled components, image offsets. The test writers
also wrap codestreams in JP2 boxes (palettes, channel definitions, colour
spaces) and move packet headers into PPM/PPT segments. OpenJPEG's encoder
refuses more resolutions than a small image has levels, so the cases stop
at 7. Sizes stay at most 64 px a side.
"""

import struct

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

import torch_image_writers as tw
from rnb_neus2_torch.io import image_io
from rnb_neus2_torch.io.errors import UnreadableImage

H, W = 61, 47
MODES = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "grey": cv2.IMREAD_GRAYSCALE}


def _cv2(path, mode):
    try:
        img = cv2.imread(str(path), MODES[mode])
    except cv2.error:
        return None
    if img is not None and img.ndim == 3 and img.shape[2] in (3, 4):
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def _like_cv2(path):
    read = []
    for mode in MODES:
        want = _cv2(path, mode)
        if want is None:
            with pytest.raises(UnreadableImage):
                image_io.read_image(path, mode)
            continue
        got = image_io.read_image(path, mode)
        assert got.dtype == want.dtype and got.shape == want.shape, mode
        np.testing.assert_array_equal(got, want, err_msg=mode)
        read.append(mode)
    return read


def _planes(n=3, scale=1, seed=0):
    """Smooth gradients, a checker of xor and noise: every band gets
    coefficients."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:H, :W]
    base = [(x * 4 + y) % 256, (y * 6 + rng.integers(0, 20, (H, W))) % 256,
            ((x ^ y) * 3) % 256, (x * y) % 256]
    return [(b * scale + rng.integers(0, scale, (H, W))).astype(np.int64)
            for b in base[:n]]


def _rgb8(n=3):
    return np.stack(_planes(n), -1).astype(np.uint8)


LAYERS = dict(rates=[20, 5, 1])
TILED = dict(tile_size_on=1, cp_tdx=32, cp_tdy=40, numresolution=4)
STYLES = {"bypass": 1, "reset": 2, "termall": 4, "vsc": 8, "pterm": 16,
          "segsym": 32, "all": 63}
OPJ_CASES = {
    "default": dict(tcp_mct=1),
    "irreversible": dict(tcp_mct=1, irreversible=1),
    "layers_dB": dict(tcp_mct=1, irreversible=1, quality=[20, 30, 45]),
    "rgn": dict(tcp_mct=1, irreversible=1, roi_compno=0, roi_shift=5,
                rates=[20]),
    "sop_eph": dict(tcp_mct=1, csty=6, **LAYERS),
    "poc": dict(tcp_mct=1, poc=[(0, 0, 1, 3, 3, "RPCL"),
                                (0, 0, 3, 6, 3, "LRCP")],
                precincts=[(32, 32), (16, 16)], **LAYERS),
    "poc_by_component": dict(tcp_mct=1, poc=[(0, 0, 3, 6, 1, "CPRL"),
                                             (0, 1, 3, 6, 3, "RLCP")],
                             **LAYERS),
    "tile_parts": dict(tcp_mct=1, tp_on=1, tp_flag=ord("R"), **TILED),
    "odd_tiles": dict(tcp_mct=1, tile_size_on=1, cp_tdx=17, cp_tdy=13,
                      numresolution=3),
    "odd_tiles_97": dict(tcp_mct=1, irreversible=1, tile_size_on=1,
                         cp_tdx=17, cp_tdy=13, numresolution=3, rates=[4]),
    "small_cblk": dict(tcp_mct=1, cblockw_init=4, cblockh_init=16,
                       numresolution=2),
    "one_resolution": dict(tcp_mct=1, numresolution=1),
    "seven_resolutions": dict(tcp_mct=1, irreversible=1, numresolution=6),
    "no_mct": dict(irreversible=1),
    "tlm_plt": dict(tcp_mct=1, extra=["TLM=YES", "PLT=YES"], **TILED),
}
for _p in tw.PROGRESSION_ORDERS:
    for _irr in (0, 1):
        OPJ_CASES[f"{_p}_{'97' if _irr else '53'}"] = dict(
            tcp_mct=1, irreversible=_irr, prog_order=_p,
            precincts=[(16, 16), (16, 16), (32, 32)], **LAYERS, **TILED)
for _s, _mode in STYLES.items():
    OPJ_CASES[f"style_{_s}"] = dict(tcp_mct=1, irreversible=1, mode=_mode,
                                    **LAYERS)


@pytest.mark.parametrize("case", sorted(OPJ_CASES))
def test_openjpeg_encoder_options_match_cv2(tmp_path, case):
    path = tmp_path / f"{case}.jp2"
    tw.openjpeg_encode(path, _planes(), **OPJ_CASES[case])
    assert _like_cv2(path) == list(MODES)


PIL_CASES = {
    "rgb_53": dict(mode="RGB"),
    "rgb_97": dict(mode="RGB", irreversible=True),
    "rgba_53": dict(mode="RGBA"),
    "rgba_97": dict(mode="RGBA", irreversible=True),
    "grey_53": dict(mode="L"),
    "grey_97_j2k": dict(mode="L", irreversible=True, no_jp2=True),
    "grey16_53": dict(mode="I;16"),
    "grey16_97": dict(mode="I;16", irreversible=True),
    "tiles": dict(mode="RGB", tile_size=(16, 24)),
    "layers": dict(mode="RGB", quality_mode="rates",
                   quality_layers=[40, 10, 1]),
    "precincts": dict(mode="RGB", precinct_size=(32, 32),
                      codeblock_size=(8, 8)),
    "plt_comment": dict(mode="RGB", plt=True, comment="fixture",
                        no_jp2=True),
}


@pytest.mark.parametrize("case", sorted(PIL_CASES))
def test_pil_files_match_cv2(tmp_path, case):
    kw = dict(PIL_CASES[case])
    mode = kw.pop("mode")
    if mode == "I;16":
        img = Image.fromarray((_planes(1, 257)[0]).astype(np.uint16))
    else:
        img = Image.fromarray(_rgb8({"RGB": 3, "RGBA": 4, "L": 1}[mode])
                              .squeeze())
    path = tmp_path / f"{case}.jp2"
    img.save(path, "JPEG2000", **kw)
    read = _like_cv2(path)
    assert read == (["unchanged", "grey"] if mode != "RGB" and "no_jp2" in kw
                    else list(MODES))


@pytest.mark.parametrize("case", ["default_8", "lossless_8", "lossless_16",
                                  "lossless_16_rgba", "default_16",
                                  "default_grey", "default_rgba"])
def test_cv2_written_files_match_cv2(tmp_path, case):
    """cv2.imwrite's default rate is lossy (the 9/7 wavelet);
    IMWRITE_JPEG2000_COMPRESSION_X1000 = 1000 is lossless (5/3)."""
    n = 4 if "rgba" in case else 1 if "grey" in case else 3
    img = np.stack(_planes(n, 257 if "16" in case else 1), -1)
    img = img.astype(np.uint16 if "16" in case else np.uint8).squeeze()
    params = [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000] \
        if "lossless" in case else []
    path = tmp_path / f"{case}.jp2"
    assert cv2.imwrite(str(path), img, params)
    assert _like_cv2(path) == list(MODES)
    if "lossless" in case:
        got = image_io.read_image(path)
        np.testing.assert_array_equal(got, img[..., [2, 1, 0, 3][:n]]
                                      if n > 1 else img)


@pytest.mark.parametrize("case", ["ppt", "ppm"])
def test_packed_packet_headers_match_cv2(tmp_path, case):
    cs = tw.openjpeg_encode(tmp_path / "sop.j2k", _planes(), jp2=False,
                            tcp_mct=1, csty=6, tp_on=1, tp_flag=ord("R"),
                            **LAYERS, **TILED)
    path = tmp_path / f"{case}.j2k"
    path.write_bytes(tw.packed_headers(cs, case))
    assert _like_cv2(path) == list(MODES)


def _palette_file(tmp_path, bits=8):
    y, x = np.mgrid[:H, :W]
    idx = (x // 5 + y // 7) % 6
    table = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255], [9, 99, 199],
                      [250, 200, 100], [1, 2, 3]]) * ((1 << bits) - 1) // 255
    cs = tw.openjpeg_encode(tmp_path / "idx.j2k", [idx], jp2=False,
                            numresolution=2)
    return tw.jp2_file(cs, H, W, 1, 8, pclr=(table, [bits] * 3),
                       cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)])


def _jp2_case(tmp_path, case):
    rgb = _planes()
    cs3 = tw.openjpeg_encode(tmp_path / "c3.j2k", rgb, jp2=False, tcp_mct=1)
    if case == "palette":
        return _palette_file(tmp_path)
    if case == "palette_12bit":
        return _palette_file(tmp_path, 12)
    if case == "cdef_bgr":
        return tw.jp2_file(cs3, H, W, 3, 8,
                           cdef=[(0, 0, 3), (1, 0, 2), (2, 0, 1)])
    if case == "cdef_alpha_first":
        cs4 = tw.openjpeg_encode(tmp_path / "c4.j2k", _planes(4)[::-1],
                                 jp2=False)
        return tw.jp2_file(cs4, H, W, 4, 8, cdef=[(0, 1, 0), (1, 0, 1),
                                                  (2, 0, 2), (3, 0, 3)])
    if case == "colr_cmyk":
        return tw.jp2_file(cs3, H, W, 3, 8, enumcs=12)
    kw = {"grey_colr": dict(comps=rgb[:1], colour=2),
          "grey_alpha": dict(comps=rgb[:2], colour=2),
          "sycc": dict(comps=rgb, colour=3),
          "sycc_12bit": dict(comps=_planes(3, 16), colour=3, prec=12),
          "bits_12": dict(comps=_planes(3, 16), prec=12, tcp_mct=1),
          "bits_12_grey_j2k": dict(comps=_planes(1, 16), prec=12,
                                   jp2=False),
          "bits_mixed": dict(comps=[rgb[0], rgb[1] * 16, rgb[2]],
                             prec=[8, 12, 8]),
          "bits_20": dict(comps=_planes(3, 4096), prec=20),
          "bits_4": dict(comps=[c >> 4 for c in rgb], prec=4),
          "signed": dict(comps=[c - 128 for c in rgb], signed=True),
          "subsampled": dict(comps=[rgb[0], rgb[1][::2, ::2],
                                    rgb[2][::2, ::2]],
                             sub=[(1, 1), (2, 2), (2, 2)], colour=3),
          "image_offset": dict(comps=rgb, origin=(4, 3)),
          "five_components": dict(comps=_planes(4) + rgb[:1],
                                  tcp_mct=1)}[case]
    return tw.openjpeg_encode(tmp_path / "f.jp2", kw.pop("comps"), **kw)


# case → the modes cv2 reads
JP2_CASES = {
    "palette": list(MODES), "palette_12bit": list(MODES),
    "cdef_bgr": list(MODES), "cdef_alpha_first": list(MODES),
    "grey_colr": list(MODES), "grey_alpha": ["color", "grey"],
    "sycc": list(MODES), "sycc_12bit": list(MODES), "bits_12": list(MODES),
    "bits_12_grey_j2k": ["unchanged", "grey"], "bits_mixed": list(MODES),
    "bits_20": ["color", "grey"], "bits_4": [], "signed": [],
    "subsampled": [], "image_offset": [], "five_components": [],
    "colr_cmyk": []}


@pytest.mark.parametrize("case", sorted(JP2_CASES))
def test_boxes_depths_and_refusals_match_cv2(tmp_path, case):
    path = tmp_path / f"{case}.jp2"
    path.write_bytes(_jp2_case(tmp_path, case))
    assert _like_cv2(path) == JP2_CASES[case]


def test_repeated_ppt_index_is_unreadable(tmp_path):
    """OpenJPEG refuses a tile whose PPT segments repeat an index."""
    cs = tw.openjpeg_encode(tmp_path / "sop.j2k", _planes(), jp2=False,
                            tcp_mct=1, csty=6, tp_on=1, tp_flag=ord("R"),
                            **TILED)
    good = tw.packed_headers(cs, "ppt")
    bad = bytearray(good)
    at = 0
    while True:
        at = bad.find(b"\xff\x61", at + 1)
        if at < 0:
            break
        bad[at + 4] = 0
    path = tmp_path / "bad.j2k"
    path.write_bytes(bytes(bad))
    assert _like_cv2(path) == []


@pytest.mark.parametrize("keep", [0.3, 0.6, 0.9])
def test_truncated_codestream_is_unreadable(tmp_path, keep):
    """OpenJPEG's strict decoder fails a tile whose packets run past its
    data; cv2 returns None."""
    cs = tw.openjpeg_encode(tmp_path / "a.j2k", _planes(), jp2=False,
                            tcp_mct=1, **LAYERS)
    path = tmp_path / "cut.j2k"
    path.write_bytes(cs[:int(len(cs) * keep)])
    assert _like_cv2(path) == []


def test_opj_parameter_offsets():
    """The ctypes writer's view of opj_cparameters_t agrees with
    OpenJPEG's defaults (6 resolutions, 64x64 code-blocks, no ROI)."""
    p = tw.opj_parameters()
    got = {k: struct.unpack_from("<" + c, p, at)[0]
           for k, (at, c) in tw.OPJ_FIELDS.items()}
    assert (got["numresolution"], got["cblockw_init"], got["cblockh_init"],
            got["roi_compno"], got["mode"]) == (6, 64, 64, -1, 0)
    assert struct.unpack_from("<2i", p, 18204) == (-1, -1)


def test_jpeg2000_is_not_written_yet(tmp_path):
    """The JP2 writer, which this test once found missing, now round-trips
    through the port's reader: losslessly under OpenJPEG's rate cap, in
    RGB, RGBA and 16-bit grey; and a side under 32 pixels, which OpenJPEG
    refuses at cv2's 5 levels, raises and writes nothing."""
    y, x = np.mgrid[:H, :W]
    ramps = np.stack([x * 4 + y, y * 3 + 20, x * 2 + y * 2, 255 - y], -1)
    for img in (ramps[..., :3].astype(np.uint8), ramps.astype(np.uint8),
                (ramps[..., 0] * 160).astype(np.uint16)):
        image_io.write_raw(tmp_path / "a.jp2", img)
        np.testing.assert_array_equal(
            image_io.read_image(tmp_path / "a.jp2"), img)
    with pytest.raises(ValueError, match="32 pixels"):
        image_io.write_raw(tmp_path / "b.jp2", np.zeros((4, 40, 3), np.uint8))
    assert not (tmp_path / "b.jp2").exists()


def test_committed_scene_prepares_as_jax(tmp_path):
    """The JPEG 2000 / Group 4 sphere of `torch_fixtures/jp2_scene`
    (phase 19 of chip_smoke.py trains it on the card): the port's
    `prepare_testbed_data` gives the JAX package's transform and
    prepared arrays, whose digests `expected.json` holds."""
    import hashlib
    import json
    from pathlib import Path

    from rnb_neus2_torch.io import png
    from rnb_neus2_torch.io.dataloaders import load_data
    from rnb_neus2_torch.io.prepare import prepare_testbed_data
    from rnb_neus2_tpu.io.dataloaders import load_data as jload
    from rnb_neus2_tpu.io.prepare import prepare_testbed_data as jprepare

    scene = Path(__file__).parent / "torch_fixtures" / "jp2_scene"
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


@pytest.mark.parametrize("kind,w,h", [("j2k", (1 << 20) + 1, 61),
                                      ("tif", (1 << 20) + 1, 1),
                                      ("tif", 1 << 15, (1 << 15) + 1)])
def test_images_past_cv2s_size_limits_are_unreadable(tmp_path, kind, w, h):
    """cv2's imread refuses an image wider or taller than 2^20 or of more
    than 2^30 pixels before it decodes it (validateInputImageSize)."""
    path = tmp_path / f"big.{kind}"
    if kind == "j2k":
        cs = bytearray(tw.openjpeg_encode(tmp_path / "a.j2k", _planes(1),
                                          jp2=False))
        struct.pack_into(">II", cs, 8, w, h)
        path.write_bytes(bytes(cs))
    else:
        path.write_bytes(tw.tiff_file(
            {256: (4, [w]), 257: (4, [h]), 258: (3, [8]), 259: (3, [1]),
             262: (3, [1]), 277: (3, [1]), 278: (4, [1])}, [bytes(16)]))
    assert _like_cv2(path) == []
