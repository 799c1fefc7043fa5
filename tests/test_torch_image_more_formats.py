"""BMP, PNM/PAM/PFM, Radiance HDR, Sun raster, GIF and WebP read as cv2
reads them, and the exact writers' bytes against cv2.imwrite's.

Every file is held against cv2 in its three read modes (IMREAD_UNCHANGED,
_COLOR, _GRAYSCALE), exactly; where cv2 returns None the port must raise
UnreadableImage, asserted beside cv2's None on the same bytes. Files that
neither cv2 nor PIL writes come from `torch_image_writers.py`. Small
sizes (at most 64x64) keep the file fast.
"""

import io
import json
import os
import struct

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

import rnb_neus2_tpu.io.image_io as jimage_io
import rnb_neus2_tpu.io.prepare as jprepare
import torch_image_writers as tw
from rnb_neus2_torch.io import image_io, png, prepare
from rnb_neus2_torch.io.errors import UnreadableImage, UnsupportedImage

H, W = 23, 29
MODES = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "grey": cv2.IMREAD_GRAYSCALE}


def _cv2(path, mode):
    """cv2.imread in RGB(A) order; None where cv2 returns None or raises."""
    try:
        img = cv2.imread(str(path), MODES[mode])
    except cv2.error:
        return None
    if img is not None and img.ndim == 3 and img.shape[2] in (3, 4):
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def _like_cv2(tmp_path, blob, suffix=".bin", name="f"):
    """Every mode: the port's array equals cv2's in dtype, shape and every
    sample, or both refuse. → the modes cv2 read."""
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
        assert got.dtype == want.dtype and got.shape == want.shape, \
            (mode, got.dtype, got.shape, want.dtype, want.shape)
        if want.dtype == np.float32:
            np.testing.assert_array_equal(
                np.ascontiguousarray(got).view(np.uint32),
                np.ascontiguousarray(want).view(np.uint32), err_msg=mode)
        else:
            np.testing.assert_array_equal(got, want, err_msg=mode)
        read.append(mode)
    return read


def _smooth(rng, shape, top=255, dtype=np.uint8):
    y, x = np.mgrid[:shape[0], :shape[1]]
    ch = shape[2] if len(shape) == 3 else 1
    base = np.stack([0.5 + 0.45 * np.sin(x / 5.0 + 2 * c) * np.cos(y / 4.0 + c)
                     for c in range(ch)], -1)
    img = np.clip(base + rng.normal(0, 0.03, base.shape), 0, 1)
    return np.round(img * top).astype(dtype).reshape(shape)


def _pil(img, fmt, **kw):
    bio = io.BytesIO()
    img.save(bio, fmt, **kw)
    return bio.getvalue()


# ---------------------------------------------------------------------- BMP
def _palette(rng, n, grey=False):
    if grey:
        return np.repeat(np.sort(rng.integers(0, 256, n))[:, None], 3, 1)
    return rng.integers(0, 256, (n, 3))


def _bmp_cases():
    rng = np.random.default_rng(1)
    out = {}
    for bits in (1, 4, 8):
        n = 1 << bits
        idx = rng.integers(0, n, (H, W))
        for grey in (False, True):
            pal = _palette(rng, n, grey)
            key = f"pal{bits}_{'grey' if grey else 'colour'}"
            out[key] = tw.bmp_file(W, H, bits, tw.bmp_rows(idx, bits),
                                   palette=pal)
        out[f"pal{bits}_os2"] = tw.bmp_file(W, H, bits, tw.bmp_rows(idx, bits),
                                            header=12, palette=pal)
    idx = rng.integers(0, 12, (H, W))
    out["pal8_clrused12"] = tw.bmp_file(W, H, 8, tw.bmp_rows(idx, 8),
                                        palette=_palette(rng, 12),
                                        clrused=12)
    out["pal8_top_down"] = tw.bmp_file(W, H, 8, tw.bmp_rows(idx[::-1], 8),
                                       palette=_palette(rng, 256),
                                       top_down=True)
    rgb = _smooth(rng, (H, W, 3))
    raw24 = tw.bmp_rows(rgb[..., ::-1].reshape(H, -1), 8)
    out["rgb24"] = tw.bmp_file(W, H, 24, raw24)
    out["rgb24_v5"] = tw.bmp_file(W, H, 24, raw24, header=124)
    out["rgb24_os2"] = tw.bmp_file(W, H, 24, raw24, header=12)
    out["rgb24_top_down"] = tw.bmp_file(
        W, H, 24, tw.bmp_rows(rgb[::-1, :, ::-1].reshape(H, -1), 8),
        top_down=True)
    bgra = _smooth(rng, (H, W, 4))
    raw32 = tw.bmp_rows(bgra.reshape(H, -1), 8)
    out["bgra32_rgb"] = tw.bmp_file(W, H, 32, raw32)
    out["bgra32_bitfields"] = tw.bmp_file(
        W, H, 32, raw32, compression=3,
        masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    for hd in (56, 108, 124):
        out[f"bgra32_v{hd}"] = tw.bmp_file(
            W, H, 32, raw32, header=hd, compression=3,
            masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000))
    out["bgra32_v5_no_alpha_mask"] = tw.bmp_file(
        W, H, 32, raw32, header=124, compression=3,
        masks=(0xFF0000, 0xFF00, 0xFF, 0))
    v = rng.integers(0, 1 << 16, (H, W))
    out["rgb555"] = tw.bmp_file(W, H, 16, tw.bmp_rows(v & 0x7FFF, 16))
    out["rgb555_bitfields"] = tw.bmp_file(W, H, 16, tw.bmp_rows(v, 16),
                                          compression=3,
                                          masks=(0x7C00, 0x3E0, 0x1F))
    out["rgb565_bitfields"] = tw.bmp_file(W, H, 16, tw.bmp_rows(v, 16),
                                          compression=3,
                                          masks=(0xF800, 0x7E0, 0x1F))
    out["rgb565_v4"] = tw.bmp_file(W, H, 16, tw.bmp_rows(v, 16), header=108,
                                   compression=3,
                                   masks=(0xF800, 0x7E0, 0x1F, 0))
    runs = np.repeat(rng.integers(0, 16, (H, 6)), 5, 1)[:, :W]
    runs[:, 10:14] = rng.integers(0, 16, (H, 4))
    for bits, rle in ((8, 1), (4, 2)):
        pal = _palette(rng, 1 << bits)
        out[f"rle{bits}"] = tw.bmp_file(W, H, bits, tw.bmp_rle(runs, bits),
                                        compression=rle, palette=pal)
        out[f"rle{bits}_delta"] = tw.bmp_file(
            W, H, bits, tw.bmp_rle(runs, bits, delta_at=(3, 4, 7, 2)),
            compression=rle, palette=pal)
        out[f"rle{bits}_grey"] = tw.bmp_file(
            W, H, bits, tw.bmp_rle(runs, bits), compression=rle,
            palette=_palette(rng, 1 << bits, grey=True))
        blob = tw.bmp_rle(runs, bits)
        out[f"rle{bits}_early_eob"] = tw.bmp_file(
            W, H, bits, blob[:len(blob) // 2] + b"\0\1", compression=rle,
            palette=pal)
        out[f"bad_rle{bits}_truncated"] = tw.bmp_file(
            W, H, bits, blob[:len(blob) // 2], compression=rle, palette=pal)
    out["pil_1"] = _pil(Image.fromarray(rgb).convert("1"), "BMP")
    out["pil_L"] = _pil(Image.fromarray(rgb).convert("L"), "BMP")
    out["pil_P"] = _pil(Image.fromarray(rgb).convert("P"), "BMP")
    out["pil_RGB"] = _pil(Image.fromarray(rgb), "BMP")
    out["pil_RGBA"] = _pil(Image.fromarray(bgra), "BMP")
    good = out["rgb24"]
    out["bad_bits_2"] = good[:28] + b"\2\0" + good[30:]
    out["bad_width_0"] = good[:18] + bytes(4) + good[22:]
    out["bad_truncated"] = good[:len(good) - 9]
    out["bad_header_20"] = good[:14] + b"\x14" + good[15:]
    out["bad_rle8_at_24_bits"] = good[:30] + b"\1" + good[31:]
    out["bad_clrused_300"] = tw.bmp_file(W, H, 8, tw.bmp_rows(idx, 8),
                                         palette=_palette(rng, 12),
                                         clrused=300)
    out["bad_565_masks"] = tw.bmp_file(W, H, 16, tw.bmp_rows(v, 16),
                                       compression=3,
                                       masks=(0xF00, 0xF0, 0xF))
    # cv2 takes the 16-bit masks from after the header, here pixel data
    out["bad_rgb565_v4"] = out.pop("rgb565_v4")
    return out


BMPS = _bmp_cases()


@pytest.mark.parametrize("case", sorted(BMPS))
def test_bmp_matches_cv2(tmp_path, case):
    read = _like_cv2(tmp_path, BMPS[case], ".bmp")
    assert bool(read) != case.startswith("bad_") or "early" in case, read


def test_bmp_channels_pinned(tmp_path):
    """A grey palette gives one channel, an OS/2 file always does, and 32
    bits give four only with BI_BITFIELDS."""
    shapes = {}
    for case in ("pal8_grey", "pal8_colour", "rgb24_os2", "bgra32_rgb",
                 "bgra32_bitfields", "bgra32_v124"):
        path = tmp_path / f"{case}.bmp"
        path.write_bytes(BMPS[case])
        shapes[case] = image_io.read_image(path).shape[2:]
    assert shapes == {"pal8_grey": (), "pal8_colour": (3,), "rgb24_os2": (),
                      "bgra32_rgb": (3,), "bgra32_bitfields": (4,),
                      "bgra32_v124": (4,)}


@pytest.mark.parametrize("bgr,grey", [((233, 201, 249), 218),
                                      ((108, 111, 169), 128)])
def test_masked_bmp_grey_sums_r_then_g_then_b(tmp_path, bgr, grey):
    """cv2 sums a masked 32-bit BMP's grey in float32 as 0.299 R +
    0.587 G + 0.114 B, truncated; summed B first, these two colours come
    out one off. cv2.imwrite writes such a file (a V5 header) for every
    4-channel image."""
    img = np.zeros((3, 5, 4), np.uint8)
    img[...] = (*bgr, 255)
    path = tmp_path / "c.bmp"
    assert cv2.imwrite(str(path), img)
    assert (cv2.imread(str(path), cv2.IMREAD_GRAYSCALE) == grey).all()
    assert (image_io.read_image(path, "grey") == grey).all()
    assert _like_cv2(tmp_path, path.read_bytes(), ".bmp") == list(MODES)


# ---------------------------------------------------------------- PNM, PAM
def _pnm_cases():
    rng = np.random.default_rng(2)
    grey, rgb = _smooth(rng, (H, W)), _smooth(rng, (H, W, 3))
    out = {}
    for maxval in (1, 100, 255, 1000, 65535):
        g = np.minimum(grey.astype(np.int64) * maxval // 255, maxval)
        c = np.minimum(rgb.astype(np.int64) * maxval // 255, maxval)
        if maxval == 1:
            bits = rng.integers(0, 2, (H, W))
            out["p1"] = b"P1\n# bits\n%d %d\n" % (W, H) + b"\n".join(
                b"".join(b"%d" % v for v in row) for row in bits) + b"\n"
            out["p1_spaced"] = b"P1 %d %d " % (W, H) + b" ".join(
                b"%d" % v for v in bits.reshape(-1)) + b"\n"
            out["p4"] = b"P4\n%d %d\n" % (W, H) + np.packbits(
                bits.astype(np.uint8), axis=1).tobytes()
            continue
        dt = ">u2" if maxval > 255 else np.uint8
        for kind, img in ((2, g), (3, c)):
            out[f"p{kind}_{maxval}"] = b"P%d\n%d %d\n# c\n%d\n" % (
                kind, W, H, maxval) + b" ".join(
                b"%d" % v for v in img.reshape(-1)) + b"\n"
            out[f"p{kind + 3}_{maxval}"] = b"P%d\n%d\n%d\n%d\n" % (
                kind + 3, W, H, maxval) + img.astype(dt).tobytes()
    out["p5_over_maxval"] = b"P5 %d %d 100\n" % (W, H) + grey.tobytes()
    out["p2_over_maxval"] = b"P2 %d %d 100 " % (W, H) + b" ".join(
        b"%d" % v for v in grey.reshape(-1)) + b"\n"
    out["p6_tab_crlf"] = b"P6\t%d\r\n%d 255\r" % (W, H) + rgb.tobytes()
    out["bad_p2_no_final_byte"] = out["p2_255"][:-1]
    out["bad_p5_truncated"] = out["p5_255"][:-7]
    out["bad_p6_maxval_70000"] = b"P6\n%d %d\n70000\n" % (W, H) + \
        rgb.tobytes() * 2
    out["bad_p3_letter"] = out["p3_255"].replace(b" ", b" x ", 9)
    out["bad_p5_width_0"] = b"P5\n0 %d\n255\n" % H + grey.tobytes()
    return out


def _pam(w, h, depth, maxval, tupltype, data, extra=b""):
    head = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (
        w, h, depth, maxval) + extra
    if tupltype is not None:
        head += b"TUPLTYPE " + tupltype + b"\n"
    return head + b"ENDHDR\n" + data


def _pam_cases():
    rng = np.random.default_rng(3)
    out = {}
    for depth, tt in ((1, None), (1, b"GRAYSCALE"), (1, b"BLACKANDWHITE"),
                      (2, b"GRAYSCALE_ALPHA"), (3, None), (3, b"RGB"),
                      (4, b"RGB_ALPHA"), (4, None), (3, b"GRAYSCALE")):
        for maxval in (1, 255, 4000):
            n = W * H * depth
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes() \
                if maxval < 256 else \
                rng.integers(0, maxval + 1, n).astype(">u2").tobytes()
            name = f"d{depth}_{(tt or b'none').decode().lower()}_{maxval}"
            # no TUPLTYPE needs 1 or 3 channels below 256; a TUPLTYPE its
            # own number of channels; a MAXVAL of 1 (packed bits) 1 or 3
            # channels in the mode's output
            if (tt is None and (depth not in (1, 3) or maxval > 255)) \
                    or tt == b"GRAYSCALE" and depth != 1:
                name = "bad_" + name
            out[name] = _pam(W, H, depth, maxval, tt, data)
    data = rng.integers(0, 256, W * H * 3, dtype=np.uint8).tobytes()
    out["comments"] = _pam(W, H, 3, 255, b"  RGB\t", data,
                           b"# a comment\n\n  \t")
    out["crlf"] = _pam(W, H, 1, 255, None, data).replace(b"\n", b"\r\n", 6)
    out["bad_width_twice"] = _pam(W, H, 1, 255, None, data,
                                  b"WIDTH %d\n" % W)
    out["bad_hex_width"] = _pam(W, H, 1, 255, None, data).replace(
        b"WIDTH %d" % W, b"WIDTH 0x%x" % W)
    out["bad_tupltype"] = _pam(W, H, 1, 255, b"GRAY", data)
    out["bad_truncated"] = _pam(W, H, 3, 255, None, data[:-5])
    out["bad_p7_space"] = b"P7 " + _pam(W, H, 1, 255, None, data)[3:]
    return out


PNMS, PAMS = _pnm_cases(), _pam_cases()


@pytest.mark.parametrize("case", sorted(PNMS))
def test_pnm_matches_cv2(tmp_path, case):
    read = _like_cv2(tmp_path, PNMS[case], ".pnm")
    assert bool(read) != case.startswith("bad_"), read


def test_pnm_rescaling_pinned(tmp_path):
    """cv2 rescales ASCII samples of a maxval below 256 and nothing else."""
    got = {}
    for case in ("p2_100", "p5_100", "p5_1000", "p2_1000"):
        path = tmp_path / f"{case}.pgm"
        path.write_bytes(PNMS[case])
        got[case] = image_io.read_image(path)
    assert got["p2_100"].max() == 255 and got["p5_100"].max() == 100
    assert got["p5_1000"].dtype == np.uint16 == got["p2_1000"].dtype
    np.testing.assert_array_equal(got["p5_1000"], got["p2_1000"])


@pytest.mark.parametrize("case", sorted(PAMS))
def test_pam_matches_cv2(tmp_path, case):
    """Where cv2 converts 2 or 4 channels to colour or grey it steps over
    each row with the wrong stride, leaving part of its output unwritten
    or writing past its end: the port refuses those modes by name, and
    cv2 is not asked (its heap may not survive it)."""
    path = tmp_path / "f.pam"
    path.write_bytes(PAMS[case])
    read = []
    for mode in MODES:
        try:
            got = image_io.read_image(path, mode)
        except UnsupportedImage as e:
            assert "unwritten" in str(e) and mode != "unchanged"
            assert any(f"DEPTH {d}" in PAMS[case].decode("latin-1")
                       for d in (2, 4))
            continue
        except UnreadableImage:
            assert _cv2(path, mode) is None
            continue
        want = _cv2(path, mode)
        assert want is not None and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=mode)
        read.append(mode)
    assert bool(read) != case.startswith("bad_"), read


# ---------------------------------------------------------------------- PFM
def _pfm_cases():
    rng = np.random.default_rng(4)
    f3 = rng.normal(0.4, 0.5, (H, W, 3)).astype(np.float32)
    f3[0, :4] = [[0.5, 1.5, 2.5], [-0.5, 254.5, 255.5], [300, -3, 0.4999],
                 [np.inf, -np.inf, 1e-30]]
    out = {}
    for nch in (1, 3):
        data = f3 if nch == 3 else f3[..., 0]
        tag = b"PF" if nch == 3 else b"Pf"
        for scale in (b"-1", b"-1.0", b"-3", b"2.5", b"1"):
            order = ">f4" if not scale.startswith(b"-") else "<f4"
            out[f"{tag.decode()}_{scale.decode()}"] = (
                tag + b"\n%d %d\n" % (W, H) + scale + b"\n"
                + data[::-1].astype(order).tobytes())
    good = out["PF_-1"]
    out["bad_no_newline"] = b"PF %d %d\n-1\n" % (W, H) + good[16:]
    out["bad_truncated"] = good[:-3]
    out["bad_scale_0"] = b"PF\n%d %d\n0\n" % (W, H) + \
        f3[::-1].astype("<f4").tobytes()
    return out


PFMS = _pfm_cases()


@pytest.mark.parametrize("case", sorted(PFMS))
def test_pfm_matches_cv2(tmp_path, case):
    read = _like_cv2(tmp_path, PFMS[case], ".pfm")
    if case.startswith("bad_"):
        assert not read
    else:   # cv2 fails on a grey file as colour and a colour file as grey
        assert read == (["unchanged", "color"] if case.startswith("PF_")
                        else ["unchanged", "grey"])


# ---------------------------------------------------------------------- HDR
def _hdr_cases():
    rng = np.random.default_rng(5)
    rgbe = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.integers(100, 150, (H, W))
    rgbe[:, 5:15] = rgbe[:, 5:6]
    rgbe[2, :, 3] = 0
    rgbe[3, :8, 3] = [1, 2, 3, 255, 128, 136, 0, 127]
    out = {"rle": tw.hdr_file(rgbe), "flat": tw.hdr_file(rgbe, rle=False)}
    out["rgbe_signature"] = tw.hdr_file(
        rgbe, head=b"#?RGBE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n"
        % (H, W))
    small = rgbe[:, :6]
    out["narrow_flat"] = tw.hdr_file(small, rle=False, head=(
        b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X 6\n" % H))
    half = tw.hdr_file(rgbe[:4])
    out["rle_then_flat"] = half + rgbe[4:].tobytes()
    out["rle_then_flat"] = out["rle_then_flat"].replace(
        b"-Y 4 +X", b"-Y %d +X" % H, 1)
    out["cv2_written"] = cv2.imencode(".hdr", rng.random(
        (H, W, 3)).astype(np.float32) * 4)[1].tobytes()
    good = out["rle"]
    out["bad_xyze"] = good.replace(b"32-bit_rle_rgbe", b"32-bit_rle_xyze")
    out["bad_layout"] = good.replace(b"-Y %d +X" % H, b"+Y %d +X" % H)
    out["bad_no_blank_line"] = good.replace(b"rgbe\n\n", b"rgbe\n")
    out["bad_truncated"] = good[:-10]
    out["bad_scanline_width"] = good.replace(
        bytes([2, 2, 0, W]), bytes([2, 2, 0, W + 1]), 1)
    return out


HDRS = _hdr_cases()


@pytest.mark.parametrize("case", sorted(HDRS))
def test_hdr_matches_cv2(tmp_path, case):
    read = _like_cv2(tmp_path, HDRS[case], ".hdr")
    assert bool(read) != case.startswith("bad_"), read


# ---------------------------------------------------------------- Sun raster
def _sun_cases():
    rng = np.random.default_rng(6)
    out = {}
    w = W
    for depth in (1, 8, 24, 32):
        pitch = ((w * depth + 7) // 8 + 1) & -2
        data = rng.integers(0, 256, pitch * H, dtype=np.uint8).tobytes()
        for kind in (0, 1, 2, 3):
            out[f"d{depth}_type{kind}"] = tw.sun_raster(w, H, depth, data,
                                                        kind)
        if depth <= 8:
            n = 1 << depth
            cmap = rng.integers(0, 256, 3 * n, dtype=np.uint8)
            out[f"d{depth}_cmap"] = tw.sun_raster(w, H, depth, data,
                                                  cmap=cmap.tobytes())
            grey = np.tile(np.sort(rng.integers(0, 256, n)), 3)
            out[f"d{depth}_grey_cmap"] = tw.sun_raster(
                w, H, depth, data, cmap=grey.astype(np.uint8).tobytes())
    out["d8_short_cmap"] = tw.sun_raster(w, H, 8, data[:w * H + H],
                                         cmap=bytes(range(30)))
    out["bad_depth_16"] = tw.sun_raster(w, H, 16, data)
    pitch = (w * 3 + 1) & -2
    out["bad_truncated"] = tw.sun_raster(w, H, 24, data[:pitch * H])[:-20]
    return out


SUNS = _sun_cases()


@pytest.mark.parametrize("case", sorted(SUNS))
def test_sun_raster_matches_cv2(tmp_path, case):
    """cv2 cannot read RT_BYTE_ENCODED (2) or RT_FORMAT_RGB (3) files,
    nor, then, can the port."""
    read = _like_cv2(tmp_path, SUNS[case], ".ras")
    bad = case.startswith("bad_") or case.endswith(("type2", "type3"))
    assert bool(read) != bad, read


# ---------------------------------------------------------------------- GIF
def _gif_cases():
    rng = np.random.default_rng(7)
    out = {}
    pal = rng.integers(0, 256, (256, 3))
    for size in (2, 3, 5, 8):
        idx = rng.integers(0, 1 << size, (H, W))
        out[f"code_size_{size}"] = tw.gif_file(
            W, H, [dict(idx=idx, min_size=size)], pal[:1 << size])
    idx = rng.integers(0, 16, (H, W))
    out["interlaced"] = tw.gif_file(W, H, [dict(idx=idx, min_size=4,
                                                interlace=True)], pal[:16])
    out["local_table"] = tw.gif_file(
        W, H, [dict(idx=idx, min_size=4, table=pal[16:32])], pal[:16])
    out["local_only_87a"] = tw.gif_file(
        W, H, [dict(idx=idx, min_size=4, table=pal[16:32])], None,
        version=b"87a")
    out["no_table"] = tw.gif_file(W, H, [dict(idx=idx, min_size=4)], None)
    for bg in (0, 5):
        out[f"transparent_bg{bg}"] = tw.gif_file(
            W, H, [dict(idx=idx, min_size=4, transparent=5)], pal[:16],
            background=bg)
    sub = idx[:11, :13]
    out["offset_frame"] = tw.gif_file(
        W, H, [dict(idx=sub, min_size=4, left=9, top=7)], pal[:16],
        background=3)
    out["offset_transparent_interlaced"] = tw.gif_file(
        W, H, [dict(idx=sub, min_size=4, left=2, top=5, transparent=1,
                    interlace=True)], pal[:16], background=3)
    out["offset_local_no_global"] = tw.gif_file(
        W, H, [dict(idx=sub, min_size=4, left=2, top=5, table=pal[:16])],
        None)
    frames = [dict(idx=idx, min_size=4), dict(idx=idx[::-1], min_size=4,
                                                transparent=2, disposal=2)]
    out["two_frames_second_transparent"] = tw.gif_file(W, H, frames,
                                                       pal[:16])
    big = rng.integers(0, 256, (64, 64))
    out["table_fills"] = tw.gif_file(64, 64, [dict(idx=big, min_size=8)],
                                     pal)
    out["clears"] = tw.gif_file(64, 64, [dict(idx=big, min_size=8,
                                              clear_every=300)], pal)
    smooth = _smooth(rng, (H, W, 3))
    p = Image.fromarray(smooth).quantize(64)
    out["pil"] = _pil(p, "GIF")
    out["pil_interlaced_transparent"] = _pil(p, "GIF", interlace=True,
                                             transparency=7)
    out["pil_animated"] = _pil(p, "GIF", save_all=True, append_images=[
        Image.fromarray(smooth[::-1]).quantize(64)], duration=50, loop=0)
    out["cv2_written"] = cv2.imencode(".gif", smooth[..., ::-1])[1].tobytes()
    good = out["code_size_5"]
    out["bad_no_trailer"] = good[:-1]
    out["bad_truncated"] = good[:len(good) // 2]
    out["bad_frame_outside"] = tw.gif_file(
        W, H, [dict(idx=sub, min_size=4, left=W - 5)], pal[:16])
    out["bad_code_size_1"] = tw.gif_file(W, H, [dict(idx=idx % 2,
                                                     min_size=1)], pal[:2])
    out["bad_fewer_pixels"] = good.replace(
        struct.pack("<HH", W, H) + bytes([0]), struct.pack(
            "<HH", W, H + 1) + bytes([0]), 1).replace(
        b"GIF89a" + struct.pack("<HH", W, H),
        b"GIF89a" + struct.pack("<HH", W, H + 1), 1)
    out["bad_zero_screen"] = b"GIF89a" + bytes(4) + good[10:]
    return out


GIFS = _gif_cases()


@pytest.mark.parametrize("case", sorted(GIFS))
def test_gif_matches_cv2(tmp_path, case):
    read = _like_cv2(tmp_path, GIFS[case], ".gif")
    assert bool(read) != case.startswith("bad_"), read


def test_gif_alpha_pinned(tmp_path):
    """A transparent index anywhere in the file gives RGBA in "unchanged";
    undrawn pixels (the transparent ones, the screen around the image)
    keep the background colour at alpha 0."""
    path = tmp_path / "t.gif"
    path.write_bytes(GIFS["offset_transparent_interlaced"])
    img = image_io.read_image(path)
    assert img.shape == (H, W, 4) and img[0, 0, 3] == 0
    path.write_bytes(GIFS["two_frames_second_transparent"])
    assert image_io.read_image(path).shape == (H, W, 4)
    path.write_bytes(GIFS["local_table"])
    assert image_io.read_image(path).shape == (H, W, 3)


# --------------------------------------------------------------------- WebP
def _anim_first_frame_offset(rng):
    """A VP8X animation whose first frame (a lossless 20x14 image) lies at
    (6, 4) of a 53x37 canvas."""
    frame = _smooth(rng, (14, 20, 3))
    vp8l = tw.riff_chunk(_pil(Image.fromarray(frame), "WEBP",
                              lossless=True), b"VP8L")
    anmf = (struct.pack("<I", 3)[:3] + struct.pack("<I", 2)[:3]
            + struct.pack("<I", 19)[:3] + struct.pack("<I", 13)[:3]
            + struct.pack("<I", 100)[:3] + b"\0"
            + b"VP8L" + struct.pack("<I", len(vp8l)) + vp8l
            + b"\0" * (len(vp8l) & 1))
    vp8x = bytes([0x12, 0, 0, 0]) + struct.pack("<I", 52)[:3] \
        + struct.pack("<I", 36)[:3]
    return tw.riff((b"VP8X", vp8x), (b"ANIM", bytes(6)), (b"ANMF", anmf))


def _gradient_tiles(seed):
    """64x64 of 8x8 tiles, each a random linear ramp with some noise: what
    makes libwebp's encoder pick every predictor mode across two seeds."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:8, :8]
    img = np.zeros((64, 64, 3))
    for ty in range(8):
        for tx in range(8):
            gx, gy = rng.normal(0, 12, 2)
            base = rng.uniform(0, 255, 3)
            img[ty * 8:ty * 8 + 8, tx * 8:tx * 8 + 8] = (
                base + (gx * x + gy * y)[..., None]
                + rng.normal(0, rng.uniform(0, 6), (8, 8, 3)))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return np.concatenate([img, np.full((64, 64, 1), 255, np.uint8)], -1)


def _mode_quadrants():
    """64x64 of four colour patterns (vertical and horizontal stripes, a
    ramp, a flat area) on which libwebp picks every 16x16 and chroma
    mode."""
    y, x = np.mgrid[:32, :32]

    def colour(v):
        return np.stack([v, np.full_like(v, 128), 255 - v], -1)
    top = np.concatenate([colour(x * 37 % 256), colour(y * 37 % 256)], 1)
    bottom = np.concatenate([colour((4 * x + 3 * y) % 256),
                             colour(np.full_like(x, 90))], 1)
    return np.concatenate([top, bottom]).astype(np.uint8)


def _webp_cases():
    rng = np.random.default_rng(8)
    out = {}
    rgb = _smooth(rng, (H, W, 3))
    rgba = np.concatenate([rgb, _smooth(rng, (H, W, 1))], -1)
    noise = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    opaque = np.concatenate([rgb, np.full((H, W, 1), 255, np.uint8)], -1)
    ll = dict(lossless=True)
    out["ll_smooth"] = _pil(Image.fromarray(rgb), "WEBP", **ll)
    out["ll_noise"] = _pil(Image.fromarray(noise), "WEBP", **ll)
    out["ll_rgba"] = _pil(Image.fromarray(rgba), "WEBP", **ll)
    for n in (2, 4, 12, 40):
        out[f"ll_palette_{n}"] = _pil(Image.fromarray(rgb).quantize(
            n).convert("RGB"), "WEBP", **ll)
    out["ll_exact_transparent"] = tw.webp_encode(
        np.where(rgba[..., 3:] < 90, 0, rgba), lossless=1, exact=1,
        method=6, quality=100)
    out["ll_near_lossless"] = tw.webp_encode(opaque, lossless=1,
                                             near_lossless=60)
    for seed in (0, 2):
        out[f"ll_gradient_tiles_{seed}"] = tw.webp_encode(
            _gradient_tiles(seed), lossless=1, method=6, quality=100)
    out["cv2_ll_rgb"] = cv2.imencode(".webp", rgb[..., ::-1])[1].tobytes()
    out["cv2_ll_bgra"] = cv2.imencode(".webp", rgba[..., [2, 1, 0, 3]])[1] \
        .tobytes()
    out["cv2_ll_grey"] = cv2.imencode(".webp", rgb[..., 0])[1].tobytes()
    out["lossy_q80"] = _pil(Image.fromarray(rgb), "WEBP", quality=80)
    out["lossy_q5_noise"] = _pil(Image.fromarray(noise), "WEBP", quality=5)
    out["lossy_q100"] = _pil(Image.fromarray(noise), "WEBP", quality=100)
    out["lossy_modes"] = _pil(Image.fromarray(_mode_quadrants()), "WEBP",
                              quality=60)
    out["cv2_lossy"] = cv2.imencode(".webp", rgb[..., ::-1], [
        cv2.IMWRITE_WEBP_QUALITY, 60])[1].tobytes()
    for name, kw in {"simple_filter": dict(filter_type=0),
                     "simple_sharp": dict(filter_type=0, filter_sharpness=6),
                     "normal_sharp": dict(filter_type=1, filter_sharpness=7),
                     "no_filter": dict(filter_strength=0),
                     "partitions_4": dict(partitions=2, segments=1),
                     "partitions_8": dict(partitions=3, quality=95),
                     "segments_2": dict(segments=2, sns_strength=100)}.items():
        out[f"lossy_{name}"] = tw.webp_encode(opaque, **kw)
    for method in (0, 1):
        for filt in (0, 1, 2):
            out[f"alpha_c{method}_f{filt}"] = tw.webp_encode(
                rgba, alpha_compression=method, alpha_filtering=filt,
                quality=70)
    out["alpha_pil"] = _pil(Image.fromarray(rgba), "WEBP", quality=60)
    vp8 = tw.riff_chunk(out["lossy_q80"], b"VP8 ")
    vp8x = bytes([0x10, 0, 0, 0]) + struct.pack("<I", W - 1)[:3] \
        + struct.pack("<I", H - 1)[:3]

    def vp8l_of(img):
        return tw.riff_chunk(_pil(Image.fromarray(img), "WEBP",
                                  lossless=True), b"VP8L")
    for filt in (1, 2, 3):
        for comp in (0, 1):
            out[f"alpha_hand_c{comp}_f{filt}"] = tw.riff(
                (b"VP8X", vp8x), (b"ALPH", tw.alph_chunk(
                    rgba[..., 3], filt, comp, vp8l_of)), (b"VP8 ", vp8))
    frames = [Image.fromarray(rgba), Image.fromarray(rgba[::-1].copy())]
    out["anim_ll_rgba"] = _pil(frames[0], "WEBP", save_all=True,
                               append_images=frames[1:], lossless=True,
                               duration=40)
    frames = [Image.fromarray(rgb), Image.fromarray(noise)]
    out["anim_lossy"] = _pil(frames[0], "WEBP", save_all=True,
                             append_images=frames[1:], quality=70,
                             duration=40)
    out["anim_first_frame_offset"] = _anim_first_frame_offset(rng)
    for h, w in ((1, 1), (1, 17), (17, 1), (64, 61)):
        img = _smooth(rng, (h, w, 3))
        out[f"lossy_{h}x{w}"] = _pil(Image.fromarray(img), "WEBP",
                                     quality=75)
        out[f"ll_{h}x{w}"] = _pil(Image.fromarray(img), "WEBP", **ll)
    good = out["lossy_q80"]
    out["bad_truncated_lossy"] = good[:len(good) * 2 // 3]
    out["bad_truncated_lossless"] = out["ll_noise"][:len(out["ll_noise"])
                                                    // 2]
    out["bad_riff_size"] = good[:4] + struct.pack("<I", len(good)) + good[8:]
    vp8l = out["ll_smooth"]
    out["bad_vp8l_signature"] = vp8l[:20] + b"\x2e" + vp8l[21:]
    out["bad_vp8l_corrupt"] = vp8l[:40] + bytes(len(vp8l) - 40)
    out["bad_interframe"] = good[:20] + bytes([good[20] | 1]) + good[21:]
    return out


WEBPS = _webp_cases()


@pytest.mark.parametrize("case", sorted(WEBPS))
def test_webp_matches_cv2(tmp_path, case):
    read = _like_cv2(tmp_path, WEBPS[case], ".webp")
    assert bool(read) != case.startswith("bad_"), read


def test_webp_cases_cover_every_tool():
    """The cases reach every VP8L transform and predictor mode, every
    colour-indexing bundling, every alpha filter and compression, both
    loop filters, token partitions, and every VP8 intra mode."""
    from rnb_neus2_torch.io import native
    transforms, modes, bundles, alpha, filters = set(), set(), set(), \
        set(), set()
    y16, y4, uv = set(), set(), set()
    for case, blob in WEBPS.items():
        if case.startswith("bad_") or case.startswith("anim"):
            continue
        vp8l = tw.riff_chunk(blob, b"VP8L")
        vp8 = tw.riff_chunk(blob, b"VP8 ")
        alph = tw.riff_chunk(blob, b"ALPH")
        if alph:
            alpha.add((alph[0] & 3, (alph[0] >> 2) & 3))
        if vp8l:
            bits = int.from_bytes(vp8l[1:5], "little")
            w, h = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
            _, tinfo, tdata, n = native.vp8l_decode(vp8l[5:], w, h)
            for i in range(n):
                kind, tbits, before, off = tinfo[4 * i:4 * i + 4]
                transforms.add(int(kind))
                if kind == 0:
                    size = -(-before // (1 << tbits)) * -(-h // (1 << tbits))
                    modes |= set(((tdata[off:off + size] >> 8) & 0xF)
                                 .tolist())
                if kind == 3:
                    bundles.add(int(tbits))
        if vp8:
            info, mb, _, code = native.vp8_parse(vp8)
            assert code == 0
            filters.add(int(info[4]))
            mb = mb.reshape(-1, 20)[:info[2] * info[3]]
            y4 |= set(mb[mb[:, 0] == 1, 4:].reshape(-1).tolist())
            y16 |= set(mb[mb[:, 0] == 0, 4].tolist())
            uv |= set(mb[:, 1].tolist())
    assert transforms == {0, 1, 2, 3} and bundles == {0, 1, 2, 3}
    assert modes >= set(range(14)), sorted(modes)
    assert alpha >= {(0, 0), (1, 0), (1, 1), (1, 2), (1, 3)}, alpha
    assert filters == {0, 1, 2}
    assert y4 == set(range(10)) and y16 == uv == set(range(4))


# ------------------------------------------------------------------ writers
WRITERS = [".bmp", ".dib", ".ppm", ".pnm", ".pxm", ".pgm", ".pbm", ".pam",
           ".pfm", ".hdr", ".pic", ".ras", ".sr"]


def _bgr(img):
    if img.ndim == 2 or img.shape[2] == 2:
        return img
    return img[..., [2, 1, 0, 3][:img.shape[2]]]


@pytest.mark.parametrize("ext", WRITERS)
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("ch", [1, 2, 3, 4])
def test_writers_match_cv2_imwrite(tmp_path, ext, dtype, ch):
    """The bytes of cv2.imwrite, or ValueError where it returns False. (A
    Sun raster row of odd length is padded with the byte after it in
    memory: the next row's first, and for the last row whatever follows
    cv2's buffer, which the port writes as 0, so that byte is not held.)"""
    rng = np.random.default_rng(ch)
    shape = (H, W) if ch == 1 else (H, W, ch)
    img = _smooth(rng, shape, np.iinfo(dtype).max, dtype)
    img[0, :3] = 0
    want_path = tmp_path / f"cv2{ext}"
    try:
        ok = cv2.imwrite(str(want_path), _bgr(img))
    except cv2.error:
        ok = False
    path = tmp_path / f"port{ext}"
    if not ok:
        with pytest.raises(ValueError):
            image_io.write_raw(path, img)
        return
    image_io.write_raw(path, img)
    got, want = path.read_bytes(), want_path.read_bytes()
    if ext in (".ras", ".sr") and (W * ch) % 2:
        assert len(got) == len(want)
        got, want = got[:-1], want[:-1]
    assert got == want


@pytest.mark.parametrize("ext", [".pfm", ".hdr"])
@pytest.mark.parametrize("ch", [1, 3])
def test_float_writers_match_cv2_imwrite(tmp_path, ext, ch):
    rng = np.random.default_rng(9)
    img = rng.normal(1, 2, (H, W, ch)).astype(np.float32)[..., :ch]
    img = img[..., 0] if ch == 1 else img
    img[0, :4] = 0
    cv2.imwrite(str(tmp_path / f"cv2{ext}"), _bgr(img))
    image_io.write_raw(tmp_path / f"port{ext}", img)
    assert (tmp_path / f"port{ext}").read_bytes() == \
        (tmp_path / f"cv2{ext}").read_bytes()


@pytest.mark.parametrize("ext,name", [(".webp", "WebP"), (".gif", "GIF"),
                                      (".jp2", "JPEG 2000"),
                                      (".avif", "AVIF"), (".j2k", None)])
def test_quantising_writers_refused_by_name(tmp_path, ext, name):
    """The writers whose cv2 encoder quantises: `.webp`, `.gif` and `.jp2`
    are written and read back as cv2 reads cv2.imwrite's file
    (tests/test_torch_image_writers.py holds them case by case); `.avif`
    is written (by the port's own AV1 encoder, so not cv2's pixels) and
    cv2 reads it as the port's reader does
    (tests/test_torch_image_avif_writer.py holds it against cv2's file);
    `.j2k`, for which cv2 5 has no writer, raises as an unknown extension
    does."""
    img = _smooth(np.random.default_rng(5), (36, 40, 3), 255, np.uint8)
    path = tmp_path / f"a{ext}"
    if ext in (".webp", ".gif", ".jp2"):
        image_io.write_raw(path, img)
        cv2.imwrite(str(tmp_path / f"c{ext}"), _bgr(img))
        for mode in MODES:
            np.testing.assert_array_equal(_cv2(path, mode),
                                          _cv2(tmp_path / f"c{ext}", mode))
    elif name:
        image_io.write_raw(path, img)
        for mode in MODES:
            np.testing.assert_array_equal(_cv2(path, mode),
                                          image_io.read_image(path, mode))
    else:
        with pytest.raises(ValueError, match="no image writer"):
            image_io.write_raw(path, img)
    with pytest.raises(ValueError, match="extension"):
        image_io.write_raw(tmp_path / "a.xyz", np.zeros((4, 4, 3), np.uint8))


# ------------------------------------------------------------- read sites

def _rgb_like_jax(img):
    return img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]]


@pytest.mark.parametrize("case", ["pfm_rgb", "pfm_grey", "hdr", "ppm16",
                                  "pgm16", "bmp", "webp_rgba", "gif"])
def test_loaders_match_jax(tmp_path, case):
    """load_image: float32 from PFM and HDR passes through as from EXR,
    16-bit PNM is divided by 65535, 8-bit formats by 255; load_normal
    remaps every extension but .exr, so a .pfm normal map too;
    load_image_raw16 as stbi_load_16 sees the file."""
    rng = np.random.default_rng(12)
    f3 = rng.normal(0, 0.6, (H, W, 3)).astype(np.float32)
    u16 = _smooth(rng, (H, W, 3), 65535, np.uint16)
    u8 = _smooth(rng, (H, W, 4))
    ext = {"pfm_rgb": ".pfm", "pfm_grey": ".pfm", "hdr": ".hdr",
           "ppm16": ".ppm", "pgm16": ".pgm", "bmp": ".bmp",
           "webp_rgba": ".webp", "gif": ".gif"}[case]
    path = tmp_path / f"x{ext}"
    if case == "pfm_rgb":
        image_io.write_raw(path, f3)
    elif case == "pfm_grey":
        image_io.write_raw(path, f3[..., 0])
    elif case == "hdr":
        image_io.write_raw(path, np.abs(f3) * 3)
    elif case == "ppm16":
        image_io.write_raw(path, u16)
    elif case == "pgm16":
        image_io.write_raw(path, u16[..., 1])
    elif case == "bmp":
        image_io.write_raw(path, u8)
    elif case == "webp_rgba":
        path.write_bytes(_pil(Image.fromarray(u8), "WEBP", lossless=True))
    else:
        path.write_bytes(_pil(Image.fromarray(u8[..., :3]).quantize(32),
                              "GIF", transparency=3))
    got, want = image_io.load_image(path), jimage_io.load_image(str(path))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(image_io.load_image_raw16(path),
                                  jimage_io.load_image_raw16(str(path)))
    if got.ndim == 3:
        np.testing.assert_array_equal(image_io.load_normal(path),
                                      jimage_io.load_normal(str(path)))


def test_prepare_matches_jax_on_pfm_webp_pgm(tmp_path):
    """A scene of float PFM normals in [-1, 1] (through _to_uint16_normal,
    as the JAX prepare sends any float normal), lossless and lossy WebP
    albedos (one with alpha) and PGM masks prepares to the same arrays."""
    from test_torch_image_formats import _views
    rng = np.random.default_rng(13)
    root = tmp_path / "in"
    root.mkdir()
    views = []
    for v in _views(str(root)):
        i = v["i"]
        h, w = v["inside"].shape
        nrm = rng.uniform(-1, 1, (h, w, 3)).astype(np.float32)
        image_io.write_raw(root / f"n{i}.pfm", nrm)
        alb = _smooth(rng, (h, w, 4))
        blob = _pil(Image.fromarray(alb if i == 0 else alb[..., :3]),
                    "WEBP", lossless=i != 2, quality=80)
        (root / f"a{i}.webp").write_bytes(blob)
        image_io.write_raw(root / f"m{i}.pgm",
                           v["inside"].astype(np.uint8) * 255)
        views.append({"c2w": v["c2w"], "K": v["K"],
                      "normal_path": str(root / f"n{i}.pfm"),
                      "albedo_path": str(root / f"a{i}.webp"),
                      "mask_path": str(root / f"m{i}.pgm")})
    data = {"views": views, "image_width": w, "image_height": h,
            "landmarks": None}
    prepare.prepare_testbed_data(data, str(tmp_path / "port"),
                                 scaling_mode="silhouettes")
    jprepare.prepare_testbed_data(data, str(tmp_path / "jax"),
                                  scaling_mode="silhouettes")
    tj, jtj = (json.load(open(tmp_path / d / "transform.json"))
               for d in ("port", "jax"))
    np.testing.assert_allclose(tj["n2w"], jtj["n2w"], rtol=1e-9)
    assert len(tj["frames"]) == len(jtj["frames"]) == 3
    for fr, jfr in zip(tj["frames"], jtj["frames"]):
        np.testing.assert_allclose(fr["transform_matrix"],
                                   jfr["transform_matrix"], rtol=1e-9)
        for k in ("normal_path", "albedo_path"):
            got = png.read_png(tmp_path / "port" / fr[k])
            want = _rgb_like_jax(cv2.imread(str(tmp_path / "jax" / jfr[k]),
                                            cv2.IMREAD_UNCHANGED))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


def test_neus_converter_matches_jax_on_bmp_and_pgm(tmp_path):
    """BMP images (IMREAD_COLOR) and PGM masks (IMREAD_GRAYSCALE): each
    image written back under its own .bmp name, a 32-bit BMP of the mask
    as alpha, the same bytes as the JAX converter's cv2.imwrite."""
    import importlib.util
    from rnb_neus2_torch.tools import data_format_from_neus
    spec = importlib.util.spec_from_file_location(
        "jax_data_format_from_neus",
        os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools",
                     "data_format_from_neus.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    rng = np.random.default_rng(14)
    root = tmp_path / "neus"
    (root / "image").mkdir(parents=True)
    (root / "mask").mkdir()
    mats = {}
    for i in range(2):
        P = np.array([[30.0, 0, W / 2, 0.1], [0, 31.0, H / 2, -0.2],
                      [0, 0, 1, 3.0 + i]], np.float32)
        mats[f"world_mat_{i}"] = np.vstack([P, [0, 0, 0, 1]])
        mats[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
        image_io.write_raw(root / "image" / f"{i:03d}.bmp",
                           _smooth(rng, (H, W, 3)))
        image_io.write_raw(root / "mask" / f"{i:03d}.pgm",
                           (rng.random((H, W)) > 0.4).astype(np.uint8) * 255)
    np.savez(root / "cameras_sphere.npz", **mats)
    data_format_from_neus.generate(str(root), str(tmp_path / "port"))
    jtool.generate(str(root), str(tmp_path / "jax"))
    got, want = (json.load(open(tmp_path / d / "transform.json"))
                 for d in ("port", "jax"))
    assert len(got["frames"]) == 2
    for f, jf in zip(got["frames"], want["frames"]):
        assert f["file_path"] == jf["file_path"]
        assert f["file_path"].endswith(".bmp")
        a, b = (tmp_path / d / f["file_path"] for d in ("port", "jax"))
        assert a.read_bytes() == b.read_bytes()


def test_fixtures_of_the_new_formats_decode_to_expected():
    """The committed fixtures of these formats (what phase 20 of
    chip_smoke.py decodes on the card's host) equal cv2's decode in
    `expected.npz`, or raise UnreadableImage where cv2 returned None."""
    fixtures = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                            "formats")
    with np.load(os.path.join(fixtures, "expected.npz")) as z:
        expected = {k: z[k] for k in z.files}
    names = sorted(n for n in os.listdir(fixtures)
                   if os.path.splitext(n)[1] in (
                       ".bmp", ".pbm", ".pgm", ".ppm", ".pam", ".pfm",
                       ".hdr", ".ras", ".gif", ".webp"))
    assert len(names) >= 45
    for name in names:
        for mode in MODES:
            want = expected[f"{name}:{mode}"]
            path = os.path.join(fixtures, name)
            if want.size == 0:
                with pytest.raises(UnreadableImage):
                    image_io.read_image(path, mode)
                continue
            got = image_io.read_image(path, mode)
            assert got.dtype == want.dtype, (name, mode)
            np.testing.assert_array_equal(got, want, err_msg=name)
