"""Write the image-format fixtures of this folder and `expected.npz`,
cv2's decode of each in IMREAD_UNCHANGED, _COLOR and _GRAYSCALE (RGB(A)
order; an empty array where cv2 returns None).

One small file per image variant that the port reads (JPEG, TIFF with
its CCITT and ThunderScan codecs, BMP, PNM/PAM/PFM, Radiance HDR, Sun
raster, GIF, WebP, JPEG 2000), written by cv2, PIL or the writers of
`tests/torch_image_writers.py`, and a few that cv2 cannot read either;
among them a 612x512 progressive JPEG and the same file cut after 3 of
its scans, a progressive and a baseline file that end inside a scan, and
612x512 lossy and lossless WebP, Radiance, RLE8 BMP, lossless 16-bit and
lossy 8-bit JPEG 2000 and Group 4 mask files, which phases 19 and 20
time. `chip_smoke.py` (phase 20) decodes them on the card's host, which
has neither cv2 nor PIL, and tests/test_torch_image_variants.py holds
them against `expected.npz`.

Also the JPEG 2000 / Group 4 sphere scene of `../jp2_scene/` (phase 19):
the port's `write_sfm_scene` PNG sphere (16 views of 256x256) with its
normals rewritten as lossless 16-bit JP2, its albedos as 8-bit JP2 at
cv2's default (lossy) rate and its masks as Group 4 TIFF (a masks.sfm.json
names them), and `expected.json`, digests of what the JAX package's
`prepare_testbed_data` makes of it on this host.

Needs cv2 and PIL, so it runs where the tests run, not on the card:

    python tests/torch_fixtures/formats/make_fixtures.py
"""

import io
import struct
import sys
from pathlib import Path

import numpy as np

import cv2
from PIL import Image

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))
sys.path.insert(0, str(HERE.parents[2]))
import torch_image_writers as tw  # noqa: E402

H, W = 37, 53
MODES = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "grey": cv2.IMREAD_GRAYSCALE}


def smooth(rng, shape, noise=0.04):
    y, x = np.mgrid[:shape[0], :shape[1]]
    ch = shape[2] if len(shape) == 3 else 1
    base = np.stack([0.5 + 0.4 * np.sin(x / 9.0 + c) * np.cos(y / 7.0 + c)
                     for c in range(ch)], -1)
    img = np.clip(base + rng.normal(0, noise, base.shape), 0, 1)
    return (img * 255).astype(np.uint8).reshape(shape)


def scan_starts(blob):
    out, pos = [], 2
    while pos + 4 <= len(blob):
        m = blob[pos + 1]
        if blob[pos] != 0xFF or m in (0, 0xFF, 1) or 0xD0 <= m <= 0xD7:
            pos += 1
            continue
        if m == 0xD9:
            break
        if m == 0xDA:
            out.append(pos)
        pos += 2 + struct.unpack_from(">H", blob, pos + 2)[0]
    return out


def pil_bytes(img, fmt, **kw):
    bio = io.BytesIO()
    img.save(bio, fmt, **kw)
    return bio.getvalue()


def coef_blocks(rng, hs, vs):
    hmax, vmax = max(hs), max(vs)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    out = []
    for c in range(len(hs)):
        bh, bw = mcuy * vs[c], mcux * hs[c]
        b = np.zeros((bh, bw, 64), np.int64)
        yy, xx = np.mgrid[:bh, :bw]
        b[..., 0] = (40 * np.sin(yy / 3.0 + c) * np.cos(xx / 4.0)).astype(int)
        keep = rng.random((bh, bw, 63)) < np.linspace(0.6, 0.02, 63)
        b[..., 1:] = (rng.normal(0, np.linspace(25, 1, 63), (bh, bw, 63))
                      * keep).astype(int)
        out.append(b)
    return out


def tags(h, w, bits, spp, photo, fmt=1, extra=None):
    t = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp),
         259: (3, [1]), 262: (3, [photo]), 277: (3, [spp]), 278: (4, [h]),
         284: (3, [1]), 339: (3, [fmt] * spp)}
    t.update(extra or {})
    return t


def jpegs(rng):
    out = {}
    big = smooth(rng, (612, 512, 3), noise=0.002)
    blob = cv2.imencode(".jpg", big, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                      cv2.IMWRITE_JPEG_QUALITY, 80])[1]
    blob = blob.tobytes()
    out["prog_612x512.jpg"] = blob
    out["prog_612x512_cut3.jpg"] = blob[:scan_starts(blob)[3]]
    out["prog_grey.jpg"] = cv2.imencode(
        ".jpg", smooth(rng, (H, W)), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1] \
        .tobytes()
    out["prog_444_restart.jpg"] = cv2.imencode(
        ".jpg", smooth(rng, (H, W, 3)), [
            cv2.IMWRITE_JPEG_PROGRESSIVE, 1, cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x111111])[1].tobytes()
    blob = cv2.imencode(".jpg", smooth(rng, (H, W, 3)), [
        cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes()
    out["prog_truncated.jpg"] = blob[:int(len(blob) * 0.6)]
    blob = cv2.imencode(".jpg", smooth(rng, (H, W, 3)), [
        cv2.IMWRITE_JPEG_RST_INTERVAL, 2])[1].tobytes()
    out["baseline_truncated.jpg"] = blob[:int(len(blob) * 0.7)]
    out["prog_pil.jpg"] = pil_bytes(Image.fromarray(smooth(rng, (H, W, 3))),
                                    "JPEG", progressive=True, quality=85)
    q = [np.clip(np.arange(64) // 4 + 2, 1, 255), np.full(64, 5)]
    b420 = coef_blocks(rng, [2, 1, 1], [2, 1, 1])
    out["arith_seq_420.jpg"] = tw.arith_jpeg(b420, q, H, W, [2, 1, 1],
                                             [2, 1, 1], restart=3)
    b444 = coef_blocks(rng, [1, 1, 1], [1, 1, 1])
    out["arith_prog_444_dac.jpg"] = tw.arith_jpeg(
        b444, q, H, W, [1, 1, 1], [1, 1, 1], progressive=True,
        dac=(1, 3, 2))
    out["arith_prog_cut3.jpg"] = tw.arith_jpeg(
        b420, q, H, W, [2, 1, 1], [2, 1, 1], progressive=True, cut_after=3)
    planes = rng.integers(0, 32, (3, 13, 17))
    out["lossless_rgb_p5.jpg"] = tw.lossless_jpeg(planes, 5, 5, 1, 4,
                                                  adobe=0)
    out["lossless_grey_pt2.jpg"] = tw.lossless_jpeg(
        rng.integers(0, 256, (1, 13, 17)), 8, 7, 2)
    cmyk = Image.fromarray(rng.integers(0, 256, (H, W, 4)).astype(np.uint8),
                           "CMYK")
    blob = pil_bytes(cmyk, "JPEG", quality=90)
    out["cmyk.jpg"] = blob
    at = blob.index(b"Adobe")
    out["ycck.jpg"] = blob[:at + 11] + b"\x02" + blob[at + 12:]
    blob = cv2.imencode(".jpg", smooth(rng, (H, W, 3)))[1].tobytes()
    n, = struct.unpack(">H", blob[4:6])
    out["rgb_adobe.jpg"] = blob[:2] + tw._segment(
        0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00") + blob[4 + n:]
    sof = blob.index(b"\xff\xc0")
    out["unreadable_hierarchical.jpg"] = blob[:sof + 1] + b"\xc5" \
        + blob[sof + 2:]
    out["unreadable_12bit.jpg"] = blob[:sof + 4] + b"\x0c" + blob[sof + 5:]
    out["unreadable_lossless12.jpg"] = tw.lossless_jpeg(
        rng.integers(0, 4096, (1, 6, 7)), 12, 1)
    return out


def tiffs(rng):
    out = {}
    img = smooth(rng, (H, W, 3))
    t = tags(H, W, 8, 3, 2, extra={322: (3, [16]), 323: (3, [16]),
                                   259: (3, [8])})
    del t[278]
    import zlib
    out["tiled_rgb_deflate.tif"] = tw.tiff_file(
        t, [zlib.compress(x.tobytes()) for x in tw.tiles(img, 16, 16)],
        tiled=True)
    f32 = rng.random((H, W)).astype(np.float32)
    t = tags(H, W, 32, 1, 1, 3, extra={322: (3, [16]), 323: (3, [16])})
    del t[278]
    out["tiled_float32.tif"] = tw.tiff_file(
        t, [x.tobytes() for x in tw.tiles(f32, 16, 16)], tiled=True)
    rgba = smooth(rng, (H, W, 4))
    out["planar_rgba.tif"] = tw.tiff_file(
        tags(H, W, 8, 4, 2, extra={284: (3, [2]), 338: (3, [2])}),
        [rgba[..., c].tobytes() for c in range(4)])
    path = HERE / "_tmp.tif"
    cv2.imwrite(str(path), smooth(rng, (H, W, 3)),
                [cv2.IMWRITE_TIFF_COMPRESSION, 7])
    out["jpeg_rgb.tif"] = path.read_bytes()
    Image.fromarray(smooth(rng, (H, W, 3))).save(path, compression="jpeg")
    out["jpeg_ycbcr.tif"] = path.read_bytes()
    path.unlink()
    out["bw1.tif"] = tw.tiff_file(tags(H, W, 1, 1, 1),
                                  [tw.pack_bits(rng.integers(0, 2, (H, W)),
                                                1)])
    out["miniswhite.tif"] = tw.tiff_file(tags(H, W, 8, 1, 0),
                                         [smooth(rng, (H, W)).tobytes()])
    cmap = [(i * 4111) % 65536 for i in range(16)] + \
        [(i * 7919) % 65536 for i in range(16)] + \
        [(i * 257) % 65536 for i in range(16)]
    out["palette4.tif"] = tw.tiff_file(
        tags(H, W, 4, 1, 3, extra={320: (3, cmap)}),
        [tw.pack_bits(rng.integers(0, 16, (H, W)), 4)])
    out["palette8_pil.tif"] = pil_bytes(
        Image.fromarray(smooth(rng, (H, W, 3))).convert("P"), "TIFF")
    units = rng.integers(0, 256, (-(-H // 2), -(-W // 2), 6)).astype(np.uint8)
    out["ycbcr22.tif"] = tw.tiff_file(tags(H, W, 8, 3, 6),
                                      [units.tobytes()])
    out["cmyk.tif"] = pil_bytes(Image.fromarray(
        rng.integers(0, 256, (H, W, 4)).astype(np.uint8), "CMYK"), "TIFF")
    i16 = (rng.normal(0, 8000, (H, W))).astype(np.int16)
    out["int16.tif"] = tw.tiff_file(tags(H, W, 16, 1, 1, 2), [i16.tobytes()])
    f64 = rng.normal(0, 1, (H, W, 3))
    out["float64_rgb.tif"] = tw.tiff_file(tags(H, W, 64, 3, 2, 3),
                                          [f64.tobytes()])
    out["orient3.tif"] = tw.tiff_file(
        tags(H, W, 8, 3, 2, extra={274: (3, [3])}), [img.tobytes()])
    sq = smooth(rng, (W, W, 3))
    out["orient6_square.tif"] = tw.tiff_file(
        tags(W, W, 8, 3, 2, extra={274: (3, [6])}), [sq.tobytes()])
    out["bigtiff.tif"] = pil_bytes(Image.fromarray(smooth(rng, (H, W, 3))),
                                   "TIFF", big_tiff=True)
    out["unreadable_grey2.tif"] = tw.tiff_file(
        tags(H, W, 2, 1, 1), [tw.pack_bits(rng.integers(0, 4, (H, W)), 2)])
    out["unreadable_orient6.tif"] = tw.tiff_file(
        tags(H, W, 8, 3, 2, extra={274: (3, [6])}), [img.tobytes()])
    out["unreadable_float16.tif"] = tw.tiff_file(
        tags(H, W, 16, 1, 1, 3), [np.ones((H, W), np.float16).tobytes()])
    return out


BIG = (612, 512)     # DiLiGenT-MV's view, (width, height)


def sphere_view(radius=200):
    """A 612x512 normal map of a sphere on black, the project's typical
    input, as [0, 1] floats (the timing fixtures' content)."""
    w, h = BIG
    y, x = np.mgrid[:h, :w].astype(np.float32)
    nx, ny = (x - w / 2) / radius, (y - h / 2) / radius
    r2 = nx ** 2 + ny ** 2
    nz = np.sqrt(np.clip(1 - r2, 0, 1))
    img = np.stack([nx, -ny, nz], -1) * 0.5 + 0.5
    img[r2 >= 1] = 0
    return img


def more_formats(rng):
    """BMP, PNM/PAM/PFM, Radiance, Sun raster, GIF and WebP."""
    out = {}
    rgb = smooth(rng, (H, W, 3))
    rgba = smooth(rng, (H, W, 4))
    grey = smooth(rng, (H, W))
    pal = rng.integers(0, 256, (256, 3))
    idx = rng.integers(0, 16, (H, W))
    out["bmp_pal4.bmp"] = tw.bmp_file(W, H, 4, tw.bmp_rows(idx, 4),
                                      palette=pal[:16])
    out["bmp_pal8_grey.bmp"] = tw.bmp_file(
        W, H, 8, tw.bmp_rows(grey, 8),
        palette=np.repeat(np.arange(256)[:, None], 3, 1))
    out["bmp_pal1_os2.bmp"] = tw.bmp_file(
        W, H, 1, tw.bmp_rows(idx % 2, 1), header=12, palette=pal[:2])
    out["bmp_565.bmp"] = tw.bmp_file(
        W, H, 16, tw.bmp_rows(rng.integers(0, 1 << 16, (H, W)), 16),
        compression=3, masks=(0xF800, 0x7E0, 0x1F))
    out["bmp_555_top_down.bmp"] = tw.bmp_file(
        W, H, 16, tw.bmp_rows(rng.integers(0, 1 << 15, (H, W))[::-1], 16),
        top_down=True)
    out["bmp_v5_bgra.bmp"] = tw.bmp_file(
        W, H, 32, tw.bmp_rows(rgba.reshape(H, -1), 8), header=124,
        compression=3, masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000))
    runs = np.repeat(rng.integers(0, 16, (H, 11)), 5, 1)[:, :W]
    out["bmp_rle8_delta.bmp"] = tw.bmp_file(
        W, H, 8, tw.bmp_rle(runs, 8, delta_at=(5, 3, 9, 2)), compression=1,
        palette=pal)
    out["bmp_rle4.bmp"] = tw.bmp_file(W, H, 4, tw.bmp_rle(runs, 4),
                                      compression=2, palette=pal[:16])
    out["bmp_cv2_rgb.bmp"] = cv2.imencode(".bmp", rgb[..., ::-1])[1] \
        .tobytes()
    blob = out["bmp_cv2_rgb.bmp"]
    out["unreadable_bmp_bits2.bmp"] = blob[:28] + b"\2\0" + blob[30:]
    bits = rng.integers(0, 2, (H, W))
    out["pnm_p1.pbm"] = b"P1\n# bits\n%d %d\n" % (W, H) + b"\n".join(
        b"".join(b"%d" % v for v in row) for row in bits) + b"\n"
    out["pnm_p4.pbm"] = b"P4\n%d %d\n" % (W, H) + np.packbits(
        bits.astype(np.uint8), axis=1).tobytes()
    g100 = grey.astype(np.int64) * 100 // 255
    out["pnm_p2_maxval100.pgm"] = b"P2\n%d %d\n100\n" % (W, H) + b" ".join(
        b"%d" % v for v in g100.reshape(-1)) + b"\n"
    out["pnm_p3.ppm"] = b"P3 %d %d 255\n" % (W, H) + b" ".join(
        b"%d" % v for v in rgb.reshape(-1)) + b"\n"
    out["pnm_p5_16bit.pgm"] = b"P5\n%d %d\n65535\n" % (W, H) + \
        (grey.astype(np.uint16) * 257).astype(">u2").tobytes()
    out["pnm_p6_maxval1000.ppm"] = b"P6\n%d %d\n1000\n" % (W, H) + \
        (rgb.astype(np.int64) * 1000 // 255).astype(">u2").tobytes()
    out["pnm_cv2_p6.ppm"] = cv2.imencode(".ppm", rgb[..., ::-1])[1] \
        .tobytes()
    out["unreadable_pnm_truncated.pgm"] = out["pnm_p5_16bit.pgm"][:-9]

    def pam(depth, maxval, tt, data):
        head = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\n" % (
            W, H, depth, maxval)
        return head + (b"TUPLTYPE " + tt + b"\n" if tt else b"") + \
            b"ENDHDR\n" + data
    out["pam_grayscale.pam"] = pam(1, 255, b"GRAYSCALE", grey.tobytes())
    out["pam_rgb.pam"] = pam(3, 255, None, rgb.tobytes())
    out["pam_rgb_16bit.pam"] = pam(3, 65535, b"RGB", (
        rgb.astype(np.uint16) * 257).astype(">u2").tobytes())
    out["pam_blackandwhite.pam"] = pam(1, 1, b"BLACKANDWHITE",
                                       rng.integers(0, 256, H * W,
                                                    dtype=np.uint8).tobytes())
    out["unreadable_pam_cv2_bgra.pam"] = cv2.imencode(
        ".pam", rgba[..., [2, 1, 0, 3]])[1].tobytes()
    f3 = rng.normal(0.3, 0.5, (H, W, 3)).astype(np.float32)
    out["pfm_rgb.pfm"] = b"PF\n%d %d\n-1.0\n" % (W, H) + \
        f3[::-1].astype("<f4").tobytes()
    out["pfm_grey_big_endian.pfm"] = b"Pf\n%d %d\n2\n" % (W, H) + \
        f3[::-1, :, 0].astype(">f4").tobytes()
    rgbe = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
    rgbe[..., 3] = rng.integers(120, 136, (H, W))
    rgbe[:, 10:30] = rgbe[:, 10:11]
    out["hdr_rle.hdr"] = tw.hdr_file(rgbe)
    out["hdr_flat.hdr"] = tw.hdr_file(rgbe, rle=False)
    out["hdr_cv2.hdr"] = cv2.imencode(".hdr", f3[..., ::-1] ** 2)[1] \
        .tobytes()
    out["unreadable_hdr_xyze.hdr"] = out["hdr_rle.hdr"].replace(
        b"rle_rgbe", b"rle_xyze")
    pitch = (W + 1) & -2
    data8 = rng.integers(0, 256, pitch * H, dtype=np.uint8).tobytes()
    out["sun_8bit_cmap.ras"] = tw.sun_raster(
        W, H, 8, data8, cmap=rng.integers(0, 256, 768,
                                          dtype=np.uint8).tobytes())
    out["sun_8bit_no_map.ras"] = tw.sun_raster(W, H, 8, data8)
    out["sun_1bit.ras"] = tw.sun_raster(
        W, H, 1, rng.integers(0, 256, (((W + 7) // 8 + 1) & -2) * H,
                              dtype=np.uint8).tobytes())
    out["sun_cv2_24bit.ras"] = cv2.imencode(".ras", np.ascontiguousarray(
        rgb[:, :W - 1, ::-1]))[1].tobytes()
    out["sun_32bit.ras"] = tw.sun_raster(W, H, 32, rgba.tobytes(), kind=0)
    out["unreadable_sun_byte_encoded.ras"] = tw.sun_raster(W, H, 8, data8,
                                                           kind=2)
    out["gif_interlaced.gif"] = tw.gif_file(
        W, H, [dict(idx=idx, min_size=4, interlace=True)], pal[:16])
    out["gif_local_transparent_offset.gif"] = tw.gif_file(
        W, H, [dict(idx=idx[:20, :30] % 4, min_size=2, left=7, top=9,
                    table=pal[40:44], transparent=2)], pal[:16],
        background=5)
    q = Image.fromarray(rgb).quantize(64)
    out["gif_pil_animated.gif"] = pil_bytes(q, "GIF", save_all=True,
                                            append_images=[q.rotate(90)],
                                            duration=50)
    out["unreadable_gif_no_trailer.gif"] = out["gif_interlaced.gif"][:-1]
    out["webp_lossless.webp"] = pil_bytes(Image.fromarray(
        rng.integers(0, 256, (H, W, 3)).astype(np.uint8)), "WEBP",
        lossless=True)
    out["webp_lossless_palette.webp"] = pil_bytes(
        Image.fromarray(rgb).quantize(6).convert("RGB"), "WEBP",
        lossless=True)
    out["webp_lossless_rgba.webp"] = pil_bytes(Image.fromarray(rgba),
                                               "WEBP", lossless=True)
    opaque = np.concatenate([rgb, np.full((H, W, 1), 255, np.uint8)], -1)
    out["webp_lossy_simple_filter.webp"] = tw.webp_encode(
        opaque, filter_type=0, partitions=2, quality=70)
    out["webp_lossy.webp"] = pil_bytes(Image.fromarray(rgb), "WEBP",
                                       quality=80)
    out["webp_lossy_alpha.webp"] = tw.webp_encode(
        rgba, alpha_filtering=1, quality=70)
    frames = [Image.fromarray(rgba), Image.fromarray(rgba[::-1].copy())]
    out["webp_animated.webp"] = pil_bytes(frames[0], "WEBP", save_all=True,
                                          append_images=frames[1:],
                                          lossless=True, duration=40)
    blob = out["webp_lossy.webp"]
    out["unreadable_webp_truncated.webp"] = blob[:len(blob) // 2]
    view = sphere_view()
    view8 = (view * 255).astype(np.uint8)
    out["webp_lossy_612x512.webp"] = pil_bytes(Image.fromarray(view8),
                                               "WEBP", quality=90)
    out["webp_lossless_612x512.webp"] = pil_bytes(Image.fromarray(view8),
                                                  "WEBP", lossless=True)
    small = sphere_view(110)[..., ::-1].astype(np.float32)
    out["hdr_612x512.hdr"] = cv2.imencode(".hdr", np.ascontiguousarray(
        np.round(small * 64) / 64))[1].tobytes()
    levels = Image.fromarray(view8).quantize(24)
    out["bmp_rle8_612x512.bmp"] = tw.bmp_file(
        BIG[0], BIG[1], 8, tw.bmp_rle(np.asarray(levels), 8),
        compression=1, palette=np.asarray(levels.getpalette()[:72])
        .reshape(24, 3))
    return out


def thirteenth(rng):
    """TIFF CCITT (MH, T.4 1-D and 2-D, T.6, RLEW, FillOrder 2) and
    ThunderScan; JPEG 2000 (cv2's lossless and lossy files, PIL's raw
    codestream, every progression order, code-block styles, a palette,
    sYCC, 12-bit, packed headers) and what cv2 refuses."""
    import tempfile
    out = {}
    y, x = np.mgrid[:H, :W]
    mask = ((x - 24) ** 2 + (y - 18) ** 2 < 150) ^ ((x + y) % 11 == 0)
    mask[rng.random((H, W)) < 0.03] ^= True
    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "f"
        for name, kw in {"mh": dict(compression=2),
                         "g3_1d": dict(compression=3, t4_options=0),
                         "g3_2d": dict(compression=3, t4_options=5),
                         "g4": dict(compression=4),
                         "g4_fill_order_2": dict(compression=4,
                                                 fill_order=2,
                                                 photometric=1),
                         "g4_tiles": dict(compression=4, tile=(16, 16))
                         }.items():
            out[f"fax_{name}.tif"] = tw.libtiff_bilevel(p, mask, **kw)
        out["fax_rlew.tif"] = tw.rlew_file(mask)
        idx = ((x // 4 + y // 6) % 16).astype(np.uint8)
        pal = [int(v) for v in rng.integers(0, 65536, 48)]
        out["thunderscan.tif"] = tw.tiff_file(
            {256: (3, [W]), 257: (3, [H]), 258: (3, [4]),
             259: (3, [32809]), 262: (3, [3]), 277: (3, [1]),
             278: (3, [H]), 320: (3, pal)}, [tw.thunderscan(idx)])
        out["unreadable_lzma.tif"] = pil_bytes(
            Image.fromarray(smooth(rng, (H, W))), "TIFF", compression="lzma")
        rgb = smooth(rng, (H, W, 3))
        planes = [rgb[..., c].astype(np.int64) for c in range(3)]
        ok, blob = cv2.imencode(".jp2", rgb[..., ::-1])
        out["jp2_cv2_lossy.jp2"] = blob.tobytes()
        rgba16 = smooth(rng, (H, W, 4)).astype(np.uint16) * 257 + 3
        ok, blob = cv2.imencode(".jp2", rgba16, [
            cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000])
        out["jp2_cv2_lossless_rgba16.jp2"] = blob.tobytes()
        out["j2k_pil_grey_97.j2k"] = pil_bytes(
            Image.fromarray(rgb[..., 0]), "JPEG2000", no_jp2=True,
            irreversible=True)
        for prog in tw.PROGRESSION_ORDERS:
            out[f"j2k_{prog.lower()}.jp2"] = tw.openjpeg_encode(
                p, planes, tcp_mct=1, irreversible=prog in ("RPCL", "CPRL"),
                prog_order=prog, precincts=[(16, 16), (32, 32)],
                rates=[20, 5, 1], tile_size_on=1, cp_tdx=32, cp_tdy=24,
                numresolution=3)
        out["j2k_styles_sop_eph.j2k"] = tw.openjpeg_encode(
            p, planes, jp2=False, tcp_mct=1, irreversible=1, mode=63,
            csty=6, rates=[20, 5, 1])
        out["j2k_ppm.j2k"] = tw.packed_headers(tw.openjpeg_encode(
            p, planes, jp2=False, tcp_mct=1, csty=6, rates=[10, 2]), "ppm")
        out["j2k_sycc_12bit.jp2"] = tw.openjpeg_encode(
            p, [c * 16 for c in planes], prec=12, colour=3)
        cs = tw.openjpeg_encode(p, [(x // 5 + y // 7) % 6], jp2=False,
                                numresolution=2)
        out["j2k_palette.jp2"] = tw.jp2_file(
            cs, H, W, 1, 8, pclr=(rng.integers(0, 256, (6, 3)), [8] * 3),
            cmap=[(0, 1, 0), (0, 1, 1), (0, 1, 2)])
        out["unreadable_j2k_signed.jp2"] = tw.openjpeg_encode(
            p, [c - 128 for c in planes], signed=True)
    view = sphere_view()
    view16 = np.round(view * 65535).astype(np.uint16)
    ok, blob = cv2.imencode(".jp2", view16[..., ::-1], [
        cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000])
    out["jp2_lossless16_612x512.jp2"] = blob.tobytes()
    ok, blob = cv2.imencode(".jp2", (view16 >> 8).astype(np.uint8)[..., ::-1])
    out["jp2_lossy8_612x512.jp2"] = blob.tobytes()
    inside = view.max(-1) > 0
    with tempfile.TemporaryDirectory() as d:
        out["g4_mask_612x512.tif"] = tw.libtiff_bilevel(Path(d) / "m.tif",
                                                        inside, 4)
    return out


SCENE = HERE.parent / "jp2_scene"
SCENE_SPHERE = dict(n_views=16, width=256, height=256, radius=0.25)
SCENE_CENTER = (0.2, -0.1, 0.3)


def array_digest(a) -> str:
    import hashlib
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.dtype}{a.shape}".encode()
                          + a.tobytes()).hexdigest()


def jp2_scene():
    """The phase-19 sphere in JPEG 2000 and Group 4 TIFF, and the digests
    of the JAX package's prepared arrays (RGBA order, uint16)."""
    import json
    import shutil
    import tempfile

    from rnb_neus2_torch.testing.synthetic import write_sfm_scene
    from rnb_neus2_tpu.io.dataloaders import load_data as jload
    from rnb_neus2_tpu.io.prepare import prepare_testbed_data as jprepare

    if SCENE.exists():
        shutil.rmtree(SCENE)
    for sub in ("normals", "albedos", "masks"):
        (SCENE / sub).mkdir(parents=True)
    with tempfile.TemporaryDirectory() as d:
        normals, albedos, masks, radius = write_sfm_scene(
            d, "png", world_center=SCENE_CENTER, **SCENE_SPHERE)
        sfm = {k: json.load(open(p)) for k, p in (("normals", normals),
                                                  ("albedos", albedos))}
        for view in sfm["normals"]["views"]:
            src = Path(d) / view["path"]
            img = cv2.imread(str(src), cv2.IMREAD_UNCHANGED)
            view["path"] = str(Path("normals") / (src.stem + ".jp2"))
            assert cv2.imwrite(str(SCENE / view["path"]), img, [
                cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000])
        for view in sfm["albedos"]["views"]:
            src = Path(d) / view["path"]
            img = cv2.imread(str(src), cv2.IMREAD_COLOR)    # 8 bits
            view["path"] = str(Path("albedos") / (src.stem + ".jp2"))
            assert cv2.imwrite(str(SCENE / view["path"]), img)
        mask_views = []
        for view in sfm["normals"]["views"]:
            pid = view["poseId"]
            m = cv2.imread(str(Path(masks) / f"{pid}.png"),
                           cv2.IMREAD_GRAYSCALE)
            path = Path("masks") / f"{pid}.tif"
            Image.fromarray(m > 127).convert("1").save(
                SCENE / path, "TIFF", compression="group4")
            mask_views.append(dict(view, path=str(path)))
        sfm["masks"] = dict(sfm["normals"], views=mask_views)
        for k, v in sfm.items():
            with open(SCENE / f"{k}.sfm.json", "w") as f:
                json.dump(v, f)
    with tempfile.TemporaryDirectory() as d:
        data = jload(str(SCENE / "normals.sfm.json"),
                     albedo_sfm_path=str(SCENE / "albedos.sfm.json"),
                     mask_sfm_path=str(SCENE / "masks.sfm.json"))
        jprepare(data, d)
        tj = json.load(open(Path(d) / "transform.json"))
        expected = {"world_center": list(SCENE_CENTER), "world_radius":
                    radius, "n2w": tj["n2w"], "frames": {}}
        for fr in tj["frames"]:
            rec = {}
            for key in ("normal_path", "albedo_path"):
                img = cv2.imread(str(Path(d) / fr[key]),
                                 cv2.IMREAD_UNCHANGED)[..., [2, 1, 0, 3]]
                rec[key.split("_")[0]] = array_digest(img)
            expected["frames"][Path(fr["normal_path"]).name] = rec
    with open(SCENE / "expected.json", "w") as f:
        json.dump(expected, f, indent=1)
    total = sum(p.stat().st_size for p in SCENE.rglob("*") if p.is_file())
    print(f"jp2_scene: {total} bytes")


def cv2_rgb(path, mode):
    try:
        img = cv2.imread(str(path), MODES[mode])
    except cv2.error:
        img = None
    if img is None:
        return np.zeros(0, np.uint8)
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def main():
    rng = np.random.default_rng(2024)
    files = {**jpegs(rng), **tiffs(rng), **more_formats(rng),
             **thirteenth(np.random.default_rng(16))}
    for old in HERE.iterdir():
        if old.suffix not in (".py", ".npz"):
            old.unlink()
    expected = {}
    for name, blob in sorted(files.items()):
        limit = 512 << 10 if "612x512" in name else 64 << 10
        assert len(blob) <= limit, (name, len(blob))
        (HERE / name).write_bytes(blob)
        for mode in MODES:
            expected[f"{name}:{mode}"] = cv2_rgb(HERE / name, mode)
        read = [m for m in MODES if expected[f"{name}:{m}"].size]
        assert bool(read) != name.startswith("unreadable"), name
    np.savez_compressed(HERE / "expected.npz", **expected)
    total = sum(len(b) for b in files.values())
    print(f"{len(files)} fixtures, {total} bytes; expected.npz "
          f"{(HERE / 'expected.npz').stat().st_size} bytes")
    jp2_scene()


if __name__ == "__main__":
    main()
