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

AVIF (the fourteenth slice): cv2's, PIL's and libaom's files for every
coding tool the port's AV1 decoder has (`tests/test_torch_image_avif.py`
holds their census), the features refused by name and what cv2 cannot
read; `../avif_scene/` is the sphere below in AVIF.

The sixteenth slice: LogLuv 32- and 24-bit and LogL TIFFs in strips and
tiles, written by the host's libtiff (`sgilog_*.tif`); AVIF grids with
alpha and cropped, and 612x512 film-grain and superres AVIFs.

The seventeenth slice: AVIF sequences (cv2's `imwriteanimation` and
Pillow's `save_all` files, and containers built box by box: `co64`,
several chunks, `prem`, a track size that scales the frame, a primary item
that differs from the track's first frame), still items whose `ispe`
scales the frame, and layered images from libaom's encoder driven as
libavif drives it (2 and 4 layers, quality and spatial, `lsel`, alpha,
10 and 12 bits, screen content, the slow speeds' overlapped and warped
motion and inter-intra), with what libavif refuses; 612x512 sequence,
scaled and layered files (phase 19); and `../avis_scene/`.

The twentieth slice: plain multi-frame AV1 streams of libaom's encoder
(`tw.aom_encode_stream`, with look-ahead) in one item, each using an
inter tool (`avif_inter_*`: compound prediction of every type, the skip
mode, shown-existing frames, global motion, segmentation in inter frames
with temporal updates, superres and film grain in inter frames, switch
frames; 8 and 10 bits; a 612x512 stream for phase 19); and
`../avif_inter_scene/`.

The twenty-second slice (`make_fixtures.py exr`): OpenEXR files written
by the host's libOpenEXR 3.1.5 (`tests/torch_exr_library.py`, g++
against `libopenexr-dev`'s headers; this cv2 has no OpenEXR), `exr_*`:
every compression (PIZ, PXR24, B44, B44A, DWAA, DWAB) x HALF / FLOAT /
mixed channels x Y / RGB / RGBA, 1x1, odd sizes, off-origin windows, both
line orders, pLinear B44, DWA levels 5 / 45 / 200, tiles in every level
mode, rounding mode and tile order, multi-part files, the deep, UINT and
subsampled files the port refuses by name, and the sphere's 612x512
normal map in each compression (phase 19's rows). Their `expected.npz`
entry is `Imf::InputFile`'s FLOAT decode of part 0 in the port's channel
order, under ":unchanged" only (the port refuses EXR read as 8-bit
colour or grey); and `../exr_scene/`.

Also the JPEG 2000 / Group 4 sphere scene of `../jp2_scene/` (phase 19):
the port's `write_sfm_scene` PNG sphere (16 views of 256x256) with its
normals rewritten as lossless 16-bit JP2, its albedos as 8-bit JP2 at
cv2's default (lossy) rate and its masks as Group 4 TIFF (a masks.sfm.json
names them), and `expected.json`, digests of what the JAX package's
`prepare_testbed_data` makes of it on this host.

Needs cv2 and PIL (and for `exr` the host's OpenEXR 3.1 headers and
libraries), so it runs where the tests run, not on the card:

    python tests/torch_fixtures/formats/make_fixtures.py [avif | sixteenth | seventeenth | twentieth | exr]
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


def sixteenth(rng):
    """TIFF SGILog (34676) and SGILog24 (34677), written by the host's
    libtiff from float XYZ / Y: LogLuv 32- and 24-bit and LogL, in strips
    and in tiles, with zeros, values past 1 (clipped by the 8-bit path),
    negative Y (LogL's sign bit) and saturated colours; LogL under the
    SGILog24 code, which cv2 does not read. (A 612x512 LogLuv32 view
    takes 160 KB, past the TIFF fixtures' 64 KB: phase 19 assembles its
    612x512 SGILog files itself.) Also AVIF grids (with alpha, cropped;
    one of tiles libavif refuses) and the phase-19 view as film-grain and
    superres AVIFs."""
    import tempfile
    out = {}
    y, x = np.mgrid[:H, :W]
    xyz = (smooth(rng, (H, W, 3)).astype(np.float32) / 255) ** 2 * 1.6
    xyz[:4, :6] = 0
    xyz[-3:, -5:] *= 40
    xyz[5:9, 10:20] = [0.9, 0.05, 0.01]
    xyz[20:24, 30:40] = [0.01, 0.3, 1.2]
    lum = xyz[..., 1] * np.where((x + y) % 9 == 0, -1, 1)
    with tempfile.TemporaryDirectory() as d:
        p = Path(d) / "s.tif"
        for kind, comp in (("luv32", 34676), ("luv24", 34677)):
            out[f"sgilog_{kind}_strips.tif"] = tw.libtiff_sgilog(
                p, xyz, comp, rows_per_strip=7)
            out[f"sgilog_{kind}_tiles.tif"] = tw.libtiff_sgilog(
                p, xyz, comp, tile=(16, 16))
        out["sgilog_logl_strips.tif"] = tw.libtiff_sgilog(
            p, lum, 34676, rows_per_strip=5)
        out["sgilog_logl_tiles.tif"] = tw.libtiff_sgilog(p, lum, 34676,
                                                         tile=(32, 16))
        out["unreadable_sgilog_logl_code24.tif"] = tw.libtiff_sgilog(
            p, lum, 34677)
    # AVIF grids: 3x2 tiles of cv2's RGBA files (an alpha grid as the
    # colour grid's auxl) cropped to 170x120, and tiles under 64 samples
    # (MIAF; libavif refuses them)
    tiles = []
    for _ in range(6):
        rgba = np.dstack([rich(rng, 64, 64), rng.integers(0, 256, (64, 64))
                          .astype(np.uint8)])
        tiles.append(cv2_avif(rgba[..., [2, 1, 0, 3]].copy()))
    out["avif_grid_alpha.avif"] = grid_avif(tiles, 2, 3, (170, 120))
    out["unreadable_avif_grid_small_tiles.avif"] = grid_avif(
        cv2_avif(rich(rng, 48, 48)[..., ::-1].copy()))
    # the phase-19 view with film grain (libaom's test vector 1) and with
    # superres (coded 8/12 as wide), libaom's encoder through ctypes
    view = np.round(sphere_view() * 255).astype(np.uint8)
    out["avif_film_grain_612x512.avif"] = aom_avif(
        view, usage=2, cq=40, options={"cpu-used": 6, "film-grain-test": 1})
    out["avif_superres_612x512.avif"] = aom_avif(
        view, usage=2, cq=30, options={"cpu-used": 6},
        cfg={19: 1, 20: 12, 21: 12})
    return out


def rich(rng, h, w):
    """Texture with edges at many angles, discs and noise: content that
    makes an AV1 encoder use most of its intra tools."""
    base = smooth(rng, (h, w, 3), noise=0.0)
    for _ in range(max(4, h * w // 400)):
        ang, length = rng.uniform(0, np.pi), rng.uniform(6, 40)
        x0, y0 = rng.uniform(0, w), rng.uniform(0, h)
        p2 = (int(x0 + length * np.cos(ang)), int(y0 + length * np.sin(ang)))
        cv2.line(base, (int(x0), int(y0)), p2,
                 tuple(int(v) for v in rng.integers(0, 256, 3)),
                 int(rng.integers(1, 4)), cv2.LINE_AA)
    for _ in range(max(2, h * w // 1500)):
        cv2.circle(base, (int(rng.uniform(0, w)), int(rng.uniform(0, h))),
                   int(rng.uniform(3, 14)),
                   tuple(int(v) for v in rng.integers(0, 256, 3)), -1,
                   cv2.LINE_AA)
    noise = rng.normal(0, 6, base.shape)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def bands(rng, size, width, horizontal):
    """Stripes `width` samples wide, each a colour with a sinusoid along
    it: 64x16, 16x64, 64x32 and 32x64 blocks and transforms."""
    yy, xx = np.mgrid[:size, :size].astype(np.float64)
    idx, t = (yy, xx) if horizontal else (xx, yy)
    img = np.zeros((size, size, 3))
    for b in range(size // width):
        m = (idx // width) == b
        for c in range(3):
            img[..., c][m] = (rng.uniform(40, 200) + 35 * np.sin(
                t / rng.uniform(5, 12) + rng.uniform(0, 6)))[m]
    return np.clip(img, 0, 255).astype(np.uint8)


def pil_avif(img, mode=None, **kw):
    return pil_bytes(Image.fromarray(img, mode), "AVIF", **kw)


def cv2_avif(img, *params):
    ok, blob = cv2.imencode(".avif", img, list(params))
    assert ok
    return blob.tobytes()


def aom_avif(rgb, **kw):
    """libaom's encoder through ctypes (tools no libavif option reaches),
    in a one-item container."""
    from rnb_neus2_torch.io import native
    obus = tw.aom_encode(tw.rgb_to_yuv420(rgb), **kw)
    code, info, _, _ = native.av1_decode(obus)
    assert code == 0, code
    return tw.avif_still(obus, info, colr=(1, 13, 6, 1))


def aom_until(rgb, census_index, settings):
    """The first of `settings` (aom_avif keyword sets) whose frame uses the
    tool at `census_index` of native/av1.cc's census."""
    from rnb_neus2_torch.io import native
    for kw in settings:
        obus = tw.aom_encode(tw.rgb_to_yuv420(rgb), **kw)
        code, info, _, census = native.av1_decode(obus)
        if code == 0 and census[census_index]:
            return tw.avif_still(obus, info, colr=(1, 13, 6, 1))
    raise AssertionError(f"no setting uses tool {census_index}")


def with_colr(blob: bytes, mc: int) -> bytes:
    """`blob` with its colr nclx box's matrix_coefficients set to `mc`."""
    i = blob.find(b"colrnclx")
    assert i > 0
    out = bytearray(blob)
    out[i + 12:i + 14] = mc.to_bytes(2, "big")
    return bytes(out)


def grid_avif(tile_blobs, rows=2, cols=2, size=None) -> bytes:
    """A rows x cols grid derived item over one-item AVIFs' tiles (one
    blob for every tile, or a list in raster order), of output `size`
    (w, h; default the tiles' whole area); where the tiles carry alpha,
    an alpha grid over their alpha items, the colour grid's `auxl`."""
    from rnb_neus2_torch.io import avif
    blobs = tile_blobs if isinstance(tile_blobs, list) \
        else [tile_blobs] * (rows * cols)
    colour, alpha = [], []
    for blob in blobs:
        c = avif.parse(blob, "tile")
        it = c.items[c.primary]
        aux = [c.items[f] for k, f, to in c.refs
               if k == b"auxl" and c.primary in to]
        for dst, item in ((colour, it), (alpha, aux[0] if aux else None)):
            if item is None:
                continue
            w, h = struct.unpack(">II", avif.prop(item, b"ispe")[4:12])
            props = [tw.ispe(w, h), tw.isobmff_box(b"av1C",
                                                   avif.prop(item, b"av1C"))]
            dst.append((avif.item_data(c, item, blob, "tile"), w, h, props))
    w, h = colour[0][1], colour[0][2]
    ow, oh = size or (cols * w, rows * h)
    desc = bytes([0, 0, rows - 1, cols - 1]) + struct.pack(">HH", ow, oh)
    n = rows * cols
    items = [dict(id=1, type=b"grid", data=desc, method=1,
                  props=[tw.ispe(ow, oh), tw.pixi(8, 3)])]
    refs = [(b"dimg", 1, list(range(3, 3 + n)))]
    if alpha:
        urn = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0"
        items.append(dict(id=2, type=b"grid", data=desc, method=1,
                          props=[tw.ispe(ow, oh), tw.pixi(8, 1),
                                 tw.full_box(b"auxC", 0, 0, urn)]))
        refs += [(b"auxl", 2, [1]), (b"dimg", 2, list(range(3 + n, 3 + 2 * n)))]
    for k, (obus, tw_, th, props) in enumerate(colour + alpha):
        items.append(dict(id=3 + k, type=b"av01", data=obus, hidden=True,
                          props=props + [tw.pixi(8, 3 if k < n else 1)]))
    return tw.avif_file(items, refs=refs)


def cv2_sequence(frames, *params) -> bytes:
    """cv2.imwriteanimation's AVIF of `frames` (BGR(A) or grey)."""
    import tempfile
    anim = cv2.Animation()
    anim.frames = [np.ascontiguousarray(f) for f in frames]
    anim.durations = [100] * len(frames)
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "seq.avif")
        assert cv2.imwriteanimation(path, anim, list(params))
        return Path(path).read_bytes()


def tracks_of(blob):
    """[(track, [sample bytes])] of an AVIF sequence."""
    return [(t, t["samples"]) for t in tw.sequence_tracks(blob)]


def later_frames(img):
    """Two frames after `img` that differ from it: shifted and darkened."""
    return [np.roll(img, 3, axis=1), (img.astype(np.int64) * 3 // 4).astype(img.dtype)]


def layered(yuv, layers, depth=8, speed=6, **kw):
    """(layer OBUs, info) of libaom's layered encode (`aom_encode_layers`)."""
    from rnb_neus2_torch.io import native
    obus = tw.aom_encode_layers(yuv, layers, bit_depth=depth, speed=speed, **kw)
    code, info, _, _ = native.av1_decode(b"".join(obus))
    assert code == 0, code
    return obus, info


def layered_until(rng, layers, census_indices, settings):
    """The first of `settings` ((height, width) of a `rich` image and
    aom_encode_layers keyword sets) whose layered stream uses every tool
    at `census_indices`."""
    from rnb_neus2_torch.io import native
    for size, kw in settings:
        obus = tw.aom_encode_layers(tw.rgb_to_yuv420(rich(rng, *size)), layers, **kw)
        code, info, _, census = native.av1_decode(b"".join(obus))
        if code == 0 and all(census[i] for i in census_indices):
            return tw.layered_avif(obus, info, colr=(1, 13, 6, 1))
    raise AssertionError(f"no setting uses tools {census_indices}")


QUALITY2 = [(40, (1, 1)), (12, (1, 1))]
SPATIAL2 = [(30, (1, 2)), (20, (1, 1))]
SPATIAL4 = [(50, (1, 4)), (40, (1, 2)), (30, (1, 2)), (10, (1, 1))]
QUALITY4 = [(60, (1, 1)), (40, (1, 1)), (20, (1, 1)), (5, (1, 1))]


def seventeenth(rng):
    """AVIF sequences, `ispe`-scaled stills and layered images (see the
    module docstring)."""
    out = {}
    h, w = 40, 56
    rgb = rich(rng, h, w)
    bgr = np.ascontiguousarray(rgb[..., ::-1])
    alpha = smooth(rng, (h, w))
    bgra = np.dstack([bgr, alpha])
    deep = smooth(rng, (h, w, 4)).astype(np.uint16) * 257
    # cv2's and Pillow's sequences: the first frame, later ones differ
    out["avis_cv2_rgb.avif"] = cv2_sequence([bgr] + later_frames(bgr))
    out["avis_cv2_rgba.avif"] = cv2_sequence([bgra] + later_frames(bgra))
    out["avis_cv2_q100_444.avif"] = cv2_sequence([bgr] + later_frames(bgr), cv2.IMWRITE_AVIF_QUALITY, 100)
    out["avis_cv2_grey.avif"] = cv2_sequence([bgr[..., 1].copy()] + later_frames(bgr[..., 1].copy()))
    for depth in (10, 12):
        d3 = np.ascontiguousarray(deep[..., :3] >> (16 - depth))
        out[f"avis_cv2_{depth}bit.avif"] = cv2_sequence([d3] + later_frames(d3), cv2.IMWRITE_AVIF_DEPTH, depth)
    d4 = deep >> 4
    out["avis_cv2_rgba_12bit.avif"] = cv2_sequence([d4] + later_frames(d4), cv2.IMWRITE_AVIF_DEPTH, 12)
    frames = [Image.fromarray(f) for f in [rgb] + later_frames(rgb)]
    bio = io.BytesIO()
    frames[0].save(bio, "AVIF", save_all=True, append_images=frames[1:], quality=60)
    out["avis_pil_rgb.avif"] = bio.getvalue()
    frames = [Image.fromarray(np.dstack([f, alpha])) for f in [rgb] + later_frames(rgb)]
    bio = io.BytesIO()
    frames[0].save(bio, "AVIF", save_all=True, append_images=frames[1:], quality=60)
    out["avis_pil_rgba.avif"] = bio.getvalue()
    # containers built box by box around cv2's RGBA samples
    (ct, cs), (at, als) = tracks_of(out["avis_cv2_rgba.avif"])
    cp, ap = ct["props"], at["props"]
    brands = (b"avis", b"mif1", b"miaf", b"msf1", b"iso8")

    def seq(color=None, alpha_track=None, **kw):
        c = dict(id=1, width=w, height=h, samples=cs, props=cp)
        c.update(color or {})
        a = dict(id=2, width=w, height=h, samples=als, props=ap, aux_for=1, handler=b"auxv")
        a.update(alpha_track or {})
        return tw.avis_file([c, a], brands=brands, **kw)
    out["avis_co64_chunks_prem.avif"] = seq(dict(co64=True, chunks=[1, 2], prem_by=2),
                                            dict(co64=True, chunks=[2, 1]))
    out["avis_track_scaled.avif"] = seq(dict(tkhd_size=(61, 29)), dict(tkhd_size=(61, 29)))
    out["unreadable_avis_no_stsd.avif"] = seq(dict(skip=[b"stsd"]))
    out["unreadable_avis_sample_past_end.avif"] = seq(dict(samples=cs, chunks=[3]))[:-200]
    out["unreadable_avis_not_a_key_frame.avif"] = tw.avis_file(
        [dict(id=1, width=w, height=h, samples=cs[1:] + cs[:1], props=cp)], brands=brands)
    # the source rule: a mif1 file whose primary item is another image
    still = cv2_avif(np.ascontiguousarray(bgr[::-1]))
    from rnb_neus2_torch.io import avif
    sc = avif.parse(still, "still")
    it = sc.items[sc.primary]
    item = dict(id=1, type=b"av01", data=avif.item_data(sc, it, still, "still"),
                props=[tw.isobmff_box(k, b) for k, b in it.props])
    (t1, s1), = tracks_of(out["avis_cv2_rgb.avif"])
    out["avis_mif1_track_and_item.avif"] = tw.avis_file(
        [dict(id=1, width=w, height=h, samples=s1, props=t1["props"])],
        items=[item], major=b"mif1")
    # stills whose ispe scales the frame: down, up, non-integer, one axis
    def with_ispe(blob, size):
        b, pos = bytearray(blob), 0
        while (i := b.find(b"ispe", pos)) > 0:
            b[i + 8:i + 16] = struct.pack(">II", *size)
            pos = i + 4
        return bytes(b)
    ok, s8 = cv2.imencode(".avif", bgr)
    out["avif_ispe_down.avif"] = with_ispe(s8.tobytes(), (28, 20))
    ok, s10 = cv2.imencode(".avif", np.ascontiguousarray(deep >> 6), [cv2.IMWRITE_AVIF_DEPTH, 10])
    out["avif_ispe_up_rgba_10bit.avif"] = with_ispe(s10.tobytes(), (112, 80))
    ok, s12 = cv2.imencode(".avif", np.ascontiguousarray(deep[..., :3] >> 4), [cv2.IMWRITE_AVIF_DEPTH, 12])
    out["avif_ispe_noninteger_12bit.avif"] = with_ispe(s12.tobytes(), (45, 31))
    out["avif_ispe_one_axis.avif"] = with_ispe(s8.tobytes(), (56, 17))
    # layered images, libaom's streams in libavif's container
    lh, lw = 64, 96
    lrgb = rich(rng, lh, lw)
    yuv = tw.rgb_to_yuv420(lrgb)
    for name, layers in (("quality", QUALITY2), ("spatial", SPATIAL2), ("4_spatial", SPATIAL4)):
        obus, info = layered(yuv, layers)
        out[f"avif_layers_{name}.avif"] = tw.layered_avif(obus, info, colr=(1, 13, 6, 1))
    obus, info = layered(yuv, SPATIAL4)
    out["avif_layers_lsel_middle.avif"] = tw.layered_avif(obus, info, lsel=1, colr=(1, 13, 6, 1))
    out["unreadable_avif_layers_lsel_past.avif"] = tw.layered_avif(obus, info, lsel=4, colr=(1, 13, 6, 1))
    ess = tw.layered_avif(obus, info, colr=(1, 13, 6, 1), essential_a1lx=True)
    out["unreadable_avif_layers_essential_a1lx.avif"] = ess
    aplane = smooth(rng, (lh, lw))
    aobus, ainfo = layered([aplane, yuv[1], yuv[2]], QUALITY2, monochrome=True,
                           controls={tw.AV1E_SET_COLOR_RANGE: 1})   # full range, as libavif
    out["avif_layers_alpha.avif"] = tw.layered_avif(*layered(yuv, QUALITY2), alpha=aobus,
                                                    alpha_info=ainfo, colr=(1, 13, 6, 1))
    out["avif_layers_alpha_prem.avif"] = tw.layered_avif(*layered(yuv, SPATIAL2), alpha=aobus,
                                                         alpha_info=ainfo, colr=(1, 13, 6, 1),
                                                         premultiplied=True)
    for depth in (10, 12):
        dyuv = [p.astype(np.uint16) << (depth - 8) for p in yuv]
        obus, info = layered(dyuv, SPATIAL2 if depth == 10 else QUALITY2, depth=depth)
        out[f"avif_layers_{depth}bit.avif"] = tw.layered_avif(obus, info, colr=(1, 13, 6, 1))
    # screen content: palette in an inter frame, whole-sample motion
    pal = rng.integers(0, 255, (6, 3))
    idx = (np.add.outer(np.arange(96) // 7, np.arange(128) // 5) + rng.integers(0, 2, (96, 128))) % 6
    obus, info = layered(tw.rgb_to_yuv420(pal[idx].astype(np.uint8)), SPATIAL2,
                         options={"tune-content": "screen"})
    out["avif_layers_screen.avif"] = tw.layered_avif(obus, info, colr=(1, 13, 6, 1))
    # the slow speeds: overlapped and warped motion, smooth and wedge
    # inter-intra (census 124, 125, 127, 109)
    out["avif_layers_slow.avif"] = layered_until(
        rng, QUALITY4, (124, 125, 127, 109),
        [((96, 128), dict(speed=sp)) for _ in range(12) for sp in (1, 0)])
    # tools no libavif layer uses, refused by name: compound prediction
    # and global motion in a plain 4-frame stream
    base = rich(rng, 96, 128).astype(np.int64)
    moving = [tw.rgb_to_yuv420(np.clip(np.roll(np.roll(base, 3 * k, 1), 2 * k, 0), 0, 255).astype(np.uint8))
              for k in range(6)]
    for name, speed, gm in (("compound", 0, 0), ("global_motion", 6, 1)):
        obus = tw.aom_encode_layers(moving, [(30, (1, 1))] * 6, speed=speed, flags=[0] * 6,
                                    spatial=False, options={"enable-global-motion": gm})
        from rnb_neus2_torch.io import native
        code, info, _, _ = native.av1_decode(obus[0])
        out[f"avif_refused_{name}.avif"] = tw.layered_avif(obus, info, colr=(1, 13, 6, 1))
    # phase 19's 612x512 rows: a sequence's first frame, a 306x256 frame
    # scaled to its ispe, a 2-layer spatial image
    view = cv2.imread(str(HERE / "avif_q95_612x512.avif"), cv2.IMREAD_COLOR)
    out["avis_612x512.avif"] = cv2_sequence([view] + later_frames(view), cv2.IMWRITE_AVIF_QUALITY, 60)
    half = cv2.resize(view, (306, 256), interpolation=cv2.INTER_AREA)
    ok, hb = cv2.imencode(".avif", half, [cv2.IMWRITE_AVIF_QUALITY, 80])
    out["avif_ispe_306x256_to_612x512.avif"] = with_ispe(hb.tobytes(), (612, 512))
    obus, info = layered(tw.rgb_to_yuv420(np.ascontiguousarray(view[..., ::-1])), [(45, (1, 2)), (35, (1, 1))])
    out["avif_layers_spatial_612x512.avif"] = tw.layered_avif(obus, info, colr=(1, 13, 6, 1))
    return out


def moving_frames(rng, n, h, w, zoom=False, depth=8):
    """`n` 4:2:0 frames of a `rich` picture moving: shifted 3 samples
    right and 2 down a frame, or turned 1.5 degrees and zoomed 2 % about
    its centre; uint16 at `depth` > 8."""
    base = rich(rng, h + 40, w + 40)
    out = []
    for k in range(n):
        if zoom:
            m = cv2.getRotationMatrix2D(((w + 40) / 2, (h + 40) / 2), 1.5 * k, 1 + 0.02 * k)
            fr = cv2.warpAffine(base, m, (w + 40, h + 40))
        else:
            fr = np.roll(np.roll(base, 3 * k, 1), 2 * k, 0)
        yuv = tw.rgb_to_yuv420(np.ascontiguousarray(fr[20:20 + h, 20:20 + w]))
        out.append([p.astype(np.uint16) << (depth - 8) for p in yuv] if depth > 8 else yuv)
    return out


def stream_until(frames, census_indices, settings, depth=8):
    """(OBUs, info) of the first of `settings` (aom_encode_stream keyword
    sets) whose plain multi-frame stream uses every tool at
    `census_indices` of native/av1.cc's census, decodes and equals
    libaom's decode."""
    from rnb_neus2_torch.io import native
    from torch_avif_reference import libaom_planes
    for kw in settings:
        obus = tw.aom_encode_stream(frames, bit_depth=depth, **kw)
        code, info, planes, census = native.av1_decode(obus)
        if code == 0 and all(census[i] for i in census_indices):
            ref = libaom_planes(obus)
            assert len(ref) == len(planes) and all(np.array_equal(a, b) for a, b in zip(planes, ref))
            return obus, info
        print("  setting", kw, "code", code, "census", {i: int(census[i]) for i in census_indices})
    raise AssertionError(f"no setting uses tools {census_indices}")


def twentieth(rng):
    """Plain multi-frame AV1 streams of libaom's encoder in one item, each
    using an inter tool the port decodes since this slice (census slots of
    native/av1.cc): compound prediction of every type with the skip mode
    and shown-existing frames (look-ahead and alt-reference frames),
    global motion, segmentation in inter frames (cyclic refresh, with
    temporal updates in real-time mode), superres and film grain in inter
    frames, switch frames; 8 and 10 bits; and a 612x512 stream with
    compound prediction and global motion for phase 19's codec rows."""
    out = {}
    h, w = 64, 96
    shift = moving_frames(rng, 12, h, w)
    zoom = moving_frames(rng, 10, h, w, zoom=True)
    gm = {"enable-global-motion": 1}
    cases = [
        ("compound", shift, 8, (128, 131, 133), [dict(lag=12, speed=s) for s in (1, 0, 2)]),
        ("compound_types", shift, 8, (129, 130, 131, 132, 134),
         [dict(speed=0, cq=c) for c in (30, 20, 40)]),
        ("skip_mode", shift, 8, (133,), [dict(lag=12, speed=s) for s in (6, 4)]),
        ("show_existing", shift, 8, (148,), [dict(lag=12, speed=s, cq=40) for s in (4, 6)]),
        ("global_motion", zoom, 8, (128, 141, 144, 146), [dict(lag=10, speed=s, options=gm) for s in (2, 1, 3)]),
        ("segmentation", shift, 8, (150, 151), [dict(speed=s, options={"aq-mode": 3}) for s in (6, 4)]),
        ("segmentation_temporal", shift, 8, (150, 152),
         [dict(usage=1, speed=s, options={"aq-mode": 3}) for s in (7, 8, 6)]),
        ("superres", shift, 8, (161,), [dict(lag=12, cfg={19: 1, 20: d, 21: d}) for d in (12, 16)]),
        ("film_grain", shift, 8, (162,), [dict(lag=12, options={"film-grain-test": t}) for t in (1, 2)]),
        ("switch_frame", shift, 8, (164,), [dict(lag=12, cfg={49: d, 50: 1}) for d in (4, 3)]),
    ]
    for depth in (10,):
        deep = [[p.astype(np.uint16) << 2 for p in f] for f in shift]
        deep_zoom = [[p.astype(np.uint16) << 2 for p in f] for f in zoom]
        cases += [("compound_10bit", deep, depth, (128, 133, 148), [dict(lag=12, speed=s) for s in (1, 2)]),
                  ("global_motion_10bit", deep_zoom, depth, (141, 144, 146),
                   [dict(lag=10, speed=s, options=gm) for s in (2, 1)]),
                  ("film_grain_10bit", deep, depth, (162,), [dict(lag=12, options={"film-grain-test": 1})])]
    for name, frames, depth, slots, settings in cases:
        obus, info = stream_until(frames, slots, settings, depth)
        out[f"avif_inter_{name}.avif"] = tw.avif_still(obus, info, colr=(1, 13, 6, 1))
    # phase 19's row: the 612x512 view moving (turned and zoomed)
    view = cv2.imread(str(HERE / "avif_q95_612x512.avif"), cv2.IMREAD_COLOR)[..., ::-1]
    frames = []
    for k in range(4):
        m = cv2.getRotationMatrix2D((306, 256), 1.0 * (3 - k), 1 + 0.015 * (3 - k))
        frames.append(tw.rgb_to_yuv420(np.ascontiguousarray(cv2.warpAffine(view, m, (612, 512)))))
    obus, info = stream_until(frames, (128, 144, 146), [dict(lag=4, speed=s, options=gm) for s in (4, 2)])
    out["avif_inter_tools_612x512.avif"] = tw.avif_still(obus, info, colr=(1, 13, 6, 1))
    return out


def fourteenth(rng):
    """AVIF: cv2's own files at its defaults, quality 50 and 100, 10 and
    12 bits, grey, RGBA and odd sizes; PIL's (libavif 1.3 + aom) for the
    subsamplings, tiles, 128x128 superblocks, screen content, alpha
    premultiplied, irot/imir, limited range and aom's advanced options;
    libaom's encoder through ctypes for intra block copy, loop
    restoration's switchable type, the 64-point rectangular transforms,
    variance-AQ segmentation (two passes) and superres; hand-built containers for a grid, a sequence and what
    cv2 refuses; three 612x512 files for phase 20."""
    out = {}
    img = rich(rng, 64, 96)
    bgr = img[..., ::-1].copy()
    out["avif_cv2_default.avif"] = cv2_avif(bgr)
    out["avif_cv2_q95.avif"] = cv2_avif(bgr, cv2.IMWRITE_AVIF_QUALITY, 95)
    out["avif_cv2_q50.avif"] = cv2_avif(bgr, cv2.IMWRITE_AVIF_QUALITY, 50)
    out["avif_cv2_q100.avif"] = cv2_avif(bgr, cv2.IMWRITE_AVIF_QUALITY, 100)
    deep = (smooth(rng, (48, 64, 3), 0.05).astype(np.uint16) * 257)
    out["avif_cv2_10bit.avif"] = cv2_avif(deep >> 6, cv2.IMWRITE_AVIF_DEPTH, 10)
    out["avif_cv2_12bit.avif"] = cv2_avif(deep >> 4, cv2.IMWRITE_AVIF_DEPTH, 12)
    out["avif_cv2_10bit_lossless.avif"] = cv2_avif(
        deep >> 6, cv2.IMWRITE_AVIF_DEPTH, 10, cv2.IMWRITE_AVIF_QUALITY, 100)
    out["avif_cv2_12bit_lossless.avif"] = cv2_avif(
        deep >> 4, cv2.IMWRITE_AVIF_DEPTH, 12, cv2.IMWRITE_AVIF_QUALITY, 100)
    out["avif_cv2_grey.avif"] = cv2_avif(img[..., 1].copy())
    out["avif_cv2_grey_10bit.avif"] = cv2_avif(deep[..., 0] >> 6, cv2.IMWRITE_AVIF_DEPTH, 10)
    alpha = np.clip(np.add.outer(np.arange(64) * 3, np.arange(96) * 2), 0, 255).astype(np.uint8)
    out["avif_cv2_rgba.avif"] = cv2_avif(np.dstack([bgr, alpha]))
    deep_a = np.dstack([deep, deep[..., :1][::-1]])
    out["avif_cv2_rgba_10bit.avif"] = cv2_avif(deep_a >> 6, cv2.IMWRITE_AVIF_DEPTH, 10)
    out["avif_cv2_rgba_12bit.avif"] = cv2_avif(deep_a >> 4, cv2.IMWRITE_AVIF_DEPTH, 12)
    for w, h in ((1, 1), (17, 9), (65, 33)):
        out[f"avif_cv2_{w}x{h}.avif"] = cv2_avif(rich(rng, h, w)[..., ::-1].copy())
    nat = rich(rng, 96, 96)
    out["avif_422.avif"] = pil_avif(nat, quality=50, speed=0, subsampling="4:2:2")
    out["avif_444.avif"] = pil_avif(nat, quality=50, speed=0, subsampling="4:4:4",
                                    advanced={"enable-chroma-deltaq": "1"})
    out["avif_400.avif"] = pil_avif(nat, quality=50, speed=0, subsampling="4:0:0")
    out["avif_q20_speed0.avif"] = pil_avif(nat, quality=20, speed=0)
    out["avif_tiles_2x2.avif"] = pil_avif(nat, quality=50, speed=2, tile_rows=1,
                                          tile_cols=1, autotiling=False)
    out["avif_sb128.avif"] = pil_avif(rich(rng, 160, 160), quality=40, speed=1,
                                      advanced={"sb-size": "128"})
    few = (rich(rng, 96, 96) // 64 * 64 + 32).astype(np.uint8)
    out["avif_palette.avif"] = pil_avif(few, quality=70, speed=1,
                                        advanced={"tune-content": "screen"})
    out["avif_qm.avif"] = pil_avif(nat, quality=40, speed=2,
                                   advanced={"enable-qm": "1", "qm-min": "2"})
    out["avif_deltaq_lf.avif"] = aom_avif(rich(rng, 256, 256), usage=2, cq=30, options={
        "cpu-used": 2, "deltaq-mode": 2, "delta-lf-mode": 1})
    out["avif_segmentation.avif"] = aom_avif(rich(rng, 96, 96), usage=0, cq=30, options={
        "cpu-used": 2, "aq-mode": 1, "deltaq-mode": 0}, two_pass=True)
    out["avif_lr.avif"] = pil_avif(nat, quality=40, speed=1,
                                   advanced={"enable-restoration": "1"})
    lr = rich(rng, 256, 256)
    blur = cv2.GaussianBlur(rich(rng, 256, 256), (0, 0), 3)
    lr[:, 128:] = blur[:, 128:]
    lr[128:, :128] = np.clip(blur[128:, :128] + rng.normal(0, 20, (128, 128, 3)), 0, 255)
    out["avif_lr_switchable.avif"] = aom_until(lr, 80, [dict(
        usage=u, cq=cq, options={"cpu-used": cpu, "enable-restoration": 1})
        for cq in (35, 20, 50) for u in (0, 2) for cpu in (1, 0)])
    for width, hor in ((16, True), (16, False), (32, True), (32, False)):
        name = f"avif_tx64_{width}{'h' if hor else 'v'}.avif"
        out[name] = aom_avif(bands(rng, 256, width, hor), usage=0, cq=20,
                             options={"cpu-used": 0})
    tile = rng.integers(0, 256, (32, 32, 3)).astype(np.float64)
    ibc = np.tile(tile, (4, 12, 1))
    yy, xx = np.mgrid[:128, :384]
    ramp = ((xx % 16) * 3 - (yy % 8) * 4)[..., None] * np.array([1, -1, 0.5])
    ibc = np.clip(ibc + ramp + rng.normal(0, 3, ibc.shape), 0, 255).astype(np.uint8)
    out["avif_intrabc.avif"] = aom_avif(ibc, usage=0, cq=20, options={
        "cpu-used": 2, "tune-content": "screen", "enable-intrabc": 1,
        "reduced-tx-type-set": 0})
    lim = pil_avif(nat, quality=60, range="limited")
    out["avif_bt709_limited.avif"] = with_colr(lim, 1)
    out["avif_bt2020_limited.avif"] = with_colr(lim, 9)
    full = out["avif_cv2_q95.avif"]
    out["avif_bt709_full.avif"] = with_colr(full, 1)
    out["avif_smpte240_full.avif"] = with_colr(full, 7)
    rgba = np.dstack([nat[:64], alpha[:, :96]])
    out["avif_premultiplied.avif"] = pil_avif(rgba, quality=80, alpha_premultiplied=True)
    for name, orient in (("irot", 6), ("imir", 2)):
        exif = Image.Exif()
        exif[0x0112] = orient
        out[f"avif_{name}.avif"] = pil_avif(nat[:40], quality=70, exif=exif.tobytes())
    flat = np.clip(np.stack(np.broadcast_arrays(
        80 + np.arange(96)[None], 120 + np.arange(96)[:, None] * 0.5,
        np.full((96, 96), 100.0)), -1) + rng.normal(0, 4, (96, 96, 3)), 0, 255).astype(np.uint8)
    out["avif_film_grain.avif"] = pil_avif(flat, quality=60,
                                           advanced={"denoise-noise-level": "25"})
    out["avif_superres.avif"] = aom_avif(rich(rng, 64, 64), usage=2, cq=30,
                                         options={"cpu-used": 4}, cfg={19: 1, 20: 16, 21: 16})
    out["avif_grid.avif"] = grid_avif(cv2_avif(rich(rng, 64, 64)[..., ::-1].copy()))
    good = out["avif_cv2_q95.avif"]
    out["unreadable_avif_truncated.avif"] = good[:len(good) * 2 // 3]
    bad = bytearray(good)
    i = bad.find(b"iloc") + 4 + 4 + 2 + 2 + 2 + 2 + 2
    bad[i:i + 4] = (len(good) + 100).to_bytes(4, "big")     # extent offset past the end
    out["unreadable_avif_bad_iloc.avif"] = bytes(bad)
    bad = bytearray(good)
    bad[bad.find(b"mdat") + 4] |= 0x80                       # OBU forbidden bit
    out["unreadable_avif_bad_obu.avif"] = bytes(bad)
    out["unreadable_avif_grey_alpha.avif"] = pil_avif(
        np.dstack([nat[..., 0], alpha[:, :96].repeat(2, 0)[:96]]), mode="LA",
        quality=80, subsampling="4:0:0")
    view8 = np.round(sphere_view() * 255).astype(np.uint8)[..., ::-1].copy()
    out["avif_q95_612x512.avif"] = cv2_avif(view8, cv2.IMWRITE_AVIF_QUALITY, 95)
    out["avif_lossless444_612x512.avif"] = cv2_avif(view8, cv2.IMWRITE_AVIF_QUALITY, 100)
    view12 = np.round(sphere_view() * 4095).astype(np.uint16)[..., ::-1].copy()
    out["avif_12bit_612x512.avif"] = cv2_avif(view12, cv2.IMWRITE_AVIF_DEPTH, 12)
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
    write_expected(SCENE, radius)


AVIF_SCENE = HERE.parent / "avif_scene"


def avif_scene():
    """The phase-19 sphere in AVIF: normals lossless 8-bit 4:4:4, albedos
    at cv2's default quality, masks lossless grey; and the digests of the
    JAX package's prepared arrays (RGBA order, uint16)."""
    import json
    import shutil
    import tempfile

    from rnb_neus2_torch.testing.synthetic import write_sfm_scene

    if AVIF_SCENE.exists():
        shutil.rmtree(AVIF_SCENE)
    for sub in ("normals", "albedos", "masks"):
        (AVIF_SCENE / sub).mkdir(parents=True)
    with tempfile.TemporaryDirectory() as d:
        normals, albedos, masks, radius = write_sfm_scene(
            d, "png", world_center=SCENE_CENTER, **SCENE_SPHERE)
        sfm = {k: json.load(open(p)) for k, p in (("normals", normals),
                                                  ("albedos", albedos))}
        for key, params in (("normals", [cv2.IMWRITE_AVIF_QUALITY, 100]),
                            ("albedos", [])):
            for view in sfm[key]["views"]:
                src = Path(d) / view["path"]
                img = cv2.imread(str(src), cv2.IMREAD_COLOR)    # 8 bits
                view["path"] = str(Path(key) / (src.stem + ".avif"))
                assert cv2.imwrite(str(AVIF_SCENE / view["path"]), img, params)
        mask_views = []
        for view in sfm["normals"]["views"]:
            pid = view["poseId"]
            m = cv2.imread(str(Path(masks) / f"{pid}.png"),
                           cv2.IMREAD_GRAYSCALE)
            path = Path("masks") / f"{pid}.avif"
            assert cv2.imwrite(str(AVIF_SCENE / path), m,
                               [cv2.IMWRITE_AVIF_QUALITY, 100])
            assert np.array_equal(cv2.imread(str(AVIF_SCENE / path),
                                             cv2.IMREAD_UNCHANGED), m)
            mask_views.append(dict(view, path=str(path)))
        sfm["masks"] = dict(sfm["normals"], views=mask_views)
        for k, v in sfm.items():
            with open(AVIF_SCENE / f"{k}.sfm.json", "w") as f:
                json.dump(v, f)
    write_expected(AVIF_SCENE, radius)


AVIS_SCENE = HERE.parent / "avis_scene"


def avis_scene():
    """The phase-19 sphere with normals as 3-frame AVIF sequences whose
    first frame is the view (cv2's lossless 4:4:4; then the view shifted
    and darkened), albedos as 2-layer layered AVIFs (half size, then the
    view: libaom's spatial layers as libavif encodes them) and PNG masks;
    and the digests of the JAX package's prepared arrays."""
    import json
    import shutil
    import tempfile

    from rnb_neus2_torch.io import native
    from rnb_neus2_torch.testing.synthetic import write_sfm_scene

    if AVIS_SCENE.exists():
        shutil.rmtree(AVIS_SCENE)
    for sub in ("normals", "albedos", "masks"):
        (AVIS_SCENE / sub).mkdir(parents=True)
    with tempfile.TemporaryDirectory() as d:
        normals, albedos, masks, radius = write_sfm_scene(
            d, "png", world_center=SCENE_CENTER, **SCENE_SPHERE)
        sfm = {k: json.load(open(p)) for k, p in (("normals", normals),
                                                  ("albedos", albedos))}
        for view in sfm["normals"]["views"]:
            src = Path(d) / view["path"]
            img = cv2.imread(str(src), cv2.IMREAD_COLOR)       # 8 bits
            view["path"] = str(Path("normals") / (src.stem + ".avif"))
            (AVIS_SCENE / view["path"]).write_bytes(cv2_sequence(
                [img] + later_frames(img), cv2.IMWRITE_AVIF_QUALITY, 100))
            assert np.array_equal(cv2.imread(str(AVIS_SCENE / view["path"]),
                                             cv2.IMREAD_COLOR), img)
        for view in sfm["albedos"]["views"]:
            src = Path(d) / view["path"]
            rgb = cv2.imread(str(src), cv2.IMREAD_COLOR)[..., ::-1]
            obus = tw.aom_encode_layers(tw.rgb_to_yuv420(np.ascontiguousarray(rgb)),
                                        [(40, (1, 2)), (16, (1, 1))])
            code, info, _, _ = native.av1_decode(b"".join(obus))
            assert code == 0, code
            view["path"] = str(Path("albedos") / (src.stem + ".avif"))
            (AVIS_SCENE / view["path"]).write_bytes(
                tw.layered_avif(obus, info, colr=(1, 13, 6, 1)))
        mask_views = []
        for view in sfm["normals"]["views"]:
            pid = view["poseId"]
            path = Path("masks") / f"{pid}.png"
            shutil.copy(Path(masks) / f"{pid}.png", AVIS_SCENE / path)
            mask_views.append(dict(view, path=str(path)))
        sfm["masks"] = dict(sfm["normals"], views=mask_views)
        for k, v in sfm.items():
            with open(AVIS_SCENE / f"{k}.sfm.json", "w") as f:
                json.dump(v, f)
    write_expected(AVIS_SCENE, radius)


AVIF_INTER_SCENE = HERE.parent / "avif_inter_scene"


def avif_inter_scene():
    """The phase-19 sphere with normals and albedos as plain multi-frame
    AV1 streams in one item (libaom with look-ahead and global motion:
    the view turned and zoomed, then the view itself, the last frame
    shown), which together use compound prediction, global motion and
    shown-existing frames; PNG masks; and the digests of the JAX
    package's prepared arrays."""
    import json
    import shutil
    import tempfile

    from rnb_neus2_torch.io import native
    from rnb_neus2_torch.testing.synthetic import write_sfm_scene

    if AVIF_INTER_SCENE.exists():
        shutil.rmtree(AVIF_INTER_SCENE)
    for sub in ("normals", "albedos", "masks"):
        (AVIF_INTER_SCENE / sub).mkdir(parents=True)
    used = np.zeros(native.AV1_CENSUS, np.int64)
    with tempfile.TemporaryDirectory() as d:
        normals, albedos, masks, radius = write_sfm_scene(
            d, "png", world_center=SCENE_CENTER, **SCENE_SPHERE)
        sfm = {k: json.load(open(p)) for k, p in (("normals", normals),
                                                  ("albedos", albedos))}
        noise = np.random.default_rng(23)
        # normals: 8 frames at speed 2 (compound prediction, global motion
        # warps); albedos: 12 frames with noise before the view at speed 4
        # (compound prediction, the skip mode, shown-existing frames)
        for key, n, speed, cq, sigma in (("normals", 8, 2, 8, 0), ("albedos", 12, 4, 16, 4)):
            for view in sfm[key]["views"]:
                src = Path(d) / view["path"]
                rgb = np.ascontiguousarray(cv2.imread(str(src), cv2.IMREAD_COLOR)[..., ::-1])
                frames = []
                for k in range(n):
                    j = n - 1 - k
                    m = cv2.getRotationMatrix2D((128, 128), 1.5 * j, 1 + 0.015 * j)
                    fr = cv2.warpAffine(rgb, m, (256, 256), borderMode=cv2.BORDER_REPLICATE).astype(np.float64)
                    if j:
                        fr += noise.normal(0, sigma, fr.shape)
                    frames.append(tw.rgb_to_yuv420(np.clip(np.round(fr), 0, 255).astype(np.uint8)))
                obus = tw.aom_encode_stream(frames, cq=cq, lag=n, speed=speed,
                                            options={"enable-global-motion": 1})
                code, info, _, census = native.av1_decode(obus)
                assert code == 0, code
                used += census
                view["path"] = str(Path(key) / (src.stem + ".avif"))
                (AVIF_INTER_SCENE / view["path"]).write_bytes(
                    tw.avif_still(obus, info, colr=(1, 13, 6, 1)))
        assert used[128] and used[148] and (used[143] or used[144] or used[145]), used[128:165]
        mask_views = []
        for view in sfm["normals"]["views"]:
            pid = view["poseId"]
            path = Path("masks") / f"{pid}.png"
            shutil.copy(Path(masks) / f"{pid}.png", AVIF_INTER_SCENE / path)
            mask_views.append(dict(view, path=str(path)))
        sfm["masks"] = dict(sfm["normals"], views=mask_views)
        for k, v in sfm.items():
            with open(AVIF_INTER_SCENE / f"{k}.sfm.json", "w") as f:
                json.dump(v, f)
    write_expected(AVIF_INTER_SCENE, radius)


# ------------------------------------------------------------------ EXR
# the twenty-second slice: files written by the host's OpenEXR 3.1.5
# (`tests/torch_exr_library.py`), each with `Imf::InputFile`'s decode as its
# expected array (cv2 here has no OpenEXR; its EXR decoder reads with that
# call)
EXR_SCENE = HERE.parent / "exr_scene"
EXR_SETS = {("B", "G", "R"): "RGB", ("A", "B", "G", "R"): "RGBA",
            ("Y",): "Y"}


def exr_library():
    import torch_exr_library as ex
    return ex


def exr_decode(path) -> np.ndarray:
    """`Imf::InputFile`'s FLOAT decode of part 0 as the port returns it:
    RGB(A) (H, W, 3|4) or a lone Y (H, W); other channel sets stacked in
    the header's order; an empty array where the library throws."""
    r = exr_library().read(path)
    if "error" in r:
        return np.zeros(0, np.float32)
    ch = r["channels"]
    kind = EXR_SETS.get(tuple(ch))
    if kind == "Y":
        return ch["Y"]
    order = list(kind) if kind else list(ch)
    return np.stack([ch[c] for c in order], -1)


def exr_as_cv2(path) -> np.ndarray:
    """What cv2 with OpenEXR hands the JAX package for an RGB(A) or Y
    file: the library's decode, BGR(A)."""
    img = exr_decode(path)
    return img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]]


def exr_plane(rng, h, w, c=0, flat=False, positive=False):
    """A smooth plane (past 1 and, unless `positive`, below 0 from the
    second channel on; unless `positive`, with a little noise on a coarse
    grid), so that every codec shrinks it, and unless `flat` a row of
    runs, sparse spikes and (unless `positive`) subnormal halves; a constant 8x8 block (a B44A
    3-byte block, a DC-only DCT block). PIZ keeps a bitmap of the 16-bit
    values used: small files shrink only where they span few of them."""
    y, x = np.mgrid[:h, :w].astype(np.float64)
    img = 0.5 + 0.45 * np.sin(x / (5.0 + c) + c) * np.cos(y / (4.0 + c))
    img = img * (1 + c) - (0 if positive else 0.3 * c)
    if positive:       # few significant bits: FLOAT's low words repeat
        img = np.round(img * 256) / 256
    else:
        img += rng.integers(-2, 3, (h, w)) / 512
    if not flat:
        img[h // 3] = np.round(img[h // 3], 1)
        img[::13, ::11] = 4.0
        if not positive:
            img[2::17, 3::19] = 1e-6
    if h >= 16 and w >= 16:
        img[8:16, 8:16] = 0.25
    return img


def exr_channels(rng, h, w, names, kind, positive=False):
    """{name: plane} in HALF ("half"), FLOAT ("float") or, for "mixed",
    FLOAT G (or A) among HALF ones."""
    out = {}
    for c, n in enumerate(names):
        f32 = kind == "float" or (kind == "mixed" and n in "GA")
        out[n] = exr_plane(rng, h, w, c, positive=positive).astype(
            np.float32 if f32 else np.float16)
    return out


def exr_write(name, *parts) -> bytes:
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / name
        exr_library().write(path, *parts)
        return path.read_bytes()


def exr_fixtures(rng) -> dict:
    """The EXR variants: each compression x HALF / FLOAT / mixed x Y / RGB
    / RGBA at odd sizes and off-origin windows in both line orders; 1x1,
    a row, a column, a constant plane and a PIZ chunk past 2^14 values
    (wdec16); pLinear B44 / B44A; DWA levels 5, 45 and 200, RGBA (A as
    RLE), Y alone and a DWAB file of two chunks; tiles 8x8, 16x32 and
    64x64 in ONE / MIPMAP / RIPMAP, ROUND_DOWN / UP and INCREASING /
    DECREASING / RANDOM_Y order; multi-part files of 2 and 3 parts whose
    part 0 is scan-line or tiled; the refused deep, UINT and subsampled
    Y/RY/BY files; and the 612x512 normal map of the sphere (HALF RGB) in
    every compression and in 64x64 ZIP tiles, which phase 19 times."""
    ex = exr_library()
    files = {}
    shapes = [(23, 37), (33, 19), (40, 64), (17, 5), (29, 48), (35, 33)]
    # DWA's header, rules and code table outweigh a small chunk's samples
    dwa_shapes = [(40, 64), (57, 48), (64, 45), (33, 72), (48, 48), (61, 39)]
    windows = [(0, 0), (3, -2), (-7, 11), (100, 50), (0, 0), (-1, -1)]
    i = 0
    for comp in ("PIZ", "PXR24", "B44", "B44A", "DWAA", "DWAB"):
        for chans in ("Y", "RGB", "RGBA"):
            for kind in ("half", "float", "mixed"):
                if chans == "Y" and kind == "mixed":
                    continue
                h, w = (dwa_shapes if comp.startswith("DWA")
                        else shapes)[i % len(shapes)]
                order = "decreasing" if i % 2 else "increasing"
                name = f"exr_{comp.lower()}_{kind}_{chans.lower()}.exr"
                files[name] = exr_write(name, ex.part(
                    exr_channels(rng, h, w, chans, kind,
                                 positive=comp == "PIZ"), comp,
                    window=windows[i % len(windows)], line_order=order))
                i += 1
        name = f"exr_{comp.lower()}_1x1.exr"
        files[name] = exr_write(name, ex.part(
            exr_channels(rng, 1, 1, "RGB", "mixed"), comp, window=(5, 7)))
    for name, (h, w), kind, flat in (
            ("exr_piz_row.exr", (1, 160), "half", False),
            ("exr_piz_column.exr", (160, 1), "float", False),
            ("exr_piz_constant.exr", (24, 24), "half", True),
            ("exr_piz_wdec16.exr", (32, 1024), "half", False)):
        if flat:
            chans = {n: np.full((h, w), 0.75, np.float16) for n in "RGB"}
        elif "wdec16" in name:
            # 32,768 distinct 16-bit words in the chunk, finite halves
            # of both signs: past 2^14, so the wavelet is wdec16
            k = np.arange(h * w).reshape(h, w)
            bits = np.where(k < 0x7C00, k, 0x8000 + k - 0x7C00)
            chans = {"Y": bits.astype(np.uint16).view(np.float16)}
        else:           # a narrow range: a short bitmap of used values
            t = np.linspace(0, 6, h * w).reshape(h, w)
            chans = {n: (np.round((0.7 + 0.2 * np.sin(t + c)) * 512) / 512)
                     .astype(np.float16 if kind == "half" else np.float32)
                     for c, n in enumerate("RGB")}
        files[name] = exr_write(name, ex.part(chans, "PIZ"))
    for comp in ("B44", "B44A"):
        name = f"exr_{comp.lower()}_plinear.exr"
        files[name] = exr_write(name, ex.part(
            exr_channels(rng, 21, 30, "RGB", "half"), comp,
            plinear="RGB"))
    for comp in ("DWAA", "DWAB"):
        for level in (5, 45, 200):
            name = f"exr_{comp.lower()}_level{level}.exr"
            files[name] = exr_write(name, ex.part(
                exr_channels(rng, 40, 48, "RGB", "half"), comp,
                dwa_level=float(level)))
    name = "exr_dwaa_y_plinear.exr"
    files[name] = exr_write(name, ex.part(
        exr_channels(rng, 48, 64, "Y", "half"), "DWAA", plinear="Y"))
    name = "exr_dwab_two_chunks.exr"
    files[name] = exr_write(name, ex.part(
        exr_channels(rng, 300, 9, "RGB", "half"), "DWAB", window=(2, -40)))
    tiled = [  # size, tile, level mode, rounding, order, compression,
               # channels, kind
        ((23, 37), (8, 8), "one", "down", "increasing", "ZIP", "RGB", "half"),
        ((23, 37), (8, 8), "mipmap", "down", "decreasing", "B44A", "RGBA",
         "mixed"),
        ((23, 37), (8, 8), "ripmap", "up", "random", "DWAA", "RGB", "mixed"),
        ((50, 70), (16, 32), "one", "up", "random", "PXR24", "RGB", "float"),
        ((50, 70), (16, 32), "mipmap", "up", "increasing", "B44", "Y", "half"),
        ((50, 70), (16, 32), "ripmap", "down", "decreasing", "NO", "RGB",
         "mixed"),
        ((64, 64), (64, 64), "one", "down", "decreasing", "PIZ", "RGB",
         "mixed"),
        ((30, 100), (64, 64), "mipmap", "down", "random", "DWAB", "RGBA",
         "half"),
        ((30, 100), (64, 64), "ripmap", "up", "increasing", "RLE", "RGB",
         "half"),
        ((20, 30), (16, 32), "one", "down", "increasing", "ZIPS", "Y", "half")]
    for j, (size, tile, mode, rnd, order, comp, chans, kind) in \
            enumerate(tiled):
        name = (f"exr_tiled_{tile[0]}x{tile[1]}_{mode}_{rnd}_{order}_"
                f"{comp.lower()}.exr")
        files[name] = exr_write(name, ex.part(
            exr_channels(rng, *size, chans, kind, positive=comp == "PIZ"),
            comp, tiles=tile, level_mode=mode, rounding=rnd,
            line_order=order, window=windows[j % len(windows)]))
    other = {n: np.full((6, 7), 2.0, np.float16) for n in "RGB"}
    name = "exr_multipart_scanline.exr"
    files[name] = exr_write(name, ex.part(
        exr_channels(rng, 27, 31, "RGB", "mixed", positive=True), "PIZ"),
        ex.part(other, "ZIP", tiles=(8, 8)))
    name = "exr_multipart_tiled.exr"
    files[name] = exr_write(name, ex.part(
        exr_channels(rng, 27, 31, "RGBA", "half"), "DWAA", tiles=(16, 16),
        level_mode="mipmap"), ex.part(other, "ZIP"),
        ex.part({"Y": np.full((5, 5), 3.0, np.float32)}, "PXR24"))
    name = "exr_multipart_y.exr"
    files[name] = exr_write(name, ex.part(
        exr_channels(rng, 14, 22, "Y", "half"), "B44", window=(-3, 4)),
        ex.part(other, "RLE", window=(-3, 4)))
    name = "exr_refused_deep.exr"
    deep = exr_channels(rng, 6, 9, "RGB", "float")
    deep["Z"] = np.linspace(1, 2, 54, dtype=np.float32).reshape(6, 9)
    files[name] = exr_write(name, ex.part(deep, "ZIPS", deep=True))
    name = "exr_refused_uint.exr"
    files[name] = exr_write(name, ex.part(
        {n: rng.integers(0, 1 << 20, (7, 9)).astype(np.uint32)
         for n in "RGB"}, "PIZ"))
    name = "exr_refused_subsampled.exr"
    files[name] = exr_write(name, ex.part(
        {"Y": exr_plane(rng, 8, 12).astype(np.float16),
         "RY": exr_plane(rng, 4, 6).astype(np.float16),
         "BY": exr_plane(rng, 4, 6).astype(np.float16)}, "ZIP",
        sampling={"RY": (2, 2), "BY": (2, 2)}))
    big = {n: (sphere_view()[..., c] * 2 - 1).astype(np.float16)
           for c, n in enumerate("RGB")}
    for comp in ("PIZ", "PXR24", "B44", "B44A", "DWAA", "DWAB"):
        name = f"exr_{comp.lower()}_612x512.exr"
        files[name] = exr_write(name, ex.part(big, comp))
    name = "exr_tiled_zip_612x512.exr"
    files[name] = exr_write(name, ex.part(big, "ZIP", tiles=(64, 64)))
    return files


def exr_scene():
    """The phase-19 sphere in the EXR variants: normals as HALF PIZ, DWAA
    and 16x16-tiled mip-mapped ZIP files in turn by view (view 0's as
    part 0 of a 2-part file), albedos as FLOAT PXR24 and HALF B44A in
    turn, PNG masks; and the digests of the JAX package's prepared arrays
    with `cv2.imread` returning the library's decode of the EXR files."""
    import json
    import shutil
    import tempfile

    from rnb_neus2_torch.testing.synthetic import write_sfm_scene

    ex = exr_library()
    if EXR_SCENE.exists():
        shutil.rmtree(EXR_SCENE)
    for sub in ("normals", "albedos", "masks"):
        (EXR_SCENE / sub).mkdir(parents=True)
    with tempfile.TemporaryDirectory() as d:
        normals, albedos, masks, radius = write_sfm_scene(
            d, "png", world_center=SCENE_CENTER, **SCENE_SPHERE)
        sfm = {k: json.load(open(p)) for k, p in (("normals", normals),
                                                  ("albedos", albedos))}
        for i, view in enumerate(sfm["normals"]["views"]):
            src = Path(d) / view["path"]
            rgb = cv2.imread(str(src), cv2.IMREAD_UNCHANGED)[..., [2, 1, 0]]
            n = {c: (rgb[..., k] / 65535.0 * 2 - 1).astype(np.float16)
                 for k, c in enumerate("RGB")}
            view["path"] = str(Path("normals") / (src.stem + ".exr"))
            out = EXR_SCENE / view["path"]
            if i == 0:
                ex.write(out, ex.part(n, "PIZ"), ex.part(
                    {c: np.zeros((16, 16), np.float16) for c in "RGB"},
                    "ZIP", tiles=(16, 16)))
            else:
                ex.write(out, (ex.part(n, "PIZ"), ex.part(n, "DWAA"),
                               ex.part(n, "ZIP", tiles=(16, 16),
                                       level_mode="mipmap"))[i % 3])
        for i, view in enumerate(sfm["albedos"]["views"]):
            src = Path(d) / view["path"]
            rgb = cv2.imread(str(src), cv2.IMREAD_UNCHANGED)[..., [2, 1, 0]]
            a = rgb / 65535.0
            view["path"] = str(Path("albedos") / (src.stem + ".exr"))
            if i % 2 == 0:
                p = ex.part({c: a[..., k].astype(np.float32)
                             for k, c in enumerate("RGB")}, "PXR24")
            else:
                p = ex.part({c: a[..., k].astype(np.float16)
                             for k, c in enumerate("RGB")}, "B44A")
            ex.write(EXR_SCENE / view["path"], p)
        mask_views = []
        for view in sfm["normals"]["views"]:
            pid = view["poseId"]
            path = Path("masks") / f"{pid}.png"
            shutil.copy(Path(masks) / f"{pid}.png", EXR_SCENE / path)
            mask_views.append(dict(view, path=str(path)))
        sfm["masks"] = dict(sfm["normals"], views=mask_views)
        for k, v in sfm.items():
            with open(EXR_SCENE / f"{k}.sfm.json", "w") as f:
                json.dump(v, f)
    real = cv2.imread
    cv2.imread = lambda p, f=cv2.IMREAD_COLOR: (
        exr_as_cv2(p) if str(p).endswith(".exr") else real(p, f))
    try:
        write_expected(EXR_SCENE, radius)
    finally:
        cv2.imread = real


SGILOG_SCENE = HERE.parent / "sgilog_scene"
# cv2's XYZ → RGB (sRGB primaries, D65), which the albedos go through
# backwards so that cv2 reads them back close to the PNG scene's
XYZ2RGB = np.array([[3.240479, -1.53715, -0.498535],
                    [-0.969256, 1.875991, 0.041556],
                    [0.055648, -0.204043, 1.057311]])


def sgilog_scene():
    """The phase-19 sphere with SGILog albedos (LogLuv of the PNG albedos'
    float XYZ, which cv2 reads back as RGB: views 1 and 9 SGILog24, whose
    uncompressed 3 bytes a sample take 197 KB a view, the others SGILog),
    grid AVIF normals (each view 2x2 tiles of
    cv2's lossless encodes, as `grid_avif` builds them) and 8-bit PNG
    masks; and the digests of the JAX package's prepared arrays."""
    import json
    import shutil
    import tempfile

    from rnb_neus2_torch.testing.synthetic import write_sfm_scene

    if SGILOG_SCENE.exists():
        shutil.rmtree(SGILOG_SCENE)
    for sub in ("normals", "albedos", "masks"):
        (SGILOG_SCENE / sub).mkdir(parents=True)
    to_xyz = np.linalg.inv(XYZ2RGB)
    with tempfile.TemporaryDirectory() as d:
        normals, albedos, masks, radius = write_sfm_scene(
            d, "png", world_center=SCENE_CENTER, **SCENE_SPHERE)
        sfm = {k: json.load(open(p)) for k, p in (("normals", normals),
                                                  ("albedos", albedos))}
        for k, view in enumerate(sfm["albedos"]["views"]):
            src = Path(d) / view["path"]
            rgb = cv2.imread(str(src), cv2.IMREAD_UNCHANGED)[..., 2::-1]
            xyz = (rgb.astype(np.float64) / 65535) @ to_xyz.T
            view["path"] = str(Path("albedos") / (src.stem + ".tif"))
            tw.libtiff_sgilog(SGILOG_SCENE / view["path"],
                              xyz.astype(np.float32),
                              34677 if k % 8 == 1 else 34676,
                              rows_per_strip=32)
        for view in sfm["normals"]["views"]:
            src = Path(d) / view["path"]
            img = cv2.imread(str(src), cv2.IMREAD_COLOR)       # 8 bits
            h, w = img.shape[:2]
            tiles = [cv2_avif(np.ascontiguousarray(
                img[r * h // 2:(r + 1) * h // 2, c * w // 2:(c + 1) * w // 2]),
                cv2.IMWRITE_AVIF_QUALITY, 100)
                for r in range(2) for c in range(2)]
            view["path"] = str(Path("normals") / (src.stem + ".avif"))
            (SGILOG_SCENE / view["path"]).write_bytes(
                grid_avif(tiles, 2, 2, (w, h)))
            assert np.array_equal(cv2.imread(str(SGILOG_SCENE / view["path"]),
                                             cv2.IMREAD_COLOR), img)
        mask_views = []
        for view in sfm["normals"]["views"]:
            pid = view["poseId"]
            path = Path("masks") / f"{pid}.png"
            shutil.copy(Path(masks) / f"{pid}.png", SGILOG_SCENE / path)
            mask_views.append(dict(view, path=str(path)))
        sfm["masks"] = dict(sfm["normals"], views=mask_views)
        for k, v in sfm.items():
            with open(SGILOG_SCENE / f"{k}.sfm.json", "w") as f:
                json.dump(v, f)
    write_expected(SGILOG_SCENE, radius)


def write_expected(scene: Path, radius: float) -> None:
    """`scene`/expected.json: the world sphere, the JAX package's n2w and
    the digests of its prepared normals and albedos (RGBA, uint16)."""
    import json
    import tempfile

    from rnb_neus2_tpu.io.dataloaders import load_data as jload
    from rnb_neus2_tpu.io.prepare import prepare_testbed_data as jprepare

    with tempfile.TemporaryDirectory() as d:
        data = jload(str(scene / "normals.sfm.json"),
                     albedo_sfm_path=str(scene / "albedos.sfm.json"),
                     mask_sfm_path=str(scene / "masks.sfm.json"))
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
    with open(scene / "expected.json", "w") as f:
        json.dump(expected, f, indent=1)
    total = sum(p.stat().st_size for p in scene.rglob("*") if p.is_file())
    print(f"{scene.name}: {total} bytes")


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
    """All fixtures and the scenes; `make_fixtures.py avif` rewrites only
    the AVIF files, their entries of expected.npz and the AVIF scene;
    `make_fixtures.py sixteenth` only the sixteenth slice's files (SGILog,
    the new AVIFs) and their entries; `make_fixtures.py seventeenth` the
    seventeenth's (sequences, scaled and layered AVIFs), their entries and
    the avis scene; `make_fixtures.py twentieth` the twentieth's (plain
    multi-frame AV1 streams using compound prediction, global motion and
    the other inter tools), their entries and the avif_inter scene;
    `make_fixtures.py exr` the EXR files written by OpenEXR, their
    entries and the EXR scene."""
    only = sys.argv[1] if sys.argv[1:] in (["avif"], ["sixteenth"], ["seventeenth"], ["twentieth"], ["exr"]) else None
    if only == "exr":
        files = exr_fixtures(np.random.default_rng(25))
        for old in HERE.glob("exr_*.exr"):
            old.unlink()
        with np.load(HERE / "expected.npz") as z:
            expected = {k: z[k] for k in z.files
                        if not k.split(":")[0].endswith(".exr")}
    elif only == "twentieth":
        files = twentieth(np.random.default_rng(23))
        with np.load(HERE / "expected.npz") as z:
            expected = {k: z[k] for k in z.files
                        if k.split(":")[0] not in files}
    elif only == "seventeenth":
        files = seventeenth(np.random.default_rng(20))
        with np.load(HERE / "expected.npz") as z:
            expected = {k: z[k] for k in z.files
                        if k.split(":")[0] not in files}
    elif only == "sixteenth":
        files = sixteenth(np.random.default_rng(19))
        with np.load(HERE / "expected.npz") as z:
            expected = {k: z[k] for k in z.files
                        if k.split(":")[0] not in files}
    elif only == "avif":
        files = fourteenth(np.random.default_rng(17))
        for old in HERE.glob("*.avif"):
            old.unlink()
        with np.load(HERE / "expected.npz") as z:
            expected = {k: z[k] for k in z.files
                        if not k.split(":")[0].endswith(".avif")}
    else:
        rng = np.random.default_rng(2024)
        files = {**jpegs(rng), **tiffs(rng), **more_formats(rng),
                 **thirteenth(np.random.default_rng(16)),
                 **fourteenth(np.random.default_rng(17)),
                 **sixteenth(np.random.default_rng(19)),
                 **seventeenth(np.random.default_rng(20)),
                 **twentieth(np.random.default_rng(23)),
                 **exr_fixtures(np.random.default_rng(25))}
        for old in HERE.iterdir():
            if old.suffix not in (".py", ".npz"):
                old.unlink()
        expected = {}
    for name, blob in sorted(files.items()):
        limit = 512 << 10 if "612x512" in name else 64 << 10
        if name.endswith(".exr"):   # B44 keeps 14 of each 32 bytes
            limit *= 2
        assert len(blob) <= limit, (name, len(blob))
        (HERE / name).write_bytes(blob)
        if name.endswith(".exr"):
            # the library's decode; the port reads EXR unchanged only
            expected[f"{name}:unchanged"] = exr_decode(HERE / name)
            continue
        for mode in MODES:
            expected[f"{name}:{mode}"] = cv2_rgb(HERE / name, mode)
        read = [m for m in MODES if expected[f"{name}:{m}"].size]
        assert bool(read) != name.startswith("unreadable"), name
    np.savez_compressed(HERE / "expected.npz", **expected)
    total = sum(len(b) for b in files.values())
    print(f"{len(files)} fixtures, {total} bytes; expected.npz "
          f"{(HERE / 'expected.npz').stat().st_size} bytes")
    if only is None:
        jp2_scene()
    if only in (None, "avif"):
        avif_scene()
    if only in (None, "sixteenth"):
        sgilog_scene()
    if only in (None, "seventeenth"):
        avis_scene()
    if only in (None, "twentieth"):
        avif_inter_scene()
    if only in (None, "exr"):
        exr_scene()


if __name__ == "__main__":
    main()
