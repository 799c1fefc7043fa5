"""Write the image-format fixtures of this folder and `expected.npz`,
cv2's decode of each in IMREAD_UNCHANGED, _COLOR and _GRAYSCALE (RGB(A)
order; an empty array where cv2 returns None).

One small file per JPEG and TIFF variant that the port reads, written by
cv2, PIL or the writers of `tests/torch_image_writers.py`, and a few that
cv2 cannot read either; among them a 612x512 progressive JPEG and the
same file cut after 3 of its scans, and a progressive and a baseline
file that end inside a scan. `chip_smoke.py` (phase 20) decodes
them on the card's host, which has neither cv2 nor PIL, and
tests/test_torch_image_variants.py holds them against `expected.npz`.

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
    files = {**jpegs(rng), **tiffs(rng)}
    for old in HERE.iterdir():
        if old.suffix in (".jpg", ".tif"):
            old.unlink()
    expected = {}
    for name, blob in sorted(files.items()):
        assert len(blob) <= 64 << 10, (name, len(blob))
        (HERE / name).write_bytes(blob)
        for mode in MODES:
            expected[f"{name}:{mode}"] = cv2_rgb(HERE / name, mode)
        read = [m for m in MODES if expected[f"{name}:{m}"].size]
        assert bool(read) != name.startswith("unreadable"), name
    np.savez_compressed(HERE / "expected.npz", **expected)
    total = sum(len(b) for b in files.values())
    print(f"{len(files)} fixtures, {total} bytes; expected.npz "
          f"{(HERE / 'expected.npz').stat().st_size} bytes")


if __name__ == "__main__":
    main()
