"""TIFF read and write with numpy, zlib, the LZW/PackBits helpers of
`native/codecs.cc` and the port's JPEG decoder: no `cv2`, `PIL` or
`tifffile`, which the card's host does not have.

Reads the first image of a TIFF or BigTIFF as `cv2.imread` does (byte
order `II` or `MM`): strips or tiles (edge tiles cropped), planar
configuration 1 or 2; compression none (1), LZW (5), Deflate (8, 32946),
PackBits (32773) or JPEG (7, with JPEGTables, through `io/jpeg.py`);
predictor none, horizontal differencing (2) or floating point (3);
orientations 1-8 in every mode, as `exif.orient` (5-8 only for square
images: cv2 transposes in place and fails on others). cv2 reads 1-, 4-
(palette) and 8-bit files through libtiff's RGBA interface in every
mode, and so does this reader: MinIsBlack and MinIsWhite grey (1 or 8
bits, an alpha sample ignored), palette (16-bit colormap entries scaled
by >> 8 unless all are below 256), RGB (an unassociated 8-bit alpha
premultiplied as (v·a + 127) // 255), CMYK (InkSet 1: each channel
(255 - k)·(255 - v) // 255, alpha 255) and YCbCr (libtiff's
TIFFYCbCrToRGB, chroma subsampled by replication; under JPEG
compression libjpeg's conversion); signed 8-bit samples as their
unsigned bytes. 16-, 32- and 64-bit samples come back unchanged
(uint16, int16, uint32, int32, float32, float64) in IMREAD_UNCHANGED,
in RGB(A) order, and 16-bit ones scaled to 8 bits under IMREAD_COLOR /
_GRAYSCALE.

What cv2 cannot read either raises `errors.UnreadableImage`: 2-bit
samples, 4-bit grey, orientations 5-8 of a non-square image, 16-bit
CMYK, CMYK with alpha, float16, 32- and 64-bit samples read as 8-bit
colour or grey. What cv2 reads and this reader does not raises
`errors.UnsupportedImage`: old-style JPEG (6) and other compressions,
16-bit and float planar-separate files of several samples (which cv2
decodes into uninitialized memory), 16-bit grey tiles of partial width
read as 8-bit, grey with more than one extra sample, other photometric
interpretations.

Writes strip TIFFs as cv2 writes them: LZW with horizontal differencing
for 8 and 16 bits, uncompressed float.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from . import exif, jpeg, native
from .errors import unreadable, unsupported

SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")
NONE, LZW, DEFLATE, ADOBE_DEFLATE, PACKBITS, JPEG = 1, 5, 32946, 8, 32773, 7
COMPRESSIONS = (NONE, LZW, DEFLATE, ADOBE_DEFLATE, PACKBITS)
PREDICTED = (LZW, DEFLATE, ADOBE_DEFLATE)
# field type → (struct code, size)
TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
         6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
         11: ("f", 4), 12: ("d", 8), 13: ("I", 4), 16: ("Q", 8),
         17: ("q", 8), 18: ("Q", 8)}
MINISWHITE, MINISBLACK, RGB, PALETTE, SEPARATED, YCBCR = 0, 1, 2, 3, 5, 6


def _ifd(blob: bytes, path):
    """The first IFD → (byte order, {tag: values})."""
    if len(blob) < 16 or blob[:4] not in SIGNATURES:
        unreadable(path, "not a TIFF file")
    order = "<" if blob[:2] == b"II" else ">"
    big = blob[2:4] in (b"+\x00", b"\x00+")
    try:
        if big:
            size, _, offset = struct.unpack_from(order + "HHQ", blob, 4)
            if size != 8:
                unreadable(path, f"BigTIFF with {size}-byte offsets")
            n, = struct.unpack_from(order + "Q", blob, offset)
            head, entry, inline = offset + 8, 20, 8
        else:
            offset, = struct.unpack_from(order + "I", blob, 4)
            n, = struct.unpack_from(order + "H", blob, offset)
            head, entry, inline = offset + 2, 12, 4
        if offset < 8 or head + entry * n > len(blob):
            unreadable(path, "TIFF directory outside the file")
        tags = {}
        for i in range(n):
            at = head + entry * i
            tag, typ = struct.unpack_from(order + "HH", blob, at)
            count, = struct.unpack_from(order + ("Q" if big else "I"), blob,
                                        at + 4)
            raw = blob[at + (12 if big else 8):][:inline]
            if typ not in TYPES:
                continue
            code, size = TYPES[typ]
            nbytes = size * count
            data = raw if nbytes <= inline else blob[struct.unpack(
                order + ("Q" if big else "I"), raw)[0]:][:nbytes]
            if len(data) < nbytes:
                unreadable(path, f"TIFF tag {tag} past the end of the file")
            tags[tag] = struct.unpack(order + code * count, data[:nbytes]) \
                if typ != 2 else (data[:nbytes].rstrip(b"\0")
                                  .decode("latin-1"),)
    except struct.error:
        unreadable(path, "truncated TIFF directory")
    return order, tags


class _Layout:
    """What the first image needs, checked against what is read."""

    def __init__(self, tags, path):
        self.tags = tags
        if 256 not in tags or 257 not in tags:
            unreadable(path, "TIFF without ImageWidth or ImageLength")
        self.w, self.h = tags[256][0], tags[257][0]
        self.spp = tags.get(277, (1,))[0]
        bits = set(tags.get(258, (1,)))
        fmt = set(tags.get(339, (1,)))
        if len(bits) != 1 or len(fmt) != 1:
            unsupported(path, "TIFF with mixed sample sizes or formats")
        self.bits, self.fmt = bits.pop(), fmt.pop()
        self.photometric = tags.get(262, (MINISBLACK,))[0]
        self.planar = tags.get(284, (1,))[0]
        self.comp = tags.get(259, (1,))[0]
        self.orientation = tags.get(274, (1,))[0]
        self.extra = tags.get(338, ())
        self.tiled = 322 in tags or 324 in tags
        grey = self.photometric in (MINISWHITE, MINISBLACK)
        bits, fmt, spp, ph = self.bits, self.fmt, self.spp, self.photometric
        # what cv2 refuses
        if bits == 2 or (bits == 4 and ph != PALETTE):
            unreadable(path, f"{bits}-bit TIFF")
        if self.orientation >= 5 and self.w != self.h:
            # cv2 transposes in place, which fails unless the image is
            # square
            unreadable(path, f"TIFF Orientation {self.orientation} of a "
                       f"{self.w}x{self.h} image")
        if not 1 <= self.orientation <= 8:
            unsupported(path, f"TIFF Orientation {self.orientation}")
        if ph == SEPARATED and (bits != 8 or spp != 4):
            unreadable(path, f"{bits}-bit TIFF CMYK with {spp} samples")
        if fmt == 3 and bits == 16:
            unreadable(path, "float16 TIFF")
        # what this reader does not read
        dtype = {(1, 1): np.uint8, (4, 1): np.uint8, (8, 1): np.uint8,
                 (8, 2): np.int8, (16, 1): np.uint16, (16, 2): np.int16,
                 (32, 1): np.uint32, (32, 2): np.int32, (32, 3): np.float32,
                 (64, 3): np.float64}.get((bits, fmt))
        if dtype is None:
            unsupported(path, f"TIFF with {bits}-bit samples of "
                        f"SampleFormat {fmt}")
        self.dtype = np.dtype(dtype)
        if self.comp == JPEG:
            if bits != 8:
                unsupported(path, f"{bits}-bit JPEG-compressed TIFF")
        elif self.comp not in COMPRESSIONS:
            unsupported(path, f"TIFF compression {self.comp}")
        kinds = {MINISWHITE: (1, 2), MINISBLACK: (1, 2), RGB: (3, 4),
                 PALETTE: (1,), SEPARATED: (4,), YCBCR: (3,)}
        if spp not in kinds.get(ph, ()):
            unsupported(path, f"TIFF with {spp} samples per pixel and "
                        f"PhotometricInterpretation {ph}")
        if bits == 1 and ph not in (MINISWHITE, MINISBLACK, PALETTE):
            unsupported(path, f"1-bit TIFF of PhotometricInterpretation "
                        f"{ph}")
        if ph == YCBCR and (bits != 8 or (self.comp != JPEG
                                          and self.planar != 1)):
            unsupported(path, "YCbCr TIFF other than 8-bit contiguous")
        if self.planar == 2 and spp > 1 and bits > 8:
            unsupported(path, f"planar-separate {bits}-bit TIFF of {spp} "
                        "samples (cv2 decodes it into uninitialized "
                        "memory)")
        # the 8-bit path, libtiff's RGBA interface; but cv2 reads signed
        # 8-bit samples as they are under IMREAD_UNCHANGED
        self.rgba = bits <= 8 or spp == 2
        self.raw_int8 = self.dtype == np.int8 and spp != 2
        # libtiff applies a predictor only under LZW and Deflate
        self.predictor = tags.get(317, (1,))[0] \
            if self.comp in PREDICTED else 1
        if self.predictor not in (1, 2, 3) or (self.predictor == 3
                                               and fmt != 3) \
                or (self.predictor == 2 and bits < 8):
            unsupported(path, f"TIFF Predictor {self.predictor} for "
                        f"{bits}-bit samples")
        if self.tiled:
            if 322 not in tags or 323 not in tags or 324 not in tags:
                unreadable(path, "tiled TIFF without its tile tags")
            self.cw, self.ch = tags[322][0], tags[323][0]
            self.offsets, self.counts = tags[324], tags.get(325)
        else:
            if 273 not in tags:
                unreadable(path, "TIFF without StripOffsets")
            self.cw, self.ch = self.w, min(tags.get(278, (self.h,))[0],
                                           self.h)
            self.offsets, self.counts = tags[273], tags.get(279)
        if self.cw == 0 or self.ch == 0:
            unreadable(path, "TIFF with empty tiles or strips")


def _decompress(blob, offset, count, comp, size, path) -> bytes:
    data = blob[offset:offset + count]
    try:
        if comp == NONE:
            out = data
        elif comp == LZW:
            out = native.lzw_decode(data, size)
        elif comp == PACKBITS:
            out = native.packbits_decode(data, size)
        else:
            out = zlib.decompress(data)
    except (ValueError, zlib.error) as e:
        unsupported(path, f"corrupt TIFF data ({e})")
    if len(out) < size:
        unsupported(path, f"TIFF chunk of {len(out)} bytes, want {size}, "
                    "(a short chunk)")
    return out[:size]


def _samples(raw: bytes, rows, cols, spp, lay, order) -> np.ndarray:
    """One chunk's bytes → (rows, cols, spp) samples, predictor undone."""
    if lay.bits < 8:
        per_row = -(-cols * spp * lay.bits // 8)
        bits = np.unpackbits(np.frombuffer(raw, np.uint8)
                             .reshape(rows, per_row), axis=1)
        bits = bits[:, :cols * spp * lay.bits].reshape(rows, -1, lay.bits)
        weights = 1 << np.arange(lay.bits - 1, -1, -1)
        return (bits * weights).sum(-1).astype(np.uint8) \
            .reshape(rows, cols, spp)
    size = lay.dtype.itemsize
    a = np.frombuffer(raw, np.uint8).reshape(rows, cols * spp * size)
    if lay.predictor == 3:
        planes = np.cumsum(a.reshape(rows, -1, spp), axis=1,
                           dtype=np.uint8).reshape(rows, size, cols * spp)
        # byte planes, most significant first, whatever the byte order
        return np.ascontiguousarray(planes.transpose(0, 2, 1)).view(
            lay.dtype.newbyteorder(">")).astype(lay.dtype) \
            .reshape(rows, cols, spp)
    uint = np.dtype(f"u{size}")
    vals = a.view(uint.newbyteorder(order)).astype(uint) \
        .reshape(rows, cols, spp)
    if lay.predictor == 2:
        vals = np.cumsum(vals, axis=1, dtype=uint)
    return vals.view(lay.dtype)


def _chunk_grid(lay):
    """(y, x, rows, cols) of every chunk of one plane, in file order."""
    out = []
    for y in range(0, lay.h, lay.ch):
        for x in range(0, lay.w, lay.cw):
            out.append((y, x, min(lay.ch, lay.h - y), min(lay.cw, lay.w - x)))
    return out


def _decode(blob, lay, order, path) -> np.ndarray:
    """The image's samples, (h, w, spp) of lay.dtype; under JPEG
    compression (h, w, 3) RGB or (h, w) grey uint8, colour converted as
    libtiff's JPEG codec hands it to the RGBA interface."""
    grid = _chunk_grid(lay)
    planes = lay.spp if lay.planar == 2 else 1
    per = lay.spp // planes
    if len(lay.offsets) < len(grid) * planes:
        unreadable(path, f"TIFF with {len(lay.offsets)} chunks, want "
                   f"{len(grid) * planes}")
    counts = lay.counts
    if lay.comp == JPEG:
        return _decode_jpeg(blob, lay, grid, path)
    if lay.photometric == YCBCR:
        return _decode_ycbcr(blob, lay, grid, path)
    row_bytes = -(-lay.cw * per * lay.bits // 8)
    size = row_bytes * lay.ch
    if counts is None:
        if lay.comp != NONE:
            unsupported(path, "compressed TIFF without StripByteCounts")
        counts = [size] * len(lay.offsets)
    out = np.zeros((lay.h, lay.w, lay.spp), lay.dtype)
    for p in range(planes):
        for i, (y, x, rows, cols) in enumerate(grid):
            k = p * len(grid) + i
            # a strip holds its rows only; a tile is always whole
            n_rows = lay.ch if lay.tiled else rows
            raw = _decompress(blob, lay.offsets[k], counts[k], lay.comp,
                              row_bytes * n_rows, path)
            s = _samples(raw, n_rows, lay.cw, per, lay, order)
            out[y:y + rows, x:x + cols, p * per:(p + 1) * per] = \
                s[:rows, :cols]
    return out


def _decode_ycbcr(blob, lay, grid, path) -> np.ndarray:
    """Uncompressed YCbCr strips: their packed units (see
    `_ycbcr_to_rgb`), concatenated."""
    sh, sv = lay.tags.get(530, (2, 2))
    if lay.tiled or (lay.ch % sv and len(grid) > 1):
        unsupported(path, "tiled YCbCr TIFF, or strips of partial blocks")
    unit = sh * sv + 2
    parts = []
    for i, (y, x, rows, cols) in enumerate(grid):
        size = -(-rows // sv) * -(-cols // sh) * unit
        count = lay.counts[i] if lay.counts else size
        parts.append(_decompress(blob, lay.offsets[i], count, lay.comp,
                                 size, path))
    return np.frombuffer(b"".join(parts), np.uint8)


def _decode_jpeg(blob, lay, grid, path) -> np.ndarray:
    tables = bytes(lay.tags.get(347, ())) if 347 in lay.tags else b""
    if lay.photometric == YCBCR:
        colour = "ycc"                 # libtiff asks libjpeg for RGB
    elif lay.photometric in (MINISBLACK, MINISWHITE):
        colour = "grey"
    elif lay.photometric == RGB:
        colour = "rgb"                 # JCS_UNKNOWN: no conversion
    else:
        unsupported(path, f"JPEG-compressed TIFF of "
                    f"PhotometricInterpretation {lay.photometric}")
    ch = 1 if colour == "grey" else 3
    out = np.zeros((lay.h, lay.w, ch), np.uint8)
    counts = lay.counts or [len(blob) - o for o in lay.offsets]
    for i, (y, x, rows, cols) in enumerate(grid):
        part = blob[lay.offsets[i]:lay.offsets[i] + counts[i]]
        img = jpeg.decode_jpeg(part, path, "unchanged", tables, colour)
        img = img.reshape(img.shape[0], img.shape[1], -1)
        out[y:y + rows, x:x + cols] = img[:rows, :cols, :ch]
    return out


def _ycbcr_tables(lay):
    """libtiff's TIFFYCbCrToRGBInit in float32, as it computes it."""
    f32 = np.float32
    luma = [f32(a) / f32(b) for a, b in zip(*[iter(lay.tags.get(
        529, (299, 1000, 587, 1000, 114, 1000)))] * 2)]
    ref = [f32(a) / f32(b) for a, b in zip(*[iter(lay.tags.get(
        532, (0, 1, 255, 1, 128, 1, 255, 1, 128, 1, 255, 1)))] * 2)]

    def fix(v):
        return int(np.float32(v) * np.float32(65536) + np.float32(0.5))

    def clampf(v, lo, hi):
        return min(max(v, f32(lo)), f32(hi))
    f1 = f32(2) - f32(2) * luma[0]
    d1 = fix(clampf(f1, 0, 2))
    f2 = luma[0] * f1 / luma[1]
    d2 = -fix(clampf(f2, 0, 2))
    f3 = f32(2) - f32(2) * luma[2]
    d3 = fix(clampf(f3, 0, 2))
    f4 = luma[2] * f3 / luma[1]
    d4 = -fix(clampf(f4, 0, 2))

    def code2v(c, rb, rw, cr):
        rb_i = int(rb)
        den = f32(rw - rb) if rw - rb != 0 else f32(1)
        return f32(f32(c - rb_i) * f32(cr)) / den

    cr_r, cb_b, cr_g, cb_g, y_tab = [], [], [], [], []
    for i in range(256):
        x = i - 128
        cr = int(clampf(code2v(x, ref[4] - f32(128), ref[5] - f32(128),
                               127), -128 * 32, 128 * 32))
        cb = int(clampf(code2v(x, ref[2] - f32(128), ref[3] - f32(128),
                               127), -128 * 32, 128 * 32))
        cr_r.append((d1 * cr + (1 << 15)) >> 16)
        cb_b.append((d3 * cb + (1 << 15)) >> 16)
        cr_g.append(d2 * cr)
        cb_g.append(d4 * cb + (1 << 15))
        y_tab.append(int(clampf(code2v(x + 128, ref[0], ref[1], 255),
                                -128 * 32, 128 * 32)))
    return [np.array(t, np.int64) for t in (cr_r, cb_b, cr_g, cb_g, y_tab)]


def _ycbcr_to_rgb(raw: np.ndarray, lay) -> np.ndarray:
    """Uncompressed YCbCr: (h, w, 3) samples as stored → RGB. The data
    holds blocks of sh x sv Y samples then one Cb and one Cr (TIFF 6.0
    section 21); chroma replicated over its block, as libtiff's
    putcontig8bitYCbCr*tile do."""
    sh, sv = lay.tags.get(530, (2, 2))
    h, w = lay.h, lay.w
    bw, bh = -(-w // sh), -(-h // sv)
    data = raw.reshape(-1)
    units = data[:bw * bh * (sh * sv + 2)].reshape(bh, bw, sh * sv + 2)
    y = units[..., :sh * sv].reshape(bh, bw, sv, sh).transpose(0, 2, 1, 3) \
        .reshape(bh * sv, bw * sh)[:h, :w]
    cb = np.repeat(np.repeat(units[..., -2], sv, 0), sh, 1)[:h, :w]
    cr = np.repeat(np.repeat(units[..., -1], sv, 0), sh, 1)[:h, :w]
    cr_r, cb_b, cr_g, cb_g, y_tab = _ycbcr_tables(lay)
    yv = y_tab[np.minimum(y, 255)]
    out = np.stack([yv + cr_r[cr], yv + ((cb_g[cb] + cr_g[cr]) >> 16),
                    yv + cb_b[cb]], -1)
    return np.clip(out, 0, 255).astype(np.uint8)


def _rgba(img: np.ndarray, lay, path) -> np.ndarray:
    """libtiff's RGBA interface: samples → (h, w, 4) uint8."""
    ph, h, w = lay.photometric, lay.h, lay.w
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if lay.comp == JPEG:
        out[..., :3] = img if img.shape[2] == 3 else img[..., :1]
        return out
    if img.dtype == np.int8:
        img = img.view(np.uint8)
    if img.dtype.itemsize == 2:            # 16-bit grey with alpha
        img = (img.view(np.uint16) >> 8).astype(np.uint8)
    if ph in (MINISWHITE, MINISBLACK):
        top = (1 << min(lay.bits, 8)) - 1
        v = img[..., 0].astype(np.int32)
        v = (top - v if ph == MINISWHITE else v) * 255 // top
        out[..., :3] = v[..., None]
        if lay.spp == 2:
            out[..., 3] = img[..., 1]
    elif ph == PALETTE:
        cmap = np.array(lay.tags.get(320, ()), np.int64)
        n = 1 << lay.bits
        if cmap.size != 3 * n:
            unreadable(path, f"TIFF colormap of {cmap.size} entries, want "
                       f"{3 * n}")
        if (cmap >= 256).any():
            cmap = cmap >> 8
        out[..., :3] = cmap.reshape(3, n).T[img[..., 0]]
    elif ph == SEPARATED:
        v = img.astype(np.int32)
        k = 255 - v[..., 3:]
        out[..., :3] = k * (255 - v[..., :3]) // 255
    elif ph == YCBCR:
        out[..., :3] = _ycbcr_to_rgb(img, lay)
    else:
        out[..., :img.shape[2]] = img
        if lay.spp == 4 and lay.extra[:1] == (2,):
            a = img[..., 3:].astype(np.uint32)
            out[..., :3] = (img[..., :3] * a + 127) // 255
    return out


def read_tiff(path, mode: str = "unchanged") -> np.ndarray:
    """The first image as `cv2.imread` gives it, in RGB(A) order. mode
    "unchanged" (IMREAD_UNCHANGED): (H, W) or (H, W, 3|4) of the file's
    own type for 16, 32 and 64 bits; for 8 bits and less what libtiff's
    RGBA interface gives, as grey, RGB or RGBA by the photometric
    interpretation. "color" / "grey": IMREAD_COLOR / _GRAYSCALE (uint8)."""
    if mode not in ("unchanged", "color", "grey"):
        raise ValueError(f"unknown read mode {mode!r}")
    blob = Path(path).read_bytes()
    order, tags = _ifd(blob, path)
    lay = _Layout(tags, path)
    img = _decode(blob, lay, order, path)
    if not lay.rgba or (lay.raw_int8 and mode == "unchanged"):
        if mode == "unchanged":
            img = img[..., 0] if lay.spp == 1 else img
            return exif.orient(img, lay.orientation)
        if lay.dtype.itemsize != 2:
            unreadable(path, f"{lay.dtype} TIFF read as 8-bit {mode}")
        img = img.view(np.uint16)
        if lay.spp == 1:
            if lay.tiled and lay.w % lay.cw:
                unsupported(path, "16-bit grey TIFF of partial edge tiles "
                            "read as 8-bit colour or grey (cv2 misreads all "
                            "but their first rows)")
            rgba = np.repeat((img >> 8).astype(np.uint8), 3, -1)
        else:
            # libtiff's Bitdepth16To8, then its premultiplication of an
            # unassociated alpha
            rgba = ((img.astype(np.uint32) + 128) // 257).astype(np.uint8)
            if lay.spp == 4 and lay.extra[:1] == (2,):
                a = rgba[..., 3:].astype(np.uint32)
                rgba[..., :3] = (rgba[..., :3] * a + 127) // 255
            rgba = rgba[..., :3]
        return exif.orient(jpeg.cv_grey(rgba) if mode == "grey" else rgba,
                       lay.orientation)
    rgba = _rgba(img, lay, path)
    grey = lay.photometric in (MINISWHITE, MINISBLACK) or lay.bits == 1
    if mode == "grey" or (mode == "unchanged" and grey):
        out = jpeg.cv_grey(rgba)
    elif mode == "unchanged" and lay.spp == 4:
        out = rgba
    else:
        out = rgba[..., :3]
    return exif.orient(out, lay.orientation)


def _apply_predictor(img: np.ndarray, predictor: int) -> np.ndarray:
    """(h, w, spp) native samples → (h, row bytes) as stored."""
    h, w, spp = img.shape
    if predictor == 3:
        planes = np.ascontiguousarray(img.astype(">f4")).view(np.uint8) \
            .reshape(h, w * spp, 4).transpose(0, 2, 1).reshape(h, -1, spp)
        d = planes.copy()
        d[:, 1:] -= planes[:, :-1]
        return d.reshape(h, -1)
    if predictor == 2:
        uint = np.dtype(f"u{img.dtype.itemsize}")
        u = img.view(uint)
        d = u.copy()
        d[:, 1:] -= u[:, :-1]
        img = d.view(img.dtype)
    return np.ascontiguousarray(img.astype(img.dtype.newbyteorder("<"))) \
        .view(np.uint8).reshape(h, -1)


def write_tiff(path, img: np.ndarray, compression: int = LZW,
               predictor: int | None = None) -> None:
    """uint8, uint16 or float32 samples, (H, W) or (H, W, 3|4) in RGB(A)
    order, as a little-endian strip TIFF. predictor None: horizontal
    differencing (2) for integer samples under LZW or Deflate, else none;
    without LZW or Deflate no predictor applies, as in libtiff."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16, np.float32):
        raise ValueError(f"TIFF samples must be uint8, uint16 or float32, "
                         f"not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, spp = img.shape
    if spp not in (1, 3, 4):
        raise ValueError(f"TIFF images have 1, 3 or 4 channels, not {spp}")
    if compression not in COMPRESSIONS:
        raise ValueError(f"TIFF compression {compression} is not written")
    is_float = img.dtype == np.float32
    if compression not in PREDICTED:
        predictor = 1
    elif predictor is None:
        predictor = 1 if is_float else 2
    if predictor not in (1, 2, 3) or (predictor == 3 and not is_float):
        raise ValueError(f"TIFF predictor {predictor} is not written for "
                         f"{img.dtype} samples")
    rows = _apply_predictor(img, predictor)
    row = rows.shape[1]
    rps = max(1, min(h, 8192 // row))
    strips = []
    for y in range(0, h, rps):
        chunk = rows[y:y + rps]
        if compression == LZW:
            strips.append(native.lzw_encode(chunk.tobytes()))
        elif compression == PACKBITS:
            strips.append(native.packbits_encode(chunk))
        elif compression in (DEFLATE, ADOBE_DEFLATE):
            strips.append(zlib.compress(chunk.tobytes(), 6))
        else:
            strips.append(chunk.tobytes())
    bits = img.dtype.itemsize * 8
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp),
               (259, 3, [compression]), (262, 3, [1 if spp == 1 else 2]),
               (273, 4, None), (277, 3, [spp]), (278, 4, [rps]),
               (279, 4, [len(s) for s in strips]), (284, 3, [1])]
    if predictor != 1:
        entries.append((317, 3, [predictor]))
    entries.append((339, 3, [3 if is_float else 1] * spp))
    # layout: header, strips, out-of-line values, IFD
    out = bytearray(b"II*\x00\x00\x00\x00\x00")
    offsets = []
    for s in strips:
        offsets.append(len(out))
        out += s
        out += b"\0" * (len(out) & 1)
    entries[5] = (273, 4, offsets)
    blobs = {}
    for tag, typ, vals in entries:
        code, size = TYPES[typ]
        if size * len(vals) > 4:
            blobs[tag] = len(out)
            out += struct.pack(f"<{len(vals)}{code}", *vals)
            out += b"\0" * (len(out) & 1)
    ifd = len(out)
    out[4:8] = struct.pack("<I", ifd)
    out += struct.pack("<H", len(entries))
    for tag, typ, vals in entries:
        code, size = TYPES[typ]
        if tag in blobs:
            field = struct.pack("<I", blobs[tag])
        else:
            field = struct.pack(f"<{len(vals)}{code}", *vals).ljust(4, b"\0")
        out += struct.pack("<HHI", tag, typ, len(vals)) + field
    out += struct.pack("<I", 0)
    Path(path).write_bytes(bytes(out))
