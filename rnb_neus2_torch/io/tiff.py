"""TIFF read and write with numpy, zlib and the LZW/PackBits helpers of
`native/codecs.cc`: no `cv2`, `PIL` or `tifffile`, which the card's host
does not have.

Reads the first image of a baseline TIFF as `cv2.imread` does: byte order
`II` or `MM`; strips, PlanarConfiguration 1; 8- and 16-bit unsigned or
32-bit IEEE float samples, 1 (MinIsBlack), 3 or 4 (RGB) per pixel;
compression none (1), LZW (5), Deflate (8, 32946) or PackBits (32773);
predictor none, horizontal differencing (2) or floating point (3).
Samples come back in RGB(A) order. Tiles, planar-separate data, JPEG
compression, other depths, photometric interpretations and orientations
raise ValueError naming the file and the feature. cv2 reads 8-bit files
through libtiff's RGBA interface, which premultiplies an unassociated
alpha (ExtraSamples 2) as (v * a + 127) // 255; so does this reader.

Writes the same layouts; by default as cv2 writes: LZW with horizontal
differencing for 8 and 16 bits, uncompressed float.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from . import native

SIGNATURES = (b"II*\x00", b"MM\x00*")
NONE, LZW, DEFLATE, ADOBE_DEFLATE, PACKBITS = 1, 5, 32946, 8, 32773
COMPRESSIONS = (NONE, LZW, DEFLATE, ADOBE_DEFLATE, PACKBITS)
PREDICTED = (LZW, DEFLATE, ADOBE_DEFLATE)
# field type → (struct code, size)
TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8),
         6: ("b", 1), 7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8),
         11: ("f", 4), 12: ("d", 8), 16: ("Q", 8)}
# OpenCV's BGR2Gray weights in 1/16384 (color.hpp), applied by imread
CV_GREY_B, CV_GREY_G, CV_GREY_R = 1868, 9617, 4899


def _ifd(blob: bytes, path):
    order = "<" if blob[:2] == b"II" else ">"
    magic, offset = struct.unpack_from(order + "HI", blob, 2)
    if magic == 43:
        raise ValueError(f"{path}: BigTIFF is not supported")
    if blob[:4] not in SIGNATURES:
        raise ValueError(f"{path}: not a TIFF file")
    n, = struct.unpack_from(order + "H", blob, offset)
    tags = {}
    for i in range(n):
        tag, typ, count, raw = struct.unpack_from(order + "HHI4s", blob,
                                                  offset + 2 + 12 * i)
        if typ not in TYPES:
            continue
        code, size = TYPES[typ]
        nbytes = size * count
        data = raw if nbytes <= 4 else blob[
            struct.unpack(order + "I", raw)[0]:][:nbytes]
        tags[tag] = struct.unpack(order + code * count, data[:nbytes]) \
            if typ != 2 else (data[:nbytes].rstrip(b"\0").decode("latin-1"),)
    return order, tags


def _refuse(path, what: str):
    raise ValueError(f"{path}: {what} is not supported")


def _layout(tags, path):
    """Check what the file needs against what is read; → (H, W, spp,
    numpy dtype of a sample, compression, predictor)."""
    if 322 in tags or 324 in tags:
        _refuse(path, "tiled TIFF")
    if tags.get(284, (1,))[0] != 1:
        _refuse(path, "planar-separate TIFF (PlanarConfiguration 2)")
    comp = tags.get(259, (1,))[0]
    if comp in (6, 7):
        _refuse(path, "JPEG-compressed TIFF")
    if comp not in COMPRESSIONS:
        _refuse(path, f"TIFF compression {comp}")
    w, h = tags[256][0], tags[257][0]
    spp = tags.get(277, (1,))[0]
    bits = set(tags.get(258, (1,)))
    fmt = set(tags.get(339, (1,)))
    if len(bits) != 1 or len(fmt) != 1:
        _refuse(path, "TIFF with mixed sample sizes or formats")
    bits, fmt = bits.pop(), fmt.pop()
    dtype = {(8, 1): np.uint8, (16, 1): np.uint16,
             (32, 3): np.float32}.get((bits, fmt))
    if dtype is None:
        _refuse(path, f"TIFF with {bits}-bit samples of SampleFormat {fmt}")
    photometric = tags.get(262, (1,))[0]
    if (spp, photometric) not in ((1, 1), (3, 2), (4, 2)):
        _refuse(path, f"TIFF with {spp} samples per pixel and "
                f"PhotometricInterpretation {photometric}")
    if tags.get(274, (1,))[0] != 1:
        _refuse(path, f"TIFF Orientation {tags[274][0]}")
    # libtiff applies a predictor only under LZW and Deflate
    predictor = tags.get(317, (1,))[0] if comp in PREDICTED else 1
    if predictor not in (1, 2, 3) or (predictor == 3 and fmt != 3):
        _refuse(path, f"TIFF Predictor {predictor} for {bits}-bit samples")
    return h, w, spp, np.dtype(dtype), comp, predictor


def _strip_bytes(blob, offset, count, comp, size, path) -> bytes:
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
        raise ValueError(f"{path}: corrupt TIFF strip ({e})") from None
    if len(out) < size:
        raise ValueError(f"{path}: TIFF strip has {len(out)} bytes, want "
                         f"{size}")
    return out[:size]


def _undo_predictor(raw: np.ndarray, h, w, spp, dtype, order, predictor):
    """raw: (h, w * spp * itemsize) bytes → (h, w, spp) samples."""
    size = dtype.itemsize
    if predictor == 3:
        planes = np.cumsum(raw.reshape(h, -1, spp), axis=1,
                           dtype=np.uint8).reshape(h, size, w * spp)
        # byte planes, most significant first, whatever the byte order
        return np.ascontiguousarray(planes.transpose(0, 2, 1)).view(
            np.dtype(">f4")).astype(np.float32).reshape(h, w, spp)
    uint = np.dtype(f"u{size}")
    vals = raw.view(uint.newbyteorder(order)).astype(uint).reshape(h, w, spp)
    if predictor == 2:
        vals = np.cumsum(vals, axis=1, dtype=uint)
    return vals.view(dtype)


def _colour(img: np.ndarray, mode: str, path) -> np.ndarray:
    """IMREAD_COLOR / IMREAD_GRAYSCALE: cv2 reads 8-bit data through
    libtiff's RGBA interface (16-bit colour scaled by (v + 128) // 257,
    16-bit grey keeping its high byte), then converts with its own
    BGR2Gray."""
    if img.dtype == np.float32:
        _refuse(path, "float TIFF in 8-bit colour or grey (cv2 returns "
                "None)")
    grey = img.ndim == 2
    if img.dtype == np.uint16:
        img = (img >> 8) if grey else (img.astype(np.uint32) + 128) // 257
    img = img.astype(np.uint8)
    if mode == "color":
        return np.repeat(img[..., None], 3, -1) if grey else img[..., :3]
    if grey:
        return img
    r, g, b = (img[..., i].astype(np.int32) for i in range(3))
    return ((b * CV_GREY_B + g * CV_GREY_G + r * CV_GREY_R + 8192)
            >> 14).astype(np.uint8)


def read_tiff(path, mode: str = "unchanged") -> np.ndarray:
    """The first image as `cv2.imread(IMREAD_UNCHANGED)` gives it, in RGB(A)
    order: (H, W) or (H, W, 3|4), uint8, uint16 or float32. mode "color" /
    "grey": `IMREAD_COLOR` / `IMREAD_GRAYSCALE` (uint8)."""
    blob = Path(path).read_bytes()
    order, tags = _ifd(blob, path)
    h, w, spp, dtype, comp, predictor = _layout(tags, path)
    row = w * spp * dtype.itemsize
    rps = min(tags.get(278, (h,))[0], h)
    offsets, counts = tags[273], tags.get(279)
    if counts is None:
        if comp != NONE:
            _refuse(path, "compressed TIFF without StripByteCounts")
        counts = [rps * row] * len(offsets)
    strips = []
    for i, (off, cnt) in enumerate(zip(offsets, counts)):
        rows = min(rps, h - i * rps)
        if rows <= 0:
            break
        strips.append(_strip_bytes(blob, off, cnt, comp, rows * row, path))
    raw = np.frombuffer(b"".join(strips), np.uint8)
    if raw.size != h * row:
        raise ValueError(f"{path}: TIFF strips hold {raw.size} bytes, want "
                         f"{h * row}")
    img = _undo_predictor(raw.reshape(h, row), h, w, spp, dtype, order,
                          predictor)
    if spp == 4 and dtype == np.uint8 and tags.get(338, (0,))[0] == 2:
        a = img[..., 3:].astype(np.uint32)
        img = np.concatenate([((img[..., :3] * a + 127) // 255)
                              .astype(np.uint8), img[..., 3:]], axis=-1)
    img = img[..., 0] if spp == 1 else img
    if mode == "unchanged":
        return img
    if mode not in ("color", "grey"):
        raise ValueError(f"unknown read mode {mode!r}")
    return _colour(img, mode, path)


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
