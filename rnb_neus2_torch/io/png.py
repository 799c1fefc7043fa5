"""PNG read and write with numpy, zlib and a small C unfilter: no `cv2` or
`PIL`, which the card's host does not have.

Reads every PNG kind that cv2 reads — grey at 1, 2, 4, 8 and 16 bits,
grey+alpha, RGB and RGBA at 8 and 16, palette at 1-8 bits with or without
tRNS, plain or Adam7-interlaced, any of the five row filters — and
returns what `cv2.imread` returns, in RGB(A) order rather than cv2's
BGR(A). Rows (each Adam7 pass on its own) are unfiltered by
`png_unfilter` (`native/png_unfilter.cc`, built with g++ into `build/` at
first use, as `io/raycast.py` builds the BVH): Sub, Average and Paeth
depend on the byte before, which numpy cannot vectorize along a row.

Writes every row with filter 0 (None) and zlib level 1.
"""

from __future__ import annotations

import ctypes
import functools
import struct
import zlib
from pathlib import Path

import numpy as np

from ..kernels.build import load_host_library
from . import exif
from .errors import unreadable

SIGNATURE = b"\x89PNG\r\n\x1a\n"
SOURCE = Path(__file__).resolve().parent.parent / "native" / "png_unfilter.cc"
LIBRARY = "png_unfilter"
CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}          # colour type → channels
COLOR_TYPE = {c: t for t, c in CHANNELS.items()}


@functools.lru_cache(maxsize=None)
def _library():
    lib, _ = load_host_library(LIBRARY, SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [ptr, ptr, i64, i64, i64]
    return lib


def _chunks(blob: bytes, path):
    pos = len(SIGNATURE)
    while pos + 8 <= len(blob):
        n, kind = struct.unpack_from(">I4s", blob, pos)
        body = blob[pos + 8:pos + 8 + n]
        crc, = struct.unpack_from(">I", blob, pos + 8 + n)
        if zlib.crc32(kind + body) != crc:
            unreadable(path, f"bad CRC in PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + n


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))   # x0, y0, dx, dy
# libpng's png_set_rgb_to_gray(0.299, 0.587) in 1/32768 (pngrtran.c)
GREY_RC, GREY_GC = 9797, 19234
GREY_BC = 32768 - GREY_RC - GREY_GC


def _unfilter(data: bytes, h: int, stride: int, bpp: int, path):
    out = np.empty((h, stride), np.uint8)
    bad = _library().png_unfilter(data, out.ctypes.data_as(ctypes.c_void_p),
                                  h, stride, bpp)
    if bad:
        unreadable(path, f"PNG row {bad - 1} has an unknown filter "
                   "type")
    return out


def _samples(rows: np.ndarray, n: int, depth: int) -> np.ndarray:
    """Unfiltered rows → (h, n) samples of `depth` bits (MSB first)."""
    if depth == 16:
        return rows.view(">u2").astype(np.uint16)[:, :n]
    if depth == 8:
        return rows[:, :n]
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return vals.reshape(rows.shape[0], -1)[:, :n]


def _decode(path):
    """→ (samples (H, W, C) as stored, colour type, bit depth, PLTE, tRNS,
    EXIF orientation)."""
    blob = Path(path).read_bytes()
    if not blob.startswith(SIGNATURE):
        unreadable(path, "not a PNG file")
    header, idat, plte, trns, orientation = None, [], None, None, 1
    for kind, body in _chunks(blob, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"eXIf":
            orientation = exif.orientation(body)
        elif kind == b"IEND":
            break
    if header is None:
        unreadable(path, "PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    allowed = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
    if depth not in allowed.get(ctype, ()):
        unreadable(path, f"PNG colour type {ctype} at bit depth "
                   f"{depth} is not a valid PNG")
    if ctype == 3 and plte is None:
        unreadable(path, "palette PNG without a PLTE chunk")
    ch = 1 if ctype == 3 else CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)
    data = zlib.decompress(b"".join(idat))
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    img = None if not interlace else np.empty(
        (h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = (pw * ch * depth + 7) // 8
        n = ph * (stride + 1)
        if pos + n > len(data):
            unreadable(path, f"PNG image data has {len(data)} "
                       f"bytes, too few for {w}x{h}")
        rows = _unfilter(data[pos:pos + n], ph, stride, bpp, path)
        samples = _samples(rows, pw * ch, depth).reshape(ph, pw, ch)
        if img is None:
            img = samples
        else:
            img[y0::dy, x0::dx] = samples
        pos += n
    if pos != len(data):
        unreadable(path, f"PNG image data has {len(data)} bytes, "
                   f"want {pos}")
    return img, ctype, depth, plte, trns, orientation


def read_png(path, mode: str = "unchanged") -> np.ndarray:
    """A PNG as `cv2.imread` reads it (libpng's transforms), RGB(A) order.

    mode "unchanged" (IMREAD_UNCHANGED): uint8 or uint16 samples, (H, W)
    grey (1-, 2- and 4-bit scaled to 0-255), (H, W, 2) grey+alpha, RGB, or
    RGBA; a palette expands to RGB, or RGBA with a tRNS chunk, and RGB
    with a tRNS colour key becomes RGBA. "color" (IMREAD_COLOR): uint8
    (H, W, 3), 16-bit samples keep their high byte, alpha dropped. "grey"
    (IMREAD_GRAYSCALE): uint8 (H, W), colour through libpng's
    rgb_to_gray (truncating at 8 bits, rounding at 16, before the 16-bit
    strip). Both apply an eXIf chunk's orientation, as cv2 does."""
    img, ctype, depth, plte, trns, orientation = _decode(path)
    top = (1 << depth) - 1
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte[:256]
        alpha = np.full(256, 255, np.uint8)
        if trns is not None:
            alpha[:len(trns)] = np.frombuffer(trns[:256], np.uint8)
        idx = img[..., 0]
        img = pal[idx]
        if trns is not None and mode == "unchanged":
            img = np.concatenate([img, alpha[idx][..., None]], axis=-1)
        depth, top = 8, 255
    elif ctype == 0 and depth < 8:
        img = img * np.uint8(255 // top)
        depth, top = 8, 255
    elif ctype == 2 and trns is not None and mode == "unchanged":
        key = np.array(struct.unpack(">HHH", trns[:6]), img.dtype)
        alpha = np.where(np.all(img == key, axis=-1), 0, top)
        img = np.concatenate([img, alpha[..., None].astype(img.dtype)], -1)
    if mode == "unchanged":
        return img[..., 0] if img.shape[2] == 1 else img
    colour = img.shape[2] >= 3
    if mode == "color":
        out = img[..., :3] if colour else np.repeat(img[..., :1], 3, -1)
    elif mode == "grey":
        if not colour:
            out = img[..., 0]
        else:
            r, g, b = (img[..., i].astype(np.int64) for i in range(3))
            out = GREY_RC * r + GREY_GC * g + GREY_BC * b
            out = (out + 16384) >> 15 if depth == 16 else out >> 15
    else:
        raise ValueError(f"unknown read mode {mode!r}")
    out = (out >> 8) if depth == 16 else out
    return exif.orient(out.astype(np.uint8), orientation)


def write_png(path, img: np.ndarray) -> None:
    """uint8 or uint16 samples, (H, W) or (H, W, C) with C in 1-4, RGB(A)
    order; every row filter 0."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, not "
                         f"{img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if ch not in COLOR_TYPE:
        raise ValueError(f"PNG images have 1-4 channels, not {ch}")
    depth = img.dtype.itemsize * 8
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))) \
        .view(np.uint8).reshape(h, w * ch * img.dtype.itemsize)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, COLOR_TYPE[ch], 0, 0, 0)
    Path(path).write_bytes(SIGNATURE + chunk(b"IHDR", ihdr)
                           + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
                           + chunk(b"IEND", b""))
