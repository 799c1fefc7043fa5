"""PNG read and write with numpy, zlib and a small C unfilter: no `cv2` or
`PIL`, which the card's host does not have.

Reads 8- and 16-bit grey, grey+alpha, RGB and RGBA, non-interlaced, with
any of the five row filters, and returns the samples in the file's order:
(H, W) for grey, (H, W, C) otherwise, RGB(A) — not cv2's BGR(A). Palette,
sub-byte and interlaced files raise, naming what is not supported. Rows
are unfiltered by `png_unfilter` (`native/png_unfilter.cc`, built with g++
into `build/` at first use, as `io/raycast.py` builds the BVH): Sub,
Average and Paeth depend on the byte before, which numpy cannot vectorize
along a row.

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
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + n


def read_png(path) -> np.ndarray:
    """uint8 or uint16 samples, (H, W) or (H, W, C) in RGB(A) order."""
    blob = Path(path).read_bytes()
    if not blob.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file (only PNG is read; EXR, "
                         "TIFF and other formats are not supported)")
    header, idat = None, []
    for kind, body in _chunks(blob, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} (palette) is not "
                         "supported; only grey, grey+alpha, RGB and RGBA")
    if depth not in (8, 16):
        raise ValueError(f"{path}: PNG bit depth {depth} is not supported; "
                         "only 8 and 16")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported")
    ch, nbytes = CHANNELS[ctype], depth // 8
    bpp = ch * nbytes
    stride = w * bpp
    data = zlib.decompress(b"".join(idat))
    if len(data) != h * (stride + 1):
        raise ValueError(f"{path}: PNG image data has {len(data)} bytes, "
                         f"want {h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    bad = _library().png_unfilter(data, out.ctypes.data_as(ctypes.c_void_p),
                                  h, stride, bpp)
    if bad:
        raise ValueError(f"{path}: PNG row {bad - 1} has an unknown filter "
                         "type")
    img = out.view(">u2").astype(np.uint16) if depth == 16 else out
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


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
