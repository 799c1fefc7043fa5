"""GIF, read as OpenCV 5's own decoder (grfmt_gif, not giflib) reads it.

GIF87a and GIF89a: the first image, which is what `cv2.imread` returns,
through its local colour table, else the global one, else cv2's default
(entry i grey i, but entry 1 white); LZW at minimum code sizes 2-8;
interlaced rows. The image is drawn onto the logical screen, which
starts as the global table's background colour (black without a global
table) at alpha 0; every drawn pixel gets alpha 255, and a Graphic
Control Extension's transparent index is not drawn. "unchanged" gives
(H, W, 4) RGBA if any frame of the file has a transparent index, else
(H, W, 3); "color" (H, W, 3); "grey" cvtColor's BGR2GRAY.

cv2 walks the whole file first, so a file without its trailer is
unreadable, and so is an image whose LZW data holds more or fewer pixels
than the image, or that lies outside the screen.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from . import native
from .bytestream import ByteStream
from .errors import ImwriteFailed, unreadable, unsupported
from .jpeg import cvt_grey

SIGNATURES = (b"GIF87a", b"GIF89a")


def _table(s: ByteStream, flags: int):
    if not flags & 0x80:
        return None
    n = 2 << (flags & 7)
    return np.frombuffer(s.take(3 * n), np.uint8).reshape(n, 3)


def _sub_blocks(s: ByteStream) -> bytes:
    out = []
    while True:
        n = s.byte()
        if n == 0:
            return b"".join(out)
        out.append(s.take(n))


class _First:
    """The file's structure: the first image and what cv2 reads of the
    rest."""

    def __init__(self, blob: bytes, path):
        s = ByteStream(blob, path, pos=6)
        self.w, self.h = s.word(), s.word()
        flags, self.bg = s.byte(), s.byte()
        s.skip(1)
        self.global_table = _table(s, flags)
        if not (self.w > 0 and self.h > 0):
            unreadable(path, "GIF screen of no pixels")
        self.image, self.any_transparent = None, False
        transparent = None
        while True:
            kind = s.byte()
            if kind == 0x3B:
                break
            if kind == 0x21:
                label = s.byte()
                body = _sub_blocks(s)
                if label == 0xF9 and len(body) >= 4:
                    t = body[3] if body[0] & 1 else None
                    self.any_transparent |= t is not None
                    if self.image is None:
                        transparent = t
            elif kind == 0x2C:
                left, top, w, h, iflags = struct.unpack("<HHHHB", s.take(9))
                table = _table(s, iflags)
                min_size = s.byte()
                data = _sub_blocks(s)
                if self.image is None:
                    self.image = (left, top, w, h, bool(iflags & 0x40), table,
                                  min_size, data, transparent)
            else:
                unreadable(path, f"GIF block {kind:#04x}")
        if self.image is None:
            unreadable(path, "GIF without an image")


def _default_table() -> np.ndarray:
    t = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
    t[1] = 255
    return t


def read_gif(path, mode: str = "unchanged") -> np.ndarray:
    if mode not in ("unchanged", "color", "grey"):
        raise ValueError(f"unknown read mode {mode!r}")
    f = _First(Path(path).read_bytes(), path)
    left, top, w, h, interlaced, table, min_size, data, transparent = \
        f.image
    if not (w > 0 and h > 0 and left + w <= f.w and top + h <= f.h):
        unreadable(path, "GIF image outside its screen")
    if not 2 <= min_size <= 11:
        unreadable(path, f"GIF LZW minimum code size {min_size}")
    if min_size > 8:
        unsupported(path, f"GIF LZW minimum code size {min_size} (more "
                    "colours than a table holds)")
    n, idx = native.gif_lzw_decode(data, min_size, w * h)
    if n != w * h:
        unreadable(path, f"GIF LZW data of {n} pixels, want {w * h}")
    idx = idx.reshape(h, w)
    if interlaced:
        rows = np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8),
                               np.arange(2, h, 4), np.arange(1, h, 2)])
        idx = idx[np.argsort(rows, kind="stable")]
    gt = f.global_table
    if table is None:
        table = gt if gt is not None else _default_table()
    if idx.max() >= len(table) or (gt is not None and f.bg >= len(gt)):
        unsupported(path, "GIF index past its colour table")
    screen = np.zeros((f.h, f.w, 4), np.uint8)
    if gt is not None:
        screen[..., :3] = gt[f.bg]
    drawn = np.concatenate([table[idx], np.full((h, w, 1), 255, np.uint8)],
                           -1)
    if transparent is not None:
        keep = (idx == transparent)[..., None]
        drawn = np.where(keep, screen[top:top + h, left:left + w], drawn)
    screen[top:top + h, left:left + w] = drawn
    if mode == "grey":
        return cvt_grey(screen)
    if mode == "unchanged" and f.any_transparent:
        return screen
    return np.ascontiguousarray(screen[..., :3])


# ---------------------------------------------------------------- writing
# OpenCV 5's GIF encoder at its defaults: the fixed palette R << 5 | G << 2
# | B of 8, 8 and 4 levels, an infinite NETSCAPE2.0 loop, a Graphic
# Control Extension (disposal 3, delay 100, and where a pixel has alpha 0
# the transparent index 146), one image of LZW minimum code size 8
PALETTE = np.array([[(i >> 5) * 36, ((i >> 2) & 7) * 36, (i & 3) * 85]
                    for i in range(256)], np.uint8)
TRANSPARENT = 146
_LOOP = b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"


def encode_gif(image: np.ndarray, path="image") -> bytes:
    """A GIF of (H, W, 3) RGB or (H, W, 4) RGBA uint8 samples, byte for
    byte what `cv2.imwrite(".gif")` writes: the fixed palette and
    cv2's Floyd-Steinberg dithering (`native/codecs.cc:gif_dither`),
    alpha 0 as the transparent index. cv2's encoder fails on grey input
    (its dithering asserts three or four channels) after it has opened
    the file: this raises `ImwriteFailed` with an empty file left."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"{path}: GIF takes 8-bit samples, not {image.dtype}")
    if image.ndim == 2 or image.shape[2] == 1:
        raise ImwriteFailed(f"{path}: cv2's GIF encoder takes 3 or 4 "
                            "channels, not grey", left=b"")
    if image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError(f"{path}: cv2's GIF encoder takes 3 or 4 channels, "
                         f"not shape {image.shape}")
    h, w = image.shape[:2]
    if not (0 < w < 65536 and 0 < h < 65536):
        raise ValueError(f"{path}: a GIF is at most 65535 pixels a side, "
                         f"not {w}x{h}")
    transparent, index = native.gif_dither(image)
    data = native.gif_lzw_encode(index.tobytes(), 8)
    blocks = b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                      for i in range(0, len(data), 255))
    gce = struct.pack("<BBBBHBB", 0x21, 0xF9, 4, 0x0D if transparent else 0x0C,
                      100, TRANSPARENT if transparent else 0, 0)
    palette = PALETTE.copy()
    if transparent:
        # cv2 leaves the last transparent pixel's colour in the entry
        palette[TRANSPARENT] = image[..., :3][image[..., 3] == 0][-1]
    return (b"GIF89a" + struct.pack("<HHBBB", w, h, 0xF7, 0, 0)
            + palette.tobytes() + _LOOP + gce
            + struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0x07) + b"\x08"
            + blocks + b"\x00\x3b")


def write_gif(path, image: np.ndarray) -> None:
    data = encode_gif(image, path)
    Path(path).write_bytes(data)
