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
from .errors import unreadable, unsupported
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
