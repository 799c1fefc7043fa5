"""Sun raster, read and written as OpenCV's grfmt_sunras does.

cv2 reads RT_OLD and RT_STANDARD files of depth 1, 8 (grey, or through
an RMT_EQUAL_RGB colour map), 24 (B, G, R) and 32 (X, B, G, R). Its
header check tests the decoder's image type where it means the file's
type, so RT_BYTE_ENCODED and RT_FORMAT_RGB files are unreadable to it,
and so they are to the port. What cv2 gives back, copied here:

- a colour map whose entries are all grey gives 1 channel, any other
  3; depths 24 and 32 give 3;
- 1- and 8-bit samples read as 1 channel ("unchanged" or "grey") go
  through a grey palette that cv2 fills only from a colour map: without
  one they read as 0. "color" expands them through the map, or through
  a grey ramp (0, 255 at 1 bit; 0-255 at 8);
- 32-bit pixels are read from their second byte on, so the 4th byte of
  each (what cv2 writes as alpha) is taken as red.

The writer is cv2's: RT_STANDARD, no colour map, depth 8 · channels,
rows padded to an even length with the byte that follows the row in
memory (the next row's first; 0 after the last row).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from .bytestream import ByteStream
from .errors import unreadable
from .jpeg import cv_grey

SIGNATURE = b"\x59\xa6\x6a\x95"
RT_OLD, RT_STANDARD = 0, 1
RMT_NONE, RMT_EQUAL_RGB = 0, 1


def read_sunras(path, mode: str = "unchanged") -> np.ndarray:
    if mode not in ("unchanged", "color", "grey"):
        raise ValueError(f"unknown read mode {mode!r}")
    blob = Path(path).read_bytes()
    s = ByteStream(blob, path, big_endian=True, pos=4)
    w, h, bpp = s.dword(), s.dword(), s.dword()
    if not (w > 0 and h > 0 and bpp in (1, 8, 24, 32)):
        unreadable(path, "not a Sun raster header cv2 reads")
    s.skip(4)
    kind, maptype, maplength = s.dword(), s.dword(), s.dword()
    pal_size = (1 << bpp) * 3 if bpp <= 8 else 0
    if kind not in (RT_OLD, RT_STANDARD) or not (
            (maptype == RMT_NONE and maplength == 0)
            or (maptype == RMT_EQUAL_RGB and 0 < maplength <= pal_size)):
        unreadable(path, f"Sun raster of type {kind}, map {maptype} "
                   f"({maplength} bytes)")
    palette = np.zeros((256, 3), np.uint8)          # RGB
    if maplength:
        n = maplength // 3
        cmap = np.frombuffer(s.take(maplength), np.uint8)
        palette[:n] = cmap[:3 * n].reshape(3, n).T
        colour = bool(np.any(palette[:1 << bpp] != palette[:1 << bpp, :1]))
        grey = cv_grey(palette)
    else:
        colour = bpp > 8
        if bpp <= 8:
            ramp = np.arange(256) * 255 // ((1 << bpp) - 1)
            palette[:1 << bpp] = np.minimum(ramp, 255)[:1 << bpp, None]
        grey = np.zeros(256, np.uint8)
    ch = {"unchanged": 3 if colour else 1, "color": 3, "grey": 1}[mode]
    pitch = ((w * bpp + 7) // 8 + 1) & -2
    if s.pos + pitch * h > len(blob):
        unreadable(path, "Sun raster data ends early")
    rows = np.frombuffer(blob, np.uint8, pitch * h, s.pos).reshape(h, pitch)
    if bpp <= 8:
        idx = np.unpackbits(rows, axis=1)[:, :w] if bpp == 1 \
            else rows[:, :w]
        out = palette[idx] if ch == 3 else grey[idx]
    else:
        n = bpp // 8
        px = rows[:, :n * w].reshape(h, w, n)
        rgb = px[..., 2::-1] if n == 3 else px[..., 3:0:-1]
        out = rgb if ch == 3 else cv_grey(rgb)
    return np.ascontiguousarray(out)


def encode_sunras(img: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, C) in RGB(A) order → cv2.imwrite's bytes
    (samples stored B, G, R(, A))."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"Sun raster samples are uint8, not {img.dtype}")
    ch = 1 if img.ndim == 2 else img.shape[2]
    if ch not in (1, 3, 4):
        raise ValueError(f"cv2 writes a Sun raster of 1, 3 or 4 channels, "
                         f"not {ch}")
    h, w = img.shape[:2]
    if ch >= 3:
        img = img[..., [2, 1, 0, 3][:ch]]
    flat = np.ascontiguousarray(img).reshape(-1)
    step = (w * ch + 1) & -2
    head = SIGNATURE + struct.pack(">7I", w, h, ch * 8, step * h,
                                   RT_STANDARD, RMT_NONE, 0)
    padded = np.concatenate([flat, np.zeros(step, np.uint8)])
    rows = np.lib.stride_tricks.as_strided(
        padded, (h, step), (w * ch, 1))
    return head + rows.tobytes()


def write_sunras(path, img: np.ndarray) -> None:
    Path(path).write_bytes(encode_sunras(img))
