"""Windows BMP, read and written as OpenCV's grfmt_bmp reads and writes it.

Reads the OS/2 core header (12 bytes) and the INFO header and its
successors (40, 52, 56, 108, 124 bytes): 1, 4 and 8 bits through a
palette, 16 bits as 5-5-5 (BI_RGB, or BI_BITFIELDS with its masks) or
5-6-5 (BI_BITFIELDS), 24 and 32 bits, RLE8 and RLE4 (encoded runs,
absolute runs, end of line, delta, end of bitmap; skipped pixels take
palette entry 0), bottom-up and top-down rows. What cv2 gives back:

- "unchanged": a palette whose entries are all grey gives (H, W); an
  OS/2 file is always grey (cv2 never marks it colour); 32 bits with
  BI_BITFIELDS give (H, W, 4), every other file (H, W, 3);
- "color": (H, W, 3); "grey": OpenCV's BGR2Gray of the colours.

32-bit BI_BITFIELDS pixels are the bytes as stored (B, G, R, A) unless
a header of 56 bytes or more holds non-zero R, G and B masks: then each
channel is (v & mask) >> shift, scaled by 255 // (mask >> shift), alpha
255 where its mask is 0, and their grey is the float32 sum 0.299 R +
0.587 G + 0.114 B, in that order, truncated.

16-bit samples expand by a shift (v << 3), not by replication. Writes
8-bit grey with a grey palette, 24-bit colour, and 32-bit BGRA under a
V5 header with BI_BITFIELDS masks.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from . import native
from .bytestream import ByteStream
from .errors import unreadable
from .jpeg import cv_grey

SIGNATURE = b"BM"
BI_RGB, BI_RLE8, BI_RLE4, BI_BITFIELDS = 0, 1, 2, 3


class _Header:
    def __init__(self, blob: bytes, path):
        s = ByteStream(blob, path)
        s.skip(10)
        self.offset = s.dword()
        size = s.dword()
        self.palette = np.zeros((256, 3), np.uint8)     # RGB
        self.masks = None
        colour, ok = False, False
        if size >= 36:
            w, h = s.dword(), s.dword()
            bpp, rle = s.dword() >> 16, s.dword()
            s.skip(12)
            clrused = s.dword()
            if size >= 56 and rle == BI_BITFIELDS and bpp == 32:
                masks = struct.unpack_from("<4I", blob, 54) \
                    if len(blob) >= 70 else (0, 0, 0, 0)
                if all(masks[:3]):
                    self.masks = masks
            s.skip(size - 36)
            if w > 0 and h != 0 and (
                    (bpp in (1, 4, 8, 24, 32) and rle == BI_RGB)
                    or (bpp in (16, 32) and rle in (BI_RGB, BI_BITFIELDS))
                    or (bpp == 4 and rle == BI_RLE4)
                    or (bpp == 8 and rle == BI_RLE8)):
                colour, ok = True, True
                if bpp <= 8:
                    if not 0 <= clrused <= 256:
                        unreadable(path, f"BMP with {clrused} colours")
                    n = clrused or 1 << bpp
                    pal = np.frombuffer(s.take(4 * n), np.uint8)
                    self.palette[:n] = pal.reshape(n, 4)[:, 2::-1]
                    colour = bool(np.any(self.palette[:1 << bpp]
                                         != self.palette[:1 << bpp, :1]))
                elif bpp == 16 and rle == BI_BITFIELDS:
                    r, g, b = s.dword(), s.dword(), s.dword()
                    if (r, g, b) == (0x7C00, 0x3E0, 0x1F):
                        bpp = 15
                    elif (r, g, b) != (0xF800, 0x7E0, 0x1F):
                        ok = False
                elif bpp == 16:
                    bpp = 15
        elif size == 12:
            w, h = s.word(), s.word()
            bpp, rle = s.dword() >> 16, BI_RGB
            if w > 0 and h != 0 and bpp in (1, 4, 8, 24, 32):
                if bpp <= 8:
                    n = 1 << bpp
                    pal = np.frombuffer(s.take(3 * n), np.uint8)
                    self.palette[:n] = pal.reshape(n, 3)[:, ::-1]
                ok = True
        if not ok:
            unreadable(path, "not a BMP header cv2 reads")
        self.w, self.h, self.bpp, self.rle = w, abs(h), bpp, rle
        self.bottom_up = h > 0
        self.channels = (4 if bpp == 32 and rle != BI_RGB else 3) \
            if colour else 1


def _rows(blob: bytes, hd: _Header, path) -> np.ndarray:
    """The file's rows of packed pixels, (h, pitch) uint8, in file order."""
    bits = 16 if hd.bpp == 15 else hd.bpp
    pitch = ((hd.w * bits + 7) // 8 + 3) & -4
    if hd.offset < 0 or hd.offset + pitch * hd.h > len(blob):
        unreadable(path, "BMP pixel data ends early")
    return np.frombuffer(blob, np.uint8, pitch * hd.h, hd.offset) \
        .reshape(hd.h, pitch)


def _indices(blob: bytes, hd: _Header, path) -> np.ndarray:
    """Palette indices (h, w) in file row order."""
    if hd.rle in (BI_RLE8, BI_RLE4):
        if hd.offset < 0:
            unreadable(path, "BMP pixel data ends early")
        code, idx = native.bmp_rle_decode(blob[hd.offset:], hd.w, hd.h,
                                          8 if hd.rle == BI_RLE8 else 4)
        if code == -2:
            unreadable(path, "BMP RLE data ends early")
        if code < 0:
            unreadable(path, "BMP RLE run past the end of a row")
        return idx
    rows = _rows(blob, hd, path)
    if hd.bpp == 8:
        return rows[:, :hd.w]
    shifts = np.arange(8 - hd.bpp, -1, -hd.bpp, dtype=np.uint8)
    idx = (rows[:, :, None] >> shifts) & ((1 << hd.bpp) - 1)
    return idx.reshape(hd.h, -1)[:, :hd.w]


def _direct(blob: bytes, hd: _Header, path) -> np.ndarray:
    """(h, w, 3|4) RGB(A) of a 15-, 16-, 24- or 32-bit file, file row
    order."""
    rows = _rows(blob, hd, path)
    if hd.bpp in (15, 16):
        v = rows[:, :2 * hd.w].copy().view("<u2").astype(np.int32)
        if hd.bpp == 15:
            rgb = [(v >> 7) & 0xF8, (v >> 2) & 0xF8, (v << 3) & 0xF8]
        else:
            rgb = [(v >> 8) & 0xF8, (v >> 3) & 0xFC, (v << 3) & 0xF8]
        return np.stack(rgb, -1).astype(np.uint8)
    n = hd.bpp // 8
    px = rows[:, :n * hd.w].reshape(hd.h, hd.w, n)
    if hd.masks is not None:
        v = px.copy().view("<u4")[..., 0].astype(np.int64)
        out = np.full(v.shape + (4,), 255, np.uint8)
        for c, m in enumerate(hd.masks):
            if m:
                off = (m & -m).bit_length() - 1
                out[..., c] = ((v & m) >> off) * 255 // (m >> off)
        return out if hd.channels == 4 else out[..., :3]
    out = px[..., 2::-1]
    if n == 4 and hd.channels == 4:
        out = np.concatenate([out, px[..., 3:]], -1)
    return out


def read_bmp(path, mode: str = "unchanged") -> np.ndarray:
    """A BMP as `cv2.imread` reads it, RGB(A) order (see the module)."""
    if mode not in ("unchanged", "color", "grey"):
        raise ValueError(f"unknown read mode {mode!r}")
    blob = Path(path).read_bytes()
    hd = _Header(blob, path)
    ch = {"unchanged": hd.channels, "color": 3, "grey": 1}[mode]
    if hd.bpp <= 8:
        idx = _indices(blob, hd, path)
        out = hd.palette[idx] if ch > 1 else cv_grey(hd.palette)[idx]
    else:
        out = _direct(blob, hd, path)
        if ch == 1 and hd.masks is not None:
            r, g, b = (out[..., i].astype(np.float32) for i in range(3))
            f = np.float32
            out = (r * f(0.299) + g * f(0.587) + b * f(0.114)) \
                .astype(np.uint8)
        elif ch == 1:
            out = cv_grey(out)
        elif ch == 3:
            out = out[..., :3]
    if hd.bottom_up:
        out = out[::-1]
    return np.ascontiguousarray(out)


def encode_bmp(img: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, 3|4) in RGB(A) order → cv2.imwrite's bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"BMP samples are uint8, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    ch = 1 if img.ndim == 2 else img.shape[2]
    if ch not in (1, 3, 4):
        raise ValueError(f"cv2 writes a BMP of 1, 3 or 4 channels, not {ch}")
    h, w = img.shape[:2]
    step = (w * ch + 3) & -4
    if ch == 1:
        info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, BI_RGB, 0, 0, 0,
                           0, 0)
        extra = np.repeat(np.arange(256, dtype=np.uint8), 4).reshape(256, 4)
        extra[:, 3] = 0
        extra = extra.tobytes()
    elif ch == 3:
        info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, BI_RGB, 0, 0, 0,
                           0, 0)
        extra = b""
    else:
        info = struct.pack("<IiiHHIIiiII", 124, w, h, 1, 32, BI_BITFIELDS,
                           0, 0, 0, 0, 0)
        info += struct.pack("<4I", 0xFF0000, 0xFF00, 0xFF, 0xFF000000)
        info += b"BGRs" + bytes(124 - len(info) - 4)
        extra = b""
    px = img if ch == 1 else img[..., [2, 1, 0, 3][:ch]]
    rows = np.zeros((h, step), np.uint8)
    rows[:, :w * ch] = px.reshape(h, w * ch)
    head = 14 + len(info) + len(extra)
    size = head + step * h
    return (SIGNATURE + struct.pack("<IIi", size, 0, head) + info + extra
            + rows[::-1].tobytes())


def write_bmp(path, img: np.ndarray) -> None:
    Path(path).write_bytes(encode_bmp(img))
