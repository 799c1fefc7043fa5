"""Radiance HDR (RGBE), read and written as OpenCV's grfmt_hdr does on
Greg Ward's rgbe.c.

The header starts `#?RADIANCE` or `#?RGBE`; its lines (at most 127
bytes each, as fgets reads them) are skipped up to
`FORMAT=32-bit_rle_rgbe`, which must be followed by a blank line and
`-Y H +X W`: any other FORMAT or layout is unreadable to cv2. Scanlines
are new-style RLE while each starts 2, 2, W, and flat from the first one
that does not. "unchanged" gives float32 (H, W, 3) by rgbe2float's
arithmetic (mantissa · 2^(e - 136), exactly); "color" is
saturate_cast<uchar>(v · 255) and "grey" cvtColor's BGR2GRAY of that.
The writer is RGBE_WriteHeader + RGBE_WritePixels_RLE (flat below 8 or
above 32767 columns), after cv2's conversions: grey is repeated to 3
channels, and integer samples are multiplied by float32(1/255).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from . import native
from .errors import ImwriteFailed, unreadable
from .jpeg import cvt_grey, saturate_u8

SIGNATURES = (b"#?RGBE", b"#?RADIANCE")
_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"


def _lines(blob: bytes):
    """fgets(buf, 128): lines of at most 127 bytes, with their '\\n'."""
    pos = 0
    while pos < len(blob):
        end = blob.find(b"\n", pos, pos + 127)
        end = min(pos + 127, len(blob)) if end < 0 else end + 1
        yield blob[pos:end], end
        pos = end


_SIZE = re.compile(rb"-Y\s*([+-]?\d+)\s*\+X\s*([+-]?\d+)")


def _header(blob: bytes, path):
    """RGBE_ReadHeader: → (width, height, offset of the pixels)."""
    lines = _lines(blob)
    for line, _ in lines:
        if line[:1] in (b"", b"\0", b"\n"):
            break
        if line != _FORMAT:
            continue
        blank, _ = next(lines, (b"", 0))
        size, pos = next(lines, (b"", 0))
        m = _SIZE.match(size.split(b"\0", 1)[0])
        if blank == b"\n" and m:
            return int(m.group(2)), int(m.group(1)), pos
        break
    unreadable(path, "not a Radiance header cv2 reads (FORMAT "
               "32-bit_rle_rgbe, -Y H +X W)")


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """rgbe2float: (…, 4) uint8 → (…, 3) float32 R, G, B."""
    e = rgbe[..., 3:].astype(np.int32)
    f = np.ldexp(np.float64(1.0), e - 136).astype(np.float32)
    out = rgbe[..., :3].astype(np.float32) * f
    return np.where(e != 0, out, np.float32(0))


def read_hdr(path, mode: str = "unchanged") -> np.ndarray:
    if mode not in ("unchanged", "color", "grey"):
        raise ValueError(f"unknown read mode {mode!r}")
    blob = Path(path).read_bytes()
    w, h, pos = _header(blob, path)
    if w <= 0 or h <= 0:
        unreadable(path, "Radiance image of no pixels")
    n, rgbe = native.hdr_decode(blob[pos:], w, h)
    if n == -2:
        unreadable(path, "Radiance data ends early")
    if n < 0:
        unreadable(path, "bad Radiance scanline")
    img = rgbe_to_float(rgbe)
    if mode == "unchanged":
        return img
    with np.errstate(over="ignore"):
        img8 = saturate_u8(img * np.float32(255))
    return img8 if mode == "color" else cvt_grey(img8)


def float_to_rgbe(rgb: np.ndarray) -> np.ndarray:
    """float2rgbe: (…, 3) float32 → (…, 4) uint8."""
    rgb = rgb.astype(np.float32)
    v = rgb.max(-1)
    m, e = np.frexp(v)
    safe = np.where(v < 1e-32, np.float32(1), v)
    scale = (m.astype(np.float64) * 256.0 / safe).astype(np.float32)
    out = np.empty(rgb.shape[:-1] + (4,), np.uint8)
    out[..., :3] = (rgb * scale[..., None]).astype(np.int64).astype(np.uint8)
    out[..., 3] = (e + 128).astype(np.uint8)
    out[v < 1e-32] = 0
    return out


def encode_hdr(img: np.ndarray) -> bytes:
    """cv2.imwrite's `.hdr`/`.pic` bytes for (H, W) or (H, W, 3) samples in
    RGB order (uint8, uint16 or float32)."""
    img = np.asarray(img)
    if img.ndim == 2 or img.shape[2] == 1:
        img = np.repeat(img.reshape(img.shape[:2] + (1,)), 3, -1)
    if img.shape[2] == 4:
        raise ImwriteFailed("cv2 writes a .hdr of 1 or 3 channels, not 4")
    if img.shape[2] != 3:
        raise ValueError("cv2 writes a .hdr of 1 or 3 channels, not "
                         f"{img.shape[2]}")
    if img.dtype != np.float32:
        img = img.astype(np.float32) * np.float32(1 / 255.0)
    h, w = img.shape[:2]
    rgbe = float_to_rgbe(img)
    head = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (h, w)
    if w < 8 or w > 0x7FFF:
        return head + rgbe.tobytes()
    return head + native.hdr_encode_rle(rgbe)


def write_hdr(path, img: np.ndarray) -> None:
    Path(path).write_bytes(encode_hdr(img))
