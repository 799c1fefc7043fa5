"""Netpbm (PBM, PGM, PPM: P1-P6), PAM (P7) and PFM (PF, Pf), read and
written as OpenCV's grfmt_pxm, grfmt_pam and grfmt_pfm read and write
them.

PNM: ASCII and binary, comments, any maxval up to 65535. cv2 rescales
only ASCII samples of a maxval below 256 (v · 255 // maxval, clamped to
maxval first); binary 8-bit samples come as stored, and a maxval above
255 gives uint16 samples as stored. PBM bits read 1 → 0 and 0 → 255.

PAM: WIDTH, HEIGHT, DEPTH, MAXVAL and TUPLTYPE (BLACKANDWHITE, GRAYSCALE,
GRAYSCALE_ALPHA, RGB, RGB_ALPHA, each of its own DEPTH), as cv2 reads
them: the file's samples are taken as B, G, R(, A) where cv2 copies them
and as R, G, B where it converts them to grey; a MAXVAL of 1 reads rows
of DEPTH·WIDTH bytes as packed bits; a header without TUPLTYPE needs 1 or
3 channels below 256. cv2 converts 2 or 4 channels to colour or grey
by stepping over a row with the wrong stride, leaving part of its output
unwritten or writing past it: the port refuses those.

PFM: both byte orders (the scale's sign), rows bottom to top, samples
divided by |scale|; "color" converts a 3-channel file to uint8 by
saturate_cast, "grey" a 1-channel one; cv2 fails on the other two.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from . import native
from .errors import ImwriteFailed, unreadable, unsupported
from .jpeg import cv_grey, saturate_u8

_SPACE = b" \t\n\v\f\r"
PAM_FORMATS = {b"BLACKANDWHITE": 1, b"GRAYSCALE": 1, b"GRAYSCALE_ALPHA": 2,
               b"RGB": 3, b"RGB_ALPHA": 4}


def is_pnm(head: bytes) -> bool:
    return (len(head) >= 3 and head[:1] == b"P" and b"1" <= head[1:2] <= b"6"
            and head[2] in _SPACE)


def is_pam(head: bytes) -> bool:
    return len(head) >= 3 and head[:2] == b"P7" and head[2] in _SPACE


def is_pfm(head: bytes) -> bool:
    return len(head) >= 2 and head[:2] in (b"PF", b"Pf")


def _check_mode(mode: str):
    if mode not in ("unchanged", "color", "grey"):
        raise ValueError(f"unknown read mode {mode!r}")


def _numbers(blob, pos, count, path, maxdigits=0):
    end, vals = native.pnm_read_numbers(blob, pos, count, maxdigits)
    if end == -2:
        unreadable(path, "PNM data ends early")
    if end < 0:
        unreadable(path, "PNM: unexpected byte where a number starts")
    return end, vals


def _bits(rows: np.ndarray, w: int) -> np.ndarray:
    """MSB-first bits of each row, (h, w) of 0/1."""
    return np.unpackbits(rows, axis=1)[:, :w]


def _modes(img: np.ndarray, mode: str) -> np.ndarray:
    """cv2's conversion of (h, w) or (h, w, 3) RGB samples to "color" or
    "grey": 16-bit samples keep their high byte."""
    if mode == "unchanged":
        return img
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if mode == "color":
        return np.repeat(img[..., None], 3, -1) if img.ndim == 2 else img
    return img if img.ndim == 2 else cv_grey(img)


def read_pnm(path, mode: str = "unchanged") -> np.ndarray:
    _check_mode(mode)
    blob = Path(path).read_bytes()
    kind = blob[1] - ord("0")
    bpp = {1: 1, 2: 8, 3: 24}[(kind - 1) % 3 + 1]
    binary = kind >= 4
    pos, (w, h) = _numbers(blob, 2, 2, path)
    maxval = 1
    if bpp > 1:
        pos, (maxval,) = _numbers(blob, pos, 1, path)
    if maxval > 65535 or not (w > 0 and h > 0 and maxval > 0):
        unreadable(path, "not a PNM header cv2 reads")
    nch = 3 if bpp == 24 else 1
    if bpp == 1:
        if binary:
            pitch = (w + 7) // 8
            if pos + pitch * h > len(blob):
                unreadable(path, "PNM data ends early")
            rows = np.frombuffer(blob, np.uint8, pitch * h, pos) \
                .reshape(h, pitch)
            bit = _bits(rows, w)
        else:
            _, v = _numbers(blob, pos, w * h, path, maxdigits=1)
            bit = (v != 0).reshape(h, w)
        img = np.where(bit == 1, 0, 255).astype(np.uint8)
    elif binary:
        size = 2 if maxval > 255 else 1
        n = w * h * nch
        if pos + n * size > len(blob):
            unreadable(path, "PNM data ends early")
        img = np.frombuffer(blob, ">u2" if size == 2 else np.uint8, n, pos) \
            .astype(np.uint16 if size == 2 else np.uint8)
    else:
        _, v = _numbers(blob, pos, w * h * nch, path)
        v = np.minimum(v.astype(np.int64), maxval)
        img = (v * 255 // maxval).astype(np.uint8) if maxval < 256 \
            else v.astype(np.uint16)
    img = img.reshape(h, w, nch) if nch == 3 else img.reshape(h, w)
    return np.ascontiguousarray(_modes(img, mode))


# --------------------------------------------------------------- PAM
def _pam_number(value: bytes, path) -> int:
    m = re.fullmatch(rb"[ \t\v\f]*([+-]?\d+)[ \t\v\f]*", value)
    if not m:
        unreadable(path, f"PAM header value {value!r}")
    v = int(m.group(1))
    if v < 0:
        unreadable(path, f"PAM header value {v}")
    return v


def _pam_header(blob: bytes, path):
    if len(blob) < 3 or blob[2:3] not in (b"\n", b"\r"):
        unreadable(path, "not a PAM header cv2 reads")
    pos, fields = 3, {}

    def byte():
        nonlocal pos
        if pos >= len(blob):
            unreadable(path, "PAM header ends early")
        pos += 1
        return blob[pos - 1]

    while True:
        c = byte()
        while c in _SPACE:
            c = byte()
        if c == ord("#"):
            while c not in b"\n\r":
                c = byte()
            continue
        ident = bytearray()
        while len(ident) < 8 and c not in _SPACE:
            ident.append(c)
            c = byte()
        ident = bytes(ident)
        if ident not in (b"ENDHDR", b"HEIGHT", b"WIDTH", b"DEPTH", b"MAXVAL",
                         b"TUPLTYPE"):
            unreadable(path, f"PAM header field {ident!r}")
        value = bytearray()
        while c not in b"\n\r":
            value.append(c)
            c = byte()
        if ident == b"ENDHDR":
            break
        if ident == b"TUPLTYPE":
            name = bytes(value).strip(_SPACE)
            if name not in PAM_FORMATS:
                unreadable(path, f"PAM TUPLTYPE {name!r}")
            fields[ident] = name
            continue
        if ident in fields:
            unreadable(path, f"PAM field {ident.decode()} given twice")
        fields[ident] = _pam_number(bytes(value), path)
    if not all(k in fields for k in (b"HEIGHT", b"WIDTH", b"DEPTH",
                                     b"MAXVAL")):
        unreadable(path, "PAM header lacks a field")
    w, h, ch, maxval = (fields[k] for k in (b"WIDTH", b"HEIGHT", b"DEPTH",
                                            b"MAXVAL"))
    fmt = fields.get(b"TUPLTYPE")
    if maxval > 65535:
        unreadable(path, f"PAM MAXVAL {maxval}")
    if fmt is None:
        if ch == 1 and maxval < 256:
            fmt = b"BLACKANDWHITE" if maxval == 1 else b"GRAYSCALE"
        elif ch == 3 and maxval < 256:
            fmt = b"RGB"
        else:
            unreadable(path, f"PAM of {ch} channels at MAXVAL {maxval} "
                       "without TUPLTYPE")
    if PAM_FORMATS[fmt] != ch:
        unreadable(path, f"PAM {fmt.decode()} of {ch} channels")
    if not (w > 0 and h > 0):
        unreadable(path, "PAM of no pixels")
    return w, h, ch, maxval, fmt, pos


def read_pam(path, mode: str = "unchanged") -> np.ndarray:
    _check_mode(mode)
    blob = Path(path).read_bytes()
    w, h, ch, maxval, fmt, pos = _pam_header(blob, path)
    size = 2 if maxval > 255 else 1
    n = w * h * ch
    if pos + n * size > len(blob):
        unreadable(path, "PAM data ends early")
    target = {"unchanged": ch, "color": 3, "grey": 1}[mode]
    if maxval == 1:
        if target not in (1, 3):
            unreadable(path, f"bit PAM read as {target} channels")
        rows = np.frombuffer(blob, np.uint8, n, pos).reshape(h, w * ch)
        img = np.where(_bits(rows, w) == 1, 255, 0).astype(np.uint8)
        return np.repeat(img[..., None], 3, -1) if target == 3 else img
    raw = np.frombuffer(blob, ">u2" if size == 2 else np.uint8, n, pos) \
        .reshape(h, w, ch).astype(np.uint16 if size == 2 else np.uint8)
    if mode == "unchanged":
        return np.ascontiguousarray(raw[..., [2, 1, 0, 3][:ch]]
                                    if ch >= 3 else raw[..., 0]
                                    if ch == 1 else raw)
    s8 = (raw >> 8).astype(np.uint8) if size == 2 else raw
    if ch == target:
        return np.ascontiguousarray(s8[..., ::-1] if ch == 3 else s8[..., 0])
    if ch == 3:
        return cv_grey(s8)
    if ch == 1:
        return np.repeat(s8, 3, -1)
    unsupported(path, f"{ch}-channel PAM read as {mode} (cv2 leaves part "
                "of the image unwritten, or writes past it)")


# --------------------------------------------------------------- PFM
_FLOAT = re.compile(rb"[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|"
                    rb"inf(?:inity)?|nan)", re.I)


def _pfm_token(blob: bytes, pos: int, path):
    end = pos
    while True:
        if end >= len(blob):
            unreadable(path, "PFM header ends early")
        c = blob[end]
        if c >= 128:
            unreadable(path, "PFM header byte out of range")
        if c in _SPACE:
            return blob[pos:end], end + 1
        end += 1


def read_pfm(path, mode: str = "unchanged") -> np.ndarray:
    _check_mode(mode)
    blob = Path(path).read_bytes()
    nch = 3 if blob[1:2] == b"F" else 1
    if blob[2:3] != b"\n":
        unreadable(path, "PFM header lacks its line break")
    tok, pos = _pfm_token(blob, 3, path)
    m = re.match(rb"[+-]?\d+", tok)
    w = int(m.group()) if m else 0
    tok, pos = _pfm_token(blob, pos, path)
    m = re.match(rb"[+-]?\d+", tok)
    h = int(m.group()) if m else 0
    tok, pos = _pfm_token(blob, pos, path)
    m = _FLOAT.match(tok)
    scale = float(m.group()) if m else 0.0
    if not (w > 0 and h > 0):
        unreadable(path, "PFM of no pixels")
    if (mode == "color") != (nch == 3) and mode != "unchanged":
        unreadable(path, f"{nch}-channel PFM read as {mode} (cv2 fails)")
    n = w * h * nch
    if pos + 4 * n > len(blob):
        unreadable(path, "PFM data ends early")
    if scale == 0.0:
        unreadable(path, "PFM scale 0")
    img = np.frombuffer(blob, ">f4" if scale >= 0 else "<f4", n, pos) \
        .astype(np.float32).reshape(h, w, nch)[::-1]
    img = img * np.float32(1.0 / abs(scale))
    img = img[..., 0] if nch == 1 else img
    if mode != "unchanged":
        img = saturate_u8(img)
    return np.ascontiguousarray(img)


# --------------------------------------------------------------- writers
def _samples(img: np.ndarray, fmt: str) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"{fmt} samples are uint8 or uint16, not "
                         f"{img.dtype}")
    return img[..., 0] if img.ndim == 3 and img.shape[2] == 1 else img


def encode_pnm(img: np.ndarray, kind: str = "auto") -> bytes:
    """cv2.imwrite's bytes for `.pbm` ("pbm"), `.pgm` ("pgm"), `.ppm`
    ("ppm") or `.pnm` ("auto": grey → P5, colour → P6); binary,
    RGB samples in, maxval 255 or 65535."""
    img = _samples(img, "PNM")
    ch = 1 if img.ndim == 2 else img.shape[2]
    if kind == "auto":
        kind = "pgm" if ch == 1 else "ppm"
    if ch not in (1, 3, 4):
        raise ValueError(f"cv2 writes 1, 3 or 4 channels, not {ch}")
    if kind == "pgm" and ch != 1:
        raise ImwriteFailed("cv2 writes a .pgm from grey samples only, not "
                            f"{ch} channels")
    if kind == "ppm" and ch != 3:
        raise ImwriteFailed("cv2 writes a .ppm from 3 channels only, not "
                            f"{ch}")
    h, w = img.shape[:2]
    if kind == "pbm":
        if ch != 1:
            raise ImwriteFailed("cv2 writes a .pbm from grey samples "
                                f"only, not {ch} channels")
        bits = (np.minimum(img, 255).astype(np.uint8) == 0)
        return b"P4\n%d %d\n" % (w, h) + np.packbits(bits, axis=1).tobytes()
    depth = img.dtype.itemsize * 8
    head = b"P%d\n%d %d\n%d\n" % (5 if ch == 1 else 6, w, h,
                                  (1 << depth) - 1)
    return head + img.astype(img.dtype.newbyteorder(">")).tobytes()


def encode_pam(img: np.ndarray) -> bytes:
    """cv2.imwrite's `.pam`: no TUPLTYPE, samples as B, G, R(, A) (so cv2
    cannot read back what it writes of 2 or 4 channels, or at 16 bits)."""
    img = _samples(img, "PAM")
    ch = 1 if img.ndim == 2 else img.shape[2]
    if ch not in (1, 3, 4):
        raise ValueError(f"cv2 writes a PAM of 1, 3 or 4 channels, not {ch}")
    h, w = img.shape[:2]
    if ch >= 3:
        img = img[..., [2, 1, 0, 3][:ch]]
    head = b"P7\nWIDTH %d\nHEIGHT %d\nDEPTH %d\nMAXVAL %d\nENDHDR\n" % (
        w, h, ch, (1 << img.dtype.itemsize * 8) - 1)
    return head + img.astype(img.dtype.newbyteorder(">")).tobytes()


def encode_pfm(img: np.ndarray) -> bytes:
    """cv2.imwrite's `.pfm`: 1 or 3 channels, samples converted to float32
    unscaled (uint8 255 → 255.0), little-endian (scale -1), bottom row
    first. Of 4 channels cv2 writes "P" and fails."""
    img = np.asarray(img)
    ch = 1 if img.ndim == 2 else img.shape[2]
    if ch == 4:
        raise ImwriteFailed("cv2 writes a .pfm of 1 or 3 channels, not 4",
                            left=b"P")
    if ch not in (1, 3):
        raise ValueError(f"cv2 writes a .pfm of 1 or 3 channels, not {ch}")
    h, w = img.shape[:2]
    head = b"P%s\n%d %d\n-1\n" % (b"f" if ch == 1 else b"F", w, h)
    return head + img.astype("<f4")[::-1].tobytes()


def write_pnm(path, img, kind="auto"):
    Path(path).write_bytes(encode_pnm(img, kind))


def write_pam(path, img):
    Path(path).write_bytes(encode_pam(img))


def write_pfm(path, img):
    Path(path).write_bytes(encode_pfm(img))

