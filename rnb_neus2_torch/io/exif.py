"""EXIF orientation, as cv2.imread applies it under IMREAD_COLOR and
IMREAD_GRAYSCALE (JPEG APP1 "Exif" segments, PNG eXIf chunks, WebP EXIF
chunks)."""

from __future__ import annotations

import struct

import numpy as np


def orientation(tiff: bytes) -> int:
    """Tag 0x0112 of IFD0 of a TIFF-structured EXIF blob; 1 if absent."""
    if tiff[:2] not in (b"II", b"MM"):
        return 1
    order = "<" if tiff[:2] == b"II" else ">"
    try:
        ifd, = struct.unpack_from(order + "I", tiff, 4)
        n, = struct.unpack_from(order + "H", tiff, ifd)
        for i in range(n):
            tag, typ, _, val = struct.unpack_from(order + "HHI4s", tiff,
                                                  ifd + 2 + 12 * i)
            if tag == 0x0112 and typ == 3:
                value, = struct.unpack_from(order + "H", val)
                return value if 1 <= value <= 8 else 1
    except struct.error:
        pass
    return 1


def orient(img: np.ndarray, value: int) -> np.ndarray:
    """OpenCV's ExifTransform: orientations 5-8 transpose, then flip."""
    if value >= 5:
        img = np.swapaxes(img, 0, 1)
    flip = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    return np.ascontiguousarray(np.flip(img, flip[value])
                                if value in flip else img)
