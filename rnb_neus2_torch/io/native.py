"""The codecs' C helpers (`native/codecs.cc`): LZW and PackBits for TIFF,
RLE for EXR, and the Huffman coding of JPEG scans. Built with g++ into
`build/` at first use (`kernels/build.py:load_host_library`) and bound
with ctypes; each returns a byte count or a negative error code.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from ..kernels.build import load_host_library

SOURCE = Path(__file__).resolve().parent.parent / "native" / "codecs.cc"
LIBRARY = "codecs"

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
SIGNATURES = {
    "lzw_decode": [_P, _I64, _P, _I64],
    "lzw_encode": [_P, _I64, _P, _I64],
    "packbits_decode": [_P, _I64, _P, _I64],
    "packbits_encode": [_P, _I64, _I64, _P, _I64],
    "exr_rle_decode": [_P, _I64, _P, _I64],
    "jpeg_decode_scan": [_P, _I64, _I64, _I64, _I32, _P, _P, _P, _P, _I32,
                         _P, _P, _I32, _P],
    "jpeg_encode_scan": [_P, _I64, _I32, _P, _P, _P, _P, _P, _P, _I64],
}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib, _ = load_host_library(LIBRARY, SOURCE)
    for name, args in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int64, args
    return lib


def ptr(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def _bytes_call(name: str, src: bytes, cap: int, *extra) -> bytes:
    """Run `name(src, len(src), *extra, dst, cap)`; raise ValueError with
    the code on failure."""
    dst = np.empty(max(cap, 1), np.uint8)
    n = getattr(_library(), name)(src, len(src), *extra, ptr(dst), cap)
    if n < 0:
        raise ValueError(f"{name} failed with code {n}")
    return dst[:n].tobytes()


def lzw_decode(src: bytes, size: int) -> bytes:
    return _bytes_call("lzw_decode", src, size)


def lzw_encode(src: bytes) -> bytes:
    # codes are at most 12 bits for each input byte, plus clear codes
    return _bytes_call("lzw_encode", src, 2 * len(src) + 64)


def packbits_decode(src: bytes, size: int) -> bytes:
    return _bytes_call("packbits_decode", src, size)


def packbits_encode(rows: np.ndarray) -> bytes:
    rows = np.ascontiguousarray(rows, np.uint8)
    cap = rows.size + rows.size // 64 + 2 * rows.shape[0] + 16
    dst = np.empty(cap, np.uint8)
    n = _library().packbits_encode(ptr(rows), rows.shape[0], rows.shape[1],
                                   ptr(dst), cap)
    if n < 0:
        raise ValueError(f"packbits_encode failed with code {n}")
    return dst[:n].tobytes()


def exr_rle_decode(src: bytes, size: int) -> bytes:
    return _bytes_call("exr_rle_decode", src, size)


def jpeg_decode_scan(blob: bytes, pos: int, block_comp: np.ndarray,
                     rows: np.ndarray, comp_dc: np.ndarray,
                     comp_ac: np.ndarray, bits: np.ndarray, vals: np.ndarray,
                     restart: int, coefs: np.ndarray) -> int:
    """Decode one scan into `coefs` (see codecs.cc); → the position of the
    marker that ends it, or a negative error code."""
    return _library().jpeg_decode_scan(
        blob, len(blob), pos, rows.size // block_comp.size, block_comp.size,
        ptr(block_comp), ptr(rows), ptr(comp_dc), ptr(comp_ac),
        bits.size // 16, ptr(bits), ptr(vals), restart, ptr(coefs))


def jpeg_encode_scan(blocks: np.ndarray, block_comp: np.ndarray,
                     comp_dc: np.ndarray, comp_ac: np.ndarray,
                     ehufco: np.ndarray, ehufsi: np.ndarray) -> bytes:
    """Entropy-code (n, 64) int16 blocks in scan order (see codecs.cc)."""
    cap = blocks.size * 8 + 1024
    out = np.empty(cap, np.uint8)
    n = _library().jpeg_encode_scan(
        ptr(blocks), blocks.shape[0], block_comp.size, ptr(block_comp),
        ptr(comp_dc), ptr(comp_ac), ptr(ehufco), ptr(ehufsi), ptr(out), cap)
    if n < 0:
        raise ValueError(f"jpeg_encode_scan failed with code {n}")
    return out[:n].tobytes()
