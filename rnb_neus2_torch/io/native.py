"""The codecs' C helpers (`native/codecs.cc`): LZW and PackBits for TIFF,
RLE for EXR, and the entropy coding of JPEG scans (sequential and
progressive Huffman, arithmetic, lossless). Built with g++ into
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
                         _P, _P, _I32, _P, _P],
    "jpeg_decode_progressive": [_P, _I64, _I64, _I64, _I32, _P, _P, _P,
                                _P, _I32, _P, _P, _I32, _I32, _I32, _I32,
                                _I32, _P, _P],
    "jpeg_decode_arith": [_P, _I64, _I64, _I64, _I32, _P, _P, _I32, _P, _P,
                          _P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32,
                          _P],
    "jpeg_decode_lossless": [_P, _I64, _I64, _I32, _I32, _I32, _P, _I32, _P,
                             _P, _I32, _I32, _I32, _I32, _P],
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
                     restart: int, coefs: np.ndarray) -> tuple:
    """Decode one scan into `coefs` (see codecs.cc); → (the position of
    the marker that ends it or a negative error code, the MCU at which
    the data ran out or -1)."""
    stopped = np.zeros(1, np.int64)
    end = _library().jpeg_decode_scan(
        blob, len(blob), pos, rows.size // block_comp.size, block_comp.size,
        ptr(block_comp), ptr(rows), ptr(comp_dc), ptr(comp_ac),
        bits.size // 16, ptr(bits), ptr(vals), restart, ptr(coefs),
        ptr(stopped))
    return end, int(stopped[0])


def jpeg_decode_progressive(blob: bytes, pos: int, block_comp, rows,
                            comp_dc, comp_ac, bits, vals, restart: int,
                            ss: int, se: int, ah: int, al: int,
                            coefs: np.ndarray) -> int:
    """One progressive Huffman scan of band ss..se at bits ah/al into
    `coefs`; → as `jpeg_decode_scan`."""
    stopped = np.zeros(1, np.int64)
    end = _library().jpeg_decode_progressive(
        blob, len(blob), pos, rows.size // block_comp.size, block_comp.size,
        ptr(block_comp), ptr(rows), ptr(comp_dc), ptr(comp_ac),
        bits.size // 16, ptr(bits), ptr(vals), restart, ss, se, ah, al,
        ptr(coefs), ptr(stopped))
    return end, int(stopped[0])


def jpeg_decode_arith(blob: bytes, pos: int, block_comp, rows, dc_tbl,
                      ac_tbl, dc_l, dc_u, ac_k, restart: int,
                      progressive: bool, ss: int, se: int, ah: int, al: int,
                      coefs: np.ndarray) -> int:
    """One arithmetic-coded scan (sequential, or a progressive band) with
    the DAC conditioning `dc_l`, `dc_u`, `ac_k` (uint8, 16 tables each);
    → as `jpeg_decode_scan`."""
    return _library().jpeg_decode_arith(
        blob, len(blob), pos, rows.size // block_comp.size, block_comp.size,
        ptr(block_comp), ptr(rows), dc_tbl.size, ptr(dc_tbl), ptr(ac_tbl),
        ptr(dc_l), ptr(dc_u), ptr(ac_k), restart, int(progressive), ss, se,
        ah, al, ptr(coefs))


def jpeg_decode_lossless(blob: bytes, pos: int, width: int, height: int,
                         comp_tbl, bits, vals, restart: int, predictor: int,
                         pt: int, precision: int, out: np.ndarray) -> int:
    """One lossless scan of comp_tbl.size interleaved components into
    `out` ((n, height, width) uint16); → as `jpeg_decode_scan`, -5 for a
    restart interval of partial rows."""
    return _library().jpeg_decode_lossless(
        blob, len(blob), pos, width, height, comp_tbl.size, ptr(comp_tbl),
        bits.size // 16, ptr(bits), ptr(vals), restart, predictor, pt,
        precision, ptr(out))


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
