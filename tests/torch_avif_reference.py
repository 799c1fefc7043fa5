"""Reference decodes for the AVIF tests: libaom's own AV1 decoder (the
opencv-python wheel's libaom 3.14) through ctypes, giving the Y, U and V
planes of an OBU stream, which `native/av1.cc` must equal. Used only by
tests and `torch_fixtures/formats/make_fixtures.py`; the port never loads
libaom."""

from __future__ import annotations

import ctypes

import numpy as np

from torch_av1_tables import libaom_path

AOM_DECODER_ABI_VERSION = 0x16   # as libavif 1.4 passes it
AOM_IMG_FMT_HIGHBITDEPTH = 0x800


class _Image(ctypes.Structure):
    _fields_ = [("fmt", ctypes.c_int), ("cp", ctypes.c_int), ("tc", ctypes.c_int),
                ("mc", ctypes.c_int), ("monochrome", ctypes.c_int), ("csp", ctypes.c_int),
                ("range", ctypes.c_int), ("w", ctypes.c_uint), ("h", ctypes.c_uint),
                ("bit_depth", ctypes.c_uint), ("d_w", ctypes.c_uint), ("d_h", ctypes.c_uint),
                ("r_w", ctypes.c_uint), ("r_h", ctypes.c_uint),
                ("x_chroma_shift", ctypes.c_uint), ("y_chroma_shift", ctypes.c_uint),
                ("planes", ctypes.c_void_p * 3), ("stride", ctypes.c_int * 3)]


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(libaom_path())
        lib.aom_codec_av1_dx.restype = ctypes.c_void_p
        lib.aom_codec_dec_init_ver.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                               ctypes.c_long, ctypes.c_int]
        lib.aom_codec_decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
                                         ctypes.c_void_p]
        lib.aom_codec_get_frame.restype = ctypes.POINTER(_Image)
        lib.aom_codec_get_frame.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.aom_codec_destroy.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def libaom_planes(obus: bytes):
    """[Y, U, V] (or [Y]) uint16 planes of the first frame libaom decodes
    from `obus`, or None when libaom fails."""
    lib = _lib()
    ctx = ctypes.create_string_buffer(256)
    if lib.aom_codec_dec_init_ver(ctx, lib.aom_codec_av1_dx(), None, 0,
                                  AOM_DECODER_ABI_VERSION):
        raise RuntimeError("aom_codec_dec_init_ver failed")
    try:
        if lib.aom_codec_decode(ctx, obus, len(obus), None):
            return None
        it = ctypes.c_void_p(0)
        img = lib.aom_codec_get_frame(ctx, ctypes.byref(it))
        if not img:
            return None
        im = img.contents
        high = bool(im.fmt & AOM_IMG_FMT_HIGHBITDEPTH)
        out = []
        for p in range(1 if im.monochrome else 3):
            w = im.d_w if p == 0 else (im.d_w + im.x_chroma_shift) >> im.x_chroma_shift
            h = im.d_h if p == 0 else (im.d_h + im.y_chroma_shift) >> im.y_chroma_shift
            stride = im.stride[p]
            dtype = np.uint16 if high else np.uint8
            buf = (ctypes.c_char * (stride * h)).from_address(im.planes[p])
            rows = np.frombuffer(bytes(buf), np.uint8).reshape(h, stride)
            plane = rows.view(dtype)[:, :w] if high else rows[:, :w]
            out.append(plane.astype(np.uint16))
        return out
    finally:
        lib.aom_codec_destroy(ctx)
