"""The codecs' C helpers (`native/codecs.cc`): LZW and PackBits for TIFF,
RLE for EXR, the entropy coding of JPEG scans (sequential and
progressive Huffman, arithmetic, lossless), BMP RLE, PNM's ASCII
numbers, Radiance RLE, GIF LZW, WebP's lossless and lossy bitstreams,
TIFF's CCITT and ThunderScan codecs, and a JPEG 2000 tile (tier-2,
tier-1, the inverse wavelet). Built with g++ into
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
    "bmp_rle_decode": [_P, _I64, _I64, _I64, _I32, _P],
    "pnm_read_numbers": [_P, _I64, _I64, _I64, _I32, _P],
    "hdr_decode": [_P, _I64, _I64, _I64, _P],
    "hdr_encode_rle": [_P, _I64, _I64, _P, _I64],
    "gif_lzw_decode": [_P, _I64, _I32, _I64, _P],
    "gif_lzw_encode": [_P, _I64, _I32, _P, _I64],
    "gif_dither": [_P, _I32, _I32, _I32, _P],
    "vp8l_decode": [_P, _I64, _I32, _I32, _P, _P, _P, _I64],
    "vp8l_unpredict": [_P, _I32, _I32, _P, _I32],
    "vp8l_encode": [_P, _I32, _I32, _I32, _P, _I64],
    "vp8l_analyze": [_P, _I32, _I32, _P, _P, _P],
    "sgilog_decode": [_P, _I64, _I32, _I32, _I32, _P, _P],
    "alpha_ungradient": [_P, _I32, _I32],
    "vp8_parse": [_P, _I64, _P, _P, _P, _I64],
    "vp8_reconstruct": [_P, _P, _P, _P, _P, _P],
    "fax_decode": [_P, _I64, _I32, _I32, _I32, _I32, _I64, _I64, _P],
    "thunder_decode": [_P, _I64, _I64, _I64, _P],
    "j2k_decode_tile": [_P, _I64, _P, _I64, _I32, _P, _I32, _P, _P, _I32,
                        _P, _I32, _P, _I32, _P, _P],
    "j2k_encode_tile": [_P, _I32, _I32, _I32, _I32, _I64, _P, _I64],
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


def bmp_rle_decode(src: bytes, w: int, h: int, bits: int) -> tuple:
    """BMP RLE8 / RLE4 data → (0 or a negative code, (h, w) uint8 palette
    indices in file row order)."""
    out = np.empty((h, w), np.uint8)
    code = _library().bmp_rle_decode(src, len(src), w, h, bits, ptr(out))
    return code, out


def pnm_read_numbers(blob: bytes, pos: int, count: int,
                     maxdigits: int = 0) -> tuple:
    """`count` ASCII numbers as OpenCV's PxM ReadNumber reads them from
    `pos` → (the position after them or a negative code, int32 values)."""
    out = np.zeros(max(count, 1), np.int32)
    end = _library().pnm_read_numbers(blob, len(blob), pos, count,
                                      maxdigits, ptr(out))
    return end, out[:count]


def hdr_decode(src: bytes, w: int, h: int) -> tuple:
    """Radiance scanlines → (bytes consumed or a negative code, (h, w, 4)
    RGBE bytes)."""
    out = np.empty((h, w, 4), np.uint8)
    return _library().hdr_decode(src, len(src), w, h, ptr(out)), out


def hdr_encode_rle(rgbe: np.ndarray) -> bytes:
    """(h, w, 4) RGBE bytes → new-style RLE scanlines."""
    rgbe = np.ascontiguousarray(rgbe, np.uint8)
    h, w = rgbe.shape[:2]
    cap = h * (4 + 4 * (w + w // 128 + 2))
    dst = np.empty(cap, np.uint8)
    n = _library().hdr_encode_rle(ptr(rgbe), w, h, ptr(dst), cap)
    if n < 0:
        raise ValueError(f"hdr_encode_rle failed with code {n}")
    return dst[:n].tobytes()


def gif_lzw_decode(src: bytes, min_size: int, npix: int) -> tuple:
    """One GIF image's LZW payload → (pixels decoded or -1, the (npix,)
    uint8 indices)."""
    out = np.zeros(npix, np.uint8)
    n = _library().gif_lzw_decode(src, len(src), min_size, npix, ptr(out))
    return n, out


def gif_lzw_encode(indices: bytes, min_size: int) -> bytes:
    # at most 12 bits per index, plus a clear code every 3,838 codes
    return _bytes_call("gif_lzw_encode", indices, 2 * len(indices) + 64,
                       min_size)


def gif_dither(image: np.ndarray) -> tuple:
    """(h, w, 3 or 4) uint8 → (whether any pixel is transparent, (h, w)
    uint8 palette indices), as OpenCV 5's GIF encoder maps them."""
    image = np.ascontiguousarray(image, np.uint8)
    h, w, nc = image.shape
    out = np.empty((h, w), np.uint8)
    flag = _library().gif_dither(ptr(image), w, h, nc, ptr(out))
    return bool(flag), out


def vp8l_decode(src: bytes, w: int, h: int) -> tuple:
    """A VP8L image stream → (the entropy-coded ARGB pixels (uint32, at
    the width left after colour indexing, flat), the transforms' records
    (int32, 4 each), their data (uint32), the number of transforms or
    -1)."""
    out = np.zeros(w * h, np.uint32)
    tinfo = np.zeros(16, np.int32)
    cap = 2 * (w * h) + 4096
    tdata = np.zeros(cap, np.uint32)
    n = _library().vp8l_decode(src, len(src), w, h, ptr(out), ptr(tinfo),
                               ptr(tdata), cap)
    return out, tinfo, tdata, n


def vp8l_encode(rgba: np.ndarray, alpha_used: bool) -> bytes:
    """(h, w, 4) RGBA uint8 → a VP8L bitstream (see codecs.cc)."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    # at most 15 bits a channel, plus the codes' headers
    cap = 8 * rgba.size + 4096
    dst = np.empty(cap, np.uint8)
    n = _library().vp8l_encode(ptr(rgba), w, h, int(alpha_used), ptr(dst),
                               cap)
    if n < 0:
        raise ValueError(f"vp8l_encode failed with code {n}")
    return dst[:n].tobytes()


def vp8l_analyze(rgba: np.ndarray) -> tuple:
    """libwebp's lossless analysis of (h, w, 4) RGBA uint8 at cv2's
    settings → (the RGBA libwebp's file decodes to, info = {transform set
    (0 direct, 1 spatial, 2 subtract-green, 3 spatial + subtract-green, 4
    palette), palette size (257: more than 256 colours), predictor tile
    bits, tiles across, tiles down}, the predictor's modes (tiles down,
    tiles across) or None where no spatial set was chosen)."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    info = np.zeros(5, np.int32)
    modes = np.zeros(-(-w // 4) * -(-h // 4), np.uint32)
    out = np.empty_like(rgba)
    _library().vp8l_analyze(ptr(rgba), w, h, ptr(info), ptr(modes), ptr(out))
    tiles = None
    if info[0] in (1, 3):
        tiles = ((modes[:info[3] * info[4]] >> 8) & 0xFF).reshape(
            info[4], info[3]).astype(np.int32)
    return out, info, tiles


def sgilog_decode(src: bytes, kind: int, cols: int, rows: int) -> tuple:
    """One SGILog chunk (kind 0 LogL, 1 LogLuv32, 2 LogLuv24) → (float32
    Y or XYZ, uint8 grey or RGB as libtiff's 8-bit interface gives it,
    the bytes read or −(rows decoded + 1) where the data ends first)."""
    ch = 1 if kind == 0 else 3
    y = np.zeros((rows, cols, ch), np.float32)
    out8 = np.zeros((rows, cols, ch), np.uint8)
    n = _library().sgilog_decode(src, len(src), kind, cols, rows, ptr(y),
                                 ptr(out8))
    return y, out8, n


def vp8l_unpredict(px: np.ndarray, modes: np.ndarray, bits: int) -> None:
    """The predictor transform's inverse, in place on (h, w) uint32."""
    modes = np.ascontiguousarray(modes, np.uint32)
    _library().vp8l_unpredict(ptr(px), px.shape[1], px.shape[0],
                              ptr(modes), bits)


def alpha_ungradient(a: np.ndarray) -> None:
    """The ALPH gradient filter's inverse, in place on (h, w) uint8."""
    _library().alpha_ungradient(ptr(a), a.shape[1], a.shape[0])


def fax_decode(src: bytes, kind: int, two_d: int, lsb_first: bool,
               odd_start: int, width: int, rows: int, out: np.ndarray) -> int:
    """CCITT data (TIFF compression `kind`: 2, 3, 4 or 32771) → packed
    1-bit rows in `out`; → bytes written or a negative code."""
    return _library().fax_decode(src, len(src), kind, two_d, int(lsb_first),
                                 odd_start, width, rows, ptr(out))


def thunder_decode(src: bytes, width: int, rows: int,
                   out: np.ndarray) -> int:
    """ThunderScan data → packed 4-bit rows in `out`; → bytes or -1."""
    return _library().thunder_decode(src, len(src), width, rows, ptr(out))


def j2k_decode_tile(data: bytes, head: bytes, comps, bands, steps, precs,
                    cblks, packets, out: np.ndarray) -> int:
    """One JPEG 2000 tile (see codecs.cc) into `out` (int32 words);
    → 0 or a negative code."""
    arrays = [np.ascontiguousarray(a) for a in (comps, bands, steps, precs,
                                                cblks, packets)]
    comps, bands, steps, precs, cblks, packets = arrays
    return _library().j2k_decode_tile(
        data, len(data), head, len(head), len(comps), ptr(comps),
        len(bands), ptr(bands), ptr(steps), len(precs), ptr(precs),
        len(cblks), ptr(cblks), len(packets), ptr(packets), ptr(out))


def j2k_encode_tile(samples: np.ndarray, prec: int, maxlen: int) -> bytes:
    """(nc, h, w) int32 samples of `prec` bits → one tile's packets, coded
    and rate-allocated as OpenJPEG 2.5 does for cv2 (see codecs.cc)."""
    nc, h, w = samples.shape
    cap = 2 * samples.size * ((prec + 7) // 8) + 65536
    dst = np.empty(cap, np.uint8)
    n = _library().j2k_encode_tile(ptr(samples), w, h, nc, prec, maxlen,
                                   ptr(dst), cap)
    if n < 0:
        raise ValueError(f"j2k_encode_tile failed with code {n}")
    return dst[:n].tobytes()


VP8_MAX_MB = 1 << 20


def vp8_parse(src: bytes) -> tuple:
    """A VP8 key frame → (info int32[64], per-macroblock modes uint8,
    dequantized coefficients int16, 0 or a negative code)."""
    n_mb = VP8_MAX_MB
    if len(src) >= 10:
        w = (src[6] | (src[7] << 8)) & 0x3FFF
        h = (src[8] | (src[9] << 8)) & 0x3FFF
        n_mb = min(n_mb, ((w + 15) >> 4) * ((h + 15) >> 4))
    info = np.zeros(64, np.int32)
    mb = np.zeros(20 * max(n_mb, 1), np.uint8)
    coeffs = np.zeros(400 * max(n_mb, 1), np.int16)
    code = _library().vp8_parse(src, len(src), ptr(info), ptr(mb),
                                ptr(coeffs), n_mb)
    return info, mb, coeffs, code


def vp8_reconstruct(info, mb, resid, mbw: int, mbh: int) -> tuple:
    """Prediction, residuals and the loop filter → the Y, U, V planes at
    whole macroblocks."""
    Y = np.zeros((mbh * 16, mbw * 16), np.uint8)
    U = np.zeros((mbh * 8, mbw * 8), np.uint8)
    V = np.zeros((mbh * 8, mbw * 8), np.uint8)
    mb = np.ascontiguousarray(mb, np.uint8)
    resid = np.ascontiguousarray(resid, np.int16)
    _library().vp8_reconstruct(ptr(info), ptr(mb), ptr(resid), ptr(Y),
                               ptr(U), ptr(V))
    return Y, U, V


# ------------------------------------------------------------------ AV1
AV1_SOURCE = Path(__file__).resolve().parent.parent / "native" / "av1.cc"
AV1_LIBRARY = "av1"
AV1_INFO = ("width", "height", "bit_depth", "mono", "ssx", "ssy", "cp", "tc",
            "mc", "full_range", "profile", "still", "reduced", "csp",
            "frame_type", "operating_points", "level", "tier", "tool",
            "frames", "spatial_id", "base_q_idx")


@functools.lru_cache(maxsize=None)
def _av1_library() -> ctypes.CDLL:
    lib, _ = load_host_library(AV1_LIBRARY, AV1_SOURCE)
    lib.av1_decode.restype = ctypes.c_int64
    lib.av1_decode.argtypes = [_P, _I64, _P, _P, _I64, _P, _I32, _I32]
    return lib


AV1_CENSUS = 192   # native/av1.cc's C_COUNT


def av1_decode(obus: bytes, op: int = 0, layer: int = -1) -> tuple:
    """Decode the frames of an AV1 OBU stream (`native/av1.cc`) in
    operating point `op` → (code, info dict, [Y, U, V] uint16 planes of
    the output frame, census int64[AV1_CENSUS]). The output is the last shown
    frame, or with `layer` >= 0 the first shown frame of that spatial
    layer. code is 0 or one of the negative codes of av1.cc, and the
    planes are empty unless it is 0 (info holds the sequence header's
    fields once one was read; "tool" names the inter tool of code -9)."""
    lib = _av1_library()
    info = np.zeros(32, np.int32)
    census = np.zeros(AV1_CENSUS, np.int64)
    code = lib.av1_decode(obus, len(obus), ptr(info), None, 0, ptr(census), op, layer)
    if code > -1000:
        meta = dict(zip(AV1_INFO, (int(v) for v in info[:len(AV1_INFO)])))
        return code, meta if meta["width"] else {}, [], census
    need = -code - 1000
    planes = np.zeros(need, np.uint16)
    census[:] = 0
    code = lib.av1_decode(obus, len(obus), ptr(info), ptr(planes), need,
                          ptr(census), op, layer)
    meta = dict(zip(AV1_INFO, (int(v) for v in info[:len(AV1_INFO)])))
    if code != 0:
        return code, meta, [], census
    w, h = meta["width"], meta["height"]
    out = [planes[:w * h].reshape(h, w)]
    if not meta["mono"]:
        cw, ch = (w + meta["ssx"]) >> meta["ssx"], (h + meta["ssy"]) >> meta["ssy"]
        u = planes[w * h:w * h + cw * ch].reshape(ch, cw)
        v = planes[w * h + cw * ch:w * h + 2 * cw * ch].reshape(ch, cw)
        out += [u, v]
    return code, meta, out, census


AV1_ENC_SOURCE = Path(__file__).resolve().parent.parent / "native" / "av1_enc.cc"
AV1_ENC_LIBRARY = "av1_enc"


@functools.lru_cache(maxsize=None)
def _av1_enc_library() -> ctypes.CDLL:
    lib, _ = load_host_library(AV1_ENC_LIBRARY, AV1_ENC_SOURCE)
    lib.av1_encode.restype = ctypes.c_int64
    lib.av1_encode.argtypes = [_P, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32,
                               _I32, _P, _I64, _P, _P]
    return lib


def av1_encode(planes: list, qindex: int, colour: tuple = (2, 2, 2)) -> tuple:
    """One 8-bit full-range AV1 key frame of [Y] or [Y, U, V] (4:2:0) uint8
    planes at base_q_idx `qindex` (`native/av1_enc.cc`), with the colour
    description (primaries, transfer, matrix; (2, 2, 2) writes none) →
    (OBUs: the sequence header and the frame, the reconstructed planes a
    decoder gives, seq_level_idx)."""
    y = np.ascontiguousarray(planes[0], np.uint8)
    h, w = y.shape
    mono = len(planes) == 1
    u, v = (y, y) if mono else (np.ascontiguousarray(p, np.uint8) for p in planes[1:])
    cw, ch = (w + 1) // 2, (h + 1) // 2
    if not mono and (u.shape != (ch, cw) or v.shape != (ch, cw)):
        raise ValueError(f"chroma planes of a {w}x{h} frame are {cw}x{ch}, not "
                         f"{u.shape[1]}x{u.shape[0]} and {v.shape[1]}x{v.shape[0]}")
    recon = np.zeros(w * h + (0 if mono else 2 * cw * ch), np.uint8)
    level = np.zeros(1, np.int32)
    cap = 2 * recon.size + 4096
    for _ in range(2):
        out = np.zeros(cap, np.uint8)
        n = _av1_enc_library().av1_encode(
            ptr(y), ptr(u), ptr(v), w, h, int(mono), qindex, *colour,
            ptr(out), cap, ptr(recon), ptr(level))
        if n > -1000:
            break
        cap = -n - 1000
    if n < 0:
        raise ValueError(f"av1_encode failed with code {n} ({w}x{h}, q {qindex})")
    rec = [recon[:w * h].reshape(h, w)]
    if not mono:
        rec += [recon[w * h:w * h + cw * ch].reshape(ch, cw),
                recon[w * h + cw * ch:].reshape(ch, cw)]
    return out[:n].tobytes(), rec, int(level[0])


# ------------------------------------------------------------------ scaling
SCALE_SOURCE = Path(__file__).resolve().parent.parent / "native" / "scale.cc"
SCALE_LIBRARY = "scale"


@functools.lru_cache(maxsize=None)
def _scale_library() -> ctypes.CDLL:
    lib, _ = load_host_library(SCALE_LIBRARY, SCALE_SOURCE)
    lib.scale_plane.restype = ctypes.c_int64
    lib.scale_plane.argtypes = [_P, _I32, _I32, _P, _I32, _I32, _I32]
    return lib


def scale_plane(plane: np.ndarray, width: int, height: int,
                depth: int) -> np.ndarray:
    """`plane` scaled to width x height as libavif scales a decoded plane
    (`native/scale.cc`: libyuv's ScalePlane for 8-bit samples,
    ScalePlane_12 for deeper ones, kFilterBox) → uint16."""
    src = np.ascontiguousarray(plane, np.uint16)
    dst = np.zeros((height, width), np.uint16)
    code = _scale_library().scale_plane(ptr(src), src.shape[1], src.shape[0],
                                        ptr(dst), width, height, int(depth > 8))
    if code != 0:
        raise ValueError(f"scale_plane failed with code {code}")
    return dst


# ------------------------------------------------------------------ OpenEXR
EXR_SOURCE = Path(__file__).resolve().parent.parent / "native" / "exr.cc"
EXR_LIBRARY = "exr"
EXR_ERRORS = {-1: "data ends early", -2: "corrupt data",
              -3: "output buffer too small"}


@functools.lru_cache(maxsize=None)
def _exr_library() -> ctypes.CDLL:
    lib, _ = load_host_library(EXR_LIBRARY, EXR_SOURCE)
    for name, args in {
            "exr_huf_decode": [_P, _I64, _P, _I64],
            "exr_wav_decode": [_P, _I32, _I32, _I32, _I32, _I32],
            "exr_piz_decode": [_P, _I64, _I32, _P, _I32, _I32, _P, _I64],
            "exr_b44_decode": [_P, _I64, _I32, _P, _P, _I32, _I32, _P, _I64],
            "exr_dwa_lossy": [_P, _I64, _P, _I64, _I32, _I32, _I32, _I32, _P,
                              _P]}.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int64, args
    return lib


def _exr_check(name: str, code: int) -> int:
    if code < 0:
        raise ValueError(f"{name}: {EXR_ERRORS.get(code, code)}")
    return code


def exr_huf_decode(src: bytes, n_out: int) -> np.ndarray:
    """OpenEXR's Huffman code (PIZ, DWAA's AC) → n_out uint16 symbols."""
    out = np.zeros(max(n_out, 1), np.uint16)
    _exr_check("exr_huf_decode",
               _exr_library().exr_huf_decode(src, len(src), ptr(out), n_out))
    return out[:n_out]


def exr_wav_decode(plane: np.ndarray, max_value: int) -> None:
    """PIZ's inverse 2-D wavelet of a (ny, nx) uint16 plane, in place."""
    if plane.dtype != np.uint16 or not plane.flags.c_contiguous:
        raise ValueError("exr_wav_decode takes a C-contiguous uint16 plane")
    ny, nx = plane.shape
    _exr_library().exr_wav_decode(ptr(plane), nx, 1, ny, nx, max_value)


def exr_piz_decode(src: bytes, types, nx: int, ny: int) -> bytes:
    """One PIZ chunk of channels of pixel `types` (0 UINT, 1 HALF,
    2 FLOAT), nx x ny samples each → the uncompressed chunk."""
    types = np.asarray(types, np.int32)
    cap = nx * ny * int(np.where(types == 1, 2, 4).sum())
    dst = np.empty(max(cap, 1), np.uint8)
    n = _exr_check("exr_piz_decode", _exr_library().exr_piz_decode(
        src, len(src), types.size, ptr(types), nx, ny, ptr(dst), cap))
    return dst[:n].tobytes()


def exr_b44_decode(src: bytes, types, plinear, nx: int, ny: int) -> bytes:
    """One B44 / B44A chunk (as `exr_piz_decode`; `plinear` a flag a
    channel)."""
    types = np.asarray(types, np.int32)
    plinear = np.asarray(plinear, np.int32)
    cap = nx * ny * int(np.where(types == 1, 2, 4).sum())
    dst = np.empty(max(cap, 1), np.uint8)
    n = _exr_check("exr_b44_decode", _exr_library().exr_b44_decode(
        src, len(src), types.size, ptr(types), ptr(plinear), nx, ny,
        ptr(dst), cap))
    return dst[:n].tobytes()


def exr_dwa_lossy(ac: np.ndarray, dc: np.ndarray, n_comp: int, width: int,
                  height: int, to_linear: bool) -> tuple:
    """One DWA lossy-DCT set (1 channel, or 3 through the inverse BT.709
    transform) from run-length AC and DC uint16 values → ((n_comp, height,
    width) half bits as uint16, AC values used, DC values used)."""
    ac = np.ascontiguousarray(ac, np.uint16)
    dc = np.ascontiguousarray(dc, np.uint16)
    out = np.zeros((n_comp, height, width), np.uint16)
    used = np.zeros(2, np.int64)
    _exr_check("exr_dwa_lossy", _exr_library().exr_dwa_lossy(
        ptr(ac), ac.size, ptr(dc), dc.size, n_comp, width, height,
        int(to_linear), ptr(out), ptr(used)))
    return out, int(used[0]), int(used[1])
