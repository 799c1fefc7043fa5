"""JPEG decode and encode, equal to what libjpeg-turbo gives cv2: no
`cv2` or `PIL`, which the card's host does not have.

Decode (`read_jpeg`, `decode_jpeg`): every frame libjpeg-turbo reads
through cv2's 8-bit interface — baseline and extended sequential
Huffman (SOF0/1), progressive Huffman (SOF2), arithmetic-coded
sequential and progressive (SOF9/10, with DAC conditioning) and lossless
(SOF3, predictors 1-7, point transform, precisions 2-8) — of 1, 3 or 4
components, interleaved or not, any integral sampling, restart
intervals and any (optimized) tables. The entropy decoders are the C
helpers of `native/codecs.cc`; the rest is numpy, following
libjpeg-turbo step by step so that the samples equal cv2's bit for bit:

- dequantization and the integer "islow" inverse DCT (jidctint.c): each
  of its two passes is an integer linear map of the 8 inputs followed by
  one rounding shift, so it runs as an exact float64 product with the
  8x8 integer matrix of the pass, then the shift and the range limit;
- block smoothing (jdcoefct.c decompress_smooth_data) of a progressive
  file whose last scans are missing: the first AC coefficients (and the
  DC, when no AC band arrived) estimated from the 5x5 DC neighbourhood;
- data that ends inside a scan or a segment, as libjpeg's fake EOI
  reads it: the MCU where it ends decodes on zero bits, later ones keep
  what earlier scans left, a lost restart marker is skipped;
- fancy upsampling (jdsample.c): h2v1 and h2v2 triangle filters with
  their alternating rounding bias, h1v2, and replication for other
  integral ratios (4:1:1) and components at most 2 samples wide; edge
  samples repeat, as libjpeg's context rows do;
- colour: YCbCr → RGB with jdcolor.c's 16-bit fixed-point tables; RGB
  (Adobe transform 0, ids 'R', 'G', 'B', a lossless file without
  markers) as it is; CMYK and YCCK (Adobe transform 2) through libjpeg's
  YCCK → CMYK and OpenCV's own CMYK → BGR. In lossless mode
  libjpeg-turbo converts no colour space, so cv2 reads those files only
  in the mode that needs none.

`IMREAD_GRAYSCALE` ("grey") of a YCbCr file is libjpeg's grey output,
the Y component; of an RGB file libjpeg's rgb_gray_convert; of a CMYK
file OpenCV's grey of its BGR. `IMREAD_COLOR` ("color") and "grey" apply
the EXIF orientation, `IMREAD_UNCHANGED` does not. What cv2 cannot read
either (hierarchical frames, 12-bit DCT and 9-16-bit lossless files,
arithmetic lossless, malformed headers) raises `errors.UnreadableImage`
naming the file and the feature.

Encode (`write_jpeg`): what `cv2.imwrite(".jpg")` writes by default —
quality 95 (IJG scaling of the Annex K tables), 4:2:0 (grey: one
component), the standard Huffman tables, JFIF APP0 — through libjpeg's
fixed-point RGB → YCbCr, h2v2 downsampling with its 1, 2 bias, edge
expansion and dummy blocks, the integer forward DCT (jfdctint.c) and
libjpeg-turbo's reciprocal quantization.
"""

from __future__ import annotations

import functools
import struct
from pathlib import Path

import numpy as np

from . import exif, native
from .errors import UnsupportedImage, unreadable, unsupported

SIGNATURE = b"\xff\xd8\xff"
QUALITY = 95                   # cv2's IMWRITE_JPEG_QUALITY default
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# SOFn markers: the frames read (baseline, extended, progressive,
# lossless; Huffman and arithmetic), and hierarchical ones (SOF5-7,
# SOF13-15 and DHP), which libjpeg-turbo does not decode
SOF = (0xC0, 0xC1, 0xC2, 0xC3, 0xC9, 0xCA, 0xCB)
EOF_FILL = b"\xff\xd9"
HIERARCHICAL = (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF, 0xDE)
SCAN_ERRORS = {-1: "bad Huffman table", -2: "bad Huffman code",
               -3: "wrong restart marker",
               -4: "data ends inside a lossless scan"}

# ITU T.81 Annex K: quantization tables (natural order) and the Huffman
# tables (BITS then HUFFVAL) libjpeg writes by default
STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA_Q = np.full(64, 99)
STD_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
_AC_LUMA_VALS = (
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_CHROMA_VALS = (
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
STD_HUFFMAN = {  # (class, id) → (BITS, HUFFVAL)
    (0, 0): (bytes.fromhex("00010501010101010100000000000000"),
             bytes(range(12))),
    (1, 0): (bytes.fromhex("0002010303020403050504040000017d"),
             bytes.fromhex(_AC_LUMA_VALS)),
    (0, 1): (bytes.fromhex("00030101010101010101010000000000"),
             bytes(range(12))),
    (1, 1): (bytes.fromhex("00020102040403040705040400010277"),
             bytes.fromhex(_AC_CHROMA_VALS)),
}

# fixed-point constants of jidctint.c / jfdctint.c (CONST_BITS = 13)
F0298, F0390, F0541, F0765 = 2446, 3196, 4433, 6270
F0899, F1175, F1501, F1847 = 7373, 9633, 12299, 15137
F1961, F2053, F2562, F3072 = 16069, 16819, 20995, 25172


# ---------------------------------------------------------------------------
# the DCTs as integer matrices
# ---------------------------------------------------------------------------

def _idct_1d(z):
    """One pass of jpeg_idct_islow before its descale: outputs 0-7 as
    integer combinations of inputs z[0..7]."""
    c1 = (z[2] + z[6]) * F0541
    tmp2, tmp3 = c1 - z[6] * F1847, c1 + z[2] * F0765
    tmp0, tmp1 = (z[0] + z[4]) << 13, (z[0] - z[4]) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = z[7], z[5], z[3], z[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * F1175
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    o0 = o0 * F0298 + z1 + z3
    o1 = o1 * F2053 + z2 + z4
    o2 = o2 * F3072 + z2 + z3
    o3 = o3 * F1501 + z1 + z4
    return [t10 + o3, t11 + o2, t12 + o1, t13 + o0,
            t13 - o0, t12 - o1, t11 - o2, t10 - o3]


def _fdct_1d(x):
    """One pass of jpeg_fdct_islow before its descale, with outputs 0 and 4
    scaled by 2^13 so that every output takes the same rounding shift."""
    t0, t7 = x[0] + x[7], x[0] - x[7]
    t1, t6 = x[1] + x[6], x[1] - x[6]
    t2, t5 = x[2] + x[5], x[2] - x[5]
    t3, t4 = x[3] + x[4], x[3] - x[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    out = [0] * 8
    out[0], out[4] = (t10 + t11) << 13, (t10 - t11) << 13
    z1 = (t12 + t13) * F0541
    out[2], out[6] = z1 + t13 * F0765, z1 - t12 * F1847
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * F1175
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    out[7] = t4 * F0298 + z1 + z3
    out[5] = t5 * F2053 + z2 + z4
    out[3] = t6 * F3072 + z2 + z3
    out[1] = t7 * F1501 + z1 + z4
    return out


@functools.lru_cache(maxsize=None)
def _matrix(kind: str) -> np.ndarray:
    fn = _idct_1d if kind == "idct" else _fdct_1d
    cols = [fn([int(i == j) for i in range(8)]) for j in range(8)]
    return np.array(cols, np.float64).T          # out = M @ in


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x.astype(np.int64) + (1 << (n - 1))) >> n


@functools.lru_cache(maxsize=None)
def _idct_range_limit() -> np.ndarray:
    """libjpeg's IDCT range-limit table, indexed by output & 1023 (the
    +128 level shift included)."""
    d = np.arange(1024)
    return np.clip(np.where(d < 512, d, d - 1024) + 128, 0, 255) \
        .astype(np.uint8)


def idct_islow(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """(n, 64) coefficients (natural order) → (n, 8, 8) uint8 samples."""
    a = _matrix("idct")
    z = (coefs.astype(np.float64) * qtable).reshape(-1, 8, 8)
    ws = _descale(a @ z, 11)                              # columns
    out = _descale(ws.astype(np.float64) @ a.T, 18)       # rows
    return _idct_range_limit()[out & 1023]


def fdct_islow(samples: np.ndarray) -> np.ndarray:
    """(n, 8, 8) level-shifted samples → (n, 8, 8) int64 coefficients,
    scaled by 8 as libjpeg's are."""
    b = _matrix("fdct")
    ws = _descale(samples.astype(np.float64) @ b.T, 11)   # rows
    return _descale(b @ ws.astype(np.float64), 15)        # columns


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

class _Frame:
    def __init__(self, seg: bytes, sof: int, path):
        if len(seg) < 6:
            unreadable(path, "JPEG frame header of the wrong length")
        prec, self.h, self.w, nc = struct.unpack_from(">BHHB", seg)
        self.sof = sof
        self.lossless = sof in (0xC3, 0xCB)
        self.progressive = sof in (0xC2, 0xCA)
        self.arith = sof >= 0xC9
        self.prec = prec
        if self.lossless:
            if not 2 <= prec <= 16:
                unreadable(path, f"{prec}-bit lossless JPEG")
        elif prec != 8:
            unreadable(path, f"{prec}-bit JPEG")
        if nc not in (1, 3, 4):
            unreadable(path, f"{nc}-component JPEG")
        if self.h == 0 or self.w == 0:
            unreadable(path, "JPEG with an empty frame")
        if len(seg) != 6 + 3 * nc:
            unreadable(path, "JPEG frame header of the wrong length")
        self.ids, self.hs, self.vs, self.tq = [], [], [], []
        for i in range(nc):
            cid, hv, tq = struct.unpack_from(">BBB", seg, 6 + 3 * i)
            if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                unreadable(path, f"JPEG sampling factors {hv:#x} outside 1-4")
            self.ids.append(cid)
            self.hs.append(hv >> 4)
            self.vs.append(hv & 15)
            self.tq.append(tq)
        self.hmax, self.vmax = max(self.hs), max(self.vs)
        if self.lossless and (self.hmax, self.vmax) != (1, 1):
            unsupported(path, "subsampled lossless JPEG")
        self.mcux = -(-self.w // (8 * self.hmax))
        self.mcuy = -(-self.h // (8 * self.vmax))
        # per component: padded block grid, sample size, rows in `coefs`
        self.bw = [self.mcux * h for h in self.hs]
        self.bh = [self.mcuy * v for v in self.vs]
        self.dw = [-(-self.w * h // self.hmax) for h in self.hs]
        self.dh = [-(-self.h * v // self.vmax) for v in self.vs]
        sizes = [bw * bh for bw, bh in zip(self.bw, self.bh)]
        self.base = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        if self.lossless:
            self.coefs = None
            self.samples = [None] * nc
        else:
            self.coefs = np.zeros((int(self.base[-1]), 64), np.int16)
        self.qt = [None] * nc
        # progression status (libjpeg's coef_bits, and its copy from the
        # start of the last scan of each component)
        self.coef_bits = np.full((nc, 64), -1, np.int64)
        self.prev_bits = np.zeros((nc, 64), np.int64)
        self.scans = 0
        # the iMCU row at which a scan's data ran out (None: none did)
        self.ran_out = None


def _scan_layout(frame: _Frame, comps):
    """Blocks of a scan in coding order → (the scan component of each
    block of an MCU, the row in frame.coefs of every block)."""
    if len(comps) == 1:
        c = comps[0]
        nby, nbx = -(-frame.dh[c] // 8), -(-frame.dw[c] // 8)
        r, x = np.mgrid[:nby, :nbx]
        rows = frame.base[c] + r * frame.bw[c] + x
        return np.zeros(1, np.int32), rows.reshape(-1)
    my, mx = (a.reshape(-1, 1) for a in np.mgrid[:frame.mcuy, :frame.mcux])
    cols, which = [], []
    for k, c in enumerate(comps):
        for v in range(frame.vs[c]):
            for h in range(frame.hs[c]):
                cols.append(frame.base[c] + (my * frame.vs[c] + v)
                            * frame.bw[c] + mx * frame.hs[c] + h)
                which.append(k)
    return (np.array(which, np.int32),
            np.concatenate(cols, axis=1).reshape(-1))


def _huffman_arrays(huff, keys, path):
    for k in keys:
        if k not in huff:
            unreadable(path, f"JPEG scan uses undefined Huffman table {k}")
    bits = np.frombuffer(b"".join(huff[k][0] for k in keys) or bytes(16),
                         np.uint8)
    vals = np.frombuffer(b"".join(huff[k][1].ljust(256, b"\0")
                                  for k in keys) or bytes(256), np.uint8)
    return bits, vals


def _check_progression(frame, comps, ss, se, ah, al, path):
    """jdphuff.c / jdarith.c start_pass: a legal band, and the
    progression status updated."""
    if frame.progressive:
        bad = (se != 0 if ss == 0 else (ss > se or se > 63
                                        or len(comps) != 1))
        if bad or (ah != 0 and al != ah - 1) or al > 13:
            unreadable(path, f"JPEG progression Ss={ss} Se={se} Ah={ah} "
                       f"Al={al}")
    else:
        ss, se = 0, 63
    for c in comps:
        lo, hi = min(ss, 1), max(se, 9)
        frame.prev_bits[c, lo:hi + 1] = (frame.coef_bits[c, lo:hi + 1]
                                         if frame.scans else 0)
        frame.coef_bits[c, ss:se + 1] = al
    return ss, se


def _decode_scan(blob, pos, seg, frame, huff, qtables, restart, dac, path):
    ns = seg[0] if seg else 0
    if not 1 <= ns <= 4 or len(seg) != 4 + 2 * ns:
        unreadable(path, f"JPEG scan header with {ns} components in "
                   f"{len(seg)} bytes")
    comps, dc, ac = [], [], []
    for i in range(ns):
        cid, tdta = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in frame.ids:
            unreadable(path, f"JPEG scan names unknown component {cid}")
        if frame.ids.index(cid) in comps:
            unreadable(path, f"JPEG scan names component {cid} twice")
        comps.append(frame.ids.index(cid))
        dc.append((0, tdta >> 4))
        ac.append((1, tdta & 15))
    ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
    ah, al = ahal >> 4, ahal & 15
    if frame.lossless:
        return _decode_lossless(blob, pos, frame, comps, dc, ss, al, huff,
                                restart, path)
    for c in comps:
        if frame.qt[c] is None:          # latched at the first scan
            if frame.tq[c] not in qtables:
                unreadable(path, f"JPEG component uses undefined "
                           f"quantization table {frame.tq[c]}")
            frame.qt[c] = qtables[frame.tq[c]]
    ss, se = _check_progression(frame, comps, ss, se, ah, al, path)
    frame.scans += 1
    block_comp, rows = _scan_layout(frame, comps)
    if block_comp.size > 10:             # libjpeg's D_MAX_BLOCKS_IN_MCU
        unreadable(path, f"JPEG MCU of {block_comp.size} blocks")
    rows = np.ascontiguousarray(rows, np.int64)
    if frame.arith:
        dc_l, dc_u, ac_k = dac
        end = native.jpeg_decode_arith(
            blob, pos, block_comp, rows,
            np.array([t for _, t in dc], np.int32),
            np.array([t for _, t in ac], np.int32), dc_l, dc_u, ac_k,
            restart, frame.progressive, ss, se, ah, al, frame.coefs)
    else:
        # the tables the scan reads: DC first needs DC tables, AC bands
        # AC ones, a DC refinement none
        need_dc = not frame.progressive or (ss == 0 and ah == 0)
        need_ac = not frame.progressive or ss > 0
        keys = sorted(set((dc if need_dc else []) + (ac if need_ac else [])))
        bits, vals = _huffman_arrays(huff, keys, path)
        comp_dc = np.array([keys.index(k) if need_dc else 0 for k in dc],
                           np.int32)
        comp_ac = np.array([keys.index(k) if need_ac else 0 for k in ac],
                           np.int32)
        if frame.progressive:
            end, stopped = native.jpeg_decode_progressive(
                blob, pos, block_comp, rows, comp_dc, comp_ac, bits, vals,
                restart, ss, se, ah, al, frame.coefs)
        else:
            end, stopped = native.jpeg_decode_scan(
                blob, pos, block_comp, rows, comp_dc, comp_ac, bits, vals,
                restart, frame.coefs)
        if stopped >= 0:
            # libjpeg's last_good_iMCU_row: the iMCU row where data ran out
            if len(comps) > 1:
                row = stopped // frame.mcux
            else:
                c = comps[0]
                row = stopped // -(-frame.dw[c] // 8) // frame.vs[c]
            frame.ran_out = max(row, frame.ran_out or 0)
    if end < 0:
        _scan_error(end, path)
    return end


def _scan_error(code, path):
    if code == -1:
        unreadable(path, "bad Huffman table")
    raise UnsupportedImage(f"{path}: corrupt JPEG data "
                           f"({SCAN_ERRORS.get(code, code)}) is not "
                           "supported")


def _decode_lossless(blob, pos, frame, comps, dc, predictor, pt, huff,
                     restart, path):
    if not 1 <= predictor <= 7 or pt >= frame.prec:
        unreadable(path, f"lossless JPEG predictor {predictor}, point "
                   f"transform {pt}")
    if frame.arith:
        unreadable(path, "arithmetic-coded lossless JPEG")
    keys = sorted(set(dc))
    bits, vals = _huffman_arrays(huff, keys, path)
    out = np.zeros((len(comps), frame.h, frame.w), np.uint16)
    end = native.jpeg_decode_lossless(
        blob, pos, frame.w, frame.h,
        np.array([keys.index(k) for k in dc], np.int32), bits, vals,
        restart, predictor, pt, frame.prec, out)
    if end == -5:
        unreadable(path, f"lossless JPEG restart interval {restart} of "
                   f"partial rows")
    if end < 0:
        _scan_error(end, path)
    for k, c in enumerate(comps):
        frame.samples[c] = out[k]
        frame.qt[c] = True
    frame.scans += 1
    return end


def _parse(blob: bytes, path, tables: bytes = b""):
    """Markers and scans of a JPEG stream (after the abbreviated table
    stream `tables`, as a TIFF's JPEGTables gives it) → (frame, EXIF
    orientation, colour space)."""
    if not blob.startswith(b"\xff\xd8"):
        unreadable(path, "not a JPEG file")
    frame, huff, qtables = None, {}, {}
    restart, orientation, jfif, adobe = 0, 1, False, None
    dac = (np.zeros(16, np.uint8), np.ones(16, np.uint8),
           np.full(16, 5, np.uint8))
    if tables:
        _tables(tables, huff, qtables, path)
    pos = 2
    while pos < len(blob):
        if blob[pos] != 0xFF:
            pos += 1              # junk between segments, skipped as libjpeg
            continue
        m = blob[pos + 1] if pos + 1 < len(blob) else 0xD9
        if m == 0xFF:
            pos += 1
            continue
        if m == 0xD9:
            break
        if 0xD0 <= m <= 0xD7 or m == 0x01:
            pos += 2
            continue
        length, = struct.unpack_from(">H", blob + EOF_FILL, pos + 2)
        if pos + 2 + length > len(blob):
            # libjpeg's source reads a fake EOI (FF D9) again and again
            # past the end of the file, into the segment it ends in
            blob += EOF_FILL * (length // 2 + 2)
        if length < 2:
            unreadable(path, f"JPEG segment {m:#x} of length {length}")
        seg = blob[pos + 4:pos + 2 + length]
        pos += 2 + length
        if m in HIERARCHICAL:
            unreadable(path, "hierarchical JPEG")
        if m in SOF:
            if frame is not None:
                unreadable(path, "JPEG with two frame headers")
            frame = _Frame(seg, m, path)
        elif m in (0xC4, 0xDB):
            _table_segment(m, seg, huff, qtables, path)
        elif m == 0xCC:
            _dac(seg, dac, path)
        elif m == 0xDD:
            if len(seg) != 2:
                unreadable(path, f"JPEG restart interval segment of "
                           f"{len(seg)} bytes")
            restart, = struct.unpack_from(">H", seg)
        elif m == 0xE0 and seg.startswith(b"JFIF\0"):
            jfif = True
        elif m == 0xE1 and orientation == 1 and seg.startswith(b"Exif\0\0"):
            orientation = exif.orientation(seg[6:])
        elif m == 0xEE and seg.startswith(b"Adobe") and len(seg) >= 12:
            adobe = seg[11]
        elif m == 0xDA:
            if frame is None:
                unreadable(path, "JPEG scan before the frame header")
            pos = _decode_scan(blob, pos, seg, frame, huff, qtables,
                               restart, dac, path)
    if frame is None or frame.scans == 0:
        unreadable(path, "JPEG without a frame or a scan")
    if any(q is None for q in frame.qt):
        unreadable(path, "JPEG component that no scan codes")
    return frame, orientation, _colour_space(frame, jfif, adobe)


def _tables(stream: bytes, huff, qtables, path):
    """The DHT and DQT segments of an abbreviated table stream."""
    pos = 2
    while pos + 4 <= len(stream) and stream[pos] == 0xFF:
        m = stream[pos + 1]
        if m == 0xD9:
            break
        length, = struct.unpack_from(">H", stream, pos + 2)
        if m in (0xC4, 0xDB):
            _table_segment(m, stream[pos + 4:pos + 2 + length], huff,
                           qtables, path)
        pos += 2 + length


def _table_segment(m, seg, huff, qtables, path):
    i = 0
    if m == 0xC4:
        while i < len(seg):
            tc, th = seg[i] >> 4, seg[i] & 15
            bits = seg[i + 1:i + 17]
            n = sum(bits)
            if tc > 1 or th > 3:
                unreadable(path, f"JPEG Huffman table index {seg[i]:#x}")
            if len(bits) < 16 or n > 256 or i + 17 + n > len(seg):
                unreadable(path, f"bad JPEG Huffman table: {n} codes in "
                           f"{len(seg) - i} bytes")
            huff[(tc, th)] = (bits, seg[i + 17:i + 17 + n])
            i += 17 + n
        return
    while i < len(seg):
        pq, tq = seg[i] >> 4, seg[i] & 15
        if pq > 1 or tq > 3 or i + 1 + 64 * (pq + 1) > len(seg):
            unreadable(path, "bad JPEG quantization table")
        q = np.zeros(64, np.int64)
        q[NATURAL] = struct.unpack_from(">64H" if pq else "64B", seg, i + 1)
        qtables[tq] = q
        i += 1 + 64 * (2 if pq else 1)


def _dac(seg, dac, path):
    """DAC: arithmetic conditioning (L, U) of a DC table, K of an AC one
    (jdmarker.c get_dac)."""
    dc_l, dc_u, ac_k = dac
    if len(seg) % 2:
        unreadable(path, "JPEG DAC segment of odd length")
    for i in range(0, len(seg), 2):
        index, val = seg[i], seg[i + 1]       # Tc << 4 | Tb, then the value
        if index >= 32:
            unreadable(path, f"JPEG DAC table index {index}")
        if index >= 16:
            ac_k[index - 16] = val
        else:
            if val & 15 > val >> 4:
                unreadable(path, f"JPEG DAC value {val:#x}")
            dc_l[index], dc_u[index] = val & 15, val >> 4


def _colour_space(frame, jfif, adobe) -> str:
    """libjpeg's default_decompress_parms: "grey", "ycc", "rgb", "cmyk"
    or "ycck"."""
    if len(frame.ids) == 1:
        return "grey"
    if len(frame.ids) == 4:
        return "ycck" if adobe == 2 else "cmyk"
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    # libjpeg-turbo takes a lossless file without either marker for RGB
    return "rgb" if frame.lossless or frame.ids == [82, 71, 66] else "ycc"


# libjpeg-turbo's block smoothing (jdcoefct.c decompress_smooth_data):
# for each of the first 9 AC coefficients in zig-zag order (natural
# position, quantizer position), the 5x5 DC weights of its estimate
# (rows: DC01-05, ..., DC21-25) without and with DC interpolation
_SMOOTH_POS = [1, 8, 16, 9, 2, 3, 10, 17, 24]
_SMOOTH_W = {
    1: ([[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-7, 50, 0, -50, 7],
         [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]],
        [[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3],
         [-3, 13, 0, -13, 3], [-1, -1, 0, 1, 1]]),
    16: ([[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0],
          [0, 0, 13, 0, 0], [0, 0, -1, 0, 0]],
         [[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0],
          [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]]),
    9: ([[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0, 0, 0, 0, 0],
         [1, -10, 0, 10, -1], [0, 1, 0, -1, 0]],
        [[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0, 0, 0, 0, 0],
         [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]]),
    3: (None, [[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, 2, 0, -2, 0],
               [0, 1, 0, -1, 0], [0, 0, 0, 0, 0]]),
    10: (None, [[0, 0, 0, 0, 0], [0, 1, -3, 1, 0], [0, 0, 0, 0, 0],
                [0, -1, 3, -1, 0], [0, 0, 0, 0, 0]]),
    0: (None, [[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6],
               [-8, 42, 152, 42, -8], [-6, 6, 42, 6, -6],
               [-2, -6, -8, -6, -2]]),
}
for _src, _dst in ((1, 8), (16, 2), (3, 24), (10, 17)):   # transposes
    _SMOOTH_W[_dst] = tuple(None if w is None else np.array(w).T.tolist()
                            for w in _SMOOTH_W[_src])


def _smoothing_latch(frame):
    """smoothing_ok: → (coef_bits, prev coef_bits) of coefficients 0-9
    per component when block smoothing runs, else None."""
    if not frame.progressive:
        return None
    for c in range(len(frame.ids)):
        q = frame.qt[c]
        if q is None or (q[[0] + _SMOOTH_POS] == 0).any():
            return None
        if frame.coef_bits[c, 0] < 0:
            return None
    cur = frame.coef_bits[:, :10]
    if not (cur[:, 1:] != 0).any():
        return None
    prev = frame.prev_bits[:, :10].copy() if frame.scans > 1 \
        else np.full_like(cur, -1)
    return cur, prev


def _smooth(frame, c, blocks, bits):
    """decompress_smooth_data for component c: (bh, bw, 64) coefficients
    → the estimates filled in where a coefficient is zero and not known
    to be exact."""
    v, vmax = frame.vs[c], frame.vmax
    hib = -(-frame.dh[c] // 8)                  # height in blocks
    wib = -(-frame.dw[c] // 8)
    total = frame.mcuy                         # iMCU rows
    last_rows = hib % v or v
    # per block row g: its iMCU row's block_rows, and the rows whose DC
    # values libjpeg reads (its clamping decided on image_block_row)
    rows = np.arange(hib)
    imcu, br = rows // v, rows % v
    block_rows = np.where(imcu == total - 1, last_rows, v)
    ibr = imcu * block_rows + br
    ibrs = block_rows * total
    up1 = np.where(ibr > 0, rows - 1, rows)
    up2 = np.where(ibr > 1, rows - 2, up1)
    dn1 = np.where(ibr < ibrs - 1, rows + 1, rows)
    dn2 = np.where(ibr < ibrs - 2, rows + 2, dn1)
    vert = np.stack([up2, up1, rows, dn1, dn2])          # (5, hib)
    cols = np.arange(wib)
    horiz = np.stack([np.clip(cols + d, 0, wib - 1) for d in (-2, -1, 0,
                                                             1, 2)])
    dcs = blocks[..., 0].astype(np.int64)
    # (hib, wib, 5, 5) DC neighbourhoods
    nb = dcs[vert.T[:, None, :, None], horiz.T[None, :, None, :]]
    kept = blocks[:hib, :wib].astype(np.int64)
    cur, prev = bits
    out = _estimates(kept, nb, frame.qt[c], cur[c])
    if frame.ran_out is not None:
        # iMCU rows past the one where the data ran out take the
        # progression status from before the last scan
        late = imcu > frame.ran_out
        out[late] = _estimates(kept, nb, frame.qt[c], prev[c])[late]
    return out


def _estimates(kept, nb, q, coef_bits):
    """decompress_smooth_data's estimates for one set of coef_bits:
    kept (hib, wib, 64) coefficients, nb their (hib, wib, 5, 5) DC
    neighbourhoods."""
    out = kept.copy()
    change = (coef_bits[1:10] == -1).all()
    for zz, pos in enumerate(_SMOOTH_POS + [0], start=1):
        w = _SMOOTH_W[pos][1 if change else 0]
        if pos == 0:
            if not change:
                continue
            num = q[0] * np.einsum("hwij,ij->hw", nb, np.array(w))
            mag = ((q[0] << 7) + np.abs(num)) // (q[0] << 8)
            out[..., 0] = np.where(num >= 0, mag, -mag)
            continue
        al = coef_bits[zz]
        if al == 0 or w is None:
            continue
        num = q[0] * np.einsum("hwij,ij->hw", nb, np.array(w))
        qk = q[pos]
        mag = ((qk << 7) + np.abs(num)) // (qk << 8)
        if al > 0:
            mag = np.minimum(mag, (1 << al) - 1)
        est = np.where(num >= 0, mag, -mag)
        out[..., pos] = np.where(out[..., pos] == 0, est, out[..., pos])
    return out


def _component(frame: _Frame, c: int, bits) -> np.ndarray:
    """IDCT of component c → its samples, (dh, dw) uint8."""
    lo, hi = frame.base[c], frame.base[c + 1]
    bh, bw = frame.bh[c], frame.bw[c]
    coefs = frame.coefs[lo:hi]
    if bits is not None:
        coefs = _smooth(frame, c, coefs.reshape(bh, bw, 64), bits)
        bh, bw = coefs.shape[:2]
        coefs = coefs.reshape(-1, 64)
    blocks = idct_islow(coefs, frame.qt[c])
    plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3) \
        .reshape(bh * 8, bw * 8)
    return plane[:frame.dh[c], :frame.dw[c]]


def _fancy_h(x: np.ndarray, bias_even: int, bias_odd: int,
             shift: int) -> np.ndarray:
    """Horizontal triangle filter: each input column becomes two output
    columns, (3·x + left + bias) >> shift and (3·x + right + bias) >>
    shift, edges repeated."""
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + bias_even) >> shift
    out[:, 1::2] = (3 * x + right + bias_odd) >> shift
    return out


def _colsums(x: np.ndarray) -> np.ndarray:
    """h2v2/h1v2 vertical step: each input row becomes two rows, 3·x plus
    the row above, then 3·x plus the row below (edges repeated)."""
    up = np.concatenate([x[:1], x[:-1]], axis=0)
    down = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0], x.shape[1]), np.int32)
    out[0::2], out[1::2] = 3 * x + up, 3 * x + down
    return out


def _upsample(plane: np.ndarray, fh: int, fv: int, h: int, w: int):
    """jdsample.c's method for an (fh, fv) expansion → (h, w)."""
    x = plane.astype(np.int32)
    wide = plane.shape[1] > 2
    if (fh, fv) == (1, 1):
        out = x
    elif (fh, fv) == (2, 1) and wide:
        out = _fancy_h(x, 1, 2, 2)
    elif (fh, fv) == (1, 2):
        cs = _colsums(x)
        cs[0::2] += 1
        cs[1::2] += 2
        out = cs >> 2
    elif (fh, fv) == (2, 2) and wide:
        out = _fancy_h(_colsums(x), 8, 7, 4)
    else:
        out = np.repeat(np.repeat(x, fv, axis=0), fh, axis=1)
    return out[:h, :w].astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _ycc_tables():
    """jdcolor.c's tables, and its range limit for y + 256 in [0, 768)."""
    x = np.arange(256, dtype=np.int32) - 128
    fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731
    half = 1 << 15
    limit = np.clip(np.arange(768) - 256, 0, 255).astype(np.uint8)
    return ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half, limit)


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    cr_r, cb_b, cr_g, cb_g, limit = _ycc_tables()
    y = y.astype(np.int32) + 256
    out = np.empty(y.shape + (3,), np.uint8)
    out[..., 0] = limit[y + cr_r[cr]]
    out[..., 1] = limit[y + ((cb_g[cb] + cr_g[cr]) >> 16)]
    out[..., 2] = limit[y + cb_b[cb]]
    return out


def rgb_to_grey(rgb) -> np.ndarray:
    """jdcolor.c rgb_gray_convert: libjpeg's Y of an RGB file."""
    fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    return ((fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b
             + (1 << 15)) >> 16).astype(np.uint8)


def _cmyk_to_rgb(cmyk) -> np.ndarray:
    """OpenCV's icvCvt_CMYK2BGR_8u_C4C3R, in RGB order: libjpeg's CMYK
    output is Adobe's inverted CMYK, so each of C, M, Y becomes
    k - ((255 - v)·k >> 8)."""
    k = cmyk[..., 3:].astype(np.int32)
    v = cmyk[..., :3].astype(np.int32)
    return (k - (((255 - v) * k) >> 8)).astype(np.uint8)


# OpenCV's BGR2Gray weights in 1/16384 (color.hpp), which imread applies
CV_GREY_B, CV_GREY_G, CV_GREY_R = 1868, 9617, 4899


def cv_grey(rgb) -> np.ndarray:
    """OpenCV's 8-bit BGR2Gray of RGB samples (imread's grey of a CMYK
    JPEG, of libtiff's RGBA)."""
    r, g, b = (rgb[..., i].astype(np.int32) for i in range(3))
    return ((b * CV_GREY_B + g * CV_GREY_G + r * CV_GREY_R + 8192)
            >> 14).astype(np.uint8)


def _ycck_to_cmyk(y, cb, cr, k) -> np.ndarray:
    """jdcolor.c ycck_cmyk_convert: YCbCr → RGB inverted, K kept."""
    rgb = ycc_to_rgb(y, cb, cr)
    return np.concatenate([255 - rgb, k[..., None]], axis=-1)


def _planes(frame, need, bits) -> list:
    out = []
    for c in need:
        if frame.lossless:
            s = frame.samples[c]
            out.append(s.astype(np.uint8) if frame.prec <= 8 else s)
            continue
        fh, fv = frame.hmax // frame.hs[c], frame.vmax // frame.vs[c]
        if frame.hmax % frame.hs[c] or frame.vmax % frame.vs[c]:
            unsupported(frame.path, "JPEG with fractional sampling ratios")
        out.append(_upsample(_component(frame, c, bits), fh, fv, frame.h,
                             frame.w))
    return out


def decode_jpeg(blob: bytes, path, mode: str = "unchanged",
                tables: bytes = b"", colour: str | None = None
                ) -> np.ndarray:
    """A JPEG stream → samples as `cv2.imread` gives them (see
    `read_jpeg`). `tables`: an abbreviated table stream read first (a
    TIFF's JPEGTables); `colour`: the colour space when the caller knows
    it (libtiff's JPEG codec sets it from the TIFF's photometric)."""
    if mode not in ("unchanged", "color", "grey"):
        raise ValueError(f"unknown read mode {mode!r}")
    frame, orientation, space = _parse(blob, path, tables)
    frame.path = path
    space = colour or space
    n = len(frame.ids)
    if frame.lossless:
        if frame.prec > 8:
            unreadable(path, f"{frame.prec}-bit lossless JPEG")
        # libjpeg-turbo converts no colour space in lossless mode; the
        # one cv2 asks for: CMYK for 4 components, else grey or RGB
        out = "cmyk" if n == 4 else {"grey": "grey", "color": "rgb"}.get(
            mode, "grey" if n == 1 else "rgb")
        if out != space:
            unreadable(path, f"lossless JPEG in {space} read as {mode}")
    bits = _smoothing_latch(frame)
    if space == "grey" or (mode == "grey" and space == "ycc"):
        y, = _planes(frame, [0], bits)
        img = np.repeat(y[..., None], 3, -1) if (
            mode == "color" and n == 1) else y
    else:
        planes = _planes(frame, range(n), bits)
        if space == "ycc":
            img = ycc_to_rgb(*planes)
        elif space == "rgb":
            img = np.stack(planes, axis=-1)
        else:
            cmyk = (_ycck_to_cmyk(*planes) if space == "ycck"
                    else np.stack(planes, axis=-1))
            img = _cmyk_to_rgb(cmyk)
        if mode == "grey":
            img = (rgb_to_grey(img) if space == "rgb"
                   else cv_grey(img))
    return img if mode == "unchanged" else exif.orient(img, orientation)


def read_jpeg(path, mode: str = "unchanged") -> np.ndarray:
    """uint8 (H, W) for grey files, (H, W, 3) RGB for colour ones, as
    `cv2.imread(IMREAD_UNCHANGED)`; mode "color" / "grey": IMREAD_COLOR /
    IMREAD_GRAYSCALE, EXIF orientation applied."""
    return decode_jpeg(Path(path).read_bytes(), path, mode)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def quality_table(base: np.ndarray) -> np.ndarray:
    """jpeg_quality_scaling at QUALITY (≥ 50: 200 − 2·quality percent) and
    jpeg_add_quant_table's rounding and baseline clamp."""
    return np.clip((base * (200 - 2 * QUALITY) + 50) // 100, 1, 255)


def _reciprocals(qtable: np.ndarray):
    """libjpeg-turbo's compute_reciprocal for divisor = 8·q (16-bit
    DCTELEM): → (factor, correction, shift) per coefficient."""
    fq, corr, shift = [], [], []
    for q in qtable.tolist():
        d = q << 3
        r = 16 + d.bit_length() - 1
        f, rem = divmod(1 << r, d)
        c = d // 2
        if rem == 0:
            f >>= 1
            r -= 1
        elif rem <= d // 2:
            c += 1
        else:
            f += 1
        fq.append(f); corr.append(c); shift.append(r)
    return (np.array(fq, np.int64), np.array(corr, np.int64),
            np.array(shift, np.int64))


def quantize(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """(n, 64) DCT outputs → quantized coefficients, as jsimd_quantize."""
    fq, corr, shift = _reciprocals(qtable)
    mag = ((np.abs(coefs) + corr) * fq) >> shift
    return np.where(coefs < 0, -mag, mag).astype(np.int16)


def rgb_to_ycc(rgb: np.ndarray):
    """jccolor.c's rgb_ycc_convert: → Y, Cb, Cr (uint8 planes)."""
    fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731
    half, off = 1 << 15, 128 << 16
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    y = (fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + off + half
          - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + off + half
          - 1) >> 16
    return y.astype(np.uint8), cb.astype(np.uint8), cr.astype(np.uint8)


def _edge_pad(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    return np.pad(plane, ((0, rows - plane.shape[0]),
                          (0, cols - plane.shape[1])), mode="edge")


def _h2v2_downsample(plane: np.ndarray, out_cols: int) -> np.ndarray:
    """jcsample.c h2v2_downsample after libjpeg's edge expansion: the
    input padded to an even number of rows and 2·out_cols columns, then
    (sum of 2x2 + bias) >> 2 with bias 1, 2, 1, 2 along a row."""
    h = plane.shape[0] + plane.shape[0] % 2
    x = _edge_pad(plane, h, 2 * out_cols).astype(np.int32)
    s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
    bias = np.tile(np.array([1, 2], np.int32), out_cols)[:out_cols]
    return ((s + bias) >> 2).astype(np.uint8)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8·bh, 8·bw) → (bh, bw, 8, 8)."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _quantized_blocks(plane, qtable):
    b = _blocks(plane)
    bh, bw = b.shape[:2]
    d = fdct_islow(b.reshape(-1, 8, 8).astype(np.int64) - 128)
    return quantize(d.reshape(-1, 64), qtable).reshape(bh, bw, 64)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _code_table(bits: bytes, vals: bytes):
    """jpeg_make_c_derived_tbl: canonical codes → (ehufco, ehufsi)."""
    co, si = np.zeros(256, np.uint16), np.zeros(256, np.uint8)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            co[vals[k]], si[vals[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return co, si


def encode_jpeg(img: np.ndarray) -> bytes:
    """uint8 (H, W) grey or (H, W, 3) RGB → JPEG bytes (cv2's defaults)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"JPEG input must be uint8 (H, W) or (H, W, 3), "
                         f"not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    qt = [quality_table(STD_LUMA_Q)]
    if img.ndim == 2:
        comps = [(1, 1, 1, 0)]                   # id, h, v, table
        nby, nbx = -(-h // 8), -(-w // 8)
        yb = _quantized_blocks(_edge_pad(img, 8 * nby, 8 * nbx), qt[0])
        order = yb.reshape(-1, 64)
        block_comp = np.zeros(1, np.int32)
    else:
        qt.append(quality_table(STD_CHROMA_Q))
        comps = [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
        y, cb, cr = rgb_to_ycc(img)
        mcuy, mcux = -(-h // 16), -(-w // 16)
        nby, nbx = -(-h // 8), -(-w // 8)
        yq = _quantized_blocks(_edge_pad(y, 8 * nby, 8 * nbx), qt[0])
        # dummy blocks fill the last MCUs: AC zero, DC of the block before
        full = np.zeros((2 * mcuy, 2 * mcux, 64), np.int16)
        full[:nby, :nbx] = yq
        if nbx % 2:
            full[:nby, nbx, 0] = full[:nby, nbx - 1, 0]
        if nby % 2:
            full[nby, :, 0] = full[nby - 1, 1::2, 0].repeat(2)
        chroma = []
        for plane in (cb, cr):
            d = _h2v2_downsample(plane, 8 * mcux)
            chroma.append(_quantized_blocks(_edge_pad(d, 8 * mcuy, 8 * mcux),
                                            qt[1]))
        ymcu = full.reshape(mcuy, 2, mcux, 2, 64).transpose(0, 2, 1, 3, 4) \
            .reshape(mcuy, mcux, 4, 64)
        order = np.concatenate([ymcu, chroma[0][:, :, None],
                                chroma[1][:, :, None]], axis=2) \
            .reshape(-1, 64)
        block_comp = np.array([0, 0, 0, 0, 1, 2], np.int32)
    n_tables = len(qt)
    codes = [_code_table(*STD_HUFFMAN[(cls, t)]) for t in range(n_tables)
             for cls in (0, 1)]
    ehufco = np.stack([c for c, _ in codes])
    ehufsi = np.stack([s for _, s in codes])
    comp_dc = np.array([2 * c[3] for c in comps], np.int32)
    comp_ac = comp_dc + 1
    data = native.jpeg_encode_scan(np.ascontiguousarray(order, np.int16),
                                   block_comp, comp_dc, comp_ac, ehufco,
                                   ehufsi)
    head = [b"\xff\xd8",
            _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, q in enumerate(qt):
        head.append(_segment(0xDB, bytes([t]) + bytes(
            q[NATURAL].astype(np.uint8))))
    head.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, len(comps))
                         + b"".join(bytes([cid, (ch << 4) | cv, tq])
                                    for cid, ch, cv, tq in comps)))
    for t in range(n_tables):
        for cls in (0, 1):
            bits, vals = STD_HUFFMAN[(cls, t)]
            head.append(_segment(0xC4, bytes([(cls << 4) | t]) + bits + vals))
    head.append(_segment(0xDA, bytes([len(comps)]) + b"".join(
        bytes([cid, (tq << 4) | tq]) for cid, _, _, tq in comps)
        + b"\x00\x3f\x00"))
    return b"".join(head) + data + b"\xff\xd9"


def write_jpeg(path, img: np.ndarray) -> None:
    Path(path).write_bytes(encode_jpeg(img))
