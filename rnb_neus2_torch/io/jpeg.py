"""Baseline JPEG decode and encode, equal to what libjpeg-turbo gives cv2:
no `cv2` or `PIL`, which the card's host does not have.

Decode (`read_jpeg`): sequential Huffman scans of 8-bit grey or
3-component YCbCr, interleaved or not, any integral sampling (4:4:4,
4:2:2, 4:2:0, 4:4:0, 4:1:1), restart intervals and any (optimized)
Huffman tables. Huffman decoding is the C helper of `native/codecs.cc`;
the rest is numpy, following libjpeg-turbo step by step so that the
samples equal cv2's bit for bit:

- dequantization and the integer "islow" inverse DCT (jidctint.c): each
  of its two passes is an integer linear map of the 8 inputs followed by
  one rounding shift, so it runs as an exact float64 product with the
  8x8 integer matrix of the pass, then the shift and the range limit;
- fancy upsampling (jdsample.c): h2v1 and h2v2 triangle filters with
  their alternating rounding bias, h1v2, and replication for other
  integral ratios (4:1:1) and components at most 2 samples wide; edge
  samples repeat, as libjpeg's context rows do;
- YCbCr → RGB with jdcolor.c's 16-bit fixed-point tables.

`IMREAD_GRAYSCALE` ("grey") of a colour file is libjpeg's grey output:
the Y component, with no colour conversion; `IMREAD_COLOR` ("color") and
"grey" apply the EXIF orientation, `IMREAD_UNCHANGED` does not.
Progressive, lossless, hierarchical and arithmetic-coded files, other
precisions than 8 bits, CMYK and RGB (Adobe transform 0) files raise
ValueError naming the file and the feature.

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

SIGNATURE = b"\xff\xd8\xff"
QUALITY = 95                   # cv2's IMWRITE_JPEG_QUALITY default
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# SOFn markers that are not read, by what they code
REFUSED_SOF = {0xC2: "progressive JPEG", 0xC3: "lossless JPEG",
               0xC5: "hierarchical JPEG", 0xC6: "hierarchical JPEG",
               0xC7: "hierarchical JPEG", 0xC9: "arithmetic-coded JPEG",
               0xCA: "arithmetic-coded JPEG", 0xCB: "arithmetic-coded JPEG",
               0xCD: "arithmetic-coded JPEG", 0xCE: "arithmetic-coded JPEG",
               0xCF: "arithmetic-coded JPEG"}
SCAN_ERRORS = {-1: "bad Huffman table", -2: "bad Huffman code",
               -3: "missing restart marker", -4: "data ends inside the scan"}

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


def _refuse(path, what: str):
    raise ValueError(f"{path}: {what} is not supported")


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
    def __init__(self, seg: bytes, path):
        prec, self.h, self.w, nc = struct.unpack_from(">BHHB", seg)
        if prec != 8:
            _refuse(path, f"{prec}-bit JPEG")
        if nc == 4:
            _refuse(path, "CMYK (4-component) JPEG")
        if nc not in (1, 3):
            _refuse(path, f"{nc}-component JPEG")
        if self.h == 0 or self.w == 0:
            raise ValueError(f"{path}: JPEG with an empty frame")
        if len(seg) != 6 + 3 * nc:
            raise ValueError(f"{path}: JPEG frame header of the wrong length")
        self.ids, self.hs, self.vs, self.tq = [], [], [], []
        for i in range(nc):
            cid, hv, tq = struct.unpack_from(">BBB", seg, 6 + 3 * i)
            if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                raise ValueError(f"{path}: JPEG sampling factors {hv:#x} "
                                 f"outside 1-4")
            self.ids.append(cid)
            self.hs.append(hv >> 4)
            self.vs.append(hv & 15)
            self.tq.append(tq)
        self.hmax, self.vmax = max(self.hs), max(self.vs)
        self.mcux = -(-self.w // (8 * self.hmax))
        self.mcuy = -(-self.h // (8 * self.vmax))
        # per component: padded block grid, sample size, rows in `coefs`
        self.bw = [self.mcux * h for h in self.hs]
        self.bh = [self.mcuy * v for v in self.vs]
        self.dw = [-(-self.w * h // self.hmax) for h in self.hs]
        self.dh = [-(-self.h * v // self.vmax) for v in self.vs]
        sizes = [bw * bh for bw, bh in zip(self.bw, self.bh)]
        self.base = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
        self.coefs = np.zeros((int(self.base[-1]), 64), np.int16)
        self.qt = [None] * nc


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


def _decode_scan(blob, pos, seg, frame, huff, qtables, restart, path):
    ns = seg[0] if seg else 0
    if not 1 <= ns <= 4 or len(seg) != 4 + 2 * ns:
        raise ValueError(f"{path}: JPEG scan header with {ns} components "
                         f"in {len(seg)} bytes")
    comps, dc, ac = [], [], []
    for i in range(ns):
        cid, tdta = seg[1 + 2 * i], seg[2 + 2 * i]
        if cid not in frame.ids:
            raise ValueError(f"{path}: JPEG scan names unknown component "
                             f"{cid}")
        if frame.ids.index(cid) in comps:
            raise ValueError(f"{path}: JPEG scan names component {cid} "
                             f"twice")
        comps.append(frame.ids.index(cid))
        dc.append((0, tdta >> 4))
        ac.append((1, tdta & 15))
    ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
    if (ss, se, ahal) != (0, 63, 0):
        _refuse(path, "JPEG scan with spectral selection or approximation")
    keys = sorted(set(dc + ac))
    for k in keys:
        if k not in huff:
            raise ValueError(f"{path}: JPEG scan uses undefined Huffman "
                             f"table {k}")
    for c in comps:
        if frame.qt[c] is None:          # latched at the first scan
            if frame.tq[c] not in qtables:
                raise ValueError(f"{path}: JPEG component uses undefined "
                                 f"quantization table {frame.tq[c]}")
            frame.qt[c] = qtables[frame.tq[c]]
    bits = np.frombuffer(b"".join(huff[k][0] for k in keys), np.uint8)
    vals = np.frombuffer(b"".join(huff[k][1].ljust(256, b"\0")
                                  for k in keys), np.uint8)
    block_comp, rows = _scan_layout(frame, comps)
    if block_comp.size > 10:             # libjpeg's D_MAX_BLOCKS_IN_MCU
        raise ValueError(f"{path}: JPEG MCU of {block_comp.size} blocks")
    comp_dc = np.array([keys.index(k) for k in dc], np.int32)
    comp_ac = np.array([keys.index(k) for k in ac], np.int32)
    rows = np.ascontiguousarray(rows, np.int64)
    end = native.jpeg_decode_scan(blob, pos, block_comp, rows, comp_dc,
                                  comp_ac, bits, vals, restart, frame.coefs)
    if end < 0:
        raise ValueError(f"{path}: corrupt JPEG data "
                         f"({SCAN_ERRORS.get(end, end)})")
    return end


def _parse(path):
    blob = Path(path).read_bytes()
    if not blob.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a JPEG file")
    frame, huff, qtables = None, {}, {}
    restart, orientation, jfif, adobe = 0, 1, False, None
    pos, scans = 2, 0
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
        if pos + 4 > len(blob):
            raise ValueError(f"{path}: JPEG ends inside a marker")
        length, = struct.unpack_from(">H", blob, pos + 2)
        if length < 2 or pos + 2 + length > len(blob):
            raise ValueError(f"{path}: JPEG segment {m:#x} of length "
                             f"{length} past the end of the file")
        seg = blob[pos + 4:pos + 2 + length]
        pos += 2 + length
        if m in REFUSED_SOF:
            _refuse(path, REFUSED_SOF[m])
        if m in (0xC0, 0xC1):
            frame = _Frame(seg, path)
        elif m == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = seg[i + 1:i + 17]
                n = sum(bits)
                if tc > 1 or th > 3:
                    raise ValueError(f"{path}: JPEG Huffman table index "
                                     f"{seg[i]:#x}")
                if len(bits) < 16 or n > 256 or i + 17 + n > len(seg):
                    raise ValueError(f"{path}: bad JPEG Huffman table: "
                                     f"{n} codes in {len(seg) - i} bytes")
                huff[(tc, th)] = (bits, seg[i + 17:i + 17 + n])
                i += 17 + n
        elif m == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq > 1 or tq > 3 or i + 1 + 64 * (pq + 1) > len(seg):
                    raise ValueError(f"{path}: bad JPEG quantization table")
                fmt = ">64H" if pq else "64B"
                q = np.zeros(64, np.int64)
                q[NATURAL] = struct.unpack_from(fmt, seg, i + 1)
                qtables[tq] = q
                i += 1 + 64 * (2 if pq else 1)
        elif m == 0xDD:
            if len(seg) != 2:
                raise ValueError(f"{path}: JPEG restart interval segment "
                                 f"of {len(seg)} bytes")
            restart, = struct.unpack_from(">H", seg)
        elif m == 0xE0 and seg.startswith(b"JFIF\0"):
            jfif = True
        elif m == 0xE1 and orientation == 1 and seg.startswith(b"Exif\0\0"):
            orientation = exif.orientation(seg[6:])
        elif m == 0xEE and seg.startswith(b"Adobe") and len(seg) >= 12:
            adobe = seg[11]
        elif m == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: JPEG scan before the frame header")
            if scans == 0 and len(frame.ids) == 3:
                _check_colour_space(frame, jfif, adobe, path)
            pos = _decode_scan(blob, pos, seg, frame, huff, qtables,
                               restart, path)
            scans += 1
    if frame is None or scans == 0:
        raise ValueError(f"{path}: JPEG without a frame or a scan")
    if any(q is None for q in frame.qt):
        raise ValueError(f"{path}: JPEG component that no scan codes")
    return frame, orientation


def _check_colour_space(frame, jfif, adobe, path):
    """libjpeg's default_decompress_parms for 3 components: JFIF means
    YCbCr; else an Adobe transform 0 (or, with no marker, the ids 'R',
    'G', 'B') means RGB, which is not read."""
    if jfif:
        return
    if adobe == 0 or (adobe is None and frame.ids == [82, 71, 66]):
        _refuse(path, "RGB (Adobe transform 0) JPEG")


def _component(frame: _Frame, c: int) -> np.ndarray:
    """IDCT of component c → its samples, (dh, dw) uint8."""
    lo, hi = frame.base[c], frame.base[c + 1]
    blocks = idct_islow(frame.coefs[lo:hi], frame.qt[c])
    bh, bw = frame.bh[c], frame.bw[c]
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


def read_jpeg(path, mode: str = "unchanged") -> np.ndarray:
    """uint8 (H, W) for grey files, (H, W, 3) RGB for colour ones, as
    `cv2.imread(IMREAD_UNCHANGED)`; mode "color" / "grey": IMREAD_COLOR /
    IMREAD_GRAYSCALE, EXIF orientation applied."""
    if mode not in ("unchanged", "color", "grey"):
        raise ValueError(f"unknown read mode {mode!r}")
    frame, orientation = _parse(path)
    need = [0] if (mode == "grey" or len(frame.ids) == 1) else [0, 1, 2]
    planes = []
    for c in need:
        fh, fv = frame.hmax // frame.hs[c], frame.vmax // frame.vs[c]
        if frame.hmax % frame.hs[c] or frame.vmax % frame.vs[c]:
            _refuse(path, "JPEG with fractional sampling ratios")
        planes.append(_upsample(_component(frame, c), fh, fv, frame.h,
                                frame.w))
    if len(planes) == 3:
        img = ycc_to_rgb(*planes)
    elif mode == "color":
        img = np.repeat(planes[0][..., None], 3, axis=-1)
    else:
        img = planes[0]
    return img if mode == "unchanged" else exif.orient(img, orientation)


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
