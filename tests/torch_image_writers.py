"""Writers of the image kinds that neither cv2 nor PIL writes, for the
image-variant tests and their fixtures (`torch_fixtures/formats/
make_fixtures.py`): arithmetic-coded JPEG (ITU T.81 Annex D, F.1.4, G.1.3;
the coding procedures of libjpeg's jcarith.c), lossless JPEG (Annex H),
tiled or planar TIFF (TIFF 6.0 sections 15 and 8), BMP of every header
kind, bit count and compression (RLE8/RLE4 by the Windows rules), Sun
rasters, Radiance scanlines (flat and new-style RLE), GIF (LZW at any
code size, interlacing, local tables, transparency, several frames) and
WebP's ALPH chunks and RIFF containers; `webp_encode` reaches libwebp's
encoder options through PIL's own libwebp. cv2's decode of what they
write is the reference, so the port's decoder is never held against its
own encoder. numpy only, but for `webp_encode`.
"""

import struct

import numpy as np

NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# T.81 Table D.2 (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS) with
# libjpeg's fixed state 113
QE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0),
]


class ArithEncoder:
    """The QM encoder of T.81 D.1 as jcarith.c runs it (arith_encode,
    finish_pass)."""

    def __init__(self):
        self.out = bytearray()
        self.c, self.a, self.ct = 0, 0x10000, 11
        self.sc = self.zc = 0
        self.buffer = -1

    def _emit(self, b):
        self.out.append(b)

    def _zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, stats, i, val):
        sv = stats[i]
        qe, nl, nm, sw = QE[sv & 0x7F]
        nl |= sw << 7
        self.a -= qe
        if val != sv >> 7:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            stats[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    self._flush_stack()
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def _flush_stack(self):
        if self.buffer == 0:
            self.zc += 1
        elif self.buffer >= 0:
            self._zeros()
            self._emit(self.buffer)
        if self.sc:
            self._zeros()
            while self.sc:
                self._emit(0xFF)
                self._emit(0)
                self.sc -= 1

    def finish(self) -> bytes:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            self._flush_stack()
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)
        return bytes(self.out)


def _segment(marker, body):
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _magnitude(enc, stats, st, v, x1_stats, x1, ac):
    """F.1.4.1-3: category and bits of |v| - 1 = v from bin st on."""
    m = 0
    if v:
        enc.encode(stats, st, 1)
        m = 1
        v2 = v
        if ac:
            v2 >>= 1
            if v2:
                enc.encode(stats, st, 1)
                m <<= 1
                stats, st = x1_stats, x1
                while True:
                    v2 >>= 1
                    if not v2:
                        break
                    enc.encode(stats, st, 1)
                    m <<= 1
                    st += 1
        else:
            stats, st = x1_stats, x1
            while True:
                v2 >>= 1
                if not v2:
                    break
                enc.encode(stats, st, 1)
                m <<= 1
                st += 1
    enc.encode(stats, st, 0)
    st += 14
    m >>= 1
    while m:
        enc.encode(stats, st, 1 if m & v else 0)
        m >>= 1
    return m


class ArithScan:
    """Statistics and predictions of one scan (jcarith.c start_pass)."""

    def __init__(self, n_comps, L=0, U=1, K=5):
        self.dc = [bytearray(64) for _ in range(4)]
        self.ac = [bytearray(256) for _ in range(4)]
        self.fixed = bytearray([113])
        self.last_dc = [0] * n_comps
        self.ctx = [0] * n_comps
        self.L, self.U, self.K = L, U, K

    def dc_diff(self, enc, c, t, value):
        stats = self.dc[t]
        st = self.ctx[c]
        v = value - self.last_dc[c]
        if v == 0:
            enc.encode(stats, st, 0)
            self.ctx[c] = 0
            return
        self.last_dc[c] = value
        enc.encode(stats, st, 1)
        if v > 0:
            enc.encode(stats, st + 1, 0)
            st += 2
            self.ctx[c] = 4
        else:
            v = -v
            enc.encode(stats, st + 1, 1)
            st += 3
            self.ctx[c] = 8
        v -= 1
        # the category decides the next context
        m = 0
        if v:
            m = 1 << (v.bit_length() - 1) if v > 1 else 1
        if m < (1 << self.L) >> 1:
            self.ctx[c] = 0
        elif m > (1 << self.U) >> 1:
            self.ctx[c] += 8
        _magnitude(enc, stats, st, v, stats, 20, ac=False)

    def ac_band(self, enc, t, block, ss, se, al=0):
        """AC first (sequential: ss=1, se=63, al=0)."""
        stats = self.ac[t]

        def pt(k):
            v = int(block[NATURAL[k]])
            return -((-v) >> al) if v < 0 else v >> al
        ke = se
        while ke >= ss and pt(ke) == 0:
            ke -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            enc.encode(stats, st, 0)
            while pt(k) == 0:
                enc.encode(stats, st + 1, 0)
                st += 3
                k += 1
            v = pt(k)
            enc.encode(stats, st + 1, 1)
            enc.encode(self.fixed, 0, 0 if v > 0 else 1)
            st += 2
            _magnitude(enc, stats, st, abs(v) - 1, stats,
                       189 if k <= self.K else 217, ac=True)
            k += 1
        if k <= se:
            enc.encode(stats, 3 * (k - 1), 1)

    def ac_refine(self, enc, t, block, ss, se, ah, al):
        stats = self.ac[t]

        def mag(k, shift):
            return abs(int(block[NATURAL[k]])) >> shift
        ke = se
        while ke >= ss and mag(ke, al) == 0:
            ke -= 1
        kex = ke
        while kex >= ss and mag(kex, ah) == 0:
            kex -= 1
        k = ss
        while k <= ke:
            st = 3 * (k - 1)
            if k > kex:
                enc.encode(stats, st, 0)
            while True:
                v = mag(k, al)
                if v:
                    if v >> 1:
                        enc.encode(stats, st + 2, v & 1)
                    else:
                        enc.encode(stats, st + 1, 1)
                        enc.encode(self.fixed, 0,
                                   0 if block[NATURAL[k]] > 0 else 1)
                    break
                enc.encode(stats, st + 1, 0)
                st += 3
                k += 1
            k += 1
        if k <= se:
            enc.encode(stats, 3 * (k - 1), 1)


def _mcus(comp_blocks, hs, vs, comps, mcux, mcuy):
    """Blocks of an interleaved scan in MCU order: (component, block)."""
    for my in range(mcuy):
        for mx in range(mcux):
            for c in comps:
                for v in range(vs[c]):
                    for h in range(hs[c]):
                        yield c, comp_blocks[c][my * vs[c] + v,
                                                mx * hs[c] + h]


def arith_jpeg(comp_blocks, qtables, h, w, hs, vs, progressive=False,
               restart=0, dac=None, adobe=None, cut_after=None) -> bytes:
    """Coefficient blocks (per component (bh, bw, 64) int, natural order,
    padded to whole MCUs) → an SOF9 or SOF10 file. Progressive: the
    scan script of libjpeg's jpeg_simple_progression. `dac`: (L, U, K)
    for all tables; `cut_after`: stop after that many scans."""
    nc = len(comp_blocks)
    hmax, vmax = max(hs), max(vs)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    tq = [0] + [1] * (nc - 1) if len(qtables) > 1 else [0] * nc
    out = [b"\xff\xd8"]
    if adobe is not None:
        out.append(_segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                            + bytes([adobe])))
    for t, q in enumerate(qtables):
        out.append(_segment(0xDB, bytes([t]) + bytes(
            np.asarray(q)[NATURAL].astype(np.uint8))))
    ids = [1, 2, 3, 4][:nc]
    out.append(_segment(0xCA if progressive else 0xC9,
                        struct.pack(">BHHB", 8, h, w, nc) + b"".join(
                            bytes([ids[c], (hs[c] << 4) | vs[c], tq[c]])
                            for c in range(nc))))
    L, U, K = dac or (0, 1, 5)
    if dac:
        body = b"".join(bytes([t, (U << 4) | L]) for t in range(2)) + \
            b"".join(bytes([16 + t, K]) for t in range(2))
        out.append(_segment(0xCC, body))
    if restart:
        out.append(_segment(0xDD, struct.pack(">H", restart)))
    if progressive:
        script = [(list(range(nc)), 0, 0, 0, 1)]
        if nc == 3:
            script += [([0], 1, 5, 0, 2), ([2], 1, 63, 0, 1),
                       ([1], 1, 63, 0, 1), ([0], 6, 63, 0, 2),
                       ([0], 1, 63, 2, 1), (list(range(nc)), 0, 0, 1, 0),
                       ([2], 1, 63, 1, 0), ([1], 1, 63, 1, 0),
                       ([0], 1, 63, 1, 0)]
        else:
            script += [([c], 1, 5, 0, 2) for c in range(nc)] + \
                [([c], 6, 63, 0, 2) for c in range(nc)] + \
                [([c], 1, 63, 2, 1) for c in range(nc)] + \
                [(list(range(nc)), 0, 0, 1, 0)] + \
                [([c], 1, 63, 1, 0) for c in range(nc)]
    else:
        script = [(list(range(nc)), 0, 63, 0, 0)]
    for n_scan, (comps, ss, se, ah, al) in enumerate(script):
        if cut_after is not None and n_scan == cut_after:
            return b"".join(out)
        tables = [0 if c == 0 else min(1, len(qtables) - 1) for c in comps]
        sos = bytes([len(comps)]) + b"".join(
            bytes([ids[c], (tables[i] << 4) | tables[i]])
            for i, c in enumerate(comps)) + bytes([ss, se, (ah << 4) | al])
        out.append(_segment(0xDA, sos))
        if len(comps) == 1:
            c = comps[0]
            nby = -(-(-(-h * vs[c] // vmax)) // 8)
            nbx = -(-(-(-w * hs[c] // hmax)) // 8)
            units = [[(c, comp_blocks[c][y, x])] for y in range(nby)
                     for x in range(nbx)]
        else:
            blocks = list(_mcus(comp_blocks, hs, vs, comps, mcux, mcuy))
            per = sum(hs[c] * vs[c] for c in comps)
            units = [blocks[i:i + per] for i in range(0, len(blocks), per)]
        scan = ArithScan(nc, L, U, K)
        enc = ArithEncoder()
        data = []
        for i, unit in enumerate(units):
            if restart and i and i % restart == 0:
                data.append(enc.finish())
                data.append(bytes([0xFF, 0xD0 + (i // restart - 1) % 8]))
                scan = ArithScan(nc, L, U, K)
                enc = ArithEncoder()
            for c, blk in unit:
                t = tables[comps.index(c)]
                if not progressive:
                    scan.dc_diff(enc, c, t, int(blk[0]))
                    scan.ac_band(enc, t, blk, 1, 63)
                elif ss == 0 and ah == 0:
                    v = int(blk[0])
                    scan.dc_diff(enc, c, t, v >> al)
                elif ss == 0:
                    enc.encode(scan.fixed, 0, (int(blk[0]) >> al) & 1)
                elif ah == 0:
                    scan.ac_band(enc, t, blk, ss, se, al)
                else:
                    scan.ac_refine(enc, t, blk, ss, se, ah, al)
        data.append(enc.finish())
        out.append(b"".join(data))
    out.append(b"\xff\xd9")
    return b"".join(out)


# ---------------------------------------------------------------- lossless
# a DC-style table for the 17 difference categories 0-16
LOSSLESS_BITS = bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0])
LOSSLESS_VALS = bytes(range(17))


def _codes(bits, vals):
    code, k, table = 0, 0, {}
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return table


def lossless_jpeg(planes, precision, predictor, pt=0, restart_rows=0,
                  frame_marker=None, jfif=False, adobe=None) -> bytes:
    """(n, h, w) integer samples (< 2^precision) → an SOF3 file coded
    with predictor 1-7 and point transform pt (samples >> pt are
    coded), interleaved; restarts every `restart_rows` rows."""
    planes = np.asarray(planes, np.int64) >> pt
    n, h, w = planes.shape
    codes = _codes(LOSSLESS_BITS, LOSSLESS_VALS)
    bitbuf = []

    def put(code, length):
        bitbuf.append(format(code, f"0{length}b") if length else "")

    chunks = []

    def flush():
        bits = "".join(bitbuf)
        bits += "1" * (-len(bits) % 8)
        raw = bytearray()
        for i in range(0, len(bits), 8):
            b = int(bits[i:i + 8], 2)
            raw.append(b)
            if b == 0xFF:
                raw.append(0)
        bitbuf.clear()
        chunks.append(bytes(raw))

    n_rst = 0
    for y in range(h):
        first_row = y == 0 or (restart_rows and y % restart_rows == 0)
        if restart_rows and y and y % restart_rows == 0:
            flush()
            chunks.append(bytes([0xFF, 0xD0 + n_rst % 8]))
            n_rst += 1
        for x in range(w):
            for c in range(n):
                p = planes[c]
                if first_row:
                    px = p[y, x - 1] if x else 1 << (precision - pt - 1)
                elif x == 0:
                    px = p[y - 1, 0]
                else:
                    ra, rb, rc = p[y, x - 1], p[y - 1, x], p[y - 1, x - 1]
                    px = [None, ra, rb, rc, ra + rb - rc,
                          ra + ((rb - rc) >> 1), rb + ((ra - rc) >> 1),
                          (ra + rb) >> 1][predictor]
                d = int(p[y, x] - px) & 0xFFFF
                d = d - 0x10000 if d > 0x8000 else d
                if d == -0x8000 or d == 0x8000:
                    put(*codes[16])
                    continue
                s = abs(d).bit_length()
                put(*codes[s])
                if s:
                    put(d if d > 0 else d + (1 << s) - 1, s)
    flush()
    out = [b"\xff\xd8"]
    if jfif:
        out.append(_segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01"
                            b"\x00\x00"))
    if adobe is not None:
        out.append(_segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                            + bytes([adobe])))
    out.append(_segment(frame_marker or 0xC3,
                        struct.pack(">BHHB", precision, h, w, n) + b"".join(
                            bytes([c + 1, 0x11, 0]) for c in range(n))))
    out.append(_segment(0xC4, b"\x00" + LOSSLESS_BITS + LOSSLESS_VALS))
    if restart_rows:
        out.append(_segment(0xDD, struct.pack(">H", restart_rows * w)))
    out.append(_segment(0xDA, bytes([n]) + b"".join(
        bytes([c + 1, 0]) for c in range(n)) + bytes([predictor, 0, pt])))
    out += chunks
    out.append(b"\xff\xd9")
    return b"".join(out)


# -------------------------------------------------------------------- TIFF
TIFF_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i",
              11: "f", 12: "d", 16: "Q", 7: "B"}


def tiff_file(tags, chunks, order="<", big=False, tiled=False) -> bytes:
    """A one-image TIFF (BigTIFF when `big`) built field by field: `tags`
    {tag: (type, values)}; `chunks` the strips (or tiles) in order, whose
    offsets and byte counts (273/279, or 324/325) are filled in here."""
    off_tag, cnt_tag = (324, 325) if tiled else (273, 279)
    tags = dict(tags)
    otype = 16 if big else 4
    tags[off_tag] = (otype, [0] * len(chunks))
    tags[cnt_tag] = (otype, [len(c) for c in chunks])
    head = 16 if big else 8
    entry = 20 if big else 12
    inline = 8 if big else 4
    n = len(tags)
    ifd_size = (8 if big else 2) + entry * n + (8 if big else 4)
    data_at = head + ifd_size
    # chunks first, then out-of-line values
    offsets, blob = [], b""
    for c in chunks:
        offsets.append(data_at + len(blob))
        blob += c + b"\0" * (len(c) & 1)
    tags[off_tag] = (otype, offsets)
    extra_at = data_at + len(blob)
    entries, extra = [], b""
    for tag, (typ, vals) in sorted(tags.items()):
        if typ == 2:
            packed = vals if isinstance(vals, bytes) else vals.encode()
            count = len(packed)
        elif typ == 5:                   # numerator, denominator pairs
            packed = struct.pack(order + "I" * len(vals), *vals)
            count = len(vals) // 2
        else:
            packed = struct.pack(order + TIFF_TYPES[typ] * len(vals), *vals)
            count = len(vals)
        if len(packed) > inline:
            field = struct.pack(order + ("Q" if big else "I"),
                                extra_at + len(extra))
            extra += packed + b"\0" * (len(packed) & 1)
        else:
            field = packed.ljust(inline, b"\0")
        entries.append(struct.pack(order + ("HHQ" if big else "HHI"), tag,
                                   typ, count) + field)
    if big:
        header = (b"II" if order == "<" else b"MM") + struct.pack(
            order + "HHHQ", 43, 8, 0, head)
        ifd = struct.pack(order + "Q", n) + b"".join(entries) + bytes(8)
    else:
        header = (b"II*\0" if order == "<" else b"MM\0*") + struct.pack(
            order + "I", head)
        ifd = struct.pack(order + "H", n) + b"".join(entries) + bytes(4)
    return header + ifd + blob + extra


def pack_bits(samples, bits) -> bytes:
    """(rows, n) samples of `bits` < 8 bits → rows packed MSB first, each
    row padded to a byte."""
    out = b""
    for row in np.asarray(samples):
        s = "".join(format(int(v), f"0{bits}b") for v in row)
        s += "0" * (-len(s) % 8)
        out += bytes(int(s[i:i + 8], 2) for i in range(0, len(s), 8))
    return out


def tiles(img, tw, th):
    """(h, w, ...) → the tiles in row-major order, each (th, tw, ...) with
    its edge padded with zeros."""
    h, w = img.shape[:2]
    out = []
    for y in range(0, h, th):
        for x in range(0, w, tw):
            t = np.zeros((th, tw) + img.shape[2:], img.dtype)
            part = img[y:y + th, x:x + tw]
            t[:part.shape[0], :part.shape[1]] = part
            out.append(t)
    return out


# --------------------------------------------------------------------- BMP
def bmp_file(w, h, bpp, data, header=40, compression=0, palette=None,
             clrused=0, masks=None, top_down=False) -> bytes:
    """A BMP with `data` (the pixel bytes as stored) after a file header,
    an info header of `header` bytes (12 = OS/2 core; 40, 52, 56, 108,
    124 = INFO and its successors, which carry `masks` (R, G, B, A) from
    52 bytes on), and `palette` ((n, 3) RGB, stored BGR0, or BGR in an
    OS/2 file). BI_BITFIELDS masks of a 40-byte header follow it."""
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]
        if header == 12:
            pal = p.tobytes()
        else:
            pal = np.concatenate([p, np.zeros((len(p), 1), np.uint8)],
                                 1).tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bpp)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bpp, compression, len(data), 2835, 2835,
                           clrused, 0)
        if header >= 52:
            m = list(masks or (0, 0, 0, 0))
            info += struct.pack("<4I", *(m + [0] * 4)[:4])
        info = (info + b"BGRs" if header >= 108 else info)
        info = info[:header].ljust(header, b"\0")
        if header == 40 and masks is not None:
            pal = struct.pack("<3I", *masks[:3]) + pal
    off = 14 + len(info) + len(pal)
    return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + info
            + pal + data)


def bmp_rows(rows: np.ndarray, bits: int) -> bytes:
    """(h, n) samples of `bits` each, top row first → bottom-up rows packed
    MSB first and padded to 4 bytes."""
    out = []
    for row in np.asarray(rows)[::-1]:
        if bits >= 8:
            b = np.asarray(row).astype(f"<u{bits // 8}").tobytes() \
                if bits in (8, 16) else bytes(np.asarray(row, np.uint8))
        else:
            b = pack_bits(row[None], bits)
        out.append(b + b"\0" * (-len(b) % 4))
    return b"".join(out)


def bmp_rle(idx: np.ndarray, bits: int, delta_at=None) -> bytes:
    """Palette indices (h, w), top row first → RLE8 (bits 8) or RLE4 data,
    bottom row first: encoded runs of equal values, absolute runs of the
    rest (3 or more pixels, padded to a word), an end of line after each
    row and an end of bitmap; `delta_at` (row, col, dx, dy) skips pixels
    with a delta instead."""
    out = bytearray()
    rows = np.asarray(idx)[::-1]
    h, w = rows.shape
    y = 0
    while y < h:
        row, x = rows[y], 0
        while x < w:
            if delta_at is not None and (y, x) == delta_at[:2]:
                dx, dy = delta_at[2:]
                out += bytes([0, 2, dx, dy])
                x += dx
                if dy:
                    y += dy
                    row = rows[y]
                continue
            n = 1
            if bits == 8:
                while x + n < w and n < 255 and row[x + n] == row[x]:
                    n += 1
            else:
                while (x + n < w and n < 255
                       and row[x + n] == row[x + (n & 1)]):
                    n += 1
            if n >= 3 or w - x < 3:
                v = row[x] if bits == 8 else (row[x] << 4) | (
                    row[x + 1] if n > 1 else 0)
                out += bytes([n, int(v)])
                x += n
                continue
            k = min(w - x, 12)
            lit = [int(v) for v in row[x:x + k]]
            if bits == 8:
                body = bytes(lit) + b"\0" * (k & 1)
            else:
                body = pack_bits([lit], 4)
                body += b"\0" * (len(body) & 1)
            out += bytes([0, k]) + body
            x += k
        out += b"\0\0"
        y += 1
    return bytes(out[:-2]) + b"\0\1"


# ---------------------------------------------------------------- Sun raster
def sun_raster(w, h, depth, data, kind=1, cmap=b"") -> bytes:
    return struct.pack(">8I", 0x59A66A95, w, h, depth, len(data), kind,
                       1 if cmap else 0, len(cmap)) + cmap + data


# ----------------------------------------------------------------- Radiance
def hdr_file(rgbe: np.ndarray, rle=True, head=None) -> bytes:
    """(h, w, 4) RGBE bytes as a Radiance file: new-style RLE scanlines
    (runs of 4 or more as runs, the rest literal) or flat."""
    h, w = rgbe.shape[:2]
    out = bytearray(head if head is not None else
                    b"#?RADIANCE\n# a comment\nEXPOSURE=1.0\n"
                    b"FORMAT=32-bit_rle_rgbe\n\n-Y %d +X %d\n" % (h, w))
    if not rle:
        return bytes(out) + np.asarray(rgbe, np.uint8).tobytes()
    for y in range(h):
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            v = [int(t) for t in rgbe[y, :, c]]
            x = 0
            while x < w:
                n = 1
                while x + n < w and n < 127 and v[x + n] == v[x]:
                    n += 1
                if n >= 4:
                    out += bytes([128 + n, v[x]])
                    x += n
                    continue
                k = 1
                while x + k < w and k < 128 and not (
                        x + k + 3 < w and v[x + k] == v[x + k + 1]
                        == v[x + k + 2] == v[x + k + 3]):
                    k += 1
                out += bytes([k]) + bytes(v[x:x + k])
                x += k
    return bytes(out)


# ---------------------------------------------------------------------- GIF
def gif_lzw(indices, min_size: int, clear_every: int = 0) -> bytes:
    """GIF LZW (LSB-first codes, growing to 12 bits, a clear code first,
    again when the table is full or every `clear_every` codes, and an end
    code) of palette indices, in sub-blocks."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    acc = nbits = 0
    out = bytearray()

    def put(code, size):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8

    size = min_size + 1
    table = {(i,): i for i in range(clear)}
    nxt = end + 1
    put(clear, size)
    cur, emitted = (), 0
    for v in [int(t) for t in np.asarray(indices).reshape(-1)]:
        cand = cur + (v,)
        if cand in table:
            cur = cand
            continue
        put(table[cur], size)
        emitted += 1
        if nxt < 4096:
            table[cand] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        if nxt >= 4096 or (clear_every and emitted % clear_every == 0):
            put(clear, size)
            table = {(i,): i for i in range(clear)}
            nxt, size = end + 1, min_size + 1
        cur = (v,)
    if cur:
        put(table[cur], size)
        if nxt == 1 << size and size < 12 and emitted:
            size += 1
    put(end, size)
    if nbits:
        out.append(acc & 255)
    blocks = bytearray([min_size])
    for i in range(0, len(out), 255):
        blocks += bytes([len(out[i:i + 255])]) + out[i:i + 255]
    return bytes(blocks) + b"\0"


def _table_bits(n):
    return max(1, int(np.ceil(np.log2(max(n, 2))))) - 1


def gif_file(w, h, frames, global_table=None, background=0,
             version=b"89a") -> bytes:
    """A GIF of logical size (w, h); each frame a dict: `idx` (fh, fw)
    indices, `left`, `top`, `table` (a local colour table, (n, 3)),
    `interlace`, `transparent` (an index, in a Graphic Control Extension
    with `disposal`), `min_size` (the LZW minimum code size)."""
    out = bytearray(b"GIF" + version + struct.pack("<HH", w, h))
    if global_table is not None:
        g = np.asarray(global_table, np.uint8)
        bits = _table_bits(len(g))
        g = np.concatenate([g, np.zeros(((2 << bits) - len(g), 3),
                                        np.uint8)])
        out += bytes([0x80 | 0x70 | bits, background, 0]) + g.tobytes()
    else:
        out += bytes([0x70, background, 0])
    for f in frames:
        idx = np.asarray(f["idx"])
        fh, fw = idx.shape
        if f.get("transparent") is not None or f.get("disposal"):
            t = f.get("transparent")
            out += bytes([0x21, 0xF9, 4, (f.get("disposal", 0) << 2)
                          | (t is not None), 0, 0, t or 0, 0])
        flags = 0
        table = f.get("table")
        if table is not None:
            t = np.asarray(table, np.uint8)
            bits = _table_bits(len(t))
            flags |= 0x80 | bits
        if f.get("interlace"):
            flags |= 0x40
            order = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                    np.arange(2, fh, 4), np.arange(1, fh, 2)])
            idx = idx[order]
        out += b"," + struct.pack("<HHHHB", f.get("left", 0), f.get("top", 0),
                                  fw, fh, flags)
        if table is not None:
            out += np.concatenate([t, np.zeros(((2 << bits) - len(t), 3),
                                               np.uint8)]).tobytes()
        out += gif_lzw(idx, f.get("min_size", 8), f.get("clear_every", 0))
    return bytes(out) + b";"


# --------------------------------------------------------------------- WebP
WEBP_CONFIG = ("lossless", "quality", "method", "image_hint", "target_size",
               "target_PSNR", "segments", "sns_strength", "filter_strength",
               "filter_sharpness", "filter_type", "autofilter",
               "alpha_compression", "alpha_filtering", "alpha_quality",
               "pass", "show_compressed", "preprocessing", "partitions",
               "partition_limit", "emulate_jpeg_size", "thread_level",
               "low_memory", "near_lossless", "exact", "use_delta_palette",
               "use_sharp_yuv")


def _libwebp():
    import ctypes
    import glob
    import os
    import PIL
    libdir = os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs")
    libs = glob.glob(os.path.join(libdir, "libwebp-*.so*"))
    if not libs:
        raise RuntimeError("PIL's libwebp not found")
    for dep in glob.glob(os.path.join(libdir, "libsharpyuv-*.so*")):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    return ctypes.CDLL(libs[0])


def webp_encode(rgba, **config) -> bytes:
    """(h, w, 4) uint8 RGBA → a WebP written by libwebp's advanced API
    (PIL's own libwebp through ctypes), with any WebPConfig field set by
    name: filter_type 0 (simple) or 1, partitions 0-3, segments 1-4,
    filter_sharpness, alpha_compression 0 (raw) or 1, alpha_filtering,
    lossless, exact... Only for test data: cv2 and PIL reach none of
    these knobs."""
    import ctypes
    lib = _libwebp()
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    cfg = (ctypes.c_int32 * 64)()
    assert lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(75.0), 0x0210)
    for name, value in config.items():
        i = WEBP_CONFIG.index(name)
        if name in ("quality", "target_PSNR"):
            ctypes.cast(ctypes.byref(cfg, 4 * i),
                        ctypes.POINTER(ctypes.c_float))[0] = value
        else:
            cfg[i] = value
    assert lib.WebPValidateConfig(cfg)
    pic = (ctypes.c_uint8 * 256)()
    assert lib.WebPPictureInitInternal(pic, 0x0210)
    fields = ctypes.cast(pic, ctypes.POINTER(ctypes.c_int32))
    fields[0] = config.get("lossless", 0)     # use_argb
    fields[2], fields[3] = w, h
    assert lib.WebPPictureImportRGBA(pic, rgba.ctypes.data_as(
        ctypes.c_void_p), 4 * w)
    writer = (ctypes.c_uint8 * 32)()
    lib.WebPMemoryWriterInit(writer)
    ptrs = ctypes.cast(pic, ctypes.POINTER(ctypes.c_void_p))
    ptrs[12] = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    ptrs[13] = ctypes.addressof(writer)
    ok = lib.WebPEncode(cfg, pic)
    mem = ctypes.cast(writer, ctypes.POINTER(ctypes.c_void_p))
    size = ctypes.cast(writer, ctypes.POINTER(ctypes.c_size_t))[1]
    blob = ctypes.string_at(mem[0], size)
    lib.WebPMemoryWriterClear(writer)
    lib.WebPPictureFree(pic)
    assert ok, "WebPEncode failed"
    return blob


def alpha_filter(a, method: int) -> np.ndarray:
    """The WebP alpha filters' forward direction (1 horizontal, 2
    vertical, 3 gradient; 0 none) on (h, w) uint8."""
    a = np.asarray(a).astype(np.int32)
    pred = np.zeros_like(a)
    pred[0, 1:] = a[0, :-1]
    if method:
        pred[1:, 0] = a[:-1, 0]
    if method == 1:
        pred[1:, 1:] = a[1:, :-1]
    elif method == 2:
        pred[1:, 1:] = a[:-1, 1:]
    elif method == 3:
        pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    if method == 0:
        pred[:] = 0
    return ((a - pred) & 0xFF).astype(np.uint8)


def alph_chunk(a, method: int, compression: int, vp8l_of_green) -> bytes:
    """An ALPH payload: the header byte and the filtered plane, raw or as
    a VP8L image stream whose green channel holds it (`vp8l_of_green`
    maps an (h, w, 4) RGBA image to a VP8L chunk's payload)."""
    f = alpha_filter(a, method)
    if compression == 0:
        return bytes([method << 2]) + f.tobytes()
    g = np.zeros(f.shape + (4,), np.uint8)
    g[..., 1], g[..., 3] = f, 255
    return bytes([1 | method << 2]) + vp8l_of_green(g)[5:]


def riff(*chunks) -> bytes:
    """A RIFF/WEBP file of (tag, payload) chunks, each padded to even."""
    body = b"".join(tag + struct.pack("<I", len(data)) + data
                    + b"\0" * (len(data) & 1) for tag, data in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def riff_chunk(blob: bytes, tag: bytes):
    """The payload of a WebP file's first top-level chunk `tag`, or None."""
    pos = 12
    while pos < len(blob):
        n = struct.unpack_from("<I", blob, pos + 4)[0]
        if blob[pos:pos + 4] == tag:
            return blob[pos + 8:pos + 8 + n]
        pos += 8 + n + (n & 1)
    return None


# ------------------------------------------------------- CCITT, ThunderScan
def _libtiff():
    import ctypes
    import glob
    import os
    import PIL
    libdir = os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs")
    libs = glob.glob(os.path.join(libdir, "libtiff-*.so*"))
    if not libs:
        raise RuntimeError("PIL's libtiff not found")
    lib = ctypes.CDLL(libs[0])
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    for fn in (lib.TIFFWriteEncodedStrip, lib.TIFFWriteEncodedTile):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
                       ctypes.c_ssize_t]
        fn.restype = ctypes.c_ssize_t
    return lib


def libtiff_bilevel(path, black, compression, photometric=0, fill_order=1,
                    t4_options=None, rows_per_strip=None, tile=None) -> bytes:
    """(h, w) bool `black` written by PIL's own libtiff (its CCITT
    encoders) with the given tags; → the file's bytes. With MinIsWhite
    (0) a black pixel is a 1 bit, with MinIsBlack (1) a 0 bit."""
    import ctypes
    lib = _libtiff()
    black = np.asarray(black, bool)
    h, w = black.shape
    bits = black if photometric == 0 else ~black
    tif = lib.TIFFOpen(str(path).encode(), b"w")
    assert tif

    def put(tag, v, wide=False):
        assert lib.TIFFSetField(ctypes.c_void_p(tif), ctypes.c_uint32(tag),
                                ctypes.c_uint32(v) if wide
                                else ctypes.c_int(v)), tag
    put(256, w, True)
    put(257, h, True)
    put(258, 1)
    put(277, 1)
    put(259, compression)
    put(262, photometric)
    put(266, fill_order)
    put(284, 1)
    if t4_options is not None:
        put(292, t4_options, True)
    if tile:
        put(322, tile[0], True)
        put(323, tile[1], True)
        for i, t in enumerate(tiles(bits.astype(np.uint8), *tile)):
            buf = np.packbits(t, axis=1).tobytes()
            assert lib.TIFFWriteEncodedTile(ctypes.c_void_p(tif), i, buf,
                                            len(buf)) >= 0
    else:
        rps = rows_per_strip or h
        put(278, rps, True)
        for i, y in enumerate(range(0, h, rps)):
            buf = np.packbits(bits[y:y + rps].astype(np.uint8),
                              axis=1).tobytes()
            assert lib.TIFFWriteEncodedStrip(ctypes.c_void_p(tif), i, buf,
                                             len(buf)) >= 0
    lib.TIFFClose(ctypes.c_void_p(tif))
    with open(path, "rb") as f:
        return f.read()


def libtiff_sgilog(path, data, compression=34676, rows_per_strip=None,
                   tile=None) -> bytes:
    """float32 (h, w, 3) XYZ (LogLuv) or (h, w) Y (LogL) written by the
    host's libtiff.so.6 with compression 34676 (SGILog) or 34677
    (SGILog24) from SGILOGDATAFMT_FLOAT samples (PIL refuses the
    photometrics); → the file's bytes. libtiff stores them as 16-bit
    signed samples whatever the data format."""
    import ctypes
    lib = ctypes.CDLL("libtiff.so.6")
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    lib.TIFFWriteScanline.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_uint32, ctypes.c_uint16]
    lib.TIFFWriteEncodedTile.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                         ctypes.c_void_p, ctypes.c_ssize_t]
    lib.TIFFWriteEncodedTile.restype = ctypes.c_ssize_t
    data = np.asarray(data, np.float32)
    h, w = data.shape[:2]
    spp = 1 if data.ndim == 2 else 3
    tif = lib.TIFFOpen(str(path).encode(), b"w")
    assert tif

    def put(tag, v):
        assert lib.TIFFSetField(ctypes.c_void_p(tif), ctypes.c_uint32(tag),
                                ctypes.c_int(v)), tag
    put(256, w)
    put(257, h)
    put(277, spp)
    put(259, compression)
    put(262, 32845 if spp == 3 else 32844)
    put(284, 1)
    put(65560, 0)                      # TIFFTAG_SGILOGDATAFMT: float
    if tile:
        put(322, tile[0])
        put(323, tile[1])
        for i, t in enumerate(tiles(data, *tile)):
            t = np.ascontiguousarray(t, np.float32)
            assert lib.TIFFWriteEncodedTile(ctypes.c_void_p(tif), i,
                                            t.ctypes.data, t.nbytes) >= 0
    else:
        put(278, rows_per_strip or h)
        for y in range(h):
            row = np.ascontiguousarray(data[y])
            assert lib.TIFFWriteScanline(ctypes.c_void_p(tif),
                                         row.ctypes.data, y, 0) == 1
    lib.TIFFClose(ctypes.c_void_p(tif))
    with open(path, "rb") as f:
        return f.read()


# ITU-T T.4 tables 2 and 3 (terminating codes 0-63, make-up codes 64,
# 128, ..., 1728, then the shared make-up codes 1792, ..., 2560)
T4_WHITE = """00110101 000111 0111 1000 1011 1100 1110 1111 10011 10100 00111
01000 001000 000011 110100 110101 101010 101011 0100111 0001100 0001000
0010111 0000011 0000100 0101000 0101011 0010011 0100100 0011000 00000010
00000011 00011010 00011011 00010010 00010011 00010100 00010101 00010110
00010111 00101000 00101001 00101010 00101011 00101100 00101101 00000100
00000101 00001010 00001011 01010010 01010011 01010100 01010101 00100100
00100101 01011000 01011001 01011010 01011011 01001010 01001011 00110010
00110011 00110100 11011 10010 010111 0110111 00110110 00110111 01100100
01100101 01101000 01100111 011001100 011001101 011010010 011010011
011010100 011010101 011010110 011010111 011011000 011011001 011011010
011011011 010011000 010011001 010011010 011000 010011011""".split()
T4_BLACK = """0000110111 010 11 10 011 0011 0010 00011 000101 000100 0000100
0000101 0000111 00000100 00000111 000011000 0000010111 0000011000
0000001000 00001100111 00001101000 00001101100 00000110111 00000101000
00000010111 00000011000 000011001010 000011001011 000011001100
000011001101 000001101000 000001101001 000001101010 000001101011
000011010010 000011010011 000011010100 000011010101 000011010110
000011010111 000001101100 000001101101 000011011010 000011011011
000001010100 000001010101 000001010110 000001010111 000001100100
000001100101 000001010010 000001010011 000000100100 000000110111
000000111000 000000100111 000000101000 000001011000 000001011001
000000101011 000000101100 000001011010 000001100110 000001100111
0000001111 000011001000 000011001001 000001011011 000000110011
000000110100 000000110101 0000001101100 0000001101101 0000001001010
0000001001011 0000001001100 0000001001101 0000001110010 0000001110011
0000001110100 0000001110101 0000001110110 0000001110111 0000001010010
0000001010011 0000001010100 0000001010101 0000001011010 0000001011011
0000001100100 0000001100101""".split()
T4_EXT = """00000001000 00000001100 00000001101 000000010010 000000010011
000000010100 000000010101 000000010110 000000010111 000000011100
000000011101 000000011110 000000011111""".split()


def _mh_run(run, white):
    """One run as modified Huffman codes: make-ups, then a terminating
    code."""
    table = T4_WHITE if white else T4_BLACK
    out = []
    while run >= 2624:
        out.append(T4_EXT[-1])
        run -= 2560
    if run >= 1792:
        out.append(T4_EXT[run // 64 - 28])
        run %= 64
    elif run >= 64:
        out.append(table[63 + run // 64])
        run %= 64
    out.append(table[run])
    return out


def rlew_file(black, photometric=0) -> bytes:
    """A CCITT RLEW (32771) TIFF of one strip: each row coded as modified
    Huffman and padded to where libtiff's decoder starts the next row.
    That decoder drops what is left in its bit accumulator modulo 16 and
    then steps to an even byte, so its row start depends on how far its
    table look-ups (12 bits for white codes, 13 for black) have read
    ahead; this follows it byte for byte. (libtiff's own 32771 encoder
    pads to the next 16-bit word, which its decoder misreads.)"""
    bits, avail, cp = "", 0, 0
    for row in np.asarray(black, bool):
        if photometric == 1:
            row = ~row
        changes = np.flatnonzero(np.diff(np.r_[False, row, ~row[-1]]))
        runs = np.diff(np.r_[0, changes])[:len(changes)]
        runs = [int(r) for r in runs]
        if len(runs) % 2 == 1:
            runs.append(0)
        codes = []
        for i, r in enumerate(runs):
            if i == len(runs) - 1 and r == 0:
                break
            codes += [(c, 12 if i % 2 == 0 else 13)
                      for c in _mh_run(r, i % 2 == 0)]
        for code, wid in codes:
            bits += code
            if avail < wid:             # NeedBits16: up to two bytes
                cp += 1
                avail += 8
                if avail < wid:
                    cp += 1
                    avail += 8
            avail -= len(code)
        avail &= ~15
        if avail == 0 and cp & 1:
            cp += 1
        start = 8 * cp - avail
        bits += "0" * (start - len(bits))
    bits += "0" * (-len(bits) % 8)
    data = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    h, w = np.asarray(black).shape
    return tiff_file({256: (3, [w]), 257: (3, [h]), 258: (3, [1]),
                      259: (3, [32771]), 262: (3, [photometric]),
                      277: (3, [1]), 278: (3, [h])}, [data])


def thunderscan(idx: np.ndarray) -> bytes:
    """(h, w) 4-bit values → ThunderScan codes (libtiff's tif_thunder.c
    decodes them): per row raw pixels, 2- and 3-bit deltas and runs of
    the last pixel, a run never ending a row (libtiff would leave those
    bytes unwritten)."""
    out = bytearray()
    two = {0: 0, 1: 1, -1: 3}
    three = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    for row in np.asarray(idx, int):
        x, last, w = 0, 0, len(row)
        while x < w:
            run = 0
            while x + run < w - 1 and row[x + run] == last and run < 63:
                run += 1
            if run >= 2 and x > 0:
                out.append(run)
                x += run
                continue
            d = [int(row[x + k]) - last if k == 0 else
                 int(row[x + k]) - int(row[x + k - 1])
                 for k in range(min(3, w - x))]
            if len(d) == 3 and all(v in two for v in d):
                out.append(0x40 | two[d[0]] << 4 | two[d[1]] << 2 | two[d[2]])
                x += 3
            elif len(d) >= 2 and all(v in three for v in d[:2]):
                out.append(0x80 | three[d[0]] << 3 | three[d[1]])
                x += 2
            elif d[0] in three and (x + 1 == w or x % 5 == 0):
                # a 3-bit delta and a skip
                out.append(0x80 | three[d[0]] << 3 | 4)
                x += 1
            else:
                out.append(0xC0 | int(row[x]))
                x += 1
            last = int(row[x - 1])
    return bytes(out)


# ------------------------------------------------------------- JPEG 2000
# opj_cparameters_t of OpenJPEG 2.5 (openjpeg.h), byte offsets on a 64-bit
# host; `tests/test_torch_image_jpeg2000.py` checks them against
# opj_set_default_encoder_parameters
OPJ_FIELDS = {
    "tile_size_on": (0, "i"), "cp_tx0": (4, "i"), "cp_ty0": (8, "i"),
    "cp_tdx": (12, "i"), "cp_tdy": (16, "i"), "cp_disto_alloc": (20, "i"),
    "cp_fixed_quality": (28, "i"), "csty": (48, "i"),
    "prog_order": (52, "i"), "numpocs": (4792, "I"),
    "tcp_numlayers": (4796, "i"), "numresolution": (5600, "i"),
    "cblockw_init": (5604, "i"), "cblockh_init": (5608, "i"),
    "mode": (5612, "i"), "irreversible": (5616, "i"),
    "roi_compno": (5620, "i"), "roi_shift": (5624, "i"),
    "res_spec": (5628, "i"), "tp_on": (18696, "b"), "tp_flag": (18697, "b"),
    "tcp_mct": (18698, "b")}
OPJ_RATES, OPJ_DISTORATIO, OPJ_PRCW, OPJ_PRCH, OPJ_POC = (4800, 5200, 5632,
                                                           5764, 56)
PROGRESSION_ORDERS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def _libopenjp2():
    import ctypes
    import glob
    import os
    import PIL
    libdir = os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs")
    libs = glob.glob(os.path.join(libdir, "libopenjp2-*.so*"))
    if not libs:
        raise RuntimeError("PIL's libopenjp2 not found")
    lib = ctypes.CDLL(libs[0])
    P = ctypes.c_void_p
    for name, res, args in (
            ("opj_image_create", P, [ctypes.c_uint32, P, ctypes.c_int]),
            ("opj_create_compress", P, [ctypes.c_int]),
            ("opj_setup_encoder", ctypes.c_int, [P, P, P]),
            ("opj_stream_create_default_file_stream", P,
             [ctypes.c_char_p, ctypes.c_int]),
            ("opj_start_compress", ctypes.c_int, [P, P, P]),
            ("opj_encode", ctypes.c_int, [P, P]),
            ("opj_end_compress", ctypes.c_int, [P, P]),
            ("opj_stream_destroy", None, [P]),
            ("opj_destroy_codec", None, [P]),
            ("opj_image_destroy", None, [P]),
            ("opj_set_default_encoder_parameters", None, [P])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def opj_parameters(**fields) -> bytearray:
    """opj_cparameters_t: OpenJPEG's defaults, then `fields` (names of
    OPJ_FIELDS; also rates=[...] (sets cp_disto_alloc), quality=[...]
    (cp_fixed_quality, dB), precincts=[(w, h), ...] (res_spec, csty bit
    0), poc=[(res0, comp0, layer1, res1, comp1, "RPCL"), ...] (tile 1))."""
    import ctypes
    lib = _libopenjp2()
    buf = (ctypes.c_uint8 * 20000)()
    lib.opj_set_default_encoder_parameters(buf)
    p = bytearray(buf)
    rates, quality = fields.pop("rates", None), fields.pop("quality", None)
    if rates is not None:
        fields.update(cp_disto_alloc=1, tcp_numlayers=len(rates))
        struct.pack_into(f"<{len(rates)}f", p, OPJ_RATES, *rates)
    if quality is not None:
        fields.update(cp_fixed_quality=1, tcp_numlayers=len(quality))
        struct.pack_into(f"<{len(quality)}f", p, OPJ_DISTORATIO, *quality)
    precincts = fields.pop("precincts", None)
    if precincts:
        fields["res_spec"] = len(precincts)
        fields["csty"] = fields.get("csty", 0) | 1
        for i, (w, h) in enumerate(precincts):
            struct.pack_into("<i", p, OPJ_PRCW + 4 * i, w)
            struct.pack_into("<i", p, OPJ_PRCH + 4 * i, h)
    for i, (r0, c0, l1, r1, c1, prog) in enumerate(fields.pop("poc", ())):
        at = OPJ_POC + 148 * i
        struct.pack_into("<5I", p, at, r0, c0, l1, r1, c1)
        struct.pack_into("<i", p, at + 32, PROGRESSION_ORDERS.index(prog))
        struct.pack_into("<I", p, at + 48, 1)
        fields["numpocs"] = i + 1
    if "prog_order" in fields and isinstance(fields["prog_order"], str):
        fields["prog_order"] = PROGRESSION_ORDERS.index(fields["prog_order"])
    for name, value in fields.items():
        at, code = OPJ_FIELDS[name]
        struct.pack_into("<" + code, p, at, value)
    return p


def openjpeg_encode(path, comps, prec=8, signed=False, jp2=True,
                    colour=1, sub=None, origin=(0, 0), extra=(),
                    **fields) -> bytes:
    """Components ((h, w) integer arrays, at their own subsampled sizes)
    encoded by PIL's own libopenjp2 with any encoder field (see
    `opj_parameters`); colour: OPJ_CLRSPC_SRGB (1), GRAY (2), SYCC (3);
    sub: per component (dx, dy); origin: the image offset. → the file's
    bytes."""
    import ctypes
    lib = _libopenjp2()
    n = len(comps)
    sub = sub or [(1, 1)] * n
    precs = prec if isinstance(prec, (list, tuple)) else [prec] * n
    parms = (ctypes.c_uint32 * (9 * n))()
    for i, c in enumerate(comps):
        h, w = np.asarray(c).shape
        parms[9 * i:9 * i + 9] = [sub[i][0], sub[i][1], w, h,
                                  -(-origin[0] // sub[i][0]),
                                  -(-origin[1] // sub[i][1]), precs[i], 0,
                                  int(signed)]
    image = lib.opj_image_create(n, parms, colour)
    assert image
    w0 = np.asarray(comps[0]).shape[1] * sub[0][0]
    h0 = np.asarray(comps[0]).shape[0] * sub[0][1]
    hdr = (ctypes.c_uint32 * 4).from_address(image)
    hdr[:] = [origin[0], origin[1], origin[0] + w0, origin[1] + h0]
    comp_array = ctypes.c_void_p.from_address(image + 24).value
    for i, c in enumerate(comps):
        data = ctypes.c_void_p.from_address(comp_array + 64 * i + 48).value
        a = np.ascontiguousarray(c, np.int32)
        ctypes.memmove(data, a.ctypes.data, a.nbytes)
    params = (ctypes.c_uint8 * 20000).from_buffer(opj_parameters(**fields))
    codec = lib.opj_create_compress(2 if jp2 else 0)
    stream = None
    try:
        assert lib.opj_setup_encoder(codec, params, image)
        if extra:
            opj_extra_options(codec, list(extra))
        stream = lib.opj_stream_create_default_file_stream(
            str(path).encode(), 0)
        assert lib.opj_start_compress(codec, image, stream)
        assert lib.opj_encode(codec, stream)
        assert lib.opj_end_compress(codec, stream)
    finally:
        if stream:
            lib.opj_stream_destroy(stream)
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(image)
    with open(path, "rb") as f:
        return f.read()


def opj_extra_options(codec, options):
    """opj_encoder_set_extra_options (e.g. "TLM=YES", "PLT=YES")."""
    import ctypes
    lib = _libopenjp2()
    arr = (ctypes.c_char_p * (len(options) + 1))(
        *[o.encode() for o in options], None)
    lib.opj_encoder_set_extra_options.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_void_p]
    assert lib.opj_encoder_set_extra_options(codec, arr)


def jp2_box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def jp2_file(codestream: bytes, h, w, ncomp, bits, enumcs=16, pclr=None,
             cmap=None, cdef=None) -> bytes:
    """A JP2 file around a codestream: signature, ftyp, jp2h (ihdr, colr
    of `enumcs`, then pclr ((n, k) entries, depths), cmap [(cmp, mtyp,
    pcol)] and cdef [(cn, typ, asoc)] when given), jp2c."""
    head = jp2_box(b"ihdr", struct.pack(">IIHBBBB", h, w, ncomp, bits - 1,
                                        7, 0, 0))
    head += jp2_box(b"colr", struct.pack(">BBBI", 1, 0, 0, enumcs))
    if pclr is not None:
        table, depths = pclr
        body = struct.pack(">HB", len(table), len(depths))
        body += bytes(d - 1 for d in depths)
        for row in table:
            for v, d in zip(row, depths):
                body += int(v).to_bytes((d + 7) // 8, "big")
        head += jp2_box(b"pclr", body)
    if cmap is not None:
        head += jp2_box(b"cmap", b"".join(struct.pack(">HBB", *m)
                                          for m in cmap))
    if cdef is not None:
        head += jp2_box(b"cdef", struct.pack(">H", len(cdef)) + b"".join(
            struct.pack(">HHH", *d) for d in cdef))
    return (b"\x00\x00\x00\x0cjP  \r\n\x87\n"
            + jp2_box(b"ftyp", b"jp2 \x00\x00\x00\x00jp2 ")
            + jp2_box(b"jp2h", head) + jp2_box(b"jp2c", codestream))


def packed_headers(codestream: bytes, where="ppt") -> bytes:
    """A codestream written with SOP and EPH markers, its packet headers
    (each up to and with its EPH) moved into PPT marker segments of their
    tile-parts, or into PPM segments of the main header (one Nppm chunk
    per tile-part); the bodies stay, behind their SOPs. Marker emulation
    keeps FF91 and FF92 out of headers and bodies, so they split."""
    main_end = codestream.index(b"\xff\x90")
    main, pos, parts = codestream[:main_end], main_end, []
    while pos < len(codestream) and codestream[pos:pos + 2] == b"\xff\x90":
        psot = struct.unpack_from(">I", codestream, pos + 6)[0]
        end = pos + psot if psot else len(codestream) - 2
        sod = codestream.index(b"\xff\x93", pos) + 2
        header, data = codestream[pos:sod - 2], codestream[sod:end]
        heads, bodies = b"", b""
        for pkt in data.split(b"\xff\x91")[1:]:
            sop, rest = b"\xff\x91" + pkt[:4], pkt[4:]
            cut = rest.index(b"\xff\x92") + 2
            heads += rest[:cut]
            bodies += sop + rest[cut:]
        parts.append((header, heads, bodies))
        pos = end
    out = b""
    if where == "ppm":
        stream = b"".join(struct.pack(">I", len(h)) + h for _, h, _ in parts)
        ppm = b"".join(struct.pack(">HHB", 0xFF60, 3 + len(c), z) + c
                       for z, c in enumerate([stream[i:i + 60000] for i in
                                              range(0, len(stream), 60000)]))
        out = main + ppm
    else:
        out = main
    zppt = {}                 # Zppt counts the PPT segments of each tile
    for header, heads, bodies in parts:
        if where == "ppt":
            tile = struct.unpack_from(">H", header, 4)[0]
            z = zppt[tile] = zppt.get(tile, -1) + 1
            header += struct.pack(">HHB", 0xFF61, 3 + len(heads), z) + heads
        tp = header + b"\xff\x93" + bodies
        tp = tp[:6] + struct.pack(">I", len(tp)) + tp[10:]
        out += tp
    return out + b"\xff\xd9"


# ------------------------------------------------------------------ AVIF
# A HEIF container written box by box (for the grid, layered and
# broken-box cases) and libaom's own encoder through ctypes (the
# opencv-python wheel's libaom), for the tools no libavif option reaches:
# intra block copy, superres, two-pass segmentation and a chosen usage.

def isobmff_box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(payload), kind) + payload


def full_box(kind: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return isobmff_box(kind, bytes([version]) + flags.to_bytes(3, "big") + payload)


def av1c(info: dict) -> bytes:
    """The av1C record (AV1-ISOBMFF 2.3.3) of a stream's sequence header,
    from the fields `native.av1_decode` reports."""
    return bytes([0x81, (info["profile"] << 5) | info["level"],
                  (info["tier"] << 7) | ((info["bit_depth"] > 8) << 6) | ((info["bit_depth"] == 12) << 5)
                  | (info["mono"] << 4) | (info["ssx"] << 3) | (info["ssy"] << 2) | info["csp"], 0])


def avif_still(obus: bytes, info: dict, colr=None, extra_props=()) -> bytes:
    """A one-item AVIF file around an AV1 key frame."""
    channels = 1 if info["mono"] else 3
    props = [ispe(info["width"], info["height"]), pixi(info["bit_depth"], channels),
             isobmff_box(b"av1C", av1c(info))]
    if colr is not None:
        props.append(nclx(*colr))
    props += list(extra_props)
    return avif_file([dict(id=1, type=b"av01", data=obus, props=props)])


def avif_file(items, primary=1, refs=(), major=b"avif", brands=(b"avif", b"mif1", b"miaf"),
              extra_meta=b"", extra_top=b"", idat=None, extra_mdat=b"") -> bytes:
    """An AVIF file: `items` is a list of dicts with id, type, data,
    props (list of box bytes), optional hidden / construction method 1
    (the data then goes into idat); refs are (type, from, [to...]);
    `extra_mdat` follows the items' data in mdat."""
    ftyp = isobmff_box(b"ftyp", major + b"\0\0\0\0" + b"".join(brands))
    hdlr = full_box(b"hdlr", 0, 0, b"\0" * 4 + b"pict" + b"\0" * 12 + b"\0")
    pitm = full_box(b"pitm", 0, 0, struct.pack(">H", primary))
    infes = b"".join(full_box(b"infe", 2, 1 if it.get("hidden") else 0,
                              struct.pack(">HH", it["id"], 0) + it["type"] + b"\0")
                     for it in items)
    iinf = full_box(b"iinf", 0, 0, struct.pack(">H", len(items)) + infes)
    props, assoc = [], []
    for it in items:
        idx = []
        for p in it.get("props", []):
            # a property is essential unless given as (box, False)
            box, essential = p if isinstance(p, tuple) else (p, True)
            props.append(box)
            idx.append(len(props) | (0x80 if essential else 0))
        assoc.append((it["id"], idx))
    ipco = isobmff_box(b"ipco", b"".join(props))
    ipma_body = struct.pack(">I", len(assoc))
    for iid, idx in assoc:
        ipma_body += struct.pack(">HB", iid, len(idx)) + bytes(idx)
    iprp = isobmff_box(b"iprp", ipco + full_box(b"ipma", 0, 0, ipma_body))
    iref = b""
    if refs:
        iref = full_box(b"iref", 0, 0, b"".join(
            isobmff_box(k, struct.pack(">HH", f, len(to)) + b"".join(struct.pack(">H", t) for t in to))
            for k, f, to in refs))
    idat_items = [it for it in items if it.get("method") == 1]
    idat_payload = b"".join(it["data"] for it in idat_items)

    def build(mdat_start):
        body = struct.pack(">H", len(items))
        pos, ipos = mdat_start, 0
        for it in items:
            if it.get("method") == 1:
                off = ipos
                ipos += len(it["data"])
                body += struct.pack(">HHHHII", it["id"], 1, 0, 1, off, len(it["data"]))
            else:
                body += struct.pack(">HHHHII", it["id"], 0, 0, 1, pos, len(it["data"]))
                pos += len(it["data"])
        iloc = full_box(b"iloc", 1, 0, bytes([0x44, 0x00]) + body)
        meta = full_box(b"meta", 0, 0, hdlr + pitm + iloc + iinf + iref + iprp + extra_meta
                        + (isobmff_box(b"idat", idat_payload) if idat_items else b""))
        return meta

    meta = build(0)
    start = len(ftyp) + len(meta) + len(extra_top) + 8
    meta = build(start)
    mdat = isobmff_box(b"mdat", b"".join(it["data"] for it in items if it.get("method") != 1)
                       + extra_mdat)
    return ftyp + meta + extra_top + mdat


def av01_entry(width, height, props) -> bytes:
    """An `av01` sample entry: the VisualSampleEntry's 78 bytes, then the
    property boxes (av1C, colr, pasp, ccst, auxi, ...)."""
    visual = (b"\0" * 6 + struct.pack(">H", 1) + b"\0" * 16 + struct.pack(">HH", width, height)
              + struct.pack(">III", 0x480000, 0x480000, 0) + struct.pack(">H", 1) + b"\0" * 32
              + struct.pack(">Hh", 0x18, -1))
    return isobmff_box(b"av01", visual + b"".join(props))


def _track_box(t: dict, base: int) -> bytes:
    """One `trak` whose samples start at file offset `base`. Keys: id,
    width, height, samples (list of bytes), props (sample entry boxes),
    optional aux_for / prem_by (track ids), chunks (samples per chunk;
    one chunk by default), co64, stss (1-based sample numbers), all_size
    (every sample of one size: stsz's sample_size), handler, elst,
    entries (raw stsd entries instead of one av01), tkhd_size (the
    size written into tkhd) and skip (box types left out)."""
    skip = set(t.get("skip", ()))
    samples = t["samples"]
    w, h = t.get("tkhd_size", (t["width"], t["height"]))
    tkhd = full_box(b"tkhd", 0, 1, struct.pack(">IIIII", 0, 0, t["id"], 0, len(samples))
                    + b"\0" * 8 + b"\0" * 8 + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
                    + struct.pack(">II", w << 16, h << 16))
    refs = b""
    if t.get("aux_for"):
        refs += isobmff_box(b"auxl", struct.pack(">I", t["aux_for"]))
    if t.get("prem_by"):
        refs += isobmff_box(b"prem", struct.pack(">I", t["prem_by"]))
    tref = isobmff_box(b"tref", refs) if refs else b""
    edts = isobmff_box(b"edts", full_box(b"elst", 0, 1, struct.pack(">IIII", 1, 100 * len(samples), 0, 0x10000))) \
        if t.get("elst", True) else b""
    mdhd = full_box(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, 1000, 100 * len(samples), 0x55c4, 0))
    hdlr = full_box(b"hdlr", 0, 0, b"\0" * 4 + t.get("handler", b"pict") + b"\0" * 12 + b"\0")
    entries = t.get("entries") or [av01_entry(t["width"], t["height"], t.get("props", []))]
    stsd = full_box(b"stsd", 0, 0, struct.pack(">I", len(entries)) + b"".join(entries))
    chunks = t.get("chunks") or [len(samples)]
    runs = []
    for k, n in enumerate(chunks):
        if not runs or runs[-1][1] != n:
            runs.append((k + 1, n))
    stsc = full_box(b"stsc", 0, 0, struct.pack(">I", len(runs)) + b"".join(
        struct.pack(">III", f, n, 1) for f, n in runs))
    if t.get("all_size"):
        stsz = full_box(b"stsz", 0, 0, struct.pack(">II", len(samples[0]), len(samples)))
    else:
        stsz = full_box(b"stsz", 0, 0, struct.pack(">II", 0, len(samples))
                        + b"".join(struct.pack(">I", len(x)) for x in samples))
    offsets, pos, k = [], base, 0
    for n in chunks:
        offsets.append(pos)
        pos += sum(len(x) for x in samples[k:k + n])
        k += n
    if t.get("co64"):
        stco = full_box(b"co64", 0, 0, struct.pack(">I", len(offsets)) + b"".join(struct.pack(">Q", o) for o in offsets))
    else:
        stco = full_box(b"stco", 0, 0, struct.pack(">I", len(offsets)) + b"".join(struct.pack(">I", o) for o in offsets))
    syncs = t.get("stss", [1])
    stss = full_box(b"stss", 0, 0, struct.pack(">I", len(syncs)) + b"".join(struct.pack(">I", x) for x in syncs))
    stts = full_box(b"stts", 0, 0, struct.pack(">III", 1, len(samples), 100))
    parts = {b"stsd": stsd, b"stts": stts, b"stsc": stsc, b"stsz": stsz, b"stco": stco, b"stss": stss}
    stbl = isobmff_box(b"stbl", b"".join(v for k2, v in parts.items() if k2 not in skip))
    dinf = isobmff_box(b"dinf", full_box(b"dref", 0, 0, struct.pack(">I", 1) + full_box(b"url ", 0, 1, b"")))
    minf = isobmff_box(b"minf", full_box(b"vmhd", 0, 1, b"\0" * 8) + dinf + stbl)
    mdia = isobmff_box(b"mdia", mdhd + hdlr + minf)
    return isobmff_box(b"trak", (b"" if b"tkhd" in skip else tkhd) + tref + edts + mdia)


def sequence_tracks(blob: bytes) -> list:
    """The tracks of an AVIF sequence, read here box by box (not by the
    port): [{id, aux_for, samples: [bytes], props: [box bytes of the av01
    sample entry]}] for every `trak`, its samples laid out chunk by chunk
    as stsc, stsz and stco/co64 say."""
    def boxes(start, end):
        pos = start
        while pos + 8 <= end:
            size, kind = struct.unpack(">I4s", blob[pos:pos + 8])
            hdr = 8
            if size == 1:
                size, hdr = struct.unpack(">Q", blob[pos + 8:pos + 16])[0], 16
            yield kind, pos + hdr, pos + size
            pos += size

    def child(start, end, path):
        for kind, s, e in boxes(start, end):
            if kind == path[0]:
                return (s, e) if len(path) == 1 else child(s, e, path[1:])
        return None
    out = []
    moov = child(0, len(blob), [b"moov"])
    for kind, ts, te in boxes(*moov):
        if kind != b"trak":
            continue
        s, _ = child(ts, te, [b"tkhd"])
        version = blob[s]
        track = {"id": struct.unpack(">I", blob[s + (20 if version else 12):][:4])[0], "aux_for": 0}
        tref = child(ts, te, [b"tref", b"auxl"])
        if tref:
            track["aux_for"] = struct.unpack(">I", blob[tref[0]:tref[0] + 4])[0]
        stbl = child(ts, te, [b"mdia", b"minf", b"stbl"])
        tables = {k: (s2, e2) for k, s2, e2 in boxes(*stbl)}
        s, e = tables[b"stsd"]
        entry = s + 8
        esize = struct.unpack(">I", blob[entry:entry + 4])[0]
        track["props"] = [blob[a - 8:b] for _, a, b in boxes(entry + 8 + 78, entry + esize)]
        s, _ = tables[b"stsz"]
        all_size, count = struct.unpack(">II", blob[s + 4:s + 12])
        sizes = [all_size] * count if all_size else \
            list(struct.unpack(f">{count}I", blob[s + 12:s + 12 + 4 * count]))
        wide = b"co64" in tables
        s, _ = tables[b"co64" if wide else b"stco"]
        n = struct.unpack(">I", blob[s + 4:s + 8])[0]
        chunks = struct.unpack(f">{n}{'Q' if wide else 'I'}", blob[s + 8:s + 8 + (8 if wide else 4) * n])
        s, _ = tables[b"stsc"]
        runs = [struct.unpack(">III", blob[s + 8 + 12 * i:s + 20 + 12 * i])
                for i in range(struct.unpack(">I", blob[s + 4:s + 8])[0])]
        samples, k = [], 0
        for index, offset in enumerate(chunks):
            per = [r[1] for r in runs if r[0] <= index + 1][-1]
            for _ in range(per):
                samples.append(blob[offset:offset + sizes[k]])
                offset += sizes[k]
                k += 1
        track["samples"] = samples
        out.append(track)
    return out


def avis_file(tracks, items=(), primary=1, refs=(), major=b"avis",
              brands=(b"avis", b"avif", b"mif1", b"miaf", b"msf1", b"iso8")) -> bytes:
    """An AVIF sequence: `tracks` as `_track_box` takes them, their
    samples in mdat after the items' data (`items`, `primary` and `refs`
    as avif_file takes them; no meta box without items)."""
    payload = b"".join(b"".join(t["samples"]) for t in tracks)

    def moov_at(base):
        mvhd = full_box(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000, 300) + struct.pack(">IH", 0x10000, 0x100)
                        + b"\0" * 10 + struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
                        + b"\0" * 24 + struct.pack(">I", len(tracks) + 1))
        boxes = b""
        for t in tracks:
            boxes += _track_box(t, base)
            base += sum(len(x) for x in t["samples"])
        return isobmff_box(b"moov", mvhd + boxes)

    moov = moov_at(0)
    if items:
        probe = avif_file(items, primary, refs, major, brands, extra_top=moov, extra_mdat=payload)
        base = len(probe) - len(payload)
        return avif_file(items, primary, refs, major, brands, extra_top=moov_at(base), extra_mdat=payload)
    ftyp = isobmff_box(b"ftyp", major + b"\0\0\0\0" + b"".join(brands))
    base = len(ftyp) + len(moov) + 8
    return ftyp + moov_at(base) + isobmff_box(b"mdat", payload)


def ispe(w, h) -> bytes:
    return full_box(b"ispe", 0, 0, struct.pack(">II", w, h))


def pixi(depth, channels) -> bytes:
    return full_box(b"pixi", 0, 0, bytes([channels] + [depth] * channels))


def nclx(cp, tc, mc, full) -> bytes:
    return isobmff_box(b"colr", b"nclx" + struct.pack(">HHHB", cp, tc, mc, 0x80 if full else 0))


def _libaom():
    import ctypes

    import torch_av1_tables as tables
    lib = ctypes.CDLL(tables.libaom_path())
    lib.aom_codec_av1_cx.restype = ctypes.c_void_p
    lib.aom_img_alloc.restype = ctypes.c_void_p
    lib.aom_img_alloc.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_uint]
    lib.aom_codec_enc_init_ver.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long, ctypes.c_int]
    lib.aom_codec_set_option.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
    lib.aom_codec_encode.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_ulong, ctypes.c_long]
    lib.aom_codec_get_cx_data.restype = ctypes.c_void_p
    lib.aom_codec_get_cx_data.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.aom_codec_destroy.argtypes = [ctypes.c_void_p]
    lib.aom_img_free.argtypes = [ctypes.c_void_p]
    return lib


AOM_ENCODER_ABI_VERSION = 0x1d   # as libavif 1.4 passes it to aom_codec_enc_init_ver


def _aom_image(lib, w, h, bit_depth):
    """A w x h aom_image_t (I420, 16-bit above 8 bits) and a function that
    copies [Y, U, V] planes into it."""
    import ctypes
    img = lib.aom_img_alloc(None, 0x102 | (0x800 if bit_depth > 8 else 0), w, h, 16)
    planes = (ctypes.c_void_p * 3).from_address(img + 64)
    strides = (ctypes.c_int * 3).from_address(img + 88)
    ctypes.c_uint.from_address(img + 36).value = bit_depth   # bit_depth

    def fill(yuv):
        for p, plane in enumerate(yuv):
            data = np.ascontiguousarray(plane, np.uint16 if bit_depth > 8 else np.uint8)
            row = data.shape[1] * data.itemsize
            for y in range(data.shape[0]):
                ctypes.memmove(planes[p] + y * strides[p], data[y].ctypes.data, row)
    return img, fill


def _aom_packets(lib, ctx) -> tuple:
    """(frame bytes, first-pass stats bytes) of the packets the encoder
    holds."""
    import ctypes
    frames, stats, it = b"", b"", ctypes.c_void_p(0)
    while True:
        pkt = lib.aom_codec_get_cx_data(ctx, ctypes.byref(it))
        if not pkt:
            return frames, stats
        kind = ctypes.c_int.from_address(pkt).value
        buf = ctypes.c_void_p.from_address(pkt + 8).value
        sz = ctypes.c_size_t.from_address(pkt + 16).value
        if kind == 0:                                  # AOM_CODEC_CX_FRAME_PKT
            frames += ctypes.string_at(buf, sz)
        elif kind == 1:                                # AOM_CODEC_STATS_PKT
            stats += ctypes.string_at(buf, sz)


def aom_encode(yuv, bit_depth=8, usage=2, cq=30, options=None, cfg=None,
               two_pass=False) -> bytes:
    """One key frame from libaom's encoder: `yuv` is [Y, U, V] 4:2:0
    planes (uint8 or uint16 for 10/12 bits); usage 0 good quality, 2 all
    intra; `options` go to aom_codec_set_option (aomenc's names),
    `cfg` sets aom_codec_enc_cfg_t fields by their uint32 index (19
    rc_superres_mode, 20 rc_superres_denominator, 21 its key-frame
    denominator); `two_pass` runs libaom's first pass and feeds its
    stats to the second (its variance AQ segments only then).
    → the OBUs without the temporal delimiter."""
    stats = _aom_pass(yuv, bit_depth, usage, cq, options, cfg, 1, None)[1] if two_pass else None
    out = _aom_pass(yuv, bit_depth, usage, cq, options, cfg, 2 if two_pass else 0, stats)[0]
    if out and (out[0] >> 3) & 15 == 2:                # drop the temporal delimiter
        out = out[2:]
    return out


def _aom_pass(yuv, bit_depth, usage, cq, options, cfg, passno, stats):
    import ctypes
    lib = _libaom()
    h, w = yuv[0].shape
    cfgbuf = ctypes.create_string_buffer(4096)
    iface = ctypes.c_void_p(lib.aom_codec_av1_cx())
    if lib.aom_codec_enc_config_default(iface, cfgbuf, usage):
        raise RuntimeError("aom_codec_enc_config_default")
    fields = np.frombuffer(cfgbuf, np.uint32, 100).copy()
    fields[3], fields[4], fields[5] = w, h, 1          # g_w, g_h, g_limit
    fields[8], fields[9] = bit_depth, bit_depth        # g_bit_depth, g_input_bit_depth
    fields[2] = 2 if bit_depth == 12 else 0            # g_profile
    fields[13] = passno                                 # g_pass
    fields[14] = 0                                      # g_lag_in_frames
    fields[24] = 3                                      # rc_end_usage AOM_Q
    for k, v in (cfg or {}).items():
        fields[k] = v
    ctypes.memmove(cfgbuf, fields.tobytes(), fields.nbytes)
    keep = None
    if stats is not None:                              # rc_twopass_stats_in
        keep = ctypes.create_string_buffer(stats, len(stats))
        ctypes.c_void_p.from_address(ctypes.addressof(cfgbuf) + 104).value = ctypes.addressof(keep)
        ctypes.c_size_t.from_address(ctypes.addressof(cfgbuf) + 112).value = len(stats)
    ctx = ctypes.create_string_buffer(512)
    flags = 0x40000 if bit_depth > 8 else 0            # AOM_CODEC_USE_HIGHBITDEPTH
    if lib.aom_codec_enc_init_ver(ctx, iface, cfgbuf, flags, AOM_ENCODER_ABI_VERSION):
        raise RuntimeError("aom_codec_enc_init_ver")
    try:
        opts = {"cq-level": str(cq)}
        opts.update(options or {})
        for k, v in opts.items():
            if lib.aom_codec_set_option(ctx, k.encode(), str(v).encode()):
                raise RuntimeError(f"aom option {k}={v} refused")
        img, fill = _aom_image(lib, w, h, bit_depth)
        fill(yuv)
        frames, stat = b"", b""
        for frame in (img, None):
            if lib.aom_codec_encode(ctx, frame, 0, 1, 0):
                raise RuntimeError("aom_codec_encode")
            got = _aom_packets(lib, ctx)
            frames, stat = frames + got[0], stat + got[1]
        lib.aom_img_free(img)
    finally:
        lib.aom_codec_destroy(ctx)
    return frames, stat


AOME_SET_SCALEMODE, AOME_SET_SPATIAL_LAYER_ID, AOME_SET_CPUUSED = 11, 12, 13
AOME_SET_TUNING, AOME_SET_CQ_LEVEL, AOME_SET_NUMBER_SPATIAL_LAYERS = 24, 25, 27
AV1E_SET_COLOR_RANGE = 52        # libaom's encoder_ctrl_maps: ctrl_set_color_range
SCALE_MODES = {(1, 1): 0, (4, 5): 1, (3, 5): 2, (3, 4): 3, (1, 4): 4, (1, 8): 5, (1, 2): 6}
# libavif's flags for a layer after the first: LAST is its only reference
LAYER_FLAGS = ((1 << 17) | (1 << 18) | (1 << 19) | (1 << 20) | (1 << 21) | (1 << 22)
               | (1 << 24) | (1 << 25))


def aom_encode_layers(yuv, layers, bit_depth=8, speed=6, options=None, cfg=None,
                      monochrome=False, flags=None, spatial=True, controls=None) -> list:
    """A layered AV1 image as libavif 1.4's codec_aom.c encodes one (good
    quality, AOM_Q, no lag, tune SSIM, AOME_SET_NUMBER_SPATIAL_LAYERS),
    then per layer AOME_SET_SPATIAL_LAYER_ID, AOME_SET_SCALEMODE and the
    quantizer, and for every layer after the first the flags that leave
    LAST its only reference. `yuv` is the full-size [Y, U, V] 4:2:0
    input of every layer; `layers` a list of (cq, (num, den)) scales.
    → each layer's OBUs (temporal delimiters dropped)."""
    import ctypes
    lib = _libaom()
    h, w = (yuv[0][0] if isinstance(yuv[0], (list, tuple)) else yuv[0]).shape
    cfgbuf = ctypes.create_string_buffer(4096)
    iface = ctypes.c_void_p(lib.aom_codec_av1_cx())
    if lib.aom_codec_enc_config_default(iface, cfgbuf, 0):
        raise RuntimeError("aom_codec_enc_config_default")
    fields = np.frombuffer(cfgbuf, np.uint32, 100).copy()
    fields[3], fields[4] = w, h
    fields[8], fields[9] = bit_depth, bit_depth
    fields[2] = 2 if bit_depth == 12 else 0
    fields[14] = 0                                      # g_lag_in_frames
    fields[24] = 3                                      # rc_end_usage AOM_Q
    fields[52] = int(monochrome)                        # monochrome
    for k, v in (cfg or {}).items():
        fields[k] = v
    ctypes.memmove(cfgbuf, fields.tobytes(), fields.nbytes)
    ctx = ctypes.create_string_buffer(512)
    init_flags = 0x40000 if bit_depth > 8 else 0
    if lib.aom_codec_enc_init_ver(ctx, iface, cfgbuf, init_flags, AOM_ENCODER_ABI_VERSION):
        raise RuntimeError("aom_codec_enc_init_ver")

    def control(ident, value):
        arg = ctypes.c_int(value) if isinstance(value, int) else value
        if lib.aom_codec_control(ctx, ctypes.c_int(ident), arg):
            raise RuntimeError(f"aom_codec_control {ident}")
    out = []
    try:
        control(AOME_SET_CPUUSED, speed)
        if spatial:
            control(AOME_SET_NUMBER_SPATIAL_LAYERS, len(layers))
        for k, v in (options or {}).items():
            if lib.aom_codec_set_option(ctx, k.encode(), str(v).encode()):
                raise RuntimeError(f"aom option {k}={v} refused")
        control(AOME_SET_TUNING, 1)                     # AOM_TUNE_SSIM
        for k, v in (controls or {}).items():
            control(k, v)
        img, fill = _aom_image(lib, w, h, bit_depth)
        inputs = yuv if isinstance(yuv[0], (list, tuple)) else [yuv] * len(layers)
        for index, (cq, scale) in enumerate(layers):
            fill(inputs[index])
            if spatial:
                control(AOME_SET_SPATIAL_LAYER_ID, index)
            mode = (ctypes.c_int * 2)(SCALE_MODES[scale], SCALE_MODES[scale])
            control(AOME_SET_SCALEMODE, ctypes.cast(mode, ctypes.c_void_p))
            control(AOME_SET_CQ_LEVEL, cq)
            frames = b""
            for frame in ((img,) if index < len(layers) - 1 else (img, None)):
                flag = flags[index] if flags is not None else LAYER_FLAGS if index else 0
                if lib.aom_codec_encode(ctx, frame, index, 1, flag):
                    raise RuntimeError("aom_codec_encode")
                frames += _aom_packets(lib, ctx)[0]
            out.append(drop_temporal_delimiters(frames))
        lib.aom_img_free(img)
    finally:
        lib.aom_codec_destroy(ctx)
    return out


def aom_encode_stream(frames, bit_depth=8, speed=6, cq=30, lag=0, options=None, cfg=None,
                      controls=None, usage=0) -> bytes:
    """A plain multi-frame AV1 stream from libaom's encoder (good quality
    by default, AOM_Q at `cq`): `frames` are full-size [Y, U, V] 4:2:0
    inputs; `lag` frames of look-ahead (g_lag_in_frames) let libaom code
    alt-reference frames, so compound prediction, the skip mode and
    shown-existing frames; `options` go to aom_codec_set_option (aomenc's
    names), `cfg` sets aom_codec_enc_cfg_t fields by their uint32 index
    (46 kf_mode, 48 kf_max_dist, 49 sframe_dist, 50 sframe_mode),
    `controls` aom_codec_control ids. The encoder is drained after the
    last frame, so every frame it holds back is written.
    → the OBUs of every temporal unit, temporal delimiters dropped."""
    import ctypes
    lib = _libaom()
    h, w = frames[0][0].shape
    cfgbuf = ctypes.create_string_buffer(4096)
    iface = ctypes.c_void_p(lib.aom_codec_av1_cx())
    if lib.aom_codec_enc_config_default(iface, cfgbuf, usage):
        raise RuntimeError("aom_codec_enc_config_default")
    fields = np.frombuffer(cfgbuf, np.uint32, 100).copy()
    fields[3], fields[4] = w, h
    fields[8], fields[9] = bit_depth, bit_depth
    fields[2] = 2 if bit_depth == 12 else 0
    fields[14] = lag                                    # g_lag_in_frames
    fields[24] = 3                                      # rc_end_usage AOM_Q
    for k, v in (cfg or {}).items():
        fields[k] = v
    ctypes.memmove(cfgbuf, fields.tobytes(), fields.nbytes)
    ctx = ctypes.create_string_buffer(512)
    init_flags = 0x40000 if bit_depth > 8 else 0
    if lib.aom_codec_enc_init_ver(ctx, iface, cfgbuf, init_flags, AOM_ENCODER_ABI_VERSION):
        raise RuntimeError("aom_codec_enc_init_ver")
    out = b""
    try:
        if lib.aom_codec_control(ctx, ctypes.c_int(AOME_SET_CPUUSED), ctypes.c_int(speed)):
            raise RuntimeError("aom_codec_control cpu-used")
        opts = {"cq-level": str(cq)}
        opts.update(options or {})
        for k, v in opts.items():
            if lib.aom_codec_set_option(ctx, k.encode(), str(v).encode()):
                raise RuntimeError(f"aom option {k}={v} refused")
        for k, v in (controls or {}).items():
            if lib.aom_codec_control(ctx, ctypes.c_int(k), ctypes.c_int(v)):
                raise RuntimeError(f"aom_codec_control {k}")
        img, fill = _aom_image(lib, w, h, bit_depth)
        for index, yuv in enumerate(frames):
            fill(yuv)
            if lib.aom_codec_encode(ctx, img, index, 1, 0):
                raise RuntimeError("aom_codec_encode")
            out += _aom_packets(lib, ctx)[0]
        while True:                                     # flush what the look-ahead holds
            if lib.aom_codec_encode(ctx, None, 0, 1, 0):
                raise RuntimeError("aom_codec_encode")
            got = _aom_packets(lib, ctx)[0]
            if not got:
                break
            out += got
        lib.aom_img_free(img)
    finally:
        lib.aom_codec_destroy(ctx)
    return drop_temporal_delimiters(out)


def layered_avif(layers, info, alpha=None, alpha_info=None, lsel=None, a1op=None,
                 size=None, premultiplied=False, colr=None, essential_a1lx=False) -> bytes:
    """A layered AVIF item as libavif writes one (its layers' OBUs back to
    back, `a1lx` sizing all but the last), optionally with a layered alpha
    item (`auxl`, the alpha URN, optionally `prem`), an `lsel` and an
    `a1op` on the colour item, an ispe of `size` (default: the stream's
    largest frame) and an nclx `colr`; `essential_a1lx` marks a1lx
    essential, which libavif refuses."""
    def a1lx(sizes):
        large = any(v > 0xFFFF for v in sizes[:-1])
        fields = (list(sizes[:-1]) + [0, 0, 0])[:3]
        return isobmff_box(b"a1lx", bytes([int(large)]) + b"".join(
            v.to_bytes(4 if large else 2, "big") for v in fields))

    w, h = size or (info["width"], info["height"])
    props = [ispe(w, h), pixi(info["bit_depth"], 1 if info["mono"] else 3),
             isobmff_box(b"av1C", av1c(info)), (a1lx([len(x) for x in layers]), essential_a1lx)]
    if colr is not None:
        props.append(nclx(*colr))
    if lsel is not None:
        props.append(isobmff_box(b"lsel", struct.pack(">H", lsel)))
    if a1op is not None:
        props.append(isobmff_box(b"a1op", bytes([a1op])))
    items = [dict(id=1, type=b"av01", data=b"".join(layers), props=props)]
    refs = []
    if alpha is not None:
        urn = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0"
        items.append(dict(id=2, type=b"av01", data=b"".join(alpha), hidden=True, props=[
            ispe(w, h), pixi(alpha_info["bit_depth"], 1), isobmff_box(b"av1C", av1c(alpha_info)),
            full_box(b"auxC", 0, 0, urn), (a1lx([len(x) for x in alpha]), False)]))
        refs.append((b"auxl", 2, [1]))
        if premultiplied:
            refs.append((b"prem", 1, [2]))
    return avif_file(items, refs=refs)


def drop_temporal_delimiters(obus: bytes) -> bytes:
    out, pos = b"", 0
    while pos < len(obus):
        start, h = pos, obus[pos]
        pos += 1 + ((h >> 2) & 1)
        size, shift = 0, 0
        while True:
            byte = obus[pos]
            pos += 1
            size |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                break
        if (h >> 3) & 15 != 2:
            out += obus[start:pos + size]
        pos += size
    return out


def rgb_to_yuv420(rgb: np.ndarray) -> list:
    """BT.601 full-range Y, U, V (4:2:0, box-averaged chroma) of an 8-bit
    RGB image with even sides."""
    f = rgb.astype(np.float64)
    y = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    u = (f[..., 2] - y) / 1.772 + 128
    v = (f[..., 0] - y) / 1.402 + 128
    sub = lambda c: c.reshape(c.shape[0] // 2, 2, c.shape[1] // 2, 2).mean((1, 3))
    return [np.clip(np.round(c), 0, 255).astype(np.uint8) for c in (y, sub(u), sub(v))]

