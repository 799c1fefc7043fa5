"""Writers of the JPEG and TIFF kinds that neither cv2 nor PIL writes, for
the image-variant tests and their fixtures (`torch_fixtures/formats/
make_fixtures.py`): arithmetic-coded JPEG (ITU T.81 Annex D, F.1.4, G.1.3;
the coding procedures of libjpeg's jcarith.c), lossless JPEG (Annex H)
and tiled or planar TIFF (TIFF 6.0 sections 15 and 8). cv2's decode of
what they write is the reference, so the port's decoder is never held
against its own encoder. numpy only.
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
