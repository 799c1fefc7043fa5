"""JPEG 2000 read as `cv2.imread` reads it (OpenCV's OpenJPEG decoder over
OpenJPEG 2.5), with numpy and the tile decoder of `native/codecs.cc`
(`j2k_decode_tile`: tier-2, tier-1, the inverse wavelet); no `cv2`,
`PIL` or `glymur`, which the card's host does not have.

Both signatures: a JP2 file (`ihdr`, `colr` sRGB / greyscale / sYCC,
`pclr` + `cmap` palettes, `cdef` channel order) and a raw codestream
(`FF 4F FF 51`). The codestream: SIZ, COD/COC, QCD/QCC (no quantization,
scalar derived, scalar expounded), RGN (max-shift), POC, PPM/PPT,
PLT/PLM/TLM/CRG/COM (skipped), tiles and tile-parts, SOP/EPH, the five
progression orders, precincts, quality layers, 1 to 33 resolutions,
every code-block style but HT, the 5/3 and 9/7 wavelets, RCT/ICT, the DC
level shift and the clip to precision.

Then OpenCV's own conversion (grfmt_jpeg2000_openjpeg.cpp): a sample
depth of 8 bits gives uint8 and 9-16 bits uint16 under IMREAD_UNCHANGED,
samples shifted right by (depth - 8) under IMREAD_COLOR / _GRAYSCALE;
RGB(A) from three or four components (this reader returns RGB(A), cv2
BGR(A)); grey from one (or two) components, and under IMREAD_GRAYSCALE
from three by OpenCV's fixed-point weights. cv2 returns None (this raises
`errors.UnreadableImage`) for signed or subsampled components, an image
offset, depths below 8 (and above 16 but under IMREAD_COLOR /
_GRAYSCALE), two components under IMREAD_UNCHANGED, and more than four
components.
"""

from __future__ import annotations

import copy
import math
import struct
from pathlib import Path

import numpy as np

from . import jpeg, native
from .errors import ImwriteFailed, check_size, unreadable, unsupported

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"
PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")
MAX_RES = 33
# colour spaces of the `colr` box, as OpenJPEG names them for cv2
SRGB, GREY, SYCC = 16, 17, 18


def is_jpeg2000(head: bytes) -> bool:
    return head.startswith(JP2_SIGNATURE) or head.startswith(J2K_SIGNATURE)


# ---------------------------------------------------------------- JP2 boxes
def _boxes(blob, start, end, path):
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack_from(">I4s", blob, pos)
        head = 8
        if size == 1:
            if pos + 16 > end:
                unreadable(path, "truncated JP2 box")
            size = struct.unpack_from(">Q", blob, pos + 8)[0]
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            unreadable(path, f"JP2 box {kind!r} past the end of the file")
        yield kind, pos + head, pos + size
        pos += size


class _Jp2:
    """The boxes of a JP2 file that decide what cv2 gets."""

    def __init__(self, blob, path):
        self.enumcs = 0
        self.pclr = None          # (entries (n, k) int64, depths)
        self.cmap = None          # [(cmp, mtyp, pcol)]
        self.cdef = None          # [(cn, typ, asoc)]
        self.codestream = None
        have_colr = False
        for kind, a, b in _boxes(blob, 0, len(blob), path):
            if kind == b"jp2h":
                for k, x, y in _boxes(blob, a, b, path):
                    if k == b"colr" and not have_colr:
                        have_colr = True
                        if blob[x] == 1 and y - x >= 7:
                            self.enumcs = struct.unpack_from(">I", blob,
                                                             x + 3)[0]
                    elif k == b"pclr":
                        self.pclr = self._pclr(blob, x, y, path)
                    elif k == b"cmap":
                        self.cmap = [struct.unpack_from(">HBB", blob, i)
                                     for i in range(x, y - 3, 4)]
                    elif k == b"cdef":
                        n = struct.unpack_from(">H", blob, x)[0]
                        if x + 2 + 6 * n > y:
                            unreadable(path, "truncated cdef box")
                        self.cdef = [struct.unpack_from(">HHH", blob,
                                                        x + 2 + 6 * i)
                                     for i in range(n)]
            elif kind == b"jp2c" and self.codestream is None:
                self.codestream = blob[a:b]
        if self.codestream is None:
            unreadable(path, "JP2 file without a codestream")

    @staticmethod
    def _pclr(blob, x, y, path):
        if y - x < 3:
            unreadable(path, "truncated pclr box")
        ne, npc = struct.unpack_from(">HB", blob, x)
        depths = [blob[x + 3 + i] for i in range(min(npc, y - x - 3))]
        if len(depths) < npc or any((d & 0x7F) + 1 > 38 for d in depths):
            unreadable(path, "invalid pclr box")
        pos = x + 3 + npc
        table = np.zeros((ne, npc), np.int64)
        for j in range(ne):
            for i, d in enumerate(depths):
                nb = ((d & 0x7F) + 8) // 8
                if pos + nb > y:
                    unreadable(path, "truncated pclr box")
                table[j, i] = int.from_bytes(blob[pos:pos + nb], "big")
                pos += nb
        return table, [(d & 0x7F) + 1 for d in depths]


# ------------------------------------------------------------- codestream
class _Coding:
    """COD/COC parameters of one component."""

    def __init__(self):
        self.numres = 6
        self.xcb = self.ycb = 6
        self.style = 0
        self.reversible = True
        self.precincts = None     # [(PPx, PPy)] per resolution


class _Quant:
    def __init__(self):
        self.style = 0
        self.guard = 2
        self.steps = []           # [(expn, mant)] per band


class _Params:
    """A COD/COC/QCD/QCC/RGN/POC scope: the main header or a tile's."""

    def __init__(self, ncomp, base=None):
        if base is None:
            self.sop = self.eph = False
            self.prog, self.layers, self.mct = 0, 1, 0
            self.cod = [_Coding() for _ in range(ncomp)]
            self.quant = [_Quant() for _ in range(ncomp)]
            self.roi = [0] * ncomp
            self.poc = []
        else:
            self.__dict__.update(copy.deepcopy(base.__dict__))
        self.cod_set = [False] * ncomp     # by a COC of this scope
        self.quant_set = [False] * ncomp   # by a QCC of this scope


def _spcod(blob, pos, end, scoc, coding, path):
    if pos + 5 > end:
        unreadable(path, "truncated COD/COC")
    nl, xcb, ycb, style, transform = blob[pos:pos + 5]
    if nl > 32 or xcb > 8 or ycb > 8 or xcb + ycb > 8:
        unreadable(path, "COD/COC out of range")
    if style & 0x40:
        unsupported(path, "JPEG 2000 high-throughput (HT) code-blocks")
    if style & 0x80:
        unreadable(path, "JPEG 2000 code-block style of reserved bits")
    if transform > 1:
        unsupported(path, f"JPEG 2000 wavelet transform {transform}")
    coding.numres = nl + 1
    coding.xcb, coding.ycb = xcb + 2, ycb + 2
    coding.style = style
    coding.reversible = transform == 1
    if scoc & 1:
        if pos + 5 + nl + 1 > end:
            unreadable(path, "truncated precinct sizes")
        coding.precincts = [(b & 15, b >> 4)
                            for b in blob[pos + 5:pos + 6 + nl]]
        for r, (px, py) in enumerate(coding.precincts):
            if r and (px == 0 or py == 0):
                unreadable(path, "precinct of size 1 above resolution 0")
    else:
        coding.precincts = None


def _sqcd(blob, pos, end, quant, path):
    s = blob[pos]
    quant.style, quant.guard = s & 0x1F, s >> 5
    pos += 1
    if quant.style == 0:
        quant.steps = [(b >> 3, 0) for b in blob[pos:end]]
    elif quant.style in (1, 2):
        vals = struct.unpack(f">{(end - pos) // 2}H",
                             blob[pos:pos + (end - pos) // 2 * 2])
        quant.steps = [(v >> 11, v & 0x7FF) for v in vals]
        if quant.style == 1:
            e0, m0 = quant.steps[:1][0]
            quant.steps = [(e0, m0)] + [
                (max(e0 - (b - 1) // 3, 0), m0) for b in range(1, 97)]
    else:
        unreadable(path, f"quantization style {quant.style}")
    if not quant.steps:
        unreadable(path, "QCD/QCC without step sizes")


class _Codestream:
    def __init__(self, cs: bytes, path):
        self.path = path
        if not cs.startswith(J2K_SIGNATURE):
            unreadable(path, "JPEG 2000 codestream without SOC and SIZ")
        pos = 2
        self.tiles = {}           # tile → [tile-part (header, data)]
        self.tile_params = {}
        ppm = []
        zppt = {}                 # tile → the Zppt indices read
        main = None
        tparts = []               # (tile, data) in codestream order
        while pos + 4 <= len(cs):
            marker, length = struct.unpack_from(">HH", cs, pos)
            if marker == 0xFFD9:
                break
            seg_end = pos + 2 + length
            if seg_end > len(cs) or length < 2:
                unreadable(path, f"marker {marker:04X} past the end")
            body = pos + 4
            if marker == 0xFF51:
                self._siz(cs, body, seg_end)
                main = _Params(self.ncomp)
            elif main is None:
                unreadable(path, "codestream without SIZ")
            elif marker == 0xFF90:
                tile, psot, tpsot = struct.unpack_from(">HIB", cs, body)
                if tile >= self.ntx * self.nty:
                    unreadable(path, f"tile {tile} of {self.ntx * self.nty}")
                end = pos + psot if psot else len(cs)
                if psot == 0:
                    eoc = cs.rfind(b"\xff\xd9")
                    end = eoc if eoc > pos else len(cs)
                end = min(end, len(cs))
                if tile not in self.tile_params:
                    self.tile_params[tile] = _Params(self.ncomp, main)
                scope = self.tile_params[tile]
                q = seg_end
                ppt = []
                while q + 2 <= end:
                    m = struct.unpack_from(">H", cs, q)[0]
                    if m == 0xFF93:
                        q += 2
                        break
                    ln = struct.unpack_from(">H", cs, q + 2)[0]
                    if q + 2 + ln > end:
                        unreadable(path, "tile-part header past its end")
                    if m == 0xFF61:
                        z = cs[q + 4]
                        if z in zppt.setdefault(tile, set()):
                            unreadable(path, f"PPT index {z} of tile {tile} "
                                       "repeated")
                        zppt[tile].add(z)
                        ppt.append((z, cs[q + 5:q + 2 + ln]))
                    else:
                        self._marker(m, cs, q + 4, q + 2 + ln, scope)
                    q += 2 + ln
                else:
                    unreadable(path, "tile-part without SOD")
                ppt.sort(key=lambda t: t[0])
                tparts.append((tile, b"".join(d for _, d in ppt),
                               cs[q:end]))
                pos = end
                continue
            elif marker == 0xFF60:
                ppm.append((cs[body], cs[body + 1:seg_end]))
            else:
                self._marker(marker, cs, body, seg_end, main)
            pos = seg_end
        if main is None:
            unreadable(path, "codestream without SIZ")
        self.main = main
        if ppm:
            ppm.sort(key=lambda t: t[0])
            stream = b"".join(d for _, d in ppm)
            at, chunks = 0, []
            while at + 4 <= len(stream):
                n = struct.unpack_from(">I", stream, at)[0]
                chunks.append(stream[at + 4:at + 4 + n])
                at += 4 + n
            if len(chunks) < len(tparts):
                unreadable(path, "PPM with fewer headers than tile-parts")
            tparts = [(t, h, d) for (t, _, d), h in zip(tparts, chunks)]
        for tile, head, data in tparts:
            hd, dd = self.tiles.get(tile, (b"", b""))
            self.tiles[tile] = (hd + head, dd + data)
        self.packed = bool(ppm) or any(h for h, _ in self.tiles.values())

    def _siz(self, cs, a, b):
        (self.rsiz, self.x1, self.y1, self.x0, self.y0, self.tw, self.th,
         self.tx0, self.ty0, self.ncomp) = struct.unpack_from(">H8IH", cs, a)
        if b - a < 36 + 3 * self.ncomp or self.ncomp == 0:
            unreadable(self.path, "truncated SIZ")
        if self.rsiz & 0x4000:
            unsupported(self.path, "JPEG 2000 Part 15 (HT) codestream")
        self.prec, self.signed, self.dx, self.dy = [], [], [], []
        for c in range(self.ncomp):
            s, dx, dy = cs[a + 36 + 3 * c:a + 39 + 3 * c]
            self.prec.append((s & 0x7F) + 1)
            self.signed.append(bool(s & 0x80))
            self.dx.append(dx)
            self.dy.append(dy)
        if (self.x1 <= self.x0 or self.y1 <= self.y0 or not self.tw
                or not self.th or self.tx0 > self.x0 or self.ty0 > self.y0
                or self.tx0 + self.tw <= self.x0
                or self.ty0 + self.th <= self.y0
                or 0 in self.dx or 0 in self.dy or max(self.prec) > 38):
            unreadable(self.path, "invalid SIZ")
        self.ntx = -(-(self.x1 - self.tx0) // self.tw)
        self.nty = -(-(self.y1 - self.ty0) // self.th)

    def _comp(self, cs, a):
        if self.ncomp < 257:
            return cs[a], a + 1
        return struct.unpack_from(">H", cs, a)[0], a + 2

    def _marker(self, m, cs, a, b, scope):
        path = self.path
        if m == 0xFF52:                                   # COD
            scod = cs[a]
            scope.sop, scope.eph = bool(scod & 2), bool(scod & 4)
            prog, layers, mct = struct.unpack_from(">BHB", cs, a + 1)
            if prog > 4 or layers == 0:
                unreadable(path, "invalid COD")
            scope.prog, scope.layers, scope.mct = prog, layers, mct
            coding = _Coding()
            _spcod(cs, a + 5, b, scod, coding, path)
            for c in range(self.ncomp):
                if not scope.cod_set[c]:
                    scope.cod[c] = copy.deepcopy(coding)
        elif m == 0xFF53:                                 # COC
            c, p = self._comp(cs, a)
            if c >= self.ncomp:
                unreadable(path, "COC of a missing component")
            coding = _Coding()
            _spcod(cs, p + 1, b, cs[p], coding, path)
            scope.cod[c], scope.cod_set[c] = coding, True
        elif m == 0xFF5C:                                 # QCD
            quant = _Quant()
            _sqcd(cs, a, b, quant, path)
            for c in range(self.ncomp):
                if not scope.quant_set[c]:
                    scope.quant[c] = copy.deepcopy(quant)
        elif m == 0xFF5D:                                 # QCC
            c, p = self._comp(cs, a)
            if c >= self.ncomp:
                unreadable(path, "QCC of a missing component")
            quant = _Quant()
            _sqcd(cs, p, b, quant, path)
            scope.quant[c], scope.quant_set[c] = quant, True
        elif m == 0xFF5E:                                 # RGN
            c, p = self._comp(cs, a)
            if c >= self.ncomp or cs[p] != 0:
                unreadable(path, "invalid RGN")
            scope.roi[c] = cs[p + 1]
        elif m == 0xFF5F:                                 # POC
            wide = self.ncomp >= 257
            size = 9 if wide else 7
            scope.poc = []
            for q in range(a, b - size + 1, size):
                if wide:
                    rs, cs0, le, re, ce, pp = struct.unpack_from(">BHHBHB",
                                                                 cs, q)
                else:
                    rs, cs0, le, re, ce, pp = struct.unpack_from(">BBHBBB",
                                                                 cs, q)
                if pp > 4:
                    unreadable(path, "invalid POC")
                scope.poc.append((rs, cs0, le, re, ce or 256, pp))
        elif m in (0xFF55, 0xFF57, 0xFF58, 0xFF63, 0xFF64):
            pass                                          # TLM PLM PLT CRG COM
        elif m in (0xFF50, 0xFF59):
            unsupported(path, "JPEG 2000 Part 15 (HT) codestream")
        elif m >> 8 != 0xFF:
            unreadable(path, "corrupt JPEG 2000 marker segment")


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------- geometry
class _Tile:
    """One tile's tables for `j2k_decode_tile`."""

    def __init__(self, cs: _Codestream, p: int, params: _Params):
        self.cs, self.params = cs, params
        tx, ty = p % cs.ntx, p // cs.ntx
        self.x0 = max(cs.tx0 + tx * cs.tw, cs.x0)
        self.y0 = max(cs.ty0 + ty * cs.th, cs.y0)
        self.x1 = min(cs.tx0 + (tx + 1) * cs.tw, cs.x1)
        self.y1 = min(cs.ty0 + (ty + 1) * cs.th, cs.y1)
        self.comps, bands, steps, precs, cblks = [], [], [], [], []
        self.res = []             # per comp: [(x0, y0, x1, y1, pw, ph, PPx, PPy)]
        self.prec_index = {}      # (c, r, precno) → row of precs
        offset = 0
        for c in range(cs.ncomp):
            cod, q = params.cod[c], params.quant[c]
            tcx0, tcy0 = _cdiv(self.x0, cs.dx[c]), _cdiv(self.y0, cs.dy[c])
            tcx1, tcy1 = _cdiv(self.x1, cs.dx[c]), _cdiv(self.y1, cs.dy[c])
            nl = cod.numres - 1
            w, h = tcx1 - tcx0, tcy1 - tcy0
            row = [cod.numres, cod.style, int(cod.reversible),
                   params.roi[c], offset, w, h,
                   int(params.sop) | int(params.eph) << 1 if c == 0 else 0]
            resl = []
            for r in range(cod.numres):
                lv = nl - r
                rx0, ry0 = _cdiv(tcx0, 1 << lv), _cdiv(tcy0, 1 << lv)
                rx1, ry1 = _cdiv(tcx1, 1 << lv), _cdiv(tcy1, 1 << lv)
                px, py = cod.precincts[r] if cod.precincts else (15, 15)
                tlx, tly = (rx0 >> px) << px, (ry0 >> py) << py
                brx, bry = _cdiv(rx1, 1 << px) << px, _cdiv(ry1, 1 << py) << py
                pw = 0 if rx0 == rx1 else (brx - tlx) >> px
                ph = 0 if ry0 == ry1 else (bry - tly) >> py
                resl.append((rx0, ry0, rx1, ry1, pw, ph, px, py))
                row += [rx0, ry0, rx1, ry1]
                if r == 0:
                    cbgx, cbgy, cbgw, cbgh = tlx, tly, px, py
                    bandnos = [0]
                else:
                    cbgx, cbgy, cbgw, cbgh = _cdiv(tlx, 2), _cdiv(tly, 2), \
                        px - 1, py - 1
                    bandnos = [1, 2, 3]
                xcb, ycb = min(cod.xcb, cbgw), min(cod.ycb, cbgh)
                band_rows = []
                for bno in bandnos:
                    if r == 0:
                        bx0, by0, bx1, by1 = rx0, ry0, rx1, ry1
                        ox = oy = 0
                    else:
                        xob, yob = bno & 1, bno >> 1
                        bx0 = _cdiv(tcx0 - (xob << lv), 1 << (lv + 1))
                        by0 = _cdiv(tcy0 - (yob << lv), 1 << (lv + 1))
                        bx1 = _cdiv(tcx1 - (xob << lv), 1 << (lv + 1))
                        by1 = _cdiv(tcy1 - (yob << lv), 1 << (lv + 1))
                        prev = resl[r - 1]
                        ox = prev[2] - prev[0] if xob else 0
                        oy = prev[3] - prev[1] if yob else 0
                    si = 0 if r == 0 else 3 * (r - 1) + bno
                    if q.style == 0 or q.style == 2:
                        if si >= len(q.steps):
                            unreadable(cs.path, "QCD/QCC with too few step "
                                       "sizes")
                    expn, mant = q.steps[min(si, len(q.steps) - 1)]
                    gain = 0 if not cod.reversible else (0, 1, 1, 2)[bno]
                    rb = cs.prec[c] + gain
                    step = np.float32((1.0 + mant / 2048.0)
                                      * math.pow(2.0, rb - expn))
                    band_rows.append(len(bands))
                    bands.append([c, r, bno, bx0, by0, bx1, by1,
                                  expn + q.guard - 1, ox, oy])
                    steps.append(step)
                for k in range(pw * ph):
                    pr = [c, r, len(bandnos)]
                    for bi in band_rows:
                        bx0, by0, bx1, by1 = bands[bi][3:7]
                        sx = cbgx + (k % pw) * (1 << cbgw)
                        sy = cbgy + (k // pw) * (1 << cbgh)
                        x0, y0 = max(sx, bx0), max(sy, by0)
                        x1 = min(sx + (1 << cbgw), bx1)
                        y1 = min(sy + (1 << cbgh), by1)
                        tl_x, tl_y = (x0 >> xcb) << xcb, (y0 >> ycb) << ycb
                        br_x = _cdiv(x1, 1 << xcb) << xcb
                        br_y = _cdiv(y1, 1 << ycb) << ycb
                        cw = max(0, (br_x - tl_x) >> xcb)
                        ch = max(0, (br_y - tl_y) >> ycb)
                        pr += [bi, cw, ch, len(cblks)]
                        for j in range(cw * ch):
                            cx = tl_x + (j % cw) * (1 << xcb)
                            cy = tl_y + (j // cw) * (1 << ycb)
                            cblks.append([bi, max(cx, x0), max(cy, y0),
                                          min(cx + (1 << xcb), x1),
                                          min(cy + (1 << ycb), y1)])
                    pr += [0] * (15 - len(pr))
                    self.prec_index[(c, r, k)] = len(precs)
                    precs.append(pr)
            row += [0] * (140 - len(row))
            self.comps.append(row)
            self.res.append(resl)
            offset += w * h
        self.size = offset
        self.bands = np.array(bands, np.int32).reshape(-1, 10)
        self.steps = np.array(steps, np.float32)
        self.precs = np.array(precs, np.int32).reshape(-1, 15)
        self.cblks = np.array(cblks, np.int32).reshape(-1, 5)

    # -------------------------------------------------------- packet order
    def packets(self):
        cs, prm = self.cs, self.params
        pocs = prm.poc or [(0, 0, prm.layers, MAX_RES, cs.ncomp, prm.prog)]
        seen = set()
        out = []
        for rs, c0, le, re, ce, prog in pocs:
            le, ce = min(le, prm.layers), min(ce, cs.ncomp)
            for c, r, k, lay in self._order(PROGRESSIONS[prog], rs, re, c0,
                                            ce, le):
                key = (c, r, k, lay)
                if key in seen:
                    continue
                seen.add(key)
                out.append((self.prec_index[(c, r, k)], lay))
        return np.array(out, np.int32).reshape(-1, 2)

    def _nres(self, c):
        return len(self.res[c])

    def _steps(self, comps):
        dx = dy = 0
        for c in comps:
            nr = self._nres(c)
            for r, res in enumerate(self.res[c]):
                lv = nr - 1 - r
                sx = self.cs.dx[c] << (res[6] + lv)
                sy = self.cs.dy[c] << (res[7] + lv)
                dx = sx if not dx else min(dx, sx)
                dy = sy if not dy else min(dy, sy)
        return dx, dy

    def _at(self, c, r, x, y):
        """The precinct of component c, resolution r at reference-grid
        point (x, y), or None (OpenJPEG's pi.c tests)."""
        cs = self.cs
        rx0, ry0, rx1, ry1, pw, ph, px, py = self.res[c][r]
        lv = self._nres(c) - 1 - r
        dxc, dyc = cs.dx[c], cs.dy[c]
        trx0, try0 = _cdiv(self.x0, dxc << lv), _cdiv(self.y0, dyc << lv)
        trx1, try1 = _cdiv(self.x1, dxc << lv), _cdiv(self.y1, dyc << lv)
        rpx, rpy = px + lv, py + lv
        if not (y % (dyc << rpy) == 0
                or (y == self.y0 and (try0 << lv) % (1 << rpy))):
            return None
        if not (x % (dxc << rpx) == 0
                or (x == self.x0 and (trx0 << lv) % (1 << rpx))):
            return None
        if pw == 0 or ph == 0 or trx0 == trx1 or try0 == try1:
            return None
        prci = (_cdiv(x, dxc << lv) >> px) - (trx0 >> px)
        prcj = (_cdiv(y, dyc << lv) >> py) - (try0 >> py)
        return prci + prcj * pw

    def _grid(self, comps):
        dx, dy = self._steps(comps)
        if not dx or not dy:
            return
        y = self.y0
        while y < self.y1:
            x = self.x0
            while x < self.x1:
                yield x, y
                x += dx - x % dx
            y += dy - y % dy

    def _order(self, prog, rs, re, c0, ce, le):
        comps = range(c0, ce)
        if prog in ("LRCP", "RLCP"):
            for a in range(le if prog == "LRCP" else min(re, MAX_RES)):
                for b in range(min(re, MAX_RES) if prog == "LRCP" else le):
                    lay, r = (a, b) if prog == "LRCP" else (b, a)
                    if r < rs:
                        continue
                    for c in comps:
                        if r >= self._nres(c):
                            continue
                        pw, ph = self.res[c][r][4:6]
                        for k in range(pw * ph):
                            yield c, r, k, lay
        elif prog == "RPCL":
            for r in range(rs, min(re, MAX_RES)):
                for x, y in self._grid(comps):
                    for c in comps:
                        if r >= self._nres(c):
                            continue
                        k = self._at(c, r, x, y)
                        if k is not None:
                            for lay in range(le):
                                yield c, r, k, lay
        elif prog == "PCRL":
            for x, y in self._grid(comps):
                for c in comps:
                    for r in range(rs, min(re, self._nres(c))):
                        k = self._at(c, r, x, y)
                        if k is not None:
                            for lay in range(le):
                                yield c, r, k, lay
        else:                                             # CPRL
            for c in comps:
                for x, y in self._grid([c]):
                    for r in range(rs, min(re, self._nres(c))):
                        k = self._at(c, r, x, y)
                        if k is not None:
                            for lay in range(le):
                                yield c, r, k, lay


# ------------------------------------------------------------------ decode
def _decode_tile(cs: _Codestream, p: int, path) -> list:
    """Tile p → per component (h, w) int32 samples, level-shifted and
    clipped to their precision."""
    params = cs.tile_params.get(p, cs.main)
    tile = _Tile(cs, p, params)
    head, data = cs.tiles.get(p, (b"", b""))
    out = np.zeros(max(tile.size, 1), np.int32)
    packets = tile.packets()
    if cs.packed and not head:
        unreadable(path, f"tile {p} without its packed packet headers")
    code = native.j2k_decode_tile(
        data, head, np.array(tile.comps, np.int32), tile.bands, tile.steps,
        tile.precs, tile.cblks, packets, out)
    if code == -1:
        unreadable(path, "JPEG 2000 tile whose packets run past its data "
                   "(a truncated codestream)")
    if code < 0:
        unreadable(path, f"JPEG 2000 tile {p} (code {code})")
    planes = []
    for c, row in enumerate(tile.comps):
        off, w, h = row[4], row[5], row[6]
        a = out[off:off + w * h].reshape(h, w)
        planes.append(a if params.cod[c].reversible else a.view(np.float32))
    if params.mct:
        if cs.ncomp < 3 or len({pl.shape for pl in planes[:3]}) != 1:
            unreadable(path, "MCT over components of different sizes")
        if params.cod[0].reversible:
            y, u, v = (pl.astype(np.int64) for pl in planes[:3])
            g = y - ((u + v) >> 2)
            planes[:3] = [(v + g).astype(np.int32), g.astype(np.int32),
                          (u + g).astype(np.int32)]
        else:
            y, u, v = (pl.astype(np.float32) for pl in planes[:3])
            f = np.float32
            r = y + v * f(1.402)
            g = y - u * f(0.34413) - v * f(0.71414)
            b = y + u * f(1.772)
            planes[:3] = [r, g, b]
    for c, pl in enumerate(planes):
        prec, signed = cs.prec[c], cs.signed[c]
        lo, hi = (-(1 << (prec - 1)), (1 << (prec - 1)) - 1) if signed \
            else (0, (1 << prec) - 1)
        shift = 0 if signed else 1 << (prec - 1)
        if pl.dtype == np.float32:
            big = pl > np.float32(2 ** 31 - 1)
            small = pl < -np.float32(2 ** 31)
            v = np.rint(np.where(big | small, 0, pl)).astype(np.int64)
            v = np.clip(v + shift, lo, hi)
            v[big], v[small] = hi, lo
        else:
            v = np.clip(pl.astype(np.int64) + shift, lo, hi)
        planes[c] = v.astype(np.int32)
    return planes


def _components(cs: _Codestream, path) -> list:
    """Every component of the whole image, (h, w) int32."""
    out = []
    for c in range(cs.ncomp):
        w = _cdiv(cs.x1, cs.dx[c]) - _cdiv(cs.x0, cs.dx[c])
        h = _cdiv(cs.y1, cs.dy[c]) - _cdiv(cs.y0, cs.dy[c])
        out.append(np.zeros((h, w), np.int32))
    for p in range(cs.ntx * cs.nty):
        if p not in cs.tiles:
            continue
        planes = _decode_tile(cs, p, path)
        tile = (max(cs.tx0 + (p % cs.ntx) * cs.tw, cs.x0),
                max(cs.ty0 + (p // cs.ntx) * cs.th, cs.y0))
        for c, pl in enumerate(planes):
            x = _cdiv(tile[0], cs.dx[c]) - _cdiv(cs.x0, cs.dx[c])
            y = _cdiv(tile[1], cs.dy[c]) - _cdiv(cs.y0, cs.dy[c])
            out[c][y:y + pl.shape[0], x:x + pl.shape[1]] = pl
    return out


def _apply_jp2(jp2: _Jp2, comps, path):
    """pclr + cmap, then cdef (OpenJPEG's jp2.c) → components."""
    if jp2.pclr is not None and jp2.cmap is not None:
        table = jp2.pclr[0]
        new = []
        for cmp, mtyp, pcol in jp2.cmap:
            if cmp >= len(comps):
                unreadable(path, "cmap of a missing component")
            if mtyp == 0:
                new.append(comps[cmp])
            else:
                if pcol >= table.shape[1]:
                    unreadable(path, "cmap of a missing palette column")
                idx = np.clip(comps[cmp], 0, table.shape[0] - 1)
                new.append(table[idx, pcol].astype(np.int32))
        comps = new
    if jp2.cdef:
        info = [list(d) for d in jp2.cdef]
        comps = list(comps)
        for i, (cn, typ, asoc) in enumerate(info):
            if cn >= len(comps) or asoc in (0, 65535):
                continue
            acn = asoc - 1
            if acn >= len(comps):
                continue
            if cn != acn and typ == 0:
                comps[cn], comps[acn] = comps[acn], comps[cn]
                for d in info[i + 1:]:
                    if d[0] == cn:
                        d[0] = acn
                    elif d[0] == acn:
                        d[0] = cn
    return comps


def read_jpeg2000(path, mode: str = "unchanged") -> np.ndarray:
    """The image as `cv2.imread` gives it, in RGB(A) order: mode
    "unchanged" (IMREAD_UNCHANGED): uint8 for 8-bit samples, uint16 for
    9-16 bits (unscaled), (H, W), (H, W, 3) or (H, W, 4); "color" /
    "grey": uint8 (H, W, 3) / (H, W), samples shifted to 8 bits."""
    if mode not in ("unchanged", "color", "grey"):
        raise ValueError(f"unknown read mode {mode!r}")
    blob = Path(path).read_bytes()
    jp2 = None
    if blob.startswith(JP2_SIGNATURE):
        jp2 = _Jp2(blob, path)
        cs = _Codestream(jp2.codestream, path)
        space = {SRGB: "srgb", GREY: "grey", SYCC: "sycc"}.get(
            jp2.enumcs, "srgb" if jp2.enumcs in (0,) else "other")
    else:
        cs = _Codestream(blob, path)
        space = "srgb"
    # cv2's readHeader, on the codestream's components
    check_size(path, cs.x1 - cs.x0, cs.y1 - cs.y0)
    if not 1 <= cs.ncomp <= 4:
        unreadable(path, f"JPEG 2000 of {cs.ncomp} components")
    if any(cs.signed):
        unreadable(path, "JPEG 2000 of signed components")
    max_prec = max(cs.prec)
    if max_prec < 8:
        unreadable(path, f"JPEG 2000 of {max_prec}-bit samples")
    depth = 8 if max_prec == 8 else 16 if max_prec <= 16 else 32
    channels = cs.ncomp if mode == "unchanged" else \
        3 if mode == "color" else 1
    if mode != "unchanged":
        depth = 8
    if channels == 2:
        unreadable(path, "JPEG 2000 of two components read unchanged")
    if depth == 32:
        unreadable(path, f"JPEG 2000 of {max_prec}-bit samples read "
                   "unchanged")
    if space == "other":
        unreadable(path, f"JPEG 2000 colour space {jp2.enumcs}")
    if any(d != 1 for d in cs.dx + cs.dy) or cs.x0 or cs.y0:
        unreadable(path, "JPEG 2000 with subsampled components or an "
                   "image offset")
    comps = _components(cs, path)
    if jp2 is not None:
        comps = _apply_jp2(jp2, comps, path)
    # cv2 takes the type and the shift from the codestream's depths, and
    # casts (wraps) what a palette's deeper entries give
    shift = max(0, max_prec - depth)
    n = len(comps)
    dtype = np.uint8 if depth == 8 else np.uint16

    def take(*idx):
        return np.stack([comps[i] >> shift for i in idx], -1) \
            .astype(dtype)
    if space == "srgb":
        if channels == 1:
            if n <= 2:
                return take(0)[..., 0]
            # cvtColor(COLOR_BGR2GRAY) of the cast samples
            r, g, b = (take(i)[..., 0].astype(np.int64) for i in range(3))
            return ((b * jpeg.CVT_GREY_B + g * jpeg.CVT_GREY_G
                     + r * jpeg.CVT_GREY_R + 16384) >> 15).astype(dtype)
        if channels == 3 and n in (3, 4):
            return take(0, 1, 2)
        if channels == 4 and n == 4:
            return take(0, 1, 2, 3)
        unreadable(path, f"JPEG 2000 sRGB of {n} components read as "
                   f"{channels} channels")
    if space == "grey":
        if channels in (1, 3):
            out = take(*[0] * channels)
            return out[..., 0] if channels == 1 else out
        if channels == 4 and n == 2:
            return take(0, 0, 0, 1)
        unreadable(path, f"JPEG 2000 greyscale of {n} components read as "
                   f"{channels} channels")
    # sYCC
    if channels == 1:
        return take(0)[..., 0]
    if channels == 3 and n == 3:
        return _sycc(comps, shift, dtype, path)
    unreadable(path, f"JPEG 2000 sYCC of {n} components read as "
               f"{channels} channels")


def _sycc(comps, shift, dtype, path):
    """cvtColor(COLOR_YUV2BGR) of the shifted Y, Cb, Cr samples: OpenCV's
    14-bit fixed-point weights (2.032, -0.395, -0.581, 1.140), the
    chroma centred on half the range, saturated."""
    top = np.iinfo(dtype).max
    y, u, v = (comps[i].astype(np.int64) >> shift for i in range(3))
    u, v = u - (top + 1) // 2, v - (top + 1) // 2
    r = y + ((v * 18678 + 8192) >> 14)
    g = y + ((u * -6472 + v * -9519 + 8192) >> 14)
    b = y + ((u * 33292 + 8192) >> 14)
    return np.clip(np.stack([r, g, b], -1), 0, top).astype(dtype)


# ---------------------------------------------------------------- writing
OPENJPEG_COMMENT = b"Created by OpenJPEG version 2.5.3"
# OpenCV's encoder: 6 resolutions, so OpenJPEG refuses a side under 2^5
MIN_SIDE = 32
RATE = 4.0


def _marker(code: int, body: bytes) -> bytes:
    return struct.pack(">HH", code, len(body) + 2) + body


def _jp2_box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def encode_jp2(image: np.ndarray, path="image") -> bytes:
    """A JP2 file of (H, W), (H, W, 3) RGB or (H, W, 4) RGBA uint8 or
    uint16 samples, byte for byte what `cv2.imwrite(".jp2")` writes
    (OpenCV over OpenJPEG 2.5.3 at its defaults: lossless 5/3, 5 levels,
    64x64 code-blocks, one layer in LRCP order, no MCT, the rate capped at
    a compression of 4 over the raw samples). Raises ValueError where cv2
    raises (other channel counts or types), `ImwriteFailed` with the JP2
    header boxes left where OpenJPEG refuses after writing them (a side
    under 32 pixels)."""
    image = np.asarray(image)
    if image.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"{path}: JPEG 2000 takes 8- or 16-bit samples, "
                         f"not {image.dtype}")
    comps = image[..., None] if image.ndim == 2 else image
    if comps.ndim != 3 or comps.shape[2] not in (1, 3, 4):
        raise ValueError(f"{path}: JPEG 2000 takes 1, 3 or 4 channels, not "
                         f"shape {image.shape}")
    h, w, nc = comps.shape
    prec = 8 * image.itemsize
    # the JP2 header boxes as OpenJPEG writes them for OpenCV
    ihdr = struct.pack(">IIHBBBB", h, w, nc, prec - 1, 7, 0, 0)
    colr = struct.pack(">BBBI", 1, 0, 0, SRGB if nc > 1 else GREY)
    jp2h = _jp2_box(b"ihdr", ihdr) + _jp2_box(b"colr", colr)
    if nc == 4:
        cdef = struct.pack(">H", 4) + b"".join(
            struct.pack(">HHH", i, 0, i + 1) for i in range(3)) \
            + struct.pack(">HHH", 3, 1, 0)
        jp2h += _jp2_box(b"cdef", cdef)
    head = JP2_SIGNATURE + _jp2_box(b"ftyp", b"jp2 \0\0\0\0jp2 ") \
        + _jp2_box(b"jp2h", jp2h)
    if w < MIN_SIDE or h < MIN_SIDE:
        raise ImwriteFailed(f"{path}: OpenJPEG refuses a {w}x{h} image: 5 "
                            "wavelet levels need at least 32 pixels a side",
                            left=head)
    siz = struct.pack(">H8IH", 0, w, h, 0, 0, w, h, 0, 0, nc) \
        + bytes([prec - 1, 1, 1]) * nc
    cod = bytes([0, 0, 0, 1, 0, 5, 4, 4, 0, 1])
    gains = [0] + [1, 1, 2] * 5
    qcd = bytes([0x40]) + bytes((prec + g) << 3 for g in gains)
    main = b"\xff\x4f" + _marker(0xFF51, siz) + _marker(0xFF52, cod) \
        + _marker(0xFF5C, qcd) \
        + _marker(0xFF64, struct.pack(">H", 1) + OPENJPEG_COMMENT)
    # opj_j2k_update_rates: the raw bits over the rate, less what the
    # stream holds when the tile starts (the boxes, the jp2c box's header
    # and the main header), at least 30 bytes; float32 as OpenJPEG
    told = np.float32(len(head) + 8 + len(main))
    rate = np.float32(np.float32(float(nc * prec) * w * h
                                 / float(np.float32(RATE) * np.float32(8.0))))
    rate = np.float32(rate - told)
    if rate < np.float32(30.0):
        rate = np.float32(30.0)
    maxlen = int(math.ceil(float(rate)))
    samples = np.ascontiguousarray(np.moveaxis(comps, 2, 0), np.int32)
    packets = native.j2k_encode_tile(samples, prec, maxlen)
    sot = struct.pack(">HIBB", 0, 12 + 2 + len(packets), 0, 1)
    codestream = main + _marker(0xFF90, sot) + b"\xff\x93" + packets \
        + b"\xff\xd9"
    return head + _jp2_box(b"jp2c", codestream)


def write_jp2(path, image: np.ndarray) -> None:
    data = encode_jp2(image, path)
    Path(path).write_bytes(data)
