"""AVIF still images, read as cv2 reads them: OpenCV's grfmt_avif on
libavif 1.4 (with its bundled libyuv) over libaom, sample for sample.

The container is HEIF (ISO/IEC 23008-12) in ISOBMFF boxes: `ftyp` (major
or compatible brand `avif`/`avis`, as libavif's
avifPeekCompatibleFileType tests), then `meta` with `hdlr` `pict`,
`pitm`, `iinf`/`infe`, `iloc` (versions 0-2, construction methods 0 and
1 through `idat`), `iprp` (`ipco` properties bound by `ipma`: `av1C`,
`ispe`, `pixi`, `colr` nclx or ICC, `auxC`, `irot`, `imir`, `clap`,
`a1lx`, `lsel`) and `iref` (`auxl`, `prem`, `dimg`). The primary item's
AV1 OBUs decode in `native/av1.cc` (superres upscaling and film grain
synthesis included, as libaom hands libavif the frame); an item that is
the primary's `auxl` with the alpha URN is its alpha plane. A `grid`
derived item (the primary, or its alpha) is its `dimg` tiles decoded one
by one, checked as libavif checks them and stitched (`decode_grid`).

cv2 returns libavif's planes without applying `irot`, `imir` or `clap`
(libavif reports them and does not apply them; cv2 ignores the report)
and reads no EXIF orientation from AVIF. "unchanged" gives 8-bit or,
for 10- and 12-bit files, uint16 holding the raw 0-1023 or 0-4095
values; 3 channels, or 4 with alpha; a monochrome file 1 channel (with
alpha, cv2 fails: None). "color" is libavif's conversion to 8-bit RGB
(alpha dropped, never multiplied in) and "grey" cvtColor's BGR2GRAY of
that; of a monochrome file both are its Y plane (a deeper one scaled to
8 bits by cv2's convertTo).

libavif converts YUV to RGB through libyuv where libyuv has the matrix
(BT.601, BT.709, BT.2020 NCL; full and limited range; 8-bit and, to
8-bit RGB, 10- and 12-bit 4:2:0 / 4:2:2 / 4:4:4), with libyuv's
bilinear chroma upsampling ("Filter" functions) and its 6-bit fixed-point
YuvPixel; otherwise (identity/GBR, monochrome, other matrices, 16-bit
output) through its own float path (avifImageYUVToRGBAnySlow...).
`yuv_to_rgb` below holds both, as this module's tests pin them to cv2.

Refused by name (UnsupportedImage): image sequences (an `avis` file
with a track), layered images (`lsel`, spatial layers), and an `ispe`
other than the AV1 frame's size (libavif scales the frame to it). A
file cv2 cannot read (truncated boxes, a broken `iloc`, a bad OBU, a
monochrome image with alpha, an `avis` brand without a track,
large-scale tile, `a1lx` on a single-layer item, a grid libavif refuses
or whose `ispe` is not its output size) raises UnreadableImage.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import native
from .errors import check_size, unreadable, unsupported
from .jpeg import cvt_grey

BRANDS = (b"avif", b"avis")
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")
# native/av1.cc's error codes
AV1_REFUSED = {-6: "an inter frame", -7: "layers (a layered AV1 stream)"}
LARGE_SCALE_TILE = -4        # libaom (so libavif, so cv2) fails too


def is_avif(head: bytes) -> bool:
    """avifPeekCompatibleFileType: an `ftyp` box first whose major brand
    or one of whose compatible brands is `avif` or `avis`."""
    if len(head) < 16 or head[4:8] != b"ftyp":
        return False
    size = struct.unpack(">I", head[:4])[0]
    if size < 16 or size % 4:
        return False
    body = head[8:min(size, len(head))]
    brands = [body[:4]] + [body[i:i + 4] for i in range(8, len(body) - 3, 4)]
    return any(b in BRANDS for b in brands)


@dataclass
class Item:
    id: int
    type: bytes = b""
    props: list = field(default_factory=list)
    extents: list = field(default_factory=list)
    method: int = 0


def _boxes(data: bytes, start: int, end: int, path):
    """(type, body start, body end) of each box in data[start:end]."""
    pos = start
    while pos < end:
        if end - pos < 8:
            unreadable(path, "truncated box header")
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        hdr = 8
        if size == 1:
            if end - pos < 16:
                unreadable(path, "truncated box header")
            size = struct.unpack(">Q", data[pos + 8:pos + 16])[0]
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            unreadable(path, f"box {kind!r} runs past its parent")
        yield kind, pos + hdr, pos + size
        pos += size


class _Reader:
    def __init__(self, data: bytes, pos: int, end: int, path):
        self.d, self.p, self.end, self.path = data, pos, end, path

    def take(self, n: int) -> bytes:
        if self.p + n > self.end:
            unreadable(self.path, "truncated box")
        b = self.d[self.p:self.p + n]
        self.p += n
        return b

    def u(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big") if n else 0

    def full(self) -> tuple:
        v = self.u(1)
        return v, self.u(3)


@dataclass
class Container:
    items: dict
    primary: int
    refs: list          # (type, from, [to...])
    idat: bytes
    major: bytes
    has_moov: bool


def parse(data: bytes, path) -> Container:
    major, meta, moov = b"", None, False
    for kind, s, e in _boxes(data, 0, len(data), path):
        if kind == b"ftyp":
            major = data[s:s + 4]
        elif kind == b"meta":
            meta = (s, e)
        elif kind == b"moov":
            moov = True
    if meta is None:
        if moov:
            unsupported(path, "AVIF image sequence")
        unreadable(path, "no meta box")
    items, props, refs, idat, primary, handler = {}, [], [], b"", None, b""
    ipma = []
    r = _Reader(data, meta[0], meta[1], path)
    r.full()
    for kind, s, e in _boxes(data, r.p, meta[1], path):
        b = _Reader(data, s, e, path)
        if kind == b"hdlr":
            b.full(); b.u(4)
            handler = b.take(4)
        elif kind == b"pitm":
            v, _ = b.full()
            primary = b.u(2 if v == 0 else 4)
        elif kind == b"iinf":
            v, _ = b.full()
            b.u(2 if v == 0 else 4)
            for k2, s2, e2 in _boxes(data, b.p, e, path):
                if k2 != b"infe":
                    continue
                ib = _Reader(data, s2, e2, path)
                iv, _ = ib.full()
                if iv < 2:
                    continue
                iid = ib.u(2 if iv == 2 else 4)
                ib.u(2)
                items.setdefault(iid, Item(iid)).type = ib.take(4)
        elif kind == b"iloc":
            v, _ = b.full()
            x = b.u(1)
            off_size, len_size = x >> 4, x & 15
            x = b.u(1)
            base_size, idx_size = x >> 4, (x & 15) if v in (1, 2) else 0
            count = b.u(2 if v < 2 else 4)
            for _ in range(count):
                iid = b.u(2 if v < 2 else 4)
                method = b.u(2) & 15 if v in (1, 2) else 0
                b.u(2)
                base = b.u(base_size)
                it = items.setdefault(iid, Item(iid))
                it.method = method
                for _ in range(b.u(2)):
                    b.u(idx_size)
                    off = b.u(off_size)
                    ln = b.u(len_size)
                    it.extents.append((base + off, ln))
        elif kind == b"idat":
            idat = data[s:e]
        elif kind == b"iprp":
            for k2, s2, e2 in _boxes(data, s, e, path):
                if k2 == b"ipco":
                    props = [(k3, data[s3:e3]) for k3, s3, e3 in _boxes(data, s2, e2, path)]
                elif k2 == b"ipma":
                    pb = _Reader(data, s2, e2, path)
                    v, flags = pb.full()
                    for _ in range(pb.u(4)):
                        iid = pb.u(2 if v < 1 else 4)
                        assoc = []
                        for _ in range(pb.u(1)):
                            x = pb.u(2 if flags & 1 else 1)
                            mask = 0x7FFF if flags & 1 else 0x7F
                            assoc.append(x & mask)
                        ipma.append((iid, assoc))
        elif kind == b"iref":
            v, _ = b.full()
            for k2, s2, e2 in _boxes(data, b.p, e, path):
                rb = _Reader(data, s2, e2, path)
                n = 2 if v == 0 else 4
                frm = rb.u(n)
                refs.append((k2, frm, [rb.u(n) for _ in range(rb.u(2))]))
    if handler != b"pict":
        unreadable(path, "meta handler is not pict")
    if primary is None or primary not in items:
        if moov:
            unsupported(path, "AVIF image sequence")
        unreadable(path, "no primary item")
    for iid, assoc in ipma:
        it = items.setdefault(iid, Item(iid))
        for idx in assoc:
            if idx:
                if idx > len(props):
                    unreadable(path, "ipma names a missing property")
                it.props.append(props[idx - 1])
    return Container(items, primary, refs, idat, major, moov)


def item_data(c: Container, it: Item, data: bytes, path) -> bytes:
    src = c.idat if it.method == 1 else data
    if it.method not in (0, 1):
        unreadable(path, f"iloc construction method {it.method}")
    out = b""
    for off, ln in it.extents:
        if ln == 0:
            ln = len(src) - off
        if off + ln > len(src):
            unreadable(path, "item data past the end of the file")
        out += src[off:off + ln]
    return out


def prop(it: Item, kind: bytes):
    for k, body in it.props:
        if k == kind:
            return body
    return None


def decode_item(c: Container, it: Item, data: bytes, path) -> tuple:
    """(info, planes) of an av01 item."""
    if prop(it, b"lsel") is not None:
        unsupported(path, "layered AVIF image (lsel)")
    obus = item_data(c, it, data, path)
    code, info, planes, _ = native.av1_decode(obus)
    if code in AV1_REFUSED:
        unsupported(path, f"AVIF with {AV1_REFUSED[code]}")
    if code == LARGE_SCALE_TILE:
        unreadable(path, "large-scale tile (a tile list OBU)")
    if code != 0:
        unreadable(path, f"AV1 bitstream error {code}")
    if prop(it, b"a1lx") is not None:
        unreadable(path, "a1lx on a single-layer AV1 item")
    return info, planes


# what libavif requires of every tile of a grid to be the same
TILE_KEYS = ("width", "height", "bit_depth", "mono", "ssx", "ssy", "cp",
             "tc", "mc", "full_range")


def decode_image(c: Container, it: Item, data: bytes, path) -> tuple:
    """(info, planes) of an av01 item or a grid of them."""
    return decode_grid(c, it, data, path) if it.type == b"grid" \
        else decode_item(c, it, data, path)


def decode_grid(c: Container, it: Item, data: bytes, path) -> tuple:
    """A `grid` derived item as libavif reconstructs it: the ImageGrid
    payload (version 0; rows and columns; the output size in 16 or 32
    bits), its `dimg` tiles in order, each an av01 item decoded alone,
    all of one size and format; the tiles must cover the output, the last
    row and column must reach into it, and (MIAF) a tile is at least 64
    samples a side, of even width under 4:2:0 / 4:2:2 and even height
    under 4:2:0, as is the output. The planes are stitched and cropped
    to the output size. What libavif refuses is UnreadableImage."""
    desc = item_data(c, it, data, path)
    if len(desc) < 8 or desc[0] != 0:
        unreadable(path, "grid item of another version or truncated")
    rows, cols = desc[2] + 1, desc[3] + 1
    wide = desc[1] & 1
    if len(desc) < (12 if wide else 8):
        unreadable(path, "truncated grid item")
    ow, oh = struct.unpack(">II" if wide else ">HH", desc[4:12 if wide else 8])
    ids = [t for kind, frm, to in c.refs if kind == b"dimg" and frm == it.id
           for t in to]
    if len(ids) != rows * cols:
        unreadable(path, f"grid of {rows}x{cols} tiles with {len(ids)} "
                   "dimg references")
    tiles = []
    for tid in ids:
        tile = c.items.get(tid)
        if tile is None or tile.type != b"av01":
            unreadable(path, "grid tile that is not an av01 item")
        tiles.append(decode_item(c, tile, data, path))
    info = tiles[0][0]
    if any(tuple(t[0][k] for k in TILE_KEYS)
           != tuple(info[k] for k in TILE_KEYS) for t in tiles):
        unreadable(path, "grid of mismatched tiles")
    tw, th = info["width"], info["height"]
    if tw * cols < ow or th * rows < oh:
        unreadable(path, "grid tiles that do not cover the image")
    if tw * (cols - 1) >= ow or th * (rows - 1) >= oh:
        unreadable(path, "grid tiles past the image's last row or column")
    ssx, ssy = (0, 0) if info["mono"] else (info["ssx"], info["ssy"])
    if tw < 64 or th < 64 or (ssx and (ow % 2 or tw % 2)) \
            or (ssy and (oh % 2 or th % 2)):
        unreadable(path, "grid tile or image size MIAF forbids")
    check_size(path, ow, oh)
    planes = []
    for p, plane in enumerate(tiles[0][1]):
        sx, sy = (ssx, ssy) if p else (0, 0)
        ph, pw = plane.shape
        out = np.zeros((rows * ph, cols * pw), plane.dtype)
        for k, (_, tp) in enumerate(tiles):
            r, col = divmod(k, cols)
            out[r * ph:(r + 1) * ph, col * pw:(col + 1) * pw] = tp[p]
        planes.append(np.ascontiguousarray(
            out[:(oh + sy) >> sy, :(ow + sx) >> sx]))
    return dict(info, width=ow, height=oh), planes


@dataclass
class Decoded:
    info: dict
    planes: list
    alpha: np.ndarray | None
    alpha_info: dict | None
    premultiplied: bool
    nclx: tuple | None


def decode(path) -> Decoded:
    data = Path(path).read_bytes()
    if not is_avif(data[:64]):
        unreadable(path, "not an AVIF file")
    c = parse(data, path)
    if c.major == b"avis":
        # libavif decodes the track of an `avis` file (cv2 gives its first
        # frame) and fails without one
        if c.has_moov:
            unsupported(path, "AVIF image sequence")
        unreadable(path, "avis brand without a track")
    it = c.items[c.primary]
    if it.type not in (b"av01", b"grid"):
        unreadable(path, f"primary item of type {it.type!r}")
    info, planes = decode_image(c, it, data, path)
    ispe = prop(it, b"ispe")
    if ispe is None or len(ispe) < 12:
        unreadable(path, "primary item without ispe")
    w, h = struct.unpack(">II", ispe[4:12])
    if (w, h) != (info["width"], info["height"]):
        if it.type == b"grid":
            # cv2 sizes its image by the ispe and fails on the grid's
            unreadable(path, "grid whose ispe differs from its output size")
        unsupported(path, "AVIF whose ispe differs from its AV1 frame size "
                    "(libavif scales the frame to it)")
    check_size(path, w, h)
    nclx = None
    colr = prop(it, b"colr")
    if colr is not None and colr[:4] == b"nclx" and len(colr) >= 11:
        cp, tc, mc = struct.unpack(">HHH", colr[4:10])
        nclx = (cp, tc, mc, colr[10] >> 7)
    alpha = alpha_info = None
    premul = False
    for kind, frm, to in c.refs:
        if kind != b"auxl" or c.primary not in to or frm not in c.items:
            continue
        aux = c.items[frm]
        auxc = prop(aux, b"auxC")
        if aux.type not in (b"av01", b"grid") or auxc is None:
            continue
        if auxc[4:].rstrip(b"\0").split(b"\0")[0] not in ALPHA_URNS:
            continue
        alpha_info, ap = decode_image(c, aux, data, path)
        if (alpha_info["width"], alpha_info["height"]) != (w, h):
            unreadable(path, "alpha plane of another size")
        alpha = ap[0]
        premul = any(k == b"prem" and f == c.primary and frm in t
                     for k, f, t in c.refs)
        break
    return Decoded(info, planes, alpha, alpha_info, premul, nclx)


# ------------------------------------------------------------------ colour
# libyuv's YuvConstants as libavif picks them (avifGetLibYUVConstants):
# (UB, UG, VG, VR, YG, YB) of kYuv{JPEG,I601,F709,H709,V2020,2020}Constants
LIBYUV = {(601, 1): (113, 22, 46, 90, 16320, 32),
          (601, 0): (128, 25, 52, 102, 18997, -1160),
          (709, 1): (119, 12, 30, 101, 16320, 32),
          (709, 0): (128, 14, 34, 115, 18997, -1160),
          (2020, 1): (120, 11, 37, 94, 16320, 32),
          (2020, 0): (128, 12, 42, 107, 19003, -1160)}
# libavif's (kr, kb) by matrix_coefficients; others use BT.601's
KR_KB = {1: (0.2126, 0.0722), 4: (0.30, 0.11), 5: (0.299, 0.114),
         6: (0.299, 0.114), 7: (0.212, 0.087), 9: (0.2627, 0.0593)}


def _colour(d: Decoded) -> tuple:
    """(matrix_coefficients, full_range) as libavif takes them: the colr
    nclx box where there is one, else the AV1 sequence header's."""
    if d.nclx is not None:
        return d.nclx[2], d.nclx[3]
    return d.info["mc"], d.info["full_range"]


def _libyuv_key(mc: int, mono: bool):
    if mono and mc == 0:
        mc = 6
    if mc == 1:
        return 709
    if mc in (2, 5, 6):
        return 601
    if mc == 9:
        return 2020
    return None


def _up_linear(c: np.ndarray, width: int) -> np.ndarray:
    """libyuv's ScaleRowUp2_Linear through its _Any wrapper, row by row:
    (3, 1) / 4 between chroma samples, the first and last copied."""
    c = c.astype(np.int64)
    out = np.empty(c.shape[:-1] + (width,), np.int64)
    out[..., 0] = c[..., 0]
    k = np.arange((width - 1) // 2)
    out[..., 1 + 2 * k] = (3 * c[..., k] + c[..., k + 1] + 2) >> 2
    out[..., 2 + 2 * k] = (c[..., k] + 3 * c[..., k + 1] + 2) >> 2
    out[..., width - 1] = c[..., (width - 1) // 2]
    return out


def _up_bilinear_pair(sa: np.ndarray, sb: np.ndarray, width: int) -> tuple:
    """libyuv's ScaleRowUp2_Bilinear (_Any): two output rows between chroma
    rows sa and sb, (9, 3, 3, 1) / 16 inside, (3, 1) / 4 at the ends."""
    sa = sa.astype(np.int64)
    sb = sb.astype(np.int64)
    da = np.empty(sa.shape[:-1] + (width,), np.int64)
    db = np.empty_like(da)
    da[..., 0] = (3 * sa[..., 0] + sb[..., 0] + 2) >> 2
    db[..., 0] = (sa[..., 0] + 3 * sb[..., 0] + 2) >> 2
    k = np.arange((width - 1) // 2)
    s0, s1, t0, t1 = sa[..., k], sa[..., k + 1], sb[..., k], sb[..., k + 1]
    da[..., 1 + 2 * k] = (s0 * 9 + s1 * 3 + t0 * 3 + t1 + 8) >> 4
    da[..., 2 + 2 * k] = (s0 * 3 + s1 * 9 + t0 + t1 * 3 + 8) >> 4
    db[..., 1 + 2 * k] = (s0 * 3 + s1 + t0 * 9 + t1 * 3 + 8) >> 4
    db[..., 2 + 2 * k] = (s0 + s1 * 3 + t0 * 3 + t1 * 9 + 8) >> 4
    m = (width - 1) // 2
    da[..., width - 1] = (3 * sa[..., m] + sb[..., m] + 2) >> 2
    db[..., width - 1] = (sa[..., m] + 3 * sb[..., m] + 2) >> 2
    return da, db


def _up_420(c: np.ndarray, width: int, height: int) -> np.ndarray:
    """I420To...MatrixBilinear's chroma: the first row (and the last of an
    even height) linear from one chroma row, the rows between bilinear."""
    out = np.empty((height, width), np.int64)
    out[0] = _up_linear(c[0], width)
    n = (height - 1) // 2
    if n:
        da, db = _up_bilinear_pair(c[:n], c[1:n + 1], width)
        out[1:1 + 2 * n:2] = da
        out[2:2 + 2 * n:2] = db
    if height % 2 == 0:
        out[height - 1] = _up_linear(c[n], width)
    return out


def _libyuv_rgb(y, u, v, key, full, depth, ssx, ssy) -> np.ndarray:
    """libyuv's YuvPixel (or YuvPixel10 / 12) on bilinear-upsampled chroma
    → (H, W, 3) uint8 RGB."""
    h, w = y.shape
    if ssx and ssy:
        u, v = _up_420(u, w, h), _up_420(v, w, h)
    elif ssx:
        u, v = _up_linear(u, w), _up_linear(v, w)
    ub, ug, vg, vr, yg, yb = LIBYUV[(key, full)]
    y = y.astype(np.int64)
    u = u.astype(np.int64)
    v = v.astype(np.int64)
    if depth == 8:
        y32 = y * 0x0101
    else:
        y32 = (y << (16 - depth)) | (y >> (2 * depth - 16))
        u = np.minimum(u >> (depth - 8), 255)
        v = np.minimum(v >> (depth - 8), 255)
    y1 = (((y32 * yg) & 0xFFFFFFFF) >> 16) + yb
    ui, vi = u - 128, v - 128
    b = y1 + ui * ub
    g = y1 - (ui * ug + vi * vg)
    r = y1 + vi * vr
    return np.clip(np.stack([r, g, b], -1) >> 6, 0, 255).astype(np.uint8)


def _slow_rgb(y, u, v, mc, full, depth, ssx, ssy, out_depth) -> np.ndarray:
    """avifImageYUVAnyToRGBAnySlow, float32 as libavif computes it:
    unorm tables, (9, 3, 3, 1) / 16 bilinear chroma, then the matrix (or
    identity / monochrome) → (H, W, 3) uint8 or uint16 RGB."""
    f32 = np.float32
    h, w = y.shape
    maxc = (1 << depth) - 1
    if full:
        bias_y, range_y, range_uv = 0.0, float(maxc), float(maxc)
    else:
        bias_y = float(16 << (depth - 8))
        range_y, range_uv = float(219 << (depth - 8)), float(224 << (depth - 8))
    bias_uv = float(1 << (depth - 1))
    table_y = ((np.arange(maxc + 1, dtype=f32) - f32(bias_y)) / f32(range_y)).astype(f32)
    if mc == 0:
        table_uv = table_y
    else:
        table_uv = ((np.arange(maxc + 1, dtype=f32) - f32(bias_uv)) / f32(range_uv)).astype(f32)
    Y = table_y[np.minimum(y, maxc)]
    if u is None:
        R = G = B = Y
    else:
        u = np.minimum(u, maxc)
        v = np.minimum(v, maxc)
        if not ssx and not ssy:
            Cb, Cr = table_uv[u], table_uv[v]
        else:
            Cb, Cr = _slow_upsample(table_uv, u, v, w, h, ssx, ssy)
        if mc == 0:
            G, B, R = Y, Cb, Cr
        else:
            kr, kb = (f32(x) for x in KR_KB.get(mc, KR_KB[6]))
            kg = f32(1) - kr - kb
            one, two = f32(1), f32(2)
            R = (Y + (two * (one - kr)) * Cr).astype(f32)
            B = (Y + (two * (one - kb)) * Cb).astype(f32)
            G = (Y - ((two * ((kr * (one - kr) * Cr) + (kb * (one - kb) * Cb))) / kg)).astype(f32)
    rgb = np.stack([R, G, B], -1).astype(f32)
    rgb = np.clip(rgb, f32(0), f32(1))
    maxo = f32((1 << out_depth) - 1)
    vals = (f32(0.5) + rgb * maxo).astype(f32)
    return vals.astype(np.uint8 if out_depth == 8 else np.uint16)


def _slow_upsample(table, u, v, w, h, ssx, ssy):
    """libavif's built-in bilinear 4:2:0 / 4:2:2 chroma: the nearest sample
    9/16, the adjacent column and row 3/16 each, the diagonal 1/16 (its
    float sums in that order), edges duplicated."""
    f32 = np.float32
    i = np.arange(w)
    j = np.arange(h)
    ci = i >> ssx
    cj = j >> ssy
    adj_c = np.where((i == 0) | ((i == w - 1) & (i % 2 != 0)), 0, np.where(i % 2 != 0, 1, -1))
    if ssy:
        adj_r = np.where((j == 0) | ((j == h - 1) & (j % 2 != 0)), 0, np.where(j % 2 != 0, 1, -1))
    else:
        adj_r = np.zeros(h, np.int64)
    r0, c0 = cj[:, None], ci[None, :]
    r1, c1 = (cj + adj_r)[:, None], (ci + adj_c)[None, :]
    out = []
    for p in (u, v):
        s00, s10 = table[p[r0, c0]], table[p[r0, c1]]
        s01, s11 = table[p[r1, c0]], table[p[r1, c1]]
        acc = (s00 * f32(9 / 16)).astype(f32)
        acc = (acc + (s10 * f32(3 / 16)).astype(f32)).astype(f32)
        acc = (acc + (s01 * f32(3 / 16)).astype(f32)).astype(f32)
        acc = (acc + (s11 * f32(1 / 16)).astype(f32)).astype(f32)
        out.append(acc)
    return out


def to_rgb(d: Decoded, out_depth: int) -> np.ndarray:
    """libavif's avifImageYUVToRGB for cv2: libyuv where it has the
    matrix and the output is 8-bit, else libavif's own float path. A 10-
    or 12-bit image without alpha is shifted to 8 bits first (libyuv's
    Convert16To8Plane) and converted as an 8-bit one; with alpha it goes
    through libyuv's I010Alpha (YuvPixel10, bilinear chroma) or I012
    (YuvPixel12, each chroma sample repeated) rows."""
    info = d.info
    depth, mono = info["bit_depth"], bool(info["mono"])
    mc, full = _colour(d)
    y = d.planes[0]
    u, v = (None, None) if mono else (d.planes[1], d.planes[2])
    ssx, ssy = info["ssx"], info["ssy"]
    key = _libyuv_key(mc, mono)
    if out_depth == 8 and key is not None and not mono:
        if depth == 8:
            return _libyuv_rgb(y, u, v, key, full, 8, ssx, ssy)
        if d.alpha is None:
            sh = depth - 8
            y, u, v = (np.minimum(p >> sh, 255) for p in (y, u, v))
            return _libyuv_rgb(y, u, v, key, full, 8, ssx, ssy)
        if depth == 12:
            h, w = y.shape
            u = np.repeat(np.repeat(u, 1 << ssy, 0), 1 << ssx, 1)[:h, :w]
            v = np.repeat(np.repeat(v, 1 << ssy, 0), 1 << ssx, 1)[:h, :w]
            ssx = ssy = 0
        return _libyuv_rgb(y, u, v, key, full, depth, ssx, ssy)
    return _slow_rgb(y, u, v, mc, full, depth, ssx, ssy, out_depth)


def _unpremultiply(rgb: np.ndarray, a: np.ndarray, depth: int) -> np.ndarray:
    """avifRGBImageUnpremultiplyAlpha: 8-bit through libyuv's
    ARGBUnattenuate (SIMD rows: pmulhuw of x * 257 by 1/a in 8.8 fixed
    point), deeper samples by libavif's float division."""
    a = a.astype(np.int64)[..., None]
    if depth == 8:
        ia = np.where(a == 0, 0, np.where(a == 1, 0xFFFF, 0x10000 // np.maximum(a, 1)))
        ia = np.where(a == 255, 256, ia)
        return np.minimum((rgb.astype(np.int64) * 257 * ia) >> 16, 255).astype(np.uint8)
    top = np.float32((1 << depth) - 1)
    f = rgb.astype(np.float32) * top / np.maximum(a, 1).astype(np.float32)
    c = np.minimum(np.floor(f + np.float32(0.5)), top)
    out = np.where(a == 0, 0, np.where(a < top, c, rgb))
    return out.astype(rgb.dtype)


def read_avif(path, mode: str = "unchanged") -> np.ndarray:
    """`cv2.imread` of an AVIF file in RGB(A) order (see the module
    docstring)."""
    d = decode(path)
    depth = d.info["bit_depth"]
    if d.info["mono"] and d.alpha is not None:
        unreadable(path, "monochrome AVIF with alpha (cv2 reads 2 channels and fails)")
    if d.info["mono"]:
        # cv2 copies the Y plane into one channel (convertTo(CV_8U,
        # 2^(8 - depth)), rounding half to even, for "color" and "grey"
        # of a deeper file) and replicates it for "color"
        y = d.planes[0]
        if mode == "unchanged":
            return y.astype(np.uint8) if depth == 8 else y.astype(np.uint16)
        if depth > 8:
            y = np.rint(y.astype(np.float64) / (1 << (depth - 8)))
        y = y.astype(np.uint8)
        return np.dstack([y, y, y]) if mode == "color" else y
    rgb = to_rgb(d, depth if mode == "unchanged" else 8)
    a = None
    if d.alpha is not None:
        a = d.alpha
        if not d.alpha_info["full_range"]:
            a = _limited_to_full(a, d.alpha_info["bit_depth"])
        if mode != "unchanged" and depth > 8:
            a = np.minimum(a >> (depth - 8), 255)
        if d.premultiplied:
            rgb = _unpremultiply(rgb, a, 8 if mode != "unchanged" else depth)
    if mode == "unchanged":
        return rgb if a is None else np.dstack([rgb, a.astype(rgb.dtype)])
    if mode == "color":
        return rgb
    return cvt_grey(rgb)


def _limited_to_full(a: np.ndarray, depth: int) -> np.ndarray:
    """avifLimitedToFullY: (v - 16) * 255 / 219, rounded, clamped, at the
    sample depth."""
    lo, rng, full = 16 << (depth - 8), 219 << (depth - 8), (1 << depth) - 1
    v = (a.astype(np.int64) - lo) * full
    return np.clip((v + rng // 2) // rng, 0, full)
