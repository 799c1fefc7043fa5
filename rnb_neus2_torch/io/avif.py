"""AVIF images and sequences, read as cv2 reads them: OpenCV's
grfmt_avif on libavif 1.4 (with its bundled libyuv) over libaom, sample
for sample.

The container is HEIF (ISO/IEC 23008-12) in ISOBMFF boxes: `ftyp` (major
or compatible brand `avif`/`avis`, as libavif's avifPeekCompatibleFileType
tests; a brand `avif` needs a `meta` box, `avis` a `moov`), `meta` with
`hdlr` `pict`, `pitm`, `iinf`/`infe`, `iloc` (versions 0-2, construction
methods 0 and 1 through `idat`), `iprp` (`ipco` properties bound by
`ipma`: `av1C`, `ispe`, `pixi`, `colr` nclx or ICC, `auxC`, `irot`,
`imir`, `clap`, `a1op`, `a1lx`, `lsel`; libavif's rules on which must be
essential, and an item with an essential property it does not know
ignored) and `iref` (`auxl`, `prem`, `dimg`); and `moov` with its tracks
(`tkhd`, `tref` `auxl`/`prem`, `mdia`/`minf`/`stbl`: the `av01` sample
entry's properties, `stsc`, `stsz`, `stco`/`co64`; `stss` and `stts`
read and not needed for the first frame).

Which image: libavif's AVIF_DECODER_SOURCE_AUTO (`source`): a major brand
`avis` decodes the tracks, `avif` the primary item, any other the tracks
where the file has any. From tracks, the first usable track that is no
`auxl` of another is the colour, the first that is an `auxl` of it the
alpha (`prem` naming it: premultiplied), and each gives its first
sample. The AV1 OBUs of an item or a sample decode in `native/av1.cc`
(every frame of the stream, key and inter: a layered item's layers, the
temporal unit of a sample, a multi-frame stream in one item; superres and
film grain included, as libaom hands libavif the frame); a layered item
shows its last frame, or with `lsel` the first frame of that spatial
layer (from the layers `a1lx` sizes up to it), in the operating point
`a1op` names. An item whose
primary is the `auxl` with the alpha URN is its alpha plane. A `grid`
derived item is its `dimg` tiles decoded one by one, checked as libavif
checks them and stitched (`decode_grid`). A frame whose size is not its
item's `ispe` (or its track's size) is scaled to it as libavif's
avifImageScaleWithLimit scales it: libyuv's ScalePlane / ScalePlane_12,
box filter, in `native/scale.cc` (`scale`).

cv2 returns libavif's planes without applying `irot`, `imir` or `clap`
(libavif reports them and does not apply them; cv2 ignores the report)
and reads no EXIF orientation from AVIF. "unchanged" gives 8-bit or,
for 10- and 12-bit files, uint16 holding the raw 0-1023 or 0-4095
values; 3 channels, or 4 with alpha; a monochrome file 1 channel (with
alpha, cv2 fails: None). "color" is libavif's conversion to 8-bit RGB
(alpha dropped, never multiplied in) and "grey" cvtColor's BGR2GRAY of
that; of a monochrome file both are its Y plane (a deeper one scaled to
8 bits by cv2's saturating convertTo).

libavif converts YUV to RGB through libyuv where libyuv has the matrix
(BT.601, BT.709, BT.2020 NCL; full and limited range; 8-bit and, to
8-bit RGB, 10- and 12-bit 4:2:0 / 4:2:2 / 4:4:4), with libyuv's
bilinear chroma upsampling ("Filter" functions) and its 6-bit fixed-point
YuvPixel; otherwise (identity/GBR, monochrome, other matrices, 16-bit
output) through its own float path (avifImageYUVToRGBAnySlow...).
`to_rgb` below holds both, as this module's tests pin them to cv2.

The inter tools of libaom's plain multi-frame streams decode too:
compound prediction and the skip mode, global motion, shown-existing
frames, segmentation, superres and film grain in inter frames, switch
frames. Refused by name (UnsupportedImage, "AVIF layer using ..."): the
inter tools no setting of libaom's encoder writes (`AV1_TOOLS`: short
reference signalling, the bilinear or dual interpolation filters, loop
filter delta updates in an inter frame). A file cv2 cannot read (truncated boxes, a broken
`iloc`, a bad OBU, a monochrome image with alpha, a brand without the box
it needs, a track without `stsd`, samples or chunks that run out or past
the file, a first sample that is no key frame, large-scale tile, an
essential `a1lx` or one that does not fit its item, a non-essential
`a1op` or `lsel`, an `lsel` past the layers, a zero or too large
`ispe`, a grid libavif refuses or whose `ispe` is not its output size)
raises UnreadableImage.

Writing (`encode_avif`, below): the kind of file cv2.imwrite writes at
its defaults, coded by the port's own AV1 encoder (`native/av1_enc.cc`).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import native
from .errors import ImwriteFailed, check_size, unreadable, unsupported
from .jpeg import cvt_grey

BRANDS = (b"avif", b"avis")
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")
# native/av1.cc's error codes: an inter tool the port does not decode
# (its Tool number in info["tool"]), large-scale tile (libaom, so libavif,
# so cv2, fails too)
AV1_TOOL = -9
AV1_NO_FRAME = -8
LARGE_SCALE_TILE = -4
AV1_TOOLS = {6: "short reference signalling", 7: "the bilinear interpolation filter",
             8: "dual interpolation filters", 9: "loop filter delta updates"}


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
    unsupported: bool = False     # an essential property libavif does not know


# the item properties libavif parses, and those the specifications want
# marked essential (a1op, lsel, the transforms) or not (a1lx)
KNOWN_PROPERTIES = {b"ispe", b"auxC", b"colr", b"av1C", b"pasp", b"clap", b"irot", b"imir",
                    b"pixi", b"a1op", b"lsel", b"a1lx", b"clli"}
ESSENTIAL = {b"a1op", b"lsel", b"clap", b"irot", b"imir"}
NONESSENTIAL = {b"a1lx"}


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
class Track:
    """A `trak` of an AVIF sequence as libavif keeps it: the tkhd's id and
    size, its `auxl` / `prem` references, the sample entries (format and
    property boxes) and the sample table."""
    id: int = 0
    width: int = 0
    height: int = 0
    aux_for: int = 0
    prem_by: int = 0
    entries: list = field(default_factory=list)   # (format, [(kind, body)])
    has_table: bool = False
    chunks: list = field(default_factory=list)    # chunk offsets
    to_chunk: list = field(default_factory=list)  # (first chunk, samples)
    all_size: int = 0
    sizes: list = field(default_factory=list)

    def props(self) -> list | None:
        """The properties of the first av01 sample entry, or None."""
        for fmt, props in self.entries:
            if fmt == b"av01":
                return props
        return None

    def samples(self, n_data: int, path) -> list:
        """(offset, size) of every sample, as libavif's
        avifCodecDecodeInputFillFromSampleTable lays them out: chunk by
        chunk, each chunk's samples back to back from its offset; a chunk
        without samples, a size table that runs out or a sample past the
        file is UnreadableImage."""
        out, k = [], 0
        for index, offset in enumerate(self.chunks):
            count = 0
            for first, per in reversed(self.to_chunk):
                if first <= index + 1:
                    count = per
                    break
            if count == 0:
                unreadable(path, "AVIF track with a chunk of no samples")
            for _ in range(count):
                size = self.all_size
                if size == 0:
                    if k >= len(self.sizes):
                        unreadable(path, "AVIF track's sample table is truncated")
                    size = self.sizes[k]
                if offset + size > n_data:
                    unreadable(path, "AVIF sample past the end of the file")
                out.append((offset, size))
                offset += size
                k += 1
        return out


@dataclass
class Container:
    items: dict
    primary: int | None
    refs: list          # (type, from, [to...])
    idat: bytes
    major: bytes
    tracks: list = field(default_factory=list)


def _parse_track(data: bytes, s: int, e: int, path) -> Track:
    """avifParseTrackBox: tkhd (mandatory; version 0 or 1; a size of zero
    or past libavif's limits fails), tref's auxl / prem (the first id of
    each), and mdia/minf/stbl's boxes (each of version 0)."""
    t, tkhd = Track(), False
    for kind, bs, be in _boxes(data, s, e, path):
        r = _Reader(data, bs, be, path)
        if kind == b"tkhd":
            v, _ = r.full()
            if v not in (0, 1):
                unreadable(path, f"tkhd of version {v}")
            n = 8 if v == 1 else 4
            r.u(n); r.u(n)
            t.id = r.u(4)
            r.u(4); r.u(n)
            r.take(52)
            t.width, t.height = r.u(4) >> 16, r.u(4) >> 16
            if t.width == 0 or t.height == 0:
                unreadable(path, "AVIF track of size zero")
            check_size(path, t.width, t.height)
            tkhd = True
        elif kind == b"tref":
            for k2, s2, e2 in _boxes(data, bs, be, path):
                if k2 in (b"auxl", b"prem"):
                    ident = _Reader(data, s2, e2, path).u(4)
                    if k2 == b"auxl":
                        t.aux_for = ident
                    else:
                        t.prem_by = ident
        elif kind == b"mdia":
            for k2, s2, e2 in _boxes(data, bs, be, path):
                if k2 == b"minf":
                    for k3, s3, e3 in _boxes(data, s2, e2, path):
                        if k3 == b"stbl":
                            if t.has_table:
                                unreadable(path, "a second stbl in one track")
                            t.has_table = True
                            _parse_stbl(t, data, s3, e3, path)
                elif k2 == b"mdhd":
                    v, _ = _Reader(data, s2, e2, path).full()
                    if v not in (0, 1):
                        unreadable(path, f"mdhd of version {v}")
    if not tkhd:
        unreadable(path, "trak without tkhd")
    return t


def _parse_stbl(t: Track, data: bytes, s: int, e: int, path) -> None:
    for kind, bs, be in _boxes(data, s, e, path):
        r = _Reader(data, bs, be, path)
        if kind not in (b"stco", b"co64", b"stsc", b"stsz", b"stss", b"stts",
                        b"stsd"):
            continue
        v, _ = r.full()
        if v != 0 and kind != b"stsd":
            unreadable(path, f"{kind.decode()} of version {v}")
        if kind in (b"stco", b"co64"):
            t.chunks += [r.u(8 if kind == b"co64" else 4) for _ in range(r.u(4))]
        elif kind == b"stsc":
            for i in range(r.u(4)):
                first, per = r.u(4), r.u(4)
                r.u(4)
                if (i == 0 and first != 1) or (i and first <= t.to_chunk[-1][0]):
                    unreadable(path, "stsc's chunks do not start at 1 and rise")
                t.to_chunk.append((first, per))
        elif kind == b"stsz":
            size, count = r.u(4), r.u(4)
            if size:
                t.all_size = size
            else:
                t.sizes += [r.u(4) for _ in range(count)]
        elif kind == b"stss":
            [r.u(4) for _ in range(r.u(4))]
        elif kind == b"stts":
            [r.u(8) for _ in range(r.u(4))]
        else:
            for _ in range(r.u(4)):
                if r.end - r.p < 8:
                    unreadable(path, "truncated sample entry")
                size, fmt = struct.unpack(">I4s", data[r.p:r.p + 8])
                if size < 8 or r.p + size > r.end:
                    unreadable(path, "sample entry runs past stsd")
                props = []
                # the VisualSampleEntry's 78 bytes, then property boxes (libavif
                # reads them up to the end of stsd)
                if fmt == b"av01" and r.end - (r.p + 8) > 78:
                    props = [(k, data[a:b]) for k, a, b in
                             _boxes(data, r.p + 8 + 78, r.end, path)]
                t.entries.append((fmt, props))
                r.p += size


def parse(data: bytes, path) -> Container:
    major, meta, moov, brands = b"", None, False, ()
    tracks = []
    for kind, s, e in _boxes(data, 0, len(data), path):
        if kind == b"ftyp":
            major = data[s:s + 4]
            brands = (major,) + tuple(data[i:i + 4] for i in range(s + 8, e - 3, 4))
        elif kind == b"meta":
            meta = (s, e)
        elif kind == b"moov":
            moov = True
            for k2, s2, e2 in _boxes(data, s, e, path):
                if k2 == b"trak":
                    tracks.append(_parse_track(data, s2, e2, path))
            if not tracks:
                unreadable(path, "moov without a trak")
    # libavif's avifParse: a brand `avif` needs a meta box, `avis` a moov
    if (b"avif" in brands and meta is None) or (b"avis" in brands and not moov):
        unreadable(path, "AVIF without the meta or moov box its brands need")
    if meta is None:
        return Container({}, None, [], b"", major, tracks)
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
                            wide = flags & 1
                            x = pb.u(2 if wide else 1)
                            assoc.append((x & (0x7FFF if wide else 0x7F), bool(x >> (15 if wide else 7))))
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
    for iid, assoc in ipma:
        it = items.setdefault(iid, Item(iid))
        for idx, essential in assoc:
            if idx:
                if idx > len(props):
                    unreadable(path, "ipma names a missing property")
                kind = props[idx - 1][0]
                # libavif: properties the specifications want essential or
                # not, and an item with an essential property it does not
                # know is ignored
                if kind in KNOWN_PROPERTIES:
                    if essential and kind in NONESSENTIAL:
                        unreadable(path, f"essential {kind.decode()} property")
                    if not essential and kind in ESSENTIAL:
                        unreadable(path, f"non-essential {kind.decode()} property")
                elif essential:
                    it.unsupported = True
                it.props.append(props[idx - 1])
    if primary not in items or items[primary].unsupported:
        primary = None
    return Container(items, primary, refs, idat, major, tracks)


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


def decode_av1(obus: bytes, path, op: int = 0, layer: int = -1) -> tuple:
    """(info, planes) of the frame libaom hands libavif from one AV1
    sample or item payload (its operating point `op`; the first frame of
    spatial layer `layer`, or the last one)."""
    code, info, planes, _ = native.av1_decode(obus, op, layer)
    if code == AV1_NO_FRAME and layer >= 0:
        unreadable(path, f"no frame of spatial layer {layer} (lsel)")
    if code == AV1_TOOL:
        unsupported(path, f"AVIF layer using {AV1_TOOLS.get(info['tool'], 'an inter tool')}")
    if code == LARGE_SCALE_TILE:
        unreadable(path, "large-scale tile (a tile list OBU)")
    if code != 0:
        unreadable(path, f"AV1 bitstream error {code}")
    return info, planes


def scale(info: dict, planes: list, width: int, height: int, path) -> tuple:
    """avifImageScaleWithLimit: a decoded frame whose size is not its
    item's `ispe` (or its track's) is scaled to it, each plane to its
    chroma-rounded size, by libyuv's box-filtered ScalePlane
    (`native/scale.cc`); a zero size, or one past libavif's limits or
    libyuv's 16384, is UnreadableImage."""
    w0, h0 = info["width"], info["height"]
    if (w0, h0) == (width, height):
        return info, planes
    if width == 0 or height == 0:
        unreadable(path, "AVIF scaled to a size of zero")
    check_size(path, width, height)
    if w0 > 16384 or h0 > 16384:
        unreadable(path, "AVIF frame too large for libyuv's scaler")
    out = []
    for p, plane in enumerate(planes):
        sx, sy = (info["ssx"], info["ssy"]) if p else (0, 0)
        out.append(native.scale_plane(plane, (width + sx) >> sx, (height + sy) >> sy,
                                      info["bit_depth"]))
    return dict(info, width=width, height=height), out


def layer_sizes(a1lx: bytes, total: int, path) -> list:
    """The layer sizes of an `a1lx` property as libavif reads them: three
    sizes of 16 (or, with the large_size flag, 32) bits, a zero ending the
    list, and the rest of the item as the last layer; a size that leaves
    no room for the layers after it is UnreadableImage."""
    n = 4 if a1lx[:1] and a1lx[0] & 1 else 2
    if len(a1lx) < 1 + 3 * n:
        unreadable(path, "truncated a1lx")
    sizes, remaining = [], total
    for i in range(3):
        size = int.from_bytes(a1lx[1 + i * n:1 + (i + 1) * n], "big")
        if size == 0:
            sizes.append(remaining)
            remaining = 0
            break
        if size >= remaining:
            unreadable(path, f"a1lx layer {i} does not fit in its item")
        sizes.append(size)
        remaining -= size
    if remaining > 0:
        sizes.append(remaining)
    return sizes


def decode_item(c: Container, it: Item, data: bytes, path) -> tuple:
    """(info, planes) of an av01 item, scaled to its `ispe`. A layered item
    decodes all its layers (in the operating point `a1op` names) and gives
    the last frame, or with `lsel` the first frame of that spatial layer
    from the layers up to it (as `a1lx` sizes them) — as libavif decodes
    for cv2, progressive decoding off."""
    obus = item_data(c, it, data, path)
    a1lx, lsel, a1op = prop(it, b"a1lx"), prop(it, b"lsel"), prop(it, b"a1op")
    sizes = layer_sizes(a1lx, len(obus), path) if a1lx is not None else []
    layer = -1
    if lsel is not None:
        if len(lsel) < 2:
            unreadable(path, "truncated lsel")
        layer = struct.unpack(">H", lsel[:2])[0]
        if layer == 0xFFFF:
            layer = -1
        elif sizes:
            if layer >= len(sizes):
                unreadable(path, f"lsel layer {layer} past the a1lx layers")
            obus = obus[:sum(sizes[:layer + 1])]
    op = a1op[0] if a1op else 0
    info, planes = decode_av1(obus, path, op, layer)
    ispe = prop(it, b"ispe")
    if ispe is not None and len(ispe) >= 12:
        info, planes = scale(info, planes, *struct.unpack(">II", ispe[4:12]), path)
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
        if tile is None or tile.type != b"av01" or tile.unsupported:
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


def source(c: Container) -> str:
    """libavif's AVIF_DECODER_SOURCE_AUTO: the major brand `avis` decodes
    the tracks, `avif` the primary item; any other the tracks where the
    file has any, else the primary item."""
    if c.major == b"avis":
        return "tracks"
    if c.major == b"avif":
        return "item"
    return "tracks" if c.tracks else "item"


def _nclx(props) -> tuple | None:
    for k, colr in props:
        if k == b"colr":
            if colr[:4] == b"nclx" and len(colr) >= 11:
                cp, tc, mc = struct.unpack(">HHH", colr[4:10])
                return cp, tc, mc, colr[10] >> 7
            return None
    return None


def _usable(t: Track) -> bool:
    return t.has_table and t.id != 0 and bool(t.chunks) and t.props() is not None


def decode_track(t: Track, data: bytes, path) -> tuple:
    """(info, planes) of a track's first sample, scaled to the track's
    size."""
    offset, size = t.samples(len(data), path)[0]
    info, planes = decode_av1(data[offset:offset + size], path)
    return scale(info, planes, t.width, t.height, path)


def decode_tracks(c: Container, data: bytes, path) -> Decoded:
    """An AVIF sequence's first frame as libavif picks it: the colour
    track is the first usable one (an id, chunks, an av01 sample entry)
    that is no `auxl` of another; its alpha the first usable track that
    is an `auxl` of it; premultiplied where the colour track's `prem`
    names the alpha track."""
    color = next((t for t in c.tracks if _usable(t) and not t.aux_for), None)
    if color is None:
        unreadable(path, "AVIF without an AV1 colour track")
    props = color.props()
    if prop(Item(0, props=props), b"av1C") is None:
        unreadable(path, "AVIF track without av1C")
    info, planes = decode_track(color, data, path)
    alpha = alpha_info = None
    premul = False
    track = next((t for t in c.tracks if _usable(t) and t.aux_for == color.id), None)
    if track is not None:
        alpha_info, ap = decode_track(track, data, path)
        if (alpha_info["width"], alpha_info["height"]) != (color.width, color.height):
            unreadable(path, "alpha track of another size")
        alpha = ap[0]
        premul = color.prem_by == track.id
    return Decoded(info, planes, alpha, alpha_info, premul, _nclx(props))


def decode(path) -> Decoded:
    data = Path(path).read_bytes()
    if not is_avif(data[:64]):
        unreadable(path, "not an AVIF file")
    c = parse(data, path)
    if source(c) == "tracks":
        if not c.tracks:
            unreadable(path, "avis brand without a track")
        return decode_tracks(c, data, path)
    if c.primary is None:
        unreadable(path, "no primary item")
    it = c.items[c.primary]
    if it.type not in (b"av01", b"grid"):
        unreadable(path, f"primary item of type {it.type!r}")
    ispe = prop(it, b"ispe")
    if ispe is None or len(ispe) < 12:
        unreadable(path, "primary item without ispe")
    w, h = struct.unpack(">II", ispe[4:12])
    info, planes = decode_image(c, it, data, path)
    if (w, h) != (info["width"], info["height"]):
        # cv2 sizes its image by the ispe and fails on the grid's
        unreadable(path, "grid whose ispe differs from its output size")
    check_size(path, w, h)
    nclx = _nclx(it.props)
    alpha = alpha_info = None
    premul = False
    for kind, frm, to in c.refs:
        if kind != b"auxl" or c.primary not in to or frm not in c.items:
            continue
        aux = c.items[frm]
        auxc = prop(aux, b"auxC")
        if aux.type not in (b"av01", b"grid") or auxc is None or aux.unsupported:
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
    point, 0xFFFF for a = 1, then packuswb, which saturates a word of
    32768 or more, read as signed, to 0), deeper samples by libavif's
    float division."""
    a = a.astype(np.int64)[..., None]
    if depth == 8:
        ia = np.where(a == 0, 0, np.where(a == 1, 0xFFFF, 0x10000 // np.maximum(a, 1)))
        ia = np.where(a == 255, 256, ia)
        v = (rgb.astype(np.int64) * 257 * ia) >> 16
        return np.where(v >= 32768, 0, np.minimum(v, 255)).astype(np.uint8)
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
        if depth > 8:       # saturating, as convertTo
            y = np.minimum(np.rint(y.astype(np.float64) / (1 << (depth - 8))), 255)
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


# ------------------------------------------------------------------ writing
# cv2.imwrite's AVIF at its defaults: libavif 1.4 over libaom 3.14, lossy,
# 8-bit only. The colour item is 4:2:0 BT.601 full range (colr nclx 1 /
# 13 / 6) or, from grey input, monochrome (nclx 2 / 2 / 2); an alpha
# channel with any sample under 255 becomes a monochrome full-range
# auxiliary item. base_q_idx of libaom's frames at cv2's default quality:
COLOUR_QINDEX = 148
ALPHA_QINDEX = 124
ALPHA_URN = ALPHA_URNS[0]
TEMPORAL_DELIMITER = b"\x12\x00"   # libavif keeps it before the sequence header


def rgb_to_yuv420(rgb: np.ndarray) -> tuple:
    """libavif's avifImageRGBToYUV of cv2's 8-bit BGR(A) pixels (given here
    in RGB order) for 4:2:0 BT.601 full range, which it hands to libyuv
    (RGB24ToJ420 / ARGBToJ420): Y = (77 R + 150 G + 29 B + 128) >> 8; each
    chroma sample from the rounded mean of its 2x2 pixels (the last row
    or column repeated where the size is odd), U = (128 B - 85 G - 43 R +
    32768) >> 8, V = (128 R - 107 G - 21 B + 32768) >> 8."""
    h, w = rgb.shape[:2]
    x = rgb[..., :3].astype(np.int32)
    y = (77 * x[..., 0] + 150 * x[..., 1] + 29 * x[..., 2] + 128) >> 8
    p = np.pad(x, ((0, h % 2), (0, w % 2), (0, 0)), mode="edge")
    m = (p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2] + 2) >> 2
    r, g, b = m[..., 0], m[..., 1], m[..., 2]
    u = (128 * b - 85 * g - 43 * r + 32768) >> 8
    v = (128 * r - 107 * g - 21 * b + 32768) >> 8
    return tuple(c.astype(np.uint8) for c in (y, u, v))


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def _full_box(kind: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(kind, bytes([version]) + flags.to_bytes(3, "big") + payload)


def _av1c(level: int, mono: bool) -> bytes:
    """av1C of profile 0, tier 0, 8 bits, 4:2:0 (or monochrome), chroma
    sample position 0, no configOBUs."""
    return _box(b"av1C", bytes([0x81, level, 0x10 * mono | 0x0C, 0]))


def _container(w: int, h: int, colour: bytes, level: int, mono: bool,
               alpha: bytes = None) -> bytes:
    """The HEIF boxes of cv2's AVIF, in its order: ftyp (avif; avif, mif1,
    miaf, and MA1B for a colour image of level 5.1 or lower), meta (hdlr,
    pitm, iloc, iinf, iref, iprp), mdat with the alpha item's data before
    the colour item's."""
    brands = b"avifmif1miaf" + (b"MA1B" if not mono and level <= 13 else b"")
    ftyp = _box(b"ftyp", b"avif" + b"\0\0\0\0" + brands)
    hdlr = _full_box(b"hdlr", 0, 0, b"\0" * 4 + b"pict" + b"\0" * 13)
    pitm = _full_box(b"pitm", 0, 0, struct.pack(">H", 1))
    items = [(1, b"Color", colour)] + ([(2, b"Alpha", alpha)] if alpha else [])
    iinf = _full_box(b"iinf", 0, 0, struct.pack(">H", len(items)) + b"".join(
        _full_box(b"infe", 2, 0, struct.pack(">HH", i, 0) + b"av01" + name + b"\0")
        for i, name, _ in items))
    iref = _full_box(b"iref", 0, 0, _box(b"auxl", struct.pack(">HHH", 2, 1, 1))) if alpha else b""
    nclx = (2, 2, 2) if mono else (1, 13, 6)
    props = [_full_box(b"ispe", 0, 0, struct.pack(">II", w, h)),
             _full_box(b"pixi", 0, 0, bytes([1, 8]) if mono else bytes([3, 8, 8, 8])),
             _av1c(level, mono),
             _box(b"colr", b"nclx" + struct.pack(">HHHB", *nclx, 0x80))]
    assoc = [(1, [1, 2, 0x83, 4])]
    if alpha:
        props += [_full_box(b"pixi", 0, 0, bytes([1, 8])), _av1c(level, True),
                  _full_box(b"auxC", 0, 0, ALPHA_URN + b"\0")]
        assoc.append((2, [1, 5, 0x86, 7]))
    ipma = _full_box(b"ipma", 0, 0, struct.pack(">I", len(assoc)) + b"".join(
        struct.pack(">HB", i, len(a)) + bytes(a) for i, a in assoc))
    iprp = _box(b"iprp", _box(b"ipco", b"".join(props)) + ipma)
    order = items[::-1]                       # mdat: alpha, then colour

    def meta(start: int) -> bytes:
        offsets, pos = {}, start
        for i, _, data in order:
            offsets[i] = pos
            pos += len(data)
        iloc = _full_box(b"iloc", 0, 0, bytes([0x44, 0]) + struct.pack(">H", len(items)) + b"".join(
            struct.pack(">HHHII", i, 0, 1, offsets[i], len(data)) for i, _, data in items))
        return _full_box(b"meta", 0, 0, hdlr + pitm + iloc + iinf + iref + iprp)

    start = len(ftyp) + len(meta(0)) + 8
    return ftyp + meta(start) + _box(b"mdat", b"".join(d for _, _, d in order))


def encode_avif_recon(image: np.ndarray, path="image") -> tuple:
    """`encode_avif`'s file, with the planes a decoder reconstructs from
    it: ([Y] or [Y, U, V] uint8, the alpha plane or None)."""
    image = np.asarray(image)
    if image.ndim == 3 and image.shape[2] == 1:
        image = image[..., 0]
    if image.ndim not in (2, 3) or (image.ndim == 3 and image.shape[2] not in (3, 4)):
        raise ValueError(f"{path}: cv2's AVIF encoder takes 1, 3 or 4 channels, "
                         f"not shape {image.shape}")
    if image.dtype == np.uint16:
        raise ImwriteFailed(f"{path}: cv2 writes AVIF from 8-bit samples only "
                            "(at its default bit depth)")
    if image.dtype != np.uint8:
        raise ValueError(f"{path}: AVIF takes 8-bit samples, not {image.dtype}")
    h, w = image.shape[:2]
    mono = image.ndim == 2
    planes = [image] if mono else list(rgb_to_yuv420(image))
    colour, recon, level = native.av1_encode(planes, COLOUR_QINDEX,
                                             (2, 2, 2) if mono else (1, 13, 6))
    alpha = arecon = None
    if not mono and image.shape[2] == 4 and (image[..., 3] < 255).any():
        alpha, arec, _ = native.av1_encode([image[..., 3]], ALPHA_QINDEX)
        alpha = TEMPORAL_DELIMITER + alpha
        arecon = arec[0]
    data = _container(w, h, TEMPORAL_DELIMITER + colour, level, mono, alpha)
    return data, recon, arecon


def reconstructed(recon: list, alpha=None) -> np.ndarray:
    """What cv2 and `read_avif` ("unchanged") read from a file of
    `encode_avif_recon`: its grey plane, or its planes through libavif's
    YUV to RGB (libyuv, BT.601 full range, bilinear chroma), with its
    alpha where it has one."""
    if len(recon) == 1:
        return recon[0]
    rgb = _libyuv_rgb(*recon, 601, 1, 8, 1, 1)
    return rgb if alpha is None else np.dstack([rgb, alpha])


def encode_avif(image: np.ndarray, path="image") -> bytes:
    """An AVIF of (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA uint8
    samples of the kind `cv2.imwrite(".avif")` writes at its defaults:
    cv2's boxes, brands and properties, its colour conversion
    (`rgb_to_yuv420`), its sequence header fields and its quantizers
    (COLOUR_QINDEX, ALPHA_QINDEX), coded by the port's own AV1 encoder
    (`native/av1_enc.cc`), so its bytes and pixels are not libaom's.
    Like cv2, 16-bit samples fail (`ImwriteFailed`) and 2 channels raise
    ValueError; an alpha channel of all 255 is not written."""
    return encode_avif_recon(image, path)[0]


def write_avif(path, image: np.ndarray) -> None:
    data = encode_avif(image, path)
    Path(path).write_bytes(data)
