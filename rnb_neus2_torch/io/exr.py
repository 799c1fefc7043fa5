"""OpenEXR read and write with numpy, zlib and the C helpers of
`native/codecs.cc` (RLE) and `native/exr.cc` (PIZ, B44, DWA's DCT): no
`cv2` or `OpenEXR`, which the card's host does not have.

Reads what OpenEXR 3.1's `Imf::InputFile` reads, the call cv2's EXR
decoder makes: single-part and multi-part files (part 0, InputFile's
rule), scan-line or tiled (level (0, 0) of ONE, MIPMAP and RIPMAP tiles,
either rounding mode, any tile order), in either line order, compressed
with NO, RLE, ZIPS, ZIP, PIZ, PXR24, B44, B44A, DWAA or DWAB; a chunk
whose packed size is at least its raw size is stored raw. The image is
the data window. Channels come back as the JAX package has them after
`cv2.imread(IMREAD_UNCHANGED)` and its BGR flip: R, G, B (and A) as
float32 (H, W, 3|4) in RGB(A) order, a lone Y as (H, W); HALF widens
exactly. Deep files, UINT and subsampled channels (Y/RY/BY too) and
other channel sets raise `UnsupportedImage` naming the file and the
feature: what cv2 makes of them is cv2's own conversion, which no
reference here can run. A chunk that is cut short or corrupt raises
ValueError naming the file.

`write_exr` writes FLOAT channels (HALF for float16 samples) with ZIP
compression (FLOAT and ZIP are what the JAX `save_exr` asks cv2 for),
each channel under its own name.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

from . import native
from .errors import UnsupportedImage, check_size, unsupported

MAGIC = b"\x76\x2f\x31\x01"
NO, RLE, ZIPS, ZIP, PIZ, PXR24, B44, B44A, DWAA, DWAB = range(10)
COMPRESSION_NAMES = {0: "NO", 1: "RLE", 2: "ZIPS", 3: "ZIP", 4: "PIZ",
                     5: "PXR24", 6: "B44", 7: "B44A", 8: "DWAA",
                     9: "DWAB", 10: "HTJ2K"}
LINES_PER_CHUNK = {NO: 1, RLE: 1, ZIPS: 1, ZIP: 16, PIZ: 32, PXR24: 16,
                   B44: 32, B44A: 32, DWAA: 32, DWAB: 256}
UINT, HALF, FLOAT = 0, 1, 2
SAMPLE = {HALF: np.dtype("<f2"), FLOAT: np.dtype("<f4")}
SIZE = {UINT: 4, HALF: 2, FLOAT: 4}
TILED, DEEP, MULTIPART = 0x200, 0x800, 0x1000     # version flags
ONE_LEVEL, MIPMAP, RIPMAP = 0, 1, 2
CHANNEL_SETS = {("B", "G", "R"): ("R", "G", "B"),
                ("A", "B", "G", "R"): ("R", "G", "B", "A"), ("Y",): ("Y",)}


def _refuse(path, what: str):
    unsupported(path, what)


def _cstr(blob: bytes, pos: int):
    end = blob.index(b"\0", pos)
    return blob[pos:end].decode("latin-1"), end + 1


def _attrs(blob: bytes, pos: int):
    """One header's attributes from `pos` → ({name: (type, bytes)}, the
    position after its terminating NUL)."""
    attrs = {}
    while blob[pos] != 0:
        name, pos = _cstr(blob, pos)
        kind, pos = _cstr(blob, pos)
        size, = struct.unpack_from("<i", blob, pos)
        if size < 0 or pos + 4 + size > len(blob):
            raise ValueError("attribute past the end of the file")
        attrs[name] = (kind, blob[pos + 4:pos + 4 + size])
        pos += 4 + size
    return attrs, pos + 1


def _header(blob: bytes, path):
    """→ (part 0's attributes, with "_tiled" and "_multipart" added, the
    position of its offset table). Part 0 is what `Imf::InputFile`
    reads."""
    if not blob.startswith(MAGIC) or len(blob) < 8:
        raise ValueError(f"{path}: not an OpenEXR file")
    version, = struct.unpack_from("<I", blob, 4)
    flags = version & ~0xFF
    try:
        attrs, pos = _attrs(blob, 8)
        if flags & MULTIPART:
            while blob[pos] != 0:           # the other parts' headers
                _, pos = _attrs(blob, pos)
            pos += 1
    except (ValueError, IndexError, struct.error) as e:
        raise ValueError(f"{path}: broken EXR header ({e})") from None
    kind = attrs.get("type", ("", b""))[1].rstrip(b"\0")
    if kind.startswith(b"deep") or (flags & DEEP and not flags & MULTIPART):
        _refuse(path, "deep EXR")
    if flags & MULTIPART:
        attrs["_tiled"] = kind.startswith(b"tiled")
    else:
        attrs["_tiled"] = bool(flags & TILED) or kind.startswith(b"tiled")
    attrs["_multipart"] = bool(flags & MULTIPART)
    return attrs, pos


def _channels(data: bytes, path):
    """chlist → [(name, pixel type, pLinear)] in file (alphabetical)
    order; refuses UINT and subsampled channels."""
    out, pos = [], 0
    while data[pos] != 0:
        name, pos = _cstr(data, pos)
        ptype, plinear, xs, ys = struct.unpack_from("<iB3xii", data, pos)
        pos += 16
        if ptype == UINT:
            _refuse(path, f"EXR UINT channel {name!r}")
        if ptype not in SAMPLE:
            _refuse(path, f"EXR pixel type {ptype} of channel {name!r}")
        if (xs, ys) != (1, 1):
            _refuse(path, f"subsampled EXR channel {name!r}")
        out.append((name, ptype, plinear))
    return out


def _unpredict(t: np.ndarray) -> np.ndarray:
    """ZIP/RLE post-processing: the byte predictor (a running sum of
    t - 128), then the two halves interleaved back."""
    x = t.copy()
    x[1:] -= np.uint8(128)
    x = np.cumsum(x, dtype=np.uint8)
    out = np.empty_like(x)
    half = (x.size + 1) // 2
    out[0::2], out[1::2] = x[:half], x[half:]
    return out


def _predict(raw: np.ndarray) -> np.ndarray:
    """The inverse of `_unpredict` (the writer's side)."""
    t = np.concatenate([raw[0::2], raw[1::2]])
    d = t.copy()
    d[1:] = t[1:] - t[:-1] + np.uint8(128)
    return d


def _inflate(data: bytes, size: int) -> bytes:
    """zlib with the exact size OpenEXR expects (inflating no further)."""
    d = zlib.decompressobj()
    out = d.decompress(data, size + 1)
    if len(out) != size or not d.eof:
        raise ValueError(f"zlib data of {len(out)}{'' if d.eof else '+'} "
                         f"bytes, want {size}")
    return out


def _pxr24(data: bytes, chans, nx: int, ny: int) -> np.ndarray:
    """PXR24: per row and channel the samples' byte planes, most
    significant first (FLOAT's low byte dropped), each row's values
    differenced; undone to the raw chunk."""
    sizes = [3 if t == FLOAT else SIZE[t] for _, t, _ in chans]
    t = np.frombuffer(_inflate(data, ny * nx * sum(sizes)), np.uint8)
    t = t.reshape(ny, nx * sum(sizes))
    out = np.empty((ny, nx * sum(SIZE[t] for _, t, _ in chans)), np.uint8)
    col = ocol = 0
    for (_, ptype, _), n in zip(chans, sizes):
        planes = t[:, col:col + n * nx].reshape(ny, n, nx).astype(np.uint32)
        col += n * nx
        diff = np.zeros((ny, nx), np.uint32)
        for k in range(n):
            shift = 8 * (SIZE[ptype] - 1 - k)
            diff |= planes[:, k] << np.uint32(shift)
        pixel = np.cumsum(diff, axis=1, dtype=np.uint32)
        width = SIZE[ptype]
        view = pixel.astype("<u2" if width == 2 else "<u4")
        out[:, ocol:ocol + width * nx] = view.view(np.uint8).reshape(ny, -1)
        ocol += width * nx
    return out.reshape(-1)


# DWA (ImfDwaCompressor.cpp): the channel rules of a version 2 block, how
# each channel is coded, and the decode of the three kinds
DWA_UNKNOWN, DWA_LOSSY, DWA_RLE = 0, 1, 2
DWA_SIZES = ("version", "unknown_uncompressed", "unknown_compressed",
             "ac_compressed", "dc_compressed", "rle_compressed",
             "rle_uncompressed", "rle_raw", "ac_count", "dc_count",
             "ac_compression")
STATIC_HUFFMAN, DEFLATE = 0, 1


def _dwa_rules(data: bytes, pos: int, size: int) -> list:
    """The classifier rules: suffix, scheme, CSC index, case flag, type."""
    rules, end = [], pos + size
    while pos < end:
        stop = data.index(b"\0", pos, end)
        suffix = data[pos:stop].decode("latin-1")
        if stop + 3 > end:
            raise ValueError("truncated DWA rule")
        value, ptype = data[stop + 1], data[stop + 2]
        csc = (value >> 4) - 1
        scheme = (value >> 2) & 3
        if not -1 <= csc < 3 or scheme > DWA_RLE or ptype > FLOAT:
            raise ValueError("corrupt DWA rule")
        rules.append((suffix, scheme, csc, bool(value & 1), ptype))
        pos = stop + 3
    return rules


def _dwa(data: bytes, chans, nx: int, ny: int, path) -> np.ndarray:
    """One DWAA / DWAB chunk → the raw chunk. Lossy channels (R, G, B, Y
    and the like, by the block's rules) come from `native.exr_dwa_lossy`;
    RLE and UNKNOWN ones are bytes."""
    if len(data) < 90:
        raise ValueError("DWA header cut short")
    sz = dict(zip(DWA_SIZES, struct.unpack_from("<11Q", data)))
    if sz["version"] > 2:
        raise ValueError(f"DWA data of version {sz['version']}")
    if sz["version"] < 2:
        _refuse(path, f"EXR DWA data of version {sz['version']}")
    rule_size, = struct.unpack_from("<H", data, 88)
    if rule_size < 2:
        raise ValueError("corrupt DWA rules")
    rules = _dwa_rules(data, 90, rule_size - 2)
    pos = 88 + rule_size
    parts = ("unknown_compressed", "ac_compressed", "dc_compressed",
             "rle_compressed")
    if any(sz[k] > len(data) for k in parts) \
            or pos + sum(sz[k] for k in parts) > len(data):
        raise ValueError("DWA data cut short")
    blob = {}
    for k in parts:
        blob[k] = data[pos:pos + sz[k]]
        pos += sz[k]
    # classify: a rule matches the name's suffix (after the last '.') and
    # the type; R, G and B of one prefix form a colour set
    scheme, sets = [], {}
    for i, (name, ptype, _) in enumerate(chans):
        prefix, _, suffix = name.rpartition(".")
        sets.setdefault(prefix, [-1, -1, -1])
        s = DWA_UNKNOWN
        for r_suffix, r_scheme, csc, nocase, r_type in rules:
            if r_type == ptype and (suffix.lower() if nocase else suffix) \
                    == r_suffix:
                s = r_scheme
                if csc >= 0:
                    sets[prefix][csc] = i
        scheme.append(s)
    csc_sets = [v for _, v in sorted(sets.items()) if min(v) >= 0]
    raw_size = nx * ny * sum(SIZE[t] for _, t, _ in chans)
    blocks = -(-nx // 8) * -(-ny // 8) * scheme.count(DWA_LOSSY)
    if sz["ac_count"] > 63 * blocks or sz["dc_count"] > blocks \
            or sz["unknown_uncompressed"] > raw_size \
            or sz["rle_raw"] > raw_size \
            or sz["rle_uncompressed"] > 2 * raw_size + 64:
        raise ValueError("corrupt DWA header")
    planes = [None] * len(chans)
    # UNKNOWN: zlib of the channels' XDR samples, channel after channel
    unknown = [i for i, s in enumerate(scheme) if s == DWA_UNKNOWN]
    if sz["unknown_compressed"]:
        raw = _inflate(blob["unknown_compressed"],
                       sz["unknown_uncompressed"])
    else:
        raw = b""
    at = 0
    for i in unknown:
        n = nx * ny * SIZE[chans[i][1]]
        if at + n > len(raw):
            raise ValueError("DWA UNKNOWN data cut short")
        planes[i] = np.frombuffer(raw, np.uint8, n, at).reshape(ny, -1)
        at += n
    # RLE: zlib, then OpenEXR's RLE, of each channel's byte planes
    rle = [i for i, s in enumerate(scheme) if s == DWA_RLE]
    raw = b""
    if sz["rle_raw"]:
        packed = _inflate(blob["rle_compressed"], sz["rle_uncompressed"])
        raw = native.exr_rle_decode(packed, sz["rle_raw"])
        if len(raw) != sz["rle_raw"]:
            raise ValueError("DWA RLE data corrupt")
    at = 0
    for i in rle:
        width = SIZE[chans[i][1]]
        n = nx * ny * width
        if at + n > len(raw):
            raise ValueError("DWA RLE data cut short")
        byte_planes = np.frombuffer(raw, np.uint8, n, at).reshape(width, -1)
        planes[i] = np.ascontiguousarray(byte_planes.T).reshape(ny, -1)
        at += n
    # lossy DCT: the colour sets, then the other lossy channels in order
    ac = np.zeros(0, np.uint16)
    if sz["ac_compressed"]:
        if sz["ac_compression"] == STATIC_HUFFMAN:
            ac = native.exr_huf_decode(blob["ac_compressed"], sz["ac_count"])
        elif sz["ac_compression"] == DEFLATE:
            ac = np.frombuffer(_inflate(blob["ac_compressed"],
                                        2 * sz["ac_count"]), "<u2")
        else:
            raise ValueError(f"DWA AC compression {sz['ac_compression']}")
    dc = np.zeros(0, np.uint16)
    if sz["dc_compressed"]:
        dc = _unpredict(np.frombuffer(_inflate(
            blob["dc_compressed"], 2 * sz["dc_count"]), np.uint8)).view("<u2")
    elif sz["dc_count"]:
        raise ValueError("DWA DC data corrupt")
    groups = [(s, True) for s in csc_sets]
    done = {i for s in csc_sets for i in s}
    groups += [([i], not chans[i][2]) for i, s in enumerate(scheme)
               if s == DWA_LOSSY and i not in done]
    a = d = 0
    for members, linear in groups:
        out, used_ac, used_dc = native.exr_dwa_lossy(
            ac[a:], dc[d:], len(members), nx, ny, linear)
        a += used_ac
        d += used_dc
        for k, i in enumerate(members):
            h = out[k]
            if chans[i][1] == FLOAT:
                h = h.view(np.float16).astype("<f4").view(np.uint32)
            planes[i] = h.view(np.uint8).reshape(ny, -1)
    if any(p is None for p in planes):
        raise ValueError("DWA channel without data")
    return np.concatenate(planes, axis=1).reshape(-1)


def _decompress(comp: int, data: bytes, chans, nx: int, ny: int, path):
    """One chunk's data → its raw bytes (per row, per channel, nx
    little-endian samples)."""
    types = [t for _, t, _ in chans]
    if comp == NO:
        raise ValueError(f"an uncompressed chunk of {len(data)} bytes")
    if comp == RLE:
        raw = native.exr_rle_decode(data, ny * nx * sum(SIZE[t]
                                                        for t in types))
        return _unpredict(np.frombuffer(raw, np.uint8))
    if comp in (ZIPS, ZIP):
        size = ny * nx * sum(SIZE[t] for t in types)
        return _unpredict(np.frombuffer(_inflate(data, size), np.uint8))
    if comp == PIZ:
        return np.frombuffer(native.exr_piz_decode(data, types, nx, ny),
                             np.uint8)
    if comp == PXR24:
        return _pxr24(data, chans, nx, ny)
    if comp in (B44, B44A):
        return np.frombuffer(native.exr_b44_decode(
            data, types, [p for _, _, p in chans], nx, ny), np.uint8)
    return _dwa(data, chans, nx, ny, path)


def _level0_tiles(attrs, w: int, h: int, path):
    """The tile description → (tile width, tile height, tiles across,
    tiles down) of level (0, 0), whose offsets open the table."""
    if "tiles" not in attrs:
        raise ValueError(f"{path}: tiled EXR header without 'tiles'")
    if len(attrs["tiles"][1]) < 9:
        raise ValueError(f"{path}: broken EXR tile description")
    tx, ty, mode = struct.unpack("<IIB", attrs["tiles"][1][:9])
    if tx < 1 or ty < 1 or (mode & 0xF) > RIPMAP:
        raise ValueError(f"{path}: EXR tile description {tx}x{ty} "
                         f"mode {mode}")
    return tx, ty, -(-w // tx), -(-h // ty)


def read_exr(path) -> np.ndarray:
    """float32 (H, W) for Y, (H, W, 3|4) RGB(A)."""
    blob = Path(path).read_bytes()
    attrs, pos = _header(blob, path)
    for need in ("channels", "compression", "dataWindow", "lineOrder"):
        if need not in attrs:
            raise ValueError(f"{path}: EXR header without {need!r}")
    try:
        comp = attrs["compression"][1][0]
        x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    except (IndexError, struct.error):
        raise ValueError(f"{path}: broken EXR header attribute") from None
    if comp not in LINES_PER_CHUNK:
        _refuse(path, f"EXR compression "
                f"{COMPRESSION_NAMES.get(comp, comp)}")
    try:
        chans = _channels(attrs["channels"][1], path)
    except (IndexError, struct.error) as e:
        raise ValueError(f"{path}: broken EXR channel list ({e})") from None
    names = tuple(n for n, _, _ in chans)
    if names not in CHANNEL_SETS:
        _refuse(path, f"EXR channel set {list(names)} (R, G, B[, A] or a "
                "lone Y are read)")
    w, h = x1 - x0 + 1, y1 - y0 + 1
    check_size(path, w, h)
    sizes = [SIZE[t] * w for _, t, _ in chans]
    line = sum(sizes)
    if attrs["_tiled"]:
        tx, ty, nx_tiles, ny_tiles = _level0_tiles(attrs, w, h, path)
        blocks = [(i % nx_tiles, i // nx_tiles)
                  for i in range(nx_tiles * ny_tiles)]
    else:
        per = LINES_PER_CHUNK[comp]
        blocks = list(range(-(-h // per)))
    if pos + 8 * len(blocks) > len(blob):
        raise ValueError(f"{path}: EXR offset table cut short")
    offsets = struct.unpack_from(f"<{len(blocks)}Q", blob, pos)
    head = 4 if attrs["_multipart"] else 0
    raw = np.empty((h, line), np.uint8)
    for block, off in zip(blocks, offsets):
        if off >= len(blob):
            raise ValueError(f"{path}: EXR chunk offset {off} outside the "
                             "file")
        try:
            if attrs["_multipart"] and struct.unpack_from(
                    "<i", blob, off)[0] != 0:
                raise ValueError("a chunk of another part")
            if attrs["_tiled"]:
                dx, dy = block
                tile = struct.unpack_from("<4ii", blob, off + head)
                if tile[:4] != (dx, dy, 0, 0):
                    raise ValueError(f"tile {tile[:4]} where ({dx}, {dy}, "
                                     "0, 0) is due")
                packed, where = tile[4], f"tile ({dx}, {dy})"
                cx, first = dx * tx, dy * ty
                nx, rows = min(tx, w - cx), min(ty, h - first)
                data_at = off + head + 20
            else:
                y, packed = struct.unpack_from("<ii", blob, off + head)
                first, where = y - y0, f"line {y}"
                if first != block * per:
                    raise ValueError("outside the data window")
                cx, nx, rows = 0, w, min(per, h - first)
                data_at = off + head + 8
        except struct.error:
            raise ValueError(f"{path}: EXR chunk offset {off} outside the "
                             "file") from None
        except ValueError as e:
            raise ValueError(f"{path}: EXR chunk at offset {off}: {e}") \
                from None
        if packed < 0 or data_at + packed > len(blob):
            raise ValueError(f"{path}: EXR {where}: chunk cut short")
        data = blob[data_at:data_at + packed]
        size = rows * nx * sum(SIZE[t] for _, t, _ in chans)
        if packed < size:
            try:
                t = _decompress(comp, data, chans, nx, rows, path)
            except UnsupportedImage:
                raise
            except (ValueError, zlib.error, struct.error, IndexError) as e:
                raise ValueError(f"{path}: corrupt EXR chunk at {where} "
                                 f"({e})") from None
        else:
            t = np.frombuffer(data, np.uint8)
        if t.size != size:
            raise ValueError(f"{path}: EXR chunk at {where} holds "
                             f"{t.size} bytes, want {size}")
        t = t.reshape(rows, -1)
        col = 0
        for (_, ptype, _), nbytes in zip(chans, sizes):
            n = SIZE[ptype] * nx
            raw[first:first + rows, col + SIZE[ptype] * cx:
                col + SIZE[ptype] * cx + n] = t[:, :n]
            t = t[:, n:]
            col += nbytes
    planes, col = {}, 0
    for (name, ptype, _), nbytes in zip(chans, sizes):
        planes[name] = np.ascontiguousarray(raw[:, col:col + nbytes]) \
            .view(SAMPLE[ptype]).astype(np.float32)
        col += nbytes
    order = CHANNEL_SETS[names]
    if order == ("Y",):
        return planes["Y"]
    return np.stack([planes[n] for n in order], axis=-1)


def _attr(name: str, kind: str, value: bytes) -> bytes:
    return (name.encode() + b"\0" + kind.encode() + b"\0"
            + struct.pack("<i", len(value)) + value)


def write_exr(path, image: np.ndarray) -> None:
    """(H, W) as Y, (H, W, 3) as R, G, B, (H, W, 4) as R, G, B, A; HALF
    channels for float16 samples, FLOAT for any other (cast to float32);
    ZIP compression, increasing line order."""
    image = np.asarray(image)
    ptype = HALF if image.dtype == np.float16 else FLOAT
    image = image.astype(SAMPLE[ptype])
    if image.ndim == 2:
        image = image[..., None]
    h, w, ch = image.shape
    names = {1: ("Y",), 3: ("R", "G", "B"), 4: ("R", "G", "B", "A")}.get(ch)
    if names is None:
        raise ValueError(f"EXR images have 1, 3 or 4 channels, not {ch}")
    stored = sorted(range(ch), key=lambda i: names[i])
    chlist = b"".join(names[i].encode() + b"\0"
                      + struct.pack("<iB3xii", ptype, 0, 1, 1)
                      for i in stored) + b"\0"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (MAGIC + struct.pack("<I", 2)
              + _attr("channels", "chlist", chlist)
              + _attr("compression", "compression", bytes([ZIP]))
              + _attr("dataWindow", "box2i", box)
              + _attr("displayWindow", "box2i", box)
              + _attr("lineOrder", "lineOrder", b"\0")
              + _attr("pixelAspectRatio", "float", struct.pack("<f", 1))
              + _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
              + _attr("screenWindowWidth", "float", struct.pack("<f", 1))
              + b"\0")
    # each line: every channel's samples in turn, little-endian float32
    lines = np.ascontiguousarray(image[..., stored].transpose(0, 2, 1)) \
        .view(np.uint8).reshape(h, -1)
    per = LINES_PER_CHUNK[ZIP]
    chunks = []
    for y in range(0, h, per):
        raw = lines[y:y + per].reshape(-1)
        packed = zlib.compress(_predict(raw).tobytes(), 6)
        if len(packed) >= raw.size:
            packed = raw.tobytes()
        chunks.append(struct.pack("<ii", y, len(packed)) + packed)
    pos = len(header) + 8 * len(chunks)
    table = []
    for c in chunks:
        table.append(pos)
        pos += len(c)
    Path(path).write_bytes(header + struct.pack(f"<{len(table)}Q", *table)
                           + b"".join(chunks))
