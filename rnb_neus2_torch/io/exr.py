"""OpenEXR read and write with numpy, zlib and the RLE helper of
`native/codecs.cc`: no `cv2` or `OpenEXR`, which the card's host does not
have.

Reads single-part scan-line files (the OpenEXR file layout: magic,
version, header attributes, line offset table, chunks) with HALF or FLOAT
channels, uncompressed or compressed with RLE, ZIPS or ZIP, in either
line order; the image is the data window. Channels come back as the JAX
package has them after `cv2.imread(IMREAD_UNCHANGED)` and its BGR flip:
R, G, B (and A) as float32 (H, W, 3|4) in RGB(A) order, a lone Y as
(H, W); HALF widens exactly. PIZ, PXR24, B44(A), DWAA/DWAB, tiles,
multi-part and deep files, UINT or subsampled channels and other channel
sets raise ValueError naming the file and the feature.

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
from .errors import unsupported

MAGIC = b"\x76\x2f\x31\x01"
NO, RLE, ZIPS, ZIP = 0, 1, 2, 3
COMPRESSION_NAMES = {0: "NO", 1: "RLE", 2: "ZIPS", 3: "ZIP", 4: "PIZ",
                     5: "PXR24", 6: "B44", 7: "B44A", 8: "DWAA",
                     9: "DWAB", 10: "HTJ2K"}
LINES_PER_CHUNK = {NO: 1, RLE: 1, ZIPS: 1, ZIP: 16}
UINT, HALF, FLOAT = 0, 1, 2
SAMPLE = {HALF: np.dtype("<f2"), FLOAT: np.dtype("<f4")}
TILED, DEEP, MULTIPART = 0x200, 0x800, 0x1000     # version flags
CHANNEL_SETS = {("B", "G", "R"): ("R", "G", "B"),
                ("A", "B", "G", "R"): ("R", "G", "B", "A"), ("Y",): ("Y",)}


def _refuse(path, what: str):
    unsupported(path, what)


def _cstr(blob: bytes, pos: int):
    end = blob.index(b"\0", pos)
    return blob[pos:end].decode("latin-1"), end + 1


def _header(blob: bytes, path):
    if not blob.startswith(MAGIC):
        raise ValueError(f"{path}: not an OpenEXR file")
    version, = struct.unpack_from("<I", blob, 4)
    flags = version & ~0xFF
    if flags & MULTIPART:
        _refuse(path, "multi-part EXR")
    if flags & DEEP:
        _refuse(path, "deep EXR")
    if flags & TILED:
        _refuse(path, "tiled EXR")
    attrs, pos = {}, 8
    while blob[pos] != 0:
        name, pos = _cstr(blob, pos)
        kind, pos = _cstr(blob, pos)
        size, = struct.unpack_from("<i", blob, pos)
        attrs[name] = (kind, blob[pos + 4:pos + 4 + size])
        pos += 4 + size
    kind = attrs.get("type", ("", b""))[1].rstrip(b"\0")
    if "tiles" in attrs or kind.startswith(b"tiled"):
        _refuse(path, "tiled EXR")
    if kind.startswith(b"deep"):
        _refuse(path, "deep EXR")
    return attrs, pos + 1


def _channels(data: bytes, path):
    """chlist → [(name, pixel type)] in file (alphabetical) order."""
    out, pos = [], 0
    while data[pos] != 0:
        name, pos = _cstr(data, pos)
        ptype, _, xs, ys = struct.unpack_from("<iB3xii", data, pos)
        pos += 16
        if ptype == UINT:
            _refuse(path, f"EXR UINT channel {name!r}")
        if ptype not in SAMPLE:
            _refuse(path, f"EXR pixel type {ptype} of channel {name!r}")
        if (xs, ys) != (1, 1):
            _refuse(path, f"subsampled EXR channel {name!r}")
        out.append((name, ptype))
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


def read_exr(path) -> np.ndarray:
    """float32 (H, W) for Y, (H, W, 3|4) RGB(A)."""
    blob = Path(path).read_bytes()
    attrs, pos = _header(blob, path)
    for need in ("channels", "compression", "dataWindow", "lineOrder"):
        if need not in attrs:
            raise ValueError(f"{path}: EXR header without {need!r}")
    comp = attrs["compression"][1][0]
    if comp not in LINES_PER_CHUNK:
        _refuse(path, f"EXR compression "
                f"{COMPRESSION_NAMES.get(comp, comp)}")
    chans = _channels(attrs["channels"][1], path)
    names = tuple(n for n, _ in chans)
    if names not in CHANNEL_SETS:
        _refuse(path, f"EXR channel set {list(names)} (R, G, B[, A] or a "
                "lone Y are read)")
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    sizes = [SAMPLE[t].itemsize * w for _, t in chans]
    line = sum(sizes)
    per = LINES_PER_CHUNK[comp]
    n_chunks = -(-h // per)
    offsets = struct.unpack_from(f"<{n_chunks}Q", blob, pos)
    raw = np.empty((h, line), np.uint8)
    for off in offsets:
        y, packed = struct.unpack_from("<ii", blob, off)
        first = y - y0
        rows = min(per, h - first)
        if not 0 <= first < h or first % per:
            raise ValueError(f"{path}: EXR chunk at line {y} is outside "
                             "the data window")
        data = blob[off + 8:off + 8 + packed]
        size = rows * line
        if packed < size and comp != NO:
            try:
                data = (native.exr_rle_decode(data, size) if comp == RLE
                        else zlib.decompress(data))
            except (ValueError, zlib.error) as e:
                raise ValueError(f"{path}: corrupt EXR chunk at line {y} "
                                 f"({e})") from None
            t = _unpredict(np.frombuffer(data, np.uint8))
        else:
            t = np.frombuffer(data, np.uint8)
        if t.size != size:
            raise ValueError(f"{path}: EXR chunk at line {y} holds "
                             f"{t.size} bytes, want {size}")
        raw[first:first + rows] = t.reshape(rows, line)
    planes, col = {}, 0
    for (name, ptype), nbytes in zip(chans, sizes):
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
