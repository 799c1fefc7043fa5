"""WebP, read as cv2 reads it: OpenCV's grfmt_webp on libwebp's
WebPDecodeBGR(A)Into, byte for byte.

The container: RIFF/WEBP with a simple `VP8 ` (lossy) or `VP8L`
(lossless) chunk, or `VP8X` with an `ALPH` chunk before a lossy frame.
Lossless files (VP8L) decode to exact ARGB: prefix-code groups under a
meta prefix image, the colour cache, LZ77 backward references with the
120-entry distance map, and the four transforms (predictor in 14 modes,
cross-colour, subtract-green, colour indexing with pixel bundling),
undone in reverse order. Lossy files (VP8 key frames) decode to YUV
4:2:0 (the boolean decoder, segment and quantiser headers, token
probabilities, dequantisation, the inverse WHT and DCT, 16x16, 4x4 and
chroma intra prediction, the simple and normal loop filters, token
partitions), then to RGB with libwebp's fancy upsampling and its
fixed-point VP8YUVToR/G/B. ALPH is raw or VP8L-compressed, with the
horizontal, vertical or gradient filter.

The byte-serial steps (prefix codes, the boolean decoder and its tokens,
prediction and the loop filters, which run block after block) are in
`native/codecs.cc`; the transforms that vectorise are numpy here.

cv2 returns BGRA in "unchanged" where libwebp reports alpha (a VP8L
header's alpha bit; a VP8X alpha flag or an ALPH chunk), else BGR;
"color" drops the alpha; "grey" is cvtColor's BGR2GRAY. Of an animated
file (VP8X with ANIM and ANMF chunks) cv2 returns the first frame as
libwebp's animation decoder gives it: the frame at its offset on a
canvas of transparent black, with alpha where the VP8X flag says so.

"color" and "grey" apply the EXIF orientation, as cv2 5 does: the first
`EXIF` chunk of a VP8X file whose EXIF flag (0x08) is set, still or
animated, read as a TIFF-structured blob (one that starts with
"Exif\\0\\0" carries none); a chunk without the flag, or in a file
without VP8X, is not read. "unchanged" never applies it.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from . import exif, native
from .errors import unreadable
from .jpeg import cvt_grey


def is_webp(head: bytes) -> bool:
    return len(head) >= 12 and head[:4] == b"RIFF" and head[8:12] == b"WEBP"


# ------------------------------------------------------------------ VP8L
def _vp8l_argb(data: bytes, w: int, h: int, path) -> np.ndarray:
    """A VP8L image stream of w x h → (h, w) uint32 ARGB."""
    out, tinfo, tdata, ntrans = native.vp8l_decode(data, w, h)
    if ntrans < 0:
        unreadable(path, "bad VP8L bitstream")
    transforms = [tuple(tinfo[4 * i:4 * i + 4]) for i in range(ntrans)]
    xs = w
    for kind, bits, before, _ in transforms:
        if kind == 3:
            xs = -(-before // (1 << bits))
    px = out[:h * xs].reshape(h, xs)
    for kind, bits, before, off in transforms[::-1]:
        if kind == 3:
            size = 1 << (8 >> bits)
        else:
            size = -(-before // (1 << bits)) * -(-h // (1 << bits))
        data_i = tdata[off:off + size]
        if kind == 0:
            px = np.ascontiguousarray(px, np.uint32)
            native.vp8l_unpredict(px, data_i, bits)
        elif kind == 1:
            px = _uncross(px, data_i, bits)
        elif kind == 2:
            g = (px >> 8) & 0xFF
            r = (((px >> 16) & 0xFF) + g) & 0xFF
            b = ((px & 0xFF) + g) & 0xFF
            px = (px & 0xFF00FF00) | (r << 16) | b
        else:
            px = _unindex(px, data_i, bits, before)
    return px.astype(np.uint32)


def _tiles(sub: np.ndarray, bits: int, h: int, w: int) -> np.ndarray:
    tw = -(-w // (1 << bits))
    grid = sub.reshape(-1, tw)
    return np.repeat(np.repeat(grid, 1 << bits, 0), 1 << bits, 1)[:h, :w]


def _uncross(px, sub, bits):
    h, w = px.shape
    m = _tiles(sub, bits, h, w)
    s8 = lambda v: ((v & 0xFF) ^ 0x80).astype(np.int32) - 0x80  # noqa: E731
    g2r, g2b, r2b = s8(m), s8(m >> 8), s8(m >> 16)
    green = s8(px >> 8)
    red = (((px >> 16) & 0xFF).astype(np.int32) + ((g2r * green) >> 5)) \
        & 0xFF
    blue = (px & 0xFF).astype(np.int32) + ((g2b * green) >> 5)
    blue = (blue + ((r2b * s8(red)) >> 5)) & 0xFF
    return (px & 0xFF00FF00) | (red.astype(np.uint32) << 16) \
        | blue.astype(np.uint32)


def _unindex(px, cmap, bits, width):
    idx = ((px >> 8) & 0xFF).astype(np.int64)
    if bits:
        per, depth = 1 << bits, 8 >> bits
        shifts = np.arange(per) * depth
        idx = ((idx[..., None] >> shifts) & ((1 << depth) - 1)) \
            .reshape(idx.shape[0], -1)[:, :width]
    return cmap[idx]


# ------------------------------------------------------------------- VP8
def _idct(c: np.ndarray) -> np.ndarray:
    """TransformOne's output before it is added: (..., 16) dequantized
    coefficients (raster order) → (..., 16) residuals."""
    m = c.astype(np.int32).reshape(c.shape[:-1] + (4, 4))

    def mul1(a):
        return ((a * 20091) >> 16) + a

    def mul2(a):
        return (a * 35468) >> 16

    def pass_(i0, i4, i8, i12, dc_bias):
        a = i0 + dc_bias + i8
        b = i0 + dc_bias - i8
        c_ = mul2(i4) - mul1(i12)
        d = mul1(i4) + mul2(i12)
        return np.stack([a + d, b + c_, b - c_, a - d], -1)

    t = pass_(m[..., 0, :], m[..., 1, :], m[..., 2, :], m[..., 3, :], 0)
    out = pass_(t[..., 0, :], t[..., 1, :], t[..., 2, :], t[..., 3, :], 4)
    return (out >> 3).reshape(c.shape)


def _wht(c: np.ndarray) -> np.ndarray:
    """TransformWHT: (n, 16) Y2 coefficients → (n, 16) DCs of the Y blocks
    in raster order."""
    m = c.astype(np.int32).reshape(-1, 4, 4)
    a0 = m[:, 0] + m[:, 3]
    a1 = m[:, 1] + m[:, 2]
    a2 = m[:, 1] - m[:, 2]
    a3 = m[:, 0] - m[:, 3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], 1)   # [row][col]
    dc = t[:, :, 0] + 3
    b0 = dc + t[:, :, 3]
    b1 = t[:, :, 1] + t[:, :, 2]
    b2 = t[:, :, 1] - t[:, :, 2]
    b3 = dc - t[:, :, 3]
    out = np.stack([b0 + b1, b3 + b2, b0 - b1, b3 - b2], -1) >> 3
    return out.reshape(-1, 16)


def _vp8_yuv(data: bytes, path):
    info, mb, coeffs, code = native.vp8_parse(data)
    if code < 0:
        unreadable(path, "bad or truncated VP8 frame")
    w, h, mbw, mbh = (int(v) for v in info[:4])
    coeffs = coeffs.reshape(-1, 25, 16)
    mb = mb.reshape(-1, 20).copy()
    i16 = mb[:, 0] == 0
    dcs = _wht(coeffs[i16, 24])
    c = coeffs[:, :24].astype(np.int32)
    c[i16, :16, 0] = dcs
    mb[i16, 3] |= np.any(dcs != 0, axis=1).astype(np.uint8)
    resid = _idct(c).astype(np.int16)
    Y, U, V = native.vp8_reconstruct(info, mb, resid, mbw, mbh)
    cw, ch = (w + 1) // 2, (h + 1) // 2
    return w, h, Y[:h, :w], U[:ch, :cw], V[:ch, :cw]


def _fancy(near: np.ndarray, far: np.ndarray, w: int) -> np.ndarray:
    """libwebp's UpsampleRgbLinePair for one output row per pair of chroma
    rows (`near` the row it weighs 3:1): (rows, (w+1)//2) → (rows, w)."""
    tl, l_ = near.astype(np.int32), far.astype(np.int32)
    out = np.empty((near.shape[0], w), np.int32)
    out[:, 0] = (3 * tl[:, 0] + l_[:, 0] + 2) >> 2
    pairs = (w - 1) >> 1
    if pairs:
        a, b = tl[:, :pairs], tl[:, 1:pairs + 1]       # tl_uv, t_uv
        c, d = l_[:, :pairs], l_[:, 1:pairs + 1]       # l_uv, uv
        avg = a + b + c + d + 8
        diag12 = (avg + 2 * (b + c)) >> 3
        diag03 = (avg + 2 * (a + d)) >> 3
        out[:, 1:2 * pairs:2] = (diag12 + a) >> 1
        out[:, 2:2 * pairs + 1:2] = (diag03 + b) >> 1
    if not w & 1:
        out[:, w - 1] = (3 * tl[:, pairs] + l_[:, pairs] + 2) >> 2
    return out


def _upsample(plane: np.ndarray, h: int, w: int) -> np.ndarray:
    """EmitFancyRGB's chroma for every output row: row 0 from chroma row
    0 alone; rows 2k-1 and 2k between chroma rows k-1 and k, each nearer
    its own; the last row of an even height from the last chroma row."""
    r = np.arange(h)
    k = (r + 1) // 2
    near = np.where(r % 2 == 1, k - 1, k)
    far = np.where(r % 2 == 1, k, k - 1)
    last = plane.shape[0] - 1
    near, far = np.minimum(near, last), np.clip(far, 0, last)
    far[0] = near[0]
    return _fancy(plane[near], plane[far], w)


def yuv_to_rgb(Y, U, V) -> np.ndarray:
    """VP8YUVToR/G/B (14-bit fixed point, clipped) after fancy upsampling:
    → (h, w, 3) uint8."""
    h, w = Y.shape
    u = _upsample(U, h, w)
    v = _upsample(V, h, w)
    y = Y.astype(np.int32)

    def mult_hi(a, coeff):
        return (a * coeff) >> 8

    def clip8(a):
        return np.where((a & ~((256 << 6) - 1)) == 0, a >> 6,
                        np.where(a < 0, 0, 255))

    yy = mult_hi(y, 19077)
    r = clip8(yy + mult_hi(v, 26149) - 14234)
    g = clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708)
    b = clip8(yy + mult_hi(u, 33050) - 17685)
    return np.stack([r, g, b], -1).astype(np.uint8)


def _alpha(chunk: bytes, w: int, h: int, path) -> np.ndarray:
    """An ALPH chunk → (h, w) uint8."""
    if not chunk:
        unreadable(path, "empty ALPH chunk")
    head = chunk[0]
    method, filt, pre, rsrv = head & 3, (head >> 2) & 3, (head >> 4) & 3, \
        head >> 6
    if method > 1 or pre > 1 or rsrv:
        unreadable(path, f"ALPH header {head:#04x}")
    if method == 0:
        if len(chunk) - 1 < w * h:
            unreadable(path, "ALPH data ends early")
        a = np.frombuffer(chunk, np.uint8, w * h, 1).reshape(h, w)
    else:
        a = ((_vp8l_argb(chunk[1:], w, h, path) >> 8) & 0xFF) \
            .astype(np.uint8)
    a = a.astype(np.int64)
    if filt == 1:
        col0 = np.cumsum(a[:, 0])
        rest = a.copy()
        rest[:, 0] = 0
        a = col0[:, None] + np.cumsum(rest, axis=1)
    elif filt == 2:
        a = a.copy()
        a[0] = np.cumsum(a[0])
        a = np.cumsum(a, axis=0)
    elif filt == 3:
        a8 = np.ascontiguousarray(a.astype(np.uint8))
        native.alpha_ungradient(a8)
        return a8
    return (a & 0xFF).astype(np.uint8)


# -------------------------------------------------------------- container
def _chunks(blob: bytes, pos: int, end: int, path) -> list:
    """The (tag, payload) chunks of blob[pos:end], each padded to even."""
    out = []
    while pos + 8 <= end:
        tag = blob[pos:pos + 4]
        size = struct.unpack_from("<I", blob, pos + 4)[0]
        if pos + 8 + size > end:
            unreadable(path, f"WebP chunk {tag!r} ends past its container")
        out.append((tag, blob[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _orientation(vp8x: bytes, chunks) -> int:
    """The EXIF orientation of a VP8X file: its first `EXIF` chunk's,
    read only where the VP8X flag announces it (libwebp's demuxer keeps
    the chunk only then); 1 otherwise."""
    if vp8x[0] & 0x08:
        for tag, body in chunks:
            if tag == b"EXIF":
                return exif.orientation(body)
    return 1


def _decode(blob: bytes, path):
    """→ (RGB(A) uint8 image, has_alpha as libwebp reports it, EXIF
    orientation)."""
    riff = struct.unpack_from("<I", blob, 4)[0] if len(blob) >= 12 else 0
    if riff < 12 or riff > len(blob) - 8:
        unreadable(path, "WebP RIFF size past the end of the file")
    chunks = _chunks(blob, 12, 8 + riff, path)
    if not chunks:
        unreadable(path, "WebP file without chunks")
    canvas, alpha_flag, orientation = None, False, 1
    if chunks[0][0] == b"VP8X":
        body = chunks[0][1]
        if len(body) < 10:
            unreadable(path, "short VP8X chunk")
        alpha_flag = bool(body[0] & 0x10)
        canvas = (int.from_bytes(body[4:7], "little") + 1,
                  int.from_bytes(body[7:10], "little") + 1)
        orientation = _orientation(body, chunks[1:])
        if body[0] & 0x02:
            return (_first_frame(chunks[1:], canvas, path), alpha_flag,
                    orientation)
        chunks = chunks[1:]
    return _still(chunks, canvas, alpha_flag, path) + (orientation,)


def _first_frame(chunks, canvas, path) -> np.ndarray:
    """WebPAnimDecoder's first frame: the first ANMF's image at its
    offset on a canvas of transparent black."""
    for tag, body in chunks:
        if tag != b"ANMF":
            continue
        if len(body) < 16:
            unreadable(path, "short ANMF chunk")
        x = 2 * int.from_bytes(body[0:3], "little")
        y = 2 * int.from_bytes(body[3:6], "little")
        fw = int.from_bytes(body[6:9], "little") + 1
        fh = int.from_bytes(body[9:12], "little") + 1
        if x + fw > canvas[0] or y + fh > canvas[1]:
            unreadable(path, "ANMF frame outside its canvas")
        rgba, _ = _still(_chunks(body, 16, len(body), path), (fw, fh),
                         False, path)
        out = np.zeros((canvas[1], canvas[0], 4), np.uint8)
        out[y:y + fh, x:x + fw] = rgba
        return out
    unreadable(path, "animated WebP without a frame")


def _still(chunks, canvas, alpha_flag, path):
    alph = None
    for tag, body in chunks:
        if tag == b"ALPH" and alph is None:
            alph = body
        if tag == b"VP8L":
            if len(body) < 5 or body[0] != 0x2F:
                unreadable(path, "bad VP8L header")
            bits = int.from_bytes(body[1:5], "little")
            w, h = (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
            has_alpha, version = (bits >> 28) & 1, bits >> 29
            if version or (canvas and canvas != (w, h)):
                unreadable(path, "VP8L header that libwebp refuses")
            argb = _vp8l_argb(body[5:], w, h, path)
            rgba = np.stack([(argb >> 16) & 0xFF, (argb >> 8) & 0xFF,
                             argb & 0xFF, argb >> 24], -1).astype(np.uint8)
            return rgba, bool(has_alpha)
        if tag == b"VP8 ":
            w, h, Y, U, V = _vp8_yuv(body, path)
            if canvas and canvas != (w, h):
                unreadable(path, "VP8 frame of another size than its canvas")
            rgb = yuv_to_rgb(Y, U, V)
            has_alpha = alpha_flag or alph is not None
            a = _alpha(alph, w, h, path) if alph is not None else \
                np.full((h, w), 255, np.uint8)
            return np.concatenate([rgb, a[..., None]], -1), has_alpha
    unreadable(path, "WebP file without an image chunk")


def read_webp(path, mode: str = "unchanged") -> np.ndarray:
    """A WebP as cv2.imread reads it, RGB(A) order (see the module)."""
    if mode not in ("unchanged", "color", "grey"):
        raise ValueError(f"unknown read mode {mode!r}")
    rgba, has_alpha, orientation = _decode(Path(path).read_bytes(), path)
    if mode == "unchanged":
        return rgba if has_alpha else np.ascontiguousarray(rgba[..., :3])
    img = cvt_grey(rgba) if mode == "grey" else rgba[..., :3]
    return exif.orient(img, orientation)


# ---------------------------------------------------------------- writing
def encode_webp(image: np.ndarray, path="image") -> bytes:
    """A lossless WebP of (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA
    uint8 samples that reads back as the file `cv2.imwrite(".webp")`
    writes at its default quality (libwebp's lossless encoder): grey as
    three equal channels, the alpha hint set where some alpha is under
    255. The colour under alpha 0 is what libwebp leaves there at cv2's
    settings (`exact = 0`): its analysis (`native/codecs.cc:vp8l_analyze`)
    picks the transform set and, for a spatial one, the predictor's mode
    per tile, and each pixel of alpha 0 takes its prediction's RGB. The
    stream is the port's own simple VP8L (`native/codecs.cc:vp8l_encode`)
    of those pixels, so the bytes differ from libwebp's and the pixels do
    not."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"{path}: WebP takes 8-bit samples, not "
                         f"{image.dtype}")
    if image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=-1)
    if image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError(f"{path}: WebP takes 1, 3 or 4 channels, not shape "
                         f"{image.shape}")
    h, w, nc = image.shape
    if not (0 < w <= 16383 and 0 < h <= 16383):
        raise ValueError(f"{path}: a WebP is at most 16383 pixels a side, "
                         f"not {w}x{h}")
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :nc] = image
    if nc == 4 and not rgba[..., 3].all():
        rgba = native.vp8l_analyze(rgba)[0]
    alpha_used = nc == 4 and bool((rgba[..., 3] != 255).any())
    data = native.vp8l_encode(rgba, alpha_used)
    chunk = b"VP8L" + struct.pack("<I", len(data)) + data \
        + b"\0" * (len(data) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


def write_webp(path, image: np.ndarray) -> None:
    data = encode_webp(image, path)
    Path(path).write_bytes(data)
