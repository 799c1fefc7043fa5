"""The EXR variants (`io/exr.py`, `native/exr.cc`): PIZ, PXR24, B44/B44A,
DWAA/DWAB, tiled and multi-part files written by OpenEXR 3.1.5 and
committed in `tests/torch_fixtures/formats/` (`make_fixtures.py exr`),
each held bit for bit against the library's `Imf::InputFile` decode with
FLOAT slices in `expected.npz` (cv2's EXR decoder reads that way; this
host's cv2 has no OpenEXR). The JAX loaders are fed that decode through
a patched `cv2.imread`. Neither OpenEXR nor its headers are needed here.
"""

import json
import struct
import tempfile
from pathlib import Path

import numpy as np
import pytest

import cv2
import rnb_neus2_tpu.io.image_io as jimage_io
from rnb_neus2_torch.io import exr, image_io, native, png
from rnb_neus2_torch.io.errors import UnsupportedImage

FIXTURES = Path(__file__).parent / "torch_fixtures" / "formats"
SCENE = Path(__file__).parent / "torch_fixtures" / "exr_scene"
EXPECTED = FIXTURES / "expected.npz"
ALL = sorted(p.name for p in FIXTURES.glob("exr_*.exr"))
REFUSED = {"exr_refused_deep.exr": "deep EXR",
           "exr_refused_uint.exr": "UINT channel",
           "exr_refused_subsampled.exr": "subsampled EXR channel"}
READ = [n for n in ALL if n not in REFUSED]


@pytest.fixture(scope="module")
def expected():
    with np.load(EXPECTED) as z:
        return {k.split(":")[0]: z[k] for k in z.files
                if k.endswith(".exr:unchanged")}


def test_the_fixtures_cover_the_variants():
    names = " ".join(ALL)
    for comp in ("piz", "pxr24", "b44", "b44a", "dwaa", "dwab"):
        for kind in ("half", "float", "mixed"):
            for chans in ("y", "rgb", "rgba"):
                if (chans, kind) != ("y", "mixed"):
                    assert f"exr_{comp}_{kind}_{chans}.exr" in ALL
        assert f"exr_{comp}_612x512.exr" in ALL
    for part in ("8x8", "16x32", "64x64", "one", "mipmap", "ripmap", "_up_",
                 "_down_", "increasing", "decreasing", "random", "multipart",
                 "plinear", "level5", "level45", "level200", "1x1"):
        assert part in names, part
    assert set(REFUSED) <= set(ALL)


@pytest.mark.parametrize("name", READ)
def test_read_raw_equals_the_library(name, expected):
    """Every readable fixture equals `Imf::InputFile`'s decode bit for
    bit: the lossless codecs, B44's and DWA's lossy ones (the same inverse
    DCT operations as the library's AVX code), every tile layout and part
    0 of the multi-part files."""
    got = image_io.read_raw(FIXTURES / name)
    want = expected[name]
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_what_stays_refused_raises_by_name(name):
    with pytest.raises(UnsupportedImage, match=REFUSED[name]):
        image_io.read_raw(FIXTURES / name)
    for mode in ("color", "grey"):
        with pytest.raises(UnsupportedImage, match="8-bit colour or grey"):
            image_io.read_image(FIXTURES / name, mode)


def _as_cv2(img):
    return img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]]


@pytest.mark.parametrize("name", [
    "exr_piz_half_y.exr", "exr_pxr24_float_rgb.exr", "exr_b44a_mixed_rgba.exr",
    "exr_dwaa_half_rgb.exr", "exr_dwab_float_rgba.exr",
    "exr_b44_plinear.exr", "exr_tiled_8x8_ripmap_up_random_dwaa.exr",
    "exr_multipart_tiled.exr", "exr_piz_612x512.exr"])
def test_loaders_equal_the_jax_package(name, expected, monkeypatch):
    """load_image, load_image_raw16 and load_normal of the port equal the
    JAX package's with `cv2.imread` returning the library's decode."""
    path = FIXTURES / name
    real = cv2.imread
    monkeypatch.setattr(cv2, "imread", lambda p, f=cv2.IMREAD_COLOR: (
        _as_cv2(expected[name]).copy() if str(p) == str(path)
        else real(p, f)))
    for fn in ("load_image", "load_image_raw16", "load_normal"):
        got, want = (getattr(m, fn)(path) for m in (image_io, jimage_io))
        assert got.dtype == want.dtype, fn
        np.testing.assert_array_equal(got, want, err_msg=fn)


def test_the_exr_scene_prepares_as_the_jax_package():
    """The committed EXR sphere (PIZ, DWAA, tiled mip-mapped ZIP and a
    2-part normal map; PXR24 and B44A albedos) prepares to the JAX
    package's digests and n2w."""
    import hashlib

    from rnb_neus2_torch.io.dataloaders import load_data
    from rnb_neus2_torch.io.prepare import prepare_testbed_data

    want = json.loads((SCENE / "expected.json").read_text())
    data = load_data(str(SCENE / "normals.sfm.json"),
                     albedo_sfm_path=str(SCENE / "albedos.sfm.json"),
                     mask_sfm_path=str(SCENE / "masks.sfm.json"))
    kinds = {Path(v[k]).suffix for v in data["views"]
             for k in ("normal_path", "albedo_path", "mask_path")}
    assert kinds == {".exr", ".png"}
    with tempfile.TemporaryDirectory() as d:
        prepare_testbed_data(data, d)
        tj = json.loads((Path(d) / "transform.json").read_text())
        assert tj["n2w"] == want["n2w"]
        assert len(want["frames"]) == 16
        for name, rec in want["frames"].items():
            for key in ("normal", "albedo"):
                a = np.ascontiguousarray(png.read_png(Path(d) / f"{key}s" / name))
                digest = hashlib.sha256(f"{a.dtype}{a.shape}".encode()
                                        + a.tobytes()).hexdigest()
                assert digest == rec[key], (name, key)


# ---------------------------------------------------------------- corruption

def _first_chunk(blob: bytes):
    """→ (offset of the size field of part 0's first chunk in the file,
    its packed size, the offset of its data)."""
    attrs, pos = exr._header(blob, "f")
    off, = struct.unpack_from("<Q", blob, pos)
    if not attrs["_tiled"]:
        x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
        per = exr.LINES_PER_CHUNK[attrs["compression"][1][0]]
        n = -(-(y1 - y0 + 1) // per)
        off = min(struct.unpack_from(f"<{n}Q", blob, pos))
    head = 4 if attrs["_multipart"] else 0
    field = off + head + (16 if attrs["_tiled"] else 4)
    size, = struct.unpack_from("<i", blob, field)
    return field, size, field + 4


def _full_chunk_size(blob: bytes) -> int:
    """The raw size of a whole chunk (all its lines, or a whole tile)."""
    attrs, _ = exr._header(blob, "f")
    pixel = sum(exr.SIZE[t] for _, t, _ in
                exr._channels(attrs["channels"][1], "f"))
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    if attrs["_tiled"]:
        tx, ty, _, _ = exr._level0_tiles(attrs, x1 - x0 + 1, y1 - y0 + 1, "f")
        return tx * ty * pixel
    per = exr.LINES_PER_CHUNK[attrs["compression"][1][0]]
    return min(per, y1 - y0 + 1) * (x1 - x0 + 1) * pixel


def _dwa_field(blob, index, value):
    _, _, data = _first_chunk(blob)
    out = bytearray(blob)
    struct.pack_into("<Q", out, data + 8 * index, value)
    return bytes(out)


def _zlib_header(blob, skip=0):
    """The zlib stream of the first chunk (after `skip` bytes) given a
    wrong compression method."""
    _, _, data = _first_chunk(blob)
    out = bytearray(blob)
    out[data + skip] ^= 0x0F
    return bytes(out)


def _piz_bitmap(blob):
    _, _, data = _first_chunk(blob)
    out = bytearray(blob)
    struct.pack_into("<H", out, data + 2, 0xFFFF)    # maxNonZero past 8191
    return bytes(out)


def _b44_overlong(blob):
    """The chunk one byte longer (the next chunk's first byte): its
    blocks no longer add up to it."""
    field, size, data = _first_chunk(blob)
    assert data + size < len(blob)
    out = bytearray(blob)
    struct.pack_into("<i", out, field, size + 1)
    return bytes(out)


def _rle_count(blob):
    _, _, data = _first_chunk(blob)
    out = bytearray(blob)
    out[data] = 0x7F                                 # a run past the chunk
    return bytes(out)


CORRUPT = {  # compression: (fixture, corruption)
    "RLE": ("exr_tiled_64x64_ripmap_up_increasing_rle.exr", _rle_count),
    "ZIP": ("exr_tiled_8x8_one_down_increasing_zip.exr", _zlib_header),
    "PIZ": ("exr_piz_612x512.exr", _piz_bitmap),
    "PXR24": ("exr_pxr24_612x512.exr", _zlib_header),
    "B44": ("exr_b44_612x512.exr", _b44_overlong),
    "B44A": ("exr_b44a_612x512.exr", _b44_overlong),
    "DWAA": ("exr_dwaa_612x512.exr", lambda b: _dwa_field(b, 0, 3)),
    "DWAB": ("exr_dwab_612x512.exr", lambda b: _dwa_field(b, 8, 1 << 40)),
}


@pytest.mark.parametrize("comp", sorted(CORRUPT))
def test_cut_or_corrupt_chunks_raise_naming_the_file(comp, tmp_path):
    """A chunk cut short (its size field shrunk: the codec gets too few
    bytes), cut to nothing but 1 byte, or corrupt raises ValueError naming
    the file; random bytes in its place raise so or decode to the
    image's shape, never past the buffers."""
    name, corrupt = CORRUPT[comp]
    blob = (FIXTURES / name).read_bytes()
    assert exr.COMPRESSION_NAMES[exr._header(blob, name)[0]["compression"][1][0]] \
        == comp
    field, size, data = _first_chunk(blob)
    shape = image_io.read_raw(FIXTURES / name).shape
    assert size < _full_chunk_size(blob)         # a compressed chunk
    cases = []
    for cut in (size // 2, size - 1, 1):
        b = bytearray(blob)
        struct.pack_into("<i", b, field, cut)
        cases.append(bytes(b))
    cases.append(corrupt(blob))
    for i, b in enumerate(cases):
        p = tmp_path / f"bad{i}.exr"
        p.write_bytes(b)
        with pytest.raises(ValueError, match=str(p)):
            image_io.read_raw(p)
    rng = np.random.default_rng(len(comp))
    for i in range(6):
        b = bytearray(blob)
        n = min(size, 64)
        b[data:data + n] = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        p = tmp_path / f"random{i}.exr"
        p.write_bytes(bytes(b))
        try:
            got = image_io.read_raw(p)
        except ValueError as e:
            assert str(p) in str(e)
        else:
            assert got.shape == shape


def test_an_uncompressed_chunk_cut_short_raises(tmp_path):
    blob = (FIXTURES / "exr_tiled_16x32_ripmap_down_decreasing_no.exr") \
        .read_bytes()
    field, size, _ = _first_chunk(blob)
    b = bytearray(blob)
    struct.pack_into("<i", b, field, size - 2)
    p = tmp_path / "no.exr"
    p.write_bytes(bytes(b))
    with pytest.raises(ValueError, match=str(p)):
        image_io.read_raw(p)


def test_dwa_ac_values_read_from_deflate_as_from_huffman(tmp_path, expected):
    """OpenEXR 3.1.5 codes DWAB's AC values with the Huffman code, as
    DWAA's (the chunk's own field says so); the DEFLATE coding its
    decoder also reads is held here by recoding a library file's chunks
    with zlib: the same samples come back."""
    import zlib

    name = "exr_dwab_612x512.exr"           # two chunks of 256 lines
    blob = (FIXTURES / name).read_bytes()
    attrs, pos = exr._header(blob, name)
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    offsets = struct.unpack_from("<2Q", blob, pos)
    chunks, recoded = [], 0
    for off in offsets:
        y, size = struct.unpack_from("<ii", blob, off)
        data = blob[off + 8:off + 8 + size]
        if size >= min(256, y1 - y + 1) * (x1 - x0 + 1) * 6:   # stored raw
            chunks.append(blob[off:off + 8 + size])
            continue
        recoded += 1
        sz = list(struct.unpack_from("<11Q", data))
        assert sz[10] == exr.STATIC_HUFFMAN
        ac_at = 88 + struct.unpack_from("<H", data, 88)[0] + sz[2]
        values = native.exr_huf_decode(data[ac_at:ac_at + sz[3]], sz[8])
        packed = zlib.compress(values.astype("<u2").tobytes(), 9)
        new = (struct.pack("<11Q", *sz[:3], len(packed), *sz[4:10],
                           exr.DEFLATE)
               + data[88:ac_at] + packed + data[ac_at + sz[3]:])
        chunks.append(struct.pack("<ii", y, len(new)) + new)
    table, at = [], pos + 16
    for c in chunks:
        table.append(at)
        at += len(c)
    assert recoded
    path = tmp_path / name
    path.write_bytes(blob[:pos] + struct.pack("<2Q", *table) + b"".join(chunks))
    np.testing.assert_array_equal(image_io.read_raw(path), expected[name])


# ------------------------------------------- OpenEXR's Huffman and wavelet
# a test encoder: any prefix code's lengths, OpenEXR's canonical codes and
# table packing, runs of the previous symbol as the run-length symbol and
# an 8-bit count

def _code_lengths(freq: dict) -> dict:
    import heapq
    if len(freq) == 1:
        return {next(iter(freq)): 1}
    heap = [(f, i, (s,)) for i, (s, f) in enumerate(sorted(freq.items()))]
    heapq.heapify(heap)
    depth = dict.fromkeys(freq, 0)
    k = len(heap)
    while len(heap) > 1:
        f1, _, a = heapq.heappop(heap)
        f2, _, b = heapq.heappop(heap)
        for s in a + b:
            depth[s] += 1
        heapq.heappush(heap, (f1 + f2, k, a + b))
        k += 1
    return depth


def _canonical(lengths: dict) -> dict:
    n = [0] * 59
    for l in lengths.values():
        n[l] += 1
    c = 0
    for i in range(58, 0, -1):
        n[i], c = c, (c + n[i]) >> 1
    codes = {}
    for s in sorted(lengths):
        l = lengths[s]
        codes[s] = (n[l], l)
        n[l] += 1
    return codes


class _Bits:
    def __init__(self):
        self.v, self.n = 0, 0

    def put(self, value, bits):
        self.v, self.n = (self.v << bits) | value, self.n + bits

    def bytes(self):
        pad = -self.n % 8
        return (self.v << pad).to_bytes((self.n + pad) // 8, "big")


def _huf_encode(symbols, min_run=2):
    """OpenEXR's hufCompress layout: im, iM (the run-length symbol), the
    table's size, the bit count, 0, the packed table, the bits."""
    runs, i = [], 0
    while i < len(symbols):
        j = i + 1
        while j < len(symbols) and symbols[j] == symbols[i] and j - i <= 255:
            j += 1
        runs.append((symbols[i], j - i - 1))
        i = j
    rlc = max(symbols) + 1
    freq = {}
    for s, extra in runs:
        freq[s] = freq.get(s, 0) + 1
        if extra >= min_run:
            freq[rlc] = freq.get(rlc, 0) + 1
        else:
            freq[s] += extra
    freq.setdefault(rlc, 1)
    codes = _canonical(_code_lengths(freq))
    im = min(freq)
    table = _Bits()
    s = im
    while s <= rlc:
        if s in codes:
            table.put(codes[s][1], 6)
            s += 1
            continue
        z = 0
        while s + z <= rlc and s + z not in codes and z < 255 + 6:
            z += 1
        if z >= 6:
            table.put(63, 6)
            table.put(z - 6, 8)
        elif z >= 2:
            table.put(59 + z - 2, 6)
        else:
            table.put(0, 6)
        s += z
    bits = _Bits()
    for s, extra in runs:
        code, length = codes[s]
        bits.put(code, length)
        if extra >= min_run:
            code, length = codes[rlc]
            bits.put(code, length)
            bits.put(extra, 8)
        else:
            for _ in range(extra):
                bits.put(code, length)
    t, b = table.bytes(), bits.bytes()
    longest = max(length for _, length in codes.values())
    return struct.pack("<5I", im, rlc, len(t), bits.n, 0) + t + b, longest


def _fibonacci(n):
    out = [1, 1]
    while len(out) < n:
        out.append(out[-1] + out[-2])
    return out


@pytest.mark.parametrize("case", ["empty", "single", "longest_run", "runs",
                                  "long_codes", "short_runs"])
def test_huffman_decodes_the_edge_cases(case):
    rng = np.random.default_rng(len(case))
    symbols = {
        "empty": [],
        "single": [7] * 40,
        "longest_run": [3] + [9] * 256 + [9] * 256 + [1, 2],
        "runs": [5, 5, 5, 0, 0, 65535, 65535, 65535, 65535, 12],
        # Fibonacci counts, shuffled: codes past the 14-bit table
        "long_codes": [int(v) for v in rng.permutation(np.repeat(
            np.arange(20) * 3001 % 65536, _fibonacci(20)))],
        "short_runs": [int(v) for v in rng.integers(0, 4, 300)],
    }[case]
    if case == "empty":
        assert native.exr_huf_decode(b"", 0).size == 0
        with pytest.raises(ValueError, match="data ends early"):
            native.exr_huf_decode(b"\0" * 19, 5)
        return
    blob, longest = _huf_encode(symbols)
    got = native.exr_huf_decode(blob, len(symbols))
    np.testing.assert_array_equal(got, np.asarray(symbols, np.uint16))
    if case == "long_codes":
        assert longest > 14            # past the decoder's 14-bit table
    # cut short and asked for one symbol more
    with pytest.raises(ValueError):
        native.exr_huf_decode(blob[:-1] if len(blob) > 21 else blob[:19],
                              len(symbols))
    with pytest.raises(ValueError):
        native.exr_huf_decode(blob, len(symbols) + 1)


def test_huffman_run_symbol_at_its_longest_is_one_code_and_a_count():
    blob, _ = _huf_encode([4] * 256)
    # the symbol once, the run-length symbol and the count 255
    assert struct.unpack_from("<I", blob, 12)[0] < 20
    np.testing.assert_array_equal(native.exr_huf_decode(blob, 256),
                                  np.full(256, 4, np.uint16))


def _wenc14(a, b):
    def s16(v):
        return ((v & 0xFFFF) ^ 0x8000) - 0x8000
    as_, bs = s16(a), s16(b)
    return ((as_ + bs) >> 1) & 0xFFFF, (as_ - bs) & 0xFFFF


def _wenc16(a, b):
    ao = (a + 0x8000) & 0xFFFF
    m = (ao + b) >> 1
    d = ao - b
    if d < 0:
        m = (m + 0x8000) & 0xFFFF
    return m, d & 0xFFFF


def _wav2_encode(buf, nx, ny, mx):
    """OpenEXR's wav2Encode of a (ny, nx) plane (a flat list)."""
    enc = _wenc14 if mx < (1 << 14) else _wenc16
    n, p, p2 = min(nx, ny), 1, 2
    while p2 <= n:
        y = 0
        while y <= ny - p2:
            x = 0
            while x <= nx - p2:
                i00, i01 = y * nx + x, y * nx + x + p
                i10, i11 = (y + p) * nx + x, (y + p) * nx + x + p
                a00, a01 = enc(buf[i00], buf[i01])
                a10, a11 = enc(buf[i10], buf[i11])
                buf[i00], buf[i10] = enc(a00, a10)
                buf[i01], buf[i11] = enc(a01, a11)
                x += p2
            if nx & p:
                i0, i1 = y * nx + x, (y + p) * nx + x
                buf[i0], buf[i1] = enc(buf[i0], buf[i1])
            y += p2
        if ny & p:
            x = 0
            while x <= nx - p2:
                i0, i1 = y * nx + x, y * nx + x + p
                buf[i0], buf[i1] = enc(buf[i0], buf[i1])
                x += p2
        p, p2 = p2, p2 << 1


@pytest.mark.parametrize("shape,mx", [((1, 1), 100), ((1, 37), 100),
                                      ((29, 1), 100), ((3, 5), 16383),
                                      ((17, 23), 9000), ((16, 16), 65535),
                                      ((13, 40), 40000)])
def test_wavelet_inverts_openexrs_encoder(shape, mx):
    rng = np.random.default_rng(shape[0] * 100 + shape[1])
    ny, nx = shape
    plane = rng.integers(0, mx + 1, (ny, nx)).astype(np.uint16)
    plane.flat[0] = mx
    buf = [int(v) for v in plane.reshape(-1)]
    _wav2_encode(buf, nx, ny, mx)
    coded = np.asarray(buf, np.uint16).reshape(ny, nx)
    native.exr_wav_decode(coded, mx)
    np.testing.assert_array_equal(coded, plane)
