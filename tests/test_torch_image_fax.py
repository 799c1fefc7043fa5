"""TIFF's CCITT codecs (compressions 2, 3, 4 and 32771) and ThunderScan
(32809) read as cv2 reads them, and the TIFF compressions cv2 cannot
read raising `UnreadableImage` beside cv2's None.

Every file is held against cv2 in its three read modes (IMREAD_UNCHANGED,
_COLOR, _GRAYSCALE), exactly. The bilevel files are written by PIL's own
libtiff through ctypes (`torch_image_writers.libtiff_bilevel`): modified
Huffman, T.4 1-D and 2-D (with and without EOL fill bits), T.6,
FillOrder 2, MinIsWhite and MinIsBlack, several strips and tiles. RLEW
and ThunderScan files come from the test writers' own encoders (libtiff
writes no valid RLEW, and no ThunderScan). A stream libtiff would have to
recover from (a bad code word, data that ends early, uncompressed mode)
is refused by name with `UnsupportedImage`; cv2 still returns an image
for it, which the test asserts beside the refusal.
"""

import struct

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

import io

import torch_image_writers as tw
from rnb_neus2_torch.io import image_io
from rnb_neus2_torch.io.errors import UnreadableImage, UnsupportedImage

H, W = 37, 53
MODES = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "grey": cv2.IMREAD_GRAYSCALE}


def _cv2(path, mode):
    try:
        img = cv2.imread(str(path), MODES[mode])
    except cv2.error:
        return None
    if img is not None and img.ndim == 3 and img.shape[2] in (3, 4):
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def _like_cv2(path):
    """Every mode: the port's array equals cv2's, or both refuse. → the
    modes cv2 read."""
    read = []
    for mode in MODES:
        want = _cv2(path, mode)
        if want is None:
            with pytest.raises(UnreadableImage):
                image_io.read_image(path, mode)
            continue
        got = image_io.read_image(path, mode)
        assert got.dtype == want.dtype and got.shape == want.shape, mode
        np.testing.assert_array_equal(got, want, err_msg=mode)
        read.append(mode)
    return read


def _mask(seed, h=H, w=W):
    """A bilevel mask with blobs, thin lines and noise: long and short
    runs of both colours, and rows that start black."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    m = (x - w * 0.45) ** 2 + (y - h * 0.5) ** 2 < (0.35 * min(h, w)) ** 2
    m ^= (x + y) % 11 == 0
    m[:, :2] = True
    m[rng.random((h, w)) < 0.04] ^= True
    return m


FAX_CASES = {
    "mh": dict(compression=2),
    "mh_min_is_black": dict(compression=2, photometric=1),
    "mh_fill_order_2": dict(compression=2, fill_order=2),
    "g3_1d": dict(compression=3, t4_options=0),
    "g3_1d_fill_bits": dict(compression=3, t4_options=4),
    "g3_2d": dict(compression=3, t4_options=1),
    "g3_2d_fill_bits": dict(compression=3, t4_options=5),
    "g3_2d_strips": dict(compression=3, t4_options=1, rows_per_strip=8),
    "g3_2d_fill_order_2": dict(compression=3, t4_options=1, fill_order=2),
    "g3_uncompressed_allowed": dict(compression=3, t4_options=3),
    "g4": dict(compression=4),
    "g4_min_is_black": dict(compression=4, photometric=1),
    "g4_fill_order_2": dict(compression=4, fill_order=2),
    "g4_strips": dict(compression=4, rows_per_strip=5),
    "g4_tiles": dict(compression=4, tile=(16, 16)),
    "mh_tiles": dict(compression=2, tile=(32, 16)),
}


@pytest.mark.parametrize("case", sorted(FAX_CASES))
def test_ccitt_matches_cv2(tmp_path, case):
    path = tmp_path / f"{case}.tif"
    tw.libtiff_bilevel(path, _mask(len(case)), **FAX_CASES[case])
    assert _like_cv2(path) == list(MODES)


@pytest.mark.parametrize("size", [(1, 1), (3, 200), (64, 7)])
def test_ccitt_odd_sizes_match_cv2(tmp_path, size):
    for comp, opts in ((2, None), (3, 1), (4, None)):
        path = tmp_path / f"c{comp}.tif"
        tw.libtiff_bilevel(path, _mask(comp, *size), comp, t4_options=opts)
        assert _like_cv2(path) == list(MODES)


@pytest.mark.parametrize("photometric", [0, 1])
def test_rlew_matches_cv2(tmp_path, photometric):
    path = tmp_path / "rlew.tif"
    path.write_bytes(tw.rlew_file(_mask(7), photometric))
    assert _like_cv2(path) == list(MODES)


@pytest.mark.parametrize("case", ["pil_rlew", "bad_code", "ends_early",
                                  "uncompressed_mode"])
def test_streams_libtiff_recovers_from_are_refused(tmp_path, case):
    """libtiff logs these and goes on with what its recovery leaves (cv2
    returns an image); the port names them instead."""
    path = tmp_path / f"{case}.tif"
    if case == "pil_rlew":
        img = Image.fromarray(_mask(3)).convert("1")
        bio = io.BytesIO()
        img.save(bio, "TIFF", compression="tiff_raw_16")
        path.write_bytes(bio.getvalue())
        what = "wrong length"
    else:
        blob = bytearray(tw.libtiff_bilevel(path, _mask(4), 4))
        off, cnt = _strip(blob)
        if case == "bad_code":
            blob[off + cnt // 2:off + cnt // 2 + 2] = b"\0\0"
            what = "EOL inside a row"
        elif case == "ends_early":
            struct.pack_into("<I", blob, _entry(blob, 279) + 8, cnt // 3)
            what = "EOL inside a row|ends early"
        else:
            # a 2-D row whose first mode is the extension code 0000001
            blob = bytearray(tw.libtiff_bilevel(path, _mask(4), 3,
                                                t4_options=3))
            off, _ = _strip(blob)
            rows = _eol_row_starts(bytes(blob[off:]))
            bit = rows[5]
            for k, v in enumerate("0" + "0000001" + "111"):
                i, b = divmod(bit + k, 8)
                blob[off + i] = (blob[off + i] & ~(0x80 >> b)) \
                    | (int(v) << (7 - b))
            what = "uncompressed mode"
        path.write_bytes(bytes(blob))
    assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is not None
    for mode in MODES:
        with pytest.raises(UnsupportedImage, match=what):
            image_io.read_image(path, mode)


def _entry(blob, tag):
    off = struct.unpack_from("<I", blob, 4)[0]
    n = struct.unpack_from("<H", blob, off)[0]
    for i in range(n):
        at = off + 2 + 12 * i
        if struct.unpack_from("<H", blob, at)[0] == tag:
            return at
    raise KeyError(tag)


def _strip(blob):
    return (struct.unpack_from("<I", blob, _entry(blob, 273) + 8)[0],
            struct.unpack_from("<I", blob, _entry(blob, 279) + 8)[0])


def _eol_row_starts(data):
    """Bit positions just past each EOL (eleven zeros and a one)."""
    bits = np.unpackbits(np.frombuffer(data, np.uint8))
    out, zeros = [], 0
    for i, b in enumerate(bits):
        if b and zeros >= 11:
            out.append(i + 1)
        zeros = 0 if b else zeros + 1
    return out


def test_thunderscan_matches_cv2(tmp_path):
    rng = np.random.default_rng(5)
    y, x = np.mgrid[:H, :W]
    idx = ((x // 4 + y // 6) % 16).astype(np.uint8)
    idx[rng.random((H, W)) < 0.1] = rng.integers(0, 16, 1)[0]
    pal = [int(v) for v in rng.integers(0, 65536, 48)]
    path = tmp_path / "thunder.tif"
    path.write_bytes(tw.tiff_file(
        {256: (3, [W]), 257: (3, [H]), 258: (3, [4]), 259: (3, [32809]),
         262: (3, [3]), 277: (3, [1]), 278: (3, [H]), 320: (3, pal)},
        [tw.thunderscan(idx)]))
    assert _like_cv2(path) == list(MODES)


def _hand_tiff(comp, bits=8, photometric=1, data=bytes(range(64))):
    return tw.tiff_file({256: (3, [8]), 257: (3, [4]), 258: (3, [bits]),
                         259: (3, [comp]), 262: (3, [photometric]),
                         277: (3, [1]), 278: (3, [4])}, [data])


@pytest.mark.parametrize("comp,name", [
    (6, "old-style JPEG"), (32909, "PixarLog"), (34661, "JBIG"),
    (34887, "LERC"), (34925, "LZMA"), (50000, "ZSTD"), (50001, "WebP")])
def test_codecs_cv2_lacks_are_unreadable(tmp_path, comp, name):
    """libtiff knows these codecs; cv2's was built without them and
    returns None, so the port raises UnreadableImage, which every read
    site handles as the JAX package handles None."""
    path = tmp_path / f"c{comp}.tif"
    path.write_bytes(_hand_tiff(comp, 1 if comp == 34661 else 8))
    assert _like_cv2(path) == []
    with pytest.raises(UnreadableImage, match=name):
        image_io.read_image(path)


@pytest.mark.parametrize("compression", ["tiff_lzma", "tiff_zstd"])
def test_pil_lzma_and_zstd_are_unreadable(tmp_path, compression):
    img = Image.fromarray(np.arange(H * W, dtype=np.uint8).reshape(H, W))
    path = tmp_path / "p.tif"
    img.save(path, "TIFF", compression=compression[5:])
    assert _like_cv2(path) == []


@pytest.mark.parametrize("comp,what", [
    (34676, "SGILog"), (9, "does not know it"), (34712, "does not know it"),
    (50002, "does not know it")])
def test_codecs_cv2_reads_and_the_port_does_not(tmp_path, comp, what):
    """SGILog is decoded by cv2's libtiff, and by the port as cv2 decodes
    it (this hand-made LogL strip in the three modes); a code libtiff does
    not know comes back as zeros from cv2 (its strip read fails into a
    buffer it never wrote), and the port refuses it by name."""
    path = tmp_path / f"c{comp}.tif"
    path.write_bytes(_hand_tiff(comp, 16 if comp == 34676 else 8,
                                32844 if comp == 34676 else 1))
    assert cv2.imread(str(path), cv2.IMREAD_UNCHANGED) is not None
    if comp == 34676:
        assert _like_cv2(path) == list(MODES)
        return
    with pytest.raises(UnsupportedImage, match=what):
        image_io.read_image(path)


@pytest.mark.parametrize("comp,bits,photometric", [
    (4, 8, 1), (32766, 2, 1), (32809, 4, 1)])
def test_codecs_of_samples_cv2_refuses(tmp_path, comp, bits, photometric):
    """CCITT over 8-bit samples (libtiff's fax setup refuses), NeXT (only
    2-bit, which cv2 refuses) and grey ThunderScan (4-bit grey, which cv2
    refuses): cv2 returns None."""
    path = tmp_path / f"c{comp}.tif"
    path.write_bytes(_hand_tiff(comp, bits, photometric))
    assert _like_cv2(path) == []
