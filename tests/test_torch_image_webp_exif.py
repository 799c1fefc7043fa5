"""WebP's EXIF orientation read as cv2 5 reads it.

cv2 applies the orientation of a VP8X file's first `EXIF` chunk under
IMREAD_COLOR and IMREAD_GRAYSCALE, never under IMREAD_UNCHANGED, and only
where the VP8X header's EXIF flag is set. Each 40x24 file (PIL's
lossless, lossy, alpha and animated writers at orientations 1-8, and the
hand-built variants below) is held against `cv2.imread` in the three read
modes, and `color_shape` against cv2's colour (H, W); an IDR scene whose
normal map is such a WebP gets the JAX loader's H and W.
"""

import io
import os
import struct

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

import rnb_neus2_tpu.io.dataloaders as jdataloaders
from rnb_neus2_torch.io import dataloaders, image_io

H, W = 24, 40
MODES = {"unchanged": cv2.IMREAD_UNCHANGED, "color": cv2.IMREAD_COLOR,
         "grey": cv2.IMREAD_GRAYSCALE}
KINDS = ("lossless", "lossy", "alpha", "animated")


def _cv2(path, mode):
    """cv2.imread in RGB(A) order."""
    img = cv2.imread(str(path), MODES[mode])
    assert img is not None, (path, mode)
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def _exif(orientation: int) -> bytes:
    """A TIFF-structured EXIF blob with tag 0x0112 (PIL's, without its
    "Exif\\0\\0" header)."""
    ex = Image.Exif()
    ex[0x0112] = orientation
    blob = ex.tobytes()
    assert blob.startswith(b"Exif\0\0")
    return blob[6:]


def _chunks(blob: bytes) -> list:
    out, pos = [], 12
    while pos + 8 <= len(blob):
        size, = struct.unpack_from("<I", blob, pos + 4)
        out.append((blob[pos:pos + 4], blob[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _riff(chunks) -> bytes:
    body = b"".join(tag + struct.pack("<I", len(b)) + b + b"\0" * (len(b) & 1)
                    for tag, b in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def _image(rng, alpha=False):
    y, x = np.mgrid[:H, :W]
    ch = 4 if alpha else 3
    base = np.stack([128 + 100 * np.sin(x / 5.0 + 2 * c) * np.cos(y / 4.0 + c)
                     for c in range(ch)], -1)
    # a corner mark, so that every flip and transpose shows
    base[:4, :6] = 255
    return np.clip(base + rng.normal(0, 6, base.shape), 0, 255) \
        .astype(np.uint8)


def _pil_webp(kind: str, orientation: int) -> bytes:
    """PIL's file of `kind` with an EXIF chunk of `orientation` (the
    animated writer stores the blob as it is given: its bare TIFF)."""
    rng = np.random.default_rng(KINDS.index(kind))
    buf = io.BytesIO()
    exif = _exif(orientation)
    if kind == "animated":
        frames = [Image.fromarray(_image(rng)) for _ in range(2)]
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                       lossless=True, duration=40, exif=exif)
    else:
        img = Image.fromarray(_image(rng, alpha=kind == "alpha"))
        opts = dict(lossless=True) if kind == "lossless" else dict(quality=80)
        img.save(buf, "WEBP", exif=b"Exif\0\0" + exif, **opts)
    blob = buf.getvalue()
    flags = _chunks(blob)[0]
    assert flags[0] == b"VP8X" and flags[1][0] & 0x08
    return blob


def _variants() -> dict:
    """Files whose EXIF chunk cv2 does not read, or reads first: the VP8X
    flag unset, a chunk with PIL's "Exif\\0\\0" header, a file without
    VP8X, two chunks (the first counts) and the chunk before the image."""
    base = _chunks(_pil_webp("lossless", 6))
    vp8x, rest = base[0], [c for c in base[1:] if c[0] != b"EXIF"]
    unset = (b"VP8X", bytes([vp8x[1][0] & ~0x08]) + vp8x[1][1:])
    return {
        "flag_unset": _riff([unset, *rest, (b"EXIF", _exif(6))]),
        "exif_header": _riff([vp8x, *rest,
                              (b"EXIF", b"Exif\0\0" + _exif(6))]),
        "no_vp8x": _riff([*rest, (b"EXIF", _exif(6))]),
        "two_chunks": _riff([vp8x, *rest, (b"EXIF", _exif(2)),
                             (b"EXIF", _exif(3))]),
        "chunk_first": _riff([vp8x, (b"EXIF", _exif(7)), *rest]),
        "flag_without_chunk": _riff([vp8x, *rest]),
        "orientation_9": _riff([vp8x, *rest, (b"EXIF", _exif(9))]),
    }


VARIANTS = _variants()


def _reads_like_cv2(path) -> None:
    for mode in MODES:
        want = _cv2(path, mode)
        got = image_io.read_image(path, mode)
        assert got.dtype == want.dtype and got.shape == want.shape, \
            (mode, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=mode)
    assert image_io.color_shape(path) == cv2.imread(str(path)).shape[:2]


@pytest.mark.parametrize("orientation", range(1, 9))
@pytest.mark.parametrize("kind", KINDS)
def test_webp_orientation_matches_cv2(tmp_path, kind, orientation):
    path = tmp_path / f"{kind}_{orientation}.webp"
    path.write_bytes(_pil_webp(kind, orientation))
    _reads_like_cv2(path)
    swapped = orientation >= 5
    assert image_io.color_shape(path) == ((W, H) if swapped else (H, W))


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_webp_exif_chunk_rules_match_cv2(tmp_path, case):
    path = tmp_path / f"{case}.webp"
    path.write_bytes(VARIANTS[case])
    _reads_like_cv2(path)


def _idr_scene(root, normal: bytes) -> None:
    """cameras.npz of two views and a normal/ folder whose first file is
    the WebP (the loaders take H and W from it)."""
    (root / "normal").mkdir(parents=True)
    (root / "normal" / "000.webp").write_bytes(normal)
    K = np.array([[50.0, 0, 20.0], [0, 50.0, 12.0], [0, 0, 1.0]])
    mats = {}
    for i in range(2):
        Rt = np.hstack([np.eye(3), [[0.1 * i], [0.0], [2.0]]])
        mats[f"world_mat_{i}"] = np.vstack([K @ Rt, [0, 0, 0, 1]])
        mats[f"scale_mat_{i}"] = np.eye(4)
    np.savez(os.path.join(root, "cameras.npz"), **mats)


@pytest.mark.parametrize("orientation", [1, 5, 6, 7, 8])
@pytest.mark.parametrize("kind", ["lossless", "animated"])
def test_idr_scene_with_an_oriented_webp_normal_map(tmp_path, kind,
                                                    orientation):
    _idr_scene(tmp_path, _pil_webp(kind, orientation))
    got = dataloaders.load_idr_scene(str(tmp_path))
    want = jdataloaders.load_idr_scene(str(tmp_path))
    assert (got["image_height"], got["image_width"]) \
        == (want["image_height"], want["image_width"])
    assert (got["image_height"], got["image_width"]) \
        == ((W, H) if orientation >= 5 else (H, W))
