"""Image I/O and the exact training-time decode (port of
`rnb_neus2_tpu/io/image_io.py`).

Files are read and written by the port's own codecs (no `cv2`): PNG
(`io/png.py`), TIFF (`io/tiff.py`), JPEG (`io/jpeg.py`) and OpenEXR
(`io/exr.py`). A file's format is found from its signature, as
`cv2.imread` finds it, and its samples come back as cv2 gives them, but
in RGB(A) order: the JAX package flips cv2's BGR(A), the port's readers
give RGB(A) directly and flip nothing. A grey+alpha PNG reads as (grey,
grey, grey, alpha), as cv2 reads it. Integer samples are normalized to
[0, 1]; float (EXR, float TIFF) samples pass through. `save_image` writes
the format its extension names, as `cv2.imwrite` does.

Training decode (a 16-bit RGBA texel, common_device.cuh:665-690 +
testbed_nerf.cu:1504-1535):

    rgb_premul = srgb_to_linear(raw/65535) · alpha        (read_rgba)
    value      = linear_to_srgb(rgb_premul)               (loss kernel)
"""

from __future__ import annotations

import os

import numpy as np

from . import exr, jpeg, png, tiff
from .errors import UnreadableImage, unreadable, unsupported


def srgb_to_linear(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return np.where(x <= 0.04045, x / 12.92,
                    ((x + 0.055) / 1.055) ** 2.4).astype(np.float32)


def linear_to_srgb(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return np.where(x < 0.0031308, 12.92 * x,
                    1.055 * np.clip(x, 0, None) ** 0.41666 - 0.055
                    ).astype(np.float32)


def decode_texel(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """raw [0,1] rgb + alpha → the value the loss kernel sees."""
    return linear_to_srgb(srgb_to_linear(rgb) * alpha[..., None])


def decode_normal(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """→ unit cam-frame normal with the reference's y/z negation
    (testbed_nerf.cu:1507-1510)."""
    n = decode_texel(rgb, alpha) * 2.0 - 1.0
    n[..., 1] *= -1.0
    n[..., 2] *= -1.0
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    return (n / np.maximum(norm, 1e-12)).astype(np.float32)


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------

# formats cv2 reads that the port does not yet, by their signatures
OTHER_FORMATS = ((b"BM", "BMP"), (b"P1", "PNM"), (b"P2", "PNM"),
                 (b"P3", "PNM"), (b"P4", "PNM"), (b"P5", "PNM"),
                 (b"P6", "PNM"), (b"P7", "PAM"), (b"PF", "PFM"),
                 (b"Pf", "PFM"), (b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
                 (b"#?RADIANCE", "Radiance HDR"), (b"#?RGBE", "Radiance HDR"),
                 (b"\x59\xa6\x6a\x95", "Sun raster"),
                 (b"\x00\x00\x00\x0cjP  ", "JPEG 2000"),
                 (b"\xff\x4f\xff\x51", "JPEG 2000"))


def _reader(path):
    """The reader of the file's format, from its signature, as
    `cv2.imread` finds it. A missing file or one of no format cv2 reads
    raises UnreadableImage (cv2 returns None); a format cv2 reads and the
    port does not, UnsupportedImage."""
    if not os.path.isfile(str(path)):
        unreadable(path, f"Cannot read image: {path}")
    with open(path, "rb") as f:
        head = f.read(16)
    if head.startswith(png.SIGNATURE):
        return png.read_png
    if head.startswith(jpeg.SIGNATURE):
        return jpeg.read_jpeg
    if head[:4] in tiff.SIGNATURES:
        return tiff.read_tiff
    if head.startswith(exr.MAGIC):
        return _read_exr
    for sig, name in OTHER_FORMATS:
        if head.startswith(sig):
            unsupported(path, f"{name} image")
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        unsupported(path, "WebP image")
    if head[4:8] == b"ftyp" and head[8:12] in (b"avif", b"avis"):
        unsupported(path, "AVIF image")
    unreadable(path, "not an image file cv2 reads")


def _read_exr(path, mode: str = "unchanged") -> np.ndarray:
    if mode != "unchanged":
        unsupported(path, "EXR read as 8-bit colour or grey")
    return exr.read_exr(path)


def read_image(path, mode: str = "unchanged") -> np.ndarray:
    """`cv2.imread(path, flag)` in RGB(A) order, the format found from the
    file's signature. mode "unchanged" (IMREAD_UNCHANGED): uint8, uint16
    or float32, (H, W) grey, (H, W, 3) or (H, W, 4); grey+alpha comes back
    as (grey, grey, grey, alpha). "color" (IMREAD_COLOR): uint8 (H, W, 3);
    "grey" (IMREAD_GRAYSCALE): uint8 (H, W); both with the EXIF
    orientation applied."""
    img = _reader(path)(path, mode)
    if img.ndim == 3 and img.shape[2] == 2:
        img = img[..., [0, 0, 0, 1]]
    return img


def read_raw(path) -> np.ndarray:
    """`read_image(path)`: the samples as `cv2.imread(IMREAD_UNCHANGED)`
    gives them, in RGB(A) order."""
    return read_image(path)


def color_shape(path):
    """(H, W) of `cv2.imread(path)` (IMREAD_COLOR): an EXIF orientation of
    5-8 swaps them."""
    reader = _reader(path)
    if reader in (png.read_png, jpeg.read_jpeg):
        return read_image(path, "color").shape[:2]
    return read_image(path).shape[:2]


def _read_or_raise(path) -> np.ndarray:
    """`read_raw`, a file cv2 cannot read raising as the JAX loaders do
    for cv2's None."""
    try:
        return read_raw(path)
    except UnreadableImage as e:
        raise UnreadableImage(f"Cannot read image: {path} ({e})") from None


def load_image(path) -> np.ndarray:
    """8/16-bit → [0,1] float32; float32 (EXR, float TIFF) passes through;
    RGB(A) order. A file cv2 cannot read raises FileNotFoundError
    ("Cannot read image: ...")."""
    img = _read_or_raise(path)
    if img.dtype in (np.uint8, np.uint16):
        return img.astype(np.float32) / float(np.iinfo(img.dtype).max)
    if img.dtype != np.float32:
        raise ValueError(f"Unsupported dtype {img.dtype} in {path}")
    return img


def load_image_raw16(path) -> np.ndarray:
    """16-bit RGBA exactly as the engine's stbi_load_16 sees it:
    (H, W, 4) uint16, 8-bit inputs upscaled by 257, float inputs clipped
    to [0, 1] and rounded as (v · 65535 + 0.5) truncated."""
    img = _read_or_raise(path)
    if img.dtype == np.uint8:
        img = img.astype(np.uint16) * 257
    elif img.dtype == np.float32:
        img = (np.clip(img, 0, 1) * 65535.0 + 0.5).astype(np.uint16)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[2] == 3:
        alpha = np.full(img.shape[:2] + (1,), 65535, np.uint16)
        img = np.concatenate([img, alpha], axis=-1)
    return img


def write_raw(path, image: np.ndarray) -> None:
    """uint8 or uint16 samples in RGB(A) order, written in the format the
    extension names, as `cv2.imwrite` writes them: `.png`; `.tif`/`.tiff`
    (LZW, horizontal differencing); `.jpg`/`.jpeg`/`.jpe` (quality 95,
    4:2:0, alpha dropped, 16-bit samples saturated to 255 as cv2's
    conversion to 8 bits does). `.exr` raises, since OpenCV's EXR encoder
    takes only float samples (`save_exr` writes floats), and so does any
    other extension."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext == ".png":
        png.write_png(path, image)
    elif ext in (".tif", ".tiff"):
        tiff.write_tiff(path, image)
    elif ext in (".jpg", ".jpeg", ".jpe"):
        if image.ndim == 3:
            image = image[..., :3]
        jpeg.write_jpeg(path, np.minimum(image, 255).astype(np.uint8))
    elif ext == ".exr":
        raise ValueError(f"{path}: an EXR file holds float samples; "
                         f"{image.dtype} cannot be written (use save_exr)")
    else:
        raise ValueError(f"{path}: no image writer for extension "
                         f"{ext or '(none)'!r}")


def save_image(image: np.ndarray, path, bit_depth: int = 16) -> None:
    """[0, 1] floats → 8- or 16-bit samples (NaN → 0), written by
    `write_raw` in the format the extension names."""
    image = np.nan_to_num(np.asarray(image, np.float32), nan=0.0)
    image = np.clip(image, 0.0, 1.0) * float(2 ** bit_depth - 1)
    write_raw(path, image.astype(np.uint8 if bit_depth == 8 else np.uint16))


def save_exr(image: np.ndarray, path) -> None:
    """float32 (H, W), (H, W, 3) or (H, W, 4) → an EXR of FLOAT channels,
    ZIP-compressed (what the JAX `save_exr` asks cv2 for), each channel
    under its own name: Y, or R, G, B(, A). (The JAX `save_exr` reverses
    all channels before cv2 names them B, G, R, A, so an RGBA image's R
    lands in A there.)"""
    exr.write_exr(path, image)


def load_normal(path) -> np.ndarray:
    """Normal map in [−1,1]: a `.exr` name as-is, any other remapped from
    [0,1] (the extension decides, not the content, as in the JAX
    package)."""
    ext = os.path.splitext(str(path))[1].lower()
    img = load_image(path)
    if img.ndim == 3 and img.shape[2] > 3:
        img = img[:, :, :3]
    return img if ext == ".exr" else img * 2.0 - 1.0


def save_normal_16bit(normal: np.ndarray, path) -> None:
    save_image(0.5 * (1.0 + np.asarray(normal)), path, bit_depth=16)
