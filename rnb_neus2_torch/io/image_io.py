"""Image I/O and the exact training-time decode (port of
`rnb_neus2_tpu/io/image_io.py`).

Files are read and written by the port's own codecs (no `cv2`): PNG
(`io/png.py`), TIFF (`io/tiff.py`), JPEG (`io/jpeg.py`), OpenEXR
(`io/exr.py`), BMP (`io/bmp.py`), PNM/PAM/PFM (`io/pxm.py`), Radiance
HDR (`io/hdr.py`), Sun raster (`io/sunras.py`), GIF (`io/gif.py`), WebP
(`io/webp.py`), JPEG 2000 (`io/jpeg2000.py`) and AVIF (`io/avif.py`). A
file's format is found from its signature, as
`cv2.imread` finds it, and its samples come back as cv2 gives them, but
in RGB(A) order: the JAX package flips cv2's BGR(A), the port's readers
give RGB(A) directly and flip nothing. A grey+alpha PNG reads as (grey,
grey, grey, alpha), as cv2 reads it (a grey+alpha PAM as cv2's two
channels). Integer samples are normalized to [0, 1]; float (EXR, float
TIFF, PFM, Radiance) samples pass through. `save_image` writes the
format its extension names, as `cv2.imwrite` does.

Training decode (a 16-bit RGBA texel, common_device.cuh:665-690 +
testbed_nerf.cu:1504-1535):

    rgb_premul = srgb_to_linear(raw/65535) · alpha        (read_rgba)
    value      = linear_to_srgb(rgb_premul)               (loss kernel)
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from . import (avif, bmp, exr, gif, hdr, jpeg, jpeg2000, png, pxm, sunras,
               tiff, webp)
from .errors import ImwriteFailed, UnreadableImage, unreadable, unsupported


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

def _reader(path):
    """The reader of the file's format, from its signature, as
    `cv2.imread` finds it. A missing file or one of no format cv2 reads
    raises UnreadableImage (cv2 returns None); a format cv2 reads and the
    port does not, UnsupportedImage."""
    if not os.path.isfile(str(path)):
        unreadable(path, f"Cannot read image: {path}")
    with open(path, "rb") as f:
        head = f.read(512)
    if head.startswith(png.SIGNATURE):
        return png.read_png
    if head.startswith(jpeg.SIGNATURE):
        return jpeg.read_jpeg
    if head[:4] in tiff.SIGNATURES:
        return tiff.read_tiff
    if head.startswith(exr.MAGIC):
        return _read_exr
    if head.startswith(bmp.SIGNATURE):
        return bmp.read_bmp
    if pxm.is_pnm(head):
        return pxm.read_pnm
    if pxm.is_pam(head):
        return pxm.read_pam
    if pxm.is_pfm(head):
        return pxm.read_pfm
    if head.startswith(hdr.SIGNATURES):
        return hdr.read_hdr
    if head.startswith(sunras.SIGNATURE):
        return sunras.read_sunras
    if head.startswith(gif.SIGNATURES):
        return gif.read_gif
    if webp.is_webp(head):
        return webp.read_webp
    if jpeg2000.is_jpeg2000(head):
        return jpeg2000.read_jpeg2000
    if avif.is_avif(head):
        return avif.read_avif
    unreadable(path, "not an image file cv2 reads")


def _read_exr(path, mode: str = "unchanged") -> np.ndarray:
    if mode != "unchanged":
        unsupported(path, "EXR read as 8-bit colour or grey")
    return exr.read_exr(path)


def read_image(path, mode: str = "unchanged") -> np.ndarray:
    """`cv2.imread(path, flag)` in RGB(A) order, the format found from the
    file's signature. mode "unchanged" (IMREAD_UNCHANGED): uint8, uint16
    or float32, (H, W) grey, (H, W, 3) or (H, W, 4); a grey+alpha PNG
    comes back as (grey, grey, grey, alpha), a grey+alpha PAM as (H, W,
    2). "color" (IMREAD_COLOR): uint8 (H, W, 3);
    "grey" (IMREAD_GRAYSCALE): uint8 (H, W); both with the EXIF
    orientation applied."""
    reader = _reader(path)
    img = reader(path, mode)
    if reader is png.read_png and img.ndim == 3 and img.shape[2] == 2:
        img = img[..., [0, 0, 0, 1]]
    return img


def read_raw(path) -> np.ndarray:
    """`read_image(path)`: the samples as `cv2.imread(IMREAD_UNCHANGED)`
    gives them, in RGB(A) order."""
    return read_image(path)


def color_shape(path):
    """(H, W) of `cv2.imread(path)` (IMREAD_COLOR): an EXIF orientation of
    5-8 swaps them (PNG, JPEG, WebP)."""
    reader = _reader(path)
    if reader in (png.read_png, jpeg.read_jpeg, webp.read_webp):
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


PNM_KINDS = {".ppm": "ppm", ".pgm": "pgm", ".pbm": "pbm", ".pnm": "auto"}


def _to_8bit(image: np.ndarray) -> np.ndarray:
    """loadsave.cpp's fallback for an 8-bit-only encoder: convertTo(CV_8U),
    which saturates 16-bit samples at 255."""
    return np.minimum(image, 255).astype(np.uint8)


def write_raw(path, image: np.ndarray) -> None:
    """uint8 or uint16 samples in RGB(A) order, written in the format the
    extension names, as `cv2.imwrite` writes them: `.png`; `.tif`/`.tiff`
    (LZW, horizontal differencing); `.jpg`/`.jpeg`/`.jpe` (quality 95,
    4:2:0, alpha dropped); `.bmp`/`.dib`; `.ppm`, `.pgm`, `.pbm`,
    `.pnm` (binary); `.pam`; `.pfm` and `.hdr`/`.pic` (which also
    take float32); `.ras`/`.sr`; `.webp` (lossless; grey as three
    channels; no colour kept under alpha 0); `.gif` (cv2's fixed palette
    and dithering; RGB or RGBA only); `.jp2` (OpenJPEG's lossless 5/3 at
    a rate capped at a quarter of the raw samples; 32 pixels a side at
    least); `.avif` (lossy, 8-bit only: the kind of file cv2 writes at
    its defaults, from the port's own AV1 encoder, so not cv2's bytes or
    pixels: grey as a monochrome item, RGB as 4:2:0 BT.601 full range,
    an alpha channel with any sample under 255 as an auxiliary
    monochrome item; `avif.encode_avif`). Formats of 8-bit samples (JPEG,
    BMP, Sun raster, PBM, WebP, GIF) take 16-bit ones saturated to 255,
    as cv2's conversion to 8 bits does. Where cv2.imwrite returns False
    (a colour `.pgm`, a grey `.ppm` or `.gif`, a 4-channel `.ppm`, `.pfm`
    or `.hdr`, a `.jp2` under 32 pixels a side, 16-bit `.avif`) this
    raises `errors.ImwriteFailed`, and where it raises (2 or 5 channels,
    ...) ValueError; either way it writes nothing. So do `.exr`
    (OpenCV's EXR encoder takes only float samples: `save_exr` writes
    floats) and any other extension (`.j2k` among them: cv2 5 has no
    writer for it)."""
    ext = os.path.splitext(str(path))[1].lower()
    image = np.asarray(image)
    if image.dtype == np.float32 and ext not in (".pfm", ".hdr", ".pic"):
        raise ValueError(f"{path}: float32 samples are written as .pfm, "
                         ".hdr or .exr (save_exr)")
    if ext == ".png":
        png.write_png(path, image)
    elif ext in (".tif", ".tiff"):
        tiff.write_tiff(path, image)
    elif ext in (".jpg", ".jpeg", ".jpe"):
        if image.ndim == 3:
            image = image[..., :3]
        jpeg.write_jpeg(path, _to_8bit(image))
    elif ext in (".bmp", ".dib"):
        bmp.write_bmp(path, _to_8bit(image))
    elif ext in PNM_KINDS:
        kind = PNM_KINDS[ext]
        pxm.write_pnm(path, _to_8bit(image) if kind == "pbm" else image,
                      kind)
    elif ext == ".pam":
        pxm.write_pam(path, image)
    elif ext == ".pfm":
        pxm.write_pfm(path, image)
    elif ext in (".hdr", ".pic"):
        hdr.write_hdr(path, image)
    elif ext in (".ras", ".sr"):
        sunras.write_sunras(path, _to_8bit(image))
    elif ext == ".webp":
        webp.write_webp(path, _to_8bit(image))
    elif ext == ".gif":
        gif.write_gif(path, _to_8bit(image))
    elif ext == ".jp2":
        jpeg2000.write_jp2(path, image)
    elif ext == ".exr":
        raise ValueError(f"{path}: an EXR file holds float samples; "
                         f"{image.dtype} cannot be written (use save_exr)")
    elif ext == ".avif":
        avif.write_avif(path, image)
    else:
        raise ValueError(f"{path}: no image writer for extension "
                         f"{ext or '(none)'!r}")


def save_image(image: np.ndarray, path, bit_depth: int = 16) -> None:
    """[0, 1] floats → 8- or 16-bit samples (NaN → 0), written by
    `write_raw` in the format the extension names. Where cv2.imwrite
    returns False, this returns as the JAX save_image does (which ignores
    that result) and leaves what cv2 leaves: no file, an empty `.gif`, a
    `.pfm` of "P", a `.jp2` of its header boxes."""
    image = np.nan_to_num(np.asarray(image, np.float32), nan=0.0)
    image = np.clip(image, 0.0, 1.0) * float(2 ** bit_depth - 1)
    try:
        write_raw(path, image.astype(np.uint8 if bit_depth == 8
                                     else np.uint16))
    except ImwriteFailed as e:
        if e.left is not None:
            Path(path).write_bytes(e.left)


def save_exr(image: np.ndarray, path) -> None:
    """float32 (H, W), (H, W, 3) or (H, W, 4) → an EXR of FLOAT channels,
    ZIP-compressed, holding what the JAX `save_exr` hands cv2: an image
    of 3 or more channels reversed, then named B, G, R(, A) as cv2's EXR
    encoder names them. For RGB that is each channel under its own name;
    for RGBA the file's R holds G, its G holds B, its B holds A and its A
    holds R."""
    image = np.asarray(image, np.float32)
    if image.ndim == 3 and image.shape[2] == 4:
        image = image[:, :, [1, 2, 3, 0]]
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
