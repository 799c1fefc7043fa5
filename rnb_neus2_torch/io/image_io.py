"""Image I/O and the exact training-time decode (port of
`rnb_neus2_tpu/io/image_io.py`).

Files are PNG, 8 or 16 bit, read and written by `io/png.py` (no `cv2`):
values are normalized to [0, 1] and channels come in RGB(A) order. The
JAX package reads through cv2 and flips its BGR(A) back to RGB(A); the
port's reader gives RGB(A) directly and flips nothing. A grey+alpha file
reads as (grey, grey, grey, alpha), as cv2 reads it. EXR and TIFF inputs,
which the JAX package reads only through cv2, raise.

Training decode (a 16-bit RGBA texel, common_device.cuh:665-690 +
testbed_nerf.cu:1504-1535):

    rgb_premul = srgb_to_linear(raw/65535) · alpha        (read_rgba)
    value      = linear_to_srgb(rgb_premul)               (loss kernel)
"""

from __future__ import annotations

import os

import numpy as np

from .png import read_png, write_png


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

def read_raw(path) -> np.ndarray:
    """A PNG's samples as `cv2.imread(IMREAD_UNCHANGED)` gives them, in
    RGB(A) order: (H, W) grey, (H, W, 3) or (H, W, 4); grey+alpha comes
    back as (grey, grey, grey, alpha)."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext in (".exr", ".tif", ".tiff"):
        raise ValueError(f"{path}: {ext[1:].upper()} input is not supported "
                         "by the PyTorch port yet; convert it to a 16-bit "
                         "PNG")
    if not os.path.exists(str(path)):
        raise FileNotFoundError(f"Cannot read image: {path}")
    img = read_png(path)
    if img.ndim == 3 and img.shape[2] == 2:
        img = img[..., [0, 0, 0, 1]]
    return img


def load_image(path) -> np.ndarray:
    """PNG 8/16-bit → [0,1] float32, RGB(A) order."""
    img = read_raw(path)
    return img.astype(np.float32) / float(np.iinfo(img.dtype).max)


def load_image_raw16(path) -> np.ndarray:
    """16-bit RGBA exactly as the engine's stbi_load_16 sees it:
    (H, W, 4) uint16, 8-bit inputs upscaled by 257."""
    img = read_raw(path)
    if img.dtype == np.uint8:
        img = img.astype(np.uint16) * 257
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[2] == 3:
        alpha = np.full(img.shape[:2] + (1,), 65535, np.uint16)
        img = np.concatenate([img, alpha], axis=-1)
    return img


def save_image(image: np.ndarray, path, bit_depth: int = 16) -> None:
    image = np.nan_to_num(np.asarray(image, np.float32), nan=0.0)
    image = np.clip(image, 0.0, 1.0) * float(2 ** bit_depth - 1)
    write_png(path, image.astype(np.uint8 if bit_depth == 8
                                 else np.uint16))


def load_normal(path) -> np.ndarray:
    """Normal map in [−1,1], remapped from the PNG's [0,1]."""
    img = load_image(path)
    if img.ndim == 3 and img.shape[2] > 3:
        img = img[:, :, :3]
    return img * 2.0 - 1.0


def save_normal_16bit(normal: np.ndarray, path) -> None:
    save_image(0.5 * (1.0 + np.asarray(normal)), path, bit_depth=16)
