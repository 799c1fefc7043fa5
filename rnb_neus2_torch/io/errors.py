"""The two ways the image readers refuse a file.

- `UnreadableImage`: `cv2.imread` returns None for this file too (a
  missing file, an unknown format, a malformed header, a JPEG kind that
  libjpeg-turbo does not decode, ...). The JAX package's read sites test
  for that None, so the port's read sites catch this class and do what
  they do. It is a `FileNotFoundError`, which is what the JAX loaders
  raise for a None (`load_image`: "Cannot read image: ..."), and a
  `ValueError`, the type of every refusal before the split.
- `UnsupportedImage`: cv2 reads this file but the port does not yet (the
  EXR variants, other formats). It stays a loud `ValueError` naming the
  file and the feature.

And one way a writer refuses: `ImwriteFailed`, where `cv2.imwrite`
returns False (a colour `.pgm`, a grey `.gif`, a JPEG 2000 under 32
pixels a side, ...) rather than raising. `left` holds the bytes cv2
leaves at the path (None: no file), which `image_io.save_image` writes
and returns, as the JAX save_image does.
"""

from __future__ import annotations


class UnreadableImage(FileNotFoundError, ValueError):
    """A file that `cv2.imread` cannot read either."""


class UnsupportedImage(ValueError):
    """A file that `cv2.imread` reads and the port does not."""


class ImwriteFailed(ValueError):
    """Samples that `cv2.imwrite` returns False for; `left` is what it
    leaves at the path (None: nothing)."""

    def __init__(self, message: str, left: bytes = None):
        super().__init__(message)
        self.left = left


def unreadable(path, what: str):
    raise UnreadableImage(f"{path}: {what}")


def unsupported(path, what: str):
    raise UnsupportedImage(f"{path}: {what} is not supported")


# cv2's imread refuses larger images before it decodes them
# (loadsave.cpp:validateInputImageSize, CV_IO_MAX_IMAGE_WIDTH/HEIGHT/PIXELS)
MAX_SIDE, MAX_PIXELS = 1 << 20, 1 << 30


def check_size(path, width: int, height: int) -> None:
    if not (0 < width <= MAX_SIDE and 0 < height <= MAX_SIDE
            and width * height <= MAX_PIXELS):
        unreadable(path, f"image of {width}x{height} pixels, past cv2's "
                   "limits")
