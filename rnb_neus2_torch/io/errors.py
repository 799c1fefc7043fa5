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
"""

from __future__ import annotations


class UnreadableImage(FileNotFoundError, ValueError):
    """A file that `cv2.imread` cannot read either."""


class UnsupportedImage(ValueError):
    """A file that `cv2.imread` reads and the port does not."""


def unreadable(path, what: str):
    raise UnreadableImage(f"{path}: {what}")


def unsupported(path, what: str):
    raise UnsupportedImage(f"{path}: {what} is not supported")
