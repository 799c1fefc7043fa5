"""Write this folder's writer fixtures: `input.png`, a seeded 48x40 RGBA
image shaped like a `Testbed` screenshot (a shaded disc over an alpha-0
background, with some noise), and `cv2.imwrite`'s `.webp`, `.gif`,
`.jp2` and `.avif` files of it. `chip_smoke.py` (phase 13) encodes the
same input with the port's writers on the card's host, which has no cv2,
and holds the results against these files (the AVIF, whose bytes are
libaom's and not the port's, by its decoded pixels' error);
tests/test_torch_image_writers.py regenerates them with cv2 and checks
that they have not drifted.

With --sizes it prints instead the sizes of cv2's files of phase 19's
612x512 codec view (`chip_smoke.codec_view`), which the card's host
cannot write, beside the port's sizes that phase 19 measures there.

Needs cv2, so it runs where the tests run:

    python tests/torch_fixtures/writers/make_fixtures.py [--sizes]
"""

import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[2]
EXTS = (".webp", ".gif", ".jp2", ".avif")


def make_input() -> np.ndarray:
    """(40, 48, 4) uint8 RGBA: a disc shaded across x and y, alpha 255 on
    it and 0 (with RGB 0) around it, plus seeded noise of ±6."""
    rng = np.random.default_rng(18)
    y, x = np.mgrid[:40, :48].astype(np.float32)
    disc = (x - 23.5) ** 2 + (y - 19.5) ** 2 < 17.0 ** 2
    rgb = np.stack([60 + 4 * x, 40 + 5 * y, 200 - 2 * x - y], -1)
    rgb = np.clip(rgb + rng.integers(-6, 7, rgb.shape), 0, 255)
    rgba = np.concatenate([rgb, 255 * disc[..., None]], -1).astype(np.uint8)
    rgba[~disc, :3] = 0
    return rgba


def cv2_bytes(image: np.ndarray, ext: str) -> bytes:
    """cv2.imwrite's file of an RGB(A) image, as bytes."""
    import cv2
    bgr = image[..., [2, 1, 0, 3][:image.shape[2]]] if image.ndim == 3 \
        else image
    ok, buf = cv2.imencode(ext, np.ascontiguousarray(bgr))
    assert ok, ext
    return buf.tobytes()


def write() -> None:
    import cv2
    rgba = make_input()
    cv2.imwrite(str(HERE / "input.png"), rgba[..., [2, 1, 0, 3]])
    for ext in EXTS:
        (HERE / f"cv2{ext}").write_bytes(cv2_bytes(rgba, ext))


def codec_view_sizes() -> dict:
    """cv2's bytes for phase 19's writer rows: 8-bit RGBA as .webp, .gif
    and .jp2, and 16-bit RGB as .jp2."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    rgb16, rgba8 = chip_smoke.codec_view()
    return {"webp_rgba_8bit": len(cv2_bytes(rgba8, ".webp")),
            "gif_rgba_8bit": len(cv2_bytes(rgba8, ".gif")),
            "jp2_rgba_8bit": len(cv2_bytes(rgba8, ".jp2")),
            "jp2_rgb_16bit": len(cv2_bytes(rgb16, ".jp2"))}


if __name__ == "__main__":
    if sys.argv[1:] == ["--sizes"]:
        print(json.dumps(codec_view_sizes()))
    else:
        write()
