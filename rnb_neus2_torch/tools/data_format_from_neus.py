"""Convert a NeuS-style dataset (cameras_sphere.npz + image/ + mask/) to
the testbed's transform.json layout (port of the repository's
`tools/data_format_from_neus.py`, itself a numpy version of the
reference's tools/data_format_from_neus.py).

Output in `output_dir`: images/ (8-bit RGBA PNGs: the view's RGB and the
mask as alpha) and transform.json (w, h, scale = 0.5, offset = [.5, .5,
.5], from_na, n2w = scale_mat_0, and per frame the c2w and K decomposed
from P = world_mat @ scale_mat by `io.dataloaders.decompose_projection`).

Images and masks are read as the original reads them with cv2 (colour
for the image, grey for the mask), through `io/png.py`: PNG only, where
another format is refused by name. A 16-bit sample keeps its high byte, a
grey image becomes three equal channels, an image's own alpha is dropped,
and a colour mask becomes its luma (0.299 R + 0.587 G + 0.114 B).

    python -m rnb_neus2_torch.tools.data_format_from_neus DATASET OUT \
        [--cameras-name cameras_sphere.npz] [--image-folder image] \
        [--mask-folder mask]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..io.dataloaders import decompose_projection
from ..io.png import read_png, write_png


def _read_8bit(path) -> np.ndarray:
    if os.path.splitext(path)[1].lower() != ".png":
        raise ValueError(f"{path}: only PNG images are read (this "
                         "converter has no decoder for other formats)")
    img = read_png(path)
    return (img >> 8).astype(np.uint8) if img.dtype == np.uint16 else img


def _read_colour(path) -> np.ndarray:
    img = _read_8bit(path)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] in (1, 2):
        img = np.repeat(img[..., :1], 3, axis=2)
    return img[..., :3]


def _read_grey(path) -> np.ndarray:
    img = _read_8bit(path)
    if img.ndim == 2:
        return img
    if img.shape[2] <= 2:
        return img[..., 0]
    rgb = img[..., :3].astype(np.float64)
    return np.rint(rgb @ np.array([0.299, 0.587, 0.114])).astype(np.uint8)


def generate(dataset_dir, output_dir, cameras_name="cameras_sphere.npz",
             image_folder="image", mask_folder="mask"):
    cams = np.load(os.path.join(dataset_dir, cameras_name))
    img_dir = os.path.join(dataset_dir, image_folder)
    msk_dir = os.path.join(dataset_dir, mask_folder)
    images = sorted(os.listdir(img_dir))
    masks = sorted(os.listdir(msk_dir)) if os.path.isdir(msk_dir) else []
    print(f"#images: {len(images)}")

    out_img_dir = os.path.join(output_dir, "images")
    os.makedirs(out_img_dir, exist_ok=True)

    frames = []
    W = H = None
    for i, name in enumerate(images):
        img = _read_colour(os.path.join(img_dir, name))
        if masks:
            msk = _read_grey(os.path.join(msk_dir, masks[i]))
        else:
            msk = np.full(img.shape[:2], 255, np.uint8)
        rgba = np.concatenate([img, msk[:, :, None]], axis=-1)
        H, W = rgba.shape[:2]
        write_png(os.path.join(out_img_dir, name), rgba)

        P = (cams[f"world_mat_{i}"] @ cams[f"scale_mat_{i}"])[:3, :4]
        K, c2w = decompose_projection(P.astype(np.float32))
        frames.append({
            "file_path": f"images/{name}",
            "normal_path": f"images/{name}",
            "albedo_path": f"images/{name}",
            "transform_matrix": np.asarray(c2w, np.float64).tolist(),
            "intrinsic_matrix": np.asarray(K, np.float64).tolist(),
        })

    transform = {
        "w": W, "h": H,
        "aabb_scale": 1.0,
        "scale": 0.5,
        "offset": [0.5, 0.5, 0.5],
        "from_na": True,
        "n2w": np.asarray(cams["scale_mat_0"], np.float64).tolist(),
        "frames": frames,
    }
    with open(os.path.join(output_dir, "transform.json"), "w") as f:
        json.dump(transform, f, indent=4)
    print(f"Wrote {output_dir}/transform.json")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("dataset_dir")
    p.add_argument("output_dir")
    p.add_argument("--cameras-name", default="cameras_sphere.npz")
    p.add_argument("--image-folder", default="image")
    p.add_argument("--mask-folder", default="mask")
    a = p.parse_args(argv)
    generate(a.dataset_dir, a.output_dir, a.cameras_name, a.image_folder,
             a.mask_folder)


if __name__ == "__main__":
    main()
