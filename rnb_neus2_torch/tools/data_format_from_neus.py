"""Convert a NeuS-style dataset (cameras_sphere.npz + image/ + mask/) to
the testbed's transform.json layout (port of the repository's
`tools/data_format_from_neus.py`, itself a numpy version of the
reference's tools/data_format_from_neus.py).

Output in `output_dir`: images/ (8-bit RGBA PNGs: the view's RGB and the
mask as alpha) and transform.json (w, h, scale = 0.5, offset = [.5, .5,
.5], from_na, n2w = scale_mat_0, and per frame the c2w and K decomposed
from P = world_mat @ scale_mat by `io.dataloaders.decompose_projection`).

Images and masks are read as the original reads them with cv2 — the
image with `IMREAD_COLOR`, the mask with `IMREAD_GRAYSCALE`, each format
found from its signature (`io/image_io.py:read_image`: PNG, TIFF and
JPEG, with their EXIF orientation) — and each RGBA result is written
under its own name in the format that name's extension gives, as
`cv2.imwrite` writes it (a `.jpg` name drops the mask, as cv2's JPEG
writer drops alpha). EXR images, whose 8-bit conversion by cv2 the
tests cannot observe (their cv2 is built without OpenEXR), are refused
by name.

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
from ..io.image_io import read_image, write_raw


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
        img = read_image(os.path.join(img_dir, name), "color")
        if masks:
            msk = read_image(os.path.join(msk_dir, masks[i]), "grey")
        else:
            msk = np.full(img.shape[:2], 255, np.uint8)
        rgba = np.concatenate([img, msk[:, :, None]], axis=-1)
        H, W = rgba.shape[:2]
        write_raw(os.path.join(out_img_dir, name), rgba)

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
