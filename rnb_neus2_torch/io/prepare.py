"""Prepare stage: loaded scene → testbed directory (transform.json +
normals/ + albedos/ RGBA PNGs). Port of `rnb_neus2_tpu/io/prepare.py`,
reading through the port's codecs (`io/image_io.py:read_raw`: PNG, TIFF,
JPEG, EXR) and writing PNG (`io/png.py`). A file that cv2 cannot read
either (`errors.UnreadableImage`) is handled as the JAX package handles
cv2's None: a normal map's view is skipped with a warning, an albedo is
all ones, a mask fully opaque.

Reference behavior (rnb_neus2/prepare.py:116-257) reproduced exactly:
- scaling-mode priority chain silhouettes_v2 → silhouettes → landmarks →
  camera centers (auto), or forced / none (:44-113);
- camera centers rescaled c2w[:3,3] = s·(c − center) (:148-150);
- EXR float normals in [−1,1] mapped to uint16; float albedos clipped to
  [0,1] → uint16;
- alpha masks regenerated PER TARGET BIT DEPTH (the
  mixed-bit-depth bug guarded by tests/test_prepare_albedo_alpha.py in the
  reference) (:160-215);
- output images written as {idx:05d}.png RGBA;
- transform.json: w, h, aabb_scale=1.0, scale=0.5, offset=[.5,.5,.5],
  from_na=true, n2w = inv(scale_matrix), frames[{normal_path, albedo_path,
  transform_matrix, intrinsic_matrix}] (:234-249).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..utils.meters import Logger
from . import image_io, png
from .errors import UnreadableImage
from . import scaling as sc


def load_mask_for_depth(mask_path, shape, bit_depth: int) -> np.ndarray:
    """Binary mask at the target bit depth; full-opaque when absent or
    unreadable by cv2 (prepare.py:23-41); `scaling.read_mask` thresholds
    it (float samples above 0.5)."""
    max_val = 65535 if bit_depth == 16 else 255
    dtype = np.uint16 if bit_depth == 16 else np.uint8
    if mask_path and os.path.exists(str(mask_path)):
        try:
            return (sc.read_mask(mask_path) * max_val).astype(dtype)
        except UnreadableImage:
            pass
    return np.full(shape, max_val, dtype)


def compute_scaling(data: dict, scaling_mode: str = "auto",
                    sphere_scale: float = 1.0, margin_px: float = 20,
                    logger=None):
    """Priority chain from prepare.py:44-113."""
    logger = logger or Logger()
    if scaling_mode == "none":
        return (np.zeros(3, np.float32), 1.0, np.eye(4, dtype=np.float32))

    if scaling_mode in ("auto", "silhouettes", "silhouettes_v2"):
        cams, masks = sc.cameras_for_silhouettes(data)
        if cams:
            if scaling_mode in ("auto", "silhouettes_v2"):
                logger.info(f"Scaling from silhouettes_v2 "
                            f"(min enclosing sphere): {len(cams)} views")
                center, s = sc.silhouette_scaling_v2(
                    cams, masks, sphere_scale, margin_px)
            else:
                logger.info(f"Scaling from silhouettes: {len(cams)} views")
                center, s = sc.silhouette_scaling(cams, masks, sphere_scale)
            center = np.asarray(center, np.float32)
            return center, float(s), sc.scale_matrix_from(center, s)

    if scaling_mode in ("auto", "pcd"):
        lm = data.get("landmarks")
        if lm is not None and len(lm) > 0:
            logger.info(f"Scaling from landmarks: {len(lm)} points")
            return sc.unit_sphere_from_points(lm, sphere_scale)

    if scaling_mode in ("auto", "cameras"):
        centers = np.array([v["c2w"][:3, 3] for v in data["views"]],
                           np.float32)
        if len(centers):
            logger.info(f"Scaling from camera centers: {len(centers)}")
            return sc.unit_sphere_from_points(centers, sphere_scale)

    raise RuntimeError("No data for scaling. "
                       "Use scaling_mode='none' to disable.")


def _to_uint16_normal(img: np.ndarray) -> np.ndarray:
    """EXR float normals [−1,1] → uint16 (prepare.py:166-169)."""
    v = np.clip((img + 1.0) / 2.0, 0, 1)
    return (v * 65535).astype(np.uint16)


def prepare_testbed_data(data: dict, output_folder: str, logger=None,
                         scaling_mode: str = "auto",
                         sphere_scale: float = 1.0,
                         margin_px: float = 20) -> dict:
    logger = logger or Logger()
    normals_dir = os.path.join(output_folder, "normals")
    albedos_dir = os.path.join(output_folder, "albedos")
    os.makedirs(normals_dir, exist_ok=True)
    os.makedirs(albedos_dir, exist_ok=True)

    center, s, scale_matrix = compute_scaling(
        data, scaling_mode, sphere_scale, margin_px, logger)
    logger.info(f"Scene center: {np.asarray(center).tolist()}")
    logger.info(f"Scale factor: {s:.6f}")

    frames = []
    for idx, view in enumerate(data["views"]):
        c2w = np.asarray(view["c2w"], np.float64).copy()
        c2w[:3, 3] = s * (c2w[:3, 3] - np.asarray(center, np.float64))

        try:
            nrm = image_io.read_raw(view["normal_path"])
        except UnreadableImage:        # missing, or cv2 returns None
            logger.warning(f"Cannot read: {view['normal_path']}")
            continue
        if nrm.dtype == np.float32:
            nrm = _to_uint16_normal(nrm)
        if nrm.ndim == 3 and nrm.shape[2] == 4:
            nrm = nrm[:, :, :3]
        bit_depth = 16 if nrm.dtype == np.uint16 else 8
        max_val = 65535 if bit_depth == 16 else 255

        alb = None
        ap = view.get("albedo_path")
        if ap and os.path.exists(str(ap)):
            try:
                alb = image_io.read_raw(ap)
            except UnreadableImage:    # cv2's None: an all-ones albedo
                alb = None
        if alb is not None:
            if alb.dtype == np.float32:
                alb = (np.clip(alb, 0, 1) * 65535).astype(np.uint16)
            if alb.ndim == 3 and alb.shape[2] == 4:
                alb = alb[:, :, :3]
        if alb is None:
            alb = np.full_like(nrm, max_val)

        # masks matched to each target's bit depth (prepare.py:196-215)
        n_mask = load_mask_for_depth(view.get("mask_path"), nrm.shape[:2],
                                     bit_depth)
        a_depth = 16 if alb.dtype == np.uint16 else 8
        a_mask = n_mask if a_depth == bit_depth else load_mask_for_depth(
            view.get("mask_path"), alb.shape[:2], a_depth)

        name = f"{idx:05d}.png"
        png.write_png(os.path.join(normals_dir, name),
                      np.dstack([nrm, n_mask]))
        png.write_png(os.path.join(albedos_dir, name),
                      np.dstack([alb, a_mask]))
        frames.append({
            "albedo_path": f"albedos/{name}",
            "normal_path": f"normals/{name}",
            "transform_matrix": c2w.tolist(),
            "intrinsic_matrix": np.asarray(view["K"]).tolist(),
        })

    if not frames:
        raise RuntimeError("No valid frames could be processed")
    logger.info(f"Processed {len(frames)} frames")

    n2w = np.linalg.inv(scale_matrix)
    transform = {
        "w": data["image_width"],
        "h": data["image_height"],
        "aabb_scale": 1.0,
        "scale": 0.5,
        "offset": [0.5, 0.5, 0.5],
        "from_na": True,
        "n2w": n2w.tolist(),
        "frames": frames,
    }
    path = os.path.join(output_folder, "transform.json")
    with open(path, "w") as f:
        json.dump(transform, f, indent=4)
    logger.info(f"Saved transform.json to {path}")
    return {"scene_center": center, "scale_factor": s,
            "scale_matrix": scale_matrix, "n2w": n2w,
            "n_frames": len(frames)}
