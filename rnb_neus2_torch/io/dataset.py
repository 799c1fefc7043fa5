"""In-memory training dataset (port of `rnb_neus2_tpu/io/dataset.py`).

`load_transform_json` parses a prepared scene's transform.json (the
prepare stage's interchange format: w, h, scale, offset, from_na, n2w,
aabb_scale, the top-level lens distortion and frames[] with
transform_matrix (c2w) + intrinsic_matrix), applies the from_na camera
convention (rotation unchanged, translation → scale·t + offset,
nerf_loader.h:180-201) and pre-decodes every texel to the exact value the
loss kernel would compute (`image_io.decode_*`), so the training sampler
is a pure gather. `build_dataset` assembles one from numpy arrays.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..geom.camera import Cameras
from . import image_io


@dataclass
class SceneMeta:
    """Everything needed to undo the unit-cube normalization at export."""

    scale: float = 0.5
    offset: tuple = (0.5, 0.5, 0.5)
    from_na: bool = True
    n2w_scale: float = 1.0
    n2w_translation: tuple = (0.0, 0.0, 0.0)
    aabb_scale: float = 1.0


@dataclass
class TrainingDataset:
    cameras: Cameras
    normals: torch.Tensor        # (N, H, W, 3) decoded unit normals
    albedos: torch.Tensor        # (N, H, W, 3) decoded albedo values
    alpha_normal: torch.Tensor   # (N, H, W) float
    alpha_albedo: torch.Tensor   # (N, H, W) float
    skip_candidate: torch.Tensor  # (N, H, W) bool: premultiplied red ≤ 0
    meta: SceneMeta = field(default_factory=SceneMeta)

    @property
    def n_images(self) -> int:
        return self.normals.shape[0]

    @property
    def resolution(self):
        return self.cameras.resolution

    @property
    def device(self) -> torch.device:
        return self.normals.device

    def to(self, device) -> "TrainingDataset":
        return TrainingDataset(
            cameras=self.cameras.to(device),
            normals=self.normals.to(device),
            albedos=self.albedos.to(device),
            alpha_normal=self.alpha_normal.to(device),
            alpha_albedo=self.alpha_albedo.to(device),
            skip_candidate=self.skip_candidate.to(device),
            meta=self.meta)


def _decode_view(raw16: np.ndarray, is_normal: bool):
    rgb = raw16[..., :3].astype(np.float32) / 65535.0
    alpha = raw16[..., 3].astype(np.float32) / 65535.0
    if is_normal:
        value = image_io.decode_normal(rgb, alpha)
    else:
        value = image_io.decode_texel(rgb, alpha)
    return value, alpha


def load_transform_json(scene_dir: str, device="cpu") -> TrainingDataset:
    """Load a prepared scene directory holding transform.json, onto
    `device`."""
    with open(os.path.join(scene_dir, "transform.json")) as f:
        tj = json.load(f)

    scale = float(tj.get("scale", 0.5))
    offset = tuple(tj.get("offset", [0.5, 0.5, 0.5]))
    from_na = bool(tj.get("from_na", False))
    n2w = np.asarray(tj.get("n2w", np.eye(4)), np.float32)
    meta = SceneMeta(scale=scale, offset=offset, from_na=from_na,
                     n2w_scale=float(n2w[0, 0]),
                     n2w_translation=tuple(float(v) for v in n2w[:3, 3]),
                     aabb_scale=float(tj.get("aabb_scale", 1.0)))

    W, H = int(tj["w"]), int(tj["h"])
    rots, origins, focals, pps = [], [], [], []
    normals, albedos, a_n, a_a, skips = [], [], [], [], []
    for fr in tj["frames"]:
        c2w = np.asarray(fr["transform_matrix"], np.float32)
        K = np.asarray(fr["intrinsic_matrix"], np.float32)
        rot = c2w[:3, :3].copy()
        t = c2w[:3, 3] * scale + np.asarray(offset, np.float32)
        if not from_na:
            # instant-ngp convention: flip y,z columns then cycle rows
            rot[:, 1] *= -1
            rot[:, 2] *= -1
            rot = rot[[1, 2, 0], :]
            t = t[[1, 2, 0]]
        rots.append(rot)
        origins.append(t)
        focals.append([K[0, 0], K[1, 1]])
        pps.append([K[0, 2] / W, K[1, 2] / H])

        nrm_raw = image_io.load_image_raw16(
            os.path.join(scene_dir, fr["normal_path"]))
        alb_path = fr.get("albedo_path")
        if alb_path and os.path.exists(os.path.join(scene_dir, alb_path)):
            alb_raw = image_io.load_image_raw16(
                os.path.join(scene_dir, alb_path))
        else:
            alb_raw = np.full_like(nrm_raw, 65535)
        n_val, n_alpha = _decode_view(nrm_raw, is_normal=True)
        a_val, a_alpha = _decode_view(alb_raw, is_normal=False)
        normals.append(n_val)
        albedos.append(a_val)
        a_n.append(n_alpha)
        a_a.append(a_alpha)
        skips.append((nrm_raw[..., 0] == 0) | (nrm_raw[..., 3] == 0))

    t = lambda a, dtype=torch.float32: torch.as_tensor(
        np.asarray(a), dtype=dtype, device=device)
    # top-level lens distortion, shared by all frames as in the reference
    # (nerf_loader.cu:432-497: k1/k2/p1/p2 → iterative mode if any is
    # nonzero; ftheta_p0..p4 + w/h → F-theta)
    k = [float(tj.get(key, 0.0)) for key in ("k1", "k2", "p1", "p2")]
    distortion = t(np.tile(np.asarray(k, np.float32),
                           (len(tj["frames"]), 1))) \
        if any(v != 0.0 for v in k) else None
    ftheta = t([float(tj[f"ftheta_p{i}"]) for i in range(5)] + [W, H]) \
        if "ftheta_p0" in tj else None
    cams = Cameras(rot_c2w=t(np.stack(rots)), origin=t(np.stack(origins)),
                   focal=t(np.stack(focals)), principal=t(np.stack(pps)),
                   resolution=(W, H), distortion=distortion, ftheta=ftheta)
    return TrainingDataset(
        cameras=cams,
        normals=t(np.stack(normals)),
        albedos=t(np.stack(albedos)),
        alpha_normal=t(np.stack(a_n)),
        alpha_albedo=t(np.stack(a_a)),
        skip_candidate=t(np.stack(skips), torch.bool),
        meta=meta,
    )


def build_dataset(cameras: Cameras, normals, albedos, alpha_normal,
                  alpha_albedo, meta: Optional[SceneMeta] = None
                  ) -> TrainingDataset:
    """Assemble a dataset from already-decoded numpy arrays, on the
    cameras' device.

    The black-pixel skip candidate (premultiplied linear red ≤ 0 in the raw
    normal texel, testbed_nerf.cu:1264-1266) reduces to alpha == 0 for
    synthetic data whose in-mask normals have nonzero red.
    """
    dev = cameras.rot_c2w.device
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    alpha_n = np.asarray(alpha_normal, np.float32)
    return TrainingDataset(
        cameras=cameras,
        normals=t(normals),
        albedos=t(albedos),
        alpha_normal=t(alpha_n),
        alpha_albedo=t(alpha_albedo),
        skip_candidate=torch.as_tensor(alpha_n <= 0.0, device=dev),
        meta=meta or SceneMeta(),
    )
