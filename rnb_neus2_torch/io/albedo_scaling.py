"""Multi-view albedo scale harmonization (port of
`rnb_neus2_tpu/io/albedo_scaling.py`; reference:
rnb_neus2/albedo_scaling.py). Images go through the port's codecs
(`io/image_io.py`); an `.exr` albedo is read, and its scaled copy, like
cv2's write of integer samples to an `.exr` name, raises.

Photometric-stereo albedos are recovered per view up to an unknown scale;
this stage estimates one RGB scale per view so albedos agree across views:

1. per view, sample n_samples in-mask pixels and ray-cast them into the
   phase-1 mesh (:288-292);
2. re-project each hit point into the ±1 ring-neighbor views, with an
   occlusion shadow-ray test (origin nudged eps = max(dist·1e−4, 1e−2)
   toward the neighbor camera, blocked iff a hit closer than dist−eps;
   :300-330);
3. bilinearly interpolate the neighbor albedo at the re-projection and
   form per-channel ratios; zero-valued neighbor samples are dropped
   (:349-371);
4. per neighbor pair, the MEDIAN ratio; chained cumulative product
   prop[i+1] = prop[i]·median[i] normalized by its mean (:373-396).

Cameras come from transform.json (with the n2w transform applied —
the phase-1 mesh lives in world space; :182-184) or cameras.npz. Ray
casting uses the native BVH (io/raycast.py) instead of trimesh/embree.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils.meters import Logger
from . import image_io
from .raycast import RayCaster


# ---------------------------------------------------------------------------
# camera loading
# ---------------------------------------------------------------------------

def load_cameras_from_transform_json(path, albedo_names, logger=None):
    with open(path) as f:
        data = json.load(f)
    n2w = np.asarray(data["n2w"], np.float64) if "n2w" in data else None
    frames = data.get("frames", [])
    by_stem = {Path(fr["albedo_path"]).stem: fr for fr in frames}

    Ks, Rs, cs = [], [], []
    for name in albedo_names:
        fr = by_stem.get(Path(name).stem)
        if fr is None:
            raise RuntimeError(f"No frame for albedo image: {name}")
        K = np.eye(3, dtype=np.float64)
        K[:3, :3] = np.asarray(fr["intrinsic_matrix"], np.float64)[:3, :3]
        c2w = np.asarray(fr["transform_matrix"], np.float64)
        if c2w.shape == (3, 4):
            c2w = np.vstack([c2w, [0, 0, 0, 1]])
        if n2w is not None:
            c2w = n2w @ c2w
        Ks.append(K)
        Rs.append(c2w[:3, :3])
        cs.append(c2w[:3, 3])
    if logger:
        logger.info(f"Loaded {len(Ks)} cameras from transform.json")
    return np.asarray(Ks), np.asarray(Rs), np.asarray(cs)


def load_cameras_from_npz(path, n_views, logger=None):
    from .dataloaders import decompose_projection

    cams = np.load(path)
    Ks, Rs, cs = [], [], []
    for i in range(n_views):
        P = (cams[f"world_mat_{i}"] @ cams[f"scale_mat_{i}"])[:3, :4]
        K, c2w = decompose_projection(P.astype(np.float32))
        Ks.append(np.asarray(K, np.float64)[:3, :3])
        Rs.append(np.asarray(c2w, np.float64)[:3, :3])
        cs.append(np.asarray(c2w, np.float64)[:3, 3])
    return np.asarray(Ks), np.asarray(Rs), np.asarray(cs)


def load_cameras(camera_source, albedo_names, logger=None):
    p = Path(camera_source)
    if p.suffix == ".npz":
        return load_cameras_from_npz(p, len(albedo_names), logger)
    if p.suffix in (".json", ".sfm") or p.name == "transform.json":
        return load_cameras_from_transform_json(p, albedo_names, logger)
    raise ValueError(f"Unsupported camera format: {p.suffix}")


# ---------------------------------------------------------------------------
# core
# ---------------------------------------------------------------------------

def _bilinear(img: np.ndarray, xy: np.ndarray) -> np.ndarray:
    """img (H,W,3); xy (N,2) pixel coords (x, y) → (N,3)."""
    x, y = xy[:, 0], xy[:, 1]
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    fx, fy = x - x0, y - y0
    H, W = img.shape[:2]
    x0 = np.clip(x0, 0, W - 2)
    y0 = np.clip(y0, 0, H - 2)
    c00 = img[y0, x0]
    c10 = img[y0, x0 + 1]
    c01 = img[y0 + 1, x0]
    c11 = img[y0 + 1, x0 + 1]
    return (c00 * ((1 - fx) * (1 - fy))[:, None]
            + c10 * (fx * (1 - fy))[:, None]
            + c01 * ((1 - fx) * fy)[:, None]
            + c11 * (fx * fy)[:, None])


def compute_albedo_scale_ratios(albedo_path, camera_source, mesh_path,
                                n_samples: int = 2000, logger=None,
                                rng: Optional[np.random.Generator] = None):
    """Returns (n_views, 3) per-view RGB scale factors."""
    logger = logger or Logger()
    rng = rng or np.random.default_rng()

    names = sorted(f for f in os.listdir(albedo_path)
                   if f.lower().endswith((".png", ".exr")))
    n_views = len(names)
    logger.info(f"Loading {n_views} albedo images...")
    albedos, masks = [], []
    for name in names:
        img = image_io.load_image(os.path.join(albedo_path, name))
        mask = img[:, :, 3] if img.shape[2] == 4 else np.ones(img.shape[:2])
        albedos.append(img[:, :, :3])
        masks.append(mask)
    albedos = np.asarray(albedos)
    masks = np.asarray(masks)
    _, h, w, _ = albedos.shape

    Ks, Rs, cs = load_cameras(camera_source, names, logger)

    logger.info(f"Loading mesh from {mesh_path}...")
    from ..mesh.writer import load_obj
    V, F = load_obj(mesh_path)
    caster = RayCaster(V, F)

    ratios = np.zeros((n_views, n_samples, 3, 2), np.float32)
    found = np.zeros((n_views, n_samples, 2), bool)

    logger.info("Computing ratios between neighboring views...")
    for cam in range(n_views):
        mask = masks[cam] > 0.5
        ys, xs = np.nonzero(mask)
        if len(xs) == 0:
            continue
        n_good = min(n_samples, len(xs))
        sel = rng.choice(len(xs), n_good, replace=False)
        px = np.stack([xs[sel], ys[sel]], axis=1).astype(np.float64)
        alb_vals = albedos[cam, ys[sel], xs[sel], :]

        Kinv = np.linalg.inv(Ks[cam])
        d_cam = (Kinv @ np.concatenate(
            [px, np.ones((n_good, 1))], axis=1).T)
        d_world = (Rs[cam] @ d_cam).T
        d_world /= np.linalg.norm(d_world, axis=1, keepdims=True)
        origins = np.broadcast_to(cs[cam], d_world.shape).copy()

        hit, locs, _ = caster.hits(origins, d_world)
        locs = locs[hit]
        ray_idx = np.nonzero(hit)[0]
        alb_hit = alb_vals[hit]

        for kk, neigh in enumerate([(cam + 1) % n_views,
                                    (cam - 1) % n_views]):
            to_cam = cs[neigh][None, :] - locs
            dist = np.linalg.norm(to_cam, axis=1, keepdims=True)
            dirs = to_cam / dist
            eps = np.maximum(dist[:, 0] * 1e-4, 1e-2)
            sh_origin = locs + eps[:, None] * dirs
            blocked = caster.occluded_within(sh_origin, dirs,
                                             dist[:, 0] - eps)

            pts = locs[~blocked]
            idx_kk = ray_idx[~blocked]
            alb_kk = alb_hit[~blocked]

            p_cam = Rs[neigh].T @ (pts.T - cs[neigh][:, None])
            proj = (Ks[neigh] @ p_cam).T
            proj = proj[:, :2] / proj[:, 2:3]
            ok = ((proj[:, 0] >= 0) & (proj[:, 0] < w - 1)
                  & (proj[:, 1] >= 0) & (proj[:, 1] < h - 1))
            proj, idx_kk, alb_kk = proj[ok], idx_kk[ok], alb_kk[ok]
            neigh_val = _bilinear(albedos[neigh].astype(np.float32), proj)

            nz = ~np.any(neigh_val == 0, axis=1)
            idx_kk, alb_kk, neigh_val = idx_kk[nz], alb_kk[nz], neigh_val[nz]
            ratios[cam, idx_kk, :, kk] = alb_kk / neigh_val
            found[cam, idx_kk, kk] = True

    logger.info("Computing final scaling factors...")
    med = np.zeros((n_views, 3))
    right_r, right_i = ratios[:, :, :, 0], found[:, :, 0]
    left_r = np.roll(ratios[:, :, :, 1], -1, axis=0)
    left_i = np.roll(found[:, :, 1], -1, axis=0)
    for cam in range(n_views):
        rr = right_r[cam, right_i[cam]]
        lr = 1.0 / left_r[cam, left_i[cam]]
        allr = np.concatenate([rr, lr], axis=0)
        med[cam] = np.median(allr, axis=0) if len(allr) else 1.0

    prop = np.ones((n_views, 3))
    for i in range(n_views - 1):
        prop[i + 1] = prop[i] * med[i]
    prop /= prop.mean(axis=0)
    logger.info(f"Scale ratios: {prop}")
    return prop


def scale_and_save_albedos(albedo_path, output_albedo_path, scale_ratios,
                           bit_depth=None, logger=None):
    """Apply per-view RGB scales, preserving alpha and bit depth
    (reference :399-436)."""
    logger = logger or Logger()
    os.makedirs(output_albedo_path, exist_ok=True)
    names = sorted(f for f in os.listdir(albedo_path)
                   if f.lower().endswith((".png", ".exr")))
    for i, name in enumerate(names):
        src = os.path.join(albedo_path, name)
        raw = image_io.read_raw(src)
        depth = bit_depth or (16 if raw.dtype == np.uint16 else 8)
        img = image_io.load_image(src)
        alpha = img[:, :, 3:] if img.shape[2] == 4 else None
        scaled = np.clip(img[:, :, :3] * scale_ratios[i][None, None, :],
                         0.0, 1.0)
        out = np.concatenate([scaled, alpha], axis=2) \
            if alpha is not None else scaled
        image_io.save_image(out, os.path.join(output_albedo_path, name),
                            bit_depth=depth)
    logger.info(f"Saved {len(names)} scaled albedos")
