"""Synthetic analytic scenes (port of the numpy part of
`rnb_neus2_tpu/testing/synthetic.py`).

Per-view normal maps (camera frame), albedo maps and masks made in numpy
from closed forms, so that a run needs no data file: a Lambertian sphere
centred in the unit cube, and the composite scene (sphere ∪ torus ∪
rounded box) whose analytic SDF gives the ground-truth mesh of the
Chamfer gate, with its unit-sphere-normalized v2 (`composite_norm`,
`composite_sdf_v2`, `composite_dataset_v2`, `composite_gt_mesh_v2`,
`write_prepared_composite_scene`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..geom.camera import Cameras
from ..io.dataset import SceneMeta, TrainingDataset, build_dataset
from ..mesh.marching import marching_cubes_grid


def ring_cameras(n_views: int, radius: float, width: int, height: int,
                 focal: float, center=(0.5, 0.5, 0.5),
                 elevation: float = 0.35, device="cpu") -> Cameras:
    """Cameras on a ring looking at the cube center (OpenCV convention:
    x right, y down, z forward)."""
    c = np.asarray(center, np.float32)
    rots, origins = [], []
    for i in range(n_views):
        ang = 2 * np.pi * i / n_views
        eye = c + radius * np.array([
            np.cos(ang) * np.cos(elevation),
            np.sin(ang) * np.cos(elevation),
            np.sin(elevation)], np.float32)
        fwd = c - eye
        fwd = fwd / np.linalg.norm(fwd)
        up_world = np.array([0.0, 0.0, -1.0], np.float32)
        right = np.cross(fwd, up_world)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        R = np.stack([right, down, fwd], axis=1)  # columns = cam axes
        rots.append(R.astype(np.float32))
        origins.append(eye)
    n = n_views
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return Cameras(
        rot_c2w=t(np.stack(rots)),
        origin=t(np.stack(origins)),
        focal=t(np.full((n, 2), focal, np.float32)),
        principal=t(np.full((n, 2), 0.5, np.float32)),
        resolution=(width, height),
    )


def render_sphere_views(cams: Cameras, center=(0.5, 0.5, 0.5),
                        radius: float = 0.25,
                        albedo_rgb=(0.8, 0.6, 0.4)):
    """Analytic ray-sphere render → decoded-space numpy arrays for
    build_dataset."""
    W, H = cams.resolution
    c = np.asarray(center, np.float32)
    n_views = cams.rot_c2w.shape[0]
    rots = cams.rot_c2w.cpu().numpy()
    origins = cams.origin.cpu().numpy()
    focal = cams.focal.cpu().numpy()
    pp = cams.principal.cpu().numpy()

    u = (np.arange(W) + 0.5) / W
    v = (np.arange(H) + 0.5) / H
    uu, vv = np.meshgrid(u, v)

    normals = np.zeros((n_views, H, W, 3), np.float32)
    alphas = np.zeros((n_views, H, W), np.float32)
    for i in range(n_views):
        d_cam = np.stack([
            (uu - pp[i, 0]) * W / focal[i, 0],
            (vv - pp[i, 1]) * H / focal[i, 1],
            np.ones_like(uu)], axis=-1)
        d_world = d_cam @ rots[i].T
        d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)
        oc = origins[i] - c
        b = np.sum(d_world * oc, axis=-1)
        disc = b * b - (np.sum(oc * oc) - radius * radius)
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0))
        hit &= t > 0
        p = origins[i] + t[..., None] * d_world
        n_world = (p - c) / radius
        # world → OpenCV camera frame; this is what the decoded GT must be
        n_cam = n_world @ rots[i]
        normals[i] = np.where(hit[..., None], n_cam, 0.0)
        # masked pixels decode (after the y/z negation) to (−1,+1,+1)/√3
        normals[i][~hit] = np.array([-1.0, 1.0, 1.0]) / np.sqrt(3.0)
        alphas[i] = hit.astype(np.float32)

    albedo = np.broadcast_to(np.asarray(albedo_rgb, np.float32),
                             (n_views, H, W, 3)).copy()
    albedo *= alphas[..., None]
    return normals, albedo, alphas


def sphere_dataset(n_views: int = 8, width: int = 48, height: int = 48,
                   radius: float = 0.25, cam_radius: float = 1.5,
                   focal: float = 70.0, albedo_rgb=(0.8, 0.6, 0.4),
                   device="cpu") -> TrainingDataset:
    cams = ring_cameras(n_views, cam_radius, width, height, focal,
                        device=device)
    normals, albedo, alphas = render_sphere_views(cams, radius=radius,
                                                  albedo_rgb=albedo_rgb)
    return build_dataset(cams, normals, albedo, alphas, alphas, SceneMeta())


def write_prepared_scene(out_dir, n_views: int = 8, width: int = 48,
                         height: int = 48, radius: float = 0.25,
                         cam_radius: float = 1.5, focal: float = 70.0,
                         albedo_scales=None):
    """Write the sphere as a prepared scene DIRECTORY (transform.json +
    16-bit RGBA normals/ and albedos/) through the port's PNG writer, so
    that a run goes through the same encode and decode as the pipeline's.
    Cameras are stored before normalization (t raw; the loader applies
    t → 0.5·t + 0.5)."""
    cams = ring_cameras(n_views, cam_radius, width, height, focal)
    normals, albedo, alphas = render_sphere_views(cams, radius=radius)
    return _write_prepared(out_dir, cams, normals, albedo, alphas, focal,
                           albedo_scales)


def _write_prepared(out_dir, cams: Cameras, normals, albedo, alphas,
                    focal: float, albedo_scales=None):
    """Rendered views → a prepared scene directory (transform.json +
    16-bit RGBA normals/ and albedos/)."""
    import json
    import os

    from ..io import image_io

    width, height = cams.resolution
    n_views = normals.shape[0]
    os.makedirs(os.path.join(out_dir, "normals"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "albedos"), exist_ok=True)

    frames = []
    rots = cams.rot_c2w.numpy()
    origins = cams.origin.numpy()
    for i in range(n_views):
        # decoded = stored*2−1 with y,z negated → stored = decoded·(1,−1,−1)
        stored = normals[i] * np.array([1.0, -1.0, -1.0])
        png = np.concatenate([(stored + 1.0) / 2.0, alphas[i][..., None]],
                             axis=-1)
        name = f"{i:05d}.png"
        image_io.save_image(png, os.path.join(out_dir, "normals", name), 16)
        a = albedo[i].copy()
        if albedo_scales is not None:
            a = np.clip(a * albedo_scales[i], 0, 1)
        image_io.save_image(
            np.concatenate([a, alphas[i][..., None]], axis=-1),
            os.path.join(out_dir, "albedos", name), 16)

        c2w = np.eye(4)
        c2w[:3, :3] = rots[i]
        # the loader maps t → 0.5·t + 0.5; invert so origins land as built
        c2w[:3, 3] = (origins[i] - 0.5) / 0.5
        K = np.eye(4)
        K[0, 0] = K[1, 1] = focal
        K[0, 2], K[1, 2] = width / 2.0, height / 2.0
        frames.append({"albedo_path": f"albedos/{name}",
                       "normal_path": f"normals/{name}",
                       "transform_matrix": c2w.tolist(),
                       "intrinsic_matrix": K.tolist()})
    tj = {"w": width, "h": height, "aabb_scale": 1.0, "scale": 0.5,
          "offset": [0.5, 0.5, 0.5], "from_na": True,
          "n2w": np.eye(4).tolist(), "frames": frames}
    with open(os.path.join(out_dir, "transform.json"), "w") as f:
        json.dump(tj, f)
    return out_dir


def _world_views(n_views, width, height, radius, cam_radius, focal,
                 world_center, world_scale, albedo_scales):
    """The sphere's views in a world frame: the unit cube scaled by
    `world_scale` about the sphere's centre, which lands on
    `world_center`. → (c2w rotations, camera centres, the stored normals
    (the y/z negation undone: what a normal map holds, in [-1, 1]),
    albedos with their per-view scales, alphas)."""
    cams = ring_cameras(n_views, cam_radius, width, height, focal)
    normals, albedo, alphas = render_sphere_views(cams, radius=radius)
    rots = cams.rot_c2w.numpy().astype(np.float64)
    centers = (cams.origin.numpy().astype(np.float64) - 0.5) * world_scale \
        + np.asarray(world_center, np.float64)
    stored = normals * np.array([1.0, -1.0, -1.0])
    if albedo_scales is not None:
        albedo = np.stack([np.clip(albedo[i] * albedo_scales[i], 0, 1)
                           for i in range(n_views)])
    return rots, centers, stored, albedo, alphas


def write_idr_scene(out_dir, n_views: int = 8, width: int = 48,
                    height: int = 48, radius: float = 0.25,
                    cam_radius: float = 1.5, focal: float = 70.0,
                    world_center=(0.2, -0.1, 0.3), world_scale: float = 2.0,
                    albedo_scales=None):
    """Write the sphere as an IDR-style input directory, what the pipeline
    loads (`io/dataloaders.py:load_idr_scene`): cameras.npz (world_mat_i =
    K·[R | t] of each view, scale_mat_i = identity) with 16-bit RGB
    normal/ and albedo/ PNGs and 8-bit grey mask/ PNGs named 000.png, ….
    The world frame is the unit cube scaled by `world_scale` about the
    sphere's centre, which lands on `world_center`: the sphere's world
    radius is radius · world_scale. `albedo_scales` (one RGB factor per
    view) gives the views the unknown per-view albedo scale that albedo
    scaling estimates. Returns the world radius."""
    import os

    from ..io import image_io, png

    rots, centers, stored, albedo, alphas = _world_views(
        n_views, width, height, radius, cam_radius, focal, world_center,
        world_scale, albedo_scales)
    for sub in ("normal", "albedo", "mask"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    K = np.array([[focal, 0.0, width / 2.0, 0.0],
                  [0.0, focal, height / 2.0, 0.0],
                  [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
    mats = {}
    for i in range(n_views):
        name = f"{i:03d}.png"
        image_io.save_image((stored[i] + 1.0) / 2.0,
                            os.path.join(out_dir, "normal", name), 16)
        image_io.save_image(albedo[i], os.path.join(out_dir, "albedo", name),
                            16)
        png.write_png(os.path.join(out_dir, "mask", name),
                      (alphas[i] * 255).astype(np.uint8))
        w2c = np.eye(4)
        w2c[:3, :3] = rots[i].T
        w2c[:3, 3] = -rots[i].T @ centers[i]
        mats[f"world_mat_{i}"] = (K @ w2c).astype(np.float32)
        mats[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
    np.savez(os.path.join(out_dir, "cameras.npz"), **mats)
    return radius * world_scale


SFM_FORMATS = {"png": ("png", "png", "png"), "exr": ("exr", "tif", "jpg")}


def write_sfm_scene(out_dir, formats: str = "png", n_views: int = 8,
                    width: int = 48, height: int = 48, radius: float = 0.25,
                    cam_radius: float = 1.5, focal: float = 70.0,
                    world_center=(0.2, -0.1, 0.3), world_scale: float = 2.0,
                    albedo_scales=None):
    """Write the sphere as a Meshroom-style input, what the pipeline loads
    from AliceVision SfMData JSON (`io/dataloaders.py:load_sfm_scene`):
    normals.sfm.json and albedos.sfm.json (one intrinsic, a pose per view
    in AliceVision's frame, views naming their image files) and a masks/
    folder of files named by pose id. The world frame is
    `write_idr_scene`'s. formats "png": 16-bit PNG normals and albedos,
    8-bit PNG masks; "exr": float EXR normals in [-1, 1] (`save_exr`),
    16-bit TIFF albedos and 8-bit JPEG masks (`save_image`). Returns
    (normal SfM path, albedo SfM path, mask folder, world radius)."""
    import json
    import os

    from ..io import image_io

    n_fmt, a_fmt, m_fmt = SFM_FORMATS[formats]
    rots, centers, stored, albedo, alphas = _world_views(
        n_views, width, height, radius, cam_radius, focal, world_center,
        world_scale, albedo_scales)
    for sub in ("normals", "albedos", "masks"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
    flip = np.diag([1.0, -1.0, -1.0])     # the loader's AliceVision flip
    poses, normal_views, albedo_views = [], [], []
    for i in range(n_views):
        pid = str(1000 + i)
        n_path = os.path.join("normals", f"{i:03d}.{n_fmt}")
        a_path = os.path.join("albedos", f"{i:03d}.{a_fmt}")
        if n_fmt == "exr":
            image_io.save_exr(stored[i].astype(np.float32),
                              os.path.join(out_dir, n_path))
        else:
            image_io.save_image((stored[i] + 1.0) / 2.0,
                                os.path.join(out_dir, n_path), 16)
        image_io.save_image(albedo[i], os.path.join(out_dir, a_path), 16)
        image_io.save_image(alphas[i], os.path.join(
            out_dir, "masks", f"{pid}.{m_fmt}"), 8)
        poses.append({"poseId": pid, "pose": {"transform": {
            "rotation": [repr(float(v)) for v in (flip @ rots[i]).ravel()],
            "center": [repr(float(v)) for v in flip @ centers[i]]}}})
        for views, path in ((normal_views, n_path), (albedo_views, a_path)):
            views.append({"viewId": str(i), "poseId": pid,
                          "intrinsicId": "0", "path": path})
    intr = [{"intrinsicId": "0", "width": width, "height": height,
             "pxFocalLength": [repr(float(focal))] * 2,
             "principalPoint": ["0", "0"]}]
    paths = []
    for name, views in (("normals", normal_views), ("albedos", albedo_views)):
        path = os.path.join(out_dir, f"{name}.sfm.json")
        with open(path, "w") as f:
            json.dump({"intrinsics": intr, "poses": poses, "views": views},
                      f)
        paths.append(path)
    return paths[0], paths[1], os.path.join(out_dir, "masks"), \
        radius * world_scale


# ---------------------------------------------------------------------------
# Composite analytic scene (sphere ∪ torus ∪ rounded box)
# ---------------------------------------------------------------------------
# A stand-in for the reference's multi-object validation scenes
# (DiLiGenT-MV-style: ring views, per-view normal+albedo maps, masks).
# Analytic SDF → exact GT surface for Chamfer-L1 (mesh/metrics.py).


def composite_sdf(p: np.ndarray) -> np.ndarray:
    """(..., 3) → (...) SDF of the union scene, exact enough for GT use."""
    p = np.asarray(p, np.float32)
    # sphere
    d1 = np.linalg.norm(p - np.array([0.50, 0.54, 0.56], np.float32),
                        axis=-1) - 0.14
    # torus, axis = z, centered slightly low
    q = p - np.array([0.50, 0.46, 0.40], np.float32)
    qxy = np.linalg.norm(q[..., :2], axis=-1) - 0.17
    d2 = np.sqrt(qxy * qxy + q[..., 2] * q[..., 2]) - 0.055
    # rounded box
    b = np.abs(p - np.array([0.52, 0.62, 0.40], np.float32)) \
        - np.array([0.10, 0.055, 0.045], np.float32)
    d3 = (np.linalg.norm(np.maximum(b, 0.0), axis=-1)
          + np.minimum(np.max(b, axis=-1), 0.0)) - 0.02
    return np.minimum(np.minimum(d1, d2), d3)


def composite_normal(p: np.ndarray, eps: float = 1e-4) -> np.ndarray:
    """Central-difference normal of composite_sdf, normalized."""
    p = np.asarray(p, np.float32)
    g = np.stack([
        composite_sdf(p + np.eye(3, dtype=np.float32)[d] * eps)
        - composite_sdf(p - np.eye(3, dtype=np.float32)[d] * eps)
        for d in range(3)], axis=-1)
    return g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-12)


def composite_albedo(p: np.ndarray) -> np.ndarray:
    """Smoothly varying per-component albedo (texture for the RGB loss)."""
    p = np.asarray(p, np.float32)
    base = np.stack([
        0.55 + 0.25 * np.sin(14.0 * p[..., 0]),
        0.45 + 0.25 * np.sin(11.0 * p[..., 1] + 1.3),
        0.50 + 0.30 * np.sin(9.0 * p[..., 2] + 2.1)], axis=-1)
    return np.clip(base, 0.05, 1.0).astype(np.float32)


def composite_norm(sphere_scale: float = 1.0):
    """Unit-sphere normalization of the composite scene, the reference's
    `compute_unit_sphere_scaling` (rnb_neus2/scaling.py:9-34) on the GT
    surface points: centroid, 99th-percentile outlier rejection, the
    inliers' mean as centre, scale so the largest distance is
    `sphere_scale`. Returns (center (3,), k) in unit-cube terms: the
    normalized scene is p_v2 = (p_v1 − center)·k + 0.5 with k =
    0.5·sphere_scale / max_dist, so the surface fills the radius-0.5 ball
    of the unit cube as every scene the reference trains does."""
    V, _ = composite_gt_mesh(96)
    centroid = V.mean(0)
    d = np.linalg.norm(V - centroid, axis=1)
    inl = V[d <= np.percentile(d, 99)]
    c = inl.mean(0)
    max_dist = float(np.max(np.linalg.norm(inl - c, axis=1)))
    return c.astype(np.float32), 0.5 * sphere_scale / max_dist


def composite_sdf_v2(p: np.ndarray, norm) -> np.ndarray:
    """SDF of the unit-sphere-normalized scene (exact under uniform
    scaling: d_v2(p) = k·d_v1(center + (p−0.5)/k))."""
    c, k = norm
    return composite_sdf(c + (np.asarray(p, np.float32) - 0.5) / k) * k


def render_composite_views(cams: Cameras, max_iters: int = 96,
                           norm=None, t_max: float = None):
    """Sphere-traced analytic render → (normals_cam, albedo, alphas).

    norm=(center, k) renders the normalized scene (composite_norm); the
    albedo is evaluated at the original scene point, so the texture is the
    same at every scaling."""
    W, H = cams.resolution
    n_views = cams.rot_c2w.shape[0]
    rots = cams.rot_c2w.cpu().numpy()
    origins = cams.origin.cpu().numpy()
    focal = cams.focal.cpu().numpy()
    pp = cams.principal.cpu().numpy()
    u = (np.arange(W) + 0.5) / W
    v = (np.arange(H) + 0.5) / H
    uu, vv = np.meshgrid(u, v)
    if t_max is None:
        t_max = 3.0 if norm is None else float(
            np.max(np.linalg.norm(origins - 0.5, axis=-1)) + 1.0)
    if norm is None:
        sdf_fn = composite_sdf
        unmap = lambda p: p
    else:
        c, k = norm
        sdf_fn = lambda p: composite_sdf_v2(p, norm)
        unmap = lambda p: c + (p - 0.5) / k

    normals = np.zeros((n_views, H, W, 3), np.float32)
    albedo = np.zeros((n_views, H, W, 3), np.float32)
    alphas = np.zeros((n_views, H, W), np.float32)
    for i in range(n_views):
        d_cam = np.stack([
            (uu - pp[i, 0]) * W / focal[i, 0],
            (vv - pp[i, 1]) * H / focal[i, 1],
            np.ones_like(uu)], axis=-1)
        d = d_cam @ rots[i].T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        d = d.reshape(-1, 3)
        o = origins[i][None, :]
        t = np.full((d.shape[0],), 0.05, np.float32)
        alive = np.ones_like(t, bool)
        for _ in range(max_iters):
            s = sdf_fn(o + t[:, None] * d)
            hit_now = s < 5e-5
            t = np.where(alive & ~hit_now, t + np.maximum(s, 1e-4), t)
            alive &= t < t_max
        s = sdf_fn(o + t[:, None] * d)
        hit = (s < 2e-3) & (t < t_max)
        p = o + t[:, None] * d
        n_world = composite_normal(unmap(p))
        n_cam = np.einsum("nd,dk->nk", n_world, rots[i])
        normals[i] = np.where(hit[:, None], n_cam,
                              np.array([-1.0, 1.0, 1.0]) / np.sqrt(3.0)
                              ).reshape(H, W, 3)
        albedo[i] = (composite_albedo(unmap(p)) * hit[:, None]
                     ).reshape(H, W, 3)
        alphas[i] = hit.astype(np.float32).reshape(H, W)
    return normals, albedo, alphas


def composite_dataset(n_views: int = 20, width: int = 512, height: int = 612,
                      cam_radius: float = 1.6, focal: float = 900.0,
                      device="cpu") -> TrainingDataset:
    cams = ring_cameras(n_views, cam_radius, width, height, focal,
                        device=device)
    normals, albedo, alphas = render_composite_views(cams)
    return build_dataset(cams, normals, albedo, alphas, alphas, SceneMeta())


def composite_gt_mesh(resolution: int = 384):
    """GT mesh of the analytic scene via table marching cubes, unit-cube
    coordinates."""
    ax = np.linspace(0.0, 1.0, resolution + 1, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    vol = composite_sdf(np.stack([X, Y, Z], axis=-1))
    return marching_cubes_grid(-vol, (0.0, 0.0, 0.0), 1.0 / resolution, 0.0)


# v2 camera defaults: the ring radius of the v1 cameras after the
# unit-sphere scaling (1.6·k ≈ 3.4), and a focal at which the radius-0.5
# object spans ~90% of the image half-width (DiLiGenT-MV-style framing)
COMPOSITE_V2_CAM_RADIUS = 3.4
COMPOSITE_V2_FOCAL = 1550.0


def composite_dataset_v2(n_views: int = 20, width: int = 512,
                         height: int = 612,
                         cam_radius: float = COMPOSITE_V2_CAM_RADIUS,
                         focal: float = COMPOSITE_V2_FOCAL,
                         sphere_scale: float = 1.0,
                         device="cpu") -> TrainingDataset:
    """The unit-sphere-normalized composite scene (composite_norm): world
    scale and framing as the reference's prep (scaling.py) and a
    DiLiGenT-style capture hand the testbed."""
    norm = composite_norm(sphere_scale)
    cams = ring_cameras(n_views, cam_radius, width, height, focal,
                        device=device)
    normals, albedo, alphas = render_composite_views(cams, 128, norm)
    return build_dataset(cams, normals, albedo, alphas, alphas, SceneMeta())


def composite_gt_mesh_v2(resolution: int = 384, sphere_scale: float = 1.0):
    """GT mesh of the normalized scene, unit-cube coordinates."""
    norm = composite_norm(sphere_scale)
    ax = np.linspace(0.0, 1.0, resolution + 1, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    vol = composite_sdf_v2(np.stack([X, Y, Z], axis=-1), norm)
    return marching_cubes_grid(-vol, (0.0, 0.0, 0.0), 1.0 / resolution, 0.0)


def write_prepared_composite_scene(out_dir, n_views: int = 20,
                                   width: int = 512, height: int = 612,
                                   cam_radius: float = 1.6,
                                   focal: float = 900.0,
                                   normalized: bool = False,
                                   sphere_scale: float = 1.0):
    """The composite scene as a prepared directory (transform.json +
    16-bit RGBA normal and albedo PNGs), the input of the reference's
    stage-1 testbed. normalized=True applies the unit-sphere scaling and
    the v2 framing (composite_norm, composite_dataset_v2)."""
    norm = None
    if normalized:
        norm = composite_norm(sphere_scale)
        if cam_radius == 1.6:
            cam_radius = COMPOSITE_V2_CAM_RADIUS
        if focal == 900.0:
            focal = COMPOSITE_V2_FOCAL
    cams = ring_cameras(n_views, cam_radius, width, height, focal)
    normals, albedo, alphas = render_composite_views(cams, 128, norm)
    return _write_prepared(out_dir, cams, normals, albedo, alphas, focal)


def icosphere(radius: float = 1.0, center=(0, 0, 0), subdiv: int = 3):
    """A subdivided octahedron projected onto the sphere: (V (n, 3)
    float32, F (m, 3) int64), the JAX package's test mesh."""
    V = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                  [0, 0, 1], [0, 0, -1]], np.float64)
    F = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])
    for _ in range(subdiv):
        edge_mid = {}
        newF = []
        Vl = list(V)

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = V[a] + V[b]
                edge_mid[key] = len(Vl)
                Vl.append(m / np.linalg.norm(m))
            return edge_mid[key]

        for a, b, c in F:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            newF += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        V = np.array([v / np.linalg.norm(v) for v in Vl])
        F = np.array(newF)
    return ((V * radius + np.asarray(center)).astype(np.float32),
            F.astype(np.int64))
