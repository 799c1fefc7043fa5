"""Input dataloaders (port of `rnb_neus2_tpu/io/dataloaders.py`): IDR
cameras.npz, AliceVision SfMData as JSON, SfMData through the
pyalicevision bindings (`.sfm` and the binary `.abc`), and the
auto-detecting factory.

Standardized output contract (reference: rnb_neus2/dataloaders/base.py:3-22):

    {"views": [{"c2w" (4,4), "K" (4,4), "normal_path", "albedo_path",
                "mask_path", "pose_id"}...],
     "landmarks": (N,3) or None, "image_width", "image_height",
     "scale_mat": (4,4) or None}

Conventions reproduced:
- IDR: P = (world_mat @ scale_mat)[:3,:4], decomposed as
  cv2.decomposeProjectionMatrix decomposes it (an RQ decomposition, see
  `decompose_projection`); pose = [Rᵀ | camera centre]
  (rnb_loader.py:20-35, 79-101); image filenames by digit-count
  autodetection (:65-66).
- AliceVision: world correction diag(1,−1,−1) applied to rotations,
  centers and landmarks (sfm_json_loader.py:16, 84-85); focal from
  pxFocalLength (scalar or [fx,fy]) or focalLength(mm)·W/sensorWidth;
  principal point = image center + stored offset (:58-75); per-pose
  albedo/mask matching with a mask-folder fallback (:144-199). The
  pyalicevision loader (sfm_pyav_loader.py) applies the same flip and
  matching to the bindings' objects; the bindings are imported only when
  a `.sfm` or `.abc` file is loaded.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Optional

import numpy as np

from scipy.linalg import rq

from . import image_io

_ALICEVISION_FLIP = np.diag([1.0, -1.0, -1.0])


# ---------------------------------------------------------------------------
# IDR / cameras.npz
# ---------------------------------------------------------------------------

def decompose_projection(P: np.ndarray):
    """P (3,4) → (K (4,4), c2w (4,4)), as cv2.decomposeProjectionMatrix
    decomposes it: P[:, :3] = K·R by RQ decomposition with K[0,0] and
    K[1,1] positive and R a rotation (so K[2,2] < 0 when det P[:, :3] < 0),
    K then divided by K[2,2]; the camera centre solves P·[c, 1] = 0."""
    P = np.asarray(P, np.float64)
    K, R = rq(P[:, :3])
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1.0
    K, R = K * signs, signs[:, None] * R
    if np.linalg.det(R) < 0:
        K[:, 2] *= -1.0
        R[2] *= -1.0
    K = K / K[2, 2]
    intr = np.eye(4)
    intr[:3, :3] = K
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = R.T
    c2w[:3, 3] = -np.linalg.solve(P[:, :3], P[:, 3])
    return intr, c2w


def load_idr_scene(data_dir: str) -> dict:
    """Directory with cameras.npz + normal/ [albedo/] [mask/] folders."""
    npz = os.path.join(data_dir, "cameras.npz")
    if not os.path.exists(npz):
        raise FileNotFoundError(f"cameras.npz not found in {data_dir}")
    cams = np.load(npz)
    n_images = 1 + max(int(k.rsplit("_", 1)[-1]) for k in cams.keys())

    normal_dir = os.path.join(data_dir, "normal")
    if not os.path.isdir(normal_dir):
        raise FileNotFoundError(f"normal/ folder not found in {data_dir}")
    first = sorted(os.listdir(normal_dir))[0]
    n_digits = len(os.path.splitext(first)[0])
    H, W = image_io.color_shape(os.path.join(normal_dir, first))

    albedo_dir = os.path.join(data_dir, "albedo")
    mask_dir = os.path.join(data_dir, "mask")
    has_albedo = os.path.isdir(albedo_dir)

    views = []
    for i in range(n_images):
        world = cams[f"world_mat_{i}"].astype(np.float32)
        scale = cams[f"scale_mat_{i}"].astype(np.float32)
        K, c2w = decompose_projection((world @ scale)[:3, :4])
        name = f"{i:0{n_digits}d}.png"
        mask_path = os.path.join(mask_dir, name)
        views.append({
            "c2w": c2w,
            "K": K.astype(np.float32),
            "normal_path": os.path.join(normal_dir, name),
            "albedo_path": os.path.join(albedo_dir, name)
            if has_albedo else None,
            "mask_path": mask_path if os.path.exists(mask_path) else None,
            "pose_id": str(i),
        })
    return {"views": views, "landmarks": None, "image_width": W,
            "image_height": H,
            "scale_mat": cams["scale_mat_0"].astype(np.float32)}


# ---------------------------------------------------------------------------
# AliceVision SfMData (pure JSON)
# ---------------------------------------------------------------------------

def _sfm_intrinsics(intr: dict):
    W, H = int(intr["width"]), int(intr["height"])
    if "pxFocalLength" in intr:
        pxf = intr["pxFocalLength"]
        fx, fy = (float(pxf[0]), float(pxf[1])) if isinstance(pxf, list) \
            else (float(pxf), float(pxf))
    else:
        mm = float(intr["focalLength"])
        sensor = float(intr.get("sensorWidth", 36.0))
        if "sensorWidth" not in intr:
            warnings.warn("sensorWidth missing; assuming 36.0mm")
        fx = fy = mm * W / sensor
    pp = intr.get("principalPoint", ["0", "0"])
    return fx, fy, W / 2.0 + float(pp[0]), H / 2.0 + float(pp[1]), W, H


def parse_sfm_json(data: dict, sfm_dir: Optional[str] = None):
    """SfMData dict → (camera list, landmarks)."""
    intrinsics = {i["intrinsicId"]: i for i in data.get("intrinsics", [])}
    poses = {p["poseId"]: p["pose"]["transform"]
             for p in data.get("poses", [])}

    def resolve(p):
        if not p or os.path.isabs(p) or sfm_dir is None:
            return p
        return os.path.join(sfm_dir, p)

    out = []
    for view in data.get("views", []):
        iid, pid = view["intrinsicId"], view["poseId"]
        if iid not in intrinsics or pid not in poses:
            continue
        fx, fy, cx, cy, W, H = _sfm_intrinsics(intrinsics[iid])
        tf = poses[pid]
        R = np.array([float(v) for v in tf["rotation"]]).reshape(3, 3)
        c = np.array([float(v) for v in tf["center"]])
        out.append({
            "view_id": view["viewId"], "pose_id": pid,
            "image_path": resolve(view.get("path", "")),
            "R_cam2world": _ALICEVISION_FLIP @ R,
            "center": _ALICEVISION_FLIP @ c,
            "fx": fx, "fy": fy, "cx": cx, "cy": cy,
            "width": W, "height": H,
        })

    landmarks = None
    pts = [[float(v) for v in s["X"]] for s in data.get("structure", [])
           if s.get("X") is not None]
    if pts:
        landmarks = (np.asarray(pts) @ _ALICEVISION_FLIP.T)
    return out, landmarks


def _find_mask_in_folder(folder: str, pose_id: str) -> Optional[str]:
    for ext in (".png", ".jpg", ".jpeg", ".exr"):
        cand = os.path.join(folder, pose_id + ext)
        if os.path.exists(cand):
            return cand
    return None


def load_sfm_scene(sfm_path: str, albedo_sfm_path: str = "",
                   mask_sfm_path: str = "",
                   mask_folder_path: str = "") -> dict:
    def parse_file(path):
        with open(path) as f:
            return parse_sfm_json(json.load(f),
                                  os.path.dirname(os.path.abspath(path)))

    normal_cams, landmarks = parse_file(sfm_path)
    if not normal_cams:
        raise RuntimeError(f"No valid views in {sfm_path}")

    by_pose = {}
    for key, path in [("albedo", albedo_sfm_path), ("mask", mask_sfm_path)]:
        if path and os.path.exists(path):
            cams, _ = parse_file(path)
            by_pose[key] = {c["pose_id"]: c["image_path"] for c in cams}
        else:
            by_pose[key] = {}

    views = []
    for cam in normal_cams:
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = cam["R_cam2world"]
        c2w[:3, 3] = cam["center"]
        K = np.eye(4, dtype=np.float32)
        K[0, 0], K[1, 1] = cam["fx"], cam["fy"]
        K[0, 2], K[1, 2] = cam["cx"], cam["cy"]
        pid = cam["pose_id"]
        mask_path = by_pose["mask"].get(pid)
        if mask_path is None and mask_folder_path \
                and os.path.isdir(mask_folder_path):
            mask_path = _find_mask_in_folder(mask_folder_path, pid)
        views.append({
            "c2w": c2w, "K": K,
            "normal_path": cam["image_path"],
            "albedo_path": by_pose["albedo"].get(pid),
            "mask_path": mask_path,
            "pose_id": pid,
        })
    first = normal_cams[0]
    return {"views": views, "landmarks": landmarks,
            "image_width": first["width"], "image_height": first["height"],
            "scale_mat": None}


# ---------------------------------------------------------------------------
# AliceVision SfMData through pyalicevision
# ---------------------------------------------------------------------------

def _pyav_intrinsic_K(intrinsic, camera_mod, numeric_mod) -> np.ndarray:
    """4×4 K from a pyalicevision intrinsic: the Pinhole cast's focal and
    principal-point accessors, the raw scale where the focal accessors are
    missing, scale and offset for a non-pinhole intrinsic (reference
    sfm_pyav_loader.py:22-46)."""
    K = np.eye(4, dtype=np.float32)
    cam = camera_mod.Pinhole.cast(intrinsic)
    if cam is not None:
        try:
            K[0, 0] = cam.getFocalLengthPixX()
            K[1, 1] = cam.getFocalLengthPixY()
        except AttributeError:
            s = intrinsic.getScale()
            K[0, 0], K[1, 1] = s.x(), s.y()
        pp = cam.getPrincipalPoint()
        K[0, 2] = numeric_mod.getX(pp)
        K[1, 2] = numeric_mod.getY(pp)
    else:
        s = intrinsic.getScale()
        o = intrinsic.getOffset()
        K[0, 0], K[1, 1] = s.x(), s.y()
        K[0, 2], K[1, 2] = o.x(), o.y()
    return K


def _pyav_load_sfm(sfm_io, sfm_data_mod, path: str, required: bool,
                   logger=None):
    """One SfMData file; None where an optional one is absent or does not
    load (reference sfm_pyav_loader.py:77-110)."""
    if not required and (not path or not os.path.exists(path)):
        return None
    data = sfm_data_mod.SfMData()
    if not sfm_io.load(data, path, sfm_io.ALL):
        if required:
            raise RuntimeError(f"Failed to load SfMData: {path}")
        if logger:
            logger.info(f"Failed to load optional SfMData {path}")
        return None
    return data


def load_sfm_scene_pyav(sfm_path: str, albedo_sfm_path: str = "",
                        mask_sfm_path: str = "",
                        mask_folder_path: str = "", logger=None) -> dict:
    """The loader contract from pyalicevision's SfMData (reference
    sfm_pyav_loader.py): the views whose viewId is their poseId, c2w with
    the Y/Z flip, Pinhole intrinsics (`_pyav_intrinsic_K`), flipped
    landmarks, albedo and mask matched by pose with the mask-folder
    fallback. ImportError propagates, so that `load_data` parses a `.sfm`
    as JSON where the bindings are absent."""
    from pyalicevision import (camera, numeric, sfmData as sfm_data_mod,
                               sfmDataIO)

    flip4 = np.diag([1.0, -1.0, -1.0, 1.0]).astype(np.float32)
    normal_sfm = _pyav_load_sfm(sfmDataIO, sfm_data_mod, sfm_path, True,
                                logger)
    albedo_sfm = _pyav_load_sfm(sfmDataIO, sfm_data_mod, albedo_sfm_path,
                                False, logger)
    mask_sfm = _pyav_load_sfm(sfmDataIO, sfm_data_mod, mask_sfm_path,
                              False, logger)

    all_views = normal_sfm.getViews()
    if not len(all_views):
        raise RuntimeError(f"No views in SfMData {sfm_path}")

    lms = normal_sfm.getLandmarks()
    landmarks = None
    if len(lms):
        pts = np.array([[lms[k].X[0], lms[k].X[1], lms[k].X[2]]
                        for k in lms.keys()], np.float32)
        landmarks = pts * np.array([1, -1, -1], np.float32)

    albedo_views = albedo_sfm.getViews() if albedo_sfm is not None else {}
    mask_views = mask_sfm.getViews() if mask_sfm is not None else {}

    def find_mask(pose_id):
        if pose_id in mask_views:
            p = mask_views[pose_id].getImage().getImagePath()
            if os.path.exists(p):
                return p
        if mask_folder_path and os.path.isdir(mask_folder_path):
            return _find_mask_in_folder(mask_folder_path, str(pose_id))
        return None

    views, W, H = [], None, None
    for pose_id in sorted(v for v in all_views.keys()
                          if v == all_views[v].getPoseId()):
        view = all_views[pose_id]
        if not normal_sfm.isPoseAndIntrinsicDefined(pose_id):
            continue
        tf = normal_sfm.getPose(view).getTransform()
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = np.asarray(tf.rotation(), np.float32).T
        c2w[:3, 3] = np.asarray(tf.center(), np.float32).squeeze()
        c2w = flip4 @ c2w
        intr = normal_sfm.getIntrinsics()[view.getIntrinsicId()]
        K = _pyav_intrinsic_K(intr, camera, numeric)
        img = view.getImage()
        if W is None:
            W, H = img.getWidth(), img.getHeight()
        albedo_path = None
        if pose_id in albedo_views:
            albedo_path = albedo_views[pose_id].getImage().getImagePath()
        views.append({
            "c2w": c2w, "K": K,
            "normal_path": img.getImagePath(),
            "albedo_path": albedo_path,
            "mask_path": find_mask(pose_id),
            "pose_id": str(pose_id),
        })
    if not views:
        raise RuntimeError("No valid views could be loaded")
    if logger:
        logger.info(f"Loaded {len(views)} views via pyalicevision")
    return {"views": views, "landmarks": landmarks,
            "image_width": W, "image_height": H, "scale_mat": None}


# ---------------------------------------------------------------------------
# factory
# ---------------------------------------------------------------------------

def load_data(input_path: str, albedo_sfm_path: str = "",
              mask_sfm_path: str = "", mask_folder_path: str = "",
              logger=None) -> dict:
    """Auto-detect the input format and load (reference
    dataloaders/__init__.py:28-79): a `.sfm` or `.abc` file through
    pyalicevision where the bindings import, a `.sfm` as JSON where they
    do not."""
    if os.path.isdir(input_path):
        if os.path.exists(os.path.join(input_path, "cameras.npz")):
            return load_idr_scene(input_path)
        raise FileNotFoundError(
            f"No cameras.npz found in {input_path}. "
            "Provide a .sfm or .json file instead.")

    ext = os.path.splitext(input_path)[1].lower()
    if ext == ".npz":
        return load_idr_scene(os.path.dirname(input_path))
    if ext in (".sfm", ".abc"):
        try:
            return load_sfm_scene_pyav(
                input_path, albedo_sfm_path=albedo_sfm_path,
                mask_sfm_path=mask_sfm_path,
                mask_folder_path=mask_folder_path)
        except ImportError:
            pass
    if ext in (".json", ".sfm"):
        return load_sfm_scene(input_path, albedo_sfm_path, mask_sfm_path,
                              mask_folder_path)
    raise ValueError(
        f"Unsupported input format: {ext}. Supported: directory with "
        "cameras.npz, .npz, .sfm, .abc, .json")
