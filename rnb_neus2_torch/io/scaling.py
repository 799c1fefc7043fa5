"""Scene normalization: fit the object into the unit sphere (port of
`rnb_neus2_tpu/io/scaling.py`; the mask contours are traced in numpy in
place of cv2's findContours and the hull is scipy's).

Same estimator family as the reference (rnb_neus2/scaling.py), highest
priority first (prepare.py:44-113):

1. silhouettes_v2: minimum enclosing sphere whose projection covers every
   mask contour point with a pixel margin; center optimized by Nelder-Mead
   seeded at the least-squares triangulation of mask centers of mass
   (scaling.py:145-253);
2. silhouettes (v1, MVSCPS): center by COM-ray triangulation, radius by
   projected-area matching r = √(1.5·A_fg / (π·Σ(f/Z)²)) (scaling.py:37-103);
3. landmarks / camera centers: 99th-percentile outlier-rejected bounding
   sphere (scaling.py:9-34).

All return (scene_center, scale_factor[, scale_matrix]) with
scale_matrix = diag(s)·[I | −center] in homogeneous form.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from . import image_io
from .errors import UnreadableImage


def read_mask(path) -> np.ndarray:
    """A mask file as binary float64: the channel that
    `cv2.imread(IMREAD_UNCHANGED)[:, :, 0]` gives (grey, or blue: index 2
    of the port's RGB(A)) above 0.5 for float samples, 125 for 8 bits,
    30000 for 16 (scaling.py:256-305)."""
    img = image_io.read_raw(path)
    if img.ndim == 3:
        img = img[:, :, 2]
    if img.dtype == np.float32:
        return (img > 0.5).astype(np.float64)
    thr = 125 if img.dtype == np.uint8 else 30000
    return np.where(img > thr, 1.0, 0.0)


def scale_matrix_from(center: np.ndarray, scale: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] *= scale
    m[:3, 3] = -np.asarray(center) * scale
    return m


def unit_sphere_from_points(points: np.ndarray, sphere_scale: float = 1.0):
    """99th-percentile outlier-rejected bounding sphere (scaling.py:9-34)."""
    points = np.asarray(points, np.float64)
    centroid = points.mean(axis=0)
    dist = np.linalg.norm(points - centroid, axis=1)
    inliers = points[dist <= np.percentile(dist, 99)]
    center = inliers.mean(axis=0)
    max_dist = np.linalg.norm(inliers - center, axis=1).max()
    scale = sphere_scale / max_dist
    return center, float(scale), scale_matrix_from(center, scale)


def _mask_com(mask: np.ndarray) -> Optional[np.ndarray]:
    """Center of mass in (x, y) pixel coords."""
    from scipy.ndimage import center_of_mass

    com = center_of_mass(np.asarray(mask, np.float64))
    if np.any(np.isnan(com)):
        return None
    return np.array([com[1], com[0]])


def _triangulate_center(cameras: List[dict], masks: List[np.ndarray]):
    """Least-squares intersection of the COM viewing rays."""
    A = np.zeros((3, 3))
    b = np.zeros(3)
    for cam, mask in zip(cameras, masks):
        com = _mask_com(mask)
        if com is None:
            continue
        Kinv = np.linalg.inv(np.array([[cam["fx"], 0, cam["cx"]],
                                       [0, cam["fy"], cam["cy"]],
                                       [0, 0, 1.0]]))
        d = Kinv @ np.array([com[0], com[1], 1.0])
        n = np.linalg.norm(d)
        if n < 1e-12:
            continue
        m = cam["R_cam2world"] @ (d / n)
        proj = np.eye(3) - np.outer(m, m)
        A += proj
        b += proj @ cam["center"]
    try:
        return np.linalg.lstsq(A, b, rcond=None)[0]
    except np.linalg.LinAlgError:
        return np.mean([c["center"] for c in cameras], axis=0)


def silhouette_scaling(cameras: List[dict], masks: List[np.ndarray],
                       sphere_scale: float = 1.0,
                       fg_area_ratio: float = 1.5):
    """v1: projected-area radius matching (scaling.py:37-103)."""
    center = _triangulate_center(cameras, masks)
    total_area = sum(float(np.asarray(m).sum()) for m in masks)
    sum_fz2 = 0.0
    for cam, mask in zip(cameras, masks):
        z = (cam["R_cam2world"].T @ (center - cam["center"]))[2]
        z = z if abs(z) >= 1e-8 else 1e-8
        sum_fz2 += (cam["fx"] / z) ** 2
    radius = np.sqrt(fg_area_ratio * total_area / (np.pi * sum_fz2))
    if radius < 1e-8:
        radius = 1.0
    return center, float(sphere_scale / radius)


# the 8 neighbours of a pixel, counterclockwise on screen from east, as
# (row, col) steps
_DIRS = ((0, 1), (-1, 1), (-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0),
         (1, 1))


def _follow_border(img: np.ndarray, start) -> List[tuple]:
    """The outer border through `start` (the raster-first pixel of its
    component, whose west neighbour is background), by the border
    following of Suzuki & Abe (1985), steps 3.1-3.5, as cv2.findContours
    runs it: every visit of the closed walk, so a pixel the border passes
    twice (a one-pixel spur or bridge) comes twice."""
    def at(p, d):
        return p[0] + _DIRS[d][0], p[1] + _DIRS[d][1]

    for k in range(8):              # 3.1: clockwise from the west
        d = (4 - k) % 8
        if img[at(start, d)]:
            first = at(start, d)
            break
    else:
        return [start]              # an isolated pixel
    prev, cur = first, start
    pts = []
    while True:
        pts.append(cur)
        back = _DIRS.index((prev[0] - cur[0], prev[1] - cur[1]))
        for k in range(1, 9):       # 3.3: counterclockwise after prev
            nxt = at(cur, (back + k) % 8)
            if img[nxt]:
                break
        if nxt == start and cur == first:
            return pts
        prev, cur = cur, nxt


def outer_border_points(mask: np.ndarray) -> np.ndarray:
    """(N, 2) float64 (x, y): the points of cv2.findContours(mask,
    RETR_EXTERNAL, CHAIN_APPROX_NONE), stacked. An external component is
    an 8-connected foreground component that touches the 4-connected
    background outside every component (the image is padded with
    background, as cv2 pads it); components inside another's hole, and
    hole borders, are not traced."""
    from scipy import ndimage

    img = np.pad(np.asarray(mask, bool), 1)
    background, _ = ndimage.label(~img)
    outside = background == background[0, 0]
    near = np.zeros_like(img)
    near[1:] |= outside[:-1]
    near[:-1] |= outside[1:]
    near[:, 1:] |= outside[:, :-1]
    near[:, :-1] |= outside[:, 1:]
    comps, _ = ndimage.label(img, structure=np.ones((3, 3), bool))
    external = np.unique(comps[img & near])
    labels, first = np.unique(comps.ravel(), return_index=True)
    starts = first[np.isin(labels, external)]
    pts = [p for s in starts
           for p in _follow_border(img, divmod(int(s), img.shape[1]))]
    return np.asarray(pts, np.float64).reshape(-1, 2)[:, ::-1] - 1.0


def _contour_points(mask: np.ndarray, percentile: float,
                    max_pts: int = 2000) -> Optional[np.ndarray]:
    from scipy.spatial import ConvexHull, QhullError

    pts = outer_border_points(np.asarray(mask) > 0.5)
    if len(pts) < 2:
        return None
    if percentile < 100:
        com = _mask_com(mask)
        if com is not None:
            d = np.linalg.norm(pts - com, axis=1)
            pts = pts[d <= np.percentile(d, percentile)]
            if len(pts) == 0:
                return None
    if len(pts) > max_pts:
        # convex hull vertices are the extremal points; keep them exactly
        try:
            hull = pts[ConvexHull(pts).vertices]
        except QhullError:
            hull = pts[:0]
        step = max(1, len(pts) // max(max_pts - len(hull), 1))
        pts = np.vstack([hull, pts[::step]]) if len(hull) else pts[::step]
    return pts


def silhouette_scaling_v2(cameras: List[dict], masks: List[np.ndarray],
                          sphere_scale: float = 1.0, margin_px: float = 20,
                          percentile: float = 99):
    """v2: Nelder-Mead minimum enclosing sphere (scaling.py:145-253)."""
    from scipy.optimize import minimize

    init = _triangulate_center(cameras, masks)
    views = []
    for cam, mask in zip(cameras, masks):
        pts = _contour_points(mask, percentile)
        if pts is None:
            continue
        R_w2c = cam["R_cam2world"].T
        views.append({
            "fx": cam["fx"], "fy": cam["fy"],
            "cx": cam["cx"], "cy": cam["cy"],
            "R_w2c": R_w2c, "t_w2c": -R_w2c @ cam["center"],
            "pts": pts,
        })
    if not views:
        return init, float(sphere_scale)

    def required_radius(c):
        worst = 0.0
        for v in views:
            p = v["R_w2c"] @ c + v["t_w2c"]
            z = p[2]
            if z <= 1e-6:
                return 1e12
            px = v["fx"] * p[0] / z + v["cx"]
            py = v["fy"] * p[1] / z + v["cy"]
            dx = (v["pts"][:, 0] - px) * z / v["fx"]
            dy = (v["pts"][:, 1] - py) * z / v["fy"]
            r = np.sqrt(dx * dx + dy * dy).max()
            worst = max(worst, r + margin_px * z / ((v["fx"] + v["fy"]) / 2))
        return worst

    res = minimize(required_radius, init, method="Nelder-Mead",
                   options={"maxiter": 5000, "xatol": 1e-4, "fatol": 1e-6})
    r = required_radius(res.x)
    return res.x.astype(np.float32), float(sphere_scale / r)


def cameras_for_silhouettes(data: dict) -> Tuple[List[dict],
                                                 List[np.ndarray]]:
    """Extract scaling-compatible camera dicts + binary masks from a loaded
    scene (scaling.py:256-305; `read_mask`)."""
    cameras, masks = [], []
    for view in data["views"]:
        path = view.get("mask_path")
        if not path or not os.path.exists(path):
            continue
        try:
            binary = read_mask(path).astype(np.float32)
        except UnreadableImage:     # cv2's None: the view is skipped
            continue
        c2w = view["c2w"]
        K = view["K"]
        cameras.append({
            "fx": float(K[0, 0]), "fy": float(K[1, 1]),
            "cx": float(K[0, 2]), "cy": float(K[1, 2]),
            "R_cam2world": c2w[:3, :3].astype(np.float64),
            "center": c2w[:3, 3].astype(np.float64),
        })
        masks.append(binary)
    return cameras, masks
