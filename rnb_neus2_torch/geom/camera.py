"""Camera model and ray generation (port of `rnb_neus2_tpu/geom/camera.py`).

Conventions follow the prepared-dataset contract (transform.json with
from_na=true): OpenCV-style pinhole — x right, y down, z forward.
Ray directions are built from normalized pixel coordinates
(testbed_nerf.cu:1285-1296): d_cam = ((u−cx)·W/fx, (v−cy)·H/fy, 1), rotated
by R_c2w and normalized.

Lens distortion is applied where the reference applies it
(testbed_nerf.cu:1282-1300): F-theta replaces the pinhole back-projection;
the OpenCV model Newton-undistorts the normalized plane coordinates
(`geom/distortion.py`). With neither, the cameras are ideal pinholes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .distortion import f_theta_undistortion, iterative_undistortion


class Cameras(NamedTuple):
    """Per-view pinhole cameras. All tensors share leading dim N."""

    rot_c2w: torch.Tensor     # (N, 3, 3)
    origin: torch.Tensor      # (N, 3) camera center in unit-cube space
    focal: torch.Tensor       # (N, 2) fx, fy in pixels
    principal: torch.Tensor   # (N, 2) cx, cy normalized to [0,1]
    resolution: Tuple[int, int]  # (W, H), shared by all views
    # OpenCV lens distortion [k1, k2, p1, p2] per view (transform.json's
    # top-level k1/k2/p1/p2, nerf_loader.cu:432-465), or None
    distortion: Optional[torch.Tensor] = None   # (N, 4)
    # F-theta fisheye [p0..p4, width, height] shared by all views
    # (nerf_loader.cu ftheta_p0..p4), or None
    ftheta: Optional[torch.Tensor] = None       # (7,)

    def to(self, device) -> "Cameras":
        move = lambda t: None if t is None else t.to(device)
        return Cameras(self.rot_c2w.to(device), self.origin.to(device),
                       self.focal.to(device), self.principal.to(device),
                       self.resolution, move(self.distortion),
                       move(self.ftheta))


def rays_from_pixels(cams: Cameras, img_idx: torch.Tensor,
                     xy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """img_idx: (R,), xy: (R,2) normalized image coords in [0,1).

    Returns (origins, unit directions), each (R, 3)."""
    W, H = cams.resolution
    rot = cams.rot_c2w[img_idx]                       # (R,3,3)
    o = cams.origin[img_idx]
    pp = cams.principal[img_idx]
    if cams.ftheta is not None:
        d_cam = f_theta_undistortion(xy - pp, cams.ftheta,
                                     error_direction=(0.0, 0.0, 1.0))
    else:
        f = cams.focal[img_idx]
        x = (xy[:, 0] - pp[:, 0]) * W / f[:, 0]
        y = (xy[:, 1] - pp[:, 1]) * H / f[:, 1]
        if cams.distortion is not None:
            x, y = iterative_undistortion(cams.distortion[img_idx], x, y)
        d_cam = torch.stack([x, y, torch.ones_like(x)], dim=1)
    d = torch.einsum("rij,rj->ri", rot, d_cam)
    return o, d / torch.linalg.norm(d, dim=1, keepdim=True)


def ray_aabb(o: torch.Tensor, d: torch.Tensor, lo: float = 0.0,
             hi: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slab intersection with the axis-aligned cube [lo,hi]³
    (bounding_box.cuh ray_intersect). Returns (tmin, tmax); empty if
    tmin > tmax."""
    inv = 1.0 / d
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    return tmin, tmax
