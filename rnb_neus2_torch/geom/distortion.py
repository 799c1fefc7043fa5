"""Camera lens distortion: the OpenCV radial/tangential model and the
F-theta fisheye (port of `rnb_neus2_tpu/geom/distortion.py`).

Reference: common_device.cuh — apply_camera_distortion (OpenCV k1..k4,
p1, p2), iterative_camera_undistortion (Newton with numeric central
differences, :162-199) and f_theta_undistortion (:231-244). As in the JAX
package, the Newton loop takes 10 iterations with the exact jacobian
(forward-mode derivatives of the residual along both axes).
"""

from __future__ import annotations

import torch
from torch.func import jvp


def apply_distortion(params: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """OpenCV model: params = [..., [k1, k2, p1, p2, (k3, k4)]]; returns
    (dx, dy) such that distorted = (x + dx, y + dy). The leading dims of
    params broadcast against x and y (per-ray parameters)."""
    k1, k2 = params[..., 0], params[..., 1]
    p1, p2 = params[..., 2], params[..., 3]
    k3 = params[..., 4] if params.shape[-1] > 4 else 0.0
    k4 = params[..., 5] if params.shape[-1] > 5 else 0.0
    x2, y2, xy = x * x, y * y, x * y
    r2 = x2 + y2
    radial = r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
    dx = x * radial + 2 * p1 * xy + p2 * (r2 + 2 * x2)
    dy = y * radial + 2 * p2 * xy + p1 * (r2 + 2 * y2)
    return dx, dy


def iterative_undistortion(params: torch.Tensor, u: torch.Tensor,
                           v: torch.Tensor, n_iters: int = 10):
    """Invert apply_distortion by Newton iteration (vectorized over rays)."""

    def residual(xy):
        dx, dy = apply_distortion(params, xy[..., 0], xy[..., 1])
        return torch.stack([xy[..., 0] + dx, xy[..., 1] + dy], dim=-1)

    x0 = torch.stack([u, v], dim=-1)
    x = x0
    e1 = torch.zeros_like(x0)
    e1[..., 0] = 1.0
    e2 = torch.zeros_like(x0)
    e2[..., 1] = 1.0
    for _ in range(n_iters):
        r, j1 = jvp(residual, (x,), (e1,))
        _, j2 = jvp(residual, (x,), (e2,))
        # solve the 2x2 system J·step = r − x0
        a, b = j1[..., 0], j2[..., 0]
        c, d = j1[..., 1], j2[..., 1]
        det = a * d - b * c
        det = torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)
        rx = r[..., 0] - x0[..., 0]
        ry = r[..., 1] - x0[..., 1]
        sx = (d * rx - b * ry) / det
        sy = (-c * rx + a * ry) / det
        x = x - torch.stack([sx, sy], dim=-1)
    return x[..., 0], x[..., 1]


def f_theta_undistortion(uv: torch.Tensor, params: torch.Tensor,
                         error_direction=(1000.0, 0.0, 0.0)):
    """F-theta fisheye: params = [r0..r4, resx, resy]; centred normalized
    coords → direction (common_device.cuh:231-244)."""
    xpix = uv[..., 0] * params[5]
    ypix = uv[..., 1] * params[6]
    norm = torch.sqrt(xpix * xpix + ypix * ypix)
    alpha = params[0] + norm * (params[1] + norm * (
        params[2] + norm * (params[3] + norm * params[4])))
    sin_a, cos_a = torch.sin(alpha), torch.cos(alpha)
    bad = (cos_a <= torch.finfo(torch.float32).tiny) | (norm == 0.0)
    s = sin_a / torch.where(norm == 0, torch.ones_like(norm), norm)
    dir_ = torch.stack([s * xpix, s * ypix, cos_a], dim=-1)
    err = torch.tensor(error_direction, dtype=dir_.dtype,
                       device=dir_.device).expand_as(dir_)
    return torch.where(bad[..., None], err, dir_)
