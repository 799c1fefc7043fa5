"""Image-space inference renderer (port of `rnb_neus2_tpu/render/
renderer.py`; the reference's Testbed::render_nerf,
src/testbed_nerf.cu:2772-2913, NerfTracer::trace :2581-2702 and
composite_kernel_nerf :881-1216).

The reference traces rays in waves (compact the live rays, 1-8 steps per
round); here, as in the JAX package, each pixel marches its whole ladder
against the occupancy grid at once (`ray_march.march`, the first
`max_samples` occupied points), then composites:

- color = the albedo activation of the RGB head (the reference renders
  with rgb_activation on the first 3 outputs, :987; no shading term);
- depth = Σ w·t, alpha = Σ w, normal = the normalized Σ w·∇sdf, with the
  reference's termination at T < 1e-4;
- the background, a constant or an envmap, behind 1 − alpha.

The field runs on the EMA (inference) parameters at all levels, under
`torch.no_grad()`: `NeusField` gives the analytic ∇sdf in its forward
pass. It is evaluated only at the valid samples of each tile of `tile`
rays; the other samples keep zero weight, so every per-ray sum sees the
same terms in the same order as the JAX package's, which evaluates the
field at every sample. Counting a tile's valid samples reads one number
back to the host.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import MarchConfig
from ..geom.camera import Cameras, rays_from_pixels
from ..kernels.neus_loss import albedo_activation
from ..mesh.extract import _bind, _field_device
from ..ops import ray_march
from . import neus
from .envmap import background_color


def _upsample(img: np.ndarray, W: int, H: int) -> np.ndarray:
    """Bilinear upsample (H', W'[, C]) → (H, W[, C])."""
    h, w = img.shape[:2]
    ys = (np.arange(H) + 0.5) * h / H - 0.5
    xs = (np.arange(W) + 0.5) * w / W - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    if img.ndim == 3:
        fy = fy[..., None]
        fx = fx[..., None]
    a = img[np.ix_(y0, x0)]
    b = img[np.ix_(y0, x1)]
    c = img[np.ix_(y1, x0)]
    d = img[np.ix_(y1, x1)]
    return ((1 - fy) * ((1 - fx) * a + fx * b)
            + fy * ((1 - fx) * c + fx * d)).astype(img.dtype)


def _downsample_box(img: np.ndarray, W: int, H: int) -> np.ndarray:
    """Area average (H', W'[, C]) → (H, W[, C]) for H' ≥ H, W' ≥ W: each
    output pixel averages the source pixels whose centres fall in its
    footprint (fractional boxes by linear edge weights)."""
    h, w = img.shape[:2]

    def axis_weights(n_src, n_dst):
        # weight of source sample s in destination d
        ws = np.zeros((n_dst, n_src), np.float64)
        scale = n_src / n_dst
        for d in range(n_dst):
            lo, hi = d * scale, (d + 1) * scale
            s0, s1 = int(np.floor(lo)), int(np.ceil(hi))
            for s in range(s0, min(s1, n_src)):
                ov = min(hi, s + 1) - max(lo, s)
                if ov > 0:
                    ws[d, s] = ov
        return ws / ws.sum(axis=1, keepdims=True)

    wy = axis_weights(h, H)
    wx = axis_weights(w, W)
    flat = img.reshape(h, w, -1)
    out = np.einsum("Hh,hwc,Ww->HWc", wy, flat, wx)
    return out.reshape((H, W) + img.shape[2:]).astype(img.dtype)


@torch.no_grad()
def render_rays(field, ray_o: torch.Tensor, ray_d: torch.Tensor,
                bitfield: torch.Tensor, march_cfg: MarchConfig,
                max_samples: int = 256, background=(1.0, 1.0, 1.0),
                envmap: Optional[torch.Tensor] = None):
    """(R,) rays (unit directions) → color (R, 3), depth (R,), alpha (R,),
    normal (R, 3) of `field` (parameters already bound)."""
    R = ray_o.shape[0]
    marched = ray_march.march(ray_o, ray_d, bitfield,
                              torch.full((R,), 0.5, device=ray_o.device),
                              march_cfg.n_ladder, max_samples,
                              march_cfg.cone_angle)
    M = marched.t.shape[1]
    valid = marched.valid
    pos = ray_o[:, None, :] + marched.t[..., None] * ray_d[:, None, :]
    sdf = ray_o.new_zeros(R, M)
    grad = ray_o.new_zeros(R, M, 3)
    alb = ray_o.new_zeros(R, M, 3)
    pts = torch.clamp(pos[valid], 0.0, 1.0)
    if pts.shape[0]:
        out = field(pts)
        sdf[valid] = out["sdf"]
        grad[valid] = out["grad"]
        alb[valid] = albedo_activation(out["albedo_raw"])
    inv_s = torch.exp(10.0 * field.variance[0])
    tc = torch.sum(ray_d[:, None, :] * grad, dim=-1)
    alpha = neus.sdf_to_alpha(sdf, tc, marched.dt, inv_s, 1.0)
    w = neus.composite(alpha, valid).weight
    color = torch.sum(w[..., None] * alb, dim=1)
    depth = torch.sum(w * marched.t, dim=1)
    asum = torch.sum(w, dim=1)
    nrm = torch.sum(w[..., None] * grad, dim=1)
    nrm = nrm / torch.clamp_min(torch.linalg.norm(nrm, dim=-1, keepdim=True),
                                1e-9)
    bg = background_color(envmap, ray_d, background)   # envmap.cuh read
    color = color + (1.0 - asum[:, None]) * bg
    return color, depth, asum, nrm


def render_view(field, params: Optional[Dict[str, torch.Tensor]],
                cams: Cameras, view_idx: int, bitfield: torch.Tensor,
                march_cfg: Optional[MarchConfig] = None,
                max_samples: int = 256, tile: int = 4096,
                background=(1.0, 1.0, 1.0),
                envmap: Optional[torch.Tensor] = None,
                render_scale: float = 1.0) -> Dict[str, np.ndarray]:
    """Render one view → {"albedo" (H, W, 3), "depth", "alpha", "normal"}
    as numpy arrays, with `field` evaluated on `params` (the trainer's
    `inference_params`; None keeps the field's own).

    render_scale < 1 renders at a reduced internal resolution and
    upsamples bilinearly to the output size (the headless counterpart of
    the reference's DLSS render scale, src/dlss.cu); above 1 it renders
    larger and box-filters down."""
    march_cfg = march_cfg or MarchConfig()
    field = _bind(field, params)
    W, H = cams.resolution
    if render_scale != 1.0:
        W_out, H_out = W, H
        W = max(int(round(W * render_scale)), 1)
        H = max(int(round(H * render_scale)), 1)
        # focal scaled by the rounded raster ratio per axis, so that the
        # field of view is kept when W·scale is fractional
        fscale = torch.tensor([W / W_out, H / H_out], dtype=torch.float32,
                              device=cams.focal.device)
        cams = cams._replace(focal=cams.focal * fscale, resolution=(W, H))
        out = render_view(field, None, cams, view_idx, bitfield, march_cfg,
                          max_samples, tile, background, envmap)
        if render_scale > 1.0:
            # supersampled: an area average, so the extra samples are not
            # aliased away
            return {k: _downsample_box(v, W_out, H_out)
                    for k, v in out.items()}
        return {k: _upsample(v, W_out, H_out) for k, v in out.items()}
    dev = _field_device(field)
    n = W * H
    ys, xs = np.mgrid[0:H, 0:W]
    xy = np.stack([(xs.ravel() + 0.5) / W, (ys.ravel() + 0.5) / H], axis=1)
    xy = torch.as_tensor(xy, dtype=torch.float32, device=dev)
    parts = []
    for s in range(0, n, tile):
        xy_t = xy[s:s + tile]
        ids = torch.full((xy_t.shape[0],), view_idx, dtype=torch.int64,
                         device=dev)
        o, d = rays_from_pixels(cams, ids, xy_t)
        parts.append(render_rays(field, o, d, bitfield, march_cfg,
                                 max_samples, background, envmap))
    color, depth, alpha, normal = (torch.cat(p).cpu().numpy()
                                   for p in zip(*parts))
    return {
        "albedo": color.reshape(H, W, 3),
        "depth": depth.reshape(H, W),
        "alpha": alpha.reshape(H, W),
        "normal": normal.reshape(H, W, 3),
    }


def render_path(field, params: Optional[Dict[str, torch.Tensor]],
                cams: Cameras, bitfield: torch.Tensor, camera_path,
                n_frames: int, march_cfg: Optional[MarchConfig] = None,
                max_samples: int = 256, background=(1.0, 1.0, 1.0),
                envmap: Optional[torch.Tensor] = None,
                render_scale: float = 1.0):
    """Yield (H, W, 4) float RGBA frames (albedo and alpha) along a
    `CameraPath`, each through view 0's intrinsics with the path's pose
    (the headless counterpart of the reference's camera-path playback,
    src/camera_path.cu)."""
    field = _bind(field, params)
    V = cams.rot_c2w.shape[0]
    for m in camera_path.frames(n_frames):
        m = torch.as_tensor(m, device=cams.rot_c2w.device)
        cams_m = cams._replace(rot_c2w=m[:3, :3].expand(V, 3, 3),
                               origin=m[:3, 3].expand(V, 3))
        out = render_view(field, None, cams_m, 0, bitfield, march_cfg,
                          max_samples, background=background, envmap=envmap,
                          render_scale=render_scale)
        yield np.concatenate([out["albedo"], out["alpha"][..., None]],
                             axis=-1)
