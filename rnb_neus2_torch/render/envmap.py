"""Trainable environment-map background, a lat-long RGBA texture (port of
`rnb_neus2_tpu/render/envmap.py`; the reference's envmap.cuh).

An (H, W, 4) equirectangular texture sampled by ray direction:

- the direction swizzled to (z, −x, y), then mapped to (polar, azimuth)
  unorm coordinates (envmap.cuh read_envmap → dir_to_spherical_unorm,
  common_device.cuh);
- bilinear filtering, the azimuth (x) wrapping around and the polar
  angle (y) clamped (envmap.cuh:38-63);
- trainable: the sample is gathers and lerps of the texture, so autograd
  gives the bilinear scatter that the reference's deposit_envmap_gradient
  (envmap.cuh:69-104) writes by hand.

The renderer composites it as the background: color += T_final·envmap(d).
"""

from __future__ import annotations

import math

import torch


def init_envmap(height: int = 16, width: int = 32, value: float = 0.5,
                device="cpu") -> torch.Tensor:
    """Constant-grey RGBA envmap (alpha 1)."""
    e = torch.full((height, width, 4), value, dtype=torch.float32,
                   device=device)
    e[..., 3] = 1.0
    return e


def dir_to_spherical_unorm(d: torch.Tensor) -> torch.Tensor:
    """Unit direction (already swizzled by the caller) → (polar, azimuth)
    in [0, 1]²: polar = acos(z)/π, azimuth = atan2(y, x)/(2π) + 0.5."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    polar = torch.arccos(torch.clamp(z, -1.0, 1.0)) / math.pi
    azimuth = torch.atan2(y, x) / (2.0 * math.pi) + 0.5
    return torch.stack([polar, azimuth], dim=-1)


def sample_envmap(envmap: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Bilinear lookup by ray direction: envmap (H, W, 4), dirs (..., 3)
    unit vectors in world space → (..., 4). Differentiable in `envmap`."""
    H, W = envmap.shape[0], envmap.shape[1]
    # reference swizzle: dir_to_spherical_unorm({z, -x, y}) (envmap.cuh:31)
    sw = torch.stack([dirs[..., 2], -dirs[..., 0], dirs[..., 1]], dim=-1)
    uv = dir_to_spherical_unorm(sw)                       # (..., 2)
    fx = uv[..., 1] * (W - 1)                             # azimuth → x
    fy = uv[..., 0] * (H - 1)                             # polar → y
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]

    def at(xi, yi):
        # the azimuth wraps, the polar angle clamps
        return envmap[torch.clamp(yi, 0, H - 1), torch.remainder(xi, W)]

    return ((1 - wx) * (1 - wy) * at(x0, y0)
            + wx * (1 - wy) * at(x0 + 1, y0)
            + (1 - wx) * wy * at(x0, y0 + 1)
            + wx * wy * at(x0 + 1, y0 + 1))


def background_color(envmap: torch.Tensor | None, dirs: torch.Tensor,
                     default=(1.0, 1.0, 1.0)) -> torch.Tensor:
    """RGB background per ray: the envmap's sample or a constant."""
    if envmap is None:
        return torch.tensor(default, dtype=torch.float32,
                            device=dirs.device).expand(
                                dirs.shape[:-1] + (3,))
    return sample_envmap(envmap, dirs)[..., :3]
