"""Synthetic light triplets and the RNb shading model (port of
`rnb_neus2_tpu/render/shading.py`).

Each ray is rendered under ONE of three synthetic directional lights
(testbed_nerf.cu:1537-1593): the canonical triplet (tilt 0°/120°/240°,
slant 54.74°), the identity triplet in supernormal mode, or, in opti-lights
mode, the triplet rotated by the Rodrigues rotation taking +z to the
per-pixel GT normal, negated. Shading s = n·l (optionally ReLU'd).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def canonical_light_triplet() -> np.ndarray:
    """(3, 3) matrix, column k = camera-frame direction of light k."""
    tilt = np.radians([0.0, 120.0, 240.0])
    slant = np.radians([54.74, 54.74, 54.74])
    L = np.stack([
        -np.sin(slant) * np.cos(tilt),
        -np.sin(slant) * np.sin(tilt),
        -np.cos(slant),
    ], axis=0)
    return L.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _triplet(device: torch.device, dtype: torch.dtype,
             supernormal: bool) -> torch.Tensor:
    """The (3, 3) light triplet on `device`, copied there once (a copy
    from host memory every step would make the host wait for it)."""
    if supernormal:
        return torch.eye(3, device=device, dtype=dtype)
    return torch.as_tensor(canonical_light_triplet(), device=device,
                           dtype=dtype)


def rodrigues_to_normal(normal_gt: torch.Tensor) -> torch.Tensor:
    """(R,3) GT normals → (R,3,3) rotations taking +z toward n
    (testbed_nerf.cu:1563-1581), guarded at n = ±z by an epsilon."""
    k = torch.stack([-normal_gt[:, 1], normal_gt[:, 0],
                     torch.zeros_like(normal_gt[:, 0])], dim=1)
    k = k / (torch.linalg.norm(k, dim=1, keepdim=True) + 1e-12)
    cos_t = normal_gt[:, 2]
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, 0.0, 1.0))
    zeros = torch.zeros_like(cos_t)
    K = torch.stack([
        torch.stack([zeros, -k[:, 2], k[:, 1]], dim=1),
        torch.stack([k[:, 2], zeros, -k[:, 0]], dim=1),
        torch.stack([-k[:, 1], k[:, 0], zeros], dim=1),
    ], dim=1)                                            # (R,3,3)
    KK = k[:, :, None] * k[:, None, :]
    eye = torch.eye(3, device=normal_gt.device, dtype=normal_gt.dtype)[None]
    return cos_t[:, None, None] * eye + sin_t[:, None, None] * K \
        + (1.0 - cos_t)[:, None, None] * KK


def per_ray_lights(normal_gt: torch.Tensor, light_idx: torch.Tensor,
                   supernormal: bool, light_opti: bool) -> torch.Tensor:
    """(R,3) camera-frame light for each ray's randomly chosen triplet slot."""
    L = _triplet(normal_gt.device, normal_gt.dtype, supernormal)
    lights = L[None].expand(normal_gt.shape[0], 3, 3)
    if light_opti:
        lights = -torch.einsum("rij,rjk->rik",
                               rodrigues_to_normal(normal_gt), lights)
    return torch.gather(
        lights, 2,
        light_idx.long()[:, None, None].expand(-1, 3, 1))[:, :, 0]


def shade(normal: torch.Tensor, light: torch.Tensor,
          apply_relu: bool) -> torch.Tensor:
    s = torch.sum(normal * light, dim=-1)
    return torch.relu(s) if apply_relu else s
