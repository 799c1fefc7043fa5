"""Per-view camera refinement: extrinsics, exposure and focal length (port
of `rnb_neus2_tpu/train/camera_refine.py`).

Reference capability (the per-image AdamOptimizer / RotationAdamOptimizer
stepped in train_nerf, src/testbed_nerf.cu:3761-3841; toggles
optimize_extrinsics / optimize_exposure / optimize_focal_length, off by
default in the RNb pipeline):

- extrinsics: a trainable SE(3) delta per view (axis-angle rotation +
  translation) applied to that view's rays before the positions are
  formed; gradients reach it through the sample positions and the
  position-differentiable encode, as in the dynamic scene's delta phase;
- exposure: a per-view log2 RGB scale applied to the decoded ground truth,
  value' = linear_to_srgb(2^e · srgb_to_linear(value))
  (testbed_nerf.cu:1504-1524, with the reference's literal exponent
  0.41666);
- focal length: ONE shared relative (fx, fy) offset for all views
  (cam_focal_length_offset, testbed.h:613, testbed_nerf.cu:3799-3810),
  applied in camera space by rescaling the normalized-plane ray
  coordinates.

`make_refiner` is the refiner's optimizer, optax's adam(lr, .9, .99,
1e-15). A refinement step freezes the field (`NeusField.frozen`), so it
computes no table gradient and launches no scatter kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..device import resolve_device
from .optimizer import Adam


class CameraRefineParams(NamedTuple):
    rot: torch.Tensor        # (N, 3) axis-angle deltas
    trans: torch.Tensor      # (N, 3)
    exposure: torch.Tensor   # (N, 3) log2 RGB scales
    focal: torch.Tensor      # (2,) shared relative (fx, fy) offset


def init_refine_params(n_views: int, device=None) -> CameraRefineParams:
    """Zero corrections on `device` (cuda unless asked)."""
    dev = resolve_device(device)
    z = lambda: torch.zeros(n_views, 3, device=dev)
    return CameraRefineParams(rot=z(), trans=z(), exposure=z(),
                              focal=torch.zeros(2, device=dev))


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """(N, 3) axis-angle → (N, 3, 3) by Rodrigues' formula.

    theta is a smoothed norm (+1e-16 under the root): the exact norm has a
    NaN gradient at the zero rotation, where refinement starts."""
    theta = torch.sqrt(torch.sum(aa * aa, dim=-1, keepdim=True) + 1e-16)
    k = aa / theta
    zeros = torch.zeros_like(k[..., 0])
    K = torch.stack([
        torch.stack([zeros, -k[..., 2], k[..., 1]], -1),
        torch.stack([k[..., 2], zeros, -k[..., 0]], -1),
        torch.stack([-k[..., 1], k[..., 0], zeros], -1),
    ], -2)
    s = torch.sin(theta)[..., None]
    c = torch.cos(theta)[..., None]
    eye = torch.eye(3, device=aa.device)
    return eye + s * K + (1 - c) * (K @ K)


def refine_rays(params: CameraRefineParams, img: torch.Tensor,
                ray_o: torch.Tensor, ray_d: torch.Tensor,
                rot_c2w: torch.Tensor | None = None):
    """Apply each ray's per-view SE(3) delta and, when the rays' camera
    rotations (R, 3, 3) are given, the shared focal offset first: the
    effective focal fx·(1 + offset) divides the normalized-plane
    coordinates, a camera-space rescale of the direction's x and y."""
    d = ray_d
    if rot_c2w is not None:
        dc = torch.einsum("rji,rj->ri", rot_c2w, d)       # R_viewᵀ · d
        dc = dc / dc[..., 2:3]
        scale = 1.0 + params.focal                         # (2,)
        dc = torch.cat([dc[..., :2] / scale, dc[..., 2:]], dim=-1)
        d = torch.einsum("rij,rj->ri", rot_c2w, dc)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    # index_select: its backward is an index_add (every view's rays
    # repeat its row)
    R = axis_angle_to_matrix(params.rot.index_select(0, img))   # (R, 3, 3)
    o = torch.einsum("rij,rj->ri", R, ray_o) \
        + params.trans.index_select(0, img)
    d = torch.einsum("rij,rj->ri", R, d)
    return o, d


def exposure_adjust(params: CameraRefineParams, img: torch.Tensor,
                    decoded: torch.Tensor) -> torch.Tensor:
    """2^exposure applied in linear space to pre-decoded values
    (exposure_scale = exp(ln2·e), testbed_nerf.cu:1504)."""
    scale = torch.exp2(params.exposure.index_select(0, img))   # (R, 3)
    lin = torch.where(decoded <= 0.04045, decoded / 12.92,
                      ((decoded + 0.055) / 1.055) ** 2.4)
    lin = lin * scale
    return torch.where(lin < 0.0031308, 12.92 * lin,
                       1.055 * torch.clamp_min(lin, 0) ** 0.41666 - 0.055)


def make_refiner(params: CameraRefineParams,
                 learning_rate: float = 1e-4) -> Adam:
    """The refinement parameters' optimizer, optax's adam(lr, .9, .99,
    1e-15) (the reference's per-image adams use comparable tiny rates):
    `opt.step(params, grads)` returns the updated `CameraRefineParams`."""
    return Adam(params, learning_rate, b1=0.9, b2=0.99, eps=1e-15)
