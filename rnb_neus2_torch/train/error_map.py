"""Error-map accumulation and CDF rebuilds (port of
`rnb_neus2_tpu/train/error_map.py` without `sample`).

Per-image error maps accumulate the raw per-ray color loss by a bilinear
splat (testbed_nerf.cu:1802-1831) at resolution
min(image res, ceil(√√(samples_per_image))·3.5) (testbed.cu:3642-3644).
Every `n_steps_between_error_map_updates` (128 at first, ×1.5 after each
rebuild; the trainer keeps the cadence) `rebuild` turns the maps into
sampling CDFs with the reference's uniform floors and resets the
accumulator. Drawing pixels from those CDFs (`sample`) comes with
error-map sampling in a later slice; the reference trains with it off by
default.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

MIN_IMG_PMF = 0.1
# per-texel / per-row uniform floor (testbed_nerf.cu:2433 MIN_PDF)
MIN_PDF = 0.01


class ErrorMapState(NamedTuple):
    accum: torch.Tensor        # (N, EH, EW) accumulated loss since rebuild
    cdf_x: torch.Tensor        # (N, EH, EW) per-row CDF
    cdf_y: torch.Tensor        # (N, EH) row CDF per image
    cdf_img: torch.Tensor      # (N,) image CDF
    pmf_img: torch.Tensor      # (N,) image pmf
    valid: torch.Tensor        # () bool: CDFs built at least once


def resolution_for(n_images: int, rays_per_batch: int,
                   update_interval: int, image_res: Tuple[int, int]
                   ) -> Tuple[int, int]:
    spp = update_interval * rays_per_batch / max(n_images, 1)
    r = int(math.sqrt(math.sqrt(spp)) * 3.5)
    return (max(2, min(r, image_res[0])), max(2, min(r, image_res[1])))


def _ramp(n: int, device) -> torch.Tensor:
    """(1..n)/n: the uniform CDF over n bins."""
    return (torch.arange(n, dtype=torch.float32, device=device) + 1) / n


def init_state(n_images: int, ew: int, eh: int, device="cpu"
               ) -> ErrorMapState:
    return ErrorMapState(
        accum=torch.zeros((n_images, eh, ew), device=device),
        cdf_x=_ramp(ew, device).expand(n_images, eh, ew).clone(),
        cdf_y=_ramp(eh, device).expand(n_images, eh).clone(),
        cdf_img=_ramp(n_images, device),
        pmf_img=torch.full((n_images,), 1.0 / n_images, device=device),
        valid=torch.zeros((), dtype=torch.bool, device=device))


def splat(state: ErrorMapState, img: torch.Tensor, xy: torch.Tensor,
          loss: torch.Tensor) -> ErrorMapState:
    """Bilinear accumulation of per-ray losses (testbed_nerf.cu:1802-1831).
    The clamp keeps every corner inside the image's map, so the JAX
    package's out-of-range drop never applies."""
    n, eh, ew = state.accum.shape
    px = torch.clamp(xy[:, 0] * ew - 0.5, 0.0, ew - 1.0 - 1e-4)
    py = torch.clamp(xy[:, 1] * eh - 0.5, 0.0, eh - 1.0 - 1e-4)
    x0 = px.to(torch.int64)
    y0 = py.to(torch.int64)
    fx, fy = px - x0, py - y0
    flat = state.accum.reshape(-1).clone()
    base = (img * eh + y0) * ew + x0
    flat.index_add_(0, base, loss * (1 - fx) * (1 - fy))
    flat.index_add_(0, base + 1, loss * fx * (1 - fy))
    flat.index_add_(0, base + ew, loss * (1 - fx) * fy)
    flat.index_add_(0, base + ew + 1, loss * fx * fy)
    return state._replace(accum=flat.reshape(n, eh, ew))


def rebuild(state: ErrorMapState) -> ErrorMapState:
    """Accumulated errors → sampling CDFs; accumulator reset.

    Every CDF level gets the reference's uniform floor blended in
    (construct_cdf_2d/1d, testbed_nerf.cu:2433-2489): per-texel and
    per-row MIN_PDF = 0.01, per-image MIN_PMF = 0.1."""
    n, eh, ew = state.accum.shape
    dev = state.accum.device
    m = state.accum + 1e-10
    row_sum = m.sum(dim=2)                                  # (N, EH)
    cdf_x = (1 - MIN_PDF) * torch.cumsum(m, dim=2) / row_sum[:, :, None] \
        + MIN_PDF * _ramp(ew, dev)
    img_sum = row_sum.sum(dim=1)                            # (N,)
    cdf_y = (1 - MIN_PDF) * torch.cumsum(row_sum, dim=1) / img_sum[:, None] \
        + MIN_PDF * _ramp(eh, dev)
    pmf = img_sum / img_sum.sum()
    pmf = (1 - MIN_IMG_PMF) * pmf + MIN_IMG_PMF / n
    return ErrorMapState(accum=torch.zeros_like(state.accum), cdf_x=cdf_x,
                         cdf_y=cdf_y, cdf_img=torch.cumsum(pmf, dim=0),
                         pmf_img=pmf,
                         valid=torch.ones((), dtype=torch.bool, device=dev))
