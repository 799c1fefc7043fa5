"""Error-map accumulation, CDF rebuilds and proportional sampling (port
of `rnb_neus2_tpu/train/error_map.py`).

Per-image error maps accumulate the raw per-ray color loss by a bilinear
splat (testbed_nerf.cu:1802-1831) at resolution
min(image res, ceil(√√(samples_per_image))·3.5) (testbed.cu:3642-3644).
Every `n_steps_between_error_map_updates` (128 at first, ×1.5 after each
rebuild; the trainer keeps the cadence) `rebuild` turns the maps into
sampling CDFs with the reference's uniform floors and resets the
accumulator. `sample` draws images and pixels from those CDFs when a
caller turns on one of the two knobs (`TrainConfig.sample_*_
proportional_to_error`, off by default as in the reference).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

MIN_IMG_PMF = 0.1
# share of proportional draws that take a uniform pixel (testbed_nerf.cu
# sample_cdf_2d)
UNIFORM_SAMPLING_FRACTION = 0.5
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


def sample(state: ErrorMapState, n_rays: int, u_img: torch.Tensor | None,
           u_y: torch.Tensor, u_x: torch.Tensor,
           image_proportional: bool = True, focal_proportional: bool = True):
    """→ (img (R,) int64, xy (R, 2) in [0, 1)², pdf (R,)): sample_cdf_2d
    (testbed_nerf.cu:1115-1148) on the uniforms u_img, u_y, u_x, with the
    stratified-uniform scheme until the first rebuild.

    image_proportional / focal_proportional are the pyngp knobs
    (testbed.h:663-664): off, the image is stratified (image_idx) / the
    pixel uniform, the kernels' cdf == nullptr paths."""
    n, eh, ew = state.accum.shape
    dev = u_y.device
    img_u = (torch.arange(n_rays, device=dev) * n) // n_rays
    if not (image_proportional or focal_proportional):
        return (img_u, torch.stack([u_x, u_y], dim=1),
                torch.ones(n_rays, device=dev))
    if image_proportional:
        img_is = torch.clamp_max(
            torch.searchsorted(state.cdf_img, u_img), n - 1)
    else:
        img_is = img_u
    f = UNIFORM_SAMPLING_FRACTION
    # uniform branch (u_x < 0.5): pixel uniform, residual covers the texel
    uniform = u_x < f
    ux_uni = u_x / f
    ux_cdf = (u_x - f) / (1.0 - f)

    ar = torch.arange(n_rays, device=dev)
    rows_cdf = state.cdf_y[img_is]                          # (R, EH)
    y_idx = torch.clamp_max(
        torch.searchsorted(rows_cdf, u_y[:, None])[:, 0], eh - 1)
    x_cdf = state.cdf_x[img_is, y_idx]                      # (R, EW)
    x_idx = torch.clamp_max(
        torch.searchsorted(x_cdf, ux_cdf[:, None])[:, 0], ew - 1)

    def prev(cdf, i):
        return torch.where(i > 0, cdf[ar, torch.clamp_min(i - 1, 0)], 0.0)

    cy_prev = prev(rows_cdf, y_idx)
    pmf_y = rows_cdf[ar, y_idx] - cy_prev
    cx_prev = prev(x_cdf, x_idx)
    pmf_x = x_cdf[ar, x_idx] - cx_prev
    # intra-texel position = rescaled inversion residual (:1130-1141)
    ry = torch.clamp((u_y - cy_prev) / torch.clamp_min(pmf_y, 1e-12),
                     0.0, 1.0)
    rx = torch.clamp((ux_cdf - cx_prev) / torch.clamp_min(pmf_x, 1e-12),
                     0.0, 1.0)
    xy_cdf = torch.stack([(x_idx + rx) / ew, (y_idx + ry) / eh], dim=1)
    xy_is = torch.where(uniform[:, None],
                        torch.stack([ux_uni, u_y], dim=1), xy_cdf)
    # mixture density at the returned pixel (pdf_2d, :1150-1169) × image
    # pmf; diagnostics only (the loss divides by no pdf)
    tx = torch.clamp((xy_is[:, 0] * ew).to(torch.int64), 0, ew - 1)
    ty = torch.clamp((xy_is[:, 1] * eh).to(torch.int64), 0, eh - 1)
    pmf_y_at = rows_cdf[ar, ty] - prev(rows_cdf, ty)
    x_cdf_at = state.cdf_x[img_is, ty]                      # (R, EW)
    pmf_x_at = x_cdf_at[ar, tx] - prev(x_cdf_at, tx)
    pdf_img_f = state.pmf_img[img_is] * n if image_proportional else 1.0
    pdf_xy_f = f + (pmf_y_at * eh) * (pmf_x_at * ew) * (1.0 - f)
    if not focal_proportional:
        xy_is = torch.stack([u_x, u_y], dim=1)
        pdf_xy_f = 1.0
    pdf_is = pdf_img_f * pdf_xy_f

    # uniform fallback before the first rebuild: stratified images,
    # uniform xy
    use_is = state.valid
    img = torch.where(use_is, img_is, img_u)
    xy = torch.where(use_is, xy_is, torch.stack([u_x, u_y], dim=1))
    pdf = torch.where(use_is, pdf_is, 1.0)
    return img, xy, pdf
