"""Occupancy grid, single cascade: 128³ density EMA + boolean occupancy
(port of `rnb_neus2_tpu/grid/occupancy.py:39-138`).

Reference behavior (src/testbed_nerf.cu:3424-3517, 585-741):
- each refresh evaluates the NeuS density at one jittered position per
  visited cell and merges grid = max(grid·decay, density) (decay 0.95);
- occupancy bit = density > min(0.1, mean(max(grid, 0))) (strict '>');
- after step 256 a refresh visits G³/4 uniform + G³/4 occupancy-biased
  cells from a prime-multiplier sequence — deterministic picks, computed in
  uint32 arithmetic (emulated in int64 masked to 32 bits);
- refresh cadence clamp(step/16, 1, 16) (testbed.cu:2801-2821).

Layout: flat (G³,) with index x + G·(y + G·z).

Multi-cascade grids (`rnb_neus2_tpu/grid/occupancy.py:153-245`): one G³
grid per cascade m, covering the cube of side 2^m centred on 0.5
(cascaded_grid_idx_at, testbed_nerf.cu:439-458), as (C, G³) arrays; the
cascade of a position (and step size) is the reference's mip_from_pos /
mip_from_dt (:569-583), and after thresholding each finer cascade's
occupancy is max-pooled into the central eighth of the next
(bitfield_max_pool :719-741). The JAX package's trainer never builds
them; `ray_march` consults them when it is given a (C, G³) bitfield.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import NERF_GRIDSIZE, NERF_MIN_OPTICAL_THICKNESS

MASK32 = 0xFFFFFFFF


class OccupancyState(NamedTuple):
    density: torch.Tensor       # (G³,) float32 EMA'd density
    bitfield: torch.Tensor      # (G³,) bool
    mean_density: torch.Tensor  # () float32
    ema_step: int               # refreshes so far


def init_state(grid_size: int = NERF_GRIDSIZE, device="cpu"
               ) -> OccupancyState:
    n = grid_size ** 3
    return OccupancyState(
        density=torch.zeros(n, device=device),
        bitfield=torch.zeros(n, dtype=torch.bool, device=device),
        mean_density=torch.zeros((), device=device),
        ema_step=0,
    )


def _cell_base(idx: torch.Tensor, g: int) -> torch.Tensor:
    x = idx % g
    y = (idx // g) % g
    z = idx // (g * g)
    return torch.stack([x, y, z], dim=1).to(torch.float32)


def cell_positions(grid_size: int = NERF_GRIDSIZE,
                   generator: torch.Generator | None = None, device="cpu",
                   jitter: torch.Tensor | None = None) -> torch.Tensor:
    """One uniformly jittered position per cell, (G³, 3) in [0,1]. The
    (G³, 3) jitter in [0, 1) comes from `generator` unless given."""
    g = grid_size
    idx = torch.arange(g ** 3, device=device)
    if jitter is None:
        jitter = torch.rand((g ** 3, 3), generator=generator, device=device)
    return (_cell_base(idx, g) + jitter) / g


def update(state: OccupancyState, densities: torch.Tensor,
           decay: float = 0.95,
           thresh: float = NERF_MIN_OPTICAL_THICKNESS) -> OccupancyState:
    """Merge fresh per-cell densities and rebuild the occupancy field."""
    new_density = torch.where(state.density < 0.0, state.density,
                              torch.maximum(state.density * decay, densities))
    mean = torch.mean(torch.clamp_min(new_density, 0.0))
    bit = new_density > torch.clamp_max(mean, thresh)
    return OccupancyState(density=new_density, bitfield=bit,
                          mean_density=mean, ema_step=state.ema_step + 1)


def sample_update_cells(state: OccupancyState, grid_size: int,
                        n_uniform: int, n_nonuniform: int,
                        thresh: float = NERF_MIN_OPTICAL_THICKNESS,
                        generator: torch.Generator | None = None,
                        jitter: torch.Tensor | None = None):
    """Steady-state subsampled refresh cells (generate_grid_samples_nerf_
    nonuniform, testbed_nerf.cu:585-614): n_uniform cells with threshold
    −0.01, n_nonuniform cells biased to occupied space (first of up to 10
    candidates with density > thresh, else the 10th), one jittered position
    inside each. Returns (positions (M, 3), cell_idx (M,) int64)."""
    g = grid_size
    n_cells = g ** 3
    M = n_uniform + n_nonuniform
    dev = state.density.device
    i = torch.arange(M, dtype=torch.int64, device=dev)
    j = torch.arange(10, dtype=torch.int64, device=dev)[None, :]
    step = state.ema_step & MASK32
    a = ((i + step * M) & MASK32)[:, None]
    cand = (((a * 56924617) & MASK32) + ((j * 19349663) & MASK32)
            + 96925573) & MASK32
    cand = cand % n_cells                                     # (M, 10)
    per_thresh = torch.where(i < n_uniform, -0.01, thresh)[:, None]
    ok = state.density[cand] > per_thresh                     # (M, 10)
    first = torch.argmax(ok.to(torch.int8), dim=1)
    pick = torch.where(ok.any(dim=1), first, torch.full_like(first, 9))
    idx = torch.gather(cand, 1, pick[:, None])[:, 0]
    if jitter is None:
        jitter = torch.rand((M, 3), generator=generator, device=dev)
    return (_cell_base(idx, g) + jitter) / g, idx


def update_sampled(state: OccupancyState, cell_idx: torch.Tensor,
                   densities: torch.Tensor, decay: float = 0.95,
                   thresh: float = NERF_MIN_OPTICAL_THICKNESS
                   ) -> OccupancyState:
    """Merge densities measured at a SUBSET of cells: sampled cells take
    max(decay·prev, new) (max-splat over duplicates, :617-640); unsampled
    cells decay (tmp = 0)."""
    tmp = torch.zeros_like(state.density).scatter_reduce(
        0, cell_idx, densities, reduce="amax", include_self=True)
    return update(state, tmp, decay, thresh)


def lookup(bitfield: torch.Tensor, pos: torch.Tensor,
           grid_size: int = 0) -> torch.Tensor:
    """Occupancy at positions (..., 3) in [0,1] (density_grid_occupied_at)."""
    if not grid_size:
        grid_size = round(bitfield.shape[0] ** (1.0 / 3.0))
    cell = torch.clamp((pos * grid_size).to(torch.int64), 0, grid_size - 1)
    idx = cell[..., 0] + grid_size * (cell[..., 1] + grid_size * cell[..., 2])
    return bitfield[idx]


def update_cadence(step: int) -> int:
    """clamp(step/16, 1, 16) (testbed.cu:2801)."""
    return int(np.clip(step // 16, 1, 16))


# ---------------------------------------------------------------------------
# Multi-cascade occupancy (aabb_scale > 1)
# ---------------------------------------------------------------------------


def _exponent(v: torch.Tensor) -> torch.Tensor:
    """frexp's exponent e of max(v, 1e-30): v = f·2^e with f in [0.5, 1),
    i.e. floor(log2(v)) + 1 computed exactly (testbed_nerf.cu:569-583
    calls frexpf). The JAX package takes floor(log2(·)) in float32, whose
    log rounds up to the integer for a few ulps just below a power of two;
    everywhere else the two agree."""
    return torch.frexp(torch.clamp_min(v, 1e-30)).exponent.to(torch.int64)


def mip_from_pos(pos: torch.Tensor, max_cascade: int) -> torch.Tensor:
    """(..., 3) → (...) int64 cascade from position (testbed_nerf.cu:
    569-573: frexp(max|pos − 0.5|) exponent + 1, clipped)."""
    maxval = torch.amax(torch.abs(pos - 0.5), dim=-1)
    return torch.clamp(_exponent(maxval) + 1, 0, max_cascade)


def mip_from_dt(dt: torch.Tensor, pos: torch.Tensor, max_cascade: int,
                grid_size: int = NERF_GRIDSIZE) -> torch.Tensor:
    """Cascade from step size and position (testbed_nerf.cu:576-583)."""
    mip = mip_from_pos(pos, max_cascade)
    x = dt * (2 * grid_size)
    e = _exponent(x)
    return torch.where(x < 1.0, mip,
                       torch.clamp(torch.maximum(e, mip), 0, max_cascade))


def init_state_cascaded(grid_size: int = NERF_GRIDSIZE, n_cascades: int = 1,
                        device="cpu") -> OccupancyState:
    n = grid_size ** 3
    return OccupancyState(
        density=torch.zeros((n_cascades, n), device=device),
        bitfield=torch.zeros((n_cascades, n), dtype=torch.bool,
                             device=device),
        mean_density=torch.zeros((), device=device),
        ema_step=0,
    )


def cascade_cell_positions(grid_size: int, n_cascades: int,
                           generator: torch.Generator | None = None,
                           device="cpu",
                           jitter: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """(C·G³, 3) world positions: one jittered point per cell per cascade
    (cascade m spans [0.5 − 2^{m−1}, 0.5 + 2^{m−1}] per axis). Each
    cascade's (G³, 3) jitter comes from `generator` in cascade order, or
    from the (C·G³, 3) `jitter` (the JAX package folds the cascade into
    its key)."""
    n = grid_size ** 3
    pts = []
    for m in range(n_cascades):
        j = None if jitter is None else jitter[m * n:(m + 1) * n]
        local = cell_positions(grid_size, generator, device, jitter=j)
        pts.append((local - 0.5) * (2.0 ** m) + 0.5)
    return torch.cat(pts, dim=0)


def _maxpool_into_next(bits: torch.Tensor, grid_size: int) -> torch.Tensor:
    """(C, G³) bool → the same, with each cascade's central eighth OR'd
    with the 2× max-pool of the finer cascade (bitfield_max_pool)."""
    g = grid_size
    h, q = g // 2, g // 4
    out = [bits[0]]
    for m in range(1, bits.shape[0]):
        fine = out[m - 1].reshape(h, 2, h, 2, h, 2)
        pooled = fine.any(dim=5).any(dim=3).any(dim=1)
        cur = bits[m].reshape(g, g, g).clone()
        cur[q:q + h, q:q + h, q:q + h] |= pooled
        out.append(cur.reshape(-1))
    return torch.stack(out, dim=0)


def update_cascaded(state: OccupancyState, densities: torch.Tensor,
                    grid_size: int = NERF_GRIDSIZE, decay: float = 0.95,
                    thresh: float = NERF_MIN_OPTICAL_THICKNESS
                    ) -> OccupancyState:
    """Merge per-cell densities (C, G³) and rebuild the cascaded occupancy;
    the threshold's mean is over cascade 0, as the reference's
    (update_density_grid_mean_and_bitfield :3497-3517)."""
    new_density = torch.where(state.density < 0.0, state.density,
                              torch.maximum(state.density * decay, densities))
    mean = torch.mean(torch.clamp_min(new_density[0], 0.0))
    bits = new_density > torch.clamp_max(mean, thresh)
    return OccupancyState(density=new_density,
                          bitfield=_maxpool_into_next(bits, grid_size),
                          mean_density=mean, ema_step=state.ema_step + 1)


def lookup_cascaded(bitfield: torch.Tensor, pos: torch.Tensor,
                    dt: torch.Tensor | None = None,
                    grid_size: int = NERF_GRIDSIZE) -> torch.Tensor:
    """Occupancy at world positions (..., 3) across the cascades of a
    (C, G³) bitfield (density_grid_occupied_at + the mip selection)."""
    C = bitfield.shape[0]
    if dt is None:
        mip = mip_from_pos(pos, C - 1)
    else:
        mip = mip_from_dt(dt, pos, C - 1, grid_size)
    scale = torch.exp2(-mip.to(torch.float32))[..., None]
    local = (pos - 0.5) * scale + 0.5
    cell = torch.clamp((local * grid_size).to(torch.int64), 0, grid_size - 1)
    idx = cell[..., 0] + grid_size * (cell[..., 1] + grid_size * cell[..., 2])
    return bitfield[mip, idx]
