"""Mesh extraction: hierarchical SDF evaluation, isosurface, world mapping
(port of `rnb_neus2_tpu/mesh/extract.py`).

Pipeline (mirrors Testbed::compute_and_save_marching_cubes_mesh,
src/testbed.cu:369-381 + testbed_nerf.cu:4218-4350):

1. resolution rounded up to a multiple of 16 (testbed_nerf.cu:4298-4300);
2. the SDF of the given (EMA) parameters at thresh 0, the raw signed
   distance (main.cu:461 passes thresh 0);
3. a coarse pass at res/4, sampled at cell centres, keeps the 16³ blocks
   where min |sdf| < 2·(span/cres)·√3; the fine (res+1)³ volume is the
   coarse grid's value at every point, with the active 17³ blocks
   evaluated at full resolution written over it;
4. marching cubes over the whole fine volume (`marching_device` on the
   field's device, or `marching` in numpy on the host). On the card the
   one-shot `marching_cubes_device` runs where its transient grids fit
   the card's free memory, else `marching_cubes_device_slabbed` with the
   fewest slabs that fit (`mc_slabs`; the JAX package slabs above res 640
   on a 16 GB chip); both give the same mesh;
5. normals from the SDF gradient, optional albedo colours
   clip(exp(clip(albedo_raw, −10, 10)), 0, 1)
   (compute_mesh_vertex_colors, testbed_nerf.cu:4193-4216);
6. vertices mapped to world space, p = n2w_s·(v − offset)/scale + n2w_t
   (marching_cubes.cu:908-935), winding flipped for from_na scenes.

The field is the port's `NeusField` or any object with `sdf(x)` and
`sdf_and_grad(x)` (and `forward(x)` for colours) on (N, 3) float32
tensors. Points are evaluated in fixed chunks under `torch.no_grad()`,
and their positions are made on the field's device.
"""

from __future__ import annotations

import copy
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..io.dataset import SceneMeta
from . import marching
from .marching_device import (marching_cubes_device,
                              marching_cubes_device_slabbed)

# points per field evaluation; the last chunk is padded to this size so
# that every point is evaluated in a batch of the same shape
CHUNK = 1 << 18
# bytes per volume point that the one-shot device marching cubes allocates
# beside the volume: 26,875,038,720 for a 1025³ volume, 24.96 per point
# (chip_smoke.py's mesh phase, `mc_alone_1`; NVIDIA H100 80GB HBM3, 700 W),
# rounded up
MC_BYTES_PER_POINT = 25


def _field_device(field) -> torch.device:
    if isinstance(field, torch.nn.Module):
        p = next(field.parameters(), None)
        if p is not None:
            return p.device
    return torch.device(getattr(field, "device", "cpu"))


def _bind(field, params: Optional[Dict[str, torch.Tensor]]):
    """`field` evaluated with `params` (name → tensor, e.g. the trainer's
    EMA `inference_params`): a copy of the field with them loaded."""
    if params is None:
        return field
    bound = copy.deepcopy(field)
    bound.load_state_dict(params)
    return bound


def _now(dev: torch.device) -> float:
    """The host clock once the device has finished its queued work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


@torch.no_grad()
def _sdf_points(field, n: int, points, chunk: int = CHUNK) -> torch.Tensor:
    """SDF at `points(i)` for the flat indices i in [0, n), chunk by
    chunk; `points` maps (c,) int64 indices to (c, 3) float32 positions."""
    dev = _field_device(field)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    for s in range(0, n, chunk):
        i = torch.arange(s, s + chunk, device=dev)
        x = points(torch.clamp_max(i, n - 1))
        out[s:s + chunk] = field.sdf(x)[:min(chunk, n - s)]
    return out


def _unravel(i: torch.Tensor, n: int) -> torch.Tensor:
    """Flat index of an (n, n, n) C-order grid → (len, 3) int64."""
    return torch.stack([i // (n * n), (i // n) % n, i % n], dim=1)


def coarse_pass(field, res: int, lo: float, span: float, block: int = 16,
                coarse_factor: int = 4):
    """SDF at the cell centres of the (res/coarse_factor)³ grid, and the
    (B, 3) int64 indices of the 16³ blocks that may hold the surface
    (raster order)."""
    cres = res // coarse_factor
    step = span / cres
    csdf = _sdf_points(
        field, cres ** 3,
        lambda i: (lo + (_unravel(i, cres).to(torch.float64) + 0.5) * step
                   ).to(torch.float32)).view(cres, cres, cres)
    # a coarse cell spans coarse_factor fine cells; keep blocks whose |sdf|
    # can reach 0 inside (slack = cell diagonal, SDF Lipschitz ≈ 1, ×2)
    slack = 2.0 * (span / cres) * np.sqrt(3)
    nb, bc = res // block, block // coarse_factor
    bmin = csdf.view(nb, bc, nb, bc, nb, bc).abs().amin(dim=(1, 3, 5))
    return csdf, torch.nonzero(bmin.to(torch.float64) < slack)


def fine_volume(field, csdf: torch.Tensor, active: torch.Tensor, res: int,
                lo: float, span: float, block: int = 16) -> torch.Tensor:
    """The (res+1)³ float32 volume on the field's device: the coarse value
    at every point (the sign is right away from the surface, which is all
    marching cubes reads there), the active blocks' (block+1)³ points
    evaluated over it."""
    dev = csdf.device
    npts, cres, bpts = res + 1, csdf.shape[0], block + 1
    spacing = span / res
    fi = torch.clamp_max(torch.arange(npts, device=dev) * cres // res,
                         cres - 1)
    # one axis at a time: three broadcast index tensors would be expanded
    # to (res+1)³ int64 each (26 GB at res 1024)
    vol = csdf.index_select(0, fi).index_select(1, fi).index_select(2, fi)
    corner = active.to(dev) * block                        # (B, 3)

    def index(i):
        return corner[i // bpts ** 3] + _unravel(i % bpts ** 3, bpts)

    n = corner.shape[0] * bpts ** 3
    if n:
        vals = _sdf_points(field, n, lambda i: torch.clamp(
            lo + index(i).to(torch.float32) * spacing, lo, lo + span))
        flat = vol.view(-1)
        for s in range(0, n, CHUNK):
            ijk = index(torch.arange(s, min(s + CHUNK, n), device=dev))
            flat[(ijk[:, 0] * npts + ijk[:, 1]) * npts + ijk[:, 2]] = \
                vals[s:s + CHUNK]
    return vol


def extract_mesh(field, params, resolution: int = 512,
                 meta: Optional[SceneMeta] = None,
                 block: int = 16, coarse_factor: int = 4,
                 thresh: float = 0.0, aabb=(0.0, 1.0),
                 with_colors: bool = False, backend: str = "auto"):
    """Returns {V (world, float32), F (int64), N (vertex normals), C
    (colours or None)} as numpy arrays, plus `active_blocks` and the
    `seconds` of each stage (coarse, fine, marching_cubes, finish).

    backend: "device" keeps the fine volume on the field's device and
    triangulates there; "host" fetches it and runs the numpy marching
    cubes; "auto" = "device" for a field on a card up to res 1088,
    "host" otherwise. A failure on the card raises. The device backend
    slabs its marching cubes as `mc_slabs` decides; the mesh is the same
    at every slab count."""
    meta = meta or SceneMeta()
    field = _bind(field, params)
    dev = _field_device(field)
    res = -(-resolution // 16) * 16
    lo, hi = aabb
    span = hi - lo
    if backend == "auto":
        backend = ("device" if res <= 1088 and dev.type == "cuda"
                   else "host")
    if backend not in ("device", "host"):
        raise ValueError(f"backend {backend!r}: 'auto', 'device' or 'host'")
    t = [_now(dev)]
    csdf, active = coarse_pass(field, res, lo, span, block, coarse_factor)
    t.append(_now(dev))
    vol = fine_volume(field, csdf, active, res, lo, span, block)
    t.append(_now(dev))
    if backend == "device":
        n = mc_slabs(vol)
        origin = (lo, lo, lo)
        if n > 1:
            V, F = marching_cubes_device_slabbed(vol, origin, span / res,
                                                 thresh, n)
        else:
            V, F = marching_cubes_device(vol, origin, span / res, thresh)
    else:
        V, F = marching.marching_cubes_grid(vol.cpu().numpy(), (lo, lo, lo),
                                            span / res, thresh)
    del vol
    t.append(_now(dev))
    mesh = _finish_mesh(field, V, F, meta, with_colors)
    t.append(_now(dev))
    mesh["active_blocks"] = int(active.shape[0])
    mesh["seconds"] = dict(zip(("coarse", "fine", "marching_cubes",
                                "finish"), np.diff(t).tolist()))
    return mesh


def mc_slabs(vol: torch.Tensor) -> int:
    """1 where the one-shot device marching cubes' grids
    (MC_BYTES_PER_POINT per point) fit the memory free on the volume's
    card, else the fewest slabs (a power of two dividing X − 1) whose
    grids do. 1 for a volume on the CPU."""
    if vol.device.type != "cuda":
        return 1
    free = torch.cuda.mem_get_info(vol.device)[0] + (
        torch.cuda.memory_reserved(vol.device)
        - torch.cuda.memory_allocated(vol.device))
    need = MC_BYTES_PER_POINT * vol.numel()
    cells = vol.shape[0] - 1
    n = 1
    while need / n > free and cells % (2 * n) == 0:
        n *= 2
    return n


@torch.no_grad()
def _finish_mesh(field, V, F, meta: SceneMeta, with_colors: bool) -> dict:
    """Normals from the SDF gradient, optional albedo vertex colours, and
    the unit-cube → world mapping (shared by both backends)."""
    F = F.cpu().numpy() if torch.is_tensor(F) else F
    if not len(V):
        return {"V": np.zeros((0, 3), np.float32),
                "F": np.zeros((0, 3), np.int64),
                "N": np.zeros((0, 3), np.float32), "C": None}
    Vt = torch.as_tensor(V, device=_field_device(field))
    chunks = Vt.split(CHUNK)

    # ---- normals from the SDF gradient (unit-cube space) -----------------
    N = torch.cat([field.sdf_and_grad(x)[1] for x in chunks]).cpu().numpy()
    N /= np.maximum(np.linalg.norm(N, axis=1, keepdims=True), 1e-12)

    # ---- vertex colours (albedo head) -------------------------------------
    C = None
    if with_colors:
        raw = torch.cat([field(x)["albedo_raw"] for x in chunks])
        C = np.clip(np.exp(np.clip(raw.cpu().numpy(), -10, 10)), 0.0, 1.0)

    # ---- to world space ----------------------------------------------------
    V = Vt.cpu().numpy()
    Vw = (V - np.asarray(meta.offset, np.float32)) / meta.scale
    Vw = meta.n2w_scale * Vw + np.asarray(meta.n2w_translation, np.float32)
    Nw = N * np.sign(meta.n2w_scale)
    if meta.from_na:
        F = F[:, ::-1].copy()   # winding flip (marching_cubes.cu via from_na)
        Nw = -Nw
    return {"V": Vw.astype(np.float32), "F": F, "N": Nw.astype(np.float32),
            "C": C}
