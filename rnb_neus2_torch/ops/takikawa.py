"""Takikawa (NGLOD) octree feature encoding, the SDF mode's alternative
encoding (port of `rnb_neus2_tpu/ops/takikawa.py`; the reference's
TakikawaEncoding, takikawa_encoding.cuh, over its TriangleOctree,
triangle_octree.cuh):

- the octree is refined only where the mesh's triangles lie; levels
  [starting_level, starting_level + n_levels) store 8 features at the
  vertices (lattice corners) of occupied cells (takikawa_encoding.cuh:
  277-285);
- a point is encoded per stored level by the trilinear (or smoothstep)
  interpolation of its cell's 8 corner features (kernel_takikawa:77-106,
  :64-75); a level whose cell is not refined outputs zeros (:155-163).

The octree is built once on the host in numpy (the JAX package's code,
copied): occupied cells per level by triangle subdivision, shared corner
vertices deduplicated into one vertex table. On the device a level is a
`searchsorted` of the point's cell id in the level's sorted cell ids, one
octet gather and the lerp. The table gradient is a scatter-add of
(N·8, F) rows through the CUDA kernel (`ops/gather.py`); the positions'
gradient comes from autograd through the interpolation weights.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .gather import gather_rows


@dataclasses.dataclass
class TriangleOctree:
    """Host-built sparse octree over a triangle mesh in [0,1]³.

    Per stored level l (resolution 2^(starting_level+l)):
      cell_keys[l]: (C_l,) int32 sorted linear cell ids (x + y·R + z·R²)
      octets[l]:    (C_l, 8) int32 global vertex ids, corner order =
                    bit d of the corner index ↔ +1 step in dim d
                    (kernel_takikawa:82-93)
    """
    starting_level: int
    n_levels: int
    cell_keys: List[np.ndarray]
    octets: List[np.ndarray]
    n_vertices: int

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * 8


CORNERS = np.array([[(i >> d) & 1 for d in range(3)] for i in range(8)],
                   np.int32)                     # (8,3), bit d ↔ dim d


def _occupied_cells(tri: np.ndarray, res: int) -> np.ndarray:
    """Linear ids of cells touched by any triangle at resolution `res`:
    conservative rasterization by recursive edge-midpoint subdivision
    until every triangle is under half a cell, then every cell its
    bounding box overlaps (a sliver across a cell boundary marks both)."""
    tris = [tri.astype(np.float64)]
    h = 0.5 / res
    out = []
    while tris:
        t = tris.pop()
        e = np.maximum(np.linalg.norm(t[:, 0] - t[:, 1], axis=1),
                       np.maximum(np.linalg.norm(t[:, 1] - t[:, 2], axis=1),
                                  np.linalg.norm(t[:, 2] - t[:, 0], axis=1)))
        small = e <= h
        done = t[small]
        if len(done):
            lo = np.clip(np.floor(done.min(axis=1) * res), 0,
                         res - 1).astype(np.int64)         # (T, 3)
            hi = np.clip(np.floor(done.max(axis=1) * res), 0,
                         res - 1).astype(np.int64)
            for dx, dy, dz in CORNERS:
                c = np.minimum(lo + np.array([dx, dy, dz]), hi)
                out.append(c[:, 0] + c[:, 1] * res + c[:, 2] * res * res)
        big = t[~small]
        if len(big):
            m01 = (big[:, 0] + big[:, 1]) / 2
            m12 = (big[:, 1] + big[:, 2]) / 2
            m20 = (big[:, 2] + big[:, 0]) / 2
            tris.extend([
                np.stack([big[:, 0], m01, m20], axis=1),
                np.stack([m01, big[:, 1], m12], axis=1),
                np.stack([m20, m12, big[:, 2]], axis=1),
                np.stack([m01, m12, m20], axis=1),
            ])
    if not out:
        return np.zeros((0,), np.int64)
    return np.unique(np.concatenate(out))


def build_triangle_octree(vertices: np.ndarray, faces: np.ndarray,
                          depth: int, starting_level: int = 0
                          ) -> TriangleOctree:
    """The octree whose levels starting_level … depth − 1 store features;
    `vertices` already in [0,1]³ (the SDF mode's scene normalization)."""
    if depth <= starting_level:
        raise ValueError(f"depth {depth} <= starting_level "
                         f"{starting_level}")
    tri = np.asarray(vertices, np.float64)[np.asarray(faces)]
    cell_keys, octets = [], []
    v_offset = 0
    for lvl in range(starting_level, depth):
        res = 1 << lvl
        keys = _occupied_cells(tri, res)
        cx = (keys % res).astype(np.int64)
        cy = ((keys // res) % res).astype(np.int64)
        cz = (keys // (res * res)).astype(np.int64)
        # corner lattice ids on the (res+1)³ vertex lattice
        vres = res + 1
        corners = (np.stack([cx, cy, cz], 1)[:, None, :]
                   + CORNERS[None, :, :])                      # (C,8,3)
        vid = (corners[..., 0] + corners[..., 1] * vres
               + corners[..., 2] * vres * vres)                # (C,8)
        uniq, inv = np.unique(vid, return_inverse=True)
        octets.append((inv.reshape(vid.shape) + v_offset).astype(np.int32))
        cell_keys.append(keys.astype(np.int32))
        v_offset += len(uniq)
    return TriangleOctree(starting_level, depth - starting_level,
                          cell_keys, octets, v_offset)


def init_takikawa_params(octree: TriangleOctree, n_features: int = 8,
                         generator: torch.Generator | None = None,
                         device="cpu") -> torch.Tensor:
    """Vertex feature table U(−1e−4, 1e−4) (tcnn-style init)."""
    u = torch.rand((octree.n_vertices, n_features), generator=generator,
                   device=device)
    return u * 2e-4 - 1e-4


def _smoothstep(x):
    return x * x * (3.0 - 2.0 * x)


def encode(table: torch.Tensor, positions: torch.Tensor,
           octree: TriangleOctree, interpolation: str = "linear"
           ) -> torch.Tensor:
    """(N,3) in [0,1] → (N, n_levels·F) features; zeros where the octree
    is not refined (kernel_takikawa:155-163)."""
    n = positions.shape[0]
    F = table.shape[1]
    dev = positions.device
    on = torch.as_tensor(CORNERS, device=dev)[None] > 0            # (1,8,3)
    outs = []
    for lvl in range(octree.n_levels):
        res = 1 << (octree.starting_level + lvl)
        keys = torch.as_tensor(octree.cell_keys[lvl], dtype=torch.int64,
                               device=dev)
        if keys.numel() == 0:
            outs.append(positions.new_zeros(n, F))
            continue
        octs = torch.as_tensor(octree.octets[lvl], dtype=torch.int64,
                               device=dev)
        p = positions * res
        cell = torch.clamp(torch.floor(p).to(torch.int64), 0, res - 1)
        frac = p - cell.to(p.dtype)
        key = cell[:, 0] + cell[:, 1] * res + cell[:, 2] * res * res
        i = torch.clamp(torch.searchsorted(keys, key), 0, keys.numel() - 1)
        found = keys[i] == key
        feats = gather_rows(table, octs[i])                         # (N,8,F)
        if interpolation == "smoothstep":
            frac = _smoothstep(frac)
        w = torch.prod(torch.where(on, frac[:, None, :],
                                   1.0 - frac[:, None, :]), dim=-1)  # (N,8)
        out = torch.einsum("ncf,nc->nf", feats, w)
        outs.append(out * found[:, None].to(table.dtype))
    return torch.cat(outs, dim=1)
