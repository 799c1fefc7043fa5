"""Table-based marching cubes on a numpy volume (port of
`marching_cubes_grid` and the volume gradients of
`rnb_neus2_tpu/mesh/marching.py`).

`marching_cubes_grid` is vectorized 256-case table marching cubes with
topology parity to the reference's CUDA kernels
(src/marching_cubes.cu:276-430, 660-718, 794-822): a vertex on every
sign-change grid edge at the linear zero crossing, the Bourke triangle
table (mc_tables.py), the table's winding. It is the host backend of
`extract_mesh` and the oracle that `marching_device.marching_cubes_device`
is held to. The legacy tetrahedral extractor (`marching_tets`) is not
ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .mc_tables import TRIANGLE_TABLE


def _volume_gradient_at(vol, origin, spacing, pts):
    """Trilinear-free nearest-cell central differences of the volume."""
    X, Y, Z = vol.shape
    ijk = np.clip(((pts - origin[None, :]) / spacing).round().astype(int),
                  1, [X - 2, Y - 2, Z - 2])
    x, y, z = ijk[:, 0], ijk[:, 1], ijk[:, 2]
    gx = vol[x + 1, y, z] - vol[x - 1, y, z]
    gy = vol[x, y + 1, z] - vol[x, y - 1, z]
    gz = vol[x, y, z + 1] - vol[x, y, z - 1]
    return np.stack([gx, gy, gz], axis=1)


# ---------------------------------------------------------------------------
# Table-based marching cubes with reference topology
# ---------------------------------------------------------------------------

def marching_cubes_grid(vol: np.ndarray, origin, spacing: float,
                        thresh: float = 0.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """256-case table marching cubes, vectorized numpy, topology-parity
    with the reference's gen_vertices/gen_faces
    (src/marching_cubes.cu:276-430, 660-718):

    - a vertex on every grid edge whose endpoint signs differ
      (inside = value > thresh), at the linear zero crossing;
    - per mixed cell, triangles from the Bourke table indexed by the
      8-corner mask (bit order marching_cubes.cu:675-683);
    - winding follows the table order, matching the CUDA output.

    The CUDA version enumerates vertices with atomics (nondeterministic
    ids); here ids are raster-deterministic (axis-major edge order, the
    same layout as its vertidx_grid). Connectivity is identical.

    vol: (X, Y, Z) float; returns (V (n,3) float32 world, F (m,3) int64).
    """
    X, Y, Z = vol.shape
    inside = vol > thresh
    n3 = X * Y * Z

    # --- vertices: one per sign-change edge, axis-major like vertidx_grid
    # int32 ids: the (3, X, Y, Z) grid is the peak allocation at 1024³
    # (12.6 GB vs 25 GB in int64); crossing-edge counts are far below 2^31
    # at any feasible resolution
    vid = np.full((3, X, Y, Z), -1, np.int32)
    verts = []
    base = 0
    for axis, (sl0, sl1) in enumerate((
            (np.s_[:-1, :, :], np.s_[1:, :, :]),
            (np.s_[:, :-1, :], np.s_[:, 1:, :]),
            (np.s_[:, :, :-1], np.s_[:, :, 1:]))):
        hit = inside[sl0] != inside[sl1]
        ids = np.flatnonzero(hit)
        shape = hit.shape
        g = np.full(shape, -1, np.int32)
        g.reshape(-1)[ids] = base + np.arange(len(ids))
        vid[axis][sl0] = g
        f0 = vol[sl0].reshape(-1)[ids]
        f1 = vol[sl1].reshape(-1)[ids]
        dt = (thresh - f0) / (f1 - f0)
        ix, iy, iz = np.unravel_index(ids, shape)
        p = np.stack([ix, iy, iz], axis=1).astype(np.float64)
        p[:, axis] += dt
        verts.append(p)
        base += len(ids)
    V = (np.concatenate(verts, 0) if verts else np.zeros((0, 3)))
    V = (V * spacing + np.asarray(origin, np.float64)).astype(np.float32)

    # --- cells: 8-corner mask (bit order marching_cubes.cu:675-683)
    mask = (inside[:-1, :-1, :-1].astype(np.uint8)
            | (inside[1:, :-1, :-1] << 1)
            | (inside[1:, 1:, :-1] << 2)
            | (inside[:-1, 1:, :-1] << 3)
            | (inside[:-1, :-1, 1:].astype(np.uint8) << 4)
            | (inside[1:, :-1, 1:] << 5)
            | (inside[1:, 1:, 1:] << 6)
            | (inside[:-1, 1:, 1:] << 7))
    act = np.nonzero((mask > 0) & (mask < 255))
    if len(act[0]) == 0:
        return V, np.zeros((0, 3), np.int64)
    ax, ay, az = act
    m = mask[act]                                     # (K,)

    # --- local edge table: 12 edge-vertex ids per active cell
    # (gen_faces local_edges order, marching_cubes.cu:690-703)
    e = np.empty((len(ax), 12), np.int64)
    e[:, 0] = vid[0, ax, ay, az]
    e[:, 1] = vid[1, ax + 1, ay, az]
    e[:, 2] = vid[0, ax, ay + 1, az]
    e[:, 3] = vid[1, ax, ay, az]
    e[:, 4] = vid[0, ax, ay, az + 1]
    e[:, 5] = vid[1, ax + 1, ay, az + 1]
    e[:, 6] = vid[0, ax, ay + 1, az + 1]
    e[:, 7] = vid[1, ax, ay, az + 1]
    e[:, 8] = vid[2, ax, ay, az]
    e[:, 9] = vid[2, ax + 1, ay, az]
    e[:, 10] = vid[2, ax + 1, ay + 1, az]
    e[:, 11] = vid[2, ax, ay + 1, az]

    tri = TRIANGLE_TABLE[m].astype(np.int64)          # (K, 16)
    tri15 = tri[:, :15].reshape(-1, 5, 3)             # (K, 5, 3)
    valid = tri15[:, :, 0] >= 0                       # (K, 5)
    kk, tt = np.nonzero(valid)
    F = np.take_along_axis(e[kk], tri15[kk, tt], axis=1)
    return V, F


def _volume_gradient(vol: np.ndarray, spacing: float) -> np.ndarray:
    gx, gy, gz = np.gradient(vol, spacing)
    return np.stack([gx, gy, gz], axis=-1)
