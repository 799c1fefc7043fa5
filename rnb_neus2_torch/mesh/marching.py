"""Table-based marching cubes on a numpy volume (port of
`rnb_neus2_tpu/mesh/marching.py`: `marching_cubes_grid`, `marching_tets`
and the volume gradients).

`marching_cubes_grid` is vectorized 256-case table marching cubes with
topology parity to the reference's CUDA kernels
(src/marching_cubes.cu:276-430, 660-718, 794-822): a vertex on every
sign-change grid edge at the linear zero crossing, the Bourke triangle
table (mc_tables.py), the table's winding. It is the host backend of
`extract_mesh` and the oracle that `marching_device.marching_cubes_device`
is held to. `marching_tets` is the legacy round-1 extractor: a 6-tet
cube split, watertight but with about twice the triangles and another
topology, kept for comparison.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .mc_tables import TRIANGLE_TABLE

# 6-tetrahedron decomposition of the unit cube around the main diagonal
# (0,0,0)-(1,1,1); corners indexed bit-wise (x | y<<1 | z<<2).
_TETS = np.array([
    [0, 5, 1, 3],
    [0, 5, 3, 7],
    [0, 5, 7, 4],
    [0, 7, 3, 2],
    [0, 7, 2, 6],
    [0, 7, 6, 4],
], np.int32)

_CUBE_CORNERS = np.array([[i & 1, (i >> 1) & 1, (i >> 2) & 1]
                          for i in range(8)], np.int32)


def _tet_triangles(inside: np.ndarray):
    """Case analysis for one tet: inside (M, 4) bool → list of triangles as
    (M', 3, 2) pairs of LOCAL tet-vertex indices (edges), plus row index.

    Derivation: an iso-crossing edge connects an inside and an outside
    vertex. 1-inside → 3 crossing edges → 1 triangle. 2-inside → 4 crossing
    edges → quad → 2 triangles (split consistently along (in0-out0,
    in1-out1)). 3-inside = complement of 1-inside.
    """
    tris = []       # (rows, 3 edges) where edge = (vin, vout)
    rows_all = []
    code = (inside.astype(np.int32)
            * np.array([1, 2, 4, 8], np.int32)).sum(axis=1)
    for case in range(1, 15):
        rows = np.nonzero(code == case)[0]
        if rows.size == 0:
            continue
        ins = [v for v in range(4) if case & (1 << v)]
        outs = [v for v in range(4) if not case & (1 << v)]
        if len(ins) == 1:
            a = ins[0]
            t = [[(a, outs[0]), (a, outs[1]), (a, outs[2])]]
        elif len(ins) == 3:
            a = outs[0]
            t = [[(ins[0], a), (ins[1], a), (ins[2], a)]]
        else:  # 2 in, 2 out: quad over (i0,o0),(i0,o1),(i1,o1),(i1,o0)
            i0, i1 = ins
            o0, o1 = outs
            t = [[(i0, o0), (i0, o1), (i1, o1)],
                 [(i0, o0), (i1, o1), (i1, o0)]]
        for tri in t:
            tris.append(np.asarray(tri, np.int32))
            rows_all.append(rows)
    return tris, rows_all


def marching_tets(vol: np.ndarray, origin: np.ndarray, spacing: float,
                  thresh: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """vol: (X, Y, Z) SDF samples; returns (vertices (V,3), faces (F,3)).

    Vertices are positioned by linear interpolation along crossing edges;
    faces oriented so normals point toward positive SDF (outside).
    """
    X, Y, Z = vol.shape
    if min(X, Y, Z) < 2:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    inside_grid = vol < thresh
    # global vertex ids of cube corners per cell: (X-1,Y-1,Z-1) cells
    gx, gy, gz = np.meshgrid(np.arange(X - 1), np.arange(Y - 1),
                             np.arange(Z - 1), indexing="ij")
    base = (gx * Y + gy) * Z + gz              # id of corner (0,0,0)
    base = base.ravel()
    corner_off = (_CUBE_CORNERS[:, 0] * Y + _CUBE_CORNERS[:, 1]) * Z \
        + _CUBE_CORNERS[:, 2]                  # (8,)

    flat_inside = inside_grid.ravel()
    vol_flat = vol.ravel().astype(np.float64)

    edges_acc = []
    for tet in _TETS:
        vid = base[:, None] + corner_off[tet][None, :]      # (C, 4)
        ins = flat_inside[vid]                              # (C, 4)
        n_in = ins.sum(axis=1)
        active = (n_in > 0) & (n_in < 4)
        vid_a = vid[active]
        tris, rows = _tet_triangles(ins[active])
        for tri, rr in zip(tris, rows):
            # tri: (3, 2) local indices; rr: rows of vid_a
            tv = vid_a[rr][:, tri.reshape(-1)].reshape(-1, 3, 2)
            edges_acc.append(tv)
    if not edges_acc:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    tri_edges = np.concatenate(edges_acc, axis=0)           # (F, 3, 2)
    e0 = np.minimum(tri_edges[..., 0], tri_edges[..., 1])
    e1 = np.maximum(tri_edges[..., 0], tri_edges[..., 1])
    ekey = e0.astype(np.int64) * (X * Y * Z) + e1
    uniq, inv = np.unique(ekey.ravel(), return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int64)

    # vertex positions by interpolation on unique edges
    ua = (uniq // (X * Y * Z)).astype(np.int64)
    ub = (uniq % (X * Y * Z)).astype(np.int64)
    va, vb = vol_flat[ua], vol_flat[ub]
    t = (thresh - va) / np.where(vb - va == 0, 1.0, vb - va)
    t = np.clip(t, 0.0, 1.0)

    def unflat(i):
        z = i % Z
        y = (i // Z) % Y
        x = i // (Z * Y)
        return np.stack([x, y, z], axis=1).astype(np.float64)

    pa, pb = unflat(ua), unflat(ub)
    verts = pa + t[:, None] * (pb - pa)
    verts = origin[None, :] + verts * spacing

    # drop degenerate faces (repeated vertices)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    faces = faces[good]

    # orient: normal should point toward +SDF. Use the SDF numeric gradient
    # at the triangle centroid (cheap central differences on the volume).
    tri_v = verts[faces]
    n = np.cross(tri_v[:, 1] - tri_v[:, 0], tri_v[:, 2] - tri_v[:, 0])
    cent = tri_v.mean(axis=1)
    g = _volume_gradient_at(vol, origin, spacing, cent)
    flip = (n * g).sum(axis=1) < 0
    faces[flip] = faces[flip][:, ::-1]
    return verts.astype(np.float32), faces


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
