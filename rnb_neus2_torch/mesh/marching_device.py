"""Table-based marching cubes on the volume's device (port of
`marching_cubes_device` in `rnb_neus2_tpu/mesh/marching_device.py`).

The same algorithm as the numpy `marching.marching_cubes_grid`, in
PyTorch on the tensor's device (the reference triangulates on the GPU,
src/marching_cubes.cu:794-822, gen_vertices/gen_faces :276-430):

- one vertex per sign-change grid edge at the linear zero crossing, ids
  in axis-major raster order (x-edges, then y, then z) by
  `cumsum(hit) − 1` — the numpy version's and the CUDA vertidx_grid's
  layout, so outputs compare element for element;
- the active cells (0 < 8-corner mask < 255) compacted in raster order;
- per active cell the 12 edge ids in gen_faces' local edge order
  (marching_cubes.cu:690-703) and ≤ 5 triangles from the Bourke table at
  an exclusive cumsum of the per-cell triangle counts.

The edge-id grids stay int32 (each axis has at most 1024·1025² < 2^31
edges at the 1024 export), so three of them take 12·res³ bytes: 12.9 GB
at 1024³ beside the 4.3 GB volume. The counts come to the host in one
read; every compaction after it is sized from that read
(`nonzero_static`, `repeat_interleave(output_size=…)`), so no other step
waits for the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .mc_tables import TRIANGLE_TABLE

# triangles per cube case (0..5)
_TRI_COUNT = np.sum(TRIANGLE_TABLE[:, :15].reshape(256, 5, 3)[:, :, 0] >= 0,
                    axis=1)
# cells per chunk when the triangle count is summed over the grid
_COUNT_CHUNK = 1 << 26


def _corner_mask(inside: torch.Tensor) -> torch.Tensor:
    """(X, Y, Z) bool → (X−1, Y−1, Z−1) uint8 cube-corner mask (bit order
    marching_cubes.cu:675-683)."""
    corners = (inside[:-1, :-1, :-1], inside[1:, :-1, :-1],
               inside[1:, 1:, :-1], inside[:-1, 1:, :-1],
               inside[:-1, :-1, 1:], inside[1:, :-1, 1:],
               inside[1:, 1:, 1:], inside[:-1, 1:, 1:])
    m = corners[0].to(torch.uint8)
    for bit, c in enumerate(corners[1:], start=1):
        m |= c.to(torch.uint8) << bit
    return m


def marching_cubes_device(vol: torch.Tensor, origin, spacing: float,
                          thresh: float = 0.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """vol (X, Y, Z) float32 tensor → (V (n, 3) float32, F (m, 3) int64) on
    its device: the vertices and faces of `marching_cubes_grid` on the
    same volume, in the same order."""
    vol = vol.to(torch.float32)
    dev = vol.device
    X, Y, Z = vol.shape
    inside = vol > thresh
    steps = ((1, 0, 0), (0, 1, 0), (0, 0, 1))
    hits = [inside[:-1] != inside[1:], inside[:, :-1] != inside[:, 1:],
            inside[:, :, :-1] != inside[:, :, 1:]]
    # inclusive ranks: ids[a][e] − 1 is the id of crossing edge e in axis a
    ids = [h.to(torch.int32).view(-1).cumsum_(0).view(h.shape)
           for h in hits]
    m = _corner_mask(inside)
    del inside
    active = (m > 0) & (m < 255)
    tri_count = torch.as_tensor(_TRI_COUNT, dtype=torch.int32, device=dev)
    m_flat = m.view(-1)
    n_tri = sum(tri_count[m_flat[s:s + _COUNT_CHUNK].to(torch.int32)]
                .sum(dtype=torch.int64)
                for s in range(0, m_flat.numel(), _COUNT_CHUNK))
    counts = torch.stack([ids[0].view(-1)[-1].long(),
                          ids[1].view(-1)[-1].long(),
                          ids[2].view(-1)[-1].long(),
                          active.sum(dtype=torch.int64), n_tri])
    n0, n1, n2, n_cells, n_faces = counts.tolist()     # the one host read
    bases = (0, n0, n0 + n1)

    # ---- vertices: linear zero crossing on each crossing edge ----------
    verts = []
    for axis, (h, n_a) in enumerate(zip(hits, (n0, n1, n2))):
        e = torch.nonzero_static(h.view(-1), size=n_a)[:, 0]
        _, Ya, Za = h.shape
        p = torch.stack([e // (Ya * Za), (e // Za) % Ya, e % Za], dim=1)
        q = p + torch.as_tensor(steps[axis], device=dev)
        f0 = vol[p[:, 0], p[:, 1], p[:, 2]]
        f1 = vol[q[:, 0], q[:, 1], q[:, 2]]
        dt = (thresh - f0) / (f1 - f0)
        pf = p.to(torch.float64)
        pf[:, axis] += dt.to(torch.float64)
        verts.append(pf)
    del hits
    V = (torch.cat(verts) * spacing
         + torch.as_tensor(origin, dtype=torch.float64, device=dev)
         ).to(torch.float32)
    if n_cells == 0:
        return V, torch.zeros((0, 3), dtype=torch.int64, device=dev)

    # ---- faces: active cells in raster order, ≤ 5 triangles each -------
    cells = torch.nonzero_static(active.view(-1), size=n_cells)[:, 0]
    cy, cz = Y - 1, Z - 1
    ax, ay, az = cells // (cy * cz), (cells // cz) % cy, cells % cz
    g0, g1, g2 = ((ids[a].view(-1), ids[a].shape, bases[a] - 1)
                  for a in range(3))

    def edge(g, x, y, z):
        flat, (_, Ya, Za), off = g
        return flat[(x * Ya + y) * Za + z].long() + off

    # local edge order of gen_faces (marching_cubes.cu:690-703)
    e = torch.stack([
        edge(g0, ax, ay, az), edge(g1, ax + 1, ay, az),
        edge(g0, ax, ay + 1, az), edge(g1, ax, ay, az),
        edge(g0, ax, ay, az + 1), edge(g1, ax + 1, ay, az + 1),
        edge(g0, ax, ay + 1, az + 1), edge(g1, ax, ay, az + 1),
        edge(g2, ax, ay, az), edge(g2, ax + 1, ay, az),
        edge(g2, ax + 1, ay + 1, az), edge(g2, ax, ay + 1, az)], dim=1)
    mk = m_flat[cells].long()
    ntri = tri_count[mk].long()
    tri_base = torch.cumsum(ntri, 0) - ntri                # exclusive
    kk = torch.repeat_interleave(
        torch.arange(n_cells, device=dev), ntri, output_size=n_faces)
    tt = torch.arange(n_faces, device=dev) - tri_base[kk]
    table = torch.as_tensor(TRIANGLE_TABLE, dtype=torch.int64,
                            device=dev).view(-1)
    row = mk[kk] * TRIANGLE_TABLE.shape[1] + 3 * tt
    F = torch.stack([e[kk, table[row + v]] for v in range(3)], dim=1)
    return V, F
