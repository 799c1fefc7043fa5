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

`marching_cubes_device_slabbed` (JAX `marching_cubes_device_slabbed`)
gives the same output with only one slab's grids alive at a time, for a
volume whose one-shot grids would not fit the card (`extract.py` picks
it).
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


def _grids(sv: torch.Tensor, thresh: float, n_own: int):
    """The sign-change edges of a slab of planes sv (P, Y, Z), their
    inclusive ranks per axis, the corner masks of its P−1 cell planes, and
    on the device the counts [n0, n1, n2, active cells, triangles]: the
    axis-1 and axis-2 edges of its first `n_own` planes only (the next
    slab owns the last plane's)."""
    inside = sv > thresh
    hits = [inside[:-1] != inside[1:], inside[:, :-1] != inside[:, 1:],
            inside[:, :, :-1] != inside[:, :, 1:]]
    ids = [h.to(torch.int32).view(-1).cumsum_(0).view(h.shape)
           for h in hits]
    m = _corner_mask(inside)
    del inside
    active = (m > 0) & (m < 255)
    tri_count = torch.as_tensor(_TRI_COUNT, dtype=torch.int32,
                                device=sv.device)
    m_flat = m.view(-1)
    n_tri = sum(tri_count[m_flat[s:s + _COUNT_CHUNK].to(torch.int32)]
                .sum(dtype=torch.int64)
                for s in range(0, m_flat.numel(), _COUNT_CHUNK))
    own = [ids[0].view(-1)[-1]] + [
        ids[a][:n_own].reshape(-1)[-1] if n_own else ids[a].new_zeros(())
        for a in (1, 2)]
    counts = torch.stack([c.long() for c in own]
                         + [active.sum(dtype=torch.int64), n_tri])
    return {"hits": hits, "ids": ids, "m": m, "active": active,
            "counts": counts}


def _emit(sv, thresh, grids, counts, bases, x0: int, n_own: int):
    """Vertices (grid coordinates, x shifted by `x0`, float64) of the
    slab's own edges and the faces of its cells with global vertex ids:
    the ids of axis a are bases[a] + rank, which for the axis-1 and axis-2
    edges of the slab's last plane is the next slab's id, since its base is
    this slab's base plus this slab's own count. Drops `grids`' edge
    masks once the vertices are out."""
    hits = grids.pop("hits")
    ids, m, active = grids["ids"], grids["m"], grids["active"]
    n0, n1, n2, n_cells, n_faces = counts
    dev = sv.device
    _, Y, Z = sv.shape
    steps = ((1, 0, 0), (0, 1, 0), (0, 0, 1))

    # ---- vertices: linear zero crossing on each crossing edge ----------
    verts = []
    for axis, n_a in enumerate((n0, n1, n2)):
        h = hits[axis] if axis == 0 else hits[axis][:n_own]
        e = torch.nonzero_static(h.reshape(-1), size=n_a)[:, 0]
        _, Ya, Za = h.shape
        p = torch.stack([e // (Ya * Za), (e // Za) % Ya, e % Za], dim=1)
        q = p + torch.as_tensor(steps[axis], device=dev)
        f0 = sv[p[:, 0], p[:, 1], p[:, 2]]
        f1 = sv[q[:, 0], q[:, 1], q[:, 2]]
        dt = (thresh - f0) / (f1 - f0)
        pf = p.to(torch.float64)
        pf[:, axis] += dt.to(torch.float64)
        pf[:, 0] += x0
        verts.append(pf)
    del hits, h
    V = torch.cat(verts)
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
    tri_count = torch.as_tensor(_TRI_COUNT, dtype=torch.int32, device=dev)
    mk = m.view(-1)[cells].long()
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


def _to_world(V: torch.Tensor, origin, spacing: float) -> torch.Tensor:
    return (V * spacing + torch.as_tensor(origin, dtype=torch.float64,
                                          device=V.device)
            ).to(torch.float32)


def marching_cubes_device(vol: torch.Tensor, origin, spacing: float,
                          thresh: float = 0.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """vol (X, Y, Z) float32 tensor → (V (n, 3) float32, F (m, 3) int64) on
    its device: the vertices and faces of `marching_cubes_grid` on the
    same volume, in the same order."""
    vol = vol.to(torch.float32)
    grids = _grids(vol, thresh, vol.shape[0])
    counts = grids["counts"].tolist()                  # the one host read
    n0, n1 = counts[:2]
    V, F = _emit(vol, thresh, grids, counts, (0, n0, n0 + n1), 0,
                 vol.shape[0])
    return _to_world(V, origin, spacing), F


def marching_cubes_device_slabbed(vol: torch.Tensor, origin, spacing: float,
                                  thresh: float = 0.0, n_slabs: int = 8
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`marching_cubes_device` slab by slab along x (JAX
    `marching_cubes_device_slabbed`): the same vertices and faces in the
    same order, with the edge-id grids of one slab of (X−1)/n_slabs cell
    planes alive at a time instead of the whole volume's.

    Slab s owns the cells and the axis-0 edges of x ∈ [s·sc, (s+1)·sc) and
    the axis-1/2 edges of those planes (the last slab also plane X−1).
    Each axis's ids are raster order, so a slab's own edges are one
    contiguous range and a global id is the slab's base plus its rank.
    Pass 1 counts every slab (one host read); pass 2 rebuilds each slab's
    grids and emits its vertices and faces."""
    vol = vol.to(torch.float32)
    X = vol.shape[0]
    if (X - 1) % n_slabs:
        raise ValueError(f"X-1={X - 1} not divisible by n_slabs={n_slabs}")
    sc = (X - 1) // n_slabs

    def slab(s):
        last = s == n_slabs - 1
        return vol[s * sc:(s + 1) * sc + 1], sc + 1 if last else sc

    rows = []
    for s in range(n_slabs):
        sv, n_own = slab(s)
        rows.append(_grids(sv, thresh, n_own)["counts"])
    rows = torch.stack(rows).cpu().numpy()             # the one host read
    tot = rows[:, :3].sum(axis=0)
    pre = np.concatenate([np.zeros((1, 3), np.int64),
                          np.cumsum(rows[:, :3], axis=0)])
    offset = np.array([0, tot[0], tot[0] + tot[1]])
    Vs, Fs = [], []
    for s in range(n_slabs):
        sv, n_own = slab(s)
        grids = _grids(sv, thresh, n_own)
        V, F = _emit(sv, thresh, grids, rows[s].tolist(),
                     (offset + pre[s]).tolist(), s * sc, n_own)
        del grids
        Vs.append(V)
        Fs.append(F)
    # the slabs' vertices are one range per axis each: axis by axis, slab
    # by slab
    n_ax = rows[:, :3]
    parts = [V.split(n_ax[s].tolist()) for s, V in enumerate(Vs)]
    V = torch.cat([parts[s][a] for a in range(3) for s in range(n_slabs)])
    return _to_world(V, origin, spacing), torch.cat(Fs)
