"""Mesh accuracy metrics: Chamfer-L1/L2 between meshes (port of
`rnb_neus2_tpu/mesh/metrics.py`).

Uniform area-weighted surface sampling and BVH closest-point queries in
both directions (`io/raycast.py`, the repo's `native/raycast.cc`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..io.raycast import RayCaster


def sample_surface(V: np.ndarray, F: np.ndarray, n: int,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Area-weighted uniform surface samples (n, 3)."""
    rng = rng or np.random.default_rng(0)
    tri = V[F]
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    p = area / area.sum()
    fi = rng.choice(len(F), n, p=p)
    u = rng.random((n, 2))
    flip = u.sum(1) > 1
    u[flip] = 1 - u[flip]
    t = tri[fi]
    return (t[:, 0] + u[:, :1] * (t[:, 1] - t[:, 0])
            + u[:, 1:] * (t[:, 2] - t[:, 0])).astype(np.float32)


def point_to_mesh_distances(points: np.ndarray, V: np.ndarray,
                            F: np.ndarray) -> np.ndarray:
    rc = RayCaster(V, F)
    return np.abs(rc.signed_distance(points))


def chamfer_distance(V1, F1, V2, F2, n_samples: int = 100_000,
                     seed: int = 0) -> dict:
    """Symmetric Chamfer between two meshes.

    Returns {"chamfer_l1", "chamfer_l2", "accuracy", "completeness"}:
    accuracy = mean dist from mesh1 samples to mesh2 (reconstruction → GT),
    completeness = the reverse; chamfer_l1 = their mean.
    """
    rng = np.random.default_rng(seed)
    p1 = sample_surface(V1, F1, n_samples, rng)
    p2 = sample_surface(V2, F2, n_samples, rng)
    d12 = point_to_mesh_distances(p1, V2, F2)
    d21 = point_to_mesh_distances(p2, V1, F1)
    return {
        "accuracy": float(d12.mean()),
        "completeness": float(d21.mean()),
        "chamfer_l1": float(0.5 * (d12.mean() + d21.mean())),
        "chamfer_l2": float(0.5 * ((d12 ** 2).mean()
                                   + (d21 ** 2).mean())),
    }
