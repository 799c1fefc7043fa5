"""Mesh postprocessing: keep the largest connected component by area (port
of `rnb_neus2_tpu/mesh/postprocess.py`).

Replaces the reference pipeline's trimesh step (rnb_neus2/pipeline.py:
178-219: split(only_watertight=False) → max component by area →
fix_normals → export). Vertices are connected when they share a face;
`scipy.sparse.csgraph.connected_components` gives the partition that the
JAX package's union-find loop over every face gives, in milliseconds at
the pipeline's 1.25M vertices. The extraction already orients faces from
the SDF gradient, which covers fix_normals' job.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components


def _vertex_components(n_verts: int, faces: np.ndarray) -> np.ndarray:
    """A component label per vertex; a vertex in no face is alone."""
    faces = np.asarray(faces, np.int64)
    rows = np.concatenate([faces[:, 0], faces[:, 1]])
    cols = np.concatenate([faces[:, 1], faces[:, 2]])
    graph = coo_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                       shape=(n_verts, n_verts))
    return connected_components(graph, directed=False)[1]


def largest_component(V: np.ndarray, F: np.ndarray,
                      N: np.ndarray | None = None,
                      C: np.ndarray | None = None):
    """Keep the component with the largest surface area."""
    if len(F) == 0:
        return V, F, N, C
    comp = _vertex_components(len(V), F)
    tri = V[F]
    area = 0.5 * np.linalg.norm(
        np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    face_comp = comp[F[:, 0]]
    comps, inv = np.unique(face_comp, return_inverse=True)
    areas = np.bincount(inv, weights=area)
    keep_comp = comps[np.argmax(areas)]
    keep_faces = F[face_comp == keep_comp]

    used = np.unique(keep_faces.ravel())
    remap = np.full(len(V), -1, np.int64)
    remap[used] = np.arange(len(used))
    V2 = V[used]
    F2 = remap[keep_faces]
    N2 = N[used] if N is not None else None
    C2 = C[used] if C is not None else None
    return V2, F2, N2, C2
