"""OBJ / PLY mesh writers (port of `rnb_neus2_tpu/mesh/writer.py`, byte
for byte; reference: marching_cubes.cu:879-1000).

OBJ: `v x y z [r g b]` lines (colors appended to positions like the
reference), `vn` normals, `f` 1-based indices. PLY: ascii with uchar colors.
"""

from __future__ import annotations

import os

import numpy as np


def save_mesh(path, V, F, N=None, C=None) -> None:
    path = str(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if path.endswith(".ply"):
        _save_ply(path, V, F, N, C)
    else:
        _save_obj(path, V, F, N, C)


def _save_obj(path, V, F, N, C):
    with open(path, "w") as f:
        if C is not None:
            for p, c in zip(V, C):
                f.write("v %0.5f %0.5f %0.5f %0.3f %0.3f %0.3f\n"
                        % (p[0], p[1], p[2],
                           min(max(c[0], 0), 1), min(max(c[1], 0), 1),
                           min(max(c[2], 0), 1)))
        else:
            for p in V:
                f.write("v %0.5f %0.5f %0.5f\n" % (p[0], p[1], p[2]))
        if N is not None:
            for n in N:
                f.write("vn %0.5f %0.5f %0.5f\n" % (n[0], n[1], n[2]))
        if N is not None:
            for a, b, c in F + 1:
                f.write(f"f {a}//{a} {b}//{b} {c}//{c}\n")
        else:
            for a, b, c in F + 1:
                f.write(f"f {a} {b} {c}\n")


def _save_ply(path, V, F, N, C):
    have_c = C is not None
    have_n = N is not None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(V)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if have_n:
            f.write("property float nx\nproperty float ny\nproperty float nz\n")
        if have_c:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        f.write(f"element face {len(F)}\n")
        f.write("property list uchar int vertex_index\nend_header\n")
        for i, p in enumerate(V):
            row = [f"{p[0]:.5f}", f"{p[1]:.5f}", f"{p[2]:.5f}"]
            if have_n:
                n = N[i]
                row += [f"{n[0]:.3f}", f"{n[1]:.3f}", f"{n[2]:.3f}"]
            if have_c:
                c = np.clip(C[i] * 255.0, 0, 255).astype(int)
                row += [str(c[0]), str(c[1]), str(c[2])]
            f.write(" ".join(row) + "\n")
        for a, b, c in F:
            f.write(f"3 {a} {b} {c}\n")


def load_obj(path):
    """Minimal OBJ reader (verts + faces) for tests and postprocessing."""
    V, F = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                V.append([float(x) for x in parts[1:4]])
            elif line.startswith("f "):
                idx = [p.split("/")[0] for p in line.split()[1:4]]
                F.append([int(i) - 1 for i in idx])
    return np.asarray(V, np.float32), np.asarray(F, np.int64)
