"""ctypes binding of the repo's native BVH (`native/raycast.cc`) for the
point-to-mesh distance that Chamfer needs (port of `RayCaster` and its
`signed_distance` in `rnb_neus2_tpu/io/raycast.py`).

The library builds at first use with `g++ -O3 -fopenmp -shared -fPIC`
into `build/rnb_neus2_torch/<hash>/libraycast.so` (`kernels/build.py`);
nothing is written beside the source. A failed build raises: there is no
brute-force fallback.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from ..kernels.build import REPO, load_host_library

SOURCE = REPO / "native" / "raycast.cc"
LIBRARY = "raycast"


@functools.lru_cache(maxsize=None)
def _library():
    lib, _ = load_host_library(LIBRARY, SOURCE)
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.rc_build.restype = ptr
    lib.rc_build.argtypes = [ptr, i64, ptr, i64]
    lib.rc_closest_points.restype = None
    lib.rc_closest_points.argtypes = [ptr, ptr, i64, ptr, ptr]
    lib.rc_inside.restype = None
    lib.rc_inside.argtypes = [ptr, ptr, i64, ptr]
    lib.rc_free.restype = None
    lib.rc_free.argtypes = [ptr]
    return lib


class RayCaster:
    """A BVH over a triangle mesh (V (n, 3), F (m, 3)) for point queries."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        self.V = np.ascontiguousarray(vertices, np.float32)
        self.F = np.ascontiguousarray(faces, np.int32)
        if not len(self.F):
            raise ValueError("RayCaster needs a mesh with faces")
        self._lib = _library()
        self._handle = self._lib.rc_build(
            self.V.ctypes.data_as(ctypes.c_void_p), len(self.V),
            self.F.ctypes.data_as(ctypes.c_void_p), len(self.F))

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.rc_free(self._handle)
            self._handle = None

    def signed_distance(self, points: np.ndarray) -> np.ndarray:
        """Point-to-mesh signed distance: the unsigned closest-point
        distance, signed by ray-stab parity (the reference TriangleBvh's
        raystab mode, src/triangle_bvh.cu:147)."""
        points = np.ascontiguousarray(points, np.float32)
        n = len(points)
        d = np.empty(n, np.float32)
        tri = np.empty(n, np.int32)
        inside = np.empty(n, np.int32)
        p = points.ctypes.data_as(ctypes.c_void_p)
        self._lib.rc_closest_points(self._handle, p, n,
                                    d.ctypes.data_as(ctypes.c_void_p),
                                    tri.ctypes.data_as(ctypes.c_void_p))
        self._lib.rc_inside(self._handle, p, n,
                            inside.ctypes.data_as(ctypes.c_void_p))
        return np.where(inside > 0, -d, d)
