"""ctypes binding of the repo's native BVH (`native/raycast.cc`): the
point-to-mesh distance that Chamfer needs and the closest-hit ray queries
of albedo scaling (port of `RayCaster` in `rnb_neus2_tpu/io/raycast.py`).

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
    lib.rc_closest_hits.restype = None
    lib.rc_closest_hits.argtypes = [ptr, ptr, ptr, i64, ptr, ptr]
    lib.rc_closest_points.restype = None
    lib.rc_closest_points.argtypes = [ptr, ptr, i64, ptr, ptr]
    lib.rc_inside.restype = None
    lib.rc_inside.argtypes = [ptr, ptr, i64, ptr]
    lib.rc_free.restype = None
    lib.rc_free.argtypes = [ptr]
    return lib


class RayCaster:
    """A BVH over a triangle mesh (V (n, 3), F (m, 3)) for ray and point
    queries."""

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

    def closest_hits(self, origins: np.ndarray, dirs: np.ndarray):
        """(t (R,), tri (R,)): the nearest hit along each ray; t = inf and
        tri = −1 on a miss."""
        origins = np.ascontiguousarray(origins, np.float32)
        dirs = np.ascontiguousarray(dirs, np.float32)
        n = len(origins)
        t = np.empty(n, np.float32)
        tri = np.empty(n, np.int32)
        self._lib.rc_closest_hits(
            self._handle, origins.ctypes.data_as(ctypes.c_void_p),
            dirs.ctypes.data_as(ctypes.c_void_p), n,
            t.ctypes.data_as(ctypes.c_void_p),
            tri.ctypes.data_as(ctypes.c_void_p))
        return t, tri

    def hits(self, origins, dirs):
        """(hit (R,), hit points (R, 3), t (R,)); points are 0 on a miss."""
        t, tri = self.closest_hits(origins, dirs)
        hit = tri >= 0
        locs = origins + t[:, None] * dirs
        return hit, np.where(hit[:, None], locs, 0.0), t

    def occluded_within(self, origins, dirs, max_dist) -> np.ndarray:
        """True where a hit lies closer than max_dist (a shadow query)."""
        t, tri = self.closest_hits(origins, dirs)
        return (tri >= 0) & (t < max_dist)

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
