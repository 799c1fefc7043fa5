"""Camera paths: keyframed fly-throughs with smooth interpolation (port of
`rnb_neus2_tpu/render/camera_path.py`; the reference's CameraPath,
src/camera_path.cu and camera_path.h).

Keyframes hold a rotation quaternion (x, y, z, w, Eigen's coefficient
order), a translation and the slice/scale/fov/dof scalars. Playback
evaluates a uniform cubic B-spline over 4 neighbouring keyframes
(camera_path.cu:50-69, the reference's live branch; its Catmull-Rom
branch is dead `if (0)` code), aligning quaternion signs for the short
path (camera_path.cu:35-37). JSON save/load keeps the reference's
{time, path: [{R, T, slice, scale, fov, dof}]} layout
(camera_path.cu:71-133), so either package reads the other's files.
"""

from __future__ import annotations

import dataclasses
import json
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class CameraKeyframe:
    """camera_path.h:30-66. R is a quaternion (x, y, z, w)."""
    R: np.ndarray                  # (4,)
    T: np.ndarray                  # (3,)
    slice: float = 0.0
    scale: float = 1.0
    fov: float = 50.0
    dof: float = 0.0

    @classmethod
    def from_matrix(cls, m: np.ndarray, slice=0.0, scale=1.0, fov=50.0,
                    dof=0.0) -> "CameraKeyframe":
        """3x4 camera-to-world → keyframe (camera_path.h:53)."""
        return cls(_mat_to_quat(np.asarray(m)[:3, :3]),
                   np.asarray(m)[:3, 3].astype(np.float32),
                   slice, scale, fov, dof)

    def m(self) -> np.ndarray:
        """Keyframe → 3x4 camera-to-world (camera_path.h:37-42)."""
        out = np.zeros((3, 4), np.float32)
        out[:3, :3] = _quat_to_mat(self.R / np.linalg.norm(self.R))
        out[:3, 3] = self.T
        return out

    def scaled(self, f: float) -> "CameraKeyframe":
        return CameraKeyframe(self.R * f, self.T * f, self.slice * f,
                              self.scale * f, self.fov * f, self.dof * f)

    def added(self, o: "CameraKeyframe") -> "CameraKeyframe":
        # quaternion sign alignment: take the short path (camera_path.h:60)
        Ro = o.R if float(np.dot(self.R, o.R)) >= 0 else -o.R
        return CameraKeyframe(self.R + Ro, self.T + o.T,
                              self.slice + o.slice, self.scale + o.scale,
                              self.fov + o.fov, self.dof + o.dof)


def _quat_to_mat(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def _mat_to_quat(m: np.ndarray) -> np.ndarray:
    """Rotation matrix → quaternion (x, y, z, w), Shepperd's method."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return np.array([x, y, z, w], np.float32)


def spline(t: float, p0: CameraKeyframe, p1: CameraKeyframe,
           p2: CameraKeyframe, p3: CameraKeyframe) -> CameraKeyframe:
    """Uniform cubic B-spline blend of 4 keyframes (camera_path.cu:59-68):
    it smooths the control keyframes and passes through none of them, as
    the reference's live branch does."""
    tt = t * t
    ttt = tt * t
    a = (1 - t) ** 3 / 6.0
    b = (3 * ttt - 6 * tt + 4) / 6.0
    c = (-3 * ttt + 3 * tt + 3 * t + 1) / 6.0
    d = ttt / 6.0
    return p0.scaled(a).added(p1.scaled(b)).added(p2.scaled(c)) \
        .added(p3.scaled(d))


class CameraPath:
    """Keyframe list and playback (camera_path.h:69-94)."""

    def __init__(self, keyframes: Sequence[CameraKeyframe] = ()):
        self.keyframes: List[CameraKeyframe] = list(keyframes)
        self.play_time = 0.0

    def eval(self, t: float) -> CameraKeyframe:
        """The path at t ∈ [0, 1]: keyframes playtime·n − 1 … + 2 with
        clamped indices (camera_path.h:75-82)."""
        kfs = self.keyframes
        if not kfs:
            raise ValueError("empty camera path")
        if len(kfs) == 1:
            return kfs[0]
        n = len(kfs) - 1
        x = min(max(t, 0.0), 1.0) * n
        i = min(int(x), n - 1)
        u = x - i
        get = lambda j: kfs[min(max(j, 0), len(kfs) - 1)]
        return spline(u, get(i - 1), get(i), get(i + 1), get(i + 2))

    def frames(self, n_frames: int) -> List[np.ndarray]:
        """n_frames 3x4 camera-to-world matrices evenly spaced along the
        path."""
        if n_frames == 1:
            return [self.eval(0.0).m()]
        return [self.eval(i / (n_frames - 1)).m() for i in range(n_frames)]

    # ---- JSON (camera_path.cu:71-133) -------------------------------------

    def save(self, path: str):
        data = {
            "time": self.play_time,
            "path": [{
                "R": [float(v) for v in k.R],
                "T": [float(v) for v in k.T],
                "slice": k.slice, "scale": k.scale,
                "fov": k.fov, "dof": k.dof,
            } for k in self.keyframes],
        }
        with open(path, "w") as f:
            json.dump(data, f, indent=2)

    @classmethod
    def load(cls, path: str) -> "CameraPath":
        with open(path) as f:
            data = json.load(f)
        out = cls([CameraKeyframe(
            np.asarray(k["R"], np.float32), np.asarray(k["T"], np.float32),
            float(k.get("slice", 0.0)), float(k.get("scale", 1.0)),
            float(k.get("fov", 50.0)), float(k.get("dof", 0.0)))
            for k in data["path"]])
        out.play_time = float(data.get("time", 0.0))
        return out
