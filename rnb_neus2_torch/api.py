"""High-level Python API, the pyngp module's counterpart (port of
`rnb_neus2_tpu/api.py`; the reference's src/python_api.cu:219-616).

The reference exposes a pybind11 `Testbed`: construction by mode,
load_training_data, frame/train loops, render_to_cpu, snapshot save/load,
compute_marching_cubes_mesh → {V, N, C, F}, calculate_iou, screenshots,
n_params and the loss scalars. This module offers the same surface over
the PyTorch port, on the card unless `device="cpu"` asks for the CPU.

>>> import rnb_neus2_torch.api as ngp
>>> tb = ngp.Testbed(ngp.TestbedMode.Nerf)
>>> tb.load_training_data("scene_dir/")
>>> while tb.frame(): ...
>>> mesh = tb.compute_marching_cubes_mesh(resolution=(512,) * 3)

The Image, Sdf and Volume modes drive `models/extra_modes.py` through the
same verbs (`load_training_data`, `frame`/`train`, `render_to_cpu`,
`calculate_iou`, `training_step`, `loss`), as the JAX package's
`_ExtraModeDriver` does. A Nerf scene whose transform.json says another
`aabb_scale` than the configuration is refused (`check_scene`).
"""

from __future__ import annotations

import enum
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .device import resolve_device


class TestbedMode(enum.Enum):
    """ETestbedMode (common.h:153). The RNb pipeline uses Nerf."""

    Nerf = "nerf"
    Sdf = "sdf"
    Image = "image"
    Volume = "volume"


class _ExtraModeDriver:
    """Drives the Image, Sdf and Volume workloads (`models/extra_modes.py`)
    through the Testbed's verbs, as pyngp exposes every ETestbedMode
    through one class (python_api.cu:219-616, common.h:153)."""

    def __init__(self, mode: TestbedMode, device):
        from .models import extra_modes as em

        self.mode = mode
        self.field = {TestbedMode.Image: em.ImageField,
                      TestbedMode.Sdf: em.SdfField,
                      TestbedMode.Volume: em.VolumeField}[mode](
                          device=device)
        self.params = None
        self.state = None
        self.step = 0
        self.loss = 0.0
        self._data = None

    def load(self, source) -> None:
        """source: an image path or array (Image), an OBJ path or (V, F)
        (Sdf), a .npy path or a dense array (Volume), the per-mode
        dispatch of Testbed::load_training_data."""
        if self.mode == TestbedMode.Image:
            if isinstance(source, (str, os.PathLike)):
                from .io.image_io import load_image
                source = load_image(str(source))[..., :3]
            self._data = (np.asarray(source, np.float32),)
        elif self.mode == TestbedMode.Sdf:
            if isinstance(source, (str, os.PathLike)):
                from .mesh.writer import load_obj
                source = load_obj(str(source))
            self._data = (np.asarray(source[0], np.float32),
                          np.asarray(source[1]))
        else:
            if isinstance(source, (str, os.PathLike)):
                source = np.load(str(source))
            self._data = (np.asarray(source, np.float32),)

    def train(self, n_steps: int) -> None:
        if self._data is None:
            raise RuntimeError("load_training_data first")
        self.params, self.state, self.loss = self.field.fit(
            *self._data, n_steps=n_steps, seed=self.step,
            params=self.params, state=self.state, return_state=True)
        self.step += n_steps

    def render(self, W: int = 0, H: int = 0) -> np.ndarray:
        if self.params is None:
            raise RuntimeError("train first")
        if self.mode == TestbedMode.Image:
            img = self._data[0]
            return self.field.render(self.params, W or img.shape[1],
                                     H or img.shape[0])
        # Sdf: the sphere-traced BRDF shade (testbed_sdf.cu); Volume: the
        # ratio-tracked density (testbed_volume.cu)
        return self.field.render(self.params, W=W or 256, H=H or 256)


class Testbed:
    """Facade over `Trainer`, the renderer and mesh extraction, or over
    an extra mode's field (`_ExtraModeDriver`)."""

    def __init__(self, mode: TestbedMode = TestbedMode.Nerf,
                 config: Optional[object] = None, device=None):
        from .config import TestbedConfig

        self.mode = mode
        self.device = resolve_device(device)
        self.cfg = config or TestbedConfig()
        self.max_iter = self.cfg.train.max_steps
        self._trainer = None
        self._dataset = None
        self.shall_train = True
        self.background_color = (1.0, 1.0, 1.0, 1.0)
        # optional lat-long RGBA background texture (render/envmap.py,
        # the reference's envmap.cuh); None = constant background_color
        self.envmap: Optional[torch.Tensor] = None
        self._extra = (None if mode == TestbedMode.Nerf
                       else _ExtraModeDriver(mode, self.device))

    # -- data ----------------------------------------------------------------

    def load_training_data(self, source) -> None:
        if self._extra is not None:
            self._extra.load(source)
            return
        from .io.dataset import load_transform_json
        from .train.trainer import Trainer, check_scene

        dataset = load_transform_json(str(source), self.device)
        check_scene(dataset.meta, self.cfg)
        self._dataset = dataset
        self._trainer = Trainer(self._dataset, self.cfg, device=self.device)

    def set_camera_intrinsics(self, frame_idx: int, fx: float = 0.0,
                              fy: float = 0.0, cx: float = -0.5,
                              cy: float = -0.5, k1: float = 0.0,
                              k2: float = 0.0, p1: float = 0.0,
                              p2: float = 0.0) -> None:
        """Override one view's intrinsics and OpenCV distortion (pyngp
        Testbed.nerf.training.set_camera_intrinsics, python_api.cu:557-563
        → testbed_nerf.cu:2915-2930). As in the reference: a non-positive
        focal takes the other axis's, a negative cx/cy is an already
        normalized |cx|, and any non-zero coefficient turns the distortion
        on. An index outside the views changes nothing."""
        if self._dataset is None:
            raise RuntimeError("load_training_data first")
        cams = self._dataset.cameras
        n = cams.rot_c2w.shape[0]
        if not (0 <= frame_idx < n):
            return
        W, H = cams.resolution
        if fx <= 0.0:
            fx = fy
        if fy <= 0.0:
            fy = fx
        cx = -cx if cx < 0.0 else cx / W
        cy = -cy if cy < 0.0 else cy / H
        focal = cams.focal.clone()
        pp = cams.principal.clone()
        focal[frame_idx] = torch.tensor((fx, fy))
        pp[frame_idx] = torch.tensor((cx, cy))
        dist = (cams.distortion.clone() if cams.distortion is not None
                else torch.zeros((n, 4), device=focal.device))
        dist[frame_idx] = torch.tensor((k1, k2, p1, p2))
        self._dataset.cameras = cams._replace(
            focal=focal, principal=pp,
            distortion=dist if bool(dist.any()) else None)
        if self._trainer is not None:
            # the port compiles nothing: the trainer reads the dataset's
            # cameras on every step
            self._trainer.dataset = self._dataset

    def reload_network_from_file(self, path: str = "") -> None:
        from .config import TestbedConfig
        from .train.trainer import Trainer

        if path:
            self.cfg = TestbedConfig.from_network_json(path)
        if self._dataset is not None:
            self._trainer = Trainer(self._dataset, self.cfg,
                                    device=self.device)

    # -- training --------------------------------------------------------------

    def frame(self) -> bool:
        """One training step; False once max_iter is reached
        (Testbed::frame, testbed.cu:1826-1919)."""
        if not self.shall_train or self.training_step >= self.max_iter:
            return False
        self.train(1)
        return True

    def train(self, n_steps: int) -> None:
        if self._extra is not None:
            self._extra.train(n_steps)
            return
        for _ in range(n_steps):
            self._trainer.train_step()

    @property
    def training_step(self) -> int:
        if self._extra is not None:
            return self._extra.step
        return self._trainer.step if self._trainer else 0

    @property
    def loss(self) -> float:
        if self._extra is not None:
            return self._extra.loss
        return self._trainer.loss_ema.value if self._trainer else 0.0

    @property
    def ek_loss(self) -> float:
        return self._trainer.ek_ema.value if self._trainer else 0.0

    @property
    def mask_loss(self) -> float:
        return self._trainer.mask_ema.value if self._trainer else 0.0

    def n_params(self) -> int:
        return sum(p.numel() for p in self._trainer.params.values())

    def set_max_iter(self, n: int) -> None:
        self.max_iter = n

    # -- rendering ---------------------------------------------------------------

    def render_to_cpu(self, view_idx: int = 0, max_samples: int = 256,
                      W: int = 0, H: int = 0) -> np.ndarray:
        """Render a training view → (H, W, 4) float RGBA. W and H set the
        size of an extra mode's frame (pyngp render(width, height))."""
        if self._extra is not None:
            return self._extra.render(W, H)
        from .render.renderer import render_view

        out = render_view(self._trainer.field,
                          self._trainer.inference_params,
                          self._dataset.cameras, view_idx,
                          self._trainer.occ.bitfield, self.cfg.march,
                          max_samples=max_samples,
                          background=self.background_color[:3],
                          envmap=self.envmap)
        return np.concatenate([out["albedo"], out["alpha"][..., None]],
                              axis=-1)

    def screenshot(self, path: str, view_idx: int = 0) -> None:
        from .io.image_io import save_image

        save_image(self.render_to_cpu(view_idx), path, bit_depth=8)

    def render_path(self, camera_path, n_frames: int,
                    max_samples: int = 256, render_scale: float = 1.0):
        """Render a fly-through along a `CameraPath` → list of (H, W, 4)
        float RGBA frames, each through view 0's intrinsics
        (`render/renderer.py:render_path`)."""
        from .render.renderer import render_path

        return list(render_path(
            self._trainer.field, self._trainer.inference_params,
            self._dataset.cameras, self._trainer.occ.bitfield, camera_path,
            n_frames, self.cfg.march, max_samples,
            background=self.background_color[:3], envmap=self.envmap,
            render_scale=render_scale))

    # -- mesh ------------------------------------------------------------------------

    def compute_marching_cubes_mesh(self, resolution: Tuple[int, int, int]
                                    = (256, 256, 256), thresh: float = 0.0
                                    ) -> dict:
        """→ {"V", "N", "C", "F"} like pyngp (python_api.cu mesh dict)."""
        from .mesh.extract import extract_mesh

        m = extract_mesh(self._trainer.field,
                         self._trainer.inference_params,
                         resolution=int(resolution[0]),
                         meta=self._dataset.meta, thresh=thresh,
                         with_colors=True)
        return {"V": m["V"], "N": m["N"], "C": m["C"], "F": m["F"]}

    def save_mesh(self, path: str, resolution=(256, 256, 256)) -> None:
        from .mesh.writer import save_mesh

        m = self.compute_marching_cubes_mesh(resolution)
        save_mesh(path, m["V"], m["F"], m["N"], m["C"])

    # -- snapshots -----------------------------------------------------------------

    def save_snapshot(self, path: str) -> None:
        from .train import snapshot as snap

        snap.save_snapshot(path, self._trainer)

    def load_snapshot(self, path: str) -> None:
        from .train import snapshot as snap

        snap.restore_trainer(self._trainer, snap.load_snapshot(path))

    # -- evaluation ------------------------------------------------------------------

    def calculate_iou(self, n_samples: int = 128 ** 3, thresh: float = 0.0,
                      gt_sdf=None, seed: int = 0) -> float:
        """Volumetric IoU between the learned SDF and a ground-truth SDF
        callable over [0, 1]³ (Testbed::calculate_iou, testbed.h:378), at
        `n_samples` uniform points drawn from a generator seeded with
        `seed`. In Sdf mode the ground truth is the loaded mesh, at up to
        2^15 points."""
        if self._extra is not None:
            if self.mode != TestbedMode.Sdf:
                raise ValueError(f"calculate_iou in {self.mode}: Nerf or "
                                 "Sdf only")
            return self._extra.field.calculate_iou(min(n_samples, 1 << 15),
                                                   seed)
        if gt_sdf is None:
            raise ValueError("calculate_iou needs a gt_sdf callable")
        from .mesh.extract import _bind

        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        pts = torch.rand((n_samples, 3), generator=gen, device=self.device)
        field = _bind(self._trainer.field, self._trainer.inference_params)
        with torch.no_grad():
            pred = (field.sdf(pts) < thresh).cpu().numpy()
        gt = np.asarray(gt_sdf(pts.cpu().numpy())) < thresh
        inter = np.logical_and(pred, gt).sum()
        union = np.logical_or(pred, gt).sum()
        return float(inter) / max(float(union), 1.0)
