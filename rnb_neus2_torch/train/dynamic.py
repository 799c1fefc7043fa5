"""Multi-frame dynamic-scene training (port of
`rnb_neus2_tpu/train/dynamic.py`; the NeuS2 capability the RNb fork
inherits: src/testbed.cu:2788-2870 and configs/nerf/base.json's
first_frame_max_training_step, next_frame_max_training_step,
predict_global_movement(_training_step), finetune_global_movement and the
"globalmove" optimizer chain).

- frame 0 trains the canonical field with the `Trainer`;
- each later frame first trains only the global rigid motion (the
  DeltaNetwork) for predict_global_movement_training_step steps, with the
  canonical field frozen and every hash level open: rays are marched under
  the current delta (stop-gradient), mapped back to the frame's raw rays,
  and the differentiable delta re-applied, so that the loss gradient
  reaches the delta through the sample positions and the
  position-differentiable encode (`NeusField(differentiable_positions=
  True)`). The eikonal weight is 0 in this phase. An Adam(0.005, .9, .99,
  1e-10) steps the delta and an EMA (0.95) of it is adopted at the end;
  neither is reset between frames;
- then the delta is baked into the frame's cameras and the canonical
  field trains on with the `Trainer` (its occupancy grid, error map and
  guard carry over from the previous frame);
- `extract_mesh` maps the canonical mesh's world-space vertices into the
  current frame through the inverse delta, as the JAX package does (at
  the default scale 0.5 that moves the mesh by half the delta's
  translation, and turns it about the world origin); its faces, normals
  and colours are the canonical mesh's.

The delta phase launches no scatter kernel: the field's parameters
require no gradient in it (`NeusField.frozen`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch.profiler import record_function

from ..config import TestbedConfig
from ..grid import occupancy
from ..models import delta_network as dn
from ..render.losses import training_loss
from .optimizer import Adam
from .sampler import draw_uniforms, sample_positions, sample_ray_batch
from .trainer import Trainer


@dataclasses.dataclass(frozen=True)
class DynamicConfig:
    """hyperparams + globalmove sections (configs/nerf/base.json:77-122)."""

    first_frame_max_training_step: int = 2000
    next_frame_max_training_step: int = 1300
    predict_global_movement: bool = True
    predict_global_movement_training_step: int = 100
    finetune_global_movement: bool = True
    reset_density_grid_after_global_movement: bool = False
    delta_learning_rate: float = 0.005   # globalmove Adam (base.json:106)


class FrameSequenceTrainer:
    """Drives a `Trainer` across a sequence of per-frame datasets, on
    `device` (cuda unless asked)."""

    def __init__(self, first_dataset, cfg: TestbedConfig,
                 dyn: Optional[DynamicConfig] = None, device=None):
        self.cfg = cfg
        self.dyn = dyn or DynamicConfig()
        self.trainer = Trainer(first_dataset, cfg, device=device)
        self.delta = dn.init_delta_params(self.trainer.device)
        self.delta_opt = Adam(self.delta, self.dyn.delta_learning_rate,
                              b1=0.9, b2=0.99, eps=1e-10)
        # the globalmove chain wraps Adam in an Ema(0.95); the EMA'd delta
        # is what the engine consumes
        self.delta_ema = dict(self.delta)
        self.frame = 0
        # the color+mask loss of each step of the last delta phase
        self.delta_losses: List[float] = []
        # the canonical field is frozen in the delta phase, so the eikonal
        # term (an unnormalized sum over samples) must not steer the
        # motion: through the sample positions it rewards transforms that
        # shed samples
        self._delta_loss_cfg = dataclasses.replace(cfg.loss,
                                                   ek_loss_weight=0.0)

    def train_first_frame(self, n_steps: Optional[int] = None):
        if self.frame != 0:
            raise RuntimeError("the first frame is already trained")
        self.trainer.train_steps(
            n_steps or self.dyn.first_frame_max_training_step)

    def delta_grad(self, n_rays: int):
        """The delta phase's loss on a fresh batch of `n_rays` rays and its
        gradient wrt the delta (a dict like it), on the frozen canonical
        field."""
        tr, cfg = self.trainer, self.cfg
        frozen = {k: v.detach() for k, v in self.delta.items()}
        with record_function("delta_sample_and_march"):
            # march under the current (stop-gradient) transform: the
            # reference transforms rays before the occupancy DDA
            batch, samples, _, _ = sample_ray_batch(
                tr.dataset, tr.occ.bitfield, n_rays,
                cfg.train.target_batch_size, cfg.march,
                uniforms=draw_uniforms(n_rays, tr.generator, tr.device),
                ray_transform=lambda o, d: dn.apply_rigid(frozen, o, d))
            # the raw rays, recovered through Rᵀ, so that the
            # differentiable transform can re-apply
            R = dn.rotation_6d_to_matrix(frozen["rotation6d"])
            o_raw = (batch.ray_o - frozen["translation"]) @ R
            d_raw = batch.ray_d @ R
        delta = {k: v.detach().requires_grad_()
                 for k, v in self.delta.items()}
        with tr.field.frozen():
            with record_function("delta_forward"):
                o2, d2 = dn.apply_rigid(delta, o_raw, d_raw)
                pos = sample_positions(o2, d2, samples)
                # the pre-gathered per-sample attributes were built from
                # the frozen transform's rays: the loss regathers
                batch2 = batch._replace(ray_o=o2, ray_d=d2,
                                        sample_attrs=None)
                out = tr.field(pos, differentiable_positions=True)
                loss, _ = training_loss(out, samples, batch2, cfg.flags,
                                        self._delta_loss_cfg, 1.0)
            with record_function("delta_backward"):
                grads = torch.autograd.grad(loss, list(delta.values()))
        return loss.detach(), dict(zip(delta, grads))

    def delta_step(self, n_rays: int) -> torch.Tensor:
        """One Adam step of the rigid delta (`delta_grad`); returns the
        loss (on the device)."""
        loss, grads = self.delta_grad(n_rays)
        self.delta = self.delta_opt.step(self.delta, grads)
        return loss

    def predict_movement(self, dataset) -> Dict[str, torch.Tensor]:
        """Switch to the next frame's data and train its rigid delta
        (phase 1 of `advance_frame`). Returns the adopted delta."""
        tr = self.trainer
        self.frame += 1
        tr.dataset = dataset.to(tr.device)
        if not self.dyn.predict_global_movement:
            return self.delta
        # the motion signal lives in the silhouette sliver: keep the ray
        # count high relative to the sample budget
        n_rays = max(min(tr.n_rays, 8192), 4096)
        losses = []
        for _ in range(self.dyn.predict_global_movement_training_step):
            losses.append(self.delta_step(n_rays))
            self.delta_ema = {k: 0.95 * e + 0.05 * self.delta[k]
                              for k, e in self.delta_ema.items()}
        self.delta = dict(self.delta_ema)
        self.delta_losses = torch.stack(losses).tolist() if losses else []
        if self.dyn.reset_density_grid_after_global_movement:
            tr.occ = occupancy.init_state(self.cfg.train.occ_grid_size,
                                          tr.device)
        return self.delta

    def train_frame(self, n_steps: Optional[int] = None) -> None:
        """Bake the delta into the frame's cameras, then train the
        canonical field on canonical-space rays (phase 2 of
        `advance_frame`); later delta phases refine the motion."""
        tr = self.trainer
        R = dn.rotation_6d_to_matrix(self.delta["rotation6d"])
        cams = tr.dataset.cameras
        tr.dataset = dataclasses.replace(tr.dataset, cameras=cams._replace(
            rot_c2w=torch.einsum("ij,njk->nik", R, cams.rot_c2w),
            origin=cams.origin @ R.T + self.delta["translation"]))
        tr.train_steps(n_steps or self.dyn.next_frame_max_training_step)

    def advance_frame(self, dataset, n_steps: Optional[int] = None
                      ) -> Dict[str, torch.Tensor]:
        """Switch to the next frame's data and run its schedule: the delta
        phase, then the canonical phase. Returns the delta."""
        self.predict_movement(dataset)
        self.train_frame(n_steps)
        return self.delta

    def extract_mesh(self, resolution: int = 256, **kw):
        """Mesh in the current frame's world: the canonical world-space
        vertices mapped through the inverse delta
        (transform_mesh_with_6d), as the JAX package does; F, N and C are
        the canonical mesh's."""
        from ..mesh.extract import extract_mesh

        tr = self.trainer
        m = extract_mesh(tr.field, tr.inference_params,
                         resolution=resolution, meta=tr.dataset.meta, **kw)
        if self.frame > 0:
            delta = {k: v.detach().cpu() for k, v in self.delta.items()}
            m["V"] = dn.inverse_transform_points(
                delta, torch.from_numpy(m["V"])).numpy()
        return m
