"""The training engine (port of `rnb_neus2_tpu/train/trainer.py`: the step
body `_raw_step_fn`, the occupancy refresh `_raw_occ_fn`, the level and ray
buckets, and the per-step `train_step`).

One step = sample rays → march → field (hash encode + jacobian, SDF MLP,
RGB MLP) → loss → backward (the hash-grid table gradient: K stochastic
corners per sample at the default stoch_corner_bwd = K = 1, or the exact 8;
levels 0 and 1 through the shared-memory CUDA kernel, the others through
the global-atomics one) → sparse Adam → parameter EMA. The
occupancy grid refreshes every clamp(step/16, 1, 16) steps
(testbed.cu:2801-2821): a full sweep before step 256, G³/4 uniform + G³/4
occupancy-biased cells after. Rays per batch adapt to hit the 2^18-sample
budget (testbed_nerf.cu:3554-3555), bucketed to powers of two. Each
phase runs inside a `torch.profiler.record_function` span of its name, which
`rnb_neus2_torch/tools/profile_step.py` reads.

Not ported in this slice, each named in ROADMAP.md: the divergence guard,
the fused multi-step path, the compile cache, and error-map CDF rebuilds
and sampling. `check_ported` refuses a
configuration that asks for any of them: the guard is on by default, so
the port trains only with `TrainConfig(divergence_guard=False)`.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..config import MarchConfig, TestbedConfig, TrainConfig
from ..device import resolve_device
from ..grid import occupancy
from ..io.dataset import TrainingDataset
from ..models.neus_field import NeusField
from ..render.losses import training_loss
from . import error_map
from .optimizer import SparseAdam
from .sampler import sample_ray_batch

# points per density chunk of an occupancy refresh
OCC_CHUNK = 1 << 20


def valid_level_for_step(grid_cfg, step: int) -> int:
    """Unlocked levels at `step` (grid.h:1430-1436), in float32 like the
    JAX package's traced version."""
    L = grid_cfg.n_levels
    if step <= 0:
        return L
    v = np.ceil(np.float32(grid_cfg.base_valid_level_scale * L)
                + np.float32(grid_cfg.valid_level_scale)
                * np.float32(max(0, step - grid_cfg.base_training_step)))
    return min(L, int(v))


def effective_lr_scale(train_cfg, step: int, lr_scale: float) -> float:
    """The feed-forward stabilizer window (TrainConfig.stab_*):
    ×stab_scale for steps in [stab_start, stab_end)."""
    if train_cfg.stab_scale >= 1.0 \
            or train_cfg.stab_end <= train_cfg.stab_start:
        return lr_scale
    in_win = train_cfg.stab_start <= step < train_cfg.stab_end
    return lr_scale * (train_cfg.stab_scale if in_win else 1.0)


# config fields that no code of this slice reads, by config section; each
# must keep its default. The guard's own switch is checked apart.
NOT_READ = {
    "train": ("max_steps", "field_chunk", "fused_steps") + tuple(
        f.name for f in dataclasses.fields(TrainConfig)
        if f.name.startswith("guard_")),
    "march": ("max_samples_per_ray",),
}
_DEFAULTS = {"train": TrainConfig(), "march": MarchConfig()}


def check_ported(cfg: TestbedConfig) -> None:
    """Raise on a configuration this slice of the port cannot train."""
    t = cfg.train
    if t.divergence_guard:
        raise ValueError(
            "the divergence guard is not ported yet (ROADMAP.md, queue 1); "
            "pass TrainConfig(divergence_guard=False) to train without it")
    for section, names in NOT_READ.items():
        have, default = getattr(cfg, section), _DEFAULTS[section]
        for name in names:
            if getattr(have, name) != getattr(default, name):
                raise ValueError(
                    f"{type(have).__name__}.{name}={getattr(have, name)!r}: "
                    f"this port does not read {name} yet; leave it at its "
                    f"default {getattr(default, name)!r}")
    if t.sample_image_proportional_to_error \
            or t.sample_focal_plane_proportional_to_error:
        raise ValueError("error-map proportional sampling is not ported yet")
    if t.light_prng_salt:
        raise ValueError("light_prng_salt is not ported")
    if cfg.grid.aabb_scale > 1.0:
        raise ValueError("aabb_scale > 1 (cascaded occupancy) is not "
                         "ported yet")
    if cfg.loss.fp16_grad_emulation or cfg.loss.rollover_grad_emulation:
        raise ValueError("the fp16 and rollover gradient emulations are not "
                         "ported")


class Trainer:
    """Single-scene trainer on `device` (cuda unless asked)."""

    def __init__(self, dataset: TrainingDataset, cfg: TestbedConfig,
                 device=None, params: Optional[Dict[str, torch.Tensor]] = None):
        check_ported(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.dataset = dataset.to(self.device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.train.seed)
        self.field = NeusField(cfg.grid, cfg.network, self.device,
                               self.generator)
        if params is not None:
            self.field.load_state_dict(params)
        self.params = dict(self.field.named_parameters())
        self.opt = SparseAdam(cfg.optimizer, self.params,
                              self.field.matrix_names())
        self.occ = occupancy.init_state(cfg.train.occ_grid_size, self.device)
        self.step = 0
        # adaptive batch: start at the reference's 2^12 rays (testbed.h:908)
        self.n_rays = cfg.train.initial_rays_per_batch
        ew, eh = error_map.resolution_for(
            dataset.n_images, cfg.train.initial_rays_per_batch, 128,
            dataset.resolution)
        self.emap = error_map.init_state(dataset.n_images, ew, eh,
                                         self.device)

    # ------------------------------------------------------------------

    def _level_bucket(self) -> int:
        """Smallest static level count covering the current unlock state;
        the level mask handles exactness within a bucket."""
        L = self.cfg.grid.n_levels
        active = self.cfg.grid.valid_levels(self.step)
        for b in (max(L // 3, 1), max(2 * L // 3, 2), L):
            if active <= b:
                return b
        return L

    def _bucket(self) -> int:
        """Rays per batch bucketed to a power of two."""
        lo = int(math.log2(max(self.cfg.train.initial_rays_per_batch, 64)))
        return 1 << max(lo - 3,
                        min(18, int(round(math.log2(max(self.n_rays, 1))))))

    @torch.no_grad()
    def refresh_occupancy(self, n_active: int) -> None:
        """Density at one jittered point per visited cell, merged into the
        grid (`_raw_occ_fn`)."""
        cap = self.cfg.train.occ_refresh_levels
        n_active = n_active if cap is None else min(n_active, cap)
        vl = valid_level_for_step(self.cfg.grid, self.step)
        g = self.cfg.train.occ_grid_size
        decay = self.cfg.train.density_grid_decay
        if self.step >= 256:
            n_quarter = max(g ** 3 // 4, 1)
            pos, idx = occupancy.sample_update_cells(
                self.occ, g, n_quarter, n_quarter, generator=self.generator)
        else:
            pos = occupancy.cell_positions(g, self.generator, self.device)
        dens = torch.cat([self.field.density(p, vl, n_active)
                          for p in pos.split(OCC_CHUNK)])
        if self.step >= 256:
            self.occ = occupancy.update_sampled(self.occ, idx, dens, decay)
        else:
            self.occ = occupancy.update(self.occ, dens, decay)

    def _step_body(self, n_rays: int, n_active: int) -> Dict:
        """Sample, march, field, loss, backward, optimizer (`_raw_step_fn`)."""
        cfg = self.cfg
        step = self.step
        with record_function("sample_and_march"):
            batch, samples, pos, (img, xy) = sample_ray_batch(
                self.dataset, self.occ.bitfield, n_rays,
                cfg.train.target_batch_size, cfg.march,
                generator=self.generator)
        vl = valid_level_for_step(cfg.grid, step)
        anneal = 1.0 if cfg.loss.anneal_end <= 0 else min(
            1.0, step / cfg.loss.anneal_end)
        with record_function("field_forward"):
            out = self.field(pos, vl, n_active)
        with record_function("loss"):
            loss, metrics = training_loss(out, samples, batch, cfg.flags,
                                          cfg.loss, anneal)
        names = list(self.params)
        with record_function("backward"):
            grads = torch.autograd.grad(loss,
                                        [self.params[n] for n in names])
        frac = cfg.train.fractional_from_step
        rgb_scale = 1.0 if frac is None else float(step < frac)
        with record_function("optimizer"):
            self.opt.step(self.params, dict(zip(names, grads)), rgb_scale,
                          effective_lr_scale(cfg.train, step, 1.0))
            self.emap = error_map.splat(self.emap, img, xy,
                                        metrics.pop("_per_ray_color_logged"))
        metrics["n_valid_total"] = samples.n_valid.sum()
        metrics["n_rays_kept"] = samples.ray_kept.sum()
        metrics["loss_total"] = loss.detach()
        return metrics

    def train_step(self) -> Dict[str, float]:
        """One step, metrics read back to the host (`Trainer.train_step`);
        `n_levels_run` is the step's level bucket, the levels its encode
        processes."""
        t0 = time.perf_counter()
        n_levels = self._level_bucket()
        if self.step % occupancy.update_cadence(self.step) == 0:
            with record_function("occupancy_refresh"):
                self.refresh_occupancy(n_levels)
        r = self._bucket()
        metrics = self._step_body(r, n_levels)
        self.step += 1
        out = {k: float(v) for k, v in metrics.items()}
        out["rays_per_batch"] = r
        out["n_levels_run"] = n_levels
        # adaptive rays/batch (testbed_nerf.cu:3554-3555)
        n_basis = out["n_samples_kept"] if self.cfg.train.adapt_to_kept \
            else out["n_valid_total"]
        if n_basis > 0:
            target = self.cfg.train.target_batch_size
            self.n_rays = int(np.clip(
                r * target / n_basis,
                self.cfg.train.initial_rays_per_batch // 8,
                self.cfg.train.max_rays_per_batch))
        out["step_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    @property
    def inference_params(self) -> Dict[str, torch.Tensor]:
        """EMA parameters (the reference's inference params)."""
        return self.opt.ema
