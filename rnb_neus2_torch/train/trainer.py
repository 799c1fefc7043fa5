"""The training engine (port of `rnb_neus2_tpu/train/trainer.py`: the step
body `_raw_step_fn`, the occupancy refresh `_raw_occ_fn`, the level and ray
buckets, the error-map rebuild cadence, the divergence guard, and the
per-step `train_step`).

One step = sample rays → march → field (hash encode + jacobian, SDF MLP,
RGB MLP) → loss → backward (the hash-grid table gradient: K stochastic
corners per sample at the default stoch_corner_bwd = K = 1, or the exact 8;
levels 0 and 1 through the shared-memory CUDA kernel, the others through
the global-atomics one) → sparse Adam → parameter EMA. The
occupancy grid refreshes every clamp(step/16, 1, 16) steps
(testbed.cu:2801-2821): a full sweep before step 256, G³/4 uniform + G³/4
occupancy-biased cells after. Rays per batch adapt to hit the 2^18-sample
budget (testbed_nerf.cu:3554-3555), bucketed to powers of two. The error
map rebuilds its CDFs after 128 steps, then every 1.5× the last interval
(testbed.cu:3670-3723). Each phase runs inside a
`torch.profiler.record_function` span of its name, which
`rnb_neus2_torch/tools/profile_step.py` reads.

`train_step` is one step with its metrics read back and passed through
the guard. `train_steps(n, sync_every)` is the JAX package's schedule:
steps are dispatched without a read (`train_step_async`), from step 256
in chunks of `fused_steps` (16) steps that take one occupancy refresh and
hold the rays bucket and the level bucket of their first step for all of
their steps, and the metrics are read (`_consume_metrics`: the ray-count
adaptation, the EMAs, the guard and its snapshot) once `sync_every` steps
have been dispatched since the last read, and at the end. The JAX package
runs a chunk as one fused call; here it is the step body called once per
step with the buckets held, so a chunk that starts below a bucket
boundary (the chunk at step 400 of the default grid, whose level bucket
goes from 9 to 14 at step 411) encodes its last steps at the smaller
bucket, as the JAX package does.

The divergence guard (on by default; no reference analog) keeps an
on-device copy of the last healthy state, a ≥ 64-step-lagging anchor and
a ≥ 256-step-lagging deep anchor. A metrics read that finds the color
loss exploding (non-finite, a hard band, two soft bands in a row, the
loss EMA past its ceiling, a dead zero loss) or the eikonal EMA creeping
rolls back, halves the update scale (restored ×2 after 8 clean reads),
and after too many trips drops the RGB+ channel ("degraded" mode) until
enough clean progress re-arms it. The names and the policy are the JAX
package's, so one test drives both.

Every training option the JAX trainer reads runs here:
- `grid.aabb_scale` > 1 changes what it changes in the JAX trainer, the
  per-level scale (`HashGridConfig.per_level_scale`) and, through
  `TestbedConfig.from_network_json`, the cone (1/256): the march stays on
  the unit cube with a single-cascade grid, at cone > 0 the single-phase
  ladder;
- `loss.fp16_grad_emulation` quantizes the whole parameter gradient to
  the reference's fp16 values (`quantize_grads_fp16`) after the backward
  and before the optimizer, the table's included: an entry that underflows
  to 0 is skipped by sparse Adam, as in the JAX package;
- `loss.rollover_grad_emulation` lives in the loss;
- `train.light_prng_salt` ≠ 0 draws the light index from a generator of
  its own, seeded from (seed, salt), so that the salt changes the light
  index and no other draw (the JAX package folds the salt into the light
  key);
- `network.compute_dtype` "bfloat16" lives in the field.
`check_ported` refuses only a non-default value of a field that no code
reads (`NOT_READ`, empty now); `march.max_samples_per_ray`, which no code
of the JAX package reads, is taken at any value (`IGNORED`), and
`train.field_chunk` is checked where the JAX field asserts on it
(`check_field_chunk`); the compile cache is not ported.
"""

from __future__ import annotations

import dataclasses
import logging
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
from ..render.losses import quantize_grads_fp16, training_loss
from ..utils.diagnostics import LossGraph
from ..utils.meters import Ema
from . import error_map
from .optimizer import AdamChain
from .sampler import draw_uniforms, sample_ray_batch

log = logging.getLogger("rnb_neus2_torch.train")

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
    """The guard's reactive update scale composed with the feed-forward
    stabilizer window (TrainConfig.stab_*): ×stab_scale for steps in
    [stab_start, stab_end)."""
    if train_cfg.stab_scale >= 1.0 \
            or train_cfg.stab_end <= train_cfg.stab_start:
        return lr_scale
    in_win = train_cfg.stab_start <= step < train_cfg.stab_end
    return lr_scale * (train_cfg.stab_scale if in_win else 1.0)


# config fields that no code of this slice reads, by config section; each
# must keep its default. (train.max_steps is read by the CLI's loop, not by
# a step.)
NOT_READ: Dict[str, tuple] = {}
# config fields that no code of the JAX package reads either: any value is
# taken and changes nothing
IGNORED = {"march": ("max_samples_per_ray",)}
_DEFAULTS = {"train": TrainConfig(), "march": MarchConfig()}


def check_ported(cfg: TestbedConfig) -> None:
    """Raise on a configuration this port cannot train."""
    for section, names in NOT_READ.items():
        have, default = getattr(cfg, section), _DEFAULTS[section]
        for name in names:
            if getattr(have, name) != getattr(default, name):
                raise ValueError(
                    f"{type(have).__name__}.{name}={getattr(have, name)!r}: "
                    f"this port does not read {name} yet; leave it at its "
                    f"default {getattr(default, name)!r}")


def check_field_chunk(n: int, chunk: int) -> None:
    """`train.field_chunk` only splits the JAX field's evaluation of the
    n-sample buffer into lax.map chunks (`NeusField.apply_chunked`,
    "semantically identical to apply()"), and asserts that a chunk
    divides a larger buffer. The port evaluates the field in one piece,
    the same function, and raises where that assert fails."""
    if n > chunk and n % chunk:
        raise ValueError(f"TrainConfig.field_chunk={chunk} does not divide "
                         f"the {n}-sample buffer (the JAX field's "
                         "apply_chunked asserts n % chunk == 0)")


def check_scene(meta, cfg: TestbedConfig) -> None:
    """Raise when the scene's `aabb_scale` (transform.json, `SceneMeta`)
    differs from the configuration's: neither package feeds the scene's
    value into the config, so training would run another scene scale than
    the scene asks for."""
    if float(meta.aabb_scale) != float(cfg.grid.aabb_scale):
        raise ValueError(
            f"the scene's aabb_scale is {meta.aabb_scale!r} but the "
            f"configuration's grid.aabb_scale is {cfg.grid.aabb_scale!r}; "
            "build the configuration with TestbedConfig.from_network_json("
            f"path, aabb_scale={meta.aabb_scale!r})")


def light_generator(train_cfg, device):
    """The light index's own generator for a non-zero `light_prng_salt`,
    seeded from (seed, salt); None at salt 0 (the step's generator draws
    it)."""
    salt = train_cfg.light_prng_salt
    if not salt:
        return None
    seed = np.random.SeedSequence([train_cfg.seed, salt]).generate_state(
        1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed[0]) & ((1 << 63) - 1))
    return gen


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
        self.light_generator = light_generator(cfg.train, self.device)
        self.field = NeusField(cfg.grid, cfg.network, self.device,
                               self.generator)
        if params is not None:
            self.field.load_state_dict(params)
        self.params = dict(self.field.named_parameters())
        self.opt = AdamChain(cfg.optimizer, self.params,
                              self.field.matrix_names())
        self.occ = occupancy.init_state(cfg.train.occ_grid_size, self.device)
        self.step = 0
        # adaptive batch: start at the reference's 2^12 rays (testbed.h:908)
        self.n_rays = cfg.train.initial_rays_per_batch
        self.loss_ema = Ema(half_life_steps=50)
        self.ek_ema = Ema(half_life_steps=50)
        self.mask_ema = Ema(half_life_steps=50)
        # wall-clock ms of `train_step`, a host meter (no snapshot holds it)
        self.step_ms = Ema(half_life_steps=50)
        self.loss_graph = LossGraph()
        # metrics reads (`_consume_metrics` calls) so far
        self.metric_reads = 0
        # error map: first rebuild after 128 steps, interval ×1.5 each time
        ew, eh = error_map.resolution_for(
            dataset.n_images, cfg.train.initial_rays_per_batch, 128,
            dataset.resolution)
        self.emap = error_map.init_state(dataset.n_images, ew, eh,
                                         self.device)
        self._emap_interval = 128
        self._emap_counter = 0
        # divergence guard state, as in the JAX package's Trainer (whose
        # comments give the run that motivated each field). lr_scale
        # multiplies the final Adam update.
        self.lr_scale = 1.0
        self._good: Optional[dict] = None
        self._anchor: Optional[dict] = None
        self._deep_anchor: Optional[dict] = None
        self._guard_windows = 0
        self._guard_rollbacks = 0
        # monotonic trip counter: every retry draws a new stream
        self._guard_total_rollbacks = 0
        # the furthest step a healthy checkpoint has reached: only
        # progress past it re-arms tier 1 and drains the trip count
        self._guard_best_step = -1
        # True when the previous read was already in the soft band
        self._guard_suspect = False
        # lowest loss EMA ever reached; not restored on rollback
        self._guard_ema_floor: Optional[float] = None
        self._guard_degraded_at: Optional[int] = None
        self._guard_rearms_used = 0
        # step of the last RGB+ re-arm: a trip soon after it re-degrades
        self._guard_rearmed_at: Optional[int] = None
        # best step at each trip, for the thrash detector
        self._guard_trip_best_steps: list = []
        # lowest eikonal EMA ever reached; not restored on rollback
        self._guard_ek_floor: Optional[float] = None

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
        """Sample, march, field, loss, backward, optimizer (`_raw_step_fn`)
        at `self.step`. The metrics stay tensors on the device."""
        cfg = self.cfg
        step = self.step
        t = cfg.train
        proportional = (t.sample_image_proportional_to_error
                        or t.sample_focal_plane_proportional_to_error)
        with record_function("sample_and_march"):
            batch, samples, pos, (img, xy) = sample_ray_batch(
                self.dataset, self.occ.bitfield, n_rays,
                t.target_batch_size, cfg.march,
                uniforms=draw_uniforms(n_rays, self.generator, self.device,
                                       proportional, self.light_generator),
                emap_state=self.emap,
                emap_image_prop=t.sample_image_proportional_to_error,
                emap_focal_prop=t.sample_focal_plane_proportional_to_error)
        vl = valid_level_for_step(cfg.grid, step)
        anneal = 1.0 if cfg.loss.anneal_end <= 0 else min(
            1.0, step / cfg.loss.anneal_end)
        with record_function("field_forward"):
            check_field_chunk(pos.shape[0], t.field_chunk)
            out = self.field(pos, vl, n_active)
        with record_function("loss"):
            loss, metrics = training_loss(out, samples, batch, cfg.flags,
                                          cfg.loss, anneal)
        names = list(self.params)
        with record_function("backward"):
            # a parameter the loss does not reach (the RGB network under
            # --no-albedo) gets a zero gradient, as under jax.grad
            grads = torch.autograd.grad(loss,
                                        [self.params[n] for n in names],
                                        allow_unused=True,
                                        materialize_grads=True)
            if cfg.loss.fp16_grad_emulation:
                grads = quantize_grads_fp16(grads)
        frac = cfg.train.fractional_from_step
        rgb_scale = 1.0 if frac is None else float(step < frac)
        with record_function("optimizer"):
            self.opt.step(self.params, dict(zip(names, grads)), rgb_scale,
                          effective_lr_scale(cfg.train, step, self.lr_scale))
            self.emap = error_map.splat(self.emap, img, xy,
                                        metrics.pop("_per_ray_color_logged"))
        metrics["n_valid_total"] = samples.n_valid.sum()
        metrics["n_rays_kept"] = samples.ray_kept.sum()
        metrics["loss_total"] = loss.detach()
        return metrics

    def train_step_async(self) -> Dict:
        """One step with no read of its metrics, which stay on the device
        (`Trainer.train_step_async`): the occupancy refresh when the cadence
        asks for one, the step body, the step count and the error map's
        rebuild cadence."""
        n_levels = self._level_bucket()
        if self.step % occupancy.update_cadence(self.step) == 0:
            with record_function("occupancy_refresh"):
                self.refresh_occupancy(n_levels)
        r = self._bucket()
        metrics = self._step_body(r, n_levels)
        self.step += 1
        # error-map CDF rebuild cadence (testbed.cu:3670-3723)
        self._emap_counter += 1
        if self._emap_counter >= self._emap_interval:
            self.emap = error_map.rebuild(self.emap)
            self._emap_counter = 0
            self._emap_interval = int(self._emap_interval * 1.5)
        metrics["rays_per_batch"] = r
        metrics["n_levels_run"] = n_levels
        return metrics

    def _run_chunk(self, n_rays: int, n_active: int, chunk: int) -> Dict:
        """`chunk` steps at one rays bucket and one level bucket, after one
        occupancy refresh (`_make_chunk_fn`). The caller has checked that
        the chunk starts on the refresh cadence and ends before the error
        map's next rebuild. Returns the last step's metrics."""
        with record_function("occupancy_refresh"):
            self.refresh_occupancy(n_active)
        for _ in range(chunk):
            metrics = self._step_body(n_rays, n_active)
            self.step += 1
        self._emap_counter += chunk
        metrics["rays_per_batch"] = n_rays
        metrics["n_levels_run"] = n_active
        return metrics

    def train_steps(self, n: int, sync_every: int = 10) -> Dict[str, float]:
        """`n` steps, with the metrics read only after `sync_every`
        dispatched steps and after the last (`Trainer.train_steps`). From
        step 256, on a step that is a multiple of 16, a whole chunk of
        `fused_steps` steps goes at once when it fits in the call and
        ends before the next error-map rebuild. `n` counts the steps
        dispatched: a rollback by the guard does not give them back.
        Returns the last read's metrics."""
        out: Dict[str, float] = {}
        pending = None
        done = 0
        last_sync = 0
        chunk = self.cfg.train.fused_steps
        while done < n:
            eligible = (chunk > 1 and self.step >= 256
                        and self.step % 16 == 0 and chunk % 16 == 0
                        and n - done >= chunk
                        and self._emap_counter + chunk < self._emap_interval)
            if eligible:
                pending = self._run_chunk(self._bucket(),
                                          self._level_bucket(), chunk)
                done += chunk
            else:
                pending = self.train_step_async()
                done += 1
            if done - last_sync >= sync_every or done >= n:
                out = self._consume_metrics(pending)
                last_sync = done
        return out

    def train_step(self) -> Dict[str, float]:
        """One step, metrics read back to the host and passed through the
        divergence guard (`Trainer.train_step`). `n_levels_run` is the
        step's level bucket, the levels its encode processes;
        `rolled_back` is set when the guard did not accept the step."""
        t0 = time.perf_counter()
        out = self._consume_metrics(self.train_step_async())
        out["step_ms"] = (time.perf_counter() - t0) * 1e3
        self.step_ms.update(out["step_ms"])
        return out

    def train(self, n_steps: int, log_every: int = 100, logger=None):
        """`n_steps` calls of `train_step`, with JAX `Trainer.train`'s log
        line every `log_every` steps when a logger is given."""
        for _ in range(n_steps):
            out = self.train_step()
            if logger and self.step % log_every == 0:
                logger.info(
                    f"iteration={self.step} loss={self.loss_ema.value:.6f} "
                    f"ek={self.ek_ema.value:.4f} "
                    f"mask={self.mask_ema.value:.4f} "
                    f"rays={out['rays_per_batch']} "
                    f"step_ms={self.step_ms.value:.1f}")
        return self

    @property
    def inference_params(self) -> Dict[str, torch.Tensor]:
        """EMA parameters (the reference's inference params)."""
        return self.opt.ema

    # ------------------------------------------------------------------
    # divergence guard
    # ------------------------------------------------------------------

    def seed_guard(self) -> None:
        """Take the current state as the first healthy checkpoint (after a
        resume), so that a blow-up before the first healthy read has
        something to roll back to."""
        if self.cfg.train.divergence_guard:
            self._good = self._snapshot_state()

    def _snapshot_state(self) -> dict:
        """An on-device copy of everything a rollback restores: the
        parameters, the optimizer (moments, debias steps, EMA parameters,
        update count), the error map, the occupancy grid, the generator,
        and the host counters and meters."""
        clone = lambda d: {k: v.detach().clone() for k, v in d.items()}
        opt = self.opt
        return {
            "params": clone(self.params),
            "opt": {"mu": clone(opt.mu), "nu": clone(opt.nu),
                    "steps": clone(opt.steps), "ema": clone(opt.ema),
                    "count": opt.count},
            "emap": error_map.ErrorMapState(*(t.clone() for t in self.emap)),
            "occ": self.occ._replace(
                density=self.occ.density.clone(),
                bitfield=self.occ.bitfield.clone(),
                mean_density=self.occ.mean_density.clone()),
            "rng": self.generator.get_state(),
            "light_rng": (self.light_generator.get_state()
                          if self.light_generator is not None else None),
            "step": self.step,
            "n_rays": self.n_rays, "emap_counter": self._emap_counter,
            "emap_interval": self._emap_interval,
            # the whole EMA state: an uninitialized EMA must come back
            # uninitialized, not set at 0.0
            "loss_ema": (self.loss_ema.value, self.loss_ema._initialized,
                         self.loss_ema.updates),
            "ek_ema": (self.ek_ema.value, self.ek_ema._initialized,
                       self.ek_ema.updates),
            "mask_ema": (self.mask_ema.value, self.mask_ema._initialized,
                         self.mask_ema.updates),
        }

    def _checkpoint_good(self) -> None:
        with record_function("guard_snapshot"):
            state = self._snapshot_state()
        # the anchor lags the recent checkpoint by >= 64 steps: a blow-up
        # builds below the loss threshold for ~20 steps before any read
        # sees it, so repeated failure escalates to the anchor
        if self._anchor is None \
                or state["step"] - self._anchor["step"] >= 64:
            # an anchor retired after surviving >= 256 more steps becomes
            # the deep anchor
            if self._deep_anchor is None or (
                    self._anchor is not None
                    and self._anchor["step"] - self._deep_anchor["step"]
                    >= 256):
                self._deep_anchor = self._anchor or self._good or state
            self._anchor = self._good or state
        self._good = state
        if state["step"] > self._guard_best_step:
            self._guard_best_step = state["step"]
            self._guard_rollbacks = 0

    @torch.no_grad()
    def _restore(self, g: dict) -> None:
        """Copy a snapshot into the live tensors (in place: the field and
        the optimizer keep their references) and reset the counters."""
        for k, p in self.params.items():
            p.copy_(g["params"][k])
        opt = self.opt
        for name in ("mu", "nu", "steps", "ema"):
            live = getattr(opt, name)
            for k, t in g["opt"][name].items():
                live[k].copy_(t)
        opt.count = g["opt"]["count"]
        for live, t in zip(self.emap, g["emap"]):
            live.copy_(t)
        for name in ("density", "bitfield", "mean_density"):
            getattr(self.occ, name).copy_(getattr(g["occ"], name))
        self.occ = self.occ._replace(ema_step=g["occ"].ema_step)
        self.generator.set_state(g["rng"])
        if self.light_generator is not None:
            self.light_generator.set_state(g["light_rng"])
        self.step = g["step"]
        self.n_rays = g["n_rays"]
        self._emap_counter = g["emap_counter"]
        self._emap_interval = g["emap_interval"]
        for name, ema in (("loss_ema", self.loss_ema),
                          ("ek_ema", self.ek_ema),
                          ("mask_ema", self.mask_ema)):
            value, initialized, updates = g[name]
            if initialized:
                ema.set(value, updates=updates)
            else:
                ema.reset()

    def _reseed(self) -> None:
        """A new stream after a restore: one draw from the restored stream
        and the monotonic trip count seed the generator, so that no retry
        replays the batches that diverged and no two retries share one
        (the JAX package's fold_in(key, total_rollbacks))."""
        draw = int(torch.randint(0, 1 << 62, (1,), generator=self.generator,
                                 device=self.device))
        seed = np.random.SeedSequence(
            [draw, self._guard_total_rollbacks]).generate_state(1, np.uint64)
        self.generator.manual_seed(int(seed[0]) & ((1 << 63) - 1))

    def _rollback(self, bad_loss: float) -> None:
        bad_step = self.step
        # first failure: the freshest healthy checkpoint; a repeat with no
        # healthy read between escalates to the anchor, and past 4 trips
        # to the deep anchor
        if self._guard_rollbacks == 0:
            g = self._good
        elif self._guard_rollbacks < 4:
            g = self._anchor or self._good
        else:
            g = self._deep_anchor or self._anchor or self._good
        self._restore(g)
        self._guard_total_rollbacks += 1
        self._reseed()
        self._good = g
        self.lr_scale = max(self.lr_scale * 0.5, 1.0 / 32.0)
        self._guard_windows = 0
        self._guard_rollbacks += 1
        self._guard_suspect = False
        log.warning(
            "divergence guard: loss %.3g at step ~%d; rolled back to "
            "step %d, update scale now %.4g (trip %d)", bad_loss, bad_step,
            g["step"], self.lr_scale, self._guard_total_rollbacks)
        # a trip within 256 steps of an RGB+ re-arm: the re-arm itself
        # detonated; re-degrade from the state just restored
        if self._guard_rearmed_at is not None \
                and self.cfg.flags.apply_rgbplus \
                and bad_step - self._guard_rearmed_at <= 256:
            self._enter_degraded_mode(restore=False)
            return
        # terminal: more than guard_max_trips near-consecutive trips with
        # no progress, or thrash (the last guard_max_trips trips moved the
        # best step by less than guard_thrash_span)
        cap = self.cfg.train.guard_max_trips
        self._guard_trip_best_steps.append(self._guard_best_step)
        hist = self._guard_trip_best_steps
        thrash = len(hist) > cap and (
            self._guard_best_step - hist[-cap - 1]
            < self.cfg.train.guard_thrash_span)
        if self._guard_rollbacks > cap or thrash:
            if self.cfg.train.guard_terminal == "raise":
                raise RuntimeError(
                    f"divergence guard: {cap} "
                    + ("rollbacks with net progress below "
                       f"{self.cfg.train.guard_thrash_span} steps"
                       if thrash else "near-consecutive rollbacks")
                    + " — training is unstable even at the minimum "
                    "update scale")
            self._enter_degraded_mode()

    def _set_rgbplus(self, on: bool) -> None:
        self.cfg = dataclasses.replace(
            self.cfg, flags=dataclasses.replace(self.cfg.flags,
                                                apply_rgbplus=on))

    def _enter_degraded_mode(self, restore: bool = True) -> None:
        """Terminal mode "degrade": restore the deepest anchor, switch the
        RGB+ 4th channel off (the loss reads `cfg.flags` every step) and
        restore the full update scale; `_maybe_rearm_rgbplus` switches it
        back on after guard_rearm_steps of clean progress.

        restore=False: the caller already restored a pre-detonation
        state; keep it."""
        if not self.cfg.flags.apply_rgbplus:
            raise RuntimeError(
                "divergence guard: trip cap reached again in degraded "
                "(no-rgbplus) mode — training is unstable with every "
                "known lever applied")
        if restore:
            g = self._deep_anchor or self._anchor or self._good
            if g is not None:
                self._restore(g)
        # a re-armed stretch that ends back here cancels the re-arm budget
        if self._guard_rearmed_at is not None \
                and self.cfg.train.guard_rearm_cancel_on_degrade \
                and self._guard_rearms_used < self.cfg.train.guard_max_rearms:
            log.warning(
                "divergence guard: the re-armed RGB+ stretch ended in a "
                "degrade — cancelling the remaining re-arm budget")
            self._guard_rearms_used = self.cfg.train.guard_max_rearms
        self._set_rgbplus(False)
        self._guard_degraded_at = self.step
        self._guard_rearmed_at = None
        self._guard_rollbacks = 0
        self._guard_windows = 0
        self._guard_trip_best_steps = []
        self.lr_scale = 1.0
        log.error(
            "divergence guard: trip cap reached — entering DEGRADED mode "
            "at step %d: RGB+ 4th channel off (re-arm after %d clean "
            "steps, %d re-arms left), update scale restored to 1.",
            self.step, self.cfg.train.guard_rearm_steps,
            self.cfg.train.guard_max_rearms - self._guard_rearms_used)

    def _maybe_rearm_rgbplus(self) -> None:
        """Re-enable RGB+ after guard_rearm_steps of progress in degraded
        mode, at most guard_max_rearms times, and only from an ek-healthy
        state."""
        t = self.cfg.train
        if self._guard_degraded_at is None \
                or self.cfg.flags.apply_rgbplus \
                or self._guard_rearms_used >= t.guard_max_rearms \
                or self.step < self._guard_degraded_at + t.guard_rearm_steps:
            return
        if self._guard_ek_floor is not None and self.ek_ema._initialized \
                and self.ek_ema.value > max(2.0 * self._guard_ek_floor,
                                            t.guard_ek_abs):
            return
        self._set_rgbplus(True)
        self._guard_rearms_used += 1
        self._guard_degraded_at = None
        self._guard_rearmed_at = self.step
        self._guard_trip_best_steps = []
        log.warning(
            "divergence guard: %d clean steps in degraded mode — RGB+ "
            "4th channel re-armed at step %d (re-arm %d/%d)",
            t.guard_rearm_steps, self.step, self._guard_rearms_used,
            t.guard_max_rearms)

    def _ek_creep(self) -> bool:
        """True when the eikonal EMA has crept past guard_ek_ceiling × its
        best-ever level and past the guard_ek_abs floor: the geometry is
        degrading under a healthy color loss."""
        t = self.cfg.train
        if not t.divergence_guard or t.guard_ek_ceiling <= 0 \
                or self._guard_ek_floor is None \
                or not self.ek_ema._initialized:
            return False
        return self.ek_ema.value > max(
            t.guard_ek_ceiling * self._guard_ek_floor, t.guard_ek_abs)

    def ek_healthy(self) -> bool:
        """False while the eikonal EMA creeps (`_ek_creep`)."""
        return not self._ek_creep()

    def _guard_check(self, loss_color: float) -> bool:
        """True = healthy. Called with the freshly read loss before the
        EMAs take it.

        - HARD (non-finite, > max(hard_ratio·EMA, hard_abs), an exact 0
          with a healthy reference, or the EMA past ceiling × its best
          level and soft_abs): roll back now.
        - SOFT (> max(soft_ratio·EMA, soft_abs)): forgiven once — no
          checkpoint, no EMA update; a second soft read in a row rolls
          back.
        - With no EMA reference yet, the absolute bands alone."""
        if not self.cfg.train.divergence_guard:
            return True
        t = self.cfg.train
        # eikonal creep, checked first: the loss still looks healthy. Acts
        # only while RGB+ is on.
        if self._ek_creep() and self._good is not None \
                and self.cfg.flags.apply_rgbplus:
            ek_now = self.ek_ema.value
            g = self._anchor or self._good
            self._restore(g)   # also restores the pre-creep ek EMA
            log.error(
                "divergence guard: eikonal EMA %.4g crept past %.4g "
                "(best-ever %.4g) — geometry degrading under a healthy "
                "loss; restored step %d and degrading RGB+ now",
                ek_now,
                max(t.guard_ek_ceiling * (self._guard_ek_floor or 0.0),
                    t.guard_ek_abs),
                self._guard_ek_floor or float("nan"), g["step"])
            self._enter_degraded_mode(restore=False)
            return False
        ref = self.loss_ema.value
        have_ref = math.isfinite(ref) and ref > 0.0
        hard = not math.isfinite(loss_color) or (
            loss_color > max(t.guard_hard_ratio * ref, t.guard_hard_abs)
            if have_ref else loss_color > t.guard_hard_abs)
        # dead run: no ray produced a valid sample
        if not hard and loss_color == 0.0 and (have_ref or self.step > 512):
            hard = True
        if not hard and self._guard_ema_floor is not None and have_ref \
                and ref > max(t.guard_ema_ceiling * self._guard_ema_floor,
                              t.guard_soft_abs):
            hard = True    # gradual blow-up: the EMA itself crept up
        soft = not hard and (
            loss_color > max(t.guard_soft_ratio * ref, t.guard_soft_abs)
            if have_ref else loss_color > t.guard_soft_abs)
        if soft and not self._guard_suspect:
            self._guard_suspect = True
            return False
        if hard or soft:
            self._guard_suspect = False
            if self._good is not None:
                self._rollback(loss_color)
            else:
                log.warning(
                    "divergence guard: loss %.3g at step ~%d with NO "
                    "healthy checkpoint to restore — window rejected, "
                    "training continues on the current state", loss_color,
                    self.step)
            return False
        self._guard_suspect = False
        self._maybe_rearm_rgbplus()
        # the trip count is reset only by _checkpoint_good, on progress
        self._guard_windows += 1
        if self.lr_scale < 1.0 and self._guard_windows >= 8:
            self.lr_scale = min(1.0, self.lr_scale * 2.0)
            self._guard_windows = 0
        return True

    def _consume_metrics(self, metrics) -> Dict[str, float]:
        """Read the metrics to the host, pass them through the guard, then
        adapt rays per batch, update the EMAs and checkpoint (after the
        EMA updates, so the snapshot carries the post-read EMAs)."""
        self.metric_reads += 1
        r = metrics.pop("rays_per_batch")
        n_levels = metrics.pop("n_levels_run", None)
        out = {k: float(v) for k, v in metrics.items()}
        out["rays_per_batch"] = r
        if n_levels is not None:
            out["n_levels_run"] = n_levels
        if not self._guard_check(out["loss_color"]):
            out["rolled_back"] = True
            return out
        # adaptive rays/batch (testbed_nerf.cu:3532-3558)
        n_basis = out["n_samples_kept"] if self.cfg.train.adapt_to_kept \
            else out["n_valid_total"]
        if n_basis > 0:
            target = self.cfg.train.target_batch_size
            self.n_rays = int(np.clip(
                r * target / n_basis,
                self.cfg.train.initial_rays_per_batch // 8,
                self.cfg.train.max_rays_per_batch))
        self.loss_ema.update(out["loss_color"])
        self.ek_ema.update(out["loss_ek"])
        self.mask_ema.update(out["loss_mask"])
        self.loss_graph.update(out["loss_color"])
        if self.cfg.train.divergence_guard:
            # best-ever EMA levels; monotone, not restored on rollback
            v = self.loss_ema.value
            if math.isfinite(v) and v > 0.0 and (
                    self._guard_ema_floor is None
                    or v < self._guard_ema_floor):
                self._guard_ema_floor = v
            ek = self.ek_ema.value
            if math.isfinite(ek) and ek > 0.0 and (
                    self._guard_ek_floor is None
                    or ek < self._guard_ek_floor):
                self._guard_ek_floor = ek
            self._checkpoint_good()
        return out
