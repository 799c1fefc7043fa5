"""Data-parallel training: the single-scene `Trainer` host loop over
replicas of the field (port of `rnb_neus2_tpu/parallel/trainer.py`).

One process drives one replica per listed device, as the JAX package's
single controller drives `shard_map` over its mesh: rays and the sample
budget are split over the replicas, the parameters are replicated, and the
gradients are summed once per step (`mesh.py`). The class inherits the
whole host loop of `train.trainer.Trainer` (rays-per-batch adaptation, the
occupancy cadence, the level buckets, the 16-step chunks, the guard,
snapshots) and overrides the step body, the occupancy refresh and the rays
bucket.

A step: every replica draws its `n_rays / n_dev` rays from the trainer's
one generator in replica order (the JAX package splits the step key into
one key per device), marches them against the occupancy grid with a
budget of `target_batch_size / n_dev` slots, and differentiates its loss
normalized by the global ray count and sample target. The gradients are
summed in replica order on the first device, then (with the fp16
emulation) quantized, then one optimizer step updates the first replica's
parameters, which are copied to every other replica: the replicas stay
identical bit for bit, which two optimizers could not promise where the
scatter kernels' float order differs between replicas. The first replica
is the trainer's own `field` and `params`, so snapshots, the guard's
state, the EMA parameters and mesh export read it as they read a
`Trainer`; `broadcast_params` copies it to the others after anything
writes it (a rollback, a snapshot restore).

Two places differ from the single-device `Trainer`, as in the JAX package:
- the error map is carried through untouched (not splatted): proportional
  sampling is off by default as in the reference (testbed.h:663-664), and
  is refused here;
- the occupancy refresh is a full sweep at every cadence, past step 256
  too, with the cells split over the replicas.

Two replicas may share a device (`devices=["cuda:0", "cuda:0"]`): each
still holds its own copy of the parameters.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
from torch.profiler import record_function

from ..config import TestbedConfig
from ..grid import occupancy
from ..io.dataset import TrainingDataset
from ..models.neus_field import NeusField
from ..render.losses import quantize_grads_fp16, training_loss
from ..train.sampler import RayUniforms, draw_uniforms, sample_ray_batch
from ..train.trainer import (OCC_CHUNK, Trainer, effective_lr_scale,
                             valid_level_for_step)
from .mesh import make_mesh

# metrics summed over the replicas; every other metric is their mean
_SUMMED = ("n_samples_kept", "n_rays_alive", "loss_total", "n_valid_total",
           "n_rays_kept")


def _on(t: Optional[torch.Tensor], dev: torch.device):
    return t if t is None or t.device == dev else t.to(dev)


class Replica(NamedTuple):
    device: torch.device
    field: NeusField
    params: Dict[str, torch.Tensor]
    dataset: TrainingDataset


class ParallelTrainer(Trainer):
    """Data-parallel `Trainer` over `devices` (default: the first `n_chips`
    CUDA devices, all where None)."""

    def __init__(self, dataset: TrainingDataset, cfg: TestbedConfig,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 n_chips: Optional[int] = None,
                 devices: Optional[Sequence] = None):
        devs = make_mesh(devices, n_chips)
        if len(devs) < 2:
            raise ValueError(
                f"ParallelTrainer needs >= 2 devices, have {len(devs)}; "
                "use train.Trainer on a single chip")
        if (cfg.train.sample_image_proportional_to_error
                or cfg.train.sample_focal_plane_proportional_to_error):
            raise ValueError(
                "error-map-proportional sampling is not supported on the "
                "multi-chip path (the map is not accumulated there); "
                "disable sample_*_proportional_to_error or run with "
                "--n-chips 1")
        self.devices = devs
        self.n_dev = len(devs)
        super().__init__(dataset, cfg, devs[0], params)
        datasets = {self.device: self.dataset}
        self.replicas: List[Replica] = [
            Replica(self.device, self.field, self.params, self.dataset)]
        for dev in devs[1:]:
            if dev not in datasets:
                datasets[dev] = dataset.to(dev)
            # initialized from a generator of its own (the trainer's stream
            # stays the single-device one), then set to the first replica
            field = NeusField(cfg.grid, cfg.network, dev,
                              torch.Generator(device=dev))
            self.replicas.append(Replica(dev, field,
                                         dict(field.named_parameters()),
                                         datasets[dev]))
        self.broadcast_params()

    @torch.no_grad()
    def broadcast_params(self) -> None:
        """Copy the first replica's parameters into every other replica."""
        for rep in self.replicas[1:]:
            for k, p in rep.params.items():
                p.copy_(self.params[k])

    def _restore(self, g: dict) -> None:
        super()._restore(g)
        self.broadcast_params()

    def _bucket(self) -> int:
        # the global ray count splits evenly over the replicas; both are
        # powers of two
        return max(super()._bucket(), self.n_dev)

    def _replica_grads(self, rep: Replica, bitfield, n_rays: int,
                       n_active: int):
        """One replica's gradients (in `self.params`' order) and metrics
        on its own draws, normalized by the global `n_rays` and sample
        target."""
        cfg, t = self.cfg, self.cfg.train
        n_local = n_rays // self.n_dev
        with record_function("sample_and_march"):
            uni = draw_uniforms(n_local, self.generator, self.device,
                                light_generator=self.light_generator)
            uni = RayUniforms(*(_on(u, rep.device) for u in uni))
            batch, samples, pos, _ = sample_ray_batch(
                rep.dataset, bitfield, n_local,
                t.target_batch_size // self.n_dev, cfg.march, uniforms=uni)
        vl = valid_level_for_step(cfg.grid, self.step)
        anneal = 1.0 if cfg.loss.anneal_end <= 0 else min(
            1.0, self.step / cfg.loss.anneal_end)
        with record_function("field_forward"):
            out = rep.field(pos, vl, n_active)
        with record_function("loss"):
            loss, metrics = training_loss(
                out, samples, batch, cfg.flags, cfg.loss, anneal,
                n_rays_divisor=n_rays,
                ek_samples_divisor=t.target_batch_size)
        with record_function("backward"):
            grads = torch.autograd.grad(
                loss, [rep.params[n] for n in self.params],
                allow_unused=True, materialize_grads=True)
        metrics.pop("_per_ray_color_logged")
        metrics["n_valid_total"] = samples.n_valid.sum()
        metrics["n_rays_kept"] = samples.ray_kept.sum()
        metrics["loss_total"] = loss.detach()
        return grads, metrics

    def _grads(self, n_rays: int, n_active: int):
        """The replicas' gradients summed in replica order on the first
        device, and their metrics combined as the JAX package's psums
        combine them (counts and the loss summed, the rest averaged)."""
        dev0 = self.device
        total, parts = None, []
        bitfields = {dev0: self.occ.bitfield}
        for rep in self.replicas:
            if rep.device not in bitfields:
                bitfields[rep.device] = self.occ.bitfield.to(rep.device)
            grads, metrics = self._replica_grads(
                rep, bitfields[rep.device], n_rays, n_active)
            with record_function("grad_sum"):
                if total is None:
                    total = list(grads)
                else:
                    for g, gi in zip(total, grads):
                        g.add_(_on(gi, dev0))
            parts.append(metrics)
        metrics = {}
        for k in parts[0]:
            s = parts[0][k]
            for m in parts[1:]:
                s = s + _on(m[k], dev0)
            metrics[k] = s if k in _SUMMED else s / self.n_dev
        return total, metrics

    def _step_body(self, n_rays: int, n_active: int) -> Dict:
        """The replicas' summed gradients, one optimizer step on the first
        replica, the copy to the others. The error map is not splatted."""
        cfg = self.cfg
        grads, metrics = self._grads(n_rays, n_active)
        if cfg.loss.fp16_grad_emulation:
            grads = quantize_grads_fp16(grads)
        frac = cfg.train.fractional_from_step
        rgb_scale = 1.0 if frac is None else float(self.step < frac)
        with record_function("optimizer"):
            self.opt.step(self.params, dict(zip(self.params, grads)),
                          rgb_scale,
                          effective_lr_scale(cfg.train, self.step,
                                             self.lr_scale))
            self.broadcast_params()
        return metrics

    @torch.no_grad()
    def refresh_occupancy(self, n_active: int) -> None:
        """A full sweep (one jittered point per cell) at every cadence, the
        cells split in equal contiguous shares over the replicas."""
        cap = self.cfg.train.occ_refresh_levels
        n_active = n_active if cap is None else min(n_active, cap)
        vl = valid_level_for_step(self.cfg.grid, self.step)
        g = self.cfg.train.occ_grid_size
        pos = occupancy.cell_positions(g, self.generator, self.device)
        dens = []
        for rep, share in zip(self.replicas, pos.chunk(self.n_dev)):
            share = _on(share, rep.device)
            d = torch.cat([rep.field.density(p, vl, n_active)
                           for p in share.split(OCC_CHUNK)])
            dens.append(_on(d, self.device))
        self.occ = occupancy.update(self.occ, torch.cat(dens),
                                    self.cfg.train.density_grid_decay)
