"""Training loss (port of `rnb_neus2_tpu/render/losses.py:training_loss`).

The reference's fused loss kernel (`src/testbed_nerf.cu:1396-2097`): on
CUDA tensors the three kernels of `kernels/neus_loss.py` (the forward's
two and the backward), on CPU tensors its plain version, whose autograd
gives the same gradients, including the second-order path through ∇sdf:

  total = ( Σ_rays color_loss + mask_w · Σ_rays mask_bce ) / n_rays
          + ek_w · Σ_kept_samples (‖∇sdf‖ − 1)² / S

- color and mask terms are divided by n_rays (loss_scale, :1833);
- the eikonal term is divided by the sample batch target S, as the
  reference's `add_positions_view_ekloss` does
  (common_operation.cuh:283-296, testbed_nerf.cu:4063);
- no pdf division (:1780-1790);
- RGB+: a 4th albedo channel √(3−Σa²) (L2) or 3−Σ|a| (L1), loss halved;
  the √ has a guarded, clamped subgradient (`GuardedSqrt`);
- albedo activation exp(clamp(x, −10, 10));
- mask: weight_sum clamped to [1e−4, 1−1e−4] with zero gradient at the
  rails (:1757-1777); sigmoid-BCE by default, plain BCE with --bce.

Two emulations of the reference's backward (`LossConfig`; the JAX
package's `render/losses.py:79-158, 294-340`), off by default:
- `fp16_grad_emulation`: the loss kernel's dL/doutput rows are fp16 at
  ×LOSS_SCALE = 128 (testbed.h:237, testbed_nerf.cu:1960-2083), so each
  output's cotangent passes `fp16_grad_barrier` (g → fp16(clip(128·g))/128,
  saturating); the variance is broadcast per sample first, so that each
  sample's dL/dv is quantized before the sum (nerf_network.h:327-340). The
  trainer quantizes the parameter gradients the same way
  (`quantize_grads_fp16`);
- `rollover_grad_emulation`: the rollover-padded compacted backward
  (fill_rollover_and_rescale, common_device.h:526-535) weights each kept
  sample's output cotangent by its padded-copy count (`rollover_weights`,
  from the loss's keep mask, through `scale_cotangent`).
The rollover weight goes inside and the fp16 barrier outside, so the
backward quantizes first and reweights second, as the reference writes
fp16 then rescales.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..config import LossConfig, RenderFlags
from ..kernels import neus_loss
from . import shading


class RayBatch(NamedTuple):
    """Per-ray training data (R rays); samples live in a FlatSamples buffer."""

    ray_o: torch.Tensor        # (R, 3) origins (unit-cube space)
    ray_d: torch.Tensor        # (R, 3) unit directions
    alive: torch.Tensor        # (R,) bool: ray participates at all
    normal_gt: torch.Tensor    # (R, 3) decoded GT normal (unit)
    albedo_gt: torch.Tensor    # (R, 3) decoded GT albedo
    mask_color: torch.Tensor   # (R,) albedo alpha > 0.99
    mask_gt: torch.Tensor      # (R,) normal alpha > 0.99
    rot_c2w: torch.Tensor      # (R, 3, 3) camera rotation
    light_idx: torch.Tensor    # (R,) int in [0, 3)
    pdf: torch.Tensor          # (R,) sampling pdf
    # (S, 8) per-SAMPLE attrs [ray_d(3) | alive&kept(1) | ray_o(3) | pad(1)]
    # gathered once in the sampler
    sample_attrs: torch.Tensor | None = None


# the reference's fp16 loss-gradient scale (testbed.h:237) and fp16's
# largest finite value
LOSS_SCALE = 128.0
_FP16_MAX = 65504.0


def _quantize_fp16(g: torch.Tensor) -> torch.Tensor:
    """fp16(clip(128·g))/128: saturating, with fp16's underflow to zero and
    11-bit rounding (round to nearest even, as JAX's convert)."""
    gq = torch.clamp(g * LOSS_SCALE, -_FP16_MAX, _FP16_MAX)
    return gq.to(torch.float16).to(g.dtype) / LOSS_SCALE


class FP16GradBarrier(torch.autograd.Function):
    """Identity whose cotangent is quantized to the fp16 value the
    reference's backward carries (`_quantize_fp16`). Saturating: a CUDA
    float→half overflow makes inf, which would poison the reference's Adam
    moments for good, so a run it survives never overflows."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return _quantize_fp16(g)


def fp16_grad_barrier(x: torch.Tensor) -> torch.Tensor:
    return FP16GradBarrier.apply(x)


def quantize_grads_fp16(grads):
    """The parameter-gradient half of the emulation: the reference
    accumulates hash-table scatters and MLP weight gradients in fp16 at
    the ×128 scale (adam.h:88 divides it back out). A sequence or a dict of
    gradients, each quantized."""
    if isinstance(grads, dict):
        return {k: _quantize_fp16(g) for k, g in grads.items()}
    return [_quantize_fp16(g) for g in grads]


class ScaleCotangent(torch.autograd.Function):
    """Identity in value; the backward multiplies the cotangent by `w`,
    which gets no gradient. `w` is read only in the backward, so it may be
    filled after the forward (the rollover weights, from the loss's own
    keep mask). It is kept as an attribute, not saved for the backward,
    so autograd does not refuse that fill; `training_loss` makes `w`,
    fills it once before it returns and hands it to no one else, so no
    later write can reach it before the backward."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.w = w
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.w, None


def scale_cotangent(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return ScaleCotangent.apply(x, w)


def rollover_weights(keep: torch.Tensor) -> torch.Tensor:
    """Per-slot gradient weight of the rollover-padded compacted backward:
    the n kept samples fill a fixed S-row network batch, rows [n, S)
    repeating row (i mod n) with dL/doutput rescaled by n/S, so the kept
    sample of compaction rank r carries 1 + ⌊(S−1−r)/n⌋·(n/S). Slots not
    kept get 1 (their cotangent is already zero)."""
    S = keep.shape[0]
    k = keep.to(torch.int64)
    n = torch.clamp_min(k.sum(), 1)
    rank = torch.cumsum(k, 0) - 1
    copies = torch.div(S - 1 - rank, n, rounding_mode="floor")
    w = 1.0 + copies.to(torch.float32) * (n.to(torch.float32) / S)
    return torch.where(keep, w, torch.ones_like(w))


def training_loss(field_out: Dict[str, torch.Tensor], samples,
                  batch: RayBatch, flags: RenderFlags, cfg: LossConfig,
                  cos_anneal_ratio: float = 1.0,
                  n_rays_divisor: Optional[int] = None,
                  ek_samples_divisor: Optional[int] = None
                  ) -> tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total differentiable loss for one globally-compacted batch.

    samples: ops.ray_march.FlatSamples with S slots; field_out: NeusField
    on the (S, 3) sample positions. The composite and the loss are
    `kernels/neus_loss.neus_loss`: three kernels on the card, the plain
    version on the CPU, both a segmented log-space prefix sum over the
    flat layout.

    n_rays_divisor / ek_samples_divisor (None: this batch's R and S) let a
    data-parallel replica normalize by the global ray count and the global
    sample target, so that the sum of the replicas' gradients is the
    single-device gradient (`parallel/trainer.py`)."""
    S = samples.t.shape[0]
    R = batch.alive.shape[0]
    sdf = field_out["sdf"]
    grad = field_out["grad"]
    albedo_raw = field_out["albedo_raw"]
    variance = field_out["variance"]

    # per-ray data, no gradient: the light of each ray's triplet slot in
    # world space, and the shaded target albedo
    light_cam = shading.per_ray_lights(batch.normal_gt, batch.light_idx,
                                       flags.apply_supernormal,
                                       flags.apply_light_opti)
    light_world = torch.einsum("rij,rj->ri", batch.rot_c2w, light_cam)
    shade_gt = shading.shade(batch.normal_gt, light_cam, flags.apply_relu)
    target4 = neus_loss.make_albedo4(batch.albedo_gt, flags) * shade_gt[:, None]
    per_sample = batch.sample_attrs is not None
    inp = neus_loss.LossInputs(
        dt=samples.dt, ray_id=samples.ray_id, valid=samples.valid,
        seg_start=samples.seg_start, ray_kept=samples.ray_kept,
        alive=batch.alive, light=light_world, target4=target4,
        mask_gt=batch.mask_gt.to(torch.float32),
        mask_color=batch.mask_color, per_sample_dirs=per_sample)
    opt = neus_loss.LossOptions(flags, cfg, cos_anneal_ratio,
                                n_rays_divisor or R, ek_samples_divisor or S)
    # the directions: pre-gathered per sample by the sampler, or the rays'
    # own (trainable rays: the delta phase, camera refinement)
    dirs = batch.sample_attrs if per_sample else batch.ray_d

    if cfg.rollover_grad_emulation:
        # the weights need the keep mask, which the loss below computes;
        # the barriers read them only in the backward, so they are filled
        # in after it
        w_roll = sdf.new_empty(S)
        sdf = scale_cotangent(sdf, w_roll)
        grad = scale_cotangent(grad, w_roll[:, None])
        albedo_raw = scale_cotangent(albedo_raw, w_roll[:, None])
        variance = scale_cotangent(variance.expand(S), w_roll)
    if cfg.fp16_grad_emulation:
        # rows 0-2 albedo_raw, 3 sdf, 4-6 + 8-10 ∇sdf (their summed
        # cotangent), 7 the variance, written per sample
        sdf = fp16_grad_barrier(sdf)
        grad = fp16_grad_barrier(grad)
        albedo_raw = fp16_grad_barrier(albedo_raw)
        variance = fp16_grad_barrier(variance.expand(S))

    total, metrics, keep = neus_loss.neus_loss(sdf, grad, albedo_raw,
                                               variance, dirs, inp, opt)
    if cfg.rollover_grad_emulation:
        w_roll.copy_(rollover_weights(keep))
    return total, metrics
