"""Training loss (port of `rnb_neus2_tpu/render/losses.py:training_loss`).

The reference's fused loss kernel (`src/testbed_nerf.cu:1396-2097`)
restated as a differentiable forward; autograd of it gives the reference's
gradients, including the second-order path through ∇sdf:

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
  from a stop-gradient preview of the keep mask, through
  `scale_cotangent`).
The rollover weight goes inside and the fp16 barrier outside, so the
backward quantizes first and reweights second, as the reference writes
fp16 then rescales.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..config import TRANSMITTANCE_EPSILON, LossConfig, RenderFlags
from . import neus, shading


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


def albedo_activation(raw: torch.Tensor) -> torch.Tensor:
    """Exponential activation (network_to_rgb, testbed_nerf.cu:337-346)."""
    return torch.exp(torch.clamp(raw, -10.0, 10.0))


class GuardedSqrt(torch.autograd.Function):
    """√max(x, 0) whose derivative is regularized by +1e−5 in the
    denominator like the reference's hand-written jacobian
    (testbed_nerf.cu:1942-1947) and clamped below at `floor`. With
    `clamped` (the default) the derivative is zero where the forward is
    flat (x ≤ 0) — the JAX package's fix of the reference's in-clamp slope
    (`losses.py:162-204`). torch's own sqrt backward is inf at 0."""

    @staticmethod
    def forward(ctx, x, floor: float, clamped: bool):
        y = torch.sqrt(torch.clamp_min(x, 0.0))
        ctx.save_for_backward(x, y)
        ctx.floor, ctx.clamped = floor, clamped
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        d = g * 0.5 / torch.clamp_min(y + 1e-5, ctx.floor)
        if ctx.clamped:
            d = torch.where(x > 0.0, d, torch.zeros_like(d))
        return d, None, None


def rgbplus_channel(a3: torch.Tensor, flags: RenderFlags,
                    grad_floor: float = 0.0,
                    ref_jacobian: bool = False) -> torch.Tensor:
    """4th albedo channel (testbed_nerf.cu:1523-1535)."""
    if not flags.apply_rgbplus:
        return torch.zeros_like(a3[..., 0])
    if flags.apply_l2:
        return GuardedSqrt.apply(3.0 - torch.sum(a3 * a3, dim=-1),
                                 grad_floor, not ref_jacobian)
    return 3.0 - torch.sum(torch.abs(a3), dim=-1)


def make_albedo4(a3: torch.Tensor, flags: RenderFlags,
                 grad_floor: float = 0.0,
                 ref_jacobian: bool = False) -> torch.Tensor:
    if flags.apply_no_albedo:
        return torch.cat([torch.ones_like(a3), torch.zeros_like(a3[..., :1])],
                         dim=-1)
    return torch.cat(
        [a3, rgbplus_channel(a3, flags, grad_floor, ref_jacobian)[..., None]],
        dim=-1)


def color_loss_fn(pred4: torch.Tensor, target4: torch.Tensor,
                  flags: RenderFlags) -> torch.Tensor:
    """Summed 4-component L1 or L2 (testbed_nerf.cu:280-298)."""
    d = pred4 - target4
    loss = torch.sum(d * d if flags.apply_l2 else torch.abs(d), dim=-1)
    if flags.apply_rgbplus:
        loss = loss / 2.0
    return loss


def mask_losses(weight_sum: torch.Tensor, mask_gt: torch.Tensor,
                flags: RenderFlags) -> torch.Tensor:
    """BCE on the clamped accumulated weight; the clamp's zero gradient
    outside [1e−4, 1−1e−4] is the reference's explicit zeroing of
    gradient_weight_sum (testbed_nerf.cu:1756-1777)."""
    ws = torch.clamp(weight_sum, 1e-4, 1.0 - 1e-4)
    if flags.apply_bce:
        return -(mask_gt * torch.log(ws) + (1.0 - mask_gt) * torch.log(1.0 - ws))
    sig = torch.sigmoid(ws)
    return -(mask_gt * torch.log(sig) + (1.0 - mask_gt) * torch.log(1.0 - sig))


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
    which gets no gradient."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(w)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        return g * w, None


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


def _segment_sum(values: torch.Tensor, seg_ids: torch.Tensor,
                 n_segments: int) -> torch.Tensor:
    out = values.new_zeros((n_segments,) + values.shape[1:])
    return out.index_add(0, seg_ids, values)


def training_loss(field_out: Dict[str, torch.Tensor], samples,
                  batch: RayBatch, flags: RenderFlags, cfg: LossConfig,
                  cos_anneal_ratio: float = 1.0,
                  n_rays_divisor: Optional[int] = None,
                  ek_samples_divisor: Optional[int] = None
                  ) -> tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total differentiable loss for one globally-compacted batch.

    samples: ops.ray_march.FlatSamples with S slots; field_out: NeusField
    on the (S, 3) sample positions. Compositing runs in the flat layout: the
    per-ray exclusive transmittance is a segmented log-space prefix sum
    (cumsum(log(1−α)) re-based at each ray's first slot), and per-ray
    reductions are segment sums keyed by ray_id.

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

    rid = torch.clamp_max(samples.ray_id, R - 1)   # clipped gather index
    in_seg = samples.ray_id < R                    # slot belongs to a ray
    ray_alive = batch.alive & samples.ray_kept
    if batch.sample_attrs is not None:
        dirs = batch.sample_attrs[:, 0:3]
        s_ray_alive = batch.sample_attrs[:, 3] > 0.5
    else:
        # trainable rays (the delta phase, camera refinement): index_select,
        # whose backward is an index_add; the backward of `ray_d[rid]`
        # (`indexing_backward_kernel`) serializes on the padded slots' one
        # row and took most of a delta step on the card
        dirs = batch.ray_d.index_select(0, rid)
        s_ray_alive = ray_alive[rid]
    s_alive = s_ray_alive & in_seg & samples.valid

    def keep_mask(sdf_, grad_, inv_s_):
        """valid and not yet terminated: the main path's keep below,
        recomputed for the rollover emulation's stop-gradient preview."""
        tc = torch.sum(dirs * grad_, dim=-1)
        a = neus.sdf_to_alpha(sdf_, tc, samples.dt, inv_s_,
                              cos_anneal_ratio)
        a = torch.where(s_alive, a, torch.zeros_like(a))
        lw_ = torch.log1p(-torch.clamp_max(a, 1.0 - 1e-7))
        ce = torch.cat([lw_.new_zeros(1), torch.cumsum(lw_, 0)[:-1]])
        base = ce[torch.clamp_max(samples.seg_start, S - 1)]
        return s_alive & (torch.exp(ce - base[rid]) >= TRANSMITTANCE_EPSILON)

    if cfg.rollover_grad_emulation:
        w_roll = rollover_weights(keep_mask(
            sdf.detach(), grad.detach(), torch.exp(10.0 * variance.detach())))
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
    inv_s = torch.exp(10.0 * variance)

    # ---- per-sample alpha ------------------------------------------------
    grad_for_alpha = grad.detach() if cfg.debug_stopgrad_alpha_normal \
        else grad
    true_cos = torch.sum(dirs * grad_for_alpha, dim=-1)
    sdf_for_alpha = sdf.detach() if cfg.debug_stopgrad_alpha_sdf else sdf
    alpha = neus.sdf_to_alpha(sdf_for_alpha, true_cos, samples.dt, inv_s,
                              cos_anneal_ratio)
    alpha = torch.where(s_alive, alpha, torch.zeros_like(alpha))

    # ---- segmented exclusive transmittance -------------------------------
    # clamp so a fully-opaque sample doesn't poison the log-prefix sum;
    # T ≤ 1e−7 is far below the 1e−4 kill threshold
    lw = torch.log1p(-torch.clamp_max(alpha, 1.0 - 1e-7))
    cum = torch.cumsum(lw, 0)
    cum_excl = torch.cat([lw.new_zeros(1), cum[:-1]])
    seg_base = cum_excl[torch.clamp_max(samples.seg_start, S - 1)]  # (R,)
    trans = torch.exp(cum_excl - seg_base[rid])
    keep = s_alive & (trans >= TRANSMITTANCE_EPSILON)
    w = torch.where(keep, alpha * trans, torch.zeros_like(alpha))

    # ---- shading ----------------------------------------------------------
    light_cam = shading.per_ray_lights(batch.normal_gt, batch.light_idx,
                                       flags.apply_supernormal,
                                       flags.apply_light_opti)
    light_world = torch.einsum("rij,rj->ri", batch.rot_c2w, light_cam)
    grad_for_shade = grad.detach() if cfg.debug_stopgrad_shading_normal \
        else grad
    shade_pred = shading.shade(grad_for_shade, light_world[rid],
                               flags.apply_relu)
    albedo4 = make_albedo4(albedo_activation(albedo_raw), flags,
                           cfg.rgbplus_grad_floor, cfg.rgbplus_ref_jacobian)

    seg_ids = torch.where(in_seg, samples.ray_id,
                          torch.full_like(samples.ray_id, R))
    pred4 = _segment_sum(w[:, None] * albedo4 * shade_pred[:, None],
                         seg_ids, R + 1)[:R]
    weight_sum = _segment_sum(w, seg_ids, R + 1)[:R]

    shade_gt = shading.shade(batch.normal_gt, light_cam, flags.apply_relu)
    target4 = make_albedo4(batch.albedo_gt, flags) * shade_gt[:, None]

    # ---- color ------------------------------------------------------------
    color = color_loss_fn(pred4, target4, flags) * batch.mask_color \
        * ray_alive
    color_logged = color.detach()

    # ---- mask --------------------------------------------------------------
    mask = mask_losses(weight_sum, batch.mask_gt.to(torch.float32), flags) \
        * ray_alive

    # ---- eikonal (kept samples) --------------------------------------------
    gnorm = torch.sqrt(torch.sum(grad * grad, dim=-1) + 1e-6)
    ek = torch.sum(torch.where(keep, (gnorm - 1.0) ** 2,
                               torch.zeros_like(gnorm)))

    n_rays = n_rays_divisor or R
    ek_div = ek_samples_divisor or S
    total = (torch.sum(color) + cfg.mask_loss_weight * torch.sum(mask)
             ) / n_rays + cfg.ek_loss_weight * ek / ek_div

    n_kept = torch.sum(keep)
    n_alive = torch.sum(ray_alive.to(torch.float32))
    metrics = {
        # raw per-ray loss, splatted into the error map by the trainer
        "_per_ray_color_logged": color_logged,
        "loss_color": torch.sum(color_logged) / n_rays,
        "loss_mask": torch.sum(mask.detach()) / n_rays,
        "loss_ek": ek.detach() / torch.clamp_min(n_kept.to(torch.float32),
                                                 1.0),
        "weight_sum_mean": torch.sum(weight_sum.detach())
        / torch.clamp_min(n_alive, 1.0),
        "n_samples_kept": n_kept,
        "n_rays_alive": torch.sum(ray_alive.to(torch.int32)),
        "inv_s": torch.max(inv_s.detach()),
    }
    return total, metrics
