"""The NeuS composite and loss of a training step, forward and backward, as
three CUDA kernels: wrapper, plain version, the kernels' prefix order
(`prefix_twin`) and launch counters.

Replaces the JAX package's `training_loss` (rnb_neus2_tpu/render/
losses.py:257) with its `sdf_to_alpha` (rnb_neus2_tpu/render/neus.py:29;
`REPLACES`), which XLA compiles, and their VJP: per sample the NeuS
alpha, the exclusive transmittance (a log-space prefix sum over the whole
buffer, re-based at each ray's first slot) with its keep rule (T ≥ 1e−4),
the shading, the predicted albedo and weight sum per ray, and the
colour, mask and eikonal terms; the backward gives the gradients wrt the
field's outputs (sdf, ∇sdf, raw albedo, variance) and the ray directions.
`csrc/neus_loss.cu` holds the kernels and their design; its source note
gives the bound.

`plain` is the same function in PyTorch (the port's CPU path and the
tests' reference; differentiable through autograd). It sums the
transmittance's logs with `torch.cumsum` over the whole buffer, as the
JAX package does with `jnp.cumsum`; with `prefix` it takes the values of
that prefix from a given function instead (the gradient stays the
cumsum's). The kernels sum the same logs in float64 in a fixed tree
order over tiles of `TILE` slots and round each entry to float32 once,
which `prefix_twin` reproduces bit for bit: the float32 nearest the
exact prefix, as the CPU's `torch.cumsum` (which sums in float64) gives
it.
`neus_loss` takes `plain` for CPU tensors and the kernels, through
`NeusLoss`, for CUDA tensors, where it raises on inputs they do not
take. The forward is two launches (`scan_kernel`, then `forward_kernel`),
the backward one (`backward_kernel`); each counter counts its kernel's
launches.

Inputs: `sdf` (S,), `grad` (S, 3), `albedo_raw` (S, 3), `variance` (a
scalar, or (S,) when an emulation gave each sample its own), `dirs` (the
(S, 8) per-sample attributes [ray_d | alive | ray_o | pad] when
`inp.per_sample_dirs`, else the (R, 3) ray directions) and the
`LossInputs`: the flat sample buffer's fields and the per-ray data
(`light`: the world-space light; `target4`: the shaded target albedo).
Returns (total, metrics, keep): the loss, `training_loss`'s metrics dict
and the (S,) bool keep mask.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from ..config import TRANSMITTANCE_EPSILON, LossConfig, RenderFlags
from ..render import neus, shading
from .build import LaunchCounter, load_library

SOURCE = "neus_loss.cu"
LIBRARY = "neus_loss"
REPLACES = ("rnb_neus2_tpu/render/losses.py:257",
            "rnb_neus2_tpu/render/neus.py:29")


scan_kernel = LaunchCounter("neus_loss_scan")
forward_kernel = LaunchCounter("neus_loss_forward")
backward_kernel = LaunchCounter("neus_loss_backward")

# csrc/neus_loss.cu's tile plan: kThreads threads per block, kPer
# consecutive slots per thread in a scan, TILE slots per block
THREADS, PER = 512, 2
TILE = THREADS * PER


class LossInputs(NamedTuple):
    """What the loss reads besides the field's outputs; no gradient."""

    dt: torch.Tensor            # (S,) step size
    ray_id: torch.Tensor        # (S,) owner ray, R for unused slots
    valid: torch.Tensor         # (S,) bool
    seg_start: torch.Tensor     # (R,) each ray's first slot
    ray_kept: torch.Tensor      # (R,) bool: survived the budget drop
    alive: torch.Tensor         # (R,) bool
    light: torch.Tensor         # (R, 3) world-space light
    target4: torch.Tensor       # (R, 4) shaded target albedo
    mask_gt: torch.Tensor       # (R,) float
    mask_color: torch.Tensor    # (R,) float
    per_sample_dirs: bool       # dirs are the (S, 8) sample attributes


class LossOptions(NamedTuple):
    flags: RenderFlags
    cfg: LossConfig
    cos_anneal_ratio: float
    n_rays: int                 # the colour and mask divisor
    ek_div: int                 # the eikonal divisor


# ---------------------------------------------------------------------------
# the loss's pieces (JAX `render/losses.py`), shared with render/losses.py
# ---------------------------------------------------------------------------

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


def _segment_sum(values: torch.Tensor, seg_ids: torch.Tensor,
                 n_segments: int) -> torch.Tensor:
    out = values.new_zeros((n_segments,) + values.shape[1:])
    return out.index_add(0, seg_ids, values)


# ---------------------------------------------------------------------------
# the kernels' prefix order
# ---------------------------------------------------------------------------

def _inclusive(x: torch.Tensor) -> torch.Tensor:
    """Kogge-Stone inclusive scan along the last dimension: at distance
    d = 1, 2, 4, … each entry adds the one d before it (a warp's
    __shfl_up_sync scan)."""
    d = 1
    while d < x.shape[-1]:
        x = torch.cat([x[..., :d], x[..., d:] + x[..., :-d]], dim=-1)
        d *= 2
    return x


def _block_scan(x: torch.Tensor, threads: int = THREADS):
    """csrc/neus_loss.cu's `block_prefix` on each row of x (B, threads·n):
    thread t holds entries n·t … n·t + n − 1, which it sums serially; its
    total goes through its warp's scan, the warps' totals through one more;
    each entry's exclusive prefix is (warp's + lane's) + its own. Returns
    (the exclusive prefixes, each row's total)."""
    B, m = x.shape
    v = x.view(B, threads, m // threads)
    s = torch.zeros(B, threads, dtype=x.dtype, device=x.device)
    own = []
    for k in range(v.shape[2]):
        own.append(s)
        s = s + v[..., k]
    lanes = _inclusive(s.view(B, threads // 32, 32))
    lane_ex = torch.cat([torch.zeros_like(lanes[..., :1]), lanes[..., :-1]],
                        dim=-1)
    warps = _inclusive(lanes[..., 31])
    warp_ex = torch.cat([torch.zeros_like(warps[:, :1]), warps[:, :-1]],
                        dim=-1)
    base = (warp_ex[..., None] + lane_ex).reshape(B, threads, 1)
    return (base + torch.stack(own, dim=-1)).reshape(B, m), warps[:, -1]


def prefix_twin(lw: torch.Tensor, threads: int = THREADS,
                per: int = PER) -> torch.Tensor:
    """The exclusive prefix of lw (S,) in the kernels' order, bit for bit
    for the tile plan (threads, per): in float64, each tile's local prefix
    by `_block_scan`, every tile's offset by `_block_scan` of the tiles'
    totals (each thread a run of ⌈tiles/threads⌉ of them), then offset +
    local, added once and rounded to lw's type. Slots past S count as
    +0."""
    S = lw.shape[0]
    tile = threads * per
    nb = -(-S // tile)
    x = lw.new_zeros(nb * tile, dtype=torch.float64)
    x[:S] = lw
    local, totals = _block_scan(x.view(nb, tile), threads)
    t = x.new_zeros(threads * -(-nb // threads))
    t[:nb] = totals
    offsets = _block_scan(t.view(1, -1), threads)[0][0, :nb]
    return (offsets[:, None] + local).reshape(-1)[:S].to(lw.dtype)


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def slot_alive(dirs: torch.Tensor, inp: LossInputs) -> torch.Tensor:
    """(S,) bool: the slot holds a sample of a ray (ray_id < R), is valid,
    and its ray is alive and kept (with per-sample attributes, their
    alive column)."""
    R = inp.seg_start.shape[0]
    if inp.per_sample_dirs:
        s_ray_alive = dirs[:, 3] > 0.5
    else:
        s_ray_alive = (inp.alive & inp.ray_kept)[
            torch.clamp_max(inp.ray_id, R - 1)]
    return s_ray_alive & (inp.ray_id < R) & inp.valid


def alpha_and_trans(sdf: torch.Tensor, grad: torch.Tensor,
                    variance: torch.Tensor, dirs: torch.Tensor,
                    inp: LossInputs, opt: LossOptions,
                    prefix: Optional[Callable] = None,
                    alpha_values: Optional[torch.Tensor] = None):
    """The plain version's per-sample alpha (zero where the sample is not
    alive), exclusive transmittance, alive mask and inv_s: a segmented
    log-space prefix sum, cumsum(log(1−α)) over the whole buffer re-based
    at each ray's first slot. `prefix`, if given, maps the (detached) logs
    to the values of that prefix (as `prefix_twin` does); its gradient
    stays the cumsum's. `alpha_values`, if given, are α's values at the
    alive slots (the kernels' own, for a check); its gradient stays
    sdf_to_alpha's."""
    cfg = opt.cfg
    S = inp.dt.shape[0]
    R = inp.seg_start.shape[0]
    rid = torch.clamp_max(inp.ray_id, R - 1)      # clipped gather index
    if inp.per_sample_dirs:
        d = dirs[:, 0:3]
    else:
        # trainable rays (the delta phase, camera refinement): index_select,
        # whose backward is an index_add; the backward of `ray_d[rid]`
        # (`indexing_backward_kernel`) serializes on the padded slots' one
        # row
        d = dirs.index_select(0, rid)
    s_alive = slot_alive(dirs, inp)
    inv_s = torch.exp(10.0 * variance)

    # ---- per-sample alpha ------------------------------------------------
    grad_for_alpha = grad.detach() if cfg.debug_stopgrad_alpha_normal \
        else grad
    true_cos = torch.sum(d * grad_for_alpha, dim=-1)
    sdf_for_alpha = sdf.detach() if cfg.debug_stopgrad_alpha_sdf else sdf
    alpha = neus.sdf_to_alpha(sdf_for_alpha, true_cos, inp.dt, inv_s,
                              opt.cos_anneal_ratio)
    alpha = torch.where(s_alive, alpha, torch.zeros_like(alpha))
    if alpha_values is not None:
        alpha = alpha + torch.where(
            s_alive, alpha_values.to(alpha.dtype) - alpha,
            torch.zeros_like(alpha)).detach()

    # ---- segmented exclusive transmittance -------------------------------
    # clamp so a fully-opaque sample doesn't poison the log-prefix sum;
    # T ≤ 1e−7 is far below the 1e−4 kill threshold
    lw = torch.log1p(-torch.clamp_max(alpha, 1.0 - 1e-7))
    cum = torch.cumsum(lw, 0)
    cum_excl = torch.cat([lw.new_zeros(1), cum[:-1]])
    if prefix is not None:
        cum_excl = prefix(lw.detach()).to(cum_excl.dtype) + (
            cum_excl - cum_excl.detach())
    seg_base = cum_excl[torch.clamp_max(inp.seg_start, S - 1)]  # (R,)
    trans = torch.exp(cum_excl - seg_base[rid])
    return alpha, trans, s_alive, inv_s


def plain_scan(sdf: torch.Tensor, grad: torch.Tensor,
               variance: torch.Tensor, dirs: torch.Tensor, inp: LossInputs,
               opt: LossOptions):
    """What the scan kernel computes, in PyTorch: (α, lw, C), C by
    `prefix_twin`."""
    alpha = alpha_and_trans(sdf, grad, variance, dirs, inp, opt)[0]
    lw = torch.log1p(-torch.clamp_max(alpha, 1.0 - 1e-7))
    return alpha, lw, prefix_twin(lw)


def plain(sdf: torch.Tensor, grad: torch.Tensor, albedo_raw: torch.Tensor,
          variance: torch.Tensor, dirs: torch.Tensor, inp: LossInputs,
          opt: LossOptions, prefix: Optional[Callable] = None,
          alpha_values: Optional[torch.Tensor] = None):
    """The loss in plain PyTorch (any device, float32 or float64): the
    compositing runs in the flat layout (`alpha_and_trans`, which takes
    `prefix` and `alpha_values`), and per-ray reductions are segment sums
    keyed by ray_id. Returns (total, metrics, keep)."""
    flags, cfg = opt.flags, opt.cfg
    R = inp.seg_start.shape[0]
    rid = torch.clamp_max(inp.ray_id, R - 1)
    in_seg = inp.ray_id < R
    ray_alive = inp.alive & inp.ray_kept
    alpha, trans, s_alive, inv_s = alpha_and_trans(
        sdf, grad, variance, dirs, inp, opt, prefix, alpha_values)
    keep = s_alive & (trans >= TRANSMITTANCE_EPSILON)
    w = torch.where(keep, alpha * trans, torch.zeros_like(alpha))

    # ---- shading ----------------------------------------------------------
    grad_for_shade = grad.detach() if cfg.debug_stopgrad_shading_normal \
        else grad
    shade_pred = shading.shade(grad_for_shade, inp.light[rid],
                               flags.apply_relu)
    albedo4 = make_albedo4(albedo_activation(albedo_raw), flags,
                           cfg.rgbplus_grad_floor, cfg.rgbplus_ref_jacobian)

    seg_ids = torch.where(in_seg, inp.ray_id,
                          torch.full_like(inp.ray_id, R))
    pred4 = _segment_sum(w[:, None] * albedo4 * shade_pred[:, None],
                         seg_ids, R + 1)[:R]
    weight_sum = _segment_sum(w, seg_ids, R + 1)[:R]

    # ---- color ------------------------------------------------------------
    color = color_loss_fn(pred4, inp.target4, flags) * inp.mask_color \
        * ray_alive
    color_logged = color.detach()

    # ---- mask --------------------------------------------------------------
    mask = mask_losses(weight_sum, inp.mask_gt, flags) * ray_alive

    # ---- eikonal (kept samples) --------------------------------------------
    gnorm = torch.sqrt(torch.sum(grad * grad, dim=-1) + 1e-6)
    ek = torch.sum(torch.where(keep, (gnorm - 1.0) ** 2,
                               torch.zeros_like(gnorm)))

    total = (torch.sum(color) + cfg.mask_loss_weight * torch.sum(mask)
             ) / opt.n_rays + cfg.ek_loss_weight * ek / opt.ek_div

    n_kept = torch.sum(keep)
    n_alive = torch.sum(ray_alive.to(sdf.dtype))
    metrics = {
        # raw per-ray loss, splatted into the error map by the trainer
        "_per_ray_color_logged": color_logged,
        "loss_color": torch.sum(color_logged) / opt.n_rays,
        "loss_mask": torch.sum(mask.detach()) / opt.n_rays,
        "loss_ek": ek.detach() / torch.clamp_min(n_kept.to(sdf.dtype), 1.0),
        "weight_sum_mean": torch.sum(weight_sum.detach())
        / torch.clamp_min(n_alive, 1.0),
        "n_samples_kept": n_kept,
        "n_rays_alive": torch.sum(ray_alive.to(torch.int32)),
        "inv_s": torch.max(inv_s.detach()),
    }
    return total, metrics, keep


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_INT_OPTIONS = ("S", "R", "l2", "rgbplus", "relu", "bce", "no_albedo",
                "stop_alpha_normal", "stop_shading_normal", "stop_alpha_sdf",
                "ref_jacobian", "dirs_per_sample", "dir_stride",
                "grad_stride", "albedo_stride", "v_per_sample")
_FLOAT_OPTIONS = ("grad_floor", "mask_w", "ek_w", "cos_anneal", "n_rays",
                  "ek_div")


class _Options(ctypes.Structure):
    """csrc/neus_loss.cu's Options."""
    _fields_ = [(n, ctypes.c_int) for n in _INT_OPTIONS] + [
        (n, ctypes.c_float) for n in _FLOAT_OPTIONS]


class _Inputs(ctypes.Structure):
    """csrc/neus_loss.cu's Inputs: device pointers."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "sdf", "grad", "albedo", "v", "dirs", "dt", "ray_id", "valid",
        "seg_start", "alive", "ray_kept", "light", "target4", "mask_gt",
        "mask_color")]


class _ForwardOut(ctypes.Structure):
    """csrc/neus_loss.cu's ForwardOut."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "total", "metrics", "counts", "color", "keep", "alpha", "lw", "cum",
        "trans", "ray_saved", "work")]


class _BackwardIO(ctypes.Structure):
    """csrc/neus_loss.cu's BackwardIO."""
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "g_total", "alpha", "trans", "keep", "ray_saved", "work", "g_sdf",
        "g_grad", "g_albedo", "g_v", "g_dirs")]


@functools.lru_cache(maxsize=None)
def _library():
    lib, _ = load_library(LIBRARY, [SOURCE])
    for fn in (lib.neus_loss_scan_launch, lib.neus_loss_forward_launch,
               lib.neus_loss_backward_launch):
        fn.argtypes = [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
    lib.neus_loss_work_words.argtypes = [ctypes.c_int]
    lib.neus_loss_work_words.restype = ctypes.c_longlong
    lib.neus_loss_error_string.argtypes = [ctypes.c_int]
    lib.neus_loss_error_string.restype = ctypes.c_char_p
    return lib


class Prepared(NamedTuple):
    """The kernels' view of one call: contiguous tensors (kept alive while
    the kernels may read them) and the ctypes structs."""

    tensors: tuple
    inputs: _Inputs
    options: _Options


def _prepared(tensors: tuple, options: _Options) -> Prepared:
    """`Prepared` of the tensors in `_Inputs`' field order."""
    return Prepared(tensors, _Inputs(*(t.data_ptr() for t in tensors)),
                    options)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """An (N, 3) tensor whose rows the kernels read at a stride: its last
    dimension contiguous."""
    return t if t.stride(1) == 1 else t.contiguous()


def check_inputs(sdf, grad, albedo_raw, variance, dirs, inp: LossInputs
                 ) -> None:
    """Raise on inputs that the kernels do not take."""
    S, R = inp.dt.shape[0], inp.seg_start.shape[0]
    floats = {"sdf": sdf, "grad": grad, "albedo_raw": albedo_raw,
              "variance": variance, "dirs": dirs, "dt": inp.dt,
              "light": inp.light, "target4": inp.target4,
              "mask_gt": inp.mask_gt, "mask_color": inp.mask_color}
    bad = {k: t.dtype for k, t in floats.items() if t.dtype != torch.float32}
    if bad:
        raise TypeError(f"the loss kernels take float32: {bad}")
    ints = {"ray_id": inp.ray_id, "seg_start": inp.seg_start}
    bools = {"valid": inp.valid, "ray_kept": inp.ray_kept,
             "alive": inp.alive}
    if any(t.dtype != torch.int64 for t in ints.values()) or any(
            t.dtype != torch.bool for t in bools.values()):
        raise TypeError("ray_id and seg_start must be int64, valid, ray_kept "
                        "and alive bool")
    if S == 0 or R == 0:
        raise ValueError(f"{S} slots and {R} rays: the kernels take at "
                         "least one of each")
    want = {"sdf": (S,), "grad": (S, 3), "albedo_raw": (S, 3),
            "ray_id": (S,), "valid": (S,), "ray_kept": (R,), "alive": (R,),
            "light": (R, 3), "target4": (R, 4), "mask_gt": (R,),
            "mask_color": (R,),
            "dirs": (S, 8) if inp.per_sample_dirs else (R, 3)}
    got = {**floats, **ints, **bools}
    wrong = {k: tuple(got[k].shape) for k, s in want.items()
             if tuple(got[k].shape) != s}
    if variance.numel() not in (1, S) or (variance.numel() == S and
                                          variance.dim() != 1):
        wrong["variance"] = tuple(variance.shape)
    if wrong:
        raise ValueError(f"shapes {wrong}: want {want}, variance a scalar "
                         f"or ({S},)")
    devs = {t.device for t in got.values()}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")


def prepare(sdf, grad, albedo_raw, variance, dirs, inp: LossInputs,
            opt: LossOptions) -> Prepared:
    """Check the inputs and lay them out for the kernels."""
    check_inputs(sdf, grad, albedo_raw, variance, dirs, inp)
    flags, cfg = opt.flags, opt.cfg
    S, R = inp.dt.shape[0], inp.seg_start.shape[0]
    grad, albedo_raw = _rows(grad), _rows(albedo_raw)
    ts = dict(sdf=sdf.contiguous(), grad=grad, albedo=albedo_raw,
              v=variance.reshape(-1).contiguous(), dirs=dirs.contiguous(),
              dt=inp.dt.contiguous(), ray_id=inp.ray_id.contiguous(),
              valid=inp.valid.contiguous(),
              seg_start=inp.seg_start.contiguous(),
              alive=inp.alive.contiguous(),
              ray_kept=inp.ray_kept.contiguous(),
              light=inp.light.contiguous(), target4=inp.target4.contiguous(),
              mask_gt=inp.mask_gt.contiguous(),
              mask_color=inp.mask_color.contiguous())
    options = _Options(
        S=S, R=R, l2=flags.apply_l2, rgbplus=flags.apply_rgbplus,
        relu=flags.apply_relu, bce=flags.apply_bce,
        no_albedo=flags.apply_no_albedo,
        stop_alpha_normal=cfg.debug_stopgrad_alpha_normal,
        stop_shading_normal=cfg.debug_stopgrad_shading_normal,
        stop_alpha_sdf=cfg.debug_stopgrad_alpha_sdf,
        ref_jacobian=cfg.rgbplus_ref_jacobian,
        dirs_per_sample=inp.per_sample_dirs, dir_stride=ts["dirs"].shape[1],
        grad_stride=grad.stride(0), albedo_stride=albedo_raw.stride(0),
        v_per_sample=variance.numel() == S and variance.dim() == 1,
        grad_floor=cfg.rgbplus_grad_floor, mask_w=cfg.mask_loss_weight,
        ek_w=cfg.ek_loss_weight, cos_anneal=opt.cos_anneal_ratio,
        n_rays=opt.n_rays, ek_div=opt.ek_div)
    return _prepared(tuple(ts[n] for n, _ in _Inputs._fields_), options)


def _up4(n: int) -> int:
    return (n + 3) & ~3


def _saved_layout(S: int, R: int):
    """Offsets in float32 words of `ForwardResult.saved`'s pieces, each at
    a multiple of 16 bytes: α and T (S each, `stride` apart), the keep
    mask's bytes, ray_saved (R, 5) and the kernels' scratch."""
    stride = _up4(S)
    keep = 2 * stride
    ray_saved = keep + _up4(-(-S // 4))
    return stride, keep, ray_saved, ray_saved + _up4(5 * R)


class ForwardResult(NamedTuple):
    total: torch.Tensor       # ()
    metrics: torch.Tensor     # (5,) loss_color, loss_mask, loss_ek,
    #                           weight_sum_mean, inv_s
    counts: torch.Tensor      # (2,) int64 n_samples_kept, n_rays_alive
    color: torch.Tensor       # (R,) per-ray colour loss
    keep: torch.Tensor        # (S,) bool, a view of `saved`
    saved: torch.Tensor       # float32: what the backward reads
    #                           (`_saved_layout`)
    prefix: Optional[torch.Tensor] = None   # (2, S) lw and C, where asked

    def _slot_part(self, k: int) -> torch.Tensor:
        S = self.keep.shape[0]
        return self.saved.narrow(0, k * _up4(S), S)

    @property
    def alpha(self) -> torch.Tensor:
        """(S,) α, 0 where the slot is not alive."""
        return self._slot_part(0)

    @property
    def trans(self) -> torch.Tensor:
        """(S,) T = exp(C − C[seg_start])."""
        return self._slot_part(1)

    @property
    def lw(self) -> torch.Tensor:
        """(S,) log1p(−min(α, 1 − 1e−7)), the logs that C sums (a forward
        with `with_prefix`)."""
        return self.prefix[0]

    @property
    def cum(self) -> torch.Tensor:
        """(S,) C, the buffer-wide exclusive prefix of lw (a forward with
        `with_prefix`)."""
        return self.prefix[1]

    @property
    def ray_saved(self) -> torch.Tensor:
        """(R, 5) each ray's pred4 and weight sum."""
        S, R = self.keep.shape[0], self.color.shape[0]
        return self.saved.narrow(0, _saved_layout(S, R)[2], 5 * R).view(R, 5)


def _check(lib, err: int, which: str) -> None:
    if err != 0:
        msg = lib.neus_loss_error_string(err).decode()
        raise RuntimeError(f"neus_loss {which} launch failed: {msg} ({err})")


def _launch(lib, fn, which: str, p: Prepared, out, counter: LaunchCounter,
            dev) -> None:
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.addressof(p.inputs), ctypes.addressof(p.options),
                 ctypes.addressof(out), stream)
    _check(lib, err, which)
    counter.launches += 1


def forward_buffers(p: Prepared, with_prefix: bool = False):
    """The forward's outputs for a prepared call, unwritten, and the
    ForwardOut that points the kernels at them: (ForwardResult,
    _ForwardOut). No buffer needs a fill: the kernels write every
    entry. With `with_prefix` the kernels also write lw and C (for a
    check; the training path leaves them out)."""
    S, R = p.options.S, p.options.R
    dev = p.tensors[0].device
    stride, keep, ray_saved, work = _saved_layout(S, R)
    saved = torch.empty(work + _library().neus_loss_work_words(S),
                        device=dev)
    # total, metrics, pad, counts (int64, at word 8), the per-ray colour
    outs = torch.empty(12 + R, device=dev)
    prefix = torch.empty(2, S, device=dev) if with_prefix else None
    sp, op = saved.data_ptr(), outs.data_ptr()
    out = _ForwardOut(
        total=op, metrics=op + 4, counts=op + 32, color=op + 48,
        keep=sp + 4 * keep, alpha=sp,
        lw=prefix[0].data_ptr() if with_prefix else None,
        cum=prefix[1].data_ptr() if with_prefix else None,
        trans=sp + 4 * stride, ray_saved=sp + 4 * ray_saved,
        work=sp + 4 * work)
    res = ForwardResult(
        total=outs[0], metrics=outs[1:6], counts=outs[8:12].view(torch.int64),
        color=outs[12:],
        keep=saved.narrow(0, keep, -(-S // 4)).view(torch.uint8)[:S]
        .view(torch.bool), saved=saved, prefix=prefix)
    return res, out


def launch_scan(p: Prepared, out: _ForwardOut) -> None:
    """The forward's first kernel: α and the tiles' prefixes of lw."""
    lib = _library()
    _launch(lib, lib.neus_loss_scan_launch, "scan", p, out, scan_kernel,
            p.tensors[0].device)


def launch_forward(p: Prepared, out: _ForwardOut) -> None:
    """The forward's second kernel (after `launch_scan` on the same
    buffers): C, T, keep, the per-ray sums and the loss."""
    lib = _library()
    _launch(lib, lib.neus_loss_forward_launch, "forward", p, out,
            forward_kernel, p.tensors[0].device)


def forward(p: Prepared, with_prefix: bool = False) -> ForwardResult:
    """Launch the forward's two kernels on a prepared call (with
    `with_prefix`, writing lw and C too)."""
    res, out = forward_buffers(p, with_prefix)
    launch_scan(p, out)
    launch_forward(p, out)
    return res


def backward(p: Prepared, saved: torch.Tensor, g_total: torch.Tensor,
             v_shape: torch.Size, with_dirs: bool):
    """Launch the backward kernel on a prepared call and its forward's
    `saved`: (g_sdf (S,), g_grad (S, 3), g_albedo (S, 3), g_variance shaped
    `v_shape`, g_dirs shaped as dirs or None). The kernel writes every
    entry."""
    o = p.options
    S, R = o.S, o.R
    dev = p.tensors[0].device
    lib = _library()
    nv = S if o.v_per_sample else 1
    nd = (S * o.dir_stride if o.dirs_per_sample else R * 3) if with_dirs \
        else 0
    buf = torch.empty(7 * S + nv + nd, device=dev)
    g_sdf, g_grad, g_alb, g_v, g_dirs = torch.split(
        buf, [S, 3 * S, 3 * S, nv, nd])
    g_total = g_total.to(torch.float32).contiguous()
    stride, keep, ray_saved, work = _saved_layout(S, R)
    sp = saved.data_ptr()
    io = _BackwardIO(
        g_total=g_total.data_ptr(), alpha=sp, trans=sp + 4 * stride,
        keep=sp + 4 * keep, ray_saved=sp + 4 * ray_saved, work=sp + 4 * work,
        g_sdf=g_sdf.data_ptr(), g_grad=g_grad.data_ptr(),
        g_albedo=g_alb.data_ptr(), g_v=g_v.data_ptr(),
        g_dirs=g_dirs.data_ptr() if with_dirs else None)
    _launch(lib, lib.neus_loss_backward_launch, "backward", p, io,
            backward_kernel, dev)
    dirs_shape = (S, o.dir_stride) if o.dirs_per_sample else (R, 3)
    return (g_sdf, g_grad.view(S, 3), g_alb.view(S, 3), g_v.view(v_shape),
            g_dirs.view(dirs_shape) if with_dirs else None)


class NeusLoss(torch.autograd.Function):
    """The loss on CUDA tensors: the forward's kernels, and the backward
    kernel for the gradient wrt sdf, grad, albedo_raw, variance and dirs.
    Returns (total, the forward's other outputs); only total carries a
    gradient."""

    @staticmethod
    def forward(ctx, sdf, grad, albedo_raw, variance, dirs, inp, opt):
        p = prepare(sdf, grad, albedo_raw, variance, dirs, inp, opt)
        fwd = forward(p)
        # what the backward reads, saved so that autograd refuses a
        # backward after an in-place change to any of them
        ctx.save_for_backward(*p.tensors, fwd.saved)
        ctx.options = p.options
        ctx.v_shape = variance.shape
        ctx.mark_non_differentiable(fwd.metrics, fwd.counts, fwd.color,
                                    fwd.keep)
        return fwd.total, fwd.metrics, fwd.counts, fwd.color, fwd.keep

    @staticmethod
    @once_differentiable
    def backward(ctx, g_total, *_):
        *ts, saved = ctx.saved_tensors
        grads = backward(_prepared(tuple(ts), ctx.options), saved, g_total,
                         ctx.v_shape, ctx.needs_input_grad[4])
        return (*grads, None, None)


def _metrics(metrics, counts, color) -> Dict[str, torch.Tensor]:
    return {
        "_per_ray_color_logged": color,
        "loss_color": metrics[0],
        "loss_mask": metrics[1],
        "loss_ek": metrics[2],
        "weight_sum_mean": metrics[3],
        "n_samples_kept": counts[0],
        "n_rays_alive": counts[1],
        "inv_s": metrics[4],
    }


def neus_loss(sdf: torch.Tensor, grad: torch.Tensor,
              albedo_raw: torch.Tensor, variance: torch.Tensor,
              dirs: torch.Tensor, inp: LossInputs, opt: LossOptions
              ) -> tuple[torch.Tensor, Dict[str, torch.Tensor],
                         torch.Tensor]:
    """(total, metrics, keep). CUDA tensors launch the kernels (their
    backward through `NeusLoss`) or raise; CPU tensors take `plain`."""
    if sdf.device.type == "cpu":
        return plain(sdf, grad, albedo_raw, variance, dirs, inp, opt)
    if sdf.device.type != "cuda":
        raise ValueError(f"unsupported device {sdf.device}")
    total, metrics, counts, color, keep = NeusLoss.apply(
        sdf, grad, albedo_raw, variance, dirs, inp, opt)
    return total, _metrics(metrics, counts, color), keep

