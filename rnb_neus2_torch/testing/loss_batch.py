"""A seeded flat sample batch for the training loss with its edge cases
built in, and the check of the loss kernels against their plain version
run in float64.

`loss_batch(seed, n_rays, n_slots, full)` makes, with numpy, the field's
outputs at every slot, a compacted `FlatSamples` buffer (as
`ops/ray_march._compact` lays it out) and the per-ray data of a
`RayBatch`. Rays with a role (`ROLES`): one with no slots, a long one
whose transmittance falls below 1e−4 mid-segment, one with a sample of
alpha in (1 − 1e−7, 1) whose weight sum lands on the mask clamp's upper
rail, one whose raw albedo sits on ±10 (faint, so that e^10 stays a small part
of the loss), a dead ray, one without colour
mask, a faint one on the mask clamp's lower rail and a bright one whose
RGB+ argument 3 − Σa² is negative; the last 20 rays overflow the budget
and are dropped. With `full` the kept rays fill the buffer
exactly and the last kept ray has no slots and starts at S; otherwise
the buffer ends in unused slots. `tests/test_torch_neus_loss.py` holds
the port's loss against the JAX package's on it; `chip_smoke.py` and
`tests/test_torch_gpu.py` hold the kernels against the plain version on
it (`hold_against_float64`), the scan's logs and the kernels' prefix
against values computed apart from them (`scan_checks`), and that prefix
against the twin of the kernels' own logs (`prefix_checks`).
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from ..config import TRANSMITTANCE_EPSILON
from ..kernels import neus_loss

VARIANCE = 0.3              # inv_s = exp(3) ≈ 20.1
# with dt = 0.8, dirs·∇ = −1 and inv_s as above, float32 alpha lands in
# (1 − 1e−7, 1) (and not on 1, where the clamps' ties would be)
OPAQUE_SDF, OPAQUE_DT = -0.591711, 0.8
ROLES = dict(no_slots=1, long=2, opaque=3, rail_albedo=4, dead=5,
             no_color=6, faint=7, bright=8)
LONG_SLOTS = 40


def _faint_level(n: int, dt: float = 0.03) -> float:
    """An sdf level whose NeuS alpha (dirs·∇ ≈ −1, inv_s = e^{10·VARIANCE})
    is about 2 ln 1e4 / n: the transmittance of n such samples crosses
    1e−4 near the middle. 0 where no level is faint enough to be needed
    (σ′ cannot exceed 1/4)."""
    s = float(np.exp(10.0 * VARIANCE))
    q = 2.0 * np.log(1e4) / n / (s * dt)
    if q >= 0.25:
        return 0.0
    sig = (1.0 + np.sqrt(1.0 - 4.0 * q)) / 2.0
    return float(np.log(sig / (1.0 - sig)) / s)


def _unit(rng, n):
    v = rng.normal(size=(n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def loss_batch(seed: int = 0, n_rays: int = 300, n_slots: int = 2048,
               full: bool = False, long_slots: int = LONG_SLOTS
               ) -> Dict[str, np.ndarray]:
    """The batch as a dict of numpy arrays: the field's outputs (sdf, grad,
    albedo_raw, variance), the `FlatSamples` fields and the `RayBatch`
    fields (sample_attrs included). The long ray has `long_slots` slots;
    past LONG_SLOTS its sdf sits at a level where its transmittance
    crosses 1e−4 about halfway along, so that a long ray keeps samples
    across the kernels' tiles."""
    rng = np.random.default_rng(seed)
    R, S = n_rays, n_slots
    drop = R - 20
    n_valid = rng.integers(1, 9, R)
    n_valid[ROLES["no_slots"]] = 0
    n_valid[ROLES["long"]] = long_slots
    n_valid[ROLES["opaque"]] = 6
    if full:
        # the rays before drop − 1 fill the buffer exactly; ray drop − 1
        # is kept with no slots, so its segment starts at S
        n_valid[drop - 2] = S - n_valid[:drop - 2].sum()
        n_valid[drop - 1] = 0
        if n_valid[drop - 2] < 1:
            raise ValueError(f"{S} slots are too few for {R} rays")
    n_valid[drop] = S                            # overflows: dropped
    cum = np.cumsum(n_valid)
    ray_kept = cum <= S
    counts = np.where(ray_kept, n_valid, 0)
    offsets = np.cumsum(counts) - counts
    total = counts.sum()
    ray_id = np.full(S, R, np.int64)
    for r in np.flatnonzero(counts):
        ray_id[offsets[r]:offsets[r] + counts[r]] = r
    valid = np.arange(S) < total

    ray_d = _unit(rng, R)
    ray_o = rng.uniform(0.2, 0.8, (R, 3))
    alive = rng.random(R) > 0.05
    alive[list(ROLES.values())] = True
    alive[ROLES["dead"]] = False
    mask_color = (rng.random(R) > 0.2).astype(np.float64)
    mask_color[ROLES["no_color"]] = 0.0
    mask_color[[ROLES["opaque"], ROLES["rail_albedo"], ROLES["bright"],
                ROLES["long"]]] = 1.0
    mask_gt = (rng.random(R) > 0.3).astype(np.float64)
    normal_gt = _unit(rng, R)
    albedo_gt = rng.uniform(0.1, 0.9, (R, 3))
    rot = np.linalg.qr(rng.normal(size=(R, 3, 3)))[0]
    light_idx = rng.integers(0, 3, R)
    pdf = rng.uniform(0.5, 1.5, R)

    sdf = np.zeros(S)
    grad = np.zeros((S, 3))
    albedo_raw = rng.normal(-0.5, 0.3, (S, 3))
    dt = rng.uniform(0.01, 0.05, S)
    for r in np.flatnonzero(counts):
        sl = slice(offsets[r], offsets[r] + counts[r])
        c = counts[r]
        g_mag = rng.uniform(0.8, 1.2, (c, 1))
        grad[sl] = -ray_d[r] * g_mag + 0.1 * rng.normal(size=(c, 3))
        step = rng.uniform(0.01, 0.06)
        sdf[sl] = rng.uniform(0.05, 0.15) - step * np.arange(c)
        if r == ROLES["long"]:
            sdf[sl] = 0.01 * rng.normal(size=c) + _faint_level(c)
            dt[sl] = 0.03
        elif r == ROLES["opaque"]:
            j = offsets[r] + 2
            sdf[j], dt[j], grad[j] = OPAQUE_SDF, OPAQUE_DT, -ray_d[r]
        elif r in (ROLES["rail_albedo"], ROLES["faint"]):
            sdf[sl] = 0.6
            dt[sl] = 0.02
            if r == ROLES["rail_albedo"]:
                albedo_raw[sl] = np.array([10.0, -10.0, 0.3])
        elif r == ROLES["bright"]:
            albedo_raw[sl] = 0.7
    t = np.cumsum(dt)
    rid = np.minimum(ray_id, R - 1)
    attrs = np.concatenate([ray_d, (alive & ray_kept)[:, None], ray_o,
                            np.zeros((R, 1))], axis=1)[rid]
    f32 = lambda a: np.asarray(a, np.float32)   # noqa: E731
    return dict(
        sdf=f32(sdf), grad=f32(grad), albedo_raw=f32(albedo_raw),
        variance=np.float32(VARIANCE),
        t=f32(t), dt=f32(dt), ray_id=ray_id, valid=valid,
        seg_start=offsets.astype(np.int64), n_valid=n_valid.astype(np.int64),
        ray_kept=ray_kept,
        ray_o=f32(ray_o), ray_d=f32(ray_d), alive=alive,
        normal_gt=f32(normal_gt), albedo_gt=f32(albedo_gt),
        mask_color=f32(mask_color), mask_gt=f32(mask_gt), rot_c2w=f32(rot),
        light_idx=light_idx.astype(np.int64), pdf=f32(pdf),
        sample_attrs=f32(attrs))


FIELD = ("sdf", "grad", "albedo_raw", "variance")


def torch_batch(b: Dict[str, np.ndarray], device="cpu",
                sample_attrs: bool = True):
    """(field_out, FlatSamples, RayBatch) of the port on `device`; the
    field's outputs are leaves that require a gradient, and so is ray_d
    when `sample_attrs` is False (the trainable rays' path)."""
    from ..ops.ray_march import FlatSamples
    from ..render.losses import RayBatch

    t = lambda k: torch.as_tensor(np.asarray(b[k]), device=device)  # noqa
    field = {k: t(k).requires_grad_() for k in FIELD}
    samples = FlatSamples(*(t(k) for k in FlatSamples._fields))
    rays = {k: t(k) for k in RayBatch._fields}
    if not sample_attrs:
        rays["sample_attrs"] = None
        rays["ray_d"].requires_grad_()
    return field, samples, RayBatch(**rays)


def capture_call(fn):
    """Run `fn()` with `neus_loss.neus_loss` recording its arguments:
    returns (fn's result, [(sdf, grad, albedo_raw, variance, dirs, inp,
    opt)] of each call)."""
    real = neus_loss.neus_loss
    calls = []

    def record(*args):
        calls.append(args)
        return real(*args)
    neus_loss.neus_loss = record
    try:
        return fn(), calls
    finally:
        neus_loss.neus_loss = real


def _leaves(args, dtype):
    """The differentiable inputs as fresh leaves of `dtype`, and the
    LossInputs cast to it."""
    sdf, grad, alb, v, dirs, inp, opt = args
    leaves = [x.detach().to(dtype).requires_grad_()
              for x in (sdf, grad, alb, v, dirs)]
    inp = type(inp)(*(x.detach().to(dtype) if isinstance(x, torch.Tensor)
                      and x.is_floating_point() else x for x in inp))
    return leaves, inp, opt


def _run(fn, args, dtype):
    leaves, inp, opt = _leaves(args, dtype)
    total, metrics, keep = fn(*leaves, inp, opt)
    grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                materialize_grads=True)
    return total.detach(), {k: v.detach() for k, v in metrics.items()}, \
        keep, list(grads), leaves, inp, opt


def plain_float64(sdf, grad, albedo_raw, variance, dirs, inp, opt):
    """`neus_loss.neus_loss`'s contract (any device) through the plain
    version run in float64 on double casts of the inputs: the total and
    the float metrics back in float32, the gradient flowing through the
    casts. A reference for the kernels that does not carry the float32
    plain version's whole-buffer rounding of log T."""
    d = [x.double() for x in (sdf, grad, albedo_raw, variance, dirs)]
    inp = type(inp)(*(x.double() if isinstance(x, torch.Tensor)
                      and x.is_floating_point() else x for x in inp))
    total, m, keep = neus_loss.plain(*d, inp, opt)
    return total.float(), {k: v.float() if v.is_floating_point() else v
                           for k, v in m.items()}, keep


SCALARS = ("loss_color", "loss_mask", "loss_ek", "weight_sum_mean",
           "inv_s")
COUNTS = ("n_samples_kept", "n_rays_alive")
GRADS = ("sdf", "grad", "albedo_raw", "variance", "dirs")
# tolerances of the kernels against the float64 plain version, each
# from float32's own rounding:
# - the total and the metrics 1e−5 relative (float32 per-ray sums, then
#   block sums and atomics);
# - the per-ray colour 1e−4 of its largest entry (α = 1 − σ(·)/σ(·) of a
#   faint sample cancels to a few bits in float32, in the kernels as in
#   any float32 version, and a large albedo magnifies it);
# - each gradient entry by entry: at most GRAD_OFF_SHARE of a tensor's
#   entries may miss GRAD_RTOL relative (with an absolute floor of
#   GRAD_ATOL of the tensor's largest entry), and none may miss GRAD_TOL
#   of that largest entry. The few entries that miss the relative bound
#   are the faint samples', whose α and σ(1 − σ) cancel to a few bits,
#   and sums of terms that cancel (g_α = g_w·T − G/(1 − α), with 1 − α
#   small at opaque samples). The floor: a faint sample's sdf gradient is
#   the difference of σ′ at the two ends of its step, and below 1e−5 of
#   the largest entry such differences miss 1e−4 relative in any float32
#   version (at full width on an H100, 2–4% of sdf's entries at a floor
#   of 1e−6, 0.02% at 1e−5). The relative bound sees a term that is
#   small against the tensor's largest entry but not against the entry
#   it is part of, as the eikonal term of ∇sdf's gradient on the main
#   path (without it 53–64% of the entries miss); the variance's
#   gradient, one sum over every sample, within GRAD_TOL of the sum of
#   its terms' magnitudes (each term is itself a difference at a faint
#   sample: 1.1e−4 of that sum at full width on an H100);
# - log T 1e−4 against the float64 version fed the kernels' C (exact
#   differences of the same float32 values): the kernels' exp of a
#   float32 difference; C itself is held below, against the twin of the
#   kernels' own logs bit for bit and against the reference's prefix (at
#   |C| ≈ 3e5 one float32 step of C is 0.03 in log T, and a C one step
#   off moves a ray's T by 3%, so the composite is compared on one C).
#   The float64 version takes the kernels' α values too (α is held
#   below): where a ray's composite sits near its optimum, g_w·T and
#   G/(1 − α) nearly cancel, and α's float32 error (1e−7 relative)
#   moved a whole ray's gradient by 5.4e−3 of the largest entry in one
#   main-path batch of 180 on an H100 (any float32 version shares it).
#   Rays whose weight sum lies on two sides of the mask term's clamp in
#   the two versions are left out: the clamp's gradient, 0 or the mask
#   term's, then differs for the whole ray;
# - the scan kernel's α→lw step, entry by entry: its logs within LW_ULPS
#   float32 steps of log1p(−min(α, 1 − 1e−7)) taken in float64 of the
#   α it wrote at the same slot (the clamp at float32's 1 − 1e−7, as the
#   kernel and the float32 plain version clamp; log1pf is within one
#   step, its rounding half of one); and that α, entry by entry, within
#   ALPHA_FACTOR times the float32 plain version's largest α error in the
#   buffer of the float64 version's (0 where a slot is not alive, in
#   all three; the float32 error is the cancellation of two sigmoids, a
#   property of the inputs, not of the order). Together they hold each
#   log against the float64 log1p(−min(α, 1 − 1e−7)) at float32's error.
#   The kernels' C against the twin's prefix of the float32 plain
#   version's logs (the reference's prefix) within C_REF_STEPS float32
#   steps of the largest |C| plus the sum of |Δ lw| before the slot (each
#   is the float32 nearest its exact sum, within half a step,
#   `tests/test_torch_loss_prefix.py`, and the exact sums differ by at
#   most that sum);
# - log T within LOG_T_STEPS float32 steps of the buffer's largest |C|
#   against the CPU's float32 `torch.cumsum` of the kernels' own logs
#   (each of the two sums in float64 in another order and rounds once: an
#   entry may differ by one step where its exact sum lies within the
#   float64 sums' error of a rounding tie, and a ray's log T is a
#   difference of two entries; measured on 2^18 trained-like logs: every
#   entry equal).
# Where float32 itself is further off (a faint sample's α cancels to a
# few bits, and e^10 albedo or the reference's RGB+ jacobian magnifies
# it), the colour and a gradient's worst entry may also be within
# PLAIN_FACTOR times the float32 plain version's own error, which
# computes the same α, as long as that version's transmittance is right
# (its |Δ log T| ≤ PLAIN_LOG_T_OK; at full width its whole-buffer cumsum
# is not, and the fixed tolerances alone hold).
SCALAR_RTOL, COLOR_TOL, LOG_T_TOL, LOG_T_STEPS = 1e-5, 1e-4, 1e-4, 2.0
GRAD_RTOL, GRAD_ATOL, GRAD_OFF_SHARE, GRAD_TOL = 1e-4, 1e-5, 0.01, 1e-3
PLAIN_FACTOR, PLAIN_LOG_T_OK = 2.0, 1e-3
ALPHA_FACTOR, LW_ULPS, C_REF_STEPS = 4.0, 2.0, 2.0
# the clamp of α before log1p, in float32 as the float32 versions take it
LW_CAP = float(np.float32(1.0 - 1e-7))
# samples whose float64 T lies within this relative band of 1e−4 may be
# kept by one version and not by the other: their rays are left out of
# the gradient comparison
KEEP_BAND = 1e-4
# the mask term's clamp of the weight sum, in float64 and as the kernels
# take it in float32
WS_LO, WS_HI = 1e-4, 1.0 - 1e-4
WS_LO32, WS_HI32 = float(np.float32(WS_LO)), float(np.float32(WS_HI))


def grad_errors(got: torch.Tensor, want: torch.Tensor) -> dict:
    """One gradient against its float64 reference, entry by entry (both
    already restricted to the entries compared): the largest abs error,
    the scale (the reference's largest entry) and the share of entries
    that miss GRAD_RTOL with an absolute floor of GRAD_ATOL of the
    scale."""
    got, want = got.double(), want.double()
    if not want.numel():
        return {"max_abs_err": 0.0, "scale": 0.0, "off_share": 0.0}
    err = (got - want).abs()
    scale = float(want.abs().max())
    off = err > GRAD_RTOL * want.abs() + GRAD_ATOL * scale
    return {"max_abs_err": float(err.max()), "scale": scale,
            "off_share": float(off.double().mean())}


def grads_failed(kern: dict, plain: dict, plain_ok: bool) -> list:
    """The names of the kernels' gradients (`grad_errors` of each; the
    scalar variance's with `scale` the sum of its terms' magnitudes and
    no `off_share`) that miss the tolerances above, the float32 plain
    version's errors (`plain`) widening a worst entry where `plain_ok`."""
    failed = []
    for k, e in kern.items():
        worst = GRAD_TOL * e["scale"]
        if plain_ok and "off_share" in e:
            worst = max(worst, PLAIN_FACTOR * plain[k]["max_abs_err"])
        if not (e.get("off_share", 0.0) <= GRAD_OFF_SHARE
                and e["max_abs_err"] <= worst):
            failed.append(k)
    return failed


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Float32 steps between a and b, entry by entry (0 where both are the
    same inf or both NaN)."""
    d = (_bits(a).long() - _bits(b).long()).abs()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return torch.where(same, torch.zeros_like(d), d)


def _exclusive_cumsum(lw: torch.Tensor) -> torch.Tensor:
    c = torch.cumsum(lw, 0)
    return torch.cat([lw.new_zeros(1), c[:-1]])


def _f32_step(x: torch.Tensor) -> torch.Tensor:
    """The float32 step at each |x| (float64; the least subnormal at 0)."""
    _, e = torch.frexp(x.double())
    step = torch.ldexp(torch.ones_like(x, dtype=torch.float64),
                       (e - 24).clamp_min(-149))
    return torch.where(x == 0, torch.full_like(step, 2.0 ** -149), step)


def _max_step(big: float) -> float:
    return 2.0 ** (np.floor(np.log2(big)) - 23) if big > 0 else 2.0 ** -149


def plain_logs(alpha: torch.Tensor) -> torch.Tensor:
    """log1p(−min(α, LW_CAP)), the plain version's logs, in α's type."""
    return torch.log1p(-torch.clamp_max(alpha, LW_CAP))


def scan_checks(lw: torch.Tensor, cum: torch.Tensor, alpha: torch.Tensor,
                alpha32: torch.Tensor, alpha64: torch.Tensor,
                cum_ref: torch.Tensor) -> dict:
    """The scan kernel's output against values computed apart from it: its
    logs `lw` entry by entry against log1p(−min(α, LW_CAP)) in float64 of
    its own α `alpha`, within LW_ULPS float32 steps; `alpha` entry by
    entry against the float64 plain version's (`alpha64`) within
    ALPHA_FACTOR times the float32 plain version's (`alpha32`) largest
    error; `cum` against `cum_ref`, the twin's prefix of the float32 plain
    version's logs, within C_REF_STEPS float32 steps of the largest |C|
    plus the sum of |lw − lw32| before the slot. Returns a report with
    `failed`."""
    k, a_k = lw.double(), alpha.double()
    want = plain_logs(a_k)
    lw_err = (k - want).abs()
    lw_off = lw_err > LW_ULPS * _f32_step(want)
    a64 = alpha64.double()
    a_err = (a_k - a64).abs()
    a_tol = ALPHA_FACTOR * float((alpha32.double() - a64).abs().max())
    p32 = plain_logs(alpha32).double()
    drift = _exclusive_cumsum((k - p32).abs())
    c, c_ref = cum.double(), cum_ref.double()
    step = _max_step(float(torch.maximum(c.abs().max(), c_ref.abs().max())))
    c_err = ((c - c_ref).abs() - drift).clamp_min(0.0)
    rep = {
        "lw_of_alpha_entries_off": int(lw_off.sum()),
        "lw_of_alpha_max_steps": float((lw_err / _f32_step(want)).max()),
        "alpha_max_abs_err": float(a_err.max()),
        "alpha_tol": a_tol,
        "alpha_entries_off": int((a_err > a_tol).sum()),
        "lw_vs_float64_max_abs_err": float((k - plain_logs(a64)).abs()
                                           .max()),
        "C_vs_plain_twin_max_abs_err": float((c - c_ref).abs().max()),
        "C_vs_plain_twin_steps": float(c_err.max()) / step,
        "C_bits_differ_from_plain_twin": int(
            (_bits(cum.float()) != _bits(cum_ref.float())).sum()),
    }
    checks = {"lw": rep["lw_of_alpha_entries_off"] == 0,
              "alpha": rep["alpha_entries_off"] == 0,
              "C_vs_plain_twin": rep["C_vs_plain_twin_steps"]
              <= C_REF_STEPS}
    rep["failed"] = [k for k, ok in checks.items() if not ok]
    return rep


def prefix_checks(p, fwd, inp) -> dict:
    """The kernels' transmittance against their order's twin
    (`neus_loss.prefix_twin`) on the kernels' own logs (which
    `scan_checks` holds apart), for a prepared call `p` and its forward
    `fwd` (run `with_prefix`): C bit for bit; T within one float32
    step of exp(C − C_s) computed from the twin; keep equal to the
    twin's, but where the two T straddle 1e−4; log T against the CPU's
    float32 `torch.cumsum` of the same logs within LOG_T_STEPS steps of
    the largest |C|. Then a second forward and a second backward on the
    same inputs: every output bit for bit. Returns a report with
    `failed` and `ok`, and the twin's C (`cum_twin`)."""
    S, R = p.options.S, p.options.R
    eps = TRANSMITTANCE_EPSILON
    lw, cum, trans = fwd.lw, fwd.cum, fwd.trans
    twin = neus_loss.prefix_twin(lw)
    rid = torch.clamp_max(inp.ray_id, R - 1)
    base = torch.clamp(inp.seg_start, 0, S - 1)[rid]
    t_twin = torch.exp(twin - twin[base])
    sdf, v, dirs = p.tensors[0], p.tensors[3], p.tensors[4]
    alive = neus_loss.slot_alive(dirs, inp)
    keep_twin = alive & (t_twin >= eps)
    straddle = (trans >= eps) != (t_twin >= eps)
    keep_off = (fwd.keep != keep_twin) & ~straddle
    # log T against the CPU path's cumsum of the same logs, in float64
    cpu = _exclusive_cumsum(lw.cpu()).double()
    k64, b_cpu = cum.double().cpu(), base.cpu()
    a_cpu = alive.cpu()
    dlog = ((k64 - k64[b_cpu]) - (cpu - cpu[b_cpu]))[a_cpu].abs()
    big = float(torch.maximum(k64.abs().max(), cpu.abs().max()))
    step = _max_step(big)
    # the same call again: bit for bit
    fwd2 = neus_loss.forward(p, with_prefix=True)
    same_fwd = all(torch.equal(_bits(x), _bits(y)) for x, y in (
        (fwd.alpha, fwd2.alpha), (fwd.lw, fwd2.lw), (fwd.cum, fwd2.cum),
        (fwd.trans, fwd2.trans), (fwd.ray_saved, fwd2.ray_saved),
        (fwd.color, fwd2.color), (fwd.metrics, fwd2.metrics),
        (fwd.total.reshape(1), fwd2.total.reshape(1)))) and torch.equal(
        fwd.keep, fwd2.keep) and torch.equal(fwd.counts, fwd2.counts)
    g = torch.ones((), device=sdf.device)
    bwd = [neus_loss.backward(p, f.saved, g, v.shape, True)
           for f in (fwd, fwd2)]
    same_bwd = all(torch.equal(_bits(x), _bits(y))
                   for x, y in zip(*bwd) if x is not None)
    rep = {
        "prefix_bits_differ": int((_bits(cum) != _bits(twin)).sum()),
        "trans_max_ulps": int(_ulps(trans, t_twin).max()),
        "keep_straddling": int((straddle & alive).sum()),
        "keep_differs_from_twin": int(keep_off.sum()),
        "max_abs_C": big, "C_step": step,
        "log_T_vs_cpu_cumsum_steps": float(dlog.max()) / step
        if dlog.numel() else 0.0,
        "forward_repeats_bit_for_bit": same_fwd,
        "backward_repeats_bit_for_bit": same_bwd,
    }
    checks = {
        "prefix_bits": rep["prefix_bits_differ"] == 0,
        "trans_ulp": rep["trans_max_ulps"] <= 1,
        "keep_twin": rep["keep_differs_from_twin"] == 0,
        "log_T_steps": rep["log_T_vs_cpu_cumsum_steps"] <= LOG_T_STEPS,
        "forward_repeat": same_fwd, "backward_repeat": same_bwd,
    }
    rep["failed"] = [k for k, ok in checks.items() if not ok]
    rep["ok"] = not rep["failed"]
    rep["cum_twin"] = twin
    return rep


def hold_against_float64(args, label: str = "") -> dict:
    """The loss kernels against the plain version run in float64 on double
    copies of the same inputs (`args`: the arguments of a `neus_loss`
    call on CUDA tensors), fed the kernels' float32 prefix C (the
    function's rounding) and α values, beside the float32 plain version's
    own error; C and α held apart from the composite: C against the twin
    of the kernels' own logs (`prefix_checks`), and the scan's α, logs
    and C against values computed apart from the kernels, float64's α and
    the twin's prefix of the float32 plain version's logs of the same
    inputs for C (`scan_checks`). Returns a report;
    `report["failed"]` names the checks that the kernels miss (a
    tolerance, or one launch of each kernel, which CPU tensors, taking the
    plain version, miss), and `report["ok"]` is True where it is
    empty."""
    sdf = args[0]
    inp0, opt = args[5], args[6]
    S, R = inp0.dt.shape[0], inp0.seg_start.shape[0]
    counters = (neus_loss.scan_kernel, neus_loss.forward_kernel,
                neus_loss.backward_kernel)
    before = [c.launches for c in counters]
    k_total, k_m, k_keep, k_g, k_leaves, _, _ = _run(
        neus_loss.neus_loss, args, torch.float32)
    launched = [c.launches - b for c, b in zip(counters, before)]
    # the kernels' own α, logs, C and T, from one more forward that
    # writes its logs and C
    p = neus_loss.prepare(*[x.detach() for x in k_leaves], inp0, opt)
    fwd = neus_loss.forward(p, with_prefix=True)
    twin = prefix_checks(p, fwd, inp0)
    twin.pop("cum_twin")
    # C apart from the kernels: the twin's order on the float32 plain
    # version's logs of the same inputs. The float64 composite takes the
    # kernels' own C and α values (its derivatives its own), each held
    # apart by `scan_checks`: C is the float32 nearest the exact prefix, so
    # where the two α differ by their float32 errors (1e−6) the two exact
    # prefixes may round a step apart (0.03 in log T at |C| ≈ 3e5) at some
    # hundreds of slots, which moves those rays' colour and gradients by
    # 3%; and at a nearly opaque sample whose later samples are still
    # kept (1 − α ≥ 1e−4 / T) the backward's G/(1 − α) turns α's float32
    # error into up to a few per cent of that entry
    with torch.no_grad():
        alpha32, T32, _, _ = neus_loss.alpha_and_trans(
            *[x.detach() for x in k_leaves[:2]], k_leaves[3].detach(),
            k_leaves[4].detach(), inp0, opt)
    cum_ref = neus_loss.prefix_twin(plain_logs(alpha32))

    def fed(lw):
        return fwd.cum
    p_total, p_m, p_keep, p_g, _, _, _ = _run(neus_loss.plain, args,
                                              torch.float32)
    # the float64 run takes a scalar variance per sample, which gives the
    # terms of its gradient's sum
    v = args[3]
    per_sample_v = v.dim() == 1 and v.numel() == S
    v64 = v if per_sample_v else v.detach().reshape(()).expand(S).clone()
    d_total, d_m, d_keep, d_g, d_leaves, d_inp, _ = _run(
        functools.partial(neus_loss.plain, prefix=fed,
                          alpha_values=fwd.alpha),
        (*args[:3], v64, *args[4:]), torch.float64)
    with torch.no_grad():
        alpha64, T64, alive64, _ = neus_loss.alpha_and_trans(
            *d_leaves[:2], d_leaves[3], d_leaves[4], d_inp, opt, fed)
    scan = scan_checks(fwd.lw, fwd.cum, fwd.alpha, alpha32, alpha64,
                       cum_ref)
    eps = TRANSMITTANCE_EPSILON
    band = alive64 & ((T64 / eps - 1.0).abs() < KEEP_BAND)
    rid = torch.clamp_max(inp0.ray_id, R - 1)
    in_seg = inp0.ray_id < R
    seg_ids = torch.where(in_seg, inp0.ray_id, R)
    flip_rays = torch.zeros(R + 1, dtype=torch.bool, device=sdf.device)
    flip_rays[seg_ids[band]] = True
    flip_rays[R] = False
    # rays whose weight sum the mask term's clamp takes in one version and
    # passes in the other (the kernels' float32 sum and float64's on two
    # sides of a bound): the clamp's gradient, 0 or the whole mask term's,
    # differs for the whole ray
    ws64 = torch.zeros(R + 1, dtype=torch.float64, device=sdf.device
                       ).index_add_(0, seg_ids, torch.where(
                           d_keep, fwd.alpha.double() * T64,
                           torch.zeros_like(T64)))[:R]
    ws_k = fwd.ray_saved[:, 4]
    clamp_flip = ((ws_k >= WS_LO32) & (ws_k <= WS_HI32)) != (
        (ws64 >= WS_LO) & (ws64 <= WS_HI))
    flip_rays[:R] |= clamp_flip
    slot_ok = ~(flip_rays[rid] & in_seg)
    # T where both versions walk: kept samples in float64, outside the band
    walked = d_keep & ~band
    log64 = torch.log(T64)

    def log_t_err(T):
        return float((torch.log(T.double()) - log64)[walked].abs().max()) \
            if walked.any() else 0.0

    def grad_errs(gs):
        """`grad_errors` of each gradient over the slots and rays left
        in; the scalar variance's largest abs error against the sum of
        its terms' magnitudes."""
        out = {}
        for name, g, w in zip(GRADS, gs, d_g):
            if name == "variance" and not per_sample_v:
                out[name] = {"max_abs_err": abs(float(g) - float(w.sum())),
                             "scale": float(w[slot_ok].abs().sum())}
            elif g.shape[0] == S:
                m = slot_ok.view(-1, *([1] * (g.dim() - 1))).expand_as(g)
                out[name] = grad_errors(g[m], w[m])
            else:
                keep_r = ~flip_rays[:R]
                out[name] = grad_errors(g[keep_r], w[keep_r])
        return out

    def scalar_errs(total, m):
        rel = {"total": abs(float(total) - float(d_total))
               / max(abs(float(d_total)), 1e-30)}
        for k in SCALARS:
            rel[k] = abs(float(m[k]) - float(d_m[k])) / max(
                abs(float(d_m[k])), 1e-30)
        return rel

    def forward_err(total, m):
        c, c64 = m["_per_ray_color_logged"].double(), \
            d_m["_per_ray_color_logged"]
        keep_r = ~flip_rays[:R]
        return {"total_abs_err": abs(float(total) - float(d_total)),
                "color_max_abs_err": float((c - c64)[keep_r].abs().max()),
                "color_max_abs": float(c64.abs().max())}

    kern = {"forward": forward_err(k_total, k_m),
            "scalars_rel_err": scalar_errs(k_total, k_m),
            "grads": grad_errs(k_g), "max_abs_dlogT": log_t_err(fwd.trans),
            "counts": {k: int(k_m[k]) for k in COUNTS},
            "keep_differs_outside_band": int(((k_keep != d_keep) & ~band)
                                              .sum())}
    f32 = {"forward": forward_err(p_total, p_m),
           "scalars_rel_err": scalar_errs(p_total, p_m),
           "grads": grad_errs(p_g), "max_abs_dlogT": log_t_err(T32),
           "keep_differs": int((p_keep != d_keep).sum())}
    seg = torch.bincount(torch.where(in_seg, inp0.ray_id, R),
                         minlength=R + 1)[:R]
    report = {
        "case": label, "S": S, "R": R, "launches": launched,
        "scan": scan, "prefix": twin,
        "longest_segment": int(seg.max()),
        "kept_float64": int(d_keep.sum()),
        "near_threshold_samples": int(band.sum()),
        "rays_left_out": int(flip_rays.sum()),
        "rays_across_the_mask_clamp": int(clamp_flip.sum()),
        "counts_float64": {k: int(d_m[k]) for k in COUNTS},
        "kernel": kern, "plain_float32": f32,
        "tolerances": {"scalar_rtol": SCALAR_RTOL, "color_tol": COLOR_TOL,
                       "grad_rtol": GRAD_RTOL, "grad_atol": GRAD_ATOL,
                       "grad_off_share": GRAD_OFF_SHARE,
                       "grad_tol": GRAD_TOL, "log_T_tol": LOG_T_TOL,
                       "log_T_steps": LOG_T_STEPS,
                       "plain_factor": PLAIN_FACTOR,
                       "plain_log_T_ok": PLAIN_LOG_T_OK,
                       "keep_band": KEEP_BAND},
    }
    plain_ok = f32["max_abs_dlogT"] <= PLAIN_LOG_T_OK

    def tol(fixed, plain_err):
        return max(fixed, PLAIN_FACTOR * plain_err) if plain_ok else fixed

    checks = {
        "launches": launched == [1, 1, 1],
        "scalars": all(v <= SCALAR_RTOL
                       for v in kern["scalars_rel_err"].values()),
        "color": kern["forward"]["color_max_abs_err"]
        <= tol(COLOR_TOL * kern["forward"]["color_max_abs"],
               f32["forward"]["color_max_abs_err"]),
        "log_T": kern["max_abs_dlogT"] <= LOG_T_TOL,
        "keep": kern["keep_differs_outside_band"] == 0,
        "n_rays_alive": kern["counts"]["n_rays_alive"]
        == report["counts_float64"]["n_rays_alive"],
        "n_samples_kept": abs(kern["counts"]["n_samples_kept"]
                              - report["counts_float64"]["n_samples_kept"])
        <= int(band.sum()),
    }
    report["failed"] = [k for k, ok in checks.items() if not ok] + [
        f"grad:{k}" for k in grads_failed(kern["grads"], f32["grads"],
                                          plain_ok)] + [
        f"prefix:{k}" for k in twin["failed"]] + [
        f"scan:{k}" for k in scan["failed"]]
    report["ok"] = not report["failed"]
    return report


def edge_case_calls(device, seed: int = 0) -> list:
    """(label, arguments of a `neus_loss` call) of the edge-case batch on
    `device` under the configurations the CPU tests cover, and of the
    tile batch (`TILE_BATCH`) under `TILE_CASES`, each taken through
    `training_loss` on the card."""
    from ..config import LossConfig, RenderFlags
    from ..render.losses import training_loss

    calls = []
    for label, full, attrs, flags, cfg, div in EDGE_CASES + TILE_CASES:
        kw = TILE_BATCH if label.startswith("tiles") else dict(full=full)
        field, samples, batch = torch_batch(loss_batch(seed, **kw),
                                            device, attrs)
        _, got = capture_call(lambda: training_loss(
            field, samples, batch, RenderFlags(**flags), LossConfig(**cfg),
            0.5 if label == "anneal" else 1.0, *div))
        calls.append((label, got[0]))
    return calls


# (label, full buffer, sample attrs, RenderFlags, LossConfig, divisors)
EDGE_CASES = [
    ("default", False, True, {}, {}, ()),
    ("full_buffer", True, True, {}, {}, ()),
    ("ray_directions", False, False, {}, {}, ()),
    ("l1_rgbplus_bce", False, True, dict(apply_l2=False, apply_bce=True),
     {}, ()),
    ("no_albedo_relu", False, True, dict(apply_no_albedo=True,
                                         apply_relu=True), {}, ()),
    ("ref_jacobian_floor", False, True, {},
     dict(rgbplus_ref_jacobian=True, rgbplus_grad_floor=0.05), ()),
    ("stopgrads", False, False, {},
     dict(debug_stopgrad_alpha_normal=True,
          debug_stopgrad_shading_normal=True,
          debug_stopgrad_alpha_sdf=True), ()),
    ("emulations", False, True, {},
     dict(fp16_grad_emulation=True, rollover_grad_emulation=True), ()),
    ("anneal", False, True, dict(apply_rgbplus=False), {}, (1000, 5000)),
    # the eikonal term's weight: the CPU tests' divisors case, and one
    # where it outweighs the colour and mask terms
    ("divisors", False, True, {},
     dict(mask_loss_weight=0.5, ek_loss_weight=0.1), (1200, 9000)),
    ("eikonal", False, True, {},
     dict(mask_loss_weight=0.0, ek_loss_weight=1.0), (1 << 20, 64)),
]


# a buffer of eight tiles of the kernels (1024 slots each), full: the long
# ray's 3,000 faint slots cross two tile boundaries with samples kept on
# both sides, and the last kept ray takes the ~5,100 slots left (five
# tiles)
TILE_BATCH = dict(n_rays=40, n_slots=8192, full=True, long_slots=3000)
TILE_CASES = [
    ("tiles", True, True, {}, {}, ()),
    ("tiles_ray_directions", True, False, {}, {}, ()),
    ("tiles_emulations", True, True, {},
     dict(fp16_grad_emulation=True, rollover_grad_emulation=True), ()),
]
