"""The loss layer (`kernels/neus_loss.py`: the plain version that the CPU
takes, and the interface of the three CUDA kernels that the card takes)
against the JAX package's `training_loss`: on the seeded edge-case batch of
`testing/loss_batch.py` (a few hundred rays, 2,048 slots), the total,
every metric and the VJP wrt each field output (sdf, ∇sdf, raw albedo,
variance) and, with `sample_attrs=None`, wrt ray_d, for every flag and
config case. The kernels themselves need the card: tests/test_torch_gpu.py
and chip_smoke.py hold them against this plain version run in float64."""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rnb_neus2_tpu import config as jconfig
from rnb_neus2_tpu.ops.ray_march import FlatSamples as JFlatSamples
from rnb_neus2_tpu.render import losses as jlosses
from rnb_neus2_torch import config
from rnb_neus2_torch.kernels import neus_loss
from rnb_neus2_torch.render import losses, neus
from rnb_neus2_torch.testing import loss_batch as lb
from rnb_neus2_torch.tools import loss_check

# case → (full buffer, sample attrs, RenderFlags, LossConfig,
#         cos_anneal_ratio, (n_rays_divisor, ek_samples_divisor))
CASES = {
    "default": (False, True, {}, {}, 1.0, ()),
    "l1_bce": (False, True, dict(apply_l2=False, apply_bce=True), {}, 1.0,
               ()),
    "supernormal_relu": (False, True, dict(apply_supernormal=True,
                                           apply_relu=True), {}, 1.0, ()),
    "l1_rgbplus": (False, True, dict(apply_l2=False), {}, 1.0, ()),
    "no_rgbplus_anneal": (False, True, dict(apply_rgbplus=False), {}, 0.5,
                          ()),
    "no_albedo": (False, True, dict(apply_no_albedo=True), {}, 1.0, ()),
    "light_opti": (False, True, dict(apply_light_opti=True), {}, 1.0, ()),
    "stopgrad_alpha_normal": (False, True, {},
                              dict(debug_stopgrad_alpha_normal=True), 1.0,
                              ()),
    "stopgrad_shading_normal": (False, True, {},
                                dict(debug_stopgrad_shading_normal=True),
                                1.0, ()),
    "stopgrad_alpha_sdf": (False, True, {},
                           dict(debug_stopgrad_alpha_sdf=True), 1.0, ()),
    "grad_floor": (False, True, {}, dict(rgbplus_grad_floor=0.05), 1.0, ()),
    "ref_jacobian": (False, True, {}, dict(rgbplus_ref_jacobian=True), 1.0,
                     ()),
    "fp16_emulation": (False, True, {}, dict(fp16_grad_emulation=True), 1.0,
                       ()),
    "rollover_emulation": (False, True, {},
                           dict(rollover_grad_emulation=True), 1.0, ()),
    "divisors": (False, True, {}, dict(mask_loss_weight=0.5,
                                       ek_loss_weight=0.1), 1.0, (1200, 9000)),
    "ray_directions": (False, False, {}, {}, 1.0, ()),
    "ray_directions_stopgrads": (False, False, {},
                                 dict(debug_stopgrad_alpha_normal=True,
                                      debug_stopgrad_shading_normal=True),
                                 1.0, ()),
    "full_buffer": (True, True, {}, {}, 1.0, ()),
}
METRICS = ("loss_color", "loss_mask", "loss_ek", "weight_sum_mean",
           "inv_s", "n_samples_kept", "n_rays_alive")


def _jax_batch(b, attrs: bool):
    """JAX's FlatSamples and RayBatch of the numpy batch. Raw albedo that
    sits exactly on ±10 goes to JAX one float32 step inside the clamp: at a
    tie JAX's clip passes half the gradient (lax.max/min split it) where
    torch.clamp, and the kernels, pass all of it; one step inside, JAX
    passes all of it too, and exp moves by 1e−6 relative."""
    i32 = lambda a: jnp.asarray(np.asarray(a, np.int32))  # noqa: E731
    samples = JFlatSamples(
        t=jnp.asarray(b["t"]), dt=jnp.asarray(b["dt"]),
        ray_id=i32(b["ray_id"]), valid=jnp.asarray(b["valid"]),
        seg_start=i32(b["seg_start"]), n_valid=i32(b["n_valid"]),
        ray_kept=jnp.asarray(b["ray_kept"]))
    batch = jlosses.RayBatch(
        ray_o=jnp.asarray(b["ray_o"]), ray_d=jnp.asarray(b["ray_d"]),
        alive=jnp.asarray(b["alive"]), normal_gt=jnp.asarray(b["normal_gt"]),
        albedo_gt=jnp.asarray(b["albedo_gt"]),
        mask_color=jnp.asarray(b["mask_color"]),
        mask_gt=jnp.asarray(b["mask_gt"]), rot_c2w=jnp.asarray(b["rot_c2w"]),
        light_idx=i32(b["light_idx"]), pdf=jnp.asarray(b["pdf"]),
        sample_attrs=jnp.asarray(b["sample_attrs"]) if attrs else None)
    raw = b["albedo_raw"]
    raw = np.where(np.abs(raw) == 10.0,
                   np.nextafter(raw, np.float32(0.0)), raw)
    return samples, batch, raw


def _jax(b, attrs, flags, cfg, anneal, div):
    samples, batch, raw = _jax_batch(b, attrs)
    jflags, jcfg = jconfig.RenderFlags(**flags), jconfig.LossConfig(**cfg)

    def f(sdf, grad, alb, v, ray_d):
        out = {"sdf": sdf, "grad": grad, "albedo_raw": alb, "variance": v}
        return jlosses.training_loss(out, samples,
                                     batch._replace(ray_d=ray_d), jflags,
                                     jcfg, anneal, *div)

    primals = [jnp.asarray(b["sdf"]), jnp.asarray(b["grad"]),
               jnp.asarray(raw), jnp.asarray(b["variance"]),
               jnp.asarray(b["ray_d"])]
    total, vjp, metrics = jax.vjp(f, *primals, has_aux=True)
    grads = vjp(jnp.ones_like(total))
    return float(total), {k: np.asarray(v) for k, v in metrics.items()}, \
        [np.asarray(g, np.float64) for g in grads]


def _port(b, attrs, flags, cfg, anneal, div):
    field, samples, batch = lb.torch_batch(b, "cpu", attrs)
    batch = batch._replace(ray_d=batch.ray_d.requires_grad_())
    total, metrics = losses.training_loss(
        field, samples, batch, config.RenderFlags(**flags),
        config.LossConfig(**cfg), anneal, *div)
    leaves = [field[k] for k in lb.FIELD] + [batch.ray_d]
    grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                materialize_grads=True)
    return float(total.detach()), \
        {k: v.detach().numpy() for k, v in metrics.items()}, \
        [g.double().numpy() for g in grads]


@pytest.fixture(scope="module")
def batches():
    return {full: lb.loss_batch(0, full=full) for full in (False, True)}


# a gradient entry's largest error, in units of the JAX tensor's largest
# entry: 5e-5, and 5e-4 where the function jumps (L1's sign of pred −
# target, fp16's rounding steps of 2^−11) and the two float32 orders land
# on either side of a jump
WORST = {"l1_bce": 5e-4, "fp16_emulation": 5e-4}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_vjp_match_jax(batches, case):
    """Total and metrics rtol 1e-5 (float32 sums in another order: the
    segment sums, the global cumsum), the per-ray colour rtol 2e-4 with
    atol 1e-5 of its largest entry (both sum log T over the whole buffer
    in float32, in another order: a ray late in the buffer moves by up to
    1e-4 relative; rays whose colour cancels to near 0 by the atol);
    the kept and alive counts exactly. Gradients: an entry is a sum of
    terms that cancel (g_α = g_w·T − G/(1 − α), where 1 − α is small at
    opaque samples), so it carries float32 rounding on the scale of its
    terms: at most 3% of a tensor's entries may miss rtol 1e-4 (atol 1e-6
    of its largest entry), and none by more than `WORST`. With sample
    attrs, ray_d gets no gradient in either."""
    full, attrs, flags, cfg, anneal, div = CASES[case]
    b = batches[full]
    jt, jm, jg = _jax(b, attrs, flags, cfg, anneal, div)
    pt, pm, pg = _port(b, attrs, flags, cfg, anneal, div)
    assert pt == pytest.approx(jt, rel=1e-5)
    for k in METRICS:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5, err_msg=k)
    for k in ("n_samples_kept", "n_rays_alive"):
        assert int(pm[k]) == int(jm[k]), k
    c, jc = pm["_per_ray_color_logged"], jm["_per_ray_color_logged"]
    np.testing.assert_allclose(c, jc, rtol=2e-4,
                               atol=1e-5 * np.abs(jc).max())
    for name, a, w in zip(lb.FIELD + ("ray_d",), pg, jg):
        a, scale = a.reshape(w.shape), np.abs(w).max()
        off = ~np.isclose(a, w, rtol=1e-4, atol=1e-6 * scale)
        assert off.mean() <= 0.03, (name, off.mean())
        assert np.abs(a - w).max() <= WORST.get(case, 5e-5) * scale, name
    if attrs:
        assert not np.any(pg[4]) and not np.any(jg[4])
    else:
        assert np.abs(pg[4]).max() > 0


def test_the_batch_has_its_edge_cases(batches):
    """Each role of `loss_batch` holds on the plain version's values: the
    opaque sample's alpha in (1 − 1e−7, 1) and the weight sum of its ray
    on the upper rail, the long ray's transmittance crossing 1e−4
    mid-segment, the faint ray's weight sum on the lower rail, raw albedo
    on ±10, a negative RGB+ argument, a dropped ray, a ray without slots,
    unused slots, and in the full buffer a kept ray starting at S."""
    roles = lb.ROLES
    b = batches[False]
    field, samples, batch = lb.torch_batch(b, "cpu")
    args = (field["sdf"], field["grad"], field["albedo_raw"],
            field["variance"], batch.sample_attrs)
    inp = neus_loss.LossInputs(
        dt=samples.dt, ray_id=samples.ray_id, valid=samples.valid,
        seg_start=samples.seg_start, ray_kept=samples.ray_kept,
        alive=batch.alive, light=torch.zeros(len(batch.alive), 3),
        target4=torch.zeros(len(batch.alive), 4), mask_gt=batch.mask_gt,
        mask_color=batch.mask_color, per_sample_dirs=True)
    opt = neus_loss.LossOptions(config.RenderFlags(), config.LossConfig(),
                                1.0, 300, 2048)
    with torch.no_grad():
        alpha, trans, alive, _ = neus_loss.alpha_and_trans(
            args[0], args[1], args[3], args[4], inp, opt)
    rid = samples.ray_id

    def slots(r):
        return torch.nonzero(rid == r).flatten()

    op = slots(roles["opaque"])[2]
    cap = np.float32(1.0 - 1e-7)
    assert cap < float(alpha[op]) < 1.0
    # in float64 it is 1 − 1.07e−7, just below the clamp: T after it is
    # below 1e−6 either way, so no later sample of the ray is kept
    a64 = neus.sdf_to_alpha(*(x.detach().double()[op:op + 1] for x in (
        args[0], (args[4][:, :3] * args[1]).sum(-1), samples.dt)),
        torch.exp(10.0 * args[3].detach().double()), 1.0)
    assert 1.0 - 2e-7 < float(a64) < 1.0
    w = torch.where(alive & (trans >= 1e-4), alpha * trans, 0.0)
    ws = torch.zeros(301).index_add_(0, torch.clamp_max(rid, 300), w)
    assert ws[roles["opaque"]] > 1.0 - 1e-4
    assert ws[roles["faint"]] < 1e-4 and ws[roles["rail_albedo"]] < 1e-4
    long = trans[slots(roles["long"])]
    assert long[0] == 1.0 and long[-1] < 1e-4 and (long >= 1e-4).sum() > 5
    assert (np.abs(b["albedo_raw"]) == 10.0).any()
    a3 = neus_loss.albedo_activation(field["albedo_raw"].detach())
    assert ((3.0 - (a3 * a3).sum(-1))[slots(roles["bright"])] < 0).all()
    assert len(slots(roles["no_slots"])) == 0 and not b["alive"][roles[
        "dead"]]
    assert not b["ray_kept"].all() and not b["valid"].all()
    full = batches[True]
    assert full["valid"].all() and full["seg_start"].max() == 2048
    assert full["ray_kept"][np.flatnonzero(full["seg_start"] == 2048)].any()


def test_the_structs_match_the_kernel_source():
    """The ctypes structs that the wrapper fills have the field names and
    types, in order, of csrc/neus_loss.cu's structs."""
    src = (Path(neus_loss.__file__).parent.parent / "csrc"
           / neus_loss.SOURCE).read_text()
    kinds = {"int": "c_int", "float": "c_float"}
    for struct, cls in (("Options", neus_loss._Options),
                        ("Inputs", neus_loss._Inputs),
                        ("ForwardOut", neus_loss._ForwardOut),
                        ("BackwardIO", neus_loss._BackwardIO)):
        body = re.search(rf"struct {struct} {{(.*?)\n}};", src, re.S)[1]
        fields = re.findall(r"^\s*(?:const )?([\w ]+?)(\*?)\s+(\w+);", body,
                            re.M)
        want = [(n, "c_void_p" if star else kinds[t.strip()])
                for t, star, n in fields]
        got = [(n, t.__name__) for n, t in cls._fields_]
        assert got == want, struct


def test_wrapper_takes_plain_on_cpu_and_checks_its_inputs(batches):
    field, samples, batch = lb.torch_batch(batches[False], "cpu")
    inp = neus_loss.LossInputs(
        dt=samples.dt, ray_id=samples.ray_id, valid=samples.valid,
        seg_start=samples.seg_start, ray_kept=samples.ray_kept,
        alive=batch.alive, light=torch.zeros(300, 3),
        target4=torch.zeros(300, 4), mask_gt=batch.mask_gt,
        mask_color=batch.mask_color, per_sample_dirs=True)
    opt = neus_loss.LossOptions(config.RenderFlags(), config.LossConfig(),
                                1.0, 300, 2048)
    args = [field[k] for k in lb.FIELD] + [batch.sample_attrs]
    counters = (neus_loss.scan_kernel, neus_loss.forward_kernel,
                neus_loss.backward_kernel)
    before = [c.launches for c in counters]
    total, _, keep = neus_loss.neus_loss(*args, inp, opt)
    ptotal, _, pkeep = neus_loss.plain(*args, inp, opt)
    assert torch.equal(total, ptotal) and torch.equal(keep, pkeep)
    assert [c.launches for c in counters] == before
    neus_loss.check_inputs(*args, inp)
    with pytest.raises(TypeError):
        neus_loss.check_inputs(args[0].double(), *args[1:], inp)
    with pytest.raises(ValueError):
        neus_loss.check_inputs(args[0][:-1], *args[1:], inp)
    with pytest.raises(ValueError):
        neus_loss.check_inputs(*args[:4], batch.ray_d, inp)
    with pytest.raises(ValueError):
        neus_loss.neus_loss(*(a.to("meta") for a in args), inp, opt)


@pytest.mark.parametrize("case", ["default", "divisors", "eikonal"])
def test_the_float64_check_sees_a_dropped_eikonal_gradient(case):
    """`loss_batch.grads_failed`, the card's gradient check, on the edge-case
    batch: the float64 plain version's gradients pass against themselves,
    and fail where the eikonal term's backward is dropped (the loss's
    gradients with its weight set to 0), in ∇sdf's gradient by the share
    of entries that miss the relative bound. At the default weight that
    term is far below 1e−3 of ∇sdf's largest gradient entry."""
    label, full, attrs, flags, cfg, div = next(
        c for c in lb.EDGE_CASES if c[0] == case)
    field, samples, batch = lb.torch_batch(lb.loss_batch(0, full=full),
                                           "cpu", attrs)
    _, (args,) = lb.capture_call(lambda: losses.training_loss(
        field, samples, batch, config.RenderFlags(**flags),
        config.LossConfig(**cfg), 1.0, *div))
    opt = args[6]
    no_ek = opt._replace(cfg=dataclasses.replace(opt.cfg,
                                                 ek_loss_weight=0.0))
    want = lb._run(neus_loss.plain, args, torch.float64)[3]
    dropped = lb._run(neus_loss.plain, (*args[:6], no_ek), torch.float64)[3]

    def errs(gs):
        return {n: lb.grad_errors(g, w)
                for n, g, w in zip(lb.GRADS, gs, want)}

    assert lb.grads_failed(errs(want), errs(want), True) == []
    bad = errs(dropped)
    assert lb.grads_failed(bad, bad, False) == ["grad"]
    assert bad["grad"]["off_share"] > 10 * lb.GRAD_OFF_SHARE
    assert all(bad[n]["max_abs_err"] == 0.0 for n in lb.GRADS
               if n != "grad")


def test_the_pipelines_train_with_the_chosen_loss(batches):
    """`tools/loss_check.py --loss`: each choice is the named version on
    the edge-case batch's arguments (on the CPU the kernels' entry point
    takes the plain version), and `pipelines` puts `neus_loss.neus_loss`
    back."""
    field, samples, batch = lb.torch_batch(batches[False], "cpu")
    _, (args,) = lb.capture_call(lambda: losses.training_loss(
        field, samples, batch, config.RenderFlags(), config.LossConfig()))
    args = (*[x.detach() for x in args[:5]], *args[5:])
    got = {k: float(fn(*args)[0]) for k, fn in loss_check.LOSSES.items()}
    assert got["kernels"] == float(neus_loss.plain(*args)[0])
    assert got["plain"] == got["kernels"]
    assert got["plain_twin"] == float(neus_loss.plain(
        *args, prefix=neus_loss.prefix_twin)[0])
    real = neus_loss.neus_loss
    loss_check.pipelines(0, 1, "plain")
    assert neus_loss.neus_loss is real


def test_the_planted_fault_finds_its_line():
    """`tools/loss_check.py --planted` edits the backward kernel's
    eikonal gradient, which must stand in the source exactly once."""
    src = (Path(neus_loss.__file__).parent.parent / "csrc"
           / neus_loss.SOURCE).read_text()
    out = loss_check.plant(src)
    assert "const float ge = 0.f;" in out
    assert loss_check.EIKONAL_LINE not in out
    with pytest.raises(ValueError):
        loss_check.plant(out)


def test_the_planted_scan_fault_finds_its_line():
    """`tools/loss_check.py --planted`'s second fault moves the scan
    kernel's logs one slot on within the tile: its line stands in the
    source exactly once, and the planted source has it no more."""
    src = (Path(neus_loss.__file__).parent.parent / "csrc"
           / neus_loss.SOURCE).read_text()
    line, planted_line = loss_check.PLANTS["scan_shift"]
    out = loss_check.plant(src, "scan_shift")
    assert planted_line in out and line not in out
    with pytest.raises(ValueError):
        loss_check.plant(out, "scan_shift")
