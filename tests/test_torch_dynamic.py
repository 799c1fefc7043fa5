"""Dynamic scenes of the PyTorch port against the JAX package: the field
with differentiable positions, the rigid-delta functions, the delta phase
and a frame's canonical phase of `FrameSequenceTrainer` on JAX's own
draws, and `extract_mesh` of a later frame, which the port maps in
unit-cube coordinates (the one deliberate difference).

The sequence runs at 4 levels, a 2^15 table, 8192 samples and 32×32
views, with the exact backward so that float noise flips no stochastic
pick. Before every step the test reproduces the JAX trainer's key splits
(a split for an occupancy refresh when the cadence asks for one and one
for a training step; one per delta step; `sample_ray_batch` splits its
key four ways) and hands the port the same numbers, as
tests/test_torch_trainer_parity.py does."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rnb_neus2_tpu import config as jconfig
from rnb_neus2_tpu.grid import occupancy as joccupancy
from rnb_neus2_tpu.io.dataset import SceneMeta as JSceneMeta
from rnb_neus2_tpu.io.dataset import build_dataset as jbuild
from rnb_neus2_tpu.models import delta_network as jdn
from rnb_neus2_tpu.models.neus_field import NeusField as JNeusField
from rnb_neus2_tpu.models.neus_field import init_params
from rnb_neus2_tpu.testing import synthetic as jsynthetic
from rnb_neus2_tpu.train import dynamic as jdynamic
from rnb_neus2_torch import config, interop
from rnb_neus2_torch.grid import occupancy
from rnb_neus2_torch.io.dataset import SceneMeta, build_dataset
from rnb_neus2_torch.models import delta_network as dn
from rnb_neus2_torch.models.neus_field import NeusField
from rnb_neus2_torch.testing import synthetic
from rnb_neus2_torch.train import dynamic
from rnb_neus2_torch.train import trainer as trainer_mod
from rnb_neus2_torch.train.sampler import RayUniforms

SHIFT = np.array([0.06, -0.04, 0.0], np.float32)
GRID = dict(n_levels=4, top_resolution=64, log2_hashmap_size=15)
FIRST, DELTA, NEXT = 5, 3, 4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(pkg):
    return pkg.TestbedConfig(
        grid=pkg.HashGridConfig(**GRID),
        network=pkg.NetworkConfig(stoch_corner_bwd=0),
        train=pkg.TrainConfig(target_batch_size=1 << 13,
                              initial_rays_per_batch=128, occ_grid_size=32,
                              seed=0),
        march=pkg.MarchConfig(n_ladder=512, cone_angle=1.0 / 256.0))


def _frame(center, jax_side):
    syn, build, meta = ((jsynthetic, jbuild, JSceneMeta) if jax_side
                        else (synthetic, build_dataset, SceneMeta))
    cams = syn.ring_cameras(4, 1.5, 32, 32, focal=70.0)
    normals, albedo, alphas = syn.render_sphere_views(cams, center=center,
                                                      radius=0.2)
    return build(cams, normals, albedo, alphas, alphas, meta())


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _uniforms(k, R):
    k_xy, k_skip, k_light, k_start = jax.random.split(k, 4)
    return RayUniforms(xy=_t(jax.random.uniform(k_xy, (R, 2))),
                       skip=_t(jax.random.uniform(k_skip, (R,))),
                       start=_t(jax.random.uniform(k_start, (R,))),
                       light_idx=_t(jax.random.randint(k_light, (R,), 0, 3),
                                    torch.int64))


def _train_draws(key, step, R, n, g):
    """The draws of n JAX training steps from `step` at R rays (no chunk,
    no read that changes R in between): (jitters, uniforms, key)."""
    jit, uni = [], []
    for s in range(step, step + n):
        if s % joccupancy.update_cadence(s) == 0:
            key, k = jax.random.split(key)
            jit.append(_t(jax.random.uniform(k, (g ** 3, 3))))
        key, k = jax.random.split(key)
        uni.append(_uniforms(k, R))
    return jit, uni, key


def _np_tree(t):
    return jax.tree_util.tree_map(np.array, t)


@pytest.fixture(scope="module")
def run():
    """Both sequences: FIRST steps of frame 0, then `advance_frame` to the
    shifted sphere with DELTA delta steps and NEXT canonical steps, each
    step on JAX's draws. Records the delta, its Adam moments and the loss
    after every delta step of both."""
    dyn = dict(predict_global_movement_training_step=DELTA,
               next_frame_max_training_step=NEXT)
    jseq = jdynamic.FrameSequenceTrainer(
        _frame((0.5, 0.5, 0.5), True), _cfg(jconfig),
        jdynamic.DynamicConfig(**dyn))
    seq = dynamic.FrameSequenceTrainer(
        _frame((0.5, 0.5, 0.5), False), _cfg(config),
        dynamic.DynamicConfig(**dyn), device="cpu")
    seq.trainer = trainer_mod.Trainer(
        seq.trainer.dataset, seq.cfg, device="cpu",
        params=interop.params_from_jax(_np_tree(jseq.trainer.params)))
    jtr, tr = jseq.trainer, seq.trainer
    g = tr.cfg.train.occ_grid_size
    queue = {"jitter": [], "uniforms": []}
    mp = pytest.MonkeyPatch()
    for mod in (trainer_mod, dynamic):
        real = mod.sample_ray_batch
        mp.setattr(mod, "sample_ray_batch", lambda *a, _r=real, **k: _r(
            *a, **{**k, "uniforms": queue["uniforms"].pop(0)}))
    real_cells = occupancy.cell_positions
    mp.setattr(occupancy, "cell_positions",
               lambda g, gen=None, device="cpu": real_cells(
                   g, gen, device, jitter=queue["jitter"].pop(0)))

    def feed(jit, uni):
        assert not queue["jitter"] and not queue["uniforms"]
        queue["jitter"][:], queue["uniforms"][:] = jit, uni

    try:
        jit, uni, _ = _train_draws(jtr.key, 0, jtr._bucket(), FIRST, g)
        feed(jit, uni)
        jseq.train_first_frame(FIRST)
        seq.train_first_frame(FIRST)
        assert (tr.step, tr.n_rays) == (jtr.step, jtr.n_rays)

        # the delta phase: one key split per step at the phase's ray count
        n_delta = max(min(jtr.n_rays, 8192), 4096)
        key, uni = jtr.key, []
        for _ in range(DELTA):
            key, k = jax.random.split(key)
            uni.append(_uniforms(k, n_delta))
        jit2, uni2, _ = _train_draws(key, jtr.step, jtr._bucket(), NEXT, g)
        feed(jit2, uni + uni2)

        jrec, rec = [], []
        real_fn = jseq._delta_step_fn

        def jfn(n):
            fn = real_fn(n)

            def step(*a):
                out = fn(*a)
                jrec.append(_np_tree(out[:3]))
                return out
            return step

        jseq._delta_step_fn = jfn
        real_step = seq.delta_step

        def step(n):
            loss = real_step(n)
            rec.append(({k: v.clone() for k, v in seq.delta.items()},
                        {k: v.clone() for k, v in seq.delta_opt.mu.items()},
                        {k: v.clone() for k, v in seq.delta_opt.nu.items()},
                        float(loss)))
            return loss

        seq.delta_step = step
        jdelta = jseq.advance_frame(_frame(tuple(0.5 + SHIFT), True))
        delta = seq.advance_frame(_frame(tuple(0.5 + SHIFT), False))
        assert not queue["jitter"] and not queue["uniforms"]
    finally:
        mp.undo()
    return dict(jseq=jseq, seq=seq, jrec=jrec, rec=rec,
                jdelta=_np_tree(jdelta), delta=delta)


def _close(got, want, atol, what):
    for k in want:
        err = float(np.abs(got[k].detach().numpy() - np.asarray(want[k])
                           ).max())
        assert err <= atol, (what, k, err)


def test_delta_steps_match_jax(run):
    """Every delta step: the loss within 1e-5 relative; the delta and its
    Adam moments within 1e-4 of the JAX package's (optax's adam in its
    float order). The EMA of the delta is what the phase adopts."""
    jrec, rec = run["jrec"], run["rec"]
    assert len(jrec) == len(rec) == DELTA
    for i, ((jd, jopt, jloss), (d, mu, nu, loss)) in enumerate(
            zip(jrec, rec)):
        assert loss == pytest.approx(float(jloss), rel=1e-5)
        inner = jopt[0]
        _close(d, jd, 1e-4, "delta")
        _close(mu, inner.mu, 1e-4, "mu")
        _close(nu, inner.nu, 1e-4, "nu")
        assert int(inner.count) == i + 1
    assert run["seq"].delta_opt.count == DELTA
    _close(run["delta"], run["jdelta"], 1e-4, "adopted EMA")
    assert any(float(np.abs(v).max()) > 1e-5 for v in (
        run["jdelta"]["translation"], run["jdelta"]["rotation6d"]
        - np.array([1, 0, 0, 0, 1, 0])))


def test_frame_canonical_phase_matches_jax(run):
    """The delta baked into the frame's cameras (rotation and origin
    within 1e-4), then NEXT canonical steps: the step count, rays, the
    bitfield, the parameters and the EMA as the trainer parity test holds
    them."""
    jtr, tr = run["jseq"].trainer, run["seq"].trainer
    jc, c = jtr.dataset.cameras, tr.dataset.cameras
    np.testing.assert_allclose(c.rot_c2w.numpy(), np.asarray(jc.rot_c2w),
                               atol=1e-4)
    np.testing.assert_allclose(c.origin.numpy(), np.asarray(jc.origin),
                               atol=1e-4)
    assert (tr.step, tr.n_rays) == (jtr.step, jtr.n_rays) == (
        FIRST + NEXT, jtr.n_rays)
    assert torch.equal(tr.occ.bitfield, _t(jtr.occ.bitfield))
    _close(tr.params, interop.params_from_jax(_np_tree(jtr.params)), 1e-4,
           "params")
    _close(tr.opt.ema, interop.params_from_jax(
        _np_tree(jtr.opt_state.ema_params)), 1e-4, "ema")


def test_dynamic_config_defaults_match_jax():
    assert dataclasses.asdict(dynamic.DynamicConfig()) == \
        dataclasses.asdict(jdynamic.DynamicConfig())


def test_cuda_by_default():
    """The sequence, the delta and the refinement parameters go to cuda
    unless the caller asks for the CPU; without a card that raises."""
    from rnb_neus2_torch.train import camera_refine as cr
    makers = (lambda: dynamic.FrameSequenceTrainer(
                  _frame((0.5, 0.5, 0.5), False), _cfg(config)),
              dn.init_delta_params, lambda: cr.init_refine_params(2))
    for make in makers:
        if torch.cuda.is_available():
            out = make()
            dev = (out.trainer.device if hasattr(out, "trainer")
                   else next(iter(out.values() if isinstance(out, dict)
                                  else out)).device)
            assert dev.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                make()


def _random_delta(seed):
    rng = np.random.default_rng(seed)
    return {"rotation6d": rng.standard_normal(6).astype(np.float32),
            "translation": rng.standard_normal(3).astype(np.float32) * 0.1}


def test_delta_network_matches_jax():
    """rotation_6d_to_matrix, apply_rigid, apply_rigid_points, compose and
    inverse_transform_points within 1e-6 of the JAX package's, and the
    gradient of a loss through them wrt the delta within 1e-5 of its
    largest entry (float32 cancellation in the Gram-Schmidt normalization;
    the tolerance of every gradient against `jax.grad` here)."""
    a, b = _random_delta(0), _random_delta(1)
    rng = np.random.default_rng(2)
    o = rng.random((33, 3)).astype(np.float32)
    d = rng.standard_normal((33, 3)).astype(np.float32)
    ja, jb = ({k: jnp.asarray(v) for k, v in x.items()} for x in (a, b))
    ta, tb = (interop.tensors_from_numpy(x) for x in (a, b))
    close = lambda got, want: np.testing.assert_allclose(
        got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    close(dn.rotation_6d_to_matrix(ta["rotation6d"]),
          jdn.rotation_6d_to_matrix(ja["rotation6d"]))
    for got, want in zip(dn.apply_rigid(ta, _t(o), _t(d)),
                         jdn.apply_rigid(ja, o, d)):
        close(got, want)
    close(dn.apply_rigid_points(ta, _t(o)), jdn.apply_rigid_points(ja, o))
    jc, c = jdn.compose(ja, jb), dn.compose(ta, tb)
    for k in jc:
        close(c[k], jc[k])
    close(dn.inverse_transform_points(ta, _t(o)),
          jdn.inverse_transform_points(ja, o))
    assert dn.init_delta_params("cpu")["rotation6d"].tolist() == \
        np.asarray(jdn.init_delta_params()["rotation6d"]).tolist()

    cot = rng.standard_normal((3, 33, 3)).astype(np.float32)

    def jloss(p):
        oo, dd = jdn.apply_rigid(p, o, d)
        return jnp.vdot(oo, cot[0]) + jnp.vdot(dd, cot[1]) + jnp.vdot(
            jdn.inverse_transform_points(p, o), cot[2])

    want = jax.grad(jloss)(ja)
    p = {k: v.requires_grad_() for k, v in interop.tensors_from_numpy(
        a).items()}
    oo, dd = dn.apply_rigid(p, _t(o), _t(d))
    c = torch.from_numpy(cot)
    loss = (oo * c[0]).sum() + (dd * c[1]).sum() + (
        dn.inverse_transform_points(p, _t(o)) * c[2]).sum()
    got = torch.autograd.grad(loss, list(p.values()))
    for g, k in zip(got, p):
        w = np.asarray(want[k])
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max(), k


def test_field_differentiable_positions_match_jax():
    """`NeusField(differentiable_positions=True)` against the JAX field's
    `apply(..., differentiable_positions=True)`: outputs within 1e-6 and
    the gradient of a loss of albedo, sdf and ∇sdf wrt the positions
    within 1e-5 relative to `jax.grad`'s (∇sdf carries the encode's
    second-order term). The parameters are moved off the init, whose
    hash-feature weights are zero."""
    jgrid, jnet = jconfig.HashGridConfig(**GRID), jconfig.NetworkConfig()
    params = _np_tree(init_params(jax.random.PRNGKey(0), jgrid, jnet))
    rng = np.random.default_rng(3)
    params["hash_table"] = (1e-2 * rng.standard_normal(
        params["hash_table"].shape)).astype(np.float32)
    w_x, w_enc = params["sdf_mlp"][0]
    params["sdf_mlp"][0] = (w_x, (0.1 * rng.standard_normal(
        w_enc.shape)).astype(np.float32))
    x = rng.random((301, 3)).astype(np.float32)
    x[:3] = [[0, 0, 0], [1, 1, 1], [0.5, 0.25, 1]]
    cot = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in (("albedo_raw", (301, 3)), ("sdf", (301,)),
                        ("grad", (301, 3)))}
    jfield = JNeusField(jgrid, jnet)

    def jloss(xx):
        out = jfield.apply(params, xx, differentiable_positions=True)
        return sum(jnp.vdot(out[k], cot[k]) for k in cot)

    jout = jfield.apply(params, jnp.asarray(x), differentiable_positions=True)
    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))

    field = NeusField(config.HashGridConfig(**GRID), config.NetworkConfig(),
                      device="cpu")
    field.load_state_dict(interop.params_from_jax(params))
    xt = torch.from_numpy(x).requires_grad_(True)
    with field.frozen():
        out = field(xt, differentiable_positions=True)
        loss = sum((out[k] * torch.from_numpy(cot[k])).sum() for k in cot)
        (got,) = torch.autograd.grad(loss, xt)
    for k in cot:
        want_k = np.asarray(jout[k])
        np.testing.assert_allclose(out[k].detach().numpy(), want_k,
                                   rtol=1e-6, atol=1e-6 * max(
                                       1.0, np.abs(want_k).max()))
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())


def test_extract_mesh_in_unit_cube_coordinates():
    """A later frame's mesh equals the JAX package's: the inverse delta
    applied to the canonical world-space vertices, F and N as the
    canonical mesh's (the normals not turned). Both from the same
    parameters (the geometric init's small sphere) at res 64, with a delta
    that rotates as well as moves, so the normals are held too; the
    canonical meshes (frame 0) are equal first."""
    jseq = jdynamic.FrameSequenceTrainer(_frame((0.5, 0.5, 0.5), True),
                                         _cfg(jconfig))
    seq = dynamic.FrameSequenceTrainer(_frame((0.5, 0.5, 0.5), False),
                                       _cfg(config), device="cpu")
    seq.trainer = trainer_mod.Trainer(
        seq.trainer.dataset, seq.cfg, device="cpu",
        params=interop.params_from_jax(_np_tree(jseq.trainer.params)))
    canon, jcanon = seq.extract_mesh(resolution=64), jseq.extract_mesh(
        resolution=64)
    np.testing.assert_allclose(canon["V"], jcanon["V"], atol=1e-5)
    assert len(canon["V"]) > 100
    c, s = np.cos(0.3), np.sin(0.3)
    delta = {"rotation6d": np.array([c, s, 0, -s, c, 0], np.float32),
             "translation": -SHIFT}
    jseq.delta = {k: jnp.asarray(v) for k, v in delta.items()}
    seq.delta = interop.tensors_from_numpy(delta)
    jseq.frame = seq.frame = 1
    jm, m = jseq.extract_mesh(resolution=64), seq.extract_mesh(resolution=64)
    for k in ("V", "N"):
        np.testing.assert_allclose(m[k], np.asarray(jm[k]), atol=1e-5)
    np.testing.assert_array_equal(m["F"], jm["F"])
    np.testing.assert_allclose(m["N"], canon["N"], atol=0)
    assert np.abs(m["V"] - canon["V"]).max() > 0.05
