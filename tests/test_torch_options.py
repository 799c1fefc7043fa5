"""The training options of the JAX trainer in the PyTorch port, against the
JAX package: aabb_scale > 1, the fp16 and rollover gradient emulations,
the light-PRNG salt, bfloat16 compute, and the features-only `encode`
with its exact backward; and the scene's aabb_scale check of the CLI and
the `Testbed`.

Tolerances:
- the emulations' barriers and `quantize_grads_fp16` are bit for bit
  (one float32 product, one conversion); `rollover_weights` equals a
  brute-force count of the padded copies;
- `training_loss`'s gradient with an emulation on: as
  `tests/test_torch_loss.py` (rtol 1e-4, atol 1e-7, at most 0.1% of a
  leaf's entries off by at most 1e-5 of its largest), and with the fp16
  barrier, whose rounding a last-bit difference of the incoming cotangent
  can move by one fp16 step (2^-11 relative), rtol 2e-3 and off entries
  up to 1e-3 of the leaf's largest;
- bfloat16: the forward within 2e-2 of JAX's (relative to each output's
  largest entry) and every gradient leaf within 3e-2 of its largest entry;
  both packages round the same operands to bfloat16, but a product that
  lands on a rounding boundary in one order of summation rounds the other
  way in the other, and that one bfloat16 step (2^-8) travels down the
  chain;
- trainer steps on JAX's own draws: the rules of
  `tests/test_torch_trainer_parity.py`.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rnb_neus2_tpu import config as jconfig
from rnb_neus2_tpu.models.neus_field import NeusField as JNeusField
from rnb_neus2_tpu.ops import hash_encoding as jhash
from rnb_neus2_tpu.render import losses as jlosses
from rnb_neus2_tpu.testing.synthetic import sphere_dataset as jsphere
from rnb_neus2_tpu.train.trainer import Trainer as JTrainer
from rnb_neus2_torch import config, interop
from rnb_neus2_torch.api import Testbed, TestbedMode
from rnb_neus2_torch.cli import testbed
from rnb_neus2_torch.grid import occupancy
from rnb_neus2_torch.models.neus_field import NeusField
from rnb_neus2_torch.ops import hash_encoding
from rnb_neus2_torch.render import losses
from rnb_neus2_torch.testing.synthetic import (sphere_dataset,
                                               write_prepared_scene)
from rnb_neus2_torch.train import trainer as trainer_mod
from rnb_neus2_torch.train.sampler import RayUniforms, draw_uniforms
from tests.test_torch_loss import GRID, _port_inputs, shared  # noqa: F401
from tests.test_torch_trainer_parity import _compare_steps, _np_tree, _t


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the emulations
# ---------------------------------------------------------------------------

def _grads_spanning_fp16():
    """Values whose ×128 spans fp16's subnormals, normals and overflow."""
    rng = np.random.default_rng(0)
    g = (rng.standard_normal(20000)
         * 10.0 ** rng.uniform(-14, 4, 20000)).astype(np.float32)
    g[:4] = [0.0, -0.0, 1e30, -1e30]
    return g


def test_fp16_barrier_and_quantize_bitwise():
    g = _grads_spanning_fp16()
    x = np.random.default_rng(1).standard_normal(g.shape).astype(np.float32)
    _, vjp = jax.vjp(jlosses.fp16_grad_barrier, jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_(True)
    y = losses.fp16_grad_barrier(t)
    assert torch.equal(y.detach(), t.detach())
    (got,) = torch.autograd.grad(y, t, torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    q = losses.quantize_grads_fp16({"a": torch.from_numpy(g)})["a"]
    np.testing.assert_array_equal(
        q.numpy(), np.asarray(jlosses.quantize_grads_fp16(
            {"a": jnp.asarray(g)})["a"]))
    # every value is a float16 divided by 128, saturating at 65504/128
    h = (q * 128.0).numpy()
    np.testing.assert_array_equal(h.astype(np.float16).astype(np.float32), h)
    assert np.abs(q.numpy()).max() == np.float32(65504.0 / 128.0)
    assert (q.numpy() == 0).sum() > (g == 0).sum()         # underflow


def _brute_rollover(keep):
    """Padded copies counted one by one: rows [n, S) repeat kept row
    (i mod n) at n/S of the cotangent."""
    S = len(keep)
    kept = np.flatnonzero(keep)
    n = max(len(kept), 1)
    w = np.ones(S)
    for r, slot in enumerate(kept):
        extra = sum(1 for i in range(len(kept), S) if i % n == r)
        w[slot] = 1.0 + extra * (n / S)
    return w


@pytest.mark.parametrize("frac", [0.0, 0.05, 0.4, 1.0])
def test_rollover_weights_against_brute_force_and_jax(frac):
    keep = np.random.default_rng(2).random(300) < frac
    got = losses.rollover_weights(torch.from_numpy(keep)).numpy()
    np.testing.assert_allclose(got, _brute_rollover(keep), rtol=1e-6)
    np.testing.assert_array_equal(
        got, np.asarray(jlosses.rollover_weights(jnp.asarray(keep))))


def test_scale_cotangent():
    x = torch.randn(10, 3, requires_grad=True)
    w = torch.rand(10, 1)
    g = torch.randn(10, 3)
    y = losses.scale_cotangent(x, w)
    assert torch.equal(y.detach(), x.detach())
    (gx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(gx, g * w)


def _loss_grads(shared, loss_kw, net_kw=None):  # noqa: F811
    """(outputs, loss, gradient leaves in the JAX order) of the port and of
    the JAX package on the shared batch."""
    net_kw = net_kw or {}
    field = NeusField(config.HashGridConfig(**GRID),
                      config.NetworkConfig(stoch_corner_bwd=0, **net_kw),
                      "cpu")
    field.load_state_dict(interop.params_from_jax(shared["params"]))
    samples, batch, pos = _port_inputs(shared)
    out = field(pos)
    loss, _ = losses.training_loss(out, samples, batch, config.RenderFlags(),
                                   config.LossConfig(**loss_kw), 1.0)
    names = [n for n, _ in field.named_parameters()]
    grads = torch.autograd.grad(loss, list(field.parameters()))
    g = interop.params_to_jax({n: x.double() for n, x in zip(names, grads)})

    jfield = JNeusField(shared["jgrid"], dataclasses.replace(
        shared["jnet"], **net_kw))
    jparams = jax.tree_util.tree_map(jnp.asarray, shared["params"])
    jcfg = jconfig.LossConfig(**loss_kw)

    def jloss_fn(p):
        o = jfield.apply(p, shared["pos"])
        return jlosses.training_loss(o, shared["samples"], shared["batch"],
                                     jconfig.RenderFlags(), jcfg, 1.0)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss_fn))(jparams)
    jout = jax.jit(lambda p: jfield.apply(p, shared["pos"]))(jparams)
    return (out, float(loss.detach()), jax.tree_util.tree_leaves(g),
            jout, float(jl), jax.tree_util.tree_leaves(jg))


EMULATIONS = {
    "fp16": dict(fp16_grad_emulation=True),
    "rollover": dict(rollover_grad_emulation=True),
    "both": dict(fp16_grad_emulation=True, rollover_grad_emulation=True),
}


@pytest.mark.parametrize("case", sorted(EMULATIONS))
def test_training_loss_grads_with_emulation_match_jax(shared, case):  # noqa: F811
    kw = EMULATIONS[case]
    _, loss, grads, _, jl, jgrads = _loss_grads(shared, kw)
    _, _, plain, _, _, _ = _loss_grads(shared, {})
    assert loss == pytest.approx(jl, rel=1e-5)
    fp16 = kw.get("fp16_grad_emulation", False)
    worst = 1e-3 if fp16 else 1e-5
    for a, b in zip(grads, jgrads):
        b = np.asarray(b, np.float64)
        off = ~np.isclose(a, b, rtol=2e-3 if fp16 else 1e-4, atol=1e-7)
        assert off.mean() <= 1e-3, (a[off], b[off])
        assert np.all(np.abs(a - b)[off] <= worst * np.abs(b).max()), (
            a[off], b[off], np.abs(b).max())
    # the emulation changes the gradient
    assert any(not np.allclose(a, p, rtol=0, atol=0)
               for a, p in zip(grads, plain))


# ---------------------------------------------------------------------------
# bfloat16 compute
# ---------------------------------------------------------------------------

def test_bf16_field_outputs_and_grads_match_jax(shared):  # noqa: F811
    """The field at compute_dtype bfloat16 (both MLPs and the jacobian
    chain), its loss and every gradient leaf against the JAX package."""
    bf = {"compute_dtype": "bfloat16"}
    out, loss, grads, jout, jl, jgrads = _loss_grads(shared, {}, bf)
    f32_out = _loss_grads(shared, {})[0]
    for k in ("sdf", "grad", "albedo_raw"):
        w = np.asarray(jout[k])
        g = out[k].detach().numpy()
        assert out[k].dtype == torch.float32
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), k
        assert not torch.equal(out[k], f32_out[k]), k     # bf16 ran
    assert loss == pytest.approx(jl, rel=2e-2)
    for a, b in zip(grads, jgrads):
        b = np.asarray(b, np.float64)
        assert np.abs(a - b).max() <= 3e-2 * np.abs(b).max() + 1e-12


def test_bf16_dot_backward_rounds_like_jax():
    """One bf16 product: forward, and both cotangents as JAX's transpose
    gives them (computed in float32 from the rounded operands, rounded to
    bfloat16), bit for bit."""
    from rnb_neus2_torch.ops.mlp import dot

    rng = np.random.default_rng(3)
    a = rng.standard_normal((64, 48)).astype(np.float32)
    b = rng.standard_normal((48, 16)).astype(np.float32)
    v = rng.standard_normal(48).astype(np.float32)
    w = rng.standard_normal((64, 16)).astype(np.float32)
    cd = jnp.bfloat16

    def jf(a, b, v):
        y = jnp.dot(a.astype(cd), b.astype(cd),
                    preferred_element_type=jnp.float32)
        z = jnp.dot(a.astype(cd), v.astype(cd),
                    preferred_element_type=jnp.float32)
        return jnp.sum(y * w) + jnp.sum(z * w[:, 0])

    jg = jax.grad(jf, argnums=(0, 1, 2))(a, b, v)
    ta, tb, tv = (torch.from_numpy(x).requires_grad_(True) for x in (a, b, v))
    y = dot(ta, tb, "bfloat16")
    z = dot(ta, tv, "bfloat16")
    tw = torch.from_numpy(w)
    g = torch.autograd.grad((y * tw).sum() + (z * tw[:, 0]).sum(),
                            (ta, tb, tv), retain_graph=True)
    for got, want in zip(g, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   rtol=1e-2, atol=1e-6)
    # each single-product cotangent is bitwise JAX's
    gb = torch.autograd.grad((y * tw).sum(), tb)[0]
    jgb = jax.grad(lambda b: jnp.sum(jnp.dot(
        jnp.asarray(a).astype(cd), b.astype(cd),
        preferred_element_type=jnp.float32) * w))(b)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(jgb, np.float32))


# ---------------------------------------------------------------------------
# features-only encode with the exact backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("valid_level,n_active", [(None, None), (2, None),
                                                  (None, 3)])
def test_features_only_encode_and_grads_match_jax(valid_level, n_active):
    jcfg = jconfig.HashGridConfig(**GRID)
    cfg = config.HashGridConfig(**GRID)
    rng = np.random.default_rng(4)
    table = (1e-2 * rng.standard_normal(
        (jhash.HashGridStatic(jcfg).n_entries, 2))).astype(np.float32)
    x = rng.random((3000, 3)).astype(np.float32)
    gout = rng.standard_normal((3000, cfg.output_dim)).astype(np.float32)
    jstatic = jhash.HashGridStatic(jcfg)

    def jf(t, p):
        return jnp.sum(jhash.encode(t, p, jstatic, valid_level, n_active)
                       * gout)

    jenc = jhash.encode(jnp.asarray(table), jnp.asarray(x), jstatic,
                        valid_level, n_active)
    jgt, jgp = jax.grad(jf, argnums=(0, 1))(jnp.asarray(table),
                                           jnp.asarray(x))
    tt = torch.from_numpy(table).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    enc = hash_encoding.encode(tt, tx, hash_encoding.HashGridStatic(cfg),
                               valid_level, n_active)
    np.testing.assert_allclose(enc.detach().numpy(), np.asarray(jenc),
                               rtol=1e-5, atol=1e-7)
    gt, gp = torch.autograd.grad((enc * torch.from_numpy(gout)).sum(),
                                 (tt, tx))
    np.testing.assert_allclose(gt.numpy(), np.asarray(jgt), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(gp.numpy(), np.asarray(jgp), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jgp).max()))
    assert float(gt.abs().max()) > 0


# ---------------------------------------------------------------------------
# light-PRNG salt
# ---------------------------------------------------------------------------

def test_light_salt_changes_only_the_light_index():
    train = config.TrainConfig(seed=3)
    draws = []
    for salt in (0, 1, 2):
        gen = torch.Generator().manual_seed(3)
        lg = trainer_mod.light_generator(
            dataclasses.replace(train, light_prng_salt=salt), "cpu")
        assert (lg is None) == (salt == 0)
        draws.append([draw_uniforms(512, gen, "cpu", False, lg)
                      for _ in range(3)])
    for other in draws[1:]:
        for a, b in zip(draws[0], other):
            for f in ("xy", "skip", "start"):
                assert torch.equal(getattr(a, f), getattr(b, f)), f
            assert not torch.equal(a.light_idx, b.light_idx)
            assert set(b.light_idx.tolist()) == {0, 1, 2}
    assert not torch.equal(draws[1][0].light_idx, draws[2][0].light_idx)


def test_light_salt_survives_the_guard_and_snapshot():
    """The light generator's state is part of the guard's snapshot and of
    the saved snapshot: a restore draws the same light stream."""
    from rnb_neus2_torch.train import snapshot as snap

    cfg = _small_cfg(config, light_prng_salt=5)
    ds = sphere_dataset(n_views=2, width=16, height=16, radius=0.2)
    tr = trainer_mod.Trainer(ds, cfg, device="cpu")
    tr.train_step()
    payload = snap.snapshot_payload(tr)
    state = tr.light_generator.get_state().clone()
    want = torch.randint(0, 3, (64,), generator=tr.light_generator)
    tr2 = trainer_mod.Trainer(ds, cfg, device="cpu")
    snap.restore_trainer(tr2, payload)
    assert torch.equal(tr2.light_generator.get_state(), state)
    assert torch.equal(torch.randint(0, 3, (64,),
                                     generator=tr2.light_generator), want)


# ---------------------------------------------------------------------------
# trainer steps on JAX's own draws
# ---------------------------------------------------------------------------

def _small_cfg(pkg, aabb_scale=1.0, cone=0.0, light_prng_salt=0,
               field_chunk=1 << 18, **loss_kw):
    return pkg.TestbedConfig(
        grid=pkg.HashGridConfig(n_levels=4, top_resolution=64,
                                aabb_scale=aabb_scale),
        network=pkg.NetworkConfig(stoch_corner_bwd=0),
        loss=pkg.LossConfig(**loss_kw),
        train=pkg.TrainConfig(target_batch_size=1 << 13,
                              initial_rays_per_batch=128, occ_grid_size=32,
                              seed=0, light_prng_salt=light_prng_salt,
                              field_chunk=field_chunk),
        march=pkg.MarchConfig(n_ladder=512, cone_angle=cone))


def _jax_draws_salted(jtr):
    """As `test_torch_trainer_parity._jax_draws`, with the light key
    folded with the salt (JAX `sample_ray_batch`)."""
    key, jitter = jtr.key, None
    if jtr.step % occupancy.update_cadence(jtr.step) == 0:
        key, k = jax.random.split(key)
        g = jtr.cfg.train.occ_grid_size
        n = g ** 3 if jtr.step < 256 else 2 * max(g ** 3 // 4, 1)
        jitter = _t(jax.random.uniform(k, (n, 3)))
    key, k = jax.random.split(key)
    R = jtr._bucket()
    k_xy, k_skip, k_light, k_start = jax.random.split(k, 4)
    salt = jtr.cfg.train.light_prng_salt
    if salt:
        k_light = jax.random.fold_in(k_light, salt)
    uni = RayUniforms(xy=_t(jax.random.uniform(k_xy, (R, 2))),
                      skip=_t(jax.random.uniform(k_skip, (R,))),
                      start=_t(jax.random.uniform(k_start, (R,))),
                      light_idx=_t(jax.random.randint(k_light, (R,), 0, 3),
                                   torch.int64))
    return jitter, uni


OPTION_CASES = {
    "aabb_scale_4": dict(aabb_scale=4.0, cone=1.0 / 256.0),
    "emulations": dict(fp16_grad_emulation=True,
                       rollover_grad_emulation=True),
    "light_salt": dict(light_prng_salt=1),
    # 2^12 splits the 2^13-sample buffer in two lax.map chunks in JAX; the
    # port evaluates the field in one piece
    "field_chunk": dict(field_chunk=1 << 12),
}


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_trainer_steps_with_option_match_jax(monkeypatch, case):
    kw = OPTION_CASES[case]
    jtr = JTrainer(jsphere(n_views=4, width=32, height=32, radius=0.2),
                   _small_cfg(jconfig, **kw))
    tr = trainer_mod.Trainer(
        sphere_dataset(n_views=4, width=32, height=32, radius=0.2),
        _small_cfg(config, **kw), device="cpu",
        params=interop.params_from_jax(_np_tree(jtr.params)))
    queue = {"jitter": [], "uniforms": []}
    real_sample, real_cells = (trainer_mod.sample_ray_batch,
                               occupancy.cell_positions)
    monkeypatch.setattr(trainer_mod, "sample_ray_batch",
                        lambda *a, **k: real_sample(
                            *a, **{**k, "uniforms": queue["uniforms"].pop()}))
    monkeypatch.setattr(occupancy, "cell_positions",
                        lambda g, gen=None, device="cpu": real_cells(
                            g, gen, device, jitter=queue["jitter"].pop()))
    import tests.test_torch_trainer_parity as parity
    monkeypatch.setattr(parity, "_jax_draws", _jax_draws_salted)
    # the fp16 quantization of a gradient that differs in its last float32
    # bit can round one fp16 step (2^-11) apart: the second moment, a
    # square, then differs by up to twice that
    moment_rel = 2e-3 if case == "emulations" else 1e-3
    assert _compare_steps(jtr, tr, queue, 3, moment_rel) >= 2
    if case == "aabb_scale_4":
        # the JAX trainer's march: the unit cube, a 1-D bitfield, cone
        # 1/256, and the level scales of top_resolution·4
        assert tr.occ.bitfield.dim() == 1
        np.testing.assert_array_equal(
            tr.field.static.scales, jhash.HashGridStatic(
                jtr.cfg.grid).scales)


@pytest.mark.parametrize("aabb_scale", [1.0, 2.0, 4.0, 16.0])
def test_level_scales_follow_aabb_scale_as_jax(aabb_scale):
    kw = dict(n_levels=14, top_resolution=2048, aabb_scale=aabb_scale)
    got, want = config.HashGridConfig(**kw), jconfig.HashGridConfig(**kw)
    assert got.per_level_scale == want.per_level_scale
    for f in ("level_scales", "level_resolutions", "level_table_sizes"):
        np.testing.assert_array_equal(np.asarray(getattr(got, f)()),
                                      np.asarray(getattr(want, f)()), f)
    net = os.path.join(os.path.dirname(config.__file__), "configs", "nerf",
                       "base.json")
    a = config.TestbedConfig.from_network_json(net, aabb_scale)
    b = jconfig.TestbedConfig.from_network_json(net, aabb_scale)
    assert a.march.cone_angle == b.march.cone_angle
    assert a.grid == config.HashGridConfig(**dataclasses.asdict(b.grid))


def test_check_ported_refuses_only_not_read_fields():
    cfg = config.TestbedConfig()
    on = dataclasses.replace(
        cfg,
        grid=dataclasses.replace(cfg.grid, aabb_scale=4.0),
        network=dataclasses.replace(cfg.network, compute_dtype="bfloat16"),
        loss=dataclasses.replace(cfg.loss, fp16_grad_emulation=True,
                                 rollover_grad_emulation=True),
        train=dataclasses.replace(cfg.train, light_prng_salt=3,
                                  field_chunk=1 << 16),
        march=dataclasses.replace(cfg.march, max_samples_per_ray=64))
    trainer_mod.check_ported(on)
    for section, names in trainer_mod.NOT_READ.items():
        for name in names:
            sec = getattr(cfg, section)
            bad = dataclasses.replace(cfg, **{section: dataclasses.replace(
                sec, **{name: (getattr(sec, name) or 0) + 1})})
            with pytest.raises(ValueError, match=name):
                trainer_mod.check_ported(bad)


@pytest.mark.parametrize("n,chunk", [(12, 4), (12, 5), (4, 12), (12, 12),
                                     (8192, 3000)])
def test_field_chunk_raises_where_jax_asserts(n, chunk):
    """JAX's `apply_chunked` asserts n % chunk == 0 when n > chunk; the
    port raises on the same (n, chunk) and on no other."""
    from rnb_neus2_tpu.models.neus_field import NeusField as JField
    from rnb_neus2_tpu.models.neus_field import init_params
    jcfg = _small_cfg(jconfig)
    field = JField(jcfg.grid, jcfg.network)
    params = init_params(jax.random.PRNGKey(0), jcfg.grid, jcfg.network)
    x = np.random.default_rng(0).random((n, 3), np.float32)
    try:
        field.apply_chunked(params, x, chunk=chunk)
        jax_raises = False
    except AssertionError:
        jax_raises = True
    if jax_raises:
        with pytest.raises(ValueError, match="field_chunk"):
            trainer_mod.check_field_chunk(n, chunk)
    else:
        trainer_mod.check_field_chunk(n, chunk)
    assert jax_raises == (n > chunk and n % chunk != 0)


def test_cli_trains_with_field_chunk_and_max_samples_per_ray(
        tmp_path, monkeypatch):
    """The CLI runs the same check: a config with both fields changed
    trains and writes its mesh, and a chunk that does not divide the
    buffer stops the run at its first step, as the JAX assert does."""
    d, net = _scene_with_aabb(tmp_path, 1.0)
    args = ["--scene", d, "--maxiter", "2", "--network", net,
            "--target-batch-size", "1024", "--occ-grid-size", "16",
            "--n-ladder", "128", "--device", "cpu", "--save-mesh",
            "--resolution", "16"]
    real = testbed.make_config

    def with_fields(chunk):
        def make(a):
            c = real(a)
            return dataclasses.replace(
                c, train=dataclasses.replace(c.train, field_chunk=chunk),
                march=dataclasses.replace(c.march, max_samples_per_ray=8))
        return make
    monkeypatch.setattr(testbed, "make_config", with_fields(256))
    assert testbed.main(args) == 0
    assert os.path.exists(os.path.join(d, "output", "mesh_2.obj"))
    monkeypatch.setattr(testbed, "make_config", with_fields(300))
    with pytest.raises(ValueError, match="field_chunk"):
        testbed.main(args)


def test_bf16_trains_a_few_steps():
    cfg = _small_cfg(config)
    cfg = dataclasses.replace(cfg, network=dataclasses.replace(
        cfg.network, compute_dtype="bfloat16"))
    tr = trainer_mod.Trainer(
        sphere_dataset(n_views=2, width=16, height=16, radius=0.2), cfg,
        device="cpu")
    losses_ = [tr.train_step()["loss_total"] for _ in range(4)]
    assert np.isfinite(losses_).all()


# ---------------------------------------------------------------------------
# the scene's aabb_scale
# ---------------------------------------------------------------------------

def _scene_with_aabb(tmp_path, aabb_scale):
    d = str(tmp_path / "scene")
    write_prepared_scene(d, n_views=4, width=16, height=16)
    path = os.path.join(d, "transform.json")
    with open(path) as f:
        tj = json.load(f)
    tj["aabb_scale"] = aabb_scale
    with open(path, "w") as f:
        json.dump(tj, f)
    net = str(tmp_path / "net.json")
    with open(os.path.join(os.path.dirname(config.__file__), "configs",
                           "nerf", "base.json")) as f:
        base = json.load(f)
    base["encoding"].update(n_levels=3, log2_hashmap_size=14)
    with open(net, "w") as f:
        json.dump(base, f)
    return d, net


def test_cli_refuses_a_scene_with_another_aabb_scale(tmp_path, capsys):
    d, net = _scene_with_aabb(tmp_path, 4.0)
    rc = testbed.main(["--scene", d, "--maxiter", "2", "--network", net,
                       "--target-batch-size", "1024", "--occ-grid-size",
                       "16", "--n-ladder", "128", "--device", "cpu"])
    assert rc == 2
    out = capsys.readouterr().out
    assert "aabb_scale is 4.0" in out and "aabb_scale=4.0" in out
    assert not os.path.exists(os.path.join(d, "output", "mesh_2.obj"))


def test_testbed_refuses_then_trains_with_matching_aabb_scale(tmp_path):
    d, net = _scene_with_aabb(tmp_path, 4.0)
    small = dict(target_batch_size=1 << 10, initial_rays_per_batch=64,
                 occ_grid_size=16)

    def cfg_for(aabb):
        c = config.TestbedConfig.from_network_json(net, aabb_scale=aabb)
        return dataclasses.replace(
            c, train=dataclasses.replace(c.train, **small),
            march=dataclasses.replace(c.march, n_ladder=128))

    tb = Testbed(TestbedMode.Nerf, cfg_for(1.0), device="cpu")
    with pytest.raises(ValueError, match="from_network_json"):
        tb.load_training_data(d)
    tb = Testbed(TestbedMode.Nerf, cfg_for(4.0), device="cpu")
    tb.load_training_data(d)
    assert tb.cfg.march.cone_angle == pytest.approx(1.0 / 256.0)
    tb.train(3)
    assert tb.training_step == 3 and np.isfinite(tb.loss)
