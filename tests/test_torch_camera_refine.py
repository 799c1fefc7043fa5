"""Camera refinement of the PyTorch port against the JAX package: the
axis-angle rotation, `refine_rays` (with and without the shared focal
offset), `exposure_adjust` and `init_refine_params` within 1e-6; the
refiner's Adam against optax over 5 steps; and one refinement step of the
loop of tests/test_camera_refine.py (pose and focal, through the
position-differentiable field) on the same batch, whose loss and gradient
wrt every refinement parameter agree within 1e-5."""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from flax import serialization

from rnb_neus2_tpu import config as jconfig
from rnb_neus2_tpu.models.neus_field import NeusField as JNeusField
from rnb_neus2_tpu.models.neus_field import init_params
from rnb_neus2_tpu.render.losses import training_loss as jtraining_loss
from rnb_neus2_tpu.testing.synthetic import sphere_dataset as jsphere
from rnb_neus2_tpu.train import camera_refine as jcr
from rnb_neus2_tpu.train.sampler import sample_ray_batch as jsample
from rnb_neus2_torch import config, interop
from rnb_neus2_torch.models.neus_field import NeusField
from rnb_neus2_torch.render.losses import training_loss
from rnb_neus2_torch.testing.synthetic import sphere_dataset
from rnb_neus2_torch.train import camera_refine as cr
from rnb_neus2_torch.train.sampler import (RayUniforms, sample_positions,
                                           sample_ray_batch)

GRID = dict(n_levels=4, top_resolution=64, log2_hashmap_size=15)
N_VIEWS, R, S, G = 4, 1024, 1 << 13, 32


def _random_params(seed, n=N_VIEWS, scale=0.05):
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)
    return jcr.CameraRefineParams(rot=f(n, 3), trans=f(n, 3),
                                  exposure=f(n, 3) * 10, focal=f(2))


def _close(got, want, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_init_and_axis_angle_match_jax():
    p, jp = cr.init_refine_params(3, "cpu"), jcr.init_refine_params(3)
    for a, b in zip(p, jp):
        _close(a, b, 0, 0)
    aa = np.random.default_rng(0).standard_normal((17, 3)).astype(np.float32)
    aa[0] = 0.0
    _close(cr.axis_angle_to_matrix(torch.from_numpy(aa)),
           jcr.axis_angle_to_matrix(jnp.asarray(aa)))


@pytest.mark.parametrize("with_focal", [False, True])
def test_refine_rays_match_jax(with_focal):
    jp = _random_params(1)
    p = interop.tensors_from_numpy(jp)
    rng = np.random.default_rng(2)
    n = 65
    img = rng.integers(0, N_VIEWS, n)
    o = rng.random((n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rot = None
    if with_focal:
        q, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
        rot = q.astype(np.float32)
    want = jcr.refine_rays(jp, jnp.asarray(img), o, d,
                           None if rot is None else jnp.asarray(rot))
    got = cr.refine_rays(p, torch.from_numpy(img), torch.from_numpy(o),
                         torch.from_numpy(d),
                         None if rot is None else torch.from_numpy(rot))
    for a, b in zip(got, want):
        _close(a, b)


def test_exposure_adjust_matches_jax():
    jp = _random_params(3)
    p = interop.tensors_from_numpy(jp)
    rng = np.random.default_rng(4)
    img = rng.integers(0, N_VIEWS, 257)
    v = rng.random((257, 3)).astype(np.float32)
    v[:3] = [[0.0, 0.04045, 1.0], [0.001, 0.5, 0.99], [0.2, 0.3, 0.0031]]
    _close(cr.exposure_adjust(p, torch.from_numpy(img), torch.from_numpy(v)),
           jcr.exposure_adjust(jp, jnp.asarray(img), jnp.asarray(v)))


def test_refiner_adam_matches_optax():
    """make_refiner (adam(lr, .9, .99, 1e-15)) over 5 steps of random
    gradients: parameters and moments within 1e-6."""
    jp = _random_params(5)
    tx = jcr.make_refiner(2e-3)
    state = tx.init(jp)
    p = cr.CameraRefineParams(*interop.tensors_from_numpy(jp))
    opt = cr.make_refiner(p, 2e-3)
    rng = np.random.default_rng(6)
    for _ in range(5):
        g = jcr.CameraRefineParams(*(rng.standard_normal(np.shape(a))
                                     .astype(np.float32) for a in jp))
        up, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, up)
        p = opt.step(p, interop.tensors_from_numpy(g))
    assert isinstance(p, cr.CameraRefineParams)
    for a, b in zip(p, jp):
        _close(a, b)
    inner = serialization.to_state_dict(state)["0"]
    assert opt.count == int(inner["count"]) == 5
    for name in ("mu", "nu"):
        for k, v in getattr(opt, name).items():
            _close(v, inner[name][k])


def _shell_bitfield():
    c = (np.stack(np.meshgrid(*[np.arange(G)] * 3, indexing="ij"), -1)
         .transpose(2, 1, 0, 3).reshape(-1, 3) + 0.5) / G
    r = np.linalg.norm(c - 0.5, axis=1)
    return (r > 0.1) & (r < 0.3)


@pytest.fixture(scope="module")
def batch():
    """One JAX batch, the port's on the same uniforms, and field
    parameters off the init (a sphere-like SDF with live hash features)."""
    jgrid, jnet = jconfig.HashGridConfig(**GRID), jconfig.NetworkConfig()
    params = jax.tree_util.tree_map(
        np.asarray, init_params(jax.random.PRNGKey(0), jgrid, jnet))
    rng = np.random.default_rng(7)
    params["hash_table"] = (1e-2 * rng.standard_normal(
        params["hash_table"].shape)).astype(np.float32)
    w_x, w_enc = params["sdf_mlp"][0]
    params["sdf_mlp"][0] = (w_x, (0.1 * rng.standard_normal(
        w_enc.shape)).astype(np.float32))
    scene = dict(n_views=N_VIEWS, width=32, height=32, radius=0.2)
    jds, ds = jsphere(**scene), sphere_dataset(**scene)
    bit = _shell_bitfield()
    march = dict(n_ladder=512, cone_angle=1.0 / 256.0)
    key = jax.random.PRNGKey(8)
    jb, js, _, (jimg, _) = jsample(jds, jnp.asarray(bit), key, R, S,
                                   jconfig.MarchConfig(**march))
    k_xy, k_skip, k_light, k_start = jax.random.split(key, 4)
    t = lambda a: torch.from_numpy(np.array(a))
    uni = RayUniforms(xy=t(jax.random.uniform(k_xy, (R, 2))),
                      skip=t(jax.random.uniform(k_skip, (R,))),
                      start=t(jax.random.uniform(k_start, (R,))),
                      light_idx=t(jax.random.randint(k_light, (R,), 0, 3))
                      .long())
    b, s, _, (img, _) = sample_ray_batch(
        ds, torch.from_numpy(bit), R, S, config.MarchConfig(**march),
        uniforms=uni)
    assert torch.equal(img, t(jimg).long())
    assert int(s.n_valid.sum()) > 0
    field = NeusField(config.HashGridConfig(**GRID), config.NetworkConfig(),
                      device="cpu")
    field.load_state_dict(interop.params_from_jax(params))
    return dict(jfield=JNeusField(jgrid, jnet), params=params, jb=jb, js=js,
                jimg=jimg, jds=jds, field=field, b=b, s=s, img=img, ds=ds)


@pytest.mark.parametrize("mode", ["pose", "focal"])
def test_refinement_step_gradient_matches_jax(batch, mode):
    """The loss of the refinement loop (eikonal weight 0, rays corrupted
    then refined, positions re-formed and clipped, the pre-gathered
    attributes dropped) and its gradient wrt (rot, trans, exposure,
    focal): the loss within 1e-5 relative, each gradient within 1e-5 of
    its largest entry."""
    TRUE_T = np.array([0.03, -0.02, 0.0], np.float32)
    jp = _random_params(9, scale=0.01)
    lcfg = dataclasses.replace(jconfig.LossConfig(), ek_loss_weight=0.0)
    jb, js, jimg = batch["jb"], batch["js"], batch["jimg"]
    jrot = batch["jds"].cameras.rot_c2w[jimg]
    corrupt = jcr.init_refine_params(N_VIEWS)._replace(
        focal=jnp.full((2,), 0.06, jnp.float32))

    def jloss(pp):
        if mode == "pose":
            o = jb.ray_o + TRUE_T * (jimg == 0)[:, None]
            o2, d2 = jcr.refine_rays(pp, jimg, o, jb.ray_d)
        else:
            o1, d1 = jcr.refine_rays(corrupt, jimg, jb.ray_o, jb.ray_d,
                                     rot_c2w=jrot)
            o2, d2 = jcr.refine_rays(pp, jimg, o1, d1, rot_c2w=jrot)
        rid = jnp.minimum(js.ray_id, R - 1)
        pos = jnp.clip(o2[rid] + js.t[:, None] * d2[rid], 0, 1)
        out = batch["jfield"].apply(batch["params"], pos,
                                    differentiable_positions=True)
        total, _ = jtraining_loss(out, js, jb._replace(
            ray_o=o2, ray_d=d2, sample_attrs=None), jconfig.RenderFlags(),
            lcfg, 1.0)
        return total

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)

    b, s, img, field = batch["b"], batch["s"], batch["img"], batch["field"]
    p = cr.CameraRefineParams(*(v.requires_grad_() for v in
                                interop.tensors_from_numpy(jp)))
    rot = batch["ds"].cameras.rot_c2w[img]
    with field.frozen():
        if mode == "pose":
            o = b.ray_o + torch.from_numpy(TRUE_T) * (img == 0)[:, None]
            o2, d2 = cr.refine_rays(p, img, o, b.ray_d)
        else:
            c = interop.tensors_from_numpy(corrupt)
            o1, d1 = cr.refine_rays(c, img, b.ray_o, b.ray_d, rot_c2w=rot)
            o2, d2 = cr.refine_rays(p, img, o1, d1, rot_c2w=rot)
        out = field(sample_positions(o2, d2, s), differentiable_positions=True)
        loss, _ = training_loss(out, s, b._replace(
            ray_o=o2, ray_d=d2, sample_attrs=None), config.RenderFlags(),
            dataclasses.replace(config.LossConfig(), ek_loss_weight=0.0), 1.0)
        grads = torch.autograd.grad(loss, list(p), allow_unused=True,
                                    materialize_grads=True)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    for name, g, w in zip(p._fields, grads, jg):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-5 * max(np.abs(w).max(), 1e-30), (name, err)
    assert np.abs(np.asarray(jg.trans)).max() > 0
