"""Sampler, field and training loss of the PyTorch port against the JAX
package: one ray batch, the field's outputs, the loss and its gradient
wrt every parameter (carried across by `interop.py`)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rnb_neus2_tpu import config as jconfig
from rnb_neus2_tpu.io import dataset as jdataset
from rnb_neus2_tpu.models.neus_field import NeusField as JNeusField
from rnb_neus2_tpu.models.neus_field import init_params
from rnb_neus2_tpu.ops.ray_march import FlatSamples as JFlatSamples
from rnb_neus2_tpu.render import losses as jlosses
from rnb_neus2_tpu.testing.synthetic import sphere_dataset as jsphere
from rnb_neus2_tpu.train.sampler import sample_ray_batch as jsample
from rnb_neus2_torch import config, interop
from rnb_neus2_torch.io import dataset
from rnb_neus2_torch.kernels import neus_loss
from rnb_neus2_torch.models.neus_field import NeusField
from rnb_neus2_torch.ops.ray_march import FlatSamples
from rnb_neus2_torch.render import losses
from rnb_neus2_torch.testing.synthetic import sphere_dataset
from rnb_neus2_torch.train.sampler import RayUniforms, sample_ray_batch

GRID = dict(n_levels=4, top_resolution=64, log2_hashmap_size=14)
R, S, G = 64, 1 << 13, 32
SCENE = dict(n_views=4, width=24, height=24, radius=0.2)


def _shell_bitfield():
    """Occupied cells in a shell around the sphere of radius 0.2."""
    c = (np.stack(np.meshgrid(*[np.arange(G)] * 3, indexing="ij"), -1)
         .transpose(2, 1, 0, 3).reshape(-1, 3) + 0.5) / G
    r = np.linalg.norm(c - 0.5, axis=1)
    return (r > 0.12) & (r < 0.3)


@pytest.fixture(scope="module")
def shared():
    """JAX batch and params, and the same uniforms for the port."""
    jgrid = jconfig.HashGridConfig(**GRID)
    jnet = jconfig.NetworkConfig(stoch_corner_bwd=0)
    params = jax.tree_util.tree_map(
        np.asarray, init_params(jax.random.PRNGKey(0), jgrid, jnet))
    # move off the init, where the hash-feature weights are all zero, to
    # the scale of a field a few hundred steps into training
    rng = np.random.default_rng(1)
    params["hash_table"] = (1e-3 * rng.standard_normal(
        params["hash_table"].shape)).astype(np.float32)
    w_x, w_enc = params["sdf_mlp"][0]
    params["sdf_mlp"][0] = (w_x, (0.05 * rng.standard_normal(
        w_enc.shape)).astype(np.float32))
    ds = jsphere(**SCENE)
    bit = jnp.asarray(_shell_bitfield())
    key = jax.random.PRNGKey(7)
    batch, samples, pos, _ = jsample(ds, bit, key, R, S,
                                     jconfig.MarchConfig())
    k_xy, k_skip, k_light, k_start = jax.random.split(key, 4)
    uni = RayUniforms(
        xy=torch.from_numpy(np.array(jax.random.uniform(k_xy, (R, 2)))),
        skip=torch.from_numpy(np.array(jax.random.uniform(k_skip, (R,)))),
        start=torch.from_numpy(np.array(jax.random.uniform(k_start, (R,)))),
        light_idx=torch.from_numpy(np.array(
            jax.random.randint(k_light, (R,), 0, 3))).long())
    return dict(jgrid=jgrid, jnet=jnet, params=params, ds=ds, bit=bit,
                batch=batch, samples=samples, pos=pos, uniforms=uni)


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32 else a)


def test_dataset_matches_jax(shared):
    ds = sphere_dataset(**SCENE)
    jds = shared["ds"]
    for f in ("normals", "albedos", "alpha_normal", "alpha_albedo",
              "skip_candidate"):
        np.testing.assert_array_equal(getattr(ds, f).numpy(),
                                      np.asarray(getattr(jds, f)), err_msg=f)
    for f in ("rot_c2w", "origin", "focal", "principal"):
        np.testing.assert_array_equal(getattr(ds.cameras, f).numpy(),
                                      np.asarray(getattr(jds.cameras, f)))
    raw = np.random.default_rng(2).integers(0, 65536, (5, 7, 4)) \
        .astype(np.uint16)
    for is_normal in (True, False):
        for a, b in zip(dataset._decode_view(raw, is_normal),
                        jdataset._decode_view(raw, is_normal)):
            np.testing.assert_array_equal(a, b)


def test_sampler_matches_jax(shared):
    """With JAX's own uniforms the port's batch, march and positions equal
    JAX's."""
    batch, samples, pos, _ = sample_ray_batch(
        sphere_dataset(**SCENE), torch.from_numpy(np.asarray(shared["bit"])),
        R, S, config.MarchConfig(), uniforms=shared["uniforms"])
    js, jb = shared["samples"], shared["batch"]
    for f in js._fields:
        np.testing.assert_array_equal(getattr(samples, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    assert int(samples.valid.sum()) > 1000
    for f in ("alive", "normal_gt", "albedo_gt", "mask_color", "mask_gt",
              "rot_c2w", "light_idx", "sample_attrs"):
        np.testing.assert_allclose(getattr(batch, f).numpy(),
                                   np.asarray(getattr(jb, f)), rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    np.testing.assert_allclose(batch.ray_d.numpy(), np.asarray(jb.ray_d),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(pos.numpy(), np.asarray(shared["pos"]),
                               rtol=1e-6, atol=1e-7)


def _port_inputs(shared):
    js, jb = shared["samples"], shared["batch"]
    samples = FlatSamples(*[_t(getattr(js, f)) for f in JFlatSamples._fields])
    batch = losses.RayBatch(*[_t(getattr(jb, f)) for f in jb._fields])
    return samples, batch, _t(shared["pos"])


CASES = {
    "default": (dict(), None, None),
    "l1_bce_masked_levels": (dict(apply_l2=False, apply_bce=True), 2, 3),
    "supernormal_relu": (dict(apply_supernormal=True, apply_relu=True),
                         None, None),
}


def _port_loss_grads(shared, flag_kw, vl, n_active):
    field = NeusField(config.HashGridConfig(**GRID),
                      config.NetworkConfig(stoch_corner_bwd=0), "cpu")
    field.load_state_dict(interop.params_from_jax(shared["params"]))
    samples, batch, pos = _port_inputs(shared)
    out = field(pos, vl, n_active)
    loss, m = losses.training_loss(out, samples, batch,
                                   config.RenderFlags(**flag_kw),
                                   config.LossConfig(), 1.0)
    names = [n for n, _ in field.named_parameters()]
    grads = torch.autograd.grad(loss, list(field.parameters()))
    g = interop.params_to_jax({n: x.double() for n, x in zip(names, grads)})
    return out, loss, m, jax.tree_util.tree_leaves(g)


@pytest.mark.parametrize("case", sorted(CASES))
def test_training_loss_and_grads_match_jax(shared, case):
    """Field outputs rtol 1e-5, loss rtol 1e-5, gradients wrt all
    parameters rtol 1e-4 atol 1e-7: the sums run in another order
    (scatters, segment sums, matmuls). A gradient entry that is a sum of
    many terms cancelling to a small result carries float32 rounding on
    the scale of the terms, not of the result: at most 0.1% of a leaf's
    entries may miss that tolerance, and those by no more than 1e-5 of the
    JAX leaf's largest entry."""
    flag_kw, vl, n_active = CASES[case]
    jflags = jconfig.RenderFlags(**flag_kw)
    jloss_cfg = jconfig.LossConfig()
    jfield = JNeusField(shared["jgrid"], shared["jnet"])
    jparams = jax.tree_util.tree_map(jnp.asarray, shared["params"])

    def jloss_fn(p):
        out = jfield.apply(p, shared["pos"], vl, n_active)
        return jlosses.training_loss(out, shared["samples"], shared["batch"],
                                     jflags, jloss_cfg, 1.0)

    (jl, jm), jg = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        jparams)
    jout = jax.jit(lambda p: jfield.apply(p, shared["pos"], vl, n_active))(
        jparams)

    out, loss, m, grads = _port_loss_grads(shared, flag_kw, vl, n_active)
    for k in ("sdf", "grad", "albedo_raw"):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(jout[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in ("loss_color", "loss_mask", "loss_ek", "n_samples_kept"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    for a, b in zip(grads, jax.tree_util.tree_leaves(jg)):
        b = np.asarray(b, np.float64)
        off = ~np.isclose(a, b, rtol=1e-4, atol=1e-7)
        assert off.mean() <= 1e-3, (a[off], b[off])
        assert np.all(np.abs(a - b)[off] <= 1e-5 * np.abs(b).max()), (
            a[off], b[off], np.abs(b).max())
    assert np.abs(grads[0]).max() > 1e-4      # the hash table moves


def test_guarded_sqrt_matches_jax():
    x = np.array([-1.0, 0.0, 1e-12, 0.25, 3.0], np.float32)
    for floor, ref in ((0.0, False), (0.5, False), (0.0, True)):
        jf = jlosses._make_guarded_sqrt(floor, not ref)
        jy, jvjp = jax.vjp(jf, jnp.asarray(x))
        (jd,) = jvjp(jnp.ones_like(jy))
        t = torch.from_numpy(x).requires_grad_(True)
        y = neus_loss.GuardedSqrt.apply(t, floor, not ref)
        (d,) = torch.autograd.grad(y.sum(), t)
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
        assert np.isfinite(d.numpy()).all()
