"""Mesh refinement of the PyTorch port against the JAX package: the 1-ring
accumulation and normals, laplacian smoothing, the per-vertex gradients
and `optimise_mesh_step` within 1e-6 on the same mesh and field queries;
`field_sdf_grad_fn` against the JAX field's `sdf_and_grad`; and a
refinement that pulls a perturbed sphere mesh back onto the field's zero
set."""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from rnb_neus2_tpu import config as jconfig
from rnb_neus2_tpu.mesh import refine as jrefine
from rnb_neus2_tpu.models.neus_field import NeusField as JNeusField
from rnb_neus2_tpu.models.neus_field import init_params
from rnb_neus2_torch import config, interop
from rnb_neus2_torch.mesh import marching, refine
from rnb_neus2_torch.models.neus_field import NeusField

GRID = dict(n_levels=4, top_resolution=64, log2_hashmap_size=15)


def _sphere_mesh(res=20, r=0.3):
    g = (np.arange(res + 1) / res).astype(np.float32)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    vol = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2) - r
    V, F = marching.marching_cubes_grid(vol.astype(np.float32), (0, 0, 0),
                                        1.0 / res)
    return V.astype(np.float32), F


def _analytic(V):
    """The exact sphere SDF of radius 0.27 and its gradient."""
    d = V - 0.5
    n = np.linalg.norm(d, axis=1)
    return (n - 0.27).astype(np.float32), (d / n[:, None]).astype(np.float32)


def test_one_ring_smoothing_and_gradients_match_jax():
    V, F = _sphere_mesh()
    acc, nrm = refine.compute_mesh_1ring(V, F)
    jacc, jnrm = jrefine.compute_mesh_1ring(V, F)
    np.testing.assert_allclose(acc, jacc, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(nrm, jnrm, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(refine.laplacian_smooth(V, F, 0.5, 3),
                               jrefine.laplacian_smooth(V, F, 0.5, 3),
                               rtol=1e-6, atol=1e-6)
    sdf, grad = _analytic(V)
    args = (V, nrm, acc, sdf, grad, 0.0, 2048.0, 128.0, 1.0)
    np.testing.assert_allclose(refine.mesh_opt_gradients(*args),
                               jrefine.mesh_opt_gradients(*args),
                               rtol=1e-6, atol=1e-6)


def test_optimise_mesh_step_matches_jax_and_snaps_to_surface():
    """8 Adam steps on the analytic field: within 1e-6 of the JAX
    package's, and the mean distance to the radius-0.27 zero set falls
    from 0.03."""
    V, F = _sphere_mesh()
    got = refine.optimise_mesh_step(_analytic, V, F, n_steps=8, lr=2e-3)
    want = jrefine.optimise_mesh_step(_analytic, V, F, n_steps=8, lr=2e-3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    before = np.abs(_analytic(V)[0]).mean()
    assert np.abs(_analytic(got)[0]).mean() < 0.7 * before


def test_field_sdf_grad_fn_matches_jax():
    """The port's field query (the EMA parameters loaded into a copy of
    the field) against the JAX field's `sdf_and_grad` at the same
    parameters, within 1e-5."""
    jgrid, jnet = jconfig.HashGridConfig(**GRID), jconfig.NetworkConfig()
    params = jax.tree_util.tree_map(
        np.asarray, init_params(jax.random.PRNGKey(0), jgrid, jnet))
    rng = np.random.default_rng(1)
    params["hash_table"] = (1e-2 * rng.standard_normal(
        params["hash_table"].shape)).astype(np.float32)
    V, _ = _sphere_mesh()
    jsdf, jgrad, _ = JNeusField(jgrid, jnet).sdf_and_grad(params,
                                                          jnp.asarray(V))
    field = NeusField(config.HashGridConfig(**GRID), config.NetworkConfig(),
                      device="cpu")
    fn = refine.field_sdf_grad_fn(field, interop.params_from_jax(params),
                                  chunk=100)
    sdf, grad = fn(V)
    assert isinstance(sdf, np.ndarray) and sdf.shape == (len(V),)
    np.testing.assert_allclose(sdf, np.asarray(jsdf), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad, np.asarray(jgrad), rtol=1e-5,
                               atol=1e-5)
    # the caller's field keeps its own parameters
    assert not torch.equal(field.hash_table.detach(),
                           torch.from_numpy(params["hash_table"]))
