"""The Image, Sdf and Volume workloads of the PyTorch port
(`models/extra_modes.py`, `ops/takikawa.py`, `render/sdf_volume_render.py`
and the `Testbed` in those modes) against the JAX package.

Each fit starts from the JAX package's initial parameters and takes a few
steps on its draws (`fit(..., draws=...)` with JAX's per-step uniforms;
the SDF batches are the same numpy draws in both packages): the loss
within 1e-4 relative and the parameters within 1e-5 absolute after each
run, 1e-3 of the image and volume fits' learning rate and 1e-2 of the SDF
fit's (a few Adam steps move an entry by up to a few lr; the two
packages' gradients differ only in float order, and on a barely touched
table entry, whose gradient is a few float32 terms that nearly cancel,
that moves Adam's normalised update by up to ~5e-3 of lr: 6 of the SDF
table's 133,760 entries pass 1e-6). Encodings: features within 1e-6,
gradients within 1e-5 relative to the largest. Renders: within
1e-4 (sphere tracing through 20–80 steps of a float32 field), on the
JAX package's own free-flight uniforms for the volume.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rnb_neus2_tpu.config import HashGridConfig as JHashGridConfig
from rnb_neus2_tpu.models import extra_modes as jem
from rnb_neus2_tpu.ops import takikawa as jtak
from rnb_neus2_tpu.render import sdf_volume_render as jsvr
from rnb_neus2_torch.api import Testbed, TestbedMode
from rnb_neus2_torch.config import HashGridConfig
from rnb_neus2_torch.io.image_io import save_image
from rnb_neus2_torch.mesh.writer import save_mesh
from rnb_neus2_torch.models import extra_modes as em
from rnb_neus2_torch.ops import takikawa
from rnb_neus2_torch.render import sdf_volume_render as svr
from rnb_neus2_torch.testing.synthetic import icosphere


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


def _flat(jparams):
    """The JAX package's {"table", "mlp": [...]} as the port's flat dict."""
    out = {"table": torch.from_numpy(_np(jparams["table"]).copy())}
    for i, w in enumerate(jparams["mlp"]):
        out[f"mlp.{i}"] = torch.from_numpy(_np(w).copy())
    return out


def _close_params(got, jparams, atol):
    want = _flat(jparams)
    for k in want:
        err = float((got[k] - want[k]).abs().max())
        assert err <= atol, (k, err)


def _image(H=24, W=24):
    ys, xs = np.mgrid[0:H, 0:W]
    return np.stack([np.sin(xs / 6.0) * 0.5 + 0.5,
                     np.cos(ys / 9.0) * 0.5 + 0.5,
                     ((xs + ys) % 16) / 16.0], -1).astype(np.float32)


def _jax_uniforms(seed, n_steps, shape):
    """The per-step uniforms of the JAX package's image and volume fits."""
    key = jax.random.PRNGKey(seed + 1)
    out = []
    for _ in range(n_steps):
        key, k = jax.random.split(key)
        out.append(torch.from_numpy(_np(jax.random.uniform(k, shape))))
    return out


# ---------------------------------------------------------------------------
# Hash2D + ImageField
# ---------------------------------------------------------------------------

def test_hash2d_encode_and_table_grad_match_jax():
    jenc, enc = jem.Hash2D(), em.Hash2D()
    assert (enc.sizes, enc.offsets, enc.hashed) == (jenc.sizes, jenc.offsets,
                                                    jenc.hashed)
    assert any(enc.hashed) and not all(enc.hashed)
    rng = np.random.default_rng(0)
    table = (1e-2 * rng.standard_normal((enc.n_entries, 2))).astype(
        np.float32)
    xy = rng.random((2000, 2)).astype(np.float32)
    xy[:4] = [[0, 0], [1, 1], [0, 1], [0.5, 0.5]]
    gout = rng.standard_normal((2000, 16)).astype(np.float32)
    jout = jenc.encode(jnp.asarray(table), jnp.asarray(xy))
    jg = jax.grad(lambda t: jnp.sum(jenc.encode(t, jnp.asarray(xy))
                                    * gout))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    out = enc.encode(t, torch.from_numpy(xy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    (g,) = torch.autograd.grad((out * torch.from_numpy(gout)).sum(), t)
    jg = np.asarray(jg)
    assert np.abs(g.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()


def test_image_fit_matches_jax_on_its_draws():
    img = _image()
    n, batch = 4, 1024
    jf = jem.ImageField()
    jp = jf.init(jax.random.PRNGKey(0))
    jp2, jl = jf.fit(img, n_steps=n, batch=batch, params=jp)
    f = em.ImageField(device="cpu")
    draws = _jax_uniforms(0, n, (batch, 2))
    p2, loss = f.fit(img, n_steps=n, batch=batch, params=_flat(jp),
                     draws=lambda i: draws[i])
    assert loss == pytest.approx(jl, rel=1e-4)
    _close_params(p2, jp2, 1e-5)
    out = f.render(p2, 24, 24)
    np.testing.assert_allclose(out, np.asarray(jf.render(jp2, 24, 24)),
                               atol=1e-5)


def test_image_field_init_and_fit_on_its_own_draws():
    f = em.ImageField(device="cpu")
    p = f.init(0)
    assert p["table"].shape == (f.enc.n_entries, 2)
    assert [p[f"mlp.{i}"].shape for i in range(3)] == [(64, 16), (64, 64),
                                                       (3, 64)]
    p2, opt, loss = f.fit(_image(), n_steps=30, batch=2048, params=p,
                          return_state=True)
    assert opt.count == 30 and np.isfinite(loss)
    assert loss < float(np.var(_image()))


# ---------------------------------------------------------------------------
# VolumeField (the features-only encode)
# ---------------------------------------------------------------------------

def _volume(n=16):
    g = np.mgrid[0:n, 0:n, 0:n] / float(n)
    return np.exp(-(((g - 0.5) ** 2).sum(0)) / 0.05).astype(np.float32)


def test_volume_fit_matches_jax_on_its_draws():
    vol = _volume()
    n, batch = 4, 1024
    jgrid = JHashGridConfig(n_levels=4, top_resolution=32)
    jf = jem.VolumeField(jgrid)
    jp = jf.init(jax.random.PRNGKey(0))
    jp2, jl = jf.fit(vol, n_steps=n, batch=batch, params=jp)
    f = em.VolumeField(HashGridConfig(n_levels=4, top_resolution=32),
                       device="cpu")
    draws = _jax_uniforms(0, n, (batch, 3))
    p2, loss = f.fit(vol, n_steps=n, batch=batch, params=_flat(jp),
                     draws=lambda i: draws[i])
    assert loss == pytest.approx(jl, rel=1e-4)
    _close_params(p2, jp2, 1e-5)
    pts = np.random.default_rng(1).random((500, 3)).astype(np.float32)
    np.testing.assert_allclose(
        f.apply(p2, torch.from_numpy(pts)).detach().numpy(),
        np.asarray(jf.apply(jp2, jnp.asarray(pts))), rtol=1e-4)


# ---------------------------------------------------------------------------
# Takikawa
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def octrees():
    V, F = icosphere(0.3, (0.5, 0.5, 0.5), subdiv=2)
    return (V, F, takikawa.build_triangle_octree(V, F, 6, 3),
            jtak.build_triangle_octree(V, F, 6, 3))


def test_octree_build_equals_jax(octrees):
    _, _, tree, jtree = octrees
    assert (tree.starting_level, tree.n_levels, tree.n_vertices) == (
        jtree.starting_level, jtree.n_levels, jtree.n_vertices)
    for a, b in zip(tree.cell_keys + tree.octets,
                    jtree.cell_keys + jtree.octets):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("interpolation", ["linear", "smoothstep"])
def test_takikawa_encode_and_grads_match_jax(octrees, interpolation):
    V, _, tree, jtree = octrees
    rng = np.random.default_rng(2)
    table = (1e-2 * rng.standard_normal((tree.n_vertices, 8))).astype(
        np.float32)
    pts = np.clip(V[rng.integers(0, len(V), 1500)]
                  + rng.normal(0, 0.03, (1500, 3)), 0, 1).astype(np.float32)
    pts[:3] = [[0.5, 0.5, 0.5], [0.02, 0.02, 0.02], [1.0, 1.0, 1.0]]
    gout = rng.standard_normal((1500, tree.n_output_dims)).astype(np.float32)

    def jf(t, p):
        return jnp.sum(jtak.encode(t, p, jtree, interpolation) * gout)

    jenc = jtak.encode(jnp.asarray(table), jnp.asarray(pts), jtree,
                       interpolation)
    jgt, jgp = jax.grad(jf, argnums=(0, 1))(jnp.asarray(table),
                                           jnp.asarray(pts))
    t = torch.from_numpy(table).requires_grad_(True)
    p = torch.from_numpy(pts).requires_grad_(True)
    enc = takikawa.encode(t, p, tree, interpolation)
    np.testing.assert_allclose(enc.detach().numpy(), np.asarray(jenc),
                               rtol=1e-5, atol=1e-7)
    assert float(enc[1].abs().max()) == 0.0        # not refined there
    gt, gp = torch.autograd.grad((enc * torch.from_numpy(gout)).sum(),
                                 (t, p))
    for got, want in ((gt, jgt), (gp, jgp)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    touched = gt.abs().sum(1) > 0
    assert 0 < int(touched.sum()) < tree.n_vertices


# ---------------------------------------------------------------------------
# SdfField (hash and Takikawa)
# ---------------------------------------------------------------------------

def _jax_hash_params(seed, jgrid):
    from rnb_neus2_tpu.config import NetworkConfig as JNetworkConfig
    from rnb_neus2_tpu.models.neus_field import init_params
    from rnb_neus2_torch import interop

    jp = init_params(jax.random.PRNGKey(seed), jgrid, JNetworkConfig())
    return jp, interop.params_from_jax(jax.tree_util.tree_map(np.array, jp))


def test_sdf_fit_hash_matches_jax():
    from rnb_neus2_torch import interop

    V, F = icosphere(0.3, (0.5, 0.5, 0.5), subdiv=2)
    jgrid = JHashGridConfig(n_levels=4, top_resolution=32)
    jf = jem.SdfField(jgrid)
    jp, p = _jax_hash_params(0, jgrid)
    jp2, jl = jf.fit(V, F, n_steps=3, batch=512, params=jp)
    f = em.SdfField(HashGridConfig(n_levels=4, top_resolution=32),
                    device="cpu")
    p2, loss = f.fit(V, F, n_steps=3, batch=512, params=p)
    assert loss == pytest.approx(jl, rel=1e-4)
    want = interop.params_from_jax(jax.tree_util.tree_map(np.array, jp2))
    for k in want:
        err = float((p2[k] - want[k]).abs().max())
        assert err <= 1e-5, (k, err)
    assert f.calculate_iou(1 << 10) == pytest.approx(
        jf.calculate_iou(1 << 10), abs=2e-3)


def test_sdf_fit_takikawa_matches_jax():
    V, F = icosphere(0.3, (0.5, 0.5, 0.5), subdiv=2)
    jf = jem.SdfField(encoding="takikawa", octree_depth=6,
                      octree_starting_level=3)
    jp2_first, _ = jf.fit(V, F, n_steps=1, batch=256)   # builds its octree
    f = em.SdfField(encoding="takikawa", octree_depth=6,
                    octree_starting_level=3, device="cpu")
    f.init(V, F)
    jp = {"table": jp2_first["table"], "mlp": list(jp2_first["mlp"])}
    jp2, jl = jf.fit(V, F, n_steps=3, batch=512, params=jp, seed=1)
    p2, loss = f.fit(V, F, n_steps=3, batch=512, params=_flat(jp), seed=1)
    assert loss == pytest.approx(jl, rel=1e-4)
    _close_params(p2, jp2, 1e-6)


def test_sdf_field_refuses_unknown_encoding():
    with pytest.raises(ValueError, match="takikawa"):
        em.SdfField(encoding="grid", device="cpu")


# ---------------------------------------------------------------------------
# renderers
# ---------------------------------------------------------------------------

def _sphere_sdf_fns(radius=0.3):
    return (lambda p: torch.linalg.norm(p - 0.5, dim=-1) - radius,
            lambda p: jnp.linalg.norm(p - 0.5, axis=-1) - radius)


def test_brdf_and_cameras_match_jax():
    rot, eye = svr.orbit_camera(0.3, 0.2, 1.8)
    jrot, jeye = jsvr.orbit_camera(0.3, 0.2, 1.8)
    np.testing.assert_array_equal(rot.numpy(), np.asarray(jrot))
    np.testing.assert_array_equal(eye.numpy(), np.asarray(jeye))
    o, d = svr.camera_rays(rot, eye, 12, 9, 40.0)
    jo, jd = jsvr.camera_rays(jrot, jeye, 12, 9, 40.0)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    rng = np.random.default_rng(3)
    unit = lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True)
    L, V, N = (unit(rng.standard_normal((400, 3))).astype(np.float32)
               for _ in range(3))
    base = rng.random((400, 3)).astype(np.float32)
    brdf = svr.BRDFParams(metallic=0.3, clearcoat=0.5, sheen=0.2,
                          subsurface=0.4)
    jbrdf = jsvr.BRDFParams(metallic=0.3, clearcoat=0.5, sheen=0.2,
                            subsurface=0.4)
    t = torch.from_numpy
    got = svr.evaluate_shading(t(base), t(base) * 0.1, t(base) + 1.0, brdf,
                               t(L), t(V), t(N))
    want = jsvr.evaluate_shading(base, base * 0.1, base + 1.0, jbrdf, L, V, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    env = svr.proc_envmap(t(L), t(V[0]), t(N[0]), t(base[0]))
    np.testing.assert_allclose(
        env.numpy(), np.asarray(jsvr.proc_envmap(L, V[0], N[0], base[0])),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["shade", "normals", "depth", "positions",
                                  "ao", "cost"])
def test_render_sdf_matches_jax(mode):
    fn, jfn = _sphere_sdf_fns()
    rgba, depth = svr.render_sdf(fn, 20, 16, mode=mode, n_steps=40)
    jrgba, jdepth = jsvr.render_sdf(jfn, 20, 16, mode=mode, n_steps=40)
    assert rgba.shape == (16, 20, 4)
    np.testing.assert_array_equal(rgba[..., 3].numpy(),
                                  np.asarray(jrgba[..., 3]))
    np.testing.assert_allclose(rgba.numpy(), np.asarray(jrgba), atol=1e-4)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), atol=1e-4)
    assert 0 < float(rgba[..., 3].sum()) < 16 * 20


def test_render_volume_matches_jax_on_its_uniforms():
    W, H, E = 12, 10, 24
    key = jax.random.PRNGKey(4)
    # the JAX compositor's per-event uniforms (its key split per event)
    k, us = key, []
    for _ in range(E):
        k, sub = jax.random.split(k)
        us.append(_np(jax.random.uniform(sub, (W * H,), minval=1e-7,
                                         maxval=1.0)))
    dens = lambda p: 3.0 * torch.exp(-((p - 0.5) ** 2).sum(-1) / 0.02)
    jdens = lambda p: 3.0 * jnp.exp(-((p - 0.5) ** 2).sum(-1) / 0.02)
    got = svr.render_volume(dens, W, H, uniforms=torch.from_numpy(
        np.stack(us)), max_events=E, distance_scale=0.1)
    want = jsvr.render_volume(jdens, W, H, key=key, max_events=E,
                              distance_scale=0.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    drawn = svr.render_volume(dens, W, H, generator=gen, max_events=E)
    assert torch.isfinite(drawn).all() and drawn.shape == (H, W, 4)


def test_sdf_and_volume_field_renders_are_finite():
    V, F = icosphere(0.3, (0.5, 0.5, 0.5), subdiv=2)
    f = em.SdfField(HashGridConfig(n_levels=4, top_resolution=32),
                    device="cpu")
    f.fit(V, F, n_steps=2, batch=256)
    img = f.render(W=12, H=10, n_steps=20)
    assert img.shape == (10, 12, 4) and np.isfinite(img).all()
    vf = em.VolumeField(HashGridConfig(n_levels=3, top_resolution=16),
                        device="cpu")
    vf.fit(_volume(8), n_steps=2, batch=256)
    out = vf.render(W=12, H=10, max_events=8)
    assert out.shape == (10, 12, 4) and np.isfinite(out).all()


# ---------------------------------------------------------------------------
# the Testbed in each extra mode
# ---------------------------------------------------------------------------

def test_testbed_image_mode(tmp_path):
    path = str(tmp_path / "img.png")
    save_image(_image(), path, bit_depth=16)
    tb = Testbed(TestbedMode.Image, device="cpu")
    tb.load_training_data(path)
    assert tb.frame()
    tb.train(3)
    assert tb.training_step == 4 and np.isfinite(tb.loss)
    out = tb.render_to_cpu()
    assert out.shape == (24, 24, 3) and np.isfinite(out).all()
    assert tb.render_to_cpu(W=8, H=6).shape == (6, 8, 3)
    with pytest.raises(ValueError, match="Sdf"):
        tb.calculate_iou()


def test_testbed_sdf_mode_matches_jax_facade(tmp_path):
    import rnb_neus2_tpu.api as jngp

    V, F = icosphere(0.3, (0.5, 0.5, 0.5), subdiv=1)
    path = str(tmp_path / "mesh.obj")
    save_mesh(path, V, F)
    tb = Testbed(TestbedMode.Sdf, device="cpu")
    tb.load_training_data(path)
    jtb = jngp.Testbed(jngp.TestbedMode.Sdf)
    jtb.load_training_data(path)
    np.testing.assert_array_equal(tb._extra._data[0], jtb._extra._data[0])
    np.testing.assert_array_equal(tb._extra._data[1], jtb._extra._data[1])
    tb._extra.field = em.SdfField(HashGridConfig(n_levels=3,
                                                 top_resolution=16),
                                  device="cpu")
    tb.train(2)
    assert tb.training_step == 2 and np.isfinite(tb.loss)
    assert 0.0 <= tb.calculate_iou(n_samples=1 << 10) <= 1.0
    img = tb.render_to_cpu(W=10, H=8)
    assert img.shape == (8, 10, 4) and np.isfinite(img).all()


def test_testbed_volume_mode(tmp_path):
    path = str(tmp_path / "vol.npy")
    np.save(path, _volume(8))
    tb = Testbed(TestbedMode.Volume, device="cpu")
    tb.load_training_data(path)
    tb._extra.field = em.VolumeField(HashGridConfig(n_levels=3,
                                                    top_resolution=16),
                                     device="cpu")
    with pytest.raises(RuntimeError, match="train first"):
        tb.render_to_cpu()
    tb.train(2)
    assert tb.training_step == 2 and np.isfinite(tb.loss)
    assert tb.frame() and tb.training_step == 3
