"""The port's inference renderer and its parts against the JAX package's
(`render/{renderer,neus,envmap,buffer,camera_path}.py`,
`ops/ray_march.py:march`), on the same numpy inputs.

Tolerances:
- `march` and `t_ladder`: bitwise (t, dt, valid, n_valid) at cone 0, the
  default of every scene with aabb_scale ≤ 1; the JAX side runs op by op
  (`jax.disable_jit`), because under `jit` XLA contracts
  `startt + k·dt_min` into a fused multiply-add and moves t by an ulp. At
  cone > 0 the geometric phase of the ladder is a float power, whose last
  ulp differs between XLA's and PyTorch's `pow`: there valid and n_valid
  are held bit for bit and t and dt within 1e-6 relative, as
  `tests/test_torch_march.py` holds `march_flat`;
- `composite`, the envmap (sample, background, gradient) and the tonemap
  pipeline: within 1e-6;
- `render_view` on parameters and a bitfield carried from JAX, at
  render_scale 1, 0.5 and 2: albedo, alpha and depth within 1e-5
  absolute; the normal within 1e-5 where alpha ≥ 0.05, and alpha × normal
  within 1e-5 everywhere (at the silhouette's fringe the normal is the
  normalized sum of weights near 1e-3, which turns float32 rounding into
  up to 3e-5 of direction; at render_scale 2 a pixel's normal averages
  four such sums);
- camera paths: each package reads the JSON the other wrote, keyframes
  equal; `spline`, `eval` and `frames` within 1e-6.
"""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rnb_neus2_tpu import config as jconfig
from rnb_neus2_tpu.grid import occupancy as jocc
from rnb_neus2_tpu.models.neus_field import NeusField as JField, init_params
from rnb_neus2_tpu.ops import ray_march as jmarch
from rnb_neus2_tpu.render import buffer as jbuffer
from rnb_neus2_tpu.render import camera_path as jpath
from rnb_neus2_tpu.render import envmap as jenvmap
from rnb_neus2_tpu.render import neus as jneus
from rnb_neus2_tpu.render import renderer as jrenderer
from rnb_neus2_tpu.testing.synthetic import sphere_dataset as jsphere
from rnb_neus2_torch import config, interop
from rnb_neus2_torch.models.neus_field import NeusField
from rnb_neus2_torch.ops import ray_march
from rnb_neus2_torch.render import buffer, camera_path, envmap, neus
from rnb_neus2_torch.render import renderer
from rnb_neus2_torch.testing.synthetic import sphere_dataset


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _rays(n, seed):
    """Rays from a shell around the unit cube towards points inside it."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 0.5 + 1.5 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.random((n, 3)) * 0.8 + 0.1 - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32), \
        rng.random(n).astype(np.float32)


@pytest.mark.parametrize("cone", [0.0, 1.0 / 256.0])
@pytest.mark.parametrize("max_samples", [16, 256])
def test_march_bitwise(cone, max_samples):
    o, d, u = _rays(300, 1)
    rng = np.random.default_rng(2)
    bit = rng.random(32 ** 3) < 0.3
    with jax.disable_jit():
        want = jmarch.march(jnp.asarray(o), jnp.asarray(d), jnp.asarray(bit),
                            jnp.asarray(u), 1024, max_samples, cone)
    got = ray_march.march(_t(o), _t(d), _t(bit), _t(u), 1024, max_samples,
                          cone)
    for name in ("t", "dt", "valid", "n_valid"):
        w = np.array(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.shape == w.shape, name
        if cone > 0 and name in ("t", "dt"):
            np.testing.assert_allclose(g, w, rtol=1e-6)
        else:
            assert np.array_equal(g.view(np.uint8), w.astype(
                g.dtype).view(np.uint8)), name
    n_valid = got.n_valid.numpy()
    assert n_valid.max() > max_samples > 0 or max_samples == 256
    assert got.valid.numpy().sum() == np.minimum(
        n_valid, got.t.shape[1]).sum()


def test_t_ladder_bitwise():
    u = np.random.default_rng(3).random(64).astype(np.float32) * 0.7
    for cone in (0.0, 1.0 / 256.0):
        with jax.disable_jit():
            want = np.array(jmarch.t_ladder(jnp.asarray(u), 700, cone))
        got = ray_march.t_ladder(_t(u), 700, cone).numpy()
        if cone:
            np.testing.assert_allclose(got, want, rtol=1e-6)
        else:
            assert np.array_equal(got, want)


def test_composite_matches_jax():
    rng = np.random.default_rng(4)
    alpha = (rng.random((200, 48)) ** 3).astype(np.float32)
    alpha[:20] = 0.9
    valid = rng.random((200, 48)) < 0.8
    want = jneus.composite(jnp.asarray(alpha), jnp.asarray(valid))
    got = neus.composite(_t(alpha), _t(valid))
    for name in ("alpha", "weight", "trans"):
        err = np.abs(getattr(got, name).numpy()
                     - np.array(getattr(want, name))).max()
        assert err <= 1e-6, name
    assert np.array_equal(got.keep.numpy(), np.array(want.keep))
    assert not got.keep.numpy()[:20, -1].any()   # terminated


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    d = np.concatenate([d, [[0, 1, 0], [0, -1, 0], [0, 0, 1], [-1, 0, 0]]])
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def test_envmap_matches_jax():
    rng = np.random.default_rng(5)
    e = rng.random((8, 16, 4)).astype(np.float32)
    dirs = _dirs(500, 6)
    want = np.array(jenvmap.sample_envmap(jnp.asarray(e), jnp.asarray(dirs)))
    got = envmap.sample_envmap(_t(e), _t(dirs)).numpy()
    assert np.abs(got - want).max() <= 1e-6
    bg = envmap.background_color(_t(e), _t(dirs)).numpy()
    assert np.abs(bg - want[:, :3]).max() <= 1e-6
    const = envmap.background_color(None, _t(dirs[:2]), (0.25, 0.5, 0.75))
    assert np.array_equal(const.numpy(), np.array(jenvmap.background_color(
        None, jnp.asarray(dirs[:2]), (0.25, 0.5, 0.75))))
    assert np.array_equal(envmap.init_envmap(8, 16, 0.3).numpy(),
                          np.array(jenvmap.init_envmap(8, 16, 0.3)))
    # the gradient of a background loss in the envmap: autograd against
    # jax.grad
    target = np.array([0.9, 0.1, 0.4], np.float32)
    jg = np.array(jax.grad(lambda em: jnp.mean(
        (jenvmap.background_color(em, jnp.asarray(dirs)) - target) ** 2))(
            jnp.asarray(e)))
    et = _t(e).requires_grad_(True)
    torch.mean((envmap.background_color(et, _t(dirs)) - _t(target)) ** 2) \
        .backward()
    assert np.abs(et.grad.numpy() - jg).max() <= 1e-6


def test_envmap_is_trainable_through_background():
    """Adam on the envmap recovers a target background color (the
    reference's deposit_envmap_gradient path, envmap.cuh:69-104, through
    autograd), as the JAX package's test of the same name does."""
    e = envmap.init_envmap(4, 8, value=0.2).requires_grad_(True)
    dirs = _t(_dirs(128, 1))
    target = torch.tensor([0.9, 0.1, 0.4])
    opt = torch.optim.Adam([e], lr=0.05)
    for _ in range(300):
        opt.zero_grad()
        loss = torch.mean((envmap.background_color(e, dirs) - target) ** 2)
        loss.backward()
        opt.step()
    assert float(loss.detach()) < 1e-4


@pytest.mark.parametrize("curve", list(buffer.TonemapCurve),
                         ids=lambda c: c.value)
@pytest.mark.parametrize("spaces", [("linear", "srgb"), ("srgb", "srgb"),
                                    ("linear", "linear"),
                                    ("srgb", "linear")])
def test_tonemap_matches_jax(curve, spaces):
    x = (np.random.default_rng(7).random((64, 3)) * 3.0 - 0.5) \
        .astype(np.float32)
    jcurve = jbuffer.TonemapCurve(curve.value)
    cs, out_cs = spaces
    want = np.array(jbuffer.tonemap(
        jnp.asarray(x), 0.5, jcurve, jbuffer.ColorSpace(cs),
        jbuffer.ColorSpace(out_cs)))
    got = buffer.tonemap(_t(x), 0.5, curve, buffer.ColorSpace(cs),
                         buffer.ColorSpace(out_cs)).numpy()
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite)
    assert np.abs(got[finite] - want[finite]).max() <= 1e-6


def test_render_buffer_matches_jax():
    rng = np.random.default_rng(8)
    frames = rng.random((3, 6, 5, 4)).astype(np.float32)
    jb = jbuffer.RenderBuffer.create(5, 6)
    b = buffer.RenderBuffer.create(5, 6)
    for f in frames:
        jb = jb.accumulate(jnp.asarray(f))
        b = b.accumulate(_t(f))
    assert b.spp == jb.spp == 3
    assert np.abs(b.accumulation.numpy() - frames.mean(0)).max() <= 1e-6
    for curve in buffer.TonemapCurve:
        got = b.tonemapped(0.0, curve).numpy()
        want = np.array(jb.tonemapped(0.0, jbuffer.TonemapCurve(curve.value)))
        assert np.abs(got - want).max() <= 1e-6
    assert b.clear().spp == 0 and not b.clear().accumulation.any()


def _keyframes(pkg, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        q = rng.normal(size=4)
        m = np.zeros((3, 4), np.float32)
        m[:, :3] = jpath._quat_to_mat(q / np.linalg.norm(q))
        m[:, 3] = rng.normal(size=3)
        out.append(pkg.CameraKeyframe.from_matrix(
            m, slice=float(rng.random()), scale=1.0 + float(rng.random()),
            fov=40.0 + 20 * float(rng.random()), dof=float(rng.random())))
    return out


def test_camera_path_files_and_playback_match_jax(tmp_path):
    kfs, jkfs = _keyframes(camera_path, 5, 9), _keyframes(jpath, 5, 9)
    path, jp = camera_path.CameraPath(kfs), jpath.CameraPath(jkfs)
    path.play_time = jp.play_time = 0.25
    path.save(str(tmp_path / "port.json"))
    jp.save(str(tmp_path / "jax.json"))
    assert json.loads((tmp_path / "port.json").read_text()) \
        == json.loads((tmp_path / "jax.json").read_text())
    from_jax = camera_path.CameraPath.load(str(tmp_path / "jax.json"))
    from_port = jpath.CameraPath.load(str(tmp_path / "port.json"))
    assert from_jax.play_time == from_port.play_time == 0.25
    for a, b in zip(from_jax.keyframes, from_port.keyframes):
        assert np.array_equal(a.R, b.R) and np.array_equal(a.T, b.T)
        assert (a.slice, a.scale, a.fov, a.dof) == (b.slice, b.scale, b.fov,
                                                    b.dof)
    for t in (0.0, 0.1, 0.37, 0.5, 0.99, 1.0):
        a, b = from_jax.eval(t), from_port.eval(t)
        assert np.abs(a.R - b.R).max() <= 1e-6
        assert np.abs(a.m() - b.m()).max() <= 1e-6
        assert abs(a.fov - b.fov) <= 1e-6 * b.fov
    s = camera_path.spline(0.3, *kfs[:4])
    js = jpath.spline(0.3, *jkfs[:4])
    assert np.abs(s.R - js.R).max() <= 1e-6 and np.abs(s.T - js.T).max() \
        <= 1e-6
    got, want = path.frames(7), jp.frames(7)
    assert len(got) == 7
    assert max(np.abs(a - b).max() for a, b in zip(got, want)) <= 1e-6
    # the rotation survives matrix → quaternion → matrix
    m = kfs[0].m()
    assert np.abs(camera_path.CameraKeyframe.from_matrix(m).m() - m).max() \
        <= 1e-6


def test_resampling_helpers_match_jax():
    img = np.random.default_rng(10).random((7, 9, 3)).astype(np.float32)
    assert np.array_equal(renderer._upsample(img, 20, 15),
                          jrenderer._upsample(img, 20, 15))
    assert np.array_equal(renderer._downsample_box(img, 4, 3),
                          jrenderer._downsample_box(img, 4, 3))


@pytest.fixture(scope="module")
def carried():
    """A field of the JAX package's parameters (sharpened: variance 0.6,
    noise on the table and on the SDF MLP's encoding columns), and an
    occupancy grid of its density, in both packages."""
    grid = jconfig.HashGridConfig(n_levels=4, top_resolution=64)
    params = dict(init_params(jax.random.PRNGKey(0), grid,
                              jconfig.NetworkConfig()))
    params["variance"] = jnp.full_like(params["variance"], 0.6)
    params["hash_table"] = params["hash_table"] + 1e-2 * jax.random.normal(
        jax.random.PRNGKey(1), params["hash_table"].shape)
    (w_x, w_enc), out = params["sdf_mlp"]
    params["sdf_mlp"] = [(w_x, w_enc + 0.05 * jax.random.normal(
        jax.random.PRNGKey(2), w_enc.shape)), out]
    jfield = JField(grid, jconfig.NetworkConfig())
    dens = jfield.density(params, jocc.cell_positions(jax.random.PRNGKey(3),
                                                      32))
    bit = jocc.update(jocc.init_state(32), dens).bitfield
    field = NeusField(config.HashGridConfig(n_levels=4, top_resolution=64),
                      config.NetworkConfig(), "cpu")
    field.load_state_dict(interop.params_from_jax(
        jax.tree_util.tree_map(np.array, params)))
    return jfield, params, bit, field


@pytest.mark.parametrize("scale", [1.0, 0.5, 2.0])
def test_render_view_matches_jax(carried, scale):
    jfield, params, bit, field = carried
    jds = jsphere(n_views=2, width=24, height=20, radius=0.25)
    ds = sphere_dataset(n_views=2, width=24, height=20, radius=0.25)
    with jax.disable_jit():
        want = jrenderer.render_view(
            jfield, params, jds.cameras, 1, bit,
            jconfig.MarchConfig(n_ladder=512), max_samples=64, tile=512,
            render_scale=scale)
    got = renderer.render_view(field, None, ds.cameras, 1, _t(bit),
                               config.MarchConfig(n_ladder=512),
                               max_samples=64, tile=256, render_scale=scale)
    for k in ("albedo", "alpha", "depth"):
        assert got[k].shape == want[k].shape
        assert np.abs(got[k] - want[k]).max() <= 1e-5, k
    a = want["alpha"][..., None]
    assert np.abs(a * (got["normal"] - want["normal"])).max() <= 1e-5
    solid = want["alpha"] >= 0.05
    assert solid.sum() > 20 and (want["alpha"] < 0.01).sum() > 20
    assert np.abs(got["normal"] - want["normal"])[solid].max() <= 1e-5
    # the silhouette is there: a surface in the middle, background around
    assert want["alpha"].max() > 0.99
