"""Mesh export of the PyTorch port against the JAX package, on the CPU:
marching cubes (numpy and the torch device version), extraction of an
analytic field and of a `NeusField` carried across with `interop.py`,
the OBJ/PLY writer, Chamfer, the composite scene, and the field's
`sdf` / `sdf_features` / `density`."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from rnb_neus2_tpu import config as jconfig
from rnb_neus2_tpu.geom.camera import Cameras as JCameras
from rnb_neus2_tpu.io.dataset import SceneMeta as JSceneMeta
from rnb_neus2_tpu.mesh import extract as jextract
from rnb_neus2_tpu.mesh import metrics as jmetrics
from rnb_neus2_tpu.mesh import writer as jwriter
from rnb_neus2_tpu.mesh.marching import marching_cubes_grid as j_mc
from rnb_neus2_tpu.models.neus_field import NeusField as JNeusField
from rnb_neus2_tpu.models.neus_field import init_params
from rnb_neus2_tpu.testing import synthetic as jsynthetic
from rnb_neus2_torch import config, interop
from rnb_neus2_torch.io.dataset import SceneMeta
from rnb_neus2_torch.mesh import extract, metrics, writer
from rnb_neus2_torch.mesh.marching import marching_cubes_grid
from rnb_neus2_torch.mesh.marching_device import marching_cubes_device
from rnb_neus2_torch.mesh.mc_tables import TRIANGLE_TABLE
from rnb_neus2_torch.models.neus_field import NeusField
from rnb_neus2_torch.testing import synthetic

ORIGIN, SPACING = (0.1, 0.2, 0.3), 0.05


def _volumes():
    rng = np.random.default_rng(0)
    ax = np.linspace(0, 1, 33, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    sphere = 0.3 - np.sqrt((X - .5) ** 2 + (Y - .5) ** 2 + (Z - .5) ** 2)
    return {"sphere": sphere.astype(np.float32),
            "noise": rng.normal(size=(20, 24, 28)).astype(np.float32),
            "constant": np.ones((17, 17, 17), np.float32)}


@pytest.mark.parametrize("name", ["sphere", "noise", "constant"])
def test_marching_cubes_grid_matches_jax_bitwise(name):
    vol = _volumes()[name]
    V0, F0 = j_mc(vol, ORIGIN, SPACING, 0.0)
    V1, F1 = marching_cubes_grid(vol, ORIGIN, SPACING, 0.0)
    assert V1.dtype == np.float32 and F1.dtype == np.int64
    np.testing.assert_array_equal(V1, V0)
    np.testing.assert_array_equal(F1, F0)


@pytest.mark.parametrize("name", ["sphere", "noise", "constant"])
def test_marching_cubes_device_matches_jax(name):
    """The torch version on CPU tensors: the same vertices in the same
    order (V within 1e-5) and the same faces, the empty surface too."""
    vol = _volumes()[name]
    V0, F0 = j_mc(vol, ORIGIN, SPACING, 0.0)
    V1, F1 = marching_cubes_device(torch.from_numpy(vol), ORIGIN, SPACING)
    assert V1.dtype == torch.float32 and F1.dtype == torch.int64
    assert V1.shape == V0.shape and F1.shape == F0.shape
    if len(V0):
        assert np.abs(V1.numpy() - V0).max() <= 1e-5
    np.testing.assert_array_equal(F1.numpy(), F0)
    assert (len(V0) == 0) == (name == "constant")


def _cuda_mc_oracle(vol, thresh=0.0):
    """Straight-line per-cell re-derivation of gen_vertices/gen_faces
    (src/marching_cubes.cu:276-430, 660-718), as in tests/test_mesh.py:
    raster loops, vertidx_grid with axis-major planes, Bourke table."""
    X, Y, Z = vol.shape
    inside = vol > thresh
    vid, verts = {}, []
    for axis, step in ((0, (1, 0, 0)), (1, (0, 1, 0)), (2, (0, 0, 1))):
        for x in range(X - step[0]):
            for y in range(Y - step[1]):
                for z in range(Z - step[2]):
                    x1, y1, z1 = x + step[0], y + step[1], z + step[2]
                    if inside[x, y, z] != inside[x1, y1, z1]:
                        f0, f1 = vol[x, y, z], vol[x1, y1, z1]
                        p = np.array([x, y, z], np.float64)
                        p[axis] += (thresh - f0) / (f1 - f0)
                        vid[(axis, x, y, z)] = len(verts)
                        verts.append(p)
    faces = []
    for x in range(X - 1):
        for y in range(Y - 1):
            for z in range(Z - 1):
                m = (int(inside[x, y, z])
                     | int(inside[x + 1, y, z]) << 1
                     | int(inside[x + 1, y + 1, z]) << 2
                     | int(inside[x, y + 1, z]) << 3
                     | int(inside[x, y, z + 1]) << 4
                     | int(inside[x + 1, y, z + 1]) << 5
                     | int(inside[x + 1, y + 1, z + 1]) << 6
                     | int(inside[x, y + 1, z + 1]) << 7)
                if m == 0 or m == 255:
                    continue
                edges = [
                    (0, x, y, z), (1, x + 1, y, z), (0, x, y + 1, z),
                    (1, x, y, z), (0, x, y, z + 1), (1, x + 1, y, z + 1),
                    (0, x, y + 1, z + 1), (1, x, y, z + 1), (2, x, y, z),
                    (2, x + 1, y, z), (2, x + 1, y + 1, z),
                    (2, x, y + 1, z)]
                row = TRIANGLE_TABLE[m]
                for t in range(0, 15, 3):
                    if row[t] < 0:
                        break
                    faces.append([vid[edges[row[t + i]]] for i in range(3)])
    return (np.array(verts).reshape(-1, 3),
            np.array(faces, np.int64).reshape(-1, 3))


def _canonical(V, F):
    """Vertex-order-independent form: vertices sorted on quantized
    coordinates, faces remapped, rolled to their smallest index, sorted."""
    V = np.round(V * (1 << 16)) / (1 << 16)
    order = np.lexsort((V[:, 2], V[:, 1], V[:, 0]))
    inv = np.empty(len(V), np.int64)
    inv[order] = np.arange(len(V))
    F2 = inv[F]
    roll = np.argmin(F2, axis=1)
    F2 = np.stack([F2[np.arange(len(F2)), (roll + i) % 3]
                   for i in range(3)], axis=1)
    key = np.lexsort((F2[:, 2], F2[:, 1], F2[:, 0]))
    return V[order], F2[key]


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_mc_matches_cuda_oracle_topology(backend):
    """The mirror of tests/test_mesh.py::test_mc_matches_cuda_oracle_topology
    for both of the port's marching cubes."""
    n, r = 18, 0.32
    ax = (np.arange(n) + 0.5) / n
    g = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)
    vol = np.linalg.norm(g - 0.5, axis=-1) - r
    if backend == "numpy":
        V1, F1 = marching_cubes_grid(vol, (0.0, 0.0, 0.0), 1.0, 0.0)
    else:
        V1, F1 = (t.numpy() for t in marching_cubes_device(
            torch.from_numpy(vol.astype(np.float32)), (0.0, 0.0, 0.0), 1.0))
    V0, F0 = _cuda_mc_oracle(vol)
    assert len(V1) == len(V0) and len(F1) == len(F0)
    cV1, cF1 = _canonical(V1.astype(np.float64), F1)
    cV0, cF0 = _canonical(V0, F0)
    np.testing.assert_allclose(cV1, cV0, atol=1e-5)
    np.testing.assert_array_equal(cF1, cF0)


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------

class JAnalyticField:
    """Two spheres (one large, one tiny satellite), the JAX package's
    duck-typed field of tests/test_mesh.py."""

    def __init__(self, c=(0.5, 0.5, 0.5), r=0.3, c2=(0.1, 0.1, 0.1),
                 r2=0.04):
        self.c, self.r = jnp.asarray(c), r
        self.c2, self.r2 = jnp.asarray(c2), r2

    def sdf(self, params, x, valid_level=None):
        d1 = jnp.linalg.norm(x - self.c, axis=1) - self.r
        d2 = jnp.linalg.norm(x - self.c2, axis=1) - self.r2
        return jnp.minimum(d1, d2)

    def sdf_and_grad(self, params, x, valid_level=None):
        d1 = jnp.linalg.norm(x - self.c, axis=1, keepdims=True)
        d2 = jnp.linalg.norm(x - self.c2, axis=1, keepdims=True)
        g = jnp.where(d1 - self.r < d2 - self.r2,
                      (x - self.c) / jnp.maximum(d1, 1e-9),
                      (x - self.c2) / jnp.maximum(d2, 1e-9))
        return self.sdf(params, x), g, None


class AnalyticField:
    """The same two spheres for the port (torch, no parameters)."""

    def __init__(self, c=(0.5, 0.5, 0.5), r=0.3, c2=(0.1, 0.1, 0.1),
                 r2=0.04):
        self.c, self.r = torch.tensor(c), r
        self.c2, self.r2 = torch.tensor(c2), r2

    def sdf(self, x):
        d1 = torch.linalg.norm(x - self.c, dim=1) - self.r
        d2 = torch.linalg.norm(x - self.c2, dim=1) - self.r2
        return torch.minimum(d1, d2)

    def sdf_and_grad(self, x):
        d1 = torch.linalg.norm(x - self.c, dim=1, keepdim=True)
        d2 = torch.linalg.norm(x - self.c2, dim=1, keepdim=True)
        g = torch.where(d1 - self.r < d2 - self.r2,
                        (x - self.c) / torch.clamp_min(d1, 1e-9),
                        (x - self.c2) / torch.clamp_min(d2, 1e-9))
        return self.sdf(x), g, None


METAS = {"identity": dict(from_na=False),
         "from_na_world": dict(from_na=True, n2w_scale=-1.7, scale=0.4,
                               n2w_translation=(0.3, -0.2, 1.1),
                               offset=(0.45, 0.5, 0.55))}


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("meta", sorted(METAS))
def test_extract_analytic_field_matches_jax(meta, backend):
    want = jextract.extract_mesh(JAnalyticField(), None, resolution=48,
                                 meta=JSceneMeta(**METAS[meta]))
    got = extract.extract_mesh(AnalyticField(), None, resolution=48,
                               meta=SceneMeta(**METAS[meta]),
                               backend=backend)
    assert len(want["F"]) > 500 and got["C"] is None
    assert got["V"].shape == want["V"].shape and got["V"].dtype == np.float32
    assert np.abs(got["V"] - want["V"]).max() <= 1e-5
    np.testing.assert_array_equal(got["F"], want["F"])
    assert np.abs(got["N"] - want["N"]).max() <= 1e-4
    assert got["active_blocks"] > 0
    assert set(got["seconds"]) == {"coarse", "fine", "marching_cubes",
                                   "finish"}


def test_extract_empty_surface():
    far = AnalyticField(c=(0.5, 0.5, 0.5), r=-1.0, c2=(5.0, 5.0, 5.0))
    m = extract.extract_mesh(far, None, resolution=32)
    assert m["V"].shape == (0, 3) and m["F"].shape == (0, 3)
    assert m["active_blocks"] == 0


GRID = dict(n_levels=3, top_resolution=32, log2_hashmap_size=12)
RES = 48


@pytest.fixture(scope="module")
def neus():
    """A JAX NeusField's parameters moved off the init (noisy sphere), the
    same in a port NeusField."""
    jgrid = jconfig.HashGridConfig(**GRID)
    jnet = jconfig.NetworkConfig()
    params = jax.tree_util.tree_map(
        np.asarray, init_params(jax.random.PRNGKey(0), jgrid, jnet))
    rng = np.random.default_rng(1)
    params["hash_table"] = (1e-2 * rng.standard_normal(
        params["hash_table"].shape)).astype(np.float32)
    w_x, w_enc = params["sdf_mlp"][0]
    params["sdf_mlp"][0] = (w_x, (0.05 * rng.standard_normal(
        w_enc.shape)).astype(np.float32))
    field = NeusField(config.HashGridConfig(**GRID), config.NetworkConfig(),
                      "cpu")
    field.load_state_dict(interop.params_from_jax(params))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    return JNeusField(jgrid, jnet), jparams, field


def _jax_volumes(jfield, jparams, res=RES, block=16, cf=4):
    """The JAX host path of `extract_mesh` up to its volume."""
    cres = res // cf
    axc = (np.arange(cres) + 0.5) * (1.0 / cres)
    cg = np.stack(np.meshgrid(axc, axc, axc, indexing="ij"), -1)
    csdf = jextract._sdf_volume(jfield, jparams, cg.reshape(-1, 3).astype(
        np.float32)).reshape(cres, cres, cres)
    slack = 2.0 * (1.0 / cres) * np.sqrt(3)
    nb, bc = res // block, block // cf
    bmin = np.abs(csdf.reshape(nb, bc, nb, bc, nb, bc)).min(axis=(1, 3, 5))
    active = np.argwhere(bmin < slack)
    fi = np.minimum(np.arange(res + 1) * cres // res, cres - 1)
    vol = csdf[np.ix_(fi, fi, fi)].astype(np.float32)
    loc = np.arange(block + 1)
    local = np.stack(np.meshgrid(loc, loc, loc, indexing="ij"),
                     -1).reshape(-1, 3)
    idx = (active[:, None, :] * block + local[None]).reshape(-1, 3)
    pts = np.clip(0.0 + idx.astype(np.float32) * (1.0 / res), 0.0, 1.0)
    vals = jextract._sdf_volume(jfield, jparams, pts).reshape(
        len(active), block + 1, block + 1, block + 1)
    for v, i0 in zip(vals, active * block):
        vol[i0[0]:i0[0] + block + 1, i0[1]:i0[1] + block + 1,
            i0[2]:i0[2] + block + 1] = v
    return csdf, active, vol


def test_neus_field_volumes_match_jax(neus):
    """Coarse and fine volumes within 1e-5 of the JAX package's, the same
    active blocks, and JAX's volume through the port's marching cubes
    gives JAX's mesh."""
    jfield, jparams, field = neus
    csdf0, active0, vol0 = _jax_volumes(jfield, jparams)
    csdf, active = extract.coarse_pass(field, RES, 0.0, 1.0)
    vol = extract.fine_volume(field, csdf, active, RES, 0.0, 1.0)
    assert 0 < len(active0) < (RES // 16) ** 3
    np.testing.assert_array_equal(active.numpy(), active0)
    assert np.abs(csdf.numpy() - csdf0).max() <= 1e-5
    assert np.abs(vol.numpy() - vol0).max() <= 1e-5
    V0, F0 = j_mc(vol0, (0.0, 0.0, 0.0), 1.0 / RES)
    V1, F1 = marching_cubes_device(torch.from_numpy(vol0), (0.0, 0.0, 0.0),
                                   1.0 / RES)
    assert len(F0) > 500
    assert np.abs(V1.numpy() - V0).max() <= 1e-5
    np.testing.assert_array_equal(F1.numpy(), F0)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_neus_field_mesh_and_colors_match_jax(neus, backend):
    jfield, jparams, field = neus
    want = jextract.extract_mesh(jfield, jparams, resolution=RES,
                                 with_colors=True)
    got = extract.extract_mesh(field, None, resolution=RES,
                               with_colors=True, backend=backend)
    assert got["V"].shape == want["V"].shape
    assert np.abs(got["V"] - want["V"]).max() <= 1e-5
    np.testing.assert_array_equal(got["F"], want["F"])
    assert np.abs(got["N"] - want["N"]).max() <= 1e-4
    assert np.abs(got["C"] - want["C"]).max() <= 1e-5


def test_mesh_comes_from_the_params_passed(neus):
    """extract_mesh(field, ema) evaluates the field with `ema` (as the
    trainer's inference_params), not with the field's own parameters,
    which it leaves as they were."""
    _, _, field = neus
    own = {k: v.clone() for k, v in field.state_dict().items()}
    ema = {k: v.clone() for k, v in own.items()}
    out_layer = max(k for k in ema if k.startswith("sdf_rest."))
    ema[out_layer] = ema[out_layer] * 0.8          # rescales the SDF
    other = NeusField(field.grid, field.net, "cpu")
    other.load_state_dict(ema)
    got = extract.extract_mesh(field, ema, resolution=RES, backend="host")
    want = extract.extract_mesh(other, None, resolution=RES, backend="host")
    raw = extract.extract_mesh(field, None, resolution=RES, backend="host")
    np.testing.assert_array_equal(got["V"], want["V"])
    np.testing.assert_array_equal(got["F"], want["F"])
    assert got["V"].shape != raw["V"].shape \
        or np.abs(got["V"] - raw["V"]).max() > 1e-3
    for k, v in field.state_dict().items():
        assert torch.equal(v, own[k]), k


def test_field_sdf_and_density_match_jax(neus):
    """`NeusField.sdf`, `sdf_features` and `density` against the JAX
    package's on the same parameters: sdf within 1e-5, density within
    1e-5 relative, at every level and with levels masked."""
    jfield, jparams, field = neus
    x = np.random.default_rng(2).random((4096, 3)).astype(np.float32)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        for vl, na in ((None, None), (2, None), (1, 2)):
            feats = field.sdf_features(xt, vl, na).numpy()
            jfeats = np.asarray(jfield.sdf_features(jparams, jnp.asarray(x),
                                                    vl, na))
            assert np.abs(feats - jfeats).max() <= 1e-5
            sdf = field.sdf(xt, vl, na).numpy()
            jsdf = np.asarray(jfield.sdf(jparams, jnp.asarray(x), vl, na))
            assert np.abs(sdf - jsdf).max() <= 1e-5
            dens = field.density(xt, vl, na).numpy()
            jdens = np.asarray(jfield.density(jparams, jnp.asarray(x), vl,
                                              na))
            assert np.abs(dens - jdens).max() <= 1e-5 * np.abs(jdens).max()
            assert np.abs(jdens).max() > 0


# ---------------------------------------------------------------------------
# writer, Chamfer, composite scene
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ext,normals,colors", [
    ("obj", False, False), ("obj", True, False), ("obj", True, True),
    ("ply", False, False), ("ply", True, True)])
def test_writer_bytes_match_jax(tmp_path, ext, normals, colors):
    m = extract.extract_mesh(AnalyticField(), None, resolution=32,
                             meta=SceneMeta(from_na=False))
    rng = np.random.default_rng(3)
    N = m["N"] if normals else None
    C = rng.random(m["V"].shape).astype(np.float32) * 1.2 - 0.1 \
        if colors else None
    p0, p1 = tmp_path / f"jax.{ext}", tmp_path / f"sub/port.{ext}"
    jwriter.save_mesh(p0, m["V"], m["F"], N, C)
    writer.save_mesh(p1, m["V"], m["F"], N, C)
    assert p1.read_bytes() == p0.read_bytes()
    if ext == "obj":
        V, F = writer.load_obj(p1)
        np.testing.assert_array_equal(F, m["F"])
        # "%0.5f" rounds by ≤ 5e-6, and parsing to float32 adds an ulp
        assert np.abs(V - m["V"]).max() <= 1e-5


def test_chamfer_matches_jax():
    ax = np.linspace(0, 1, 25, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt((X - .5) ** 2 + (Y - .5) ** 2 + (Z - .5) ** 2)
    V1, F1 = marching_cubes_grid(0.3 - r, (0, 0, 0), 1 / 24)
    V2, F2 = marching_cubes_grid(
        0.28 - r + 0.01 * np.sin(9 * X), (0, 0, 0), 1 / 24)
    want = jmetrics.chamfer_distance(V1, F1, V2, F2, n_samples=20_000,
                                     seed=4)
    got = metrics.chamfer_distance(V1, F1, V2, F2, n_samples=20_000, seed=4)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert 0.005 < got["chamfer_l1"] < 0.05


def test_composite_scene_matches_jax():
    p = np.random.default_rng(5).random((2000, 3)).astype(np.float32)
    np.testing.assert_allclose(synthetic.composite_sdf(p),
                               jsynthetic.composite_sdf(p), atol=1e-6)
    np.testing.assert_allclose(synthetic.composite_normal(p),
                               jsynthetic.composite_normal(p), atol=1e-6)
    np.testing.assert_allclose(synthetic.composite_albedo(p),
                               jsynthetic.composite_albedo(p), atol=1e-6)
    jc = jsynthetic.ring_cameras(2, 1.6, 24, 20, 900.0 * 24 / 512)
    cams = synthetic.ring_cameras(2, 1.6, 24, 20, 900.0 * 24 / 512)
    assert isinstance(jc, JCameras)
    for got, want in zip(synthetic.render_composite_views(cams),
                         jsynthetic.render_composite_views(jc)):
        np.testing.assert_allclose(got, want, atol=1e-6)
    assert synthetic.render_composite_views(cams)[2].sum() > 0
    V, F = synthetic.composite_gt_mesh(48)
    V0, F0 = jsynthetic.composite_gt_mesh(48)
    np.testing.assert_allclose(V, V0, atol=1e-6)
    np.testing.assert_array_equal(F, F0)


def test_volume_gradients_match_jax():
    from rnb_neus2_tpu.mesh import marching as jmarching
    from rnb_neus2_torch.mesh import marching

    vol = _volumes()["noise"]
    np.testing.assert_array_equal(marching._volume_gradient(vol, 0.05),
                                  jmarching._volume_gradient(vol, 0.05))
    pts = np.random.default_rng(6).random((500, 3)) * 1.2
    origin = np.asarray(ORIGIN)
    np.testing.assert_array_equal(
        marching._volume_gradient_at(vol, origin, SPACING, pts),
        jmarching._volume_gradient_at(vol, origin, SPACING, pts))
