"""The JAX package's last modules in the port, each against its JAX
counterpart: slabbed device marching cubes, `marching_tets`, the
unit-sphere-normalized composite scene (v2), the pyalicevision SfMData
loader (mocked bindings, as in tests/test_pyav_loader.py), the NeuS →
transform.json converter and the Meshroom node (mocked `meshroom.core`,
as in tests/test_meshroom_node.py)."""

import importlib.util
import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

from rnb_neus2_tpu.io import dataloaders as jloaders
from rnb_neus2_tpu.mesh import marching as jmarching
from rnb_neus2_tpu.mesh.marching_device import (
    marching_cubes_device_slabbed as j_slabbed)
from rnb_neus2_tpu.testing import synthetic as jsynthetic
from rnb_neus2_torch.io import dataloaders, png
from rnb_neus2_torch.mesh import extract, marching
from rnb_neus2_torch.mesh.marching_device import (
    marching_cubes_device, marching_cubes_device_slabbed)
from rnb_neus2_torch.testing import synthetic
from rnb_neus2_torch.tools import data_format_from_neus
from test_meshroom_node import node_cls  # noqa: F401  (fixture)
from test_pyav_loader import (_Intrinsic, _install_mock, _PinholeCam,
                              _scene)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORIGIN, SPACING = (0.1, 0.2, 0.3), 0.05


# ---------------------------------------------------------------------------
# slabbed marching cubes
# ---------------------------------------------------------------------------

def _mc_volumes():
    rng = np.random.default_rng(1)
    ax = np.linspace(0, 1, 33, dtype=np.float32)
    X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
    sphere = (0.3 - np.sqrt((X - .5) ** 2 + (Y - .5) ** 2
                            + (Z - .5) ** 2)).astype(np.float32)
    # a surface lying in the slab boundary planes x = 8, 16 and 24 (cells
    # on both sides of a boundary cross it)
    planes = sphere.copy()
    planes[8::8] = np.where(planes[8::8] > 0, -0.01, 0.01)
    return [("sphere", sphere, 8),
            ("planes", planes, 4), ("planes", planes, 8),
            ("noise", rng.normal(size=(33, 25, 29)).astype(np.float32), 8),
            ("constant", np.ones((17, 19, 23), np.float32), 4),
            ("noise9", rng.normal(size=(9, 9, 9)).astype(np.float32), 2)]


@pytest.mark.parametrize("case", range(len(_mc_volumes())))
def test_marching_cubes_slabbed_matches_one_shot_and_jax(case):
    """The port's slabbed output equals its one-shot and the numpy
    `marching_cubes_grid` bit for bit; against JAX's slabbed variant the
    faces are equal and the vertices within 1e-5 (JAX interpolates in
    float32 on its device, the port in float64, as the one-shot test
    in tests/test_torch_mesh.py allows)."""
    _, vol, ns = _mc_volumes()[case]
    t = torch.from_numpy(vol)
    V1, F1 = marching_cubes_device(t, ORIGIN, SPACING)
    V2, F2 = marching_cubes_device_slabbed(t, ORIGIN, SPACING, 0.0, ns)
    assert torch.equal(V1, V2) and torch.equal(F1, F2)
    V3, F3 = marching.marching_cubes_grid(vol, ORIGIN, SPACING, 0.0)
    np.testing.assert_array_equal(V2.numpy(), V3)
    np.testing.assert_array_equal(F2.numpy(), F3)
    V0, F0 = j_slabbed(vol, ORIGIN, SPACING, 0.0, n_slabs=ns)
    assert V0.shape == V2.shape
    if len(V0):
        assert np.abs(V2.numpy() - V0).max() <= 1e-5
    np.testing.assert_array_equal(F2.numpy(), F0)


def test_marching_cubes_slabbed_refuses_uneven_slabs():
    with pytest.raises(ValueError, match="divisible"):
        marching_cubes_device_slabbed(torch.zeros(10, 4, 4), ORIGIN, SPACING,
                                      0.0, 4)


def test_extract_mesh_is_the_same_at_every_slab_count(monkeypatch):
    class Sphere(torch.nn.Module):
        def sdf(self, x):
            return 0.3 - (x - 0.5).norm(dim=-1)

        def sdf_and_grad(self, x):
            d = x - 0.5
            return self.sdf(x), -d / d.norm(dim=-1, keepdim=True), None

    assert extract.mc_slabs(torch.zeros(65, 65, 65)) == 1
    meshes = []
    for n in (1, 2, 4, 16):
        monkeypatch.setattr(extract, "mc_slabs", lambda vol: n)
        meshes.append(extract.extract_mesh(Sphere(), None, 64,
                                           backend="device"))
    for m in meshes[1:]:
        for k in ("V", "F", "N"):
            np.testing.assert_array_equal(m[k], meshes[0][k])
    assert len(meshes[0]["F"]) > 1000


# ---------------------------------------------------------------------------
# marching_tets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,thresh", [((12, 12, 12), 0.0),
                                          ((9, 11, 13), 0.3),
                                          ((1, 5, 5), 0.0)])
def test_marching_tets_matches_jax(shape, thresh):
    rng = np.random.default_rng(3)
    vol = rng.normal(size=shape).astype(np.float32)
    if shape == (12, 12, 12):
        ax = np.linspace(-1, 1, 12)
        X, Y, Z = np.meshgrid(ax, ax, ax, indexing="ij")
        vol = (np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 0.6).astype(np.float32)
    origin = np.asarray(ORIGIN)
    V, F = marching.marching_tets(vol, origin, SPACING, thresh)
    V0, F0 = jmarching.marching_tets(vol, origin, SPACING, thresh)
    assert V.dtype == V0.dtype and F.dtype == F0.dtype
    np.testing.assert_array_equal(V, V0)
    np.testing.assert_array_equal(F, F0)
    assert (len(F) > 0) == (shape[0] > 1)


def test_tet_triangles_match_jax():
    ins = np.random.default_rng(4).random((200, 4)) < 0.5
    (tris, rows), (jtris, jrows) = (marching._tet_triangles(ins),
                                    jmarching._tet_triangles(ins))
    assert len(tris) == len(jtris) > 0
    for a, b, r, jr in zip(tris, jtris, rows, jrows):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(r, jr)


# ---------------------------------------------------------------------------
# composite v2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def norm():
    got, want = synthetic.composite_norm(1.0), jsynthetic.composite_norm(1.0)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    return got


def test_composite_norm_and_sdf_v2_match_jax(norm):
    assert synthetic.composite_norm(0.8)[1] == jsynthetic.composite_norm(
        0.8)[1]
    p = np.random.default_rng(5).random((3000, 3)).astype(np.float32)
    np.testing.assert_array_equal(synthetic.composite_sdf_v2(p, norm),
                                  jsynthetic.composite_sdf_v2(p, norm))


def test_composite_dataset_and_gt_mesh_v2_match_jax(norm):
    ds = synthetic.composite_dataset_v2(n_views=2, width=24, height=20,
                                        focal=1550.0 * 24 / 512)
    jds = jsynthetic.composite_dataset_v2(n_views=2, width=24, height=20,
                                          focal=1550.0 * 24 / 512)
    for f in ("normals", "albedos", "alpha_normal", "alpha_albedo",
              "skip_candidate"):
        np.testing.assert_allclose(getattr(ds, f).numpy(),
                                   np.asarray(getattr(jds, f)), atol=1e-6,
                                   err_msg=f)
    assert float(ds.alpha_normal.sum()) > 0
    V, F = synthetic.composite_gt_mesh_v2(32)
    V0, F0 = jsynthetic.composite_gt_mesh_v2(32)
    np.testing.assert_array_equal(V, V0)
    np.testing.assert_array_equal(F, F0)


@pytest.mark.parametrize("normalized", [False, True])
def test_write_prepared_composite_scene_matches_jax(tmp_path, normalized):
    kw = dict(n_views=2, width=24, height=20, normalized=normalized)
    if not normalized:
        kw["focal"] = 900.0 * 24 / 512
    synthetic.write_prepared_composite_scene(str(tmp_path / "port"), **kw)
    jsynthetic.write_prepared_composite_scene(str(tmp_path / "jax"), **kw)
    tj = [json.load(open(tmp_path / d / "transform.json"))
          for d in ("port", "jax")]
    assert tj[0] == tj[1]
    for fr in tj[0]["frames"]:
        for key in ("normal_path", "albedo_path"):
            a, b = (png.read_png(tmp_path / d / fr[key])
                    for d in ("port", "jax"))
            assert a.dtype == np.uint16 and a.shape == (20, 24, 4)
            np.testing.assert_array_equal(a, b)
    assert png.read_png(tmp_path / "port" / "normals" / "00000.png")[
        ..., 3].max() == 65535


# ---------------------------------------------------------------------------
# the pyalicevision loader
# ---------------------------------------------------------------------------

def _same_contract(got, want):
    assert (got["image_width"], got["image_height"], got["scale_mat"]) == (
        want["image_width"], want["image_height"], want["scale_mat"])
    if want["landmarks"] is None:
        assert got["landmarks"] is None
    else:
        np.testing.assert_array_equal(got["landmarks"], want["landmarks"])
    assert len(got["views"]) == len(want["views"]) > 0
    for v, jv in zip(got["views"], want["views"]):
        assert set(v) == set(jv)
        for k in ("c2w", "K"):
            assert v[k].dtype == jv[k].dtype
            np.testing.assert_array_equal(v[k], jv[k])
        for k in ("normal_path", "albedo_path", "mask_path", "pose_id"):
            assert v[k] == jv[k], k


def _albedo_and_mask(tmp_path, scene):
    """An albedo SfMData for pose 11 and a mask SfMData for pose 22."""
    import copy

    alb, msk = copy.copy(scene), copy.copy(scene)
    a = tmp_path / "a11.png"
    a.write_bytes(b"")
    alb.views = {11: type(scene.views[11])(11, type(
        scene.views[11].getImage())(str(a), 640, 480))}
    m = tmp_path / "m22.png"
    m.write_bytes(b"")
    msk.views = {22: type(scene.views[22])(22, type(
        scene.views[22].getImage())(str(m), 640, 480))}
    return alb, msk


@pytest.mark.parametrize("case", ["contract", "non_pinhole", "mask_folder",
                                  "albedo_and_mask_sfm"])
def test_pyav_loader_matches_jax(monkeypatch, tmp_path, case):
    scene = _scene(tmp_path)
    sfm = str(tmp_path / "normals.sfm")
    payloads, kw = {sfm: scene}, {}
    if case == "non_pinhole":
        scene.intrinsics = {0: _Intrinsic(pinhole=None, scale=(55, 56),
                                          offset=(5, 6))}
    elif case == "mask_folder":
        (tmp_path / "masks").mkdir()
        (tmp_path / "masks" / "11.png").write_bytes(b"")
        kw["mask_folder_path"] = str(tmp_path / "masks")
    elif case == "albedo_and_mask_sfm":
        alb, msk = _albedo_and_mask(tmp_path, scene)
        payloads.update({str(tmp_path / "a.sfm"): alb,
                         str(tmp_path / "m.sfm"): msk})
        for p in ("a.sfm", "m.sfm"):
            (tmp_path / p).write_bytes(b"")
        kw.update(albedo_sfm_path=str(tmp_path / "a.sfm"),
                  mask_sfm_path=str(tmp_path / "m.sfm"))
    _install_mock(monkeypatch, payloads)
    got = dataloaders.load_sfm_scene_pyav(sfm, **kw)
    want = jloaders.load_sfm_scene_pyav(sfm, **kw)
    _same_contract(got, want)
    if case == "mask_folder":
        assert got["views"][0]["mask_path"].endswith("11.png")
    if case == "albedo_and_mask_sfm":
        assert got["views"][0]["albedo_path"].endswith("a11.png")
        assert got["views"][1]["mask_path"].endswith("m22.png")


def test_load_data_takes_the_pyav_branch(monkeypatch, tmp_path):
    scene = _scene(tmp_path)
    scene.intrinsics = {0: _Intrinsic(pinhole=_PinholeCam(700, 700, 300,
                                                          200))}
    for ext in (".abc", ".sfm"):
        path = str(tmp_path / f"normals{ext}")
        open(path, "wb").close()
        _install_mock(monkeypatch, {path: scene})
        _same_contract(dataloaders.load_data(path),
                       jloaders.load_data(path))
    _install_mock(monkeypatch, {})
    with pytest.raises(RuntimeError, match="Failed to load SfMData"):
        dataloaders.load_sfm_scene_pyav(str(tmp_path / "missing.sfm"))


# ---------------------------------------------------------------------------
# the NeuS converter
# ---------------------------------------------------------------------------

def _neus_dir(root, n=3, W=20, H=16):
    rng = np.random.default_rng(6)
    os.makedirs(root / "image")
    os.makedirs(root / "mask")
    mats = {}
    K = np.array([[30.0, 0, W / 2, 0], [0, 31.0, H / 2, 0],
                  [0, 0, 1, 0], [0, 0, 0, 1]])
    for i in range(n):
        a = 2 * np.pi * i / n
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        w2c = np.eye(4)
        w2c[:3, :3] = R
        w2c[:3, 3] = [0.1, -0.2, 3.0]
        mats[f"world_mat_{i}"] = (K @ w2c).astype(np.float32)
        s = np.diag([1.7, 1.7, 1.7, 1.0])
        s[:3, 3] = [0.3, -0.1, 0.2]
        mats[f"scale_mat_{i}"] = s.astype(np.float32)
        png.write_png(root / "image" / f"{i:03d}.png",
                      rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        png.write_png(root / "mask" / f"{i:03d}.png",
                      (rng.random((H, W)) > 0.5).astype(np.uint8) * 255)
    np.savez(root / "cameras_sphere.npz", **mats)


def _jax_converter():
    spec = importlib.util.spec_from_file_location(
        "jax_data_format_from_neus",
        os.path.join(ROOT, "tools", "data_format_from_neus.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_neus_converter_matches_jax(tmp_path, capsys):
    _neus_dir(tmp_path / "neus")
    data_format_from_neus.main([str(tmp_path / "neus"),
                                str(tmp_path / "port")])
    _jax_converter().generate(str(tmp_path / "neus"), str(tmp_path / "jax"))
    assert "#images: 3" in capsys.readouterr().out
    got, want = (json.load(open(tmp_path / d / "transform.json"))
                 for d in ("port", "jax"))
    assert set(got) == set(want) and len(got["frames"]) == 3
    for k in ("w", "h", "aabb_scale", "scale", "offset", "from_na"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["n2w"], want["n2w"], atol=1e-6)
    for f, jf in zip(got["frames"], want["frames"]):
        for k in ("file_path", "normal_path", "albedo_path"):
            assert f[k] == jf[k]
        for k in ("transform_matrix", "intrinsic_matrix"):
            np.testing.assert_allclose(f[k], jf[k], atol=1e-6, rtol=1e-6)
        a, b = (png.read_png(tmp_path / d / f["file_path"])
                for d in ("port", "jax"))
        assert a.dtype == np.uint8 and a.shape == (16, 20, 4)
        np.testing.assert_array_equal(a, b)


def test_neus_converter_refuses_other_formats(tmp_path):
    """An EXR image (whose 8-bit colour read no test can observe) and a
    format that cv2 reads and the port does not yet (GIF) raise by name."""
    from rnb_neus2_torch.io import image_io
    _neus_dir(tmp_path / "neus", n=1)
    img = tmp_path / "neus" / "image" / "000.png"
    os.remove(img)
    image_io.save_exr(np.zeros((16, 20, 3), np.float32),
                      img.with_suffix(".exr"))
    with pytest.raises(ValueError, match="EXR read as 8-bit colour"):
        data_format_from_neus.generate(str(tmp_path / "neus"),
                                       str(tmp_path / "out"))
    img.with_suffix(".exr").write_bytes(b"GIF89a" + bytes(20))
    with pytest.raises(ValueError, match="GIF image is not supported"):
        data_format_from_neus.generate(str(tmp_path / "neus"),
                                       str(tmp_path / "out"))


# ---------------------------------------------------------------------------
# the Meshroom node
# ---------------------------------------------------------------------------

def _port_node():
    path = os.path.join(ROOT, "rnb_neus2_torch", "meshroom",
                        "RNbNeuS2Torch.py")
    spec = importlib.util.spec_from_file_location("rnb_torch_node", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.RNbNeuS2Torch


def _surface(cls):
    return ([(p.name, p.value, getattr(p, "values", None),
              getattr(p, "range", None)) for p in cls.inputs],
            [(p.name, p.value) for p in cls.outputs],
            cls.category, cls.gpu, cls.size.name)


def test_meshroom_node_surface_matches_jax(node_cls):  # noqa: F811
    assert _surface(_port_node()) == _surface(node_cls)


def test_meshroom_node_calls_the_ports_pipeline(node_cls,  # noqa: F811
                                                monkeypatch, tmp_path):
    import rnb_neus2_tpu.cli.pipeline as jpipeline
    import rnb_neus2_torch.cli.pipeline as pipeline

    calls = {}
    monkeypatch.setattr(jpipeline, "run_full_pipeline",
                        lambda **kw: calls.__setitem__("jax", kw))
    monkeypatch.setattr(pipeline, "run_full_pipeline",
                        lambda **kw: calls.__setitem__("port", kw))

    class Attr:
        def __init__(self, v):
            self.value = v

    log = types.SimpleNamespace(start=lambda lvl: None, end=lambda: None)
    values = dict(inputNormalSfm="/d/n.sfm", inputAlbedoSfm="/d/a.sfm",
                  inputMaskSfm="", inputMaskFolder="/d/masks",
                  maxSteps=12345, meshResolution=512,
                  scalingMode="silhouettes_v2", sphereScale=1.1,
                  warmupRatio=0.2, maskWeight=0.7, superNormal=True,
                  useL1=True, useRgbPlus=False, useTpu=True,
                  verboseLevel="info", outputFolder=str(tmp_path))
    node = types.SimpleNamespace(**{k: Attr(v) for k, v in values.items()})
    for cls in (node_cls, _port_node()):
        cls().processChunk(types.SimpleNamespace(node=node, logManager=log,
                                                 logger=None))
    assert calls["port"] == calls["jax"]
    assert calls["port"]["max_steps"] == 12345


# ---------------------------------------------------------------------------
# mesh_from_snapshot, the four public names, the primitive probes
# ---------------------------------------------------------------------------

def _jax_mesh_from_snapshot():
    spec = importlib.util.spec_from_file_location(
        "jax_mesh_from_snapshot",
        os.path.join(ROOT, "tools", "mesh_from_snapshot.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def snapshot_scene(tmp_path_factory):
    """A prepared scene and a step-0 snapshot of the default config (the
    geometric initialisation's sphere), which both packages load."""
    from rnb_neus2_torch.config import TestbedConfig
    from rnb_neus2_torch.io.dataset import load_transform_json
    from rnb_neus2_torch.train import snapshot as snap
    from rnb_neus2_torch.train.trainer import Trainer

    root = tmp_path_factory.mktemp("snap")
    scene = root / "scene"
    synthetic.write_prepared_scene(str(scene), n_views=4, width=24,
                                   height=24)
    torch.manual_seed(0)
    trainer = Trainer(load_transform_json(str(scene), "cpu"),
                      TestbedConfig(), device="cpu")
    path = str(root / "snapshot_0.msgpack")
    snap.save_snapshot(path, trainer)
    return scene, path


def test_mesh_from_snapshot_matches_jax(snapshot_scene, tmp_path,
                                        monkeypatch, capsys):
    from rnb_neus2_torch.tools import mesh_from_snapshot

    scene, path = snapshot_scene
    results = {}
    for name in ("port", "jax"):
        s = tmp_path / name
        shutil.copytree(scene, s)
        argv = ["--scene", str(s), "--snapshot", path, "--resolution",
                "64", "--gt-resolution", "64"]
        if name == "port":
            assert mesh_from_snapshot.main(argv + ["--device", "cpu"]) == 0
        else:
            monkeypatch.setattr("sys.argv", ["mesh_from_snapshot"] + argv)
            _jax_mesh_from_snapshot().main()
        with open(s / "output" / "chamfer_from_snapshot.json") as f:
            results[name] = json.load(f)
    got, want = results["port"], results["jax"]
    assert got["iter"] == want["iter"] == 0
    assert got["resolution"] == want["resolution"] == 64
    assert got["mesh_vertices"] == want["mesh_vertices"] > 0
    for k in want:
        if k.startswith("chamfer") or k in ("accuracy", "completeness"):
            assert abs(got[k] - want[k]) <= 1e-5, k
    assert json.dumps(got) in capsys.readouterr().out


def test_stage_timer_and_level_stats_match_jax():
    from rnb_neus2_tpu.utils import diagnostics as jdiag
    from rnb_neus2_tpu.utils import meters as jmeters
    from rnb_neus2_torch.utils import diagnostics, meters

    timers = (meters.StageTimer(), jmeters.StageTimer())
    for name, ms in (("prep", 3.0), ("step", 10.0), ("prep", 5.0),
                     ("step", 7.5), ("mesh", 100.0)):
        for t in timers:
            t.observe(name, ms)
    assert timers[0].summary() == timers[1].summary()
    fields = dict(level=2, resolution=64, n_params=1000, hashed=True,
                  mean=0.0, std=1.0, min=-1.0, max=1.0, frac_zero=0.5)
    assert diagnostics.LevelStats(**fields).fraction_of_table == \
        jdiag.LevelStats(**fields).fraction_of_table == 0.0


def test_encode_batched_matches_jax():
    import jax.numpy as jnp
    from rnb_neus2_tpu.ops import hash_encoding as jhash
    from rnb_neus2_torch.ops import hash_encoding

    from rnb_neus2_tpu.config import HashGridConfig as JHashGridConfig
    from rnb_neus2_torch.config import HashGridConfig

    cfg = dict(n_levels=6, top_resolution=128, log2_hashmap_size=14)
    jstatic = jhash.HashGridStatic(JHashGridConfig(**cfg))
    static = hash_encoding.HashGridStatic(HashGridConfig(**cfg))
    rng = np.random.default_rng(5)
    table = rng.normal(0, 1e-2, (jstatic.n_entries, 2)).astype(np.float32)
    pos = rng.random((300, 3)).astype(np.float32)
    want = np.asarray(jhash.encode_batched(jnp.asarray(table),
                                           jnp.asarray(pos), jstatic,
                                           batch=128))
    got = hash_encoding.encode_batched(torch.from_numpy(table),
                                       torch.from_numpy(pos), static,
                                       batch=128)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
    whole = hash_encoding.encode(torch.from_numpy(table),
                                 torch.from_numpy(pos), static)
    np.testing.assert_array_equal(got.detach().numpy(),
                                  whole.detach().numpy())


def test_trainer_train_logs_as_jax():
    """`Trainer.train(n, log_every, logger)`: n steps, JAX's log line at
    every multiple of log_every (the meters' values, the step_ms EMA),
    and the trainer returned."""
    from rnb_neus2_torch.testing.synthetic import sphere_dataset
    from rnb_neus2_torch.train.trainer import Trainer
    from rnb_neus2_torch.utils.meters import Logger
    from test_torch_train import _small_cfg

    trainer = Trainer(sphere_dataset(n_views=4, width=16, height=16,
                                     radius=0.2), _small_cfg(),
                      device="cpu")
    lines = []

    class Log(Logger):
        def info(self, msg):
            lines.append(msg)
    # record each step's output and meters, to replay them through the
    # JAX package's own `Trainer.train`
    record, step = [], trainer.train_step

    def recorded():
        out = step()
        record.append((out, trainer.step, trainer.loss_ema.value,
                       trainer.ek_ema.value, trainer.mask_ema.value,
                       trainer.step_ms.value))
        return out
    trainer.train_step = recorded
    assert trainer.train(4, log_every=2, logger=Log()) is trainer
    assert trainer.step == 4 and len(lines) == 2
    assert trainer.step_ms.updates == 4 and trainer.step_ms.value > 0

    from rnb_neus2_tpu.train.trainer import Trainer as JTrainer
    from rnb_neus2_tpu.utils.meters import Ema
    fake = types.SimpleNamespace(step=0, loss_ema=Ema(), ek_ema=Ema(),
                                 mask_ema=Ema(), step_ms=Ema())
    replay = iter(record)

    def replay_step():
        out, fake.step, *vals = next(replay)
        for ema, v in zip((fake.loss_ema, fake.ek_ema, fake.mask_ema,
                           fake.step_ms), vals):
            ema.value = v
        return out
    fake.train_step = replay_step
    jlines = []
    JTrainer.train(fake, 4, log_every=2,
                   logger=types.SimpleNamespace(info=jlines.append))
    assert lines == jlines


@pytest.mark.parametrize("section", ["scatter", "gather", "sort", "misc",
                                     "sharded", "slice_gather", "bigtable"])
def test_bench_primitives_sections_run_small_on_cpu(section):
    from rnb_neus2_torch.tools import bench_primitives

    rows = bench_primitives.run([section], "cpu", sizes={
        "n_el": 1 << 12, "s_big": 1 << 10, "s_huge": 1 << 13})
    assert rows and all(r["section"] == section and r["ms"] is None
                        for r in rows)
    assert all(r["source"].startswith("tools/profiling/_bench_primitives")
               for r in rows)
