"""The port's pipeline modules against the JAX package's (and cv2's): the
IDR loader and `decompose_projection`, every scaling mode, the contour
points, `prepare_testbed_data` (transform.json and pixels), albedo
ratios and their scaled PNGs, `largest_component`, and a tiny two-stage
run on the CPU that writes snapshot_40, snapshot_60 and mesh_60."""

import json
import os
import shutil
import sys
from collections import Counter

import numpy as np
import pytest
import torch
from scipy import ndimage
from scipy.spatial.transform import Rotation

cv2 = pytest.importorskip("cv2")

from rnb_neus2_tpu.io import albedo_scaling as jalbedo
from rnb_neus2_tpu.io import dataloaders as jloaders
from rnb_neus2_tpu.io import prepare as jprepare
from rnb_neus2_tpu.io import scaling as jscaling
from rnb_neus2_tpu.mesh import postprocess as jpost
from rnb_neus2_torch.cli import pipeline
from rnb_neus2_torch.cli.testbed import default_network_config
from rnb_neus2_torch.io import (albedo_scaling, dataloaders, image_io, png,
                                prepare, scaling)
from rnb_neus2_torch.mesh import postprocess, writer
from rnb_neus2_torch.mesh.marching import marching_cubes_grid
from rnb_neus2_torch.testing.synthetic import write_idr_scene

WORLD_CENTER = np.array([0.2, -0.1, 0.3])


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the test workers share the host's cores, and
    at these sizes more threads only wait on each other (a tiny run took
    7x longer with 8 threads on a busy host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def idr(tmp_path_factory):
    root = tmp_path_factory.mktemp("idr")
    radius = write_idr_scene(str(root / "in"), n_views=6, width=40,
                             height=32, radius=0.2)
    return str(root / "in"), radius


def _cv2_rgb(path):
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3 and img.shape[2] >= 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def test_decompose_projection_matches_cv2():
    rng = np.random.default_rng(0)
    for i in range(64):
        K = np.array([[rng.uniform(300, 900), rng.uniform(-2, 2),
                       rng.uniform(100, 400)],
                      [0, rng.uniform(300, 900), rng.uniform(100, 400)],
                      [0, 0, 1]])
        R = Rotation.random(random_state=i).as_matrix()
        c = rng.normal(size=3) * 3
        P = K @ np.hstack([R, -R @ c[:, None]])
        mode = i % 4
        if mode == 1:       # negative scale
            P = -P * rng.uniform(0.1, 5)
        elif mode == 2:     # mirrored image
            P = np.diag([-1, 1, 1]) @ P
        elif mode == 3:     # mirrored world
            P = P @ np.diag([1, -1, 1, 1])
        P = P.astype(np.float32)
        (K1, c2w1), (K0, c2w0) = (dataloaders.decompose_projection(P),
                                  jloaders.decompose_projection(P))
        assert K1.dtype == K0.dtype and c2w1.dtype == c2w0.dtype
        np.testing.assert_allclose(K1, K0, rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(c2w1, c2w0, rtol=1e-6, atol=1e-6)


def test_idr_loader_matches_jax(idr):
    data, jdata = dataloaders.load_data(idr[0]), jloaders.load_data(idr[0])
    assert (data["image_width"], data["image_height"]) == \
        (jdata["image_width"], jdata["image_height"])
    np.testing.assert_array_equal(data["scale_mat"], jdata["scale_mat"])
    for v, jv in zip(data["views"], jdata["views"]):
        np.testing.assert_allclose(v["c2w"], jv["c2w"], atol=1e-6)
        np.testing.assert_allclose(v["K"], jv["K"], rtol=1e-6)
        for k in ("normal_path", "albedo_path", "mask_path", "pose_id"):
            assert v[k] == jv[k]


def test_load_data_refuses_the_pyalicevision_inputs(tmp_path, monkeypatch):
    """Where the pyalicevision bindings do not import, a `.abc` file and a
    `.sfm` that is not JSON are refused with the JAX package's errors (the
    loader through the bindings: tests/test_torch_ported_modules.py)."""
    monkeypatch.setitem(sys.modules, "pyalicevision", None)
    for name, blob in (("scene.abc", b"\x00\x01"),
                       ("scene.sfm", b"\x89binary")):
        (tmp_path / name).write_bytes(blob)
        with pytest.raises(ValueError) as got:
            dataloaders.load_data(str(tmp_path / name))
        with pytest.raises(ValueError) as want:
            jloaders.load_data(str(tmp_path / name))
        assert type(got.value) is type(want.value)
        assert str(got.value) == str(want.value)


def test_contour_points_equal_cv2():
    rng = np.random.default_rng(0)
    for i in range(60):
        h, w = rng.integers(5, 40, 2)
        m = rng.random((h, w)) < rng.uniform(0.2, 0.7)
        if i % 3 == 0:
            m = ndimage.binary_opening(m)
        if i % 7 == 0:      # a ring with a component in its hole
            m = np.zeros((h, w), bool)
            m[1:-1, 1:-1] = True
            m[3:-3, 3:-3] = False
            m[h // 2, w // 2] = True
        cs, _ = cv2.findContours(m.astype(np.uint8) * 255,
                                 cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)
        want = Counter(map(tuple, np.vstack(cs).reshape(-1, 2).tolist())) \
            if cs else Counter()
        got = Counter(map(tuple, scaling.outer_border_points(m)
                          .astype(int).tolist()))
        assert got == want, i


def _data_with_landmarks(idr):
    data = dataloaders.load_data(idr[0])
    data["landmarks"] = WORLD_CENTER + np.random.default_rng(3).normal(
        size=(50, 3)) * 0.2
    return data


@pytest.mark.parametrize("mode", ["auto", "silhouettes", "silhouettes_v2",
                                  "pcd", "cameras", "none"])
def test_scaling_modes_match_jax(idr, mode):
    data = _data_with_landmarks(idr)
    c1, s1, m1 = prepare.compute_scaling(data, mode, margin_px=4)
    c0, s0, m0 = jprepare.compute_scaling(data, mode, margin_px=4)
    np.testing.assert_allclose(c1, c0, rtol=1e-12, atol=1e-12)
    assert s1 == pytest.approx(s0, rel=1e-12)
    np.testing.assert_allclose(m1, m0, rtol=1e-12, atol=1e-12)
    if mode in ("auto", "silhouettes_v2"):
        # the sphere's centre, up to the mask's pixels
        assert np.linalg.norm(np.asarray(c1) - WORLD_CENTER) < 0.05


def test_subsampled_contours_scale_as_jax():
    """Masks whose borders exceed max_pts: the points are subsampled
    around the exact hull, in another order than cv2's, and the enclosing
    sphere comes out the same."""
    rng = np.random.default_rng(4)
    cams, masks = [], []
    for i in range(3):
        ang = 2 * np.pi * i / 3
        eye = 4.0 * np.array([np.cos(ang), np.sin(ang), 0.3])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0, 0, -1.0])
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd], 1)
        cams.append({"fx": 600.0, "fy": 600.0, "cx": 450.0, "cy": 450.0,
                     "R_cam2world": R, "center": eye})
        yy, xx = np.mgrid[:900, :900]
        ang_px = np.arctan2(yy - 450, xx - 450)
        rad = 300 + 40 * np.sin(13 * ang_px + i) + rng.normal(0, 3, (900,
                                                                    900))
        masks.append((np.hypot(yy - 450, xx - 450) < rad)
                     .astype(np.float32))
    # enough points that pts[::step] takes every 2nd or 3rd
    assert len(scaling.outer_border_points(masks[0] > 0.5)) > 4200
    c1, s1 = scaling.silhouette_scaling_v2(cams, masks, margin_px=20)
    c0, s0 = jscaling.silhouette_scaling_v2(cams, masks, margin_px=20)
    np.testing.assert_allclose(c1, c0, rtol=1e-12, atol=1e-12)
    assert s1 == pytest.approx(s0, rel=1e-12)


@pytest.fixture(scope="module")
def prepared(idr, tmp_path_factory):
    """Both packages' prepare on the port loader's views (the loaders are
    held against each other above: their cameras differ by float
    rounding, which the Nelder-Mead fit of silhouettes_v2, stopping at
    xatol 1e-4, may carry into the 6th digit)."""
    root = tmp_path_factory.mktemp("prepared")
    data = dataloaders.load_data(idr[0])
    prepare.prepare_testbed_data(data, str(root / "port"))
    jprepare.prepare_testbed_data(data, str(root / "jax"))
    return str(root / "port"), str(root / "jax")


def test_prepare_matches_jax(prepared):
    port, jax_dir = prepared
    with open(f"{port}/transform.json") as f, \
            open(f"{jax_dir}/transform.json") as g:
        tj, jtj = json.load(f), json.load(g)
    assert len(tj["frames"]) == len(jtj["frames"]) == 6
    for k in ("w", "h", "aabb_scale", "scale", "offset", "from_na"):
        assert tj[k] == jtj[k]
    np.testing.assert_allclose(tj["n2w"], jtj["n2w"], rtol=1e-6, atol=1e-6)
    for fr, jfr in zip(tj["frames"], jtj["frames"]):
        assert fr["normal_path"] == jfr["normal_path"]
        for k in ("transform_matrix", "intrinsic_matrix"):
            np.testing.assert_allclose(fr[k], jfr[k], rtol=1e-6, atol=1e-6)
        for k in ("normal_path", "albedo_path"):
            np.testing.assert_array_equal(png.read_png(f"{port}/{fr[k]}"),
                                          _cv2_rgb(f"{jax_dir}/{jfr[k]}"))


def test_masks_at_each_bit_depth(idr, tmp_path):
    """An 8-bit normal with a 16-bit albedo gets an alpha at each image's
    own depth (the reference's regression test), as in the JAX package."""
    data = dataloaders.load_data(idr[0])
    v = dict(data["views"][0])
    nrm = png.read_png(v["normal_path"])
    v["normal_path"] = str(tmp_path / "n8.png")
    png.write_png(v["normal_path"], (nrm >> 8).astype(np.uint8))
    one = dict(data, views=[v, data["views"][1]])
    prepare.prepare_testbed_data(one, str(tmp_path / "port"),
                                 scaling_mode="cameras")
    jprepare.prepare_testbed_data(one, str(tmp_path / "jax"),
                                  scaling_mode="cameras")
    for sub, dtype in (("normals", np.uint8), ("albedos", np.uint16)):
        got = png.read_png(tmp_path / "port" / sub / "00000.png")
        assert got.dtype == dtype
        np.testing.assert_array_equal(
            got, _cv2_rgb(tmp_path / "jax" / sub / "00000.png"))


def _sphere_mesh(center, radius, res=48):
    lo = center - 1.3 * radius
    step = 2.6 * radius / (res - 1)
    g = lo + step * np.stack(np.meshgrid(*[np.arange(res)] * 3,
                                         indexing="ij"), -1)
    sdf = (np.linalg.norm(g - center, axis=-1) - radius).astype(np.float32)
    return marching_cubes_grid(sdf, tuple(lo), step)


def test_albedo_ratios_and_scaled_pngs_match_jax(idr, prepared, tmp_path):
    port = prepared[0]
    albedos = tmp_path / "albedos"
    albedos.mkdir()
    for i, name in enumerate(sorted(os.listdir(f"{port}/albedos"))):
        img = image_io.load_image(f"{port}/albedos/{name}")
        img[..., :3] *= 1.0 + 0.1 * i
        image_io.save_image(img, albedos / name, 16)
    V, F = _sphere_mesh(WORLD_CENTER, idr[1])
    mesh = tmp_path / "mesh.obj"
    writer.save_mesh(mesh, V, F)
    args = (str(albedos), f"{port}/transform.json", str(mesh))
    r1 = albedo_scaling.compute_albedo_scale_ratios(
        *args, n_samples=300, rng=np.random.default_rng(0))
    r0 = jalbedo.compute_albedo_scale_ratios(
        *args, n_samples=300, rng=np.random.default_rng(0))
    np.testing.assert_allclose(r1, r0, rtol=1e-12)
    assert np.isfinite(r1).all() and (r1 > 0).all()
    assert r1[0, 0] > r1[-1, 0]        # view 0 was made the darkest
    albedo_scaling.scale_and_save_albedos(str(albedos), str(tmp_path / "p"),
                                          r1)
    jalbedo.scale_and_save_albedos(str(albedos), str(tmp_path / "j"), r0)
    for name in sorted(os.listdir(albedos)):
        np.testing.assert_array_equal(png.read_png(tmp_path / "p" / name),
                                      _cv2_rgb(tmp_path / "j" / name))


def test_largest_component_matches_jax():
    parts, offset = [], 0
    rng = np.random.default_rng(5)
    Vs, Fs = [], []
    for k, r in enumerate((0.3, 0.5, 0.2)):
        V, F = _sphere_mesh(np.array([2.0 * k, 0.0, 0.0]), r, res=20)
        Vs.append(V)
        Fs.append(F + offset)
        offset += len(V)
    Vs.append(rng.normal(size=(5, 3)).astype(np.float32))   # loose verts
    V, F = np.concatenate(Vs), np.concatenate(Fs)
    perm = rng.permutation(len(V))
    inv = np.argsort(perm)
    V, F = V[perm], inv[F]
    N = rng.normal(size=V.shape).astype(np.float32)
    got = postprocess.largest_component(V, F, N)
    want = jpost.largest_component(V, F, N)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert len(got[0]) < len(V)


def test_tiny_two_stage_run(prepared, tmp_path):
    cfg = json.load(open(default_network_config()))
    cfg["encoding"].update(n_levels=4, top_resolution=64,
                           log2_hashmap_size=15)
    net = tmp_path / "small.json"
    net.write_text(json.dumps(cfg))
    scene = tmp_path / "scene"
    shutil.copytree(prepared[0], scene)
    common = ["--device", "cpu", "--network", str(net),
              "--target-batch-size", "8192", "--occ-grid-size", "32",
              "--n-ladder", "512"]
    pipeline.run_two_stage(str(scene), 60, common, resolution=48,
                           no_albedo=True)
    out = scene / "output"
    for name in ("snapshot_40.msgpack", "snapshot_60.msgpack",
                 "mesh_60.obj"):
        assert (out / name).exists(), name
    final = tmp_path / "mesh.obj"
    pipeline.postprocess_mesh(str(scene), str(final))
    V, F = writer.load_obj(final)
    assert len(V) > 0 and len(F) > 0
    assert not out.exists()
