"""The port's Python `Testbed` API (`rnb_neus2_torch/api.py`) against the
JAX package's (`rnb_neus2_tpu/api.py`): the JAX package's own API tests
(`tests/test_api.py::test_api_surface`, `::test_set_camera_intrinsics`,
`tests/test_render_buffer_path.py::test_testbed_render_path_flythrough`)
run on the port's `Testbed` on the CPU; the intrinsics it sets equal the
JAX `Testbed`'s; a JAX `Testbed` restored from the port's snapshot
renders the same view (albedo and alpha within 1e-5, the JAX side op by
op as in `tests/test_torch_render.py`) and reports the same step, loss
and parameter count. The extra modes are in
`tests/test_torch_extra_modes.py`.
"""

import numpy as np
import pytest
import jax
import torch

import rnb_neus2_tpu.api as jngp
import rnb_neus2_torch.api as ngp
from rnb_neus2_tpu import config as jconfig
from rnb_neus2_torch import config
from rnb_neus2_torch.cli import testbed
from rnb_neus2_torch.render.camera_path import CameraKeyframe, CameraPath
from rnb_neus2_torch.render.envmap import init_envmap
from rnb_neus2_torch.testing.synthetic import write_prepared_scene


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(pkg, max_steps, n_ladder=128, cone=1.0 / 256.0):
    return pkg.TestbedConfig(
        grid=pkg.HashGridConfig(n_levels=3, top_resolution=32),
        train=pkg.TrainConfig(target_batch_size=1 << 10,
                              initial_rays_per_batch=64, occ_grid_size=16,
                              max_steps=max_steps),
        march=pkg.MarchConfig(n_ladder=n_ladder, cone_angle=cone))


def test_api_surface(tmp_path):
    scene = tmp_path / "scene"
    write_prepared_scene(str(scene), n_views=4, width=16, height=16,
                         radius=0.2)
    cfg = _cfg(config, 6)
    tb = ngp.Testbed(ngp.TestbedMode.Nerf, cfg, device="cpu")
    tb.load_training_data(str(scene))
    tb.set_max_iter(6)
    steps = 0
    while tb.frame():
        steps += 1
    assert steps == 6 and tb.training_step == 6
    assert tb.n_params() > 1000
    assert np.isfinite(tb.loss) and np.isfinite(tb.ek_loss) \
        and np.isfinite(tb.mask_loss)

    img = tb.render_to_cpu(0, max_samples=32)
    assert img.shape == (16, 16, 4) and np.isfinite(img).all()
    tb.screenshot(tmp_path / "shot.png")
    assert (tmp_path / "shot.png").exists()

    snap = tmp_path / "s.msgpack"
    tb.save_snapshot(str(snap))
    tb2 = ngp.Testbed(ngp.TestbedMode.Nerf, cfg, device="cpu")
    tb2.load_training_data(str(scene))
    tb2.load_snapshot(str(snap))
    assert tb2.training_step == 6
    assert all(torch.equal(p, tb2._trainer.params[k])
               for k, p in tb._trainer.params.items())

    gt = lambda p: np.linalg.norm(p - 0.5, axis=-1) - 0.2
    iou = tb.calculate_iou(n_samples=4096, gt_sdf=gt)
    assert 0.0 <= iou <= 1.0
    assert tb.calculate_iou(n_samples=4096, gt_sdf=gt) == iou   # seeded
    with pytest.raises(ValueError, match="gt_sdf"):
        tb.calculate_iou(n_samples=16)

    m = tb.compute_marching_cubes_mesh((48, 48, 48))
    assert set(m.keys()) == {"V", "N", "C", "F"}
    tb.save_mesh(str(tmp_path / "m.obj"), (48, 48, 48))
    assert (tmp_path / "m.obj").exists()
    tb.train(2)
    assert tb.training_step == 8
    assert not tb.frame()       # max_iter reached
    # a fresh trainer of the same network, or of a network JSON's
    tb.reload_network_from_file()
    assert tb.training_step == 0 and tb.cfg is cfg
    net = tmp_path / "net.json"
    net.write_text(open(testbed.default_network_config()).read())
    tb.reload_network_from_file(str(net))
    assert tb.cfg == config.TestbedConfig.from_network_json(str(net))
    assert tb.training_step == 0 and tb.cfg.grid.n_levels == 14


def test_set_camera_intrinsics(tmp_path):
    """pyngp's set_camera_intrinsics argument conventions
    (testbed_nerf.cu:2915-2930), and the cameras equal the JAX
    `Testbed`'s after the same calls."""
    scene = tmp_path / "scene"
    write_prepared_scene(str(scene), n_views=3, width=16, height=16,
                         radius=0.2)
    tb = ngp.Testbed(ngp.TestbedMode.Nerf, _cfg(config, 2),
                     device="cpu")
    tb.load_training_data(str(scene))
    jtb = jngp.Testbed(jngp.TestbedMode.Nerf, _cfg(jconfig, 2))
    jtb.load_training_data(str(scene))
    for t in (tb, jtb):
        # fx<=0 falls back to fy; negative cx/cy means already-normalized
        t.set_camera_intrinsics(1, fx=0.0, fy=20.0, cx=-0.25, cy=8.0,
                                k1=-0.1, k2=0.01)
        # an index outside the views changes nothing, as in the reference
        t.set_camera_intrinsics(99, fx=1.0, fy=1.0)
    cams, jcams = tb._dataset.cameras, jtb._dataset.cameras
    np.testing.assert_allclose(cams.focal[1].numpy(), [20.0, 20.0])
    np.testing.assert_allclose(cams.principal[1].numpy(), [0.25, 0.5])
    assert cams.distortion is not None
    np.testing.assert_allclose(cams.distortion[1].numpy(),
                               [-0.1, 0.01, 0.0, 0.0], atol=1e-7)
    assert np.all(cams.distortion[0].numpy() == 0)
    for name in ("focal", "principal", "distortion"):
        assert np.array_equal(getattr(cams, name).numpy(),
                              np.asarray(getattr(jcams, name))), name
    assert tb._trainer.dataset.cameras is cams
    # training still runs with the distorted camera in the batch
    tb.train(2)
    assert np.isfinite(tb.loss)


def test_testbed_render_path_flythrough(tmp_path):
    """Testbed.render_path: fly a 2-keyframe path; the frames are
    well-formed RGBA and differ between the endpoints."""
    scene = tmp_path / "scene"
    write_prepared_scene(str(scene), n_views=4, width=16, height=16,
                         radius=0.25)
    tb = ngp.Testbed(ngp.TestbedMode.Nerf,
                     _cfg(config, 4, n_ladder=64), device="cpu")
    tb.load_training_data(str(scene))
    while tb.frame():
        pass
    # a direction-dependent background, so that frames vary with the
    # camera before the field has learned a surface
    em = init_envmap(8, 16, 0.0)
    em[:, :8, 0] = 1.0
    em[:, 8:, 1] = 1.0
    tb.envmap = em
    rot = tb._dataset.cameras.rot_c2w.numpy()
    org = tb._dataset.cameras.origin.numpy()
    kfs = [CameraKeyframe.from_matrix(
        np.concatenate([rot[i], org[i][:, None]], axis=1)) for i in (0, 2)]
    frames = tb.render_path(CameraPath(kfs), n_frames=3, max_samples=32)
    assert len(frames) == 3
    for f in frames:
        assert f.shape == (16, 16, 4)
        assert np.isfinite(f).all()
    assert np.abs(frames[0] - frames[-1]).max() > 1e-3


def test_jax_testbed_on_the_ports_snapshot(tmp_path):
    scene = tmp_path / "scene"
    write_prepared_scene(str(scene), n_views=4, width=16, height=16,
                         radius=0.2)
    tb = ngp.Testbed(ngp.TestbedMode.Nerf,
                     _cfg(config, 3, n_ladder=256, cone=0.0),
                     device="cpu")
    tb.load_training_data(str(scene))
    tb.train(3)
    tb.save_snapshot(str(tmp_path / "s.msgpack"))
    jtb = jngp.Testbed(jngp.TestbedMode.Nerf,
                       _cfg(jconfig, 3, n_ladder=256, cone=0.0))
    jtb.load_training_data(str(scene))
    jtb.load_snapshot(str(tmp_path / "s.msgpack"))
    assert jtb.training_step == tb.training_step == 3
    assert jtb.n_params() == tb.n_params()
    assert jtb.loss == pytest.approx(tb.loss, rel=1e-6)
    got = tb.render_to_cpu(1, max_samples=32)
    with jax.disable_jit():
        want = jtb.render_to_cpu(1, max_samples=32)
    assert got.shape == want.shape == (16, 16, 4)
    assert np.abs(got - np.asarray(want)).max() <= 1e-5
