"""Snapshots of the PyTorch port against the JAX package's, both ways.

A small config trains a few steps in one package, saves, and the other
package restores the file: every parameter, Adam moment, debias step and
count, EMA parameter, the float16 density grid with its bitfield and
refresh count, the step, the ray count and the guard's meters equal the
writer's. Port to port, the generator comes back bit for bit too. The
guard's degraded and eikonal state round-trips as in
tests/test_divergence_guard.py. The port's bytes equal what flax writes
for the same payload.
"""

import dataclasses
import math

import numpy as np
import pytest
import jax
import torch
from flax import serialization

from rnb_neus2_tpu import config as jconfig
from rnb_neus2_tpu.testing.synthetic import sphere_dataset as jsphere
from rnb_neus2_tpu.train import snapshot as jsnap
from rnb_neus2_tpu.train.trainer import Trainer as JTrainer
from rnb_neus2_torch import config, interop
from rnb_neus2_torch.testing.synthetic import sphere_dataset
from rnb_neus2_torch.train import snapshot as snap
from rnb_neus2_torch.train.trainer import Trainer


def _cfg(pkg):
    return pkg.TestbedConfig(
        grid=pkg.HashGridConfig(n_levels=2, top_resolution=32),
        train=pkg.TrainConfig(target_batch_size=1 << 10,
                              initial_rays_per_batch=64, occ_grid_size=16,
                              seed=0),
        march=pkg.MarchConfig(n_ladder=64))


def _jtrainer():
    return JTrainer(jsphere(n_views=2, width=16, height=16, radius=0.2),
                    _cfg(jconfig))


def _jfilled():
    """A JAX trainer whose every saved field holds seeded random values
    (no training step: that would compile the step)."""
    import jax.numpy as jnp
    tr = _jtrainer()
    rng = np.random.default_rng(11)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.int32 and x.ndim == 0:
            return jnp.int32(7)
        if x.dtype == np.int32:
            return jnp.asarray(rng.integers(0, 7, x.shape, dtype=np.int32))
        return jnp.asarray(rng.standard_normal(x.shape).astype(x.dtype))
    tr.params = jax.tree_util.tree_map(fill, tr.params)
    tr.opt_state = jax.tree_util.tree_map(fill, tr.opt_state)
    tr.occ = tr.occ._replace(
        density=jnp.asarray(rng.uniform(-0.1, 0.3, tr.occ.density.shape)
                            .astype(np.float32)), ema_step=jnp.int32(5))
    tr.step, tr.n_rays = 7, 300
    tr.loss_ema.set(0.0125, updates=9)
    tr.ek_ema.set(0.004, updates=6)
    tr._guard_ek_floor, tr._guard_ema_floor = 0.003, 0.011
    return tr


def _trainer(steps=0):
    tr = Trainer(sphere_dataset(n_views=2, width=16, height=16, radius=0.2),
                 _cfg(config), device="cpu")
    for _ in range(steps):
        tr.train_step()
    return tr


@torch.no_grad()
def _filled():
    """A port trainer whose every saved field holds seeded random
    values."""
    tr = _trainer()
    g = torch.Generator()
    g.manual_seed(12)
    for name in ("mu", "nu", "ema"):
        d = getattr(tr.opt, name)
        for k in d:
            d[k] = torch.randn(d[k].shape, generator=g)
    for k in tr.opt.steps:
        tr.opt.steps[k] = torch.randint(0, 7, tr.opt.steps[k].shape,
                                        generator=g, dtype=torch.int32)
    for p in tr.params.values():
        p.copy_(torch.randn(p.shape, generator=g))
    tr.opt.count = 7
    tr.occ = tr.occ._replace(
        density=torch.rand(tr.occ.density.shape, generator=g) * 0.4 - 0.1,
        ema_step=5)
    tr.step, tr.n_rays = 7, 300
    tr.loss_ema.set(0.0125, updates=9)
    tr.ek_ema.set(0.004, updates=6)
    tr._guard_ek_floor, tr._guard_ema_floor = 0.003, 0.011
    return tr


def _port_state(tr) -> dict:
    """Everything a snapshot carries, as numpy, in the JAX layouts."""
    chain, ema = interop.opt_state_to_jax(tr.opt)
    return {"params": interop.state_dict(interop.params_to_jax(tr.params)),
            "ema_params": interop.state_dict(ema), "adam_state": chain,
            "density": tr.occ.density.numpy(),
            "bitfield": tr.occ.bitfield.numpy(),
            "ema_step": int(tr.occ.ema_step), "step": tr.step,
            "n_rays": tr.n_rays}


def _jax_state(tr) -> dict:
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"params": serialization.to_state_dict(np_(tr.params)),
            "ema_params": serialization.to_state_dict(
                np_(tr.opt_state.ema_params)),
            "adam_state": serialization.to_state_dict(
                np_(tr.opt_state.adam)),
            "density": np.asarray(tr.occ.density),
            "bitfield": np.asarray(tr.occ.bitfield),
            "ema_step": int(tr.occ.ema_step), "step": tr.step,
            "n_rays": tr.n_rays}


def _assert_same(a, b, path="state"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path


def _meters(tr) -> tuple:
    return (tr.loss_ema.value, tr.loss_ema.updates, tr.ek_ema.value,
            tr.ek_ema.updates, tr._guard_ek_floor, tr._guard_ema_floor)


def test_jax_snapshot_restores_into_port(tmp_path):
    jtr = _jfilled()
    path = str(tmp_path / "jax.msgpack")
    jsnap.save_snapshot(path, jtr)
    tr = _trainer()
    snap.restore_trainer(tr, snap.load_snapshot(path))
    want = _jax_state(jtr)
    # the file holds the grid as float16: both packages restore that
    want["density"] = want["density"].astype(np.float16).astype(np.float32)
    jtr2 = _jtrainer()
    jsnap.restore_trainer(jtr2, jsnap.load_snapshot(path))
    want["bitfield"] = np.asarray(jtr2.occ.bitfield)
    _assert_same(_port_state(tr), want)
    np.testing.assert_allclose(float(tr.occ.mean_density),
                               float(jtr2.occ.mean_density), rtol=1e-6)
    assert _meters(tr) == pytest.approx(_meters(jtr2), nan_ok=True)
    assert tr._good is not None and tr._good["step"] == 7
    # no generator state in a JAX file: seeded from the two key words
    k0, k1 = (int(w) for w in np.asarray(jtr.key, np.uint32))
    g = torch.Generator()
    g.manual_seed((k0 << 32) | k1)
    assert torch.equal(tr.generator.get_state(), g.get_state())
    assert np.isfinite(tr.train_step()["loss_total"])


def test_port_snapshot_restores_into_jax(tmp_path):
    tr = _filled()
    path = str(tmp_path / "port.msgpack")
    snap.save_snapshot(path, tr)
    data = jsnap.load_snapshot(path)
    assert np.asarray(data["rng_key"]).dtype == np.uint32
    assert np.asarray(data["rng_key"]).shape == (2,)
    assert np.asarray(data["density_grid"]).dtype == np.float16
    jtr = _jtrainer()
    jsnap.restore_trainer(jtr, data)
    want = _port_state(tr)
    want["density"] = want["density"].astype(np.float16).astype(np.float32)
    got = _jax_state(jtr)
    want["bitfield"] = got["bitfield"]
    _assert_same(got, want)
    tr2 = _trainer()
    snap.restore_trainer(tr2, snap.load_snapshot(path))
    np.testing.assert_array_equal(tr2.occ.bitfield.numpy(), got["bitfield"])
    assert _meters(jtr) == pytest.approx(_meters(tr), nan_ok=True)
    assert jtr._good is not None


def test_port_snapshot_round_trips_bit_for_bit(tmp_path):
    tr = _trainer(steps=4)
    path = str(tmp_path / "port.msgpack")
    size = snap.save_snapshot(path, tr)
    with open(path, "rb") as f:
        blob = f.read()
    assert size == len(blob)
    # the same bytes as flax writes for the same payload
    payload = snap._materialize(snap.snapshot_payload(tr))
    assert serialization.msgpack_serialize(payload) == blob
    tr2 = _trainer()
    snap.restore_trainer(tr2, snap.load_snapshot(path))
    want = _port_state(tr)
    want["density"] = want["density"].astype(np.float16).astype(np.float32)
    got = _port_state(tr2)
    want["bitfield"] = got["bitfield"]
    _assert_same(got, want)
    assert torch.equal(tr2.generator.get_state(), tr.generator.get_state())
    # the meters are stored as float32, as the JAX package stores them
    assert _meters(tr2) == tuple(float(np.float32(v)) for v in _meters(tr))
    assert tr2.opt.count == tr.opt.count == 4
    for k in tr.params:
        assert tr2.opt.steps[k].dtype == torch.int32
    # the restored density is the rounded grid, and the bitfield follows
    # it against min(0.1, mean)
    d = tr2.occ.density
    assert torch.equal(tr2.occ.bitfield,
                       d > min(0.1, float(d.clamp_min(0).mean())))


def _feed(tr, loss, adv=1, ek=1e-4):
    tr.step += adv
    return tr._consume_metrics({"loss_color": loss, "loss_ek": ek,
                                "loss_mask": 0.1, "loss_total": loss,
                                "n_valid_total": 512.0,
                                "rays_per_batch": 64})


def test_snapshot_round_trips_degraded_state(tmp_path):
    """tests/test_divergence_guard.py::test_snapshot_roundtrips_degraded_state
    for the port, and across packages."""
    tr = _trainer()
    for _ in range(3):
        _feed(tr, 0.05)
    for _ in range(tr.cfg.train.guard_max_trips + 1):
        _feed(tr, 1e6)
    assert not tr.cfg.flags.apply_rgbplus
    ema_val, ema_updates = tr.loss_ema.value, tr.loss_ema.updates
    path = str(tmp_path / "degraded.msgpack")
    snap.save_snapshot(path, tr)
    for fresh, restore in ((_trainer(), snap), (_jtrainer(), jsnap)):
        assert fresh.cfg.flags.apply_rgbplus
        restore.restore_trainer(fresh, restore.load_snapshot(path))
        assert not fresh.cfg.flags.apply_rgbplus
        assert fresh._guard_degraded_at == tr.step
        assert fresh._guard_rearms_used == tr._guard_rearms_used
        assert fresh.loss_ema.value == pytest.approx(ema_val)
        assert fresh.loss_ema.updates == ema_updates
        assert fresh._good is not None
    # a user's --no-rgbplus run is not marked degraded
    tr = _trainer()
    _feed(tr, 0.05)
    tr.cfg = dataclasses.replace(tr.cfg, flags=dataclasses.replace(
        tr.cfg.flags, apply_rgbplus=False))
    path2 = str(tmp_path / "user_norgbplus.msgpack")
    snap.save_snapshot(path2, tr)
    assert not bool(snap.load_snapshot(path2)["guard_degraded"])


def test_snapshot_round_trips_ek_state(tmp_path):
    """tests/test_divergence_guard.py::test_snapshot_roundtrips_ek_state
    for the port, and across packages."""
    tr = _trainer()
    for _ in range(4):
        _feed(tr, 0.05, adv=10, ek=0.006)
    path = str(tmp_path / "ekstate.msgpack")
    snap.save_snapshot(path, tr)
    for fresh, restore in ((_trainer(), snap), (_jtrainer(), jsnap)):
        restore.restore_trainer(fresh, restore.load_snapshot(path))
        assert fresh.ek_ema.value == pytest.approx(tr.ek_ema.value)
        assert fresh.ek_ema.updates == tr.ek_ema.updates
        assert fresh._guard_ek_floor == pytest.approx(tr._guard_ek_floor)
        assert fresh._guard_ema_floor == pytest.approx(tr._guard_ema_floor)
    # an uninitialized meter is written as NaN and comes back cold
    cold = _trainer()
    path = str(tmp_path / "cold.msgpack")
    snap.save_snapshot(path, cold)
    assert math.isnan(float(snap.load_snapshot(path)["loss_ema"]))
    fresh = _trainer()
    snap.restore_trainer(fresh, snap.load_snapshot(path))
    assert not fresh.loss_ema._initialized


def test_async_writer_rotates_generations(tmp_path):
    tr = _trainer(steps=1)
    latest = str(tmp_path / "snapshot_latest.msgpack")
    w = snap.AsyncSnapshotWriter()
    for _ in range(3):
        assert w.submit(latest, tr)
        w.join(60)
        assert not w.busy()
        tr.train_step()
    assert not (tmp_path / "snapshot_latest.msgpack.tmp").exists()
    steps = [int(snap.load_snapshot(p)["step"])
             for p in (latest, latest + ".prev")]
    assert steps == [3, 2]


def test_restore_refuses_another_config(tmp_path):
    path = str(tmp_path / "s.msgpack")
    snap.save_snapshot(path, _trainer())
    other = Trainer(sphere_dataset(n_views=2, width=16, height=16,
                                   radius=0.2),
                    dataclasses.replace(_cfg(config), grid=config
                                        .HashGridConfig(n_levels=3,
                                                        top_resolution=32)),
                    device="cpu")
    with pytest.raises(ValueError, match="shape"):
        snap.restore_trainer(other, snap.load_snapshot(path))

