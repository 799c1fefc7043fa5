"""Data-parallel training of the port (`parallel.ParallelTrainer`, two
replicas on the CPU) against the JAX package's `ParallelTrainer(n_chips=2)`
and against the port's own single-device `Trainer`.

- `training_loss` with the global divisors equals JAX's with the same
  divisors; without them it is the loss of R and S, bit for bit.
- The gradient identity: one batch cut into two halves; the two replicas'
  gradients with the global divisors sum to the whole batch's gradient
  within 1e-6 relative L2, and their losses to its loss.
- Three steps against JAX on JAX's own per-device draws (the occupancy
  jitter of its full sweep, then `jax.random.split(step_key, 2)`, each
  key split four ways by the sampler, injected as in
  tests/test_torch_trainer_parity.py), then a step at 256, where the
  parallel refresh is still a full sweep: loss and metrics within 1e-5
  relative, the bitfield equal, parameters, EMA and Adam moments within
  the parity test's tolerances. The replicas are identical after every
  step.
- Refusals (error-map sampling, fewer than 2 replicas), a guard rollback
  that restores both replicas, the snapshot cycle (ParallelTrainer → file
  → Trainer and ParallelTrainer), and the CLI's `--n-chips` dispatch with
  the device list monkeypatched to two devices and to one.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from flax import serialization

from rnb_neus2_tpu import config as jconfig
from rnb_neus2_tpu.grid import occupancy as joccupancy
from rnb_neus2_tpu.models.neus_field import NeusField as JNeusField
from rnb_neus2_tpu.parallel.trainer import ParallelTrainer as JParallel
from rnb_neus2_tpu.render import losses as jlosses
from rnb_neus2_tpu.testing.synthetic import sphere_dataset as jsphere
from rnb_neus2_torch import config, interop
from rnb_neus2_torch.cli import testbed
from rnb_neus2_torch.grid import occupancy
from rnb_neus2_torch.models.neus_field import NeusField
from rnb_neus2_torch.ops.ray_march import FlatSamples
from rnb_neus2_torch.parallel import ParallelTrainer, make_mesh
from rnb_neus2_torch.parallel import trainer as ptrainer
from rnb_neus2_torch.render import losses
from rnb_neus2_torch.testing.synthetic import sphere_dataset
from rnb_neus2_torch.train import snapshot as snap
from rnb_neus2_torch.train.sampler import RayUniforms, sample_ray_batch
from rnb_neus2_torch.train.trainer import Trainer
from test_torch_cli import _small, scene  # noqa: F401  (fixture)
from test_torch_loss import GRID, _port_inputs, shared  # noqa: F401
from test_torch_trainer_parity import _cfg, _close, _np_tree, _t

CPU2 = ["cpu", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ds(pkg_sphere):
    return pkg_sphere(n_views=4, width=32, height=32, radius=0.2)


# ---------------------------------------------------------------------------
# the loss's global divisors
# ---------------------------------------------------------------------------

def test_training_loss_divisors_match_jax(shared):
    """Divisors 3·R and 2·S (a replica of a larger batch): loss and
    metrics rtol 1e-5 against JAX; the defaults are R and S bit for bit."""
    field = NeusField(config.HashGridConfig(**GRID),
                      config.NetworkConfig(stoch_corner_bwd=0), "cpu")
    field.load_state_dict(interop.params_from_jax(shared["params"]))
    samples, batch, pos = _port_inputs(shared)
    R, S = batch.alive.shape[0], samples.t.shape[0]
    out = {k: v.detach() for k, v in field(pos).items()}
    flags, lcfg = config.RenderFlags(), config.LossConfig()
    loss, m = losses.training_loss(out, samples, batch, flags, lcfg, 1.0,
                                   n_rays_divisor=3 * R,
                                   ek_samples_divisor=2 * S)
    jout = JNeusField(shared["jgrid"], shared["jnet"]).apply(
        jax.tree_util.tree_map(jnp.asarray, shared["params"]),
        shared["pos"])
    jl, jm = jlosses.training_loss(jout, shared["samples"], shared["batch"],
                                   jconfig.RenderFlags(),
                                   jconfig.LossConfig(), 1.0,
                                   n_rays_divisor=3 * R,
                                   ek_samples_divisor=2 * S)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for k in ("loss_color", "loss_mask", "loss_ek", "n_samples_kept",
              "weight_sum_mean"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    plain, pm = losses.training_loss(out, samples, batch, flags, lcfg, 1.0)
    same, sm = losses.training_loss(out, samples, batch, flags, lcfg, 1.0,
                                    n_rays_divisor=R, ek_samples_divisor=S)
    assert torch.equal(plain, same)
    assert all(torch.equal(pm[k], sm[k]) for k in pm)
    assert float(loss) != float(plain)


# ---------------------------------------------------------------------------
# the gradient identity
# ---------------------------------------------------------------------------

def _concat(halves, R2, S2):
    """Two halves (RayBatch, FlatSamples, pos), each of R2 rays and S2
    slots → the whole batch of 2·R2 rays and 2·S2 slots."""
    (b0, s0, p0), (b1, s1, p1) = halves
    R = 2 * R2
    batch = type(b0)(*[None if a is None else torch.cat([a, b])
                       for a, b in zip(b0, b1)])
    rid = [torch.where(s.ray_id < R2, s.ray_id + off,
                       torch.full_like(s.ray_id, R))
           for s, off in ((s0, 0), (s1, R2))]
    samples = FlatSamples(
        t=torch.cat([s0.t, s1.t]), dt=torch.cat([s0.dt, s1.dt]),
        ray_id=torch.cat(rid), valid=torch.cat([s0.valid, s1.valid]),
        seg_start=torch.cat([s0.seg_start, s1.seg_start + S2]),
        n_valid=torch.cat([s0.n_valid, s1.n_valid]),
        ray_kept=torch.cat([s0.ray_kept, s1.ray_kept]))
    return batch, samples, torch.cat([p0, p1])


def _f64(t):
    """A tuple of tensors with its floating ones in float64."""
    return type(t)(*[x.double() if torch.is_tensor(x)
                     and x.is_floating_point() else x for x in t])


def test_replica_gradients_sum_to_the_single_device_gradient(monkeypatch):
    """In float64 (the kernel wrappers' plain versions take it once their
    float32 check is lifted), so that the identity is held and not the
    summation order: in float32 the two orders differ by up to 1.9e-5
    relative L2 on this batch, in the variance's gradient, one sum over
    every sample with cancellation."""
    from rnb_neus2_torch.kernels import (corner_backward, encode_jacobian,
                                         hash_grad_small, scatter_add)
    monkeypatch.setattr(scatter_add, "check_out", lambda *a: None)
    monkeypatch.setattr(hash_grad_small, "check_out", lambda *a: None)
    for mod in (encode_jacobian, corner_backward):
        monkeypatch.setattr(mod, "check_inputs", lambda *a: None)
        monkeypatch.setattr(mod, "check_out", lambda *a: None)
    cfg = _cfg(config)
    pt = ParallelTrainer(_ds(sphere_dataset), cfg, devices=CPU2)
    for _ in range(3):
        pt.train_step()
    for rep in pt.replicas:
        rep.field.double()
    R2, S2 = pt._bucket() // 2, cfg.train.target_batch_size // 2
    gen = torch.Generator().manual_seed(5)
    halves = [sample_ray_batch(pt.dataset, pt.occ.bitfield, R2, S2,
                               cfg.march, generator=gen)[:3]
              for _ in range(2)]
    halves = [(_f64(b), _f64(s), p.double()) for b, s, p in halves]
    queue = list(halves)
    monkeypatch.setattr(ptrainer, "sample_ray_batch",
                        lambda *a, **k: queue.pop(0) + (None,))
    grads, metrics = pt._grads(2 * R2, pt._level_bucket())
    assert not queue
    batch, samples, pos = _concat(halves, R2, S2)
    vl = ptrainer.valid_level_for_step(cfg.grid, pt.step)
    anneal = 1.0 if cfg.loss.anneal_end <= 0 else min(
        1.0, pt.step / cfg.loss.anneal_end)
    out = pt.field(pos, vl, pt._level_bucket())
    loss, m = losses.training_loss(out, samples, batch, cfg.flags, cfg.loss,
                                   anneal)
    want = torch.autograd.grad(loss, list(pt.params.values()),
                               allow_unused=True, materialize_grads=True)
    assert float(metrics["loss_total"]) == pytest.approx(float(loss),
                                                         rel=1e-6)
    assert int(metrics["n_samples_kept"]) == int(m["n_samples_kept"])
    for name, g, w in zip(pt.params, grads, want):
        assert g.dtype == torch.float64
        err = float((g - w).norm())
        assert err <= 1e-6 * float(w.norm()), (name, err)
    assert float(want[0].abs().max()) > 0


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def _jax_draws(jtr):
    """The numbers JAX's next ParallelTrainer.train_step draws: the jitter
    of its full sweep (or None) and one RayUniforms per device."""
    key, jitter = jtr.key, None
    if jtr.step % joccupancy.update_cadence(jtr.step) == 0:
        key, k = jax.random.split(key)
        jitter = _t(jax.random.uniform(k, (jtr.cfg.train.occ_grid_size ** 3,
                                           3)))
    key, k = jax.random.split(key)
    R = jtr._bucket() // jtr.n_dev
    unis = []
    for kd in jax.random.split(k, jtr.n_dev):
        k_xy, k_skip, k_light, k_start = jax.random.split(kd, 4)
        unis.append(RayUniforms(
            xy=_t(jax.random.uniform(k_xy, (R, 2))),
            skip=_t(jax.random.uniform(k_skip, (R,))),
            start=_t(jax.random.uniform(k_start, (R,))),
            light_idx=_t(jax.random.randint(k_light, (R,), 0, 3),
                         torch.int64)))
    return jitter, unis


def _replicas_identical(pt):
    for rep in pt.replicas[1:]:
        for k, p in rep.params.items():
            assert torch.equal(p, pt.params[k]), k


def _compare(jtr, pt, queue, n):
    for _ in range(n):
        jitter, unis = _jax_draws(jtr)
        queue["uniforms"] += unis
        if jitter is not None:
            queue["jitter"].append(jitter)
        jm, m = jtr.train_step(), pt.train_step()
        assert not queue["uniforms"] and not queue["jitter"]
        assert m["loss_total"] == pytest.approx(jm["loss_total"], rel=1e-5)
        for k in ("loss_color", "loss_mask", "loss_ek", "weight_sum_mean",
                  "n_samples_kept", "n_rays_alive", "n_valid_total",
                  "n_rays_kept", "inv_s"):
            assert m[k] == pytest.approx(jm[k], rel=1e-5), k
        assert (pt.step, pt.n_rays) == (jtr.step, jtr.n_rays)
        assert torch.equal(pt.occ.bitfield, _t(jtr.occ.bitfield))
        want_d = _t(jtr.occ.density)
        assert float((pt.occ.density - want_d).abs().max()) <= 1e-5 * (
            1.0 + float(want_d.abs().max()))
        _close(pt.params, interop.params_from_jax(_np_tree(jtr.params)),
               1e-4, "params")
        want = interop.opt_state_from_jax(
            serialization.to_state_dict(_np_tree(jtr.opt_state.adam)),
            _np_tree(jtr.opt_state.ema_params))
        _close(pt.opt.ema, want["ema"], 1e-4, "ema")
        for name in ("mu", "nu"):
            for k, w in want[name].items():
                err = float((getattr(pt.opt, name)[k] - w).abs().max())
                rel = 3e-3 if k == "variance" else 1e-3
                assert err <= rel * (float(w.abs().max()) + 1e-30), \
                    (name, k, err)
        for k, w in want["steps"].items():
            assert torch.equal(pt.opt.steps[k], w), ("steps", k)
        assert pt.opt.count == want["count"]
        _replicas_identical(pt)


def test_two_replicas_match_jax_parallel_trainer(monkeypatch):
    """Three steps from JAX's initial parameters (a full-sweep refresh
    before each), then both step counters at 256 and one more step, whose
    refresh is still the full sweep on the parallel path."""
    jtr = JParallel(_ds(jsphere), _cfg(jconfig), n_chips=2)
    assert jtr.n_dev == 2
    pt = ParallelTrainer(
        _ds(sphere_dataset), _cfg(config),
        params=interop.params_from_jax(_np_tree(jtr.params)),
        devices=CPU2)
    queue = {"jitter": [], "uniforms": []}
    real_sample, real_cells = ptrainer.sample_ray_batch, \
        occupancy.cell_positions
    monkeypatch.setattr(ptrainer, "sample_ray_batch",
                        lambda *a, **k: real_sample(
                            *a, **{**k, "uniforms": queue["uniforms"].pop(0)}))
    monkeypatch.setattr(occupancy, "cell_positions",
                        lambda g, gen=None, device="cpu": real_cells(
                            g, gen, device, jitter=queue["jitter"].pop()))
    _compare(jtr, pt, queue, 3)
    jtr.step = pt.step = 256
    before = pt.occ.ema_step
    _compare(jtr, pt, queue, 1)
    assert pt.occ.ema_step == before + 1
    assert 0 < int(pt.occ.bitfield.sum()) < pt.occ.bitfield.numel()


# ---------------------------------------------------------------------------
# refusals, guard, snapshots, CLI
# ---------------------------------------------------------------------------

def test_refusals():
    cfg = _cfg(config)
    ds = _ds(sphere_dataset)
    bad = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, sample_image_proportional_to_error=True))
    with pytest.raises(ValueError, match="error-map"):
        ParallelTrainer(ds, bad, devices=CPU2)
    with pytest.raises(ValueError, match=">= 2 devices"):
        ParallelTrainer(ds, cfg, devices=["cpu"])
    with pytest.raises(ValueError, match=">= 2 devices"):
        ParallelTrainer(ds, cfg, devices=CPU2, n_chips=1)
    assert make_mesh(["cpu"] * 3, n_chips=2) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            ParallelTrainer(ds, cfg)


def test_guard_rollback_restores_every_replica():
    pt = ParallelTrainer(_ds(sphere_dataset), _cfg(config), devices=CPU2)
    for _ in range(6):
        pt.train_step()
    assert pt._good is not None
    good = {k: v.clone() for k, v in pt._good["params"].items()}
    good_step = pt._good["step"]
    with torch.no_grad():
        for rep in pt.replicas:
            for p in rep.params.values():
                p.mul_(1e6)
    pt.step += 1
    scale = pt.lr_scale
    assert pt._guard_check(float("inf")) is False
    assert pt.step == good_step and pt.lr_scale < scale
    for rep in pt.replicas:
        for k, p in rep.params.items():
            assert torch.equal(p, good[k]), k
    for _ in range(3):
        out = pt.train_step()
    assert np.isfinite(out["loss_total"])
    _replicas_identical(pt)


def test_snapshot_cycle(tmp_path):
    """A snapshot of a ParallelTrainer restores into a Trainer and into two
    ParallelTrainers with the donor's parameters; the two parallel
    restores then train three steps with equal losses."""
    cfg, ds = _cfg(config), _ds(sphere_dataset)
    a = ParallelTrainer(ds, cfg, devices=CPU2)
    for _ in range(5):
        a.train_step()
    path = str(tmp_path / "snap.msgpack")
    snap.save_snapshot(path, a)
    data = snap.load_snapshot(path)
    single = Trainer(ds, cfg, device="cpu")
    b, c = (ParallelTrainer(ds, cfg, devices=CPU2) for _ in range(2))
    for t in (single, b, c):
        snap.restore_trainer(t, data)
        assert (t.step, t.n_rays) == (a.step, a.n_rays)
        for k, p in t.params.items():
            assert torch.equal(p, a.params[k]), k
    _replicas_identical(b)
    lb = [b.train_step()["loss_total"] for _ in range(3)]
    lc = [c.train_step()["loss_total"] for _ in range(3)]
    assert lb == lc and np.isfinite(lb).all()
    assert np.isfinite(single.train_step()["loss_total"])


@pytest.mark.parametrize("n_devices,n_chips,parallel", [
    (2, "2", True), (2, "0", True), (2, "1", False), (1, "2", False)])
def test_cli_dispatch(scene, capsys, monkeypatch,  # noqa: F811
                      n_devices, n_chips, parallel):
    """`--n-chips` trains data-parallel where more than one device is asked
    for and exists, on one Trainer otherwise (the JAX CLI's rule)."""
    scene_dir, net = scene
    monkeypatch.setattr(testbed, "replica_devices",
                        lambda device: [device] * n_devices)
    assert testbed.main(["--scene", scene_dir, "--maxiter", "3",
                         "--n-chips", n_chips] + _small(net)) == 0
    out = capsys.readouterr().out
    assert ("Data-parallel over 2 devices" in out) == parallel
    assert "iteration=3 loss=" in out
