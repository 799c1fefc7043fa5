"""The divergence guard and the error-map rebuild of the PyTorch port.

Differential: each scenario of tests/test_divergence_guard.py feeds the
same synthetic metrics to a JAX `Trainer` and a port `Trainer` through
`_consume_metrics` (no training steps); after every feed both must agree
on `rolled_back`, the step, the update scale, the RGB+ flag, every
`_guard_*` field, the three EMAs, the floors and the steps of the good,
anchor and deep-anchor checkpoints (or raise alike).

Port only: a restore equals its snapshot bit for bit and writes into the
live tensors; each rollback draws a new generator stream; a healthy
guarded run equals an unguarded one bit for bit. Error map: `splat` and
`rebuild` against the JAX package, and the rebuild cadence.
"""

import dataclasses
import math

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rnb_neus2_tpu import config as jconfig
from rnb_neus2_tpu.testing.synthetic import sphere_dataset as jsphere
from rnb_neus2_tpu.train import error_map as jerror_map
from rnb_neus2_tpu.train.trainer import Trainer as JTrainer
from rnb_neus2_torch import config
from rnb_neus2_torch.testing.synthetic import sphere_dataset
from rnb_neus2_torch.train import error_map
from rnb_neus2_torch.train.trainer import Trainer

H = 0.05          # a healthy normalized color loss
CAP = jconfig.TrainConfig().guard_max_trips
REARM = jconfig.TrainConfig().guard_rearm_steps


def _cfg(pkg):
    return pkg.TestbedConfig(
        grid=pkg.HashGridConfig(n_levels=2, top_resolution=32),
        train=pkg.TrainConfig(target_batch_size=1 << 9,
                              initial_rays_per_batch=64, occ_grid_size=16,
                              seed=0),
        march=pkg.MarchConfig(n_ladder=64, cone_angle=1.0 / 256.0))


@pytest.fixture(scope="module")
def trainers():
    jtr = JTrainer(jsphere(n_views=2, width=16, height=16, radius=0.2),
                   _cfg(jconfig))
    tr = Trainer(sphere_dataset(n_views=2, width=16, height=16, radius=0.2),
                 _cfg(config), device="cpu")
    return jtr, tr


def _reset(tr, **train):
    tr.cfg = dataclasses.replace(
        tr.cfg, flags=dataclasses.replace(tr.cfg.flags, apply_rgbplus=True),
        train=dataclasses.replace(
            tr.cfg.train, divergence_guard=True, guard_terminal="degrade",
            guard_rearm_cancel_on_degrade=True, **train))
    tr.lr_scale = 1.0
    tr._good = tr._anchor = tr._deep_anchor = None
    tr._guard_windows = tr._guard_rollbacks = 0
    tr._guard_total_rollbacks = tr._guard_rearms_used = 0
    tr._guard_best_step = -1
    tr._guard_suspect = False
    tr._guard_ema_floor = tr._guard_ek_floor = None
    tr._guard_degraded_at = tr._guard_rearmed_at = None
    tr._guard_trip_best_steps = []
    for ema in (tr.loss_ema, tr.ek_ema, tr.mask_ema):
        ema.reset()
    tr.step = 0
    tr.n_rays = tr.cfg.train.initial_rays_per_batch


def _state(tr) -> dict:
    s = {k: v for k, v in vars(tr).items() if k.startswith("_guard_")}
    s.update(step=tr.step, n_rays=tr.n_rays, lr_scale=tr.lr_scale,
             rgbplus=tr.cfg.flags.apply_rgbplus,
             emas=[(e.value, e._initialized, e.updates)
                   for e in (tr.loss_ema, tr.ek_ema, tr.mask_ema)],
             checkpoints=[None if g is None else (g["step"], g["loss_ema"],
                                                  g["ek_ema"])
                          for g in (tr._good, tr._anchor, tr._deep_anchor)])
    return s


def f(loss, adv=1, ek=1e-4):
    return ("feed", loss, adv, ek)


def rep(n, *op):
    return [op] * n


SCENARIOS = {
    "healthy": rep(5, *f(H)),
    "spike": rep(3, *f(H)) + [f(1e6)],
    "nan": [f(H), f(math.nan)],
    "escalate_to_anchor": [f(H), f(H, 70), f(1e6), f(1e6)],
    "escalate_to_deep_anchor": [f(H), f(H, 70), f(H, 70), f(H, 200),
                                f(H, 70)] + rep(5, *f(1e6)),
    # healthy reads at step gaps around the 64- and 256-step anchor lags,
    # then trips that walk back through good, anchor and deep anchor
    "anchor_lag_boundaries": [f(H)] + [
        f(H, int(a)) for a in np.random.default_rng(0).choice(
            [1, 62, 63, 64, 65, 127, 128, 191, 192, 193, 255, 256], 60)]
    + rep(6, *f(1e6)),
    "scale_restores": rep(3, *f(H)) + [f(1e6)] + rep(8, *f(H)),
    "bad_first_window": [f(math.inf), f(H)],
    "guard_off": [("cfg", {"divergence_guard": False}), f(H), f(1e6)],
    "soft_spike_forgiven_once": rep(3, *f(H)) + [f(5.0), f(H), f(5.0),
                                                 f(5.0)],
    "ema_ceiling": [f(0.05 * 1.2 ** i) for i in range(40)],
    "ema_ceiling_absolute_arm": rep(3, *f(0.0006)) + [
        f(0.0006 * 1.15 ** i) for i in range(1, 32)],
    "degrade_then_finish": [f(H)] + rep(CAP + 1, *f(1e6)) + [f(H)]
    + rep(CAP + 2, *f(1e6)),
    "rearm": [("cfg", {"guard_rearm_cancel_on_degrade": False}), f(H)]
    + rep(CAP + 1, *f(1e6)) + [f(H, REARM // 2), f(H, REARM)]
    + rep(CAP + 1, *f(1e6)) + [f(H, 3 * REARM)] + rep(CAP + 1, *f(1e6))
    + [f(H, 3 * REARM)],
    "rearm_detonation": [f(H)] + rep(CAP + 1, *f(1e6))
    + [f(H, REARM + 1), f(H, 30), f(1e6, 10)],
    "failed_rearm_cancels_budget": [f(H)] + rep(CAP + 1, *f(1e6))
    + [f(H, REARM + 1), f(H, 300)] + rep(CAP + 2, *f(1e6))
    + [f(H, 4 * REARM)],
    "thrash": [f(H)] + (CAP + 2) * [f(H, 5), f(1e6)],
    "slow_progress_no_thrash": [f(H)] + (CAP + 2) * [f(H, 128), f(1e6)],
    "oscillation_livelock": [f(H)] + 120 * [f(1e6, 32), f(H, 0)],
    "ek_creep": rep(4, *f(H, 70, 0.005)) + rep(30, *f(H, 16, 0.5)),
    "ek_inert_while_degraded": rep(3, *f(H, 70, 0.005))
    + rep(CAP + 1, *f(1e6)) + rep(60, *f(H, 16, 0.5)),
    "ek_gate_blocks_rearm": rep(3, *f(H, 70, 0.005))
    + rep(CAP + 1, *f(1e6)) + rep(40, *f(H, 10, 0.08))
    + rep(10, *f(H, 200, 0.08)) + rep(120, *f(H, 10, 0.005)),
    "rollback_restores_ek_ema": rep(3, *f(H, 70, 0.004))
    + [f(H, 1, 0.018), f(1e6), f(1e6, 0)],
    "cold_ema_first_sync": [f(481876.0), f(H)],
    "seeded_guard_keeps_cold_ema": [("seed", 100), f(1e6), f(H)],
    "zero_loss_dead_run": rep(3, *f(H)) + [f(0.0)],
    "terminal_raise": [("cfg", {"guard_terminal": "raise"}), f(H)]
    + rep(30, *f(1e6)),
}


def _apply(tr, op):
    """Run one op on one trainer → (output, error message)."""
    if op[0] == "cfg":
        tr.cfg = dataclasses.replace(
            tr.cfg, train=dataclasses.replace(tr.cfg.train, **op[1]))
        return None, None
    if op[0] == "seed":
        tr.step = op[1]
        tr.seed_guard()
        return None, None
    _, loss, adv, ek = op
    tr.step += adv
    try:
        return tr._consume_metrics(
            {"loss_color": loss, "loss_ek": ek, "loss_mask": 0.1,
             "loss_total": loss, "n_valid_total": 512.0,
             "rays_per_batch": 64}), None
    except RuntimeError as e:
        return None, str(e)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_guard_matches_jax(trainers, name):
    jtr, tr = trainers
    _reset(jtr)
    _reset(tr)
    jtr._compiled.clear()
    rolled = raised = 0
    for i, op in enumerate(SCENARIOS[name]):
        (jout, jerr), (out, err) = _apply(jtr, op), _apply(tr, op)
        assert err == jerr, (i, op)
        if jerr is not None:
            raised += 1
            break
        if jout is not None:
            assert out.get("rolled_back") == jout.get("rolled_back"), (i, op)
            rolled += bool(out.get("rolled_back"))
            for k, v in jout.items():
                assert out[k] == v or (math.isnan(v) and math.isnan(out[k]))
        assert _state(tr) == _state(jtr), (i, op)
    # every scenario but the healthy and unguarded ones exercises the guard
    if name not in ("healthy", "guard_off"):
        assert rolled or raised or tr._guard_ema_floor is not None
    assert raised == (name in ("degrade_then_finish", "terminal_raise",
                               "oscillation_livelock"))


# ---------------------------------------------------------------------------
# port only: restores, streams, and a guard that changes no number
# ---------------------------------------------------------------------------

def _small_trainer(guard=True, seed=0):
    cfg = config.TestbedConfig(
        grid=config.HashGridConfig(n_levels=3, top_resolution=32),
        train=config.TrainConfig(target_batch_size=1 << 11,
                                 initial_rays_per_batch=128,
                                 occ_grid_size=16, seed=seed,
                                 divergence_guard=guard),
        march=config.MarchConfig(n_ladder=128))
    return Trainer(sphere_dataset(n_views=4, width=16, height=16,
                                  radius=0.2), cfg, device="cpu")


def _live_tensors(tr) -> dict:
    out = {f"param.{k}": p for k, p in tr.params.items()}
    for name in ("mu", "nu", "steps", "ema"):
        out.update({f"{name}.{k}": t
                    for k, t in getattr(tr.opt, name).items()})
    out.update({f"emap.{k}": t for k, t in tr.emap._asdict().items()})
    out.update({f"occ.{k}": getattr(tr.occ, k)
                for k in ("density", "bitfield", "mean_density")})
    return out


def _snapshot_tensors(g) -> dict:
    out = {f"param.{k}": t for k, t in g["params"].items()}
    for name in ("mu", "nu", "steps", "ema"):
        out.update({f"{name}.{k}": t for k, t in g["opt"][name].items()})
    out.update({f"emap.{k}": t for k, t in g["emap"]._asdict().items()})
    out.update({f"occ.{k}": getattr(g["occ"], k)
                for k in ("density", "bitfield", "mean_density")})
    return out


def test_restore_equals_snapshot_in_place():
    tr = _small_trainer()
    for _ in range(6):
        tr.train_step()
    good = tr._good
    assert good["step"] == 6
    kept = {k: t.clone() for k, t in _snapshot_tensors(good).items()}
    for _ in range(3):
        tr.train_step()
    live = _live_tensors(tr)
    ptrs = {k: t.data_ptr() for k, t in live.items()}
    assert any(not torch.equal(t, kept[k]) for k, t in live.items())
    tr._restore(good)
    live = _live_tensors(tr)
    assert set(live) == set(kept)
    for k, t in live.items():
        assert t.data_ptr() == ptrs[k], f"{k} was replaced, not copied into"
        assert t.dtype == kept[k].dtype and torch.equal(t, kept[k]), k
    # the snapshot itself is intact, and the counters came back with it
    for k, t in _snapshot_tensors(good).items():
        assert torch.equal(t, kept[k]), k
    assert tr.step == 6 and tr.opt.count == good["opt"]["count"] == 6
    assert tr.occ.ema_step == good["occ"].ema_step
    assert torch.equal(tr.generator.get_state(), good["rng"])
    assert tr.params["hash_table"] is tr.field.hash_table


def _draws(gen_state, n=8):
    g = torch.Generator()
    g.set_state(gen_state)
    return torch.rand(n, generator=g)


def test_each_rollback_draws_a_new_stream():
    tr = _small_trainer()
    for _ in range(4):
        tr.train_step()
    states = []
    for trip in range(3):
        out = tr._consume_metrics({
            "loss_color": torch.tensor(float("nan")), "loss_ek": 0.0,
            "loss_mask": 0.0, "n_valid_total": 1.0, "rays_per_batch": 64})
        assert out["rolled_back"] and tr._guard_total_rollbacks == trip + 1
        # the first trip restores the freshest checkpoint (step 4), the
        # next ones the anchor (step 1)
        assert tr.step == (4 if trip == 0 else 1) == tr._good["step"]
        assert tr.lr_scale == 0.5 ** (trip + 1)
        states.append(tr.generator.get_state())
        assert not torch.equal(_draws(states[-1]), _draws(tr._good["rng"]))
    assert len({bytes(s.numpy()) for s in states}) == 3
    out = tr.train_step()
    assert "rolled_back" not in out and tr.step == 2


def test_guarded_healthy_run_equals_unguarded():
    """The guard copies and reads; it changes no number of a healthy
    run."""
    a, b = _small_trainer(guard=True), _small_trainer(guard=False)
    for _ in range(12):
        ma, mb = a.train_step(), b.train_step()
        for k in ("loss_color", "loss_total", "rays_per_batch",
                  "n_valid_total"):
            assert ma[k] == mb[k], k
    assert a._good is not None and b._good is None
    la, lb = _live_tensors(a), _live_tensors(b)
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    assert a.n_rays == b.n_rays and a.step == b.step == 12
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


# ---------------------------------------------------------------------------
# error map
# ---------------------------------------------------------------------------

SPLAT_CASES = [(n, rays, res) for n, rays, res in (
    (4, 4096, (512, 612)), (20, 4096, (512, 612)), (3, 256, (24, 20)),
    (2, 64, (8, 8)), (1, 1 << 18, (640, 480)))]


@pytest.mark.parametrize("n,rays,res", SPLAT_CASES)
def test_splat_matches_jax(n, rays, res):
    """At every resolution `resolution_for` gives these scenes (the
    clamped edge included), with pixels on the borders and in the corner
    texels."""
    ew, eh = error_map.resolution_for(n, rays, 128, res)
    assert (ew, eh) == jerror_map.resolution_for(n, rays, 128, res)
    rng = np.random.default_rng(n)
    R = 2048
    img = rng.integers(0, n, R).astype(np.int32)
    xy = rng.random((R, 2)).astype(np.float32)
    xy[:8] = [[0, 0], [1, 1], [0, 1], [1, 0], [0.9999999, 0.5],
              [0.5, 0.9999999], [0.5 / ew, 0.5 / eh], [1e-7, 1.0]]
    loss = rng.random(R).astype(np.float32)
    jst = jerror_map.splat(jerror_map.init_state(n, ew, eh),
                           jnp.asarray(img), jnp.asarray(xy),
                           jnp.asarray(loss))
    st = error_map.splat(error_map.init_state(n, ew, eh),
                         torch.from_numpy(img).long(), torch.from_numpy(xy),
                         torch.from_numpy(loss))
    want = np.asarray(jst.accum)
    np.testing.assert_allclose(st.accum.numpy(), want, rtol=1e-6,
                               atol=1e-6)
    assert abs(float(st.accum.sum()) - float(loss.sum())) \
        <= 1e-4 * float(loss.sum())


def test_init_and_rebuild_match_jax():
    n, ew, eh = 5, 13, 11
    rng = np.random.default_rng(7)
    accum = (rng.random((n, eh, ew)) ** 4).astype(np.float32)
    accum[1] = 0.0                       # an image with no loss at all
    for st, jst in ((error_map.init_state(n, ew, eh),
                     jerror_map.init_state(n, ew, eh)),):
        for a, b in zip(st, jst):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = error_map.rebuild(error_map.init_state(n, ew, eh)._replace(
        accum=torch.from_numpy(accum)))
    want = jerror_map.rebuild(jerror_map.init_state(n, ew, eh)._replace(
        accum=jnp.asarray(accum)))
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        assert a.shape == tuple(b.shape), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    assert bool(got.valid) and not got.accum.any()
    assert error_map.MIN_PDF == jerror_map.MIN_PDF
    assert error_map.MIN_IMG_PMF == jerror_map.MIN_IMG_PMF


def test_rebuild_cadence(monkeypatch):
    """First rebuild after 128 steps, then each interval ×1.5: at steps
    128, 320 and 608, and the accumulator resets each time."""
    tr = _small_trainer()
    metrics = {"loss_color": torch.tensor(H), "loss_ek": torch.tensor(1e-3),
               "loss_mask": torch.tensor(0.1), "n_samples_kept": 512.0,
               "n_valid_total": torch.tensor(512.0)}

    def step_body(n_rays, n_active):
        tr.emap = tr.emap._replace(accum=tr.emap.accum + 1.0)
        return dict(metrics)

    at = []
    real = error_map.rebuild
    monkeypatch.setattr(tr, "_step_body", step_body)
    monkeypatch.setattr(tr, "refresh_occupancy", lambda n: None)
    monkeypatch.setattr(error_map, "rebuild",
                        lambda st: at.append(tr.step) or real(st))
    for _ in range(700):
        tr.train_step()
    assert at == [128, 320, 608]
    assert tr._emap_interval == 432 and tr._emap_counter == 700 - 608
    assert float(tr.emap.accum.max()) == 700 - 608
    assert bool(tr.emap.valid)
