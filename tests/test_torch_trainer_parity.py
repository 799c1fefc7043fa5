"""Trainer composition: a few steps of the port's `Trainer.train_step`
against the JAX package's on JAX's own draws.

Both trainers start from the JAX package's initial parameters. Before
each step the test reproduces the JAX trainer's key splits
(`Trainer.train_step`: one split for an occupancy refresh when the
cadence asks for one, one for the step; `sample_ray_batch` splits the
step key four ways) and hands the port the same numbers: the jitter of
`occupancy.cell_positions` and the sampler's `RayUniforms`. The exact
backward keeps float noise from flipping a stochastic pick. After every
step: the loss within 1e-5 relative, rays per batch and the occupancy
bitfield equal, the density within 1e-5, the parameters and the EMA
within 1e-4 (a tenth of the learning rate), the Adam moments within
1e-3 of their largest entry — 3e-3 for the variance, whose gradient is
one float32 sum over every sample with cancellation, in another order
in each package and with each thread count (up to 1.0e-3 seen on this
config, the other parameters up to 1.7e-4) — and the debias steps and
the count equal.

Past step 256 the refresh visits G³/4 uniform and G³/4 occupancy-biased
cells (`sample_update_cells`, with JAX's jitter): a second test runs three
steps, moves both trainers' step counters to 256 (the refresh's cadence is
then 16, and every frame's canonical phase of a dynamic sequence trains
there), and compares the step at 256, which opens with a subsampled
refresh. (Not more: at step 257 one hash entry's first gradient is float
cancellation noise, 4e-10 in one package and -3e-11 in the other, and
sparse Adam's first update, lr·sign(g), turns that into ±lr.)

Also: `train.max_steps`, which the CLI's loop reads, changes nothing in a
step.
"""

import dataclasses

import numpy as np
import pytest
import jax
import torch
from flax import serialization

from rnb_neus2_tpu import config as jconfig
from rnb_neus2_tpu.grid import occupancy as joccupancy
from rnb_neus2_tpu.testing.synthetic import sphere_dataset as jsphere
from rnb_neus2_tpu.train.trainer import Trainer as JTrainer
from rnb_neus2_torch import config, interop
from rnb_neus2_torch.grid import occupancy
from rnb_neus2_torch.testing.synthetic import sphere_dataset
from rnb_neus2_torch.train import trainer as trainer_mod
from rnb_neus2_torch.train.sampler import RayUniforms

STEPS = 5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the test workers share the host's cores, and
    at these sizes more threads only wait on each other (a tiny run took
    7x longer with 8 threads on a busy host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(pkg):
    return pkg.TestbedConfig(
        grid=pkg.HashGridConfig(n_levels=4, top_resolution=64),
        network=pkg.NetworkConfig(stoch_corner_bwd=0),
        train=pkg.TrainConfig(target_batch_size=1 << 13,
                              initial_rays_per_batch=128, occ_grid_size=32,
                              seed=0),
        march=pkg.MarchConfig(n_ladder=512))


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _jax_draws(jtr):
    """The numbers JAX's next `train_step` draws: the occupancy jitter (or
    None) and the sampler's uniforms."""
    key, jitter = jtr.key, None
    if jtr.step % joccupancy.update_cadence(jtr.step) == 0:
        key, k = jax.random.split(key)
        g = jtr.cfg.train.occ_grid_size
        n = g ** 3 if jtr.step < 256 else 2 * max(g ** 3 // 4, 1)
        jitter = _t(jax.random.uniform(k, (n, 3)))
    key, k = jax.random.split(key)
    R = jtr._bucket()
    k_xy, k_skip, k_light, k_start = jax.random.split(k, 4)
    uni = RayUniforms(xy=_t(jax.random.uniform(k_xy, (R, 2))),
                      skip=_t(jax.random.uniform(k_skip, (R,))),
                      start=_t(jax.random.uniform(k_start, (R,))),
                      light_idx=_t(jax.random.randint(k_light, (R,), 0, 3),
                                   torch.int64))
    return jitter, uni


def _close(got, want, atol, what):
    for k in want:
        err = float((got[k].detach().double() - want[k].double()).abs().max())
        assert err <= atol, (what, k, err)


def _pair(monkeypatch):
    """Both trainers from the JAX package's initial parameters, the port's
    draws taken from a queue that `_compare_steps` fills."""
    jtr = JTrainer(jsphere(n_views=4, width=32, height=32, radius=0.2),
                   _cfg(jconfig))
    tr = trainer_mod.Trainer(
        sphere_dataset(n_views=4, width=32, height=32, radius=0.2),
        _cfg(config), device="cpu",
        params=interop.params_from_jax(_np_tree(jtr.params)))
    queue = {"jitter": [], "uniforms": []}
    real_sample, real_cells, real_sub = (trainer_mod.sample_ray_batch,
                                         occupancy.cell_positions,
                                         occupancy.sample_update_cells)
    monkeypatch.setattr(trainer_mod, "sample_ray_batch",
                        lambda *a, **k: real_sample(
                            *a, **{**k, "uniforms": queue["uniforms"].pop()}))
    monkeypatch.setattr(occupancy, "cell_positions",
                        lambda g, gen=None, device="cpu": real_cells(
                            g, gen, device, jitter=queue["jitter"].pop()))
    monkeypatch.setattr(occupancy, "sample_update_cells",
                        lambda *a, **k: real_sub(
                            *a, **{**k, "jitter": queue["jitter"].pop()}))
    return jtr, tr, queue


def _np_tree(t):
    return jax.tree_util.tree_map(np.array, t)


def _compare_steps(jtr, tr, queue, n, moment_rel=1e-3) -> int:
    """n steps of both on JAX's draws, compared after each; returns the
    number of occupancy refreshes. `moment_rel`: the Adam moments'
    tolerance, relative to their largest entry (the variance's is 3x)."""
    refreshes = 0
    for _ in range(n):
        jitter, uni = _jax_draws(jtr)
        queue["uniforms"].append(uni)
        if jitter is not None:
            queue["jitter"].append(jitter)
            refreshes += 1
        jm, m = jtr.train_step(), tr.train_step()
        assert not queue["uniforms"] and not queue["jitter"]
        assert m["loss_total"] == pytest.approx(jm["loss_total"], rel=1e-5)
        assert (tr.step, tr.n_rays) == (jtr.step, jtr.n_rays)
        assert torch.equal(tr.occ.bitfield, _t(jtr.occ.bitfield))
        assert int(tr.occ.ema_step) == int(jtr.occ.ema_step)
        want_d = _t(jtr.occ.density)
        assert float((tr.occ.density - want_d).abs().max()) <= 1e-5 * (
            1.0 + float(want_d.abs().max()))
        _close(tr.params, interop.params_from_jax(_np_tree(jtr.params)),
               1e-4, "params")
        want = interop.opt_state_from_jax(
            serialization.to_state_dict(_np_tree(jtr.opt_state.adam)),
            _np_tree(jtr.opt_state.ema_params))
        _close(tr.opt.ema, want["ema"], 1e-4, "ema")
        for name in ("mu", "nu"):
            got = getattr(tr.opt, name)
            for k, w in want[name].items():
                err = float((got[k] - w).abs().max())
                rel = 3 * moment_rel if k == "variance" else moment_rel
                assert err <= rel * (float(w.abs().max()) + 1e-30), \
                    (name, k, err)
        for k, w in want["steps"].items():
            assert torch.equal(tr.opt.steps[k], w), ("steps", k)
        assert tr.opt.count == want["count"]
    return refreshes


def test_train_steps_match_jax_on_its_draws(monkeypatch):
    jtr, tr, queue = _pair(monkeypatch)
    assert _compare_steps(jtr, tr, queue, STEPS) >= 3
    assert tr.opt.count == jtr.step == STEPS


def test_subsampled_refresh_past_step_256_matches_jax(monkeypatch):
    """Three steps, then both step counters at 256: the next step's
    refresh evaluates G³/2 cells picked by `sample_update_cells` from the
    grid both trainers hold (candidates from the refresh count, the first
    above the threshold among 10) and max-splats them; the bitfield, the
    density and every parameter agree as before."""
    jtr, tr, queue = _pair(monkeypatch)
    _compare_steps(jtr, tr, queue, 3)
    jtr.step = tr.step = 256
    before = tr.occ.ema_step
    assert _compare_steps(jtr, tr, queue, 1) == 1
    assert tr.occ.ema_step == before + 1
    assert 0 < int(tr.occ.bitfield.sum()) < tr.occ.bitfield.numel()


def test_max_steps_does_not_change_a_step():
    ds = sphere_dataset(n_views=2, width=16, height=16, radius=0.2)
    runs = []
    for max_steps in (10, 10_000):
        cfg = _cfg(config)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, max_steps=max_steps))
        tr = trainer_mod.Trainer(ds, cfg, device="cpu")
        out = [tr.train_step()["loss_total"] for _ in range(2)]
        runs.append((out, {k: p.detach().clone()
                           for k, p in tr.params.items()}))
    (l0, p0), (l1, p1) = runs
    assert l0 == l1
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
