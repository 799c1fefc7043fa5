"""Sparse and dense Adam, L2 on matrices, the schedule and the EMA of the
PyTorch port against the JAX package's optax chain, from equal gradients;
and the port's `Adam` against optax's `adam` (the rigid delta's)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch
from flax import serialization

from rnb_neus2_tpu.config import HashGridConfig as JHashGridConfig
from rnb_neus2_tpu.config import NetworkConfig as JNetworkConfig
from rnb_neus2_tpu.config import OptimizerConfig as JOptimizerConfig
from rnb_neus2_tpu.models.neus_field import init_params
from rnb_neus2_tpu.train import optimizer as jopt
from rnb_neus2_torch import interop
from rnb_neus2_torch.config import OptimizerConfig
from rnb_neus2_torch.train import optimizer as opt


def _grads_like(tree, rng):
    """Random gradients; 70% of the hash-table slots get exactly zero."""
    g = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32) * 1e-2,
        tree)
    g["hash_table"][rng.random(g["hash_table"].shape) < 0.7] = 0.0
    return g


@pytest.mark.parametrize("decay_start", [20000, 1])
def test_sparse_adam_matches_jax(decay_start):
    """Three steps (the second scaled by 0.5, the third with the RGB MLP
    gated off): parameters and EMA rtol 1e-6; slots whose gradient was
    zero at every step keep their value exactly."""
    tree = jax.tree_util.tree_map(np.asarray, init_params(
        jax.random.PRNGKey(0), JHashGridConfig(n_levels=2, top_resolution=24),
        JNetworkConfig()))
    jcfg = JOptimizerConfig(decay_start=decay_start, decay_interval=1)
    tx = jopt.make_optimizer(jcfg, tree)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init_state(jcfg, jparams)

    params = {k: v.clone() for k, v in interop.params_from_jax(tree).items()}
    adam = opt.AdamChain(OptimizerConfig(decay_start=decay_start,
                                         decay_interval=1), params,
                          [k for k in params if k.startswith(("sdf", "rgb"))])
    rng = np.random.default_rng(1)
    touched = np.zeros(tree["hash_table"].shape, bool)
    for rgb_scale, upd_scale in ((1.0, 1.0), (1.0, 0.5), (0.0, 1.0)):
        g = _grads_like(tree, rng)
        touched |= g["hash_table"] != 0
        jparams, jstate = jopt.apply_updates(
            tx, jcfg, jparams, jax.tree_util.tree_map(jnp.asarray, g),
            jstate, jnp.float32(rgb_scale), jnp.float32(upd_scale))
        adam.step(params, interop.params_from_jax(g), rgb_scale, upd_scale)
    got = interop.params_to_jax(params)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-9)
    ema = interop.params_to_jax(adam.ema)
    for a, b in zip(jax.tree_util.tree_leaves(ema),
                    jax.tree_util.tree_leaves(jstate.ema_params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(got["hash_table"][~touched],
                                  tree["hash_table"][~touched])
    assert (got["hash_table"][touched] != tree["hash_table"][touched]).all()
    assert adam.steps["hash_table"].max() <= 3


def test_lr_schedule_matches_jax():
    jcfg = JOptimizerConfig()
    sched = jopt.lr_schedule(jcfg)
    for step in (0, 19999, 20000, 29999, 30000, 55555):
        np.testing.assert_allclose(opt.lr_at(OptimizerConfig(), step),
                                   float(sched(step)), rtol=1e-6)


def test_dense_adam_not_ported_raises():
    """(Named when dense Adam was refused.) `sparse_adam=False` now builds
    optax's dense Adam: no per-entry debias steps, and a zero gradient
    still moves a parameter through its first moment."""
    p = {"variance": torch.ones(1)}
    adam = opt.AdamChain(OptimizerConfig(sparse_adam=False), p, [])
    assert adam.steps == {} and not adam.sparse
    adam.step(p, {"variance": torch.ones(1)})
    moved = p["variance"].clone()
    adam.step(p, {"variance": torch.zeros(1)})
    assert p["variance"] < moved < 1.0


@pytest.mark.parametrize("decay_start", [20000, 2])
def test_dense_adam_matches_jax(decay_start):
    """`OptimizerConfig(sparse_adam=False)` over 5 steps (the second scaled
    by 0.5, the third with the RGB MLP gated off) against the JAX chain
    with optax's `scale_by_adam`: parameters, EMA and moments within 1e-6
    relative; the state carried to the JAX layout and back unchanged."""
    tree = jax.tree_util.tree_map(np.asarray, init_params(
        jax.random.PRNGKey(2), JHashGridConfig(n_levels=2, top_resolution=24),
        JNetworkConfig()))
    jcfg = JOptimizerConfig(sparse_adam=False, decay_start=decay_start,
                            decay_interval=1)
    tx = jopt.make_optimizer(jcfg, tree)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = jopt.init_state(jcfg, jparams)
    params = {k: v.clone() for k, v in interop.params_from_jax(tree).items()}
    adam = opt.AdamChain(OptimizerConfig(sparse_adam=False,
                                         decay_start=decay_start,
                                         decay_interval=1), params,
                         [k for k in params if k.startswith(("sdf", "rgb"))])
    rng = np.random.default_rng(3)
    for rgb_scale, upd_scale in ((1.0, 1.0), (1.0, 0.5), (0.0, 1.0),
                                 (1.0, 1.0), (1.0, 1.0)):
        g = _grads_like(tree, rng)
        jparams, jstate = jopt.apply_updates(
            tx, jcfg, jparams, jax.tree_util.tree_map(jnp.asarray, g),
            jstate, jnp.float32(rgb_scale), jnp.float32(upd_scale))
        adam.step(params, interop.params_from_jax(g), rgb_scale, upd_scale)
    close = lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), rtol=1e-6, atol=1e-9)
    for a, b in zip(jax.tree_util.tree_leaves(interop.params_to_jax(params)),
                    jax.tree_util.tree_leaves(jparams)):
        close(a, b)
    chain, ema = interop.opt_state_to_jax(adam)
    want = serialization.to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.adam))
    assert set(chain["1"]) == set(want["1"]) == {"count", "mu", "nu"}
    assert int(chain["1"]["count"]) == int(want["1"]["count"]) == 5
    for name in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(chain["1"][name]),
                        jax.tree_util.tree_leaves(want["1"][name])):
            close(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(ema),
                    jax.tree_util.tree_leaves(jstate.ema_params)):
        close(a, b)
    back = interop.opt_state_from_jax(want, jax.tree_util.tree_map(
        np.asarray, jstate.ema_params))
    assert back["count"] == 5
    for name in ("mu", "nu", "ema"):
        for k, v in back[name].items():
            close(getattr(adam, name)[k].numpy(), v.numpy())


def test_adam_matches_optax_adam():
    """The port's `Adam` as the rigid delta uses it (lr 0.005, β .9/.99,
    eps 1e-10) against optax's `adam` over 5 steps: parameters and moments
    within 1e-6; `adam_state_from_jax` carries optax's state across."""
    rng = np.random.default_rng(4)
    p0 = {"rotation6d": rng.standard_normal(6).astype(np.float32),
          "translation": rng.standard_normal(3).astype(np.float32)}
    tx = optax.adam(0.005, b1=0.9, b2=0.99, eps=1e-10)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    p = interop.tensors_from_numpy(p0)
    adam = opt.Adam(p, 0.005, b1=0.9, b2=0.99, eps=1e-10)
    for i in range(5):
        g = {k: (rng.standard_normal(v.shape) * 10.0 ** -i)
             .astype(np.float32) for k, v in p0.items()}
        up, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                              state, jp)
        jp = optax.apply_updates(jp, up)
        p = adam.step(p, interop.tensors_from_numpy(g))
    for k in p0:
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
    other = opt.Adam(interop.tensors_from_numpy(p0), 0.005)
    interop.adam_state_from_jax(serialization.to_state_dict(state), other)
    assert other.count == adam.count == 5
    for name in ("mu", "nu"):
        for k in p0:
            np.testing.assert_allclose(getattr(other, name)[k].numpy(),
                                       getattr(adam, name)[k].numpy(),
                                       rtol=1e-6, atol=1e-12)


def test_dense_adam_trainer_snapshot_round_trip(tmp_path):
    """A `Trainer` with `sparse_adam=False` trains (loss finite) and its
    snapshot, which carries optax's dense state (no `steps`), restores
    into a fresh one bit for bit."""
    from rnb_neus2_torch.config import (HashGridConfig, MarchConfig,
                                        NetworkConfig, TestbedConfig,
                                        TrainConfig)
    from rnb_neus2_torch.testing.synthetic import sphere_dataset
    from rnb_neus2_torch.train import snapshot
    from rnb_neus2_torch.train.trainer import Trainer

    cfg = TestbedConfig(
        grid=HashGridConfig(n_levels=4, top_resolution=64),
        network=NetworkConfig(stoch_corner_bwd=0),
        train=TrainConfig(target_batch_size=1 << 12,
                          initial_rays_per_batch=128, occ_grid_size=16),
        march=MarchConfig(n_ladder=256),
        optimizer=OptimizerConfig(sparse_adam=False))
    ds = sphere_dataset(n_views=2, width=16, height=16, radius=0.2)
    tr = Trainer(ds, cfg, device="cpu")
    assert all(np.isfinite(tr.train_step()["loss_total"]) for _ in range(3))
    path = str(tmp_path / "snap.msgpack")
    snapshot.save_snapshot(path, tr)
    assert "steps" not in snapshot.load_snapshot(path)["adam_state"]["1"]
    tr2 = Trainer(ds, cfg, device="cpu")
    snapshot.restore_trainer(tr2, snapshot.load_snapshot(path))
    assert tr2.opt.count == tr.opt.count == 3 and tr2.opt.steps == {}
    for name in ("mu", "nu", "ema"):
        for k, v in getattr(tr.opt, name).items():
            assert torch.equal(getattr(tr2.opt, name)[k], v), (name, k)
    for k, v in tr.params.items():
        assert torch.equal(tr2.params[k], v), k
