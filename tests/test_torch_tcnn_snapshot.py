"""CUDA-testbed snapshots of the PyTorch port against the JAX package:
the padded widths, the fp16 parameter blob and the whole file byte for
byte for the same state, the Morton permutation, either package importing
the other's file (parameters equal to their fp16 rounding bit for bit,
the density grid through the Morton round trip), and the rejection of a
file whose network does not fit the trainer's config."""

import types

import numpy as np
import pytest
import jax
import torch

from rnb_neus2_tpu import config as jconfig
from rnb_neus2_tpu.testing.synthetic import sphere_dataset as jsphere
from rnb_neus2_tpu.train import tcnn_snapshot as jts
from rnb_neus2_tpu.train.trainer import Trainer as JTrainer
from rnb_neus2_torch import config, interop
from rnb_neus2_torch.testing.synthetic import sphere_dataset
from rnb_neus2_torch.train import tcnn_snapshot as ts
from rnb_neus2_torch.train.trainer import Trainer

GRID = dict(n_levels=4, top_resolution=64, log2_hashmap_size=15)
NETWORK_CONFIG = {"encoding": {"otype": "HashGrid", "n_levels": 4},
                  "network": {"n_neurons": 64}, "aabb_scale": 1}


def _cfg(pkg, **grid):
    return pkg.TestbedConfig(
        grid=pkg.HashGridConfig(**{**GRID, **grid}),
        train=pkg.TrainConfig(target_batch_size=1 << 13,
                              initial_rays_per_batch=128, occ_grid_size=32,
                              seed=0))


def _state(seed):
    """Random field parameters (the JAX tree, numpy) and density grid."""
    jtr = JTrainer(jsphere(n_views=2, width=16, height=16, radius=0.2),
                   _cfg(jconfig))
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32),
        jtr.params)
    density = (rng.random(32 ** 3) * 2 - 0.5).astype(np.float32)
    return jtr, tree, density


@pytest.fixture(scope="module")
def state():
    return _state(0)


def test_shapes_match_jax():
    for cfg_kw in ({}, GRID):
        jshape = jts.MlpShapes.from_config(jconfig.TestbedConfig(
            grid=jconfig.HashGridConfig(**cfg_kw)))
        shape = ts.MlpShapes.from_config(config.TestbedConfig(
            grid=config.HashGridConfig(**cfg_kw)))
        assert vars(shape) == vars(jshape)
        assert shape.n_params() == jshape.n_params()
    default = ts.MlpShapes.from_config(config.TestbedConfig())
    assert (default.sdf_in, default.rgb_in) == (32, 48)


def test_morton_permutation_matches_jax():
    for g in (4, 32):
        np.testing.assert_array_equal(ts._morton_to_rowmajor_perm(g),
                                      jts._morton_to_rowmajor_perm(g))


def test_blob_and_file_bytes_equal_jax(state, tmp_path):
    """The same EMA parameters, density grid, step, loss and ray count
    give the same fp16 blob and the same file bytes in both packages."""
    jtr, tree, density = state
    shapes = ts.MlpShapes.from_config(_cfg(config))
    params = interop.params_from_jax(tree)
    blob = ts.params_to_tcnn_blob(params, shapes)
    jblob = jts.params_to_tcnn_blob(tree, jts.MlpShapes.from_config(jtr.cfg))
    assert blob.dtype == np.float16 and blob.tobytes() == jblob.tobytes()
    common = dict(step=1234, n_rays=4096,
                  loss_ema=types.SimpleNamespace(value=0.0123))
    jfake = types.SimpleNamespace(
        cfg=jtr.cfg, opt_state=types.SimpleNamespace(ema_params=tree),
        occ=types.SimpleNamespace(density=density), **common)
    fake = types.SimpleNamespace(
        cfg=_cfg(config), inference_params=params,
        occ=types.SimpleNamespace(density=torch.from_numpy(density)),
        **common)
    jts.export_cuda_snapshot(str(tmp_path / "j.msgpack"), jfake,
                             NETWORK_CONFIG)
    ts.export_cuda_snapshot(str(tmp_path / "t.msgpack"), fake,
                            NETWORK_CONFIG)
    assert (tmp_path / "t.msgpack").read_bytes() == \
        (tmp_path / "j.msgpack").read_bytes()


def _fp16(a):
    return np.asarray(a, np.float32).astype(np.float16).astype(np.float32)


def test_each_package_imports_the_other(state, tmp_path):
    """The JAX file into a port `Trainer` and the port's file into a JAX
    `Trainer`: parameters and their EMA equal the fp16 rounding of the
    source bit for bit, the density grid comes back row-major (its fp16
    rounding) with its bitfield against min(0.1, mean), and the step and
    ray count are the file's."""
    jtr, tree, density = state
    src_j = types.SimpleNamespace(
        cfg=jtr.cfg, opt_state=types.SimpleNamespace(ema_params=tree),
        occ=types.SimpleNamespace(density=density), step=77, n_rays=2048,
        loss_ema=types.SimpleNamespace(value=0.5))
    jts.export_cuda_snapshot(str(tmp_path / "j.msgpack"), src_j)
    tr = Trainer(sphere_dataset(n_views=2, width=16, height=16, radius=0.2),
                 _cfg(config), device="cpu")
    ts.import_cuda_snapshot(str(tmp_path / "j.msgpack"), tr)
    want = interop.params_from_jax(jax.tree_util.tree_map(_fp16, tree))
    for k, w in want.items():
        assert torch.equal(tr.params[k].detach(), w), k
        assert torch.equal(tr.opt.ema[k], w), k
    np.testing.assert_array_equal(tr.occ.density.numpy(), _fp16(density))
    d = _fp16(density)
    np.testing.assert_array_equal(
        tr.occ.bitfield.numpy(),
        d > min(0.1, float(np.maximum(d, 0).mean(dtype=np.float32))))
    assert (tr.step, tr.n_rays) == (77, 2048)
    assert np.isfinite(tr.train_step()["loss_total"])

    ts.export_cuda_snapshot(str(tmp_path / "t.msgpack"), tr)
    jtr2 = JTrainer(jsphere(n_views=2, width=16, height=16, radius=0.2),
                    _cfg(jconfig))
    jts.import_cuda_snapshot(str(tmp_path / "t.msgpack"), jtr2)
    want = interop.params_to_jax(tr.inference_params)
    for a, b in zip(jax.tree_util.tree_leaves(jtr2.params),
                    jax.tree_util.tree_leaves(
                        jax.tree_util.tree_map(_fp16, want))):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(
        np.asarray(jtr2.occ.density),
        tr.occ.density.numpy().astype(np.float16).astype(np.float32))
    assert (jtr2.step, jtr2.n_rays) == (tr.step, tr.n_rays)


def test_mismatched_config_is_rejected(state, tmp_path):
    jtr, tree, density = state
    src = types.SimpleNamespace(
        cfg=jtr.cfg, opt_state=types.SimpleNamespace(ema_params=tree),
        occ=types.SimpleNamespace(density=density), step=1, n_rays=128,
        loss_ema=types.SimpleNamespace(value=None))
    jts.export_cuda_snapshot(str(tmp_path / "j.msgpack"), src)
    tr = Trainer(sphere_dataset(n_views=2, width=16, height=16, radius=0.2),
                 _cfg(config, n_levels=5), device="cpu")
    before = {k: p.detach().clone() for k, p in tr.params.items()}
    with pytest.raises(ValueError, match="network configs differ"):
        ts.import_cuda_snapshot(str(tmp_path / "j.msgpack"), tr)
    assert all(torch.equal(before[k], p) for k, p in tr.params.items())
