"""The PyTorch port's trainer on the CPU: short sphere runs whose color
loss falls (exact and default stochastic backward), the level schedule
against the JAX package, the default config accepted as it is (guard
on), and the refusals (an unported option, a card that is not there)."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from rnb_neus2_tpu.config import HashGridConfig as JHashGridConfig
from rnb_neus2_tpu.train.trainer import \
    valid_level_for_step as j_valid_level_for_step
import rnb_neus2_torch
from rnb_neus2_torch import device as port_device
from rnb_neus2_torch.config import (HashGridConfig, MarchConfig,
                                    NetworkConfig, TestbedConfig,
                                    TrainConfig)
from rnb_neus2_torch.testing.synthetic import sphere_dataset
from rnb_neus2_torch.train.trainer import (IGNORED, NOT_READ, Trainer,
                                           check_ported, valid_level_for_step)


def _small_cfg(**net):
    return TestbedConfig(
        grid=HashGridConfig(n_levels=4, top_resolution=64),
        network=NetworkConfig(**{"stoch_corner_bwd": 0, **net}),
        train=TrainConfig(target_batch_size=1 << 13,
                          initial_rays_per_batch=128, occ_grid_size=32,
                          seed=0, divergence_guard=False),
        march=MarchConfig(n_ladder=512))


def test_sphere_run_color_loss_falls():
    """200 steps of the main path (exact backward, blocked march at cone
    0) on a small sphere scene: the color loss falls at least 4x and every
    loss stays finite."""
    tr = Trainer(sphere_dataset(n_views=8, width=32, height=32,
                                radius=0.2), _small_cfg(), device="cpu")
    hist = [tr.train_step() for _ in range(200)]
    color = np.array([m["loss_color"] for m in hist])
    assert np.isfinite([m["loss_total"] for m in hist]).all()
    assert color[-25:].mean() < 0.25 * color[:25].mean()
    assert all(m["n_samples_kept"] > 0 for m in hist)
    assert tr.occ.ema_step == sum(
        1 for s in range(200) if s % max(1, min(16, s // 16)) == 0)
    ema = tr.inference_params
    assert set(ema) == set(dict(tr.field.named_parameters()))


def test_valid_level_schedule_matches_jax():
    jcfg, cfg = JHashGridConfig(), HashGridConfig()
    steps = list(range(0, 700, 7)) + [110, 659, 660, 10_000]
    want = [int(j_valid_level_for_step(jcfg, jnp.int32(s))) for s in steps]
    assert [valid_level_for_step(cfg, s) for s in steps] == want


def test_trainer_refuses_stochastic_backward():
    """No longer refused: the default config (the K = 1 stochastic
    backward, the divergence guard on) is accepted as it is."""
    ds = sphere_dataset(n_views=2, width=8, height=8)
    cfg = TestbedConfig()
    assert cfg.network.stoch_corner_bwd == 1 and cfg.train.divergence_guard
    check_ported(cfg)
    assert Trainer(ds, cfg, device="cpu").field.net.stoch_corner_bwd == 1


def test_default_stochastic_run_color_loss_falls():
    """80 steps of the default K = 1 backward at small width: the color
    loss falls at least 2x, every loss stays finite, and each step reports
    the level bucket it ran."""
    tr = Trainer(sphere_dataset(n_views=8, width=32, height=32,
                                radius=0.2), _small_cfg(stoch_corner_bwd=1),
                 device="cpu")
    hist = [tr.train_step() for _ in range(80)]
    color = np.array([m["loss_color"] for m in hist])
    assert np.isfinite([m["loss_total"] for m in hist]).all()
    assert color[-10:].mean() < 0.5 * color[:10].mean()
    L = tr.cfg.grid.n_levels
    assert [m["n_levels_run"] for m in hist[:3]] == [L, 1, 1]


def test_trainer_refuses_divergence_guard():
    """No longer refused: the guard is on by default and ported. The
    guarded trainer takes steps, checkpoints each healthy one, and the
    default config passes `check_ported` unmodified."""
    ds = sphere_dataset(n_views=2, width=8, height=8)
    cfg = dataclasses.replace(_small_cfg(), train=TrainConfig())
    assert cfg.train.divergence_guard
    check_ported(TestbedConfig())
    tr = Trainer(ds, cfg, device="cpu")
    out = tr.train_step()
    assert "rolled_back" not in out and np.isfinite(out["loss_color"])
    assert tr.step == 1 and tr._good is not None and tr._good["step"] == 1
    assert tr.loss_ema.updates == 1


@pytest.mark.parametrize("section,name", [
    ("march", "max_samples_per_ray"), ("train", "field_chunk")])
def test_unread_options_must_keep_their_default(section, name):
    """No longer refused: the JAX package trains with any value of both
    (it reads max_samples_per_ray nowhere; field_chunk only splits its
    field's evaluation), and so does the port."""
    cfg = _small_cfg()
    part = getattr(cfg, section)
    other = getattr(part, name) // 2
    cfg = dataclasses.replace(cfg, **{
        section: dataclasses.replace(part, **{name: other})})
    check_ported(cfg)
    assert name not in {n for names in NOT_READ.values() for n in names}


def test_every_config_field_is_read_or_refused():
    """Each field of the port's config is read by the port's code (an
    attribute access outside comments and docstrings) or listed in
    NOT_READ, whose fields must keep their defaults."""
    root = Path(rnb_neus2_torch.__file__).parent
    read = {node.attr for path in root.rglob("*.py")
            for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.Attribute)}
    listed = {name for names in NOT_READ.values() for name in names}
    assert not listed & read
    listed |= {name for names in IGNORED.values() for name in names}
    cfg = TestbedConfig()
    for part in dataclasses.fields(cfg):
        for f in dataclasses.fields(getattr(cfg, part.name)):
            assert f.name in read or f.name in listed, f"{part.name}.{f.name}"


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_device.resolve_device()
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(sphere_dataset(n_views=2, width=8, height=8), _small_cfg())
    assert port_device.resolve_device("cpu").type == "cpu"
