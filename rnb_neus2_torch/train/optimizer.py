"""Optimizer chain: L2 (matrices only) → Adam (tcnn-exact sparse, or
optax's dense) → learning rate schedule, then the parameter EMA (port of
`rnb_neus2_tpu/train/optimizer.py`, written without optax); and `Adam`,
optax's `adam` for the small trainable sets of the rigid delta and the
camera refiner.

Reference chain (configs/nerf/base.json:4-28, tcnn optimizers):
  Ema(decay .95) → ExponentialDecay(start 20000, interval 10000, base .33)
      → Adam(lr 1e-3, β .9/.99, eps 1e-15, l2_reg 1e-6)

- l2_reg applies to MATRIX params only (the MLP weights);
- sparse skip (adam.h:112-118, `OptimizerConfig.sparse_adam`, the
  default): a non-matrix entry (hash-table slot, variance) whose gradient
  is EXACTLY zero this step is not touched — no moment decay, no
  debias-step increment, no update;
- per-entry debias counters (adam.h:188-190);
- update = sqrt(1−β2^s)/(1−β1^s) · mu / (sqrt(nu) + eps) (adam.h:193);
- `sparse_adam=False`: optax's `scale_by_adam` on every entry
  (`scale_by_adam` below);
- rgb_train_scale ∈ {0, 1} gates the RGB MLP (fractional training);
  update_scale multiplies the final update.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..config import OptimizerConfig


def lr_at(cfg: OptimizerConfig, step: int) -> float:
    """The schedule (ExponentialDecay) at `step` updates done."""
    n_decays = ((step - cfg.decay_start) // cfg.decay_interval + 1
                if step >= cfg.decay_start else 0)
    return cfg.learning_rate * cfg.decay_base ** n_decays


def scale_by_adam(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                  count: int, b1: float, b2: float, eps: float):
    """optax's `scale_by_adam` (eps_root 0) for one tensor at update
    `count` (1 for the first), in optax's float order:
    mu = (1−b1)·g + b1·mu, nu = (1−b2)·g² + b2·nu, and
    (mu/(1−b1^count)) / (sqrt(nu/(1−b2^count)) + eps), the corrections in
    float32. Returns (update, mu, nu). `torch.optim.Adam` divides
    sqrt(nu) by sqrt(1−b2^count) instead and drifts from optax."""
    mu = (1.0 - b1) * g + b1 * mu
    nu = (1.0 - b2) * (g * g) + b2 * nu
    f32 = np.float32
    c1 = float(f32(1.0) - f32(b1) ** f32(count))
    c2 = float(f32(1.0) - f32(b2) ** f32(count))
    return (mu / c1) / (torch.sqrt(nu / c2) + eps), mu, nu


class Adam:
    """optax's `adam(lr, b1, b2, eps)` on a dict (or NamedTuple) of
    tensors: `step(params, grads)` returns new parameters
    p + (−lr)·scale_by_adam(g), in the container type it was given."""

    def __init__(self, params, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        items = _items(params)
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in items.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in items.items()}

    @torch.no_grad()
    def step(self, params, grads):
        self.count += 1
        items, g = _items(params), _items(grads)
        out = {}
        for k, p in items.items():
            u, self.mu[k], self.nu[k] = scale_by_adam(
                g[k], self.mu[k], self.nu[k], self.count, self.b1, self.b2,
                self.eps)
            out[k] = p + u * (-self.lr)
        return type(params)(**out) if isinstance(params, tuple) else out


def _items(tree) -> Dict[str, torch.Tensor]:
    return tree._asdict() if isinstance(tree, tuple) else tree


class AdamChain:
    """State and update of the optimizer chain for a dict of parameters.

    `matrix` names the matrix parameters. Parameters are updated in place
    (the JAX package returns new arrays; in place saves a copy of the 5.3M
    row table). `steps` (the per-entry debias counters) exists only for
    the sparse Adam; the dense one counts with `count`."""

    def __init__(self, cfg: OptimizerConfig,
                 params: Dict[str, torch.Tensor], matrix):
        self.cfg = cfg
        self.sparse = cfg.sparse_adam
        self.matrix = frozenset(matrix)
        self.count = 0
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.steps = {k: torch.zeros(p.shape, dtype=torch.int32,
                                     device=p.device)
                      for k, p in params.items()} if self.sparse else {}
        self.ema = {k: p.detach().clone() for k, p in params.items()}

    def _sparse(self, k: str, g: torch.Tensor) -> torch.Tensor:
        """tcnn's Adam for parameter `k` (L2 already added): the update,
        with the moments and debias steps stored."""
        b1, b2, eps = self.cfg.beta1, self.cfg.beta2, self.cfg.epsilon
        if k in self.matrix:
            mu = b1 * self.mu[k] + (1.0 - b1) * g
            nu = b2 * self.nu[k] + (1.0 - b2) * g * g
            s = self.steps[k] + 1
            active = None
        else:
            active = g != 0.0
            mu = torch.where(active, b1 * self.mu[k] + (1.0 - b1) * g,
                             self.mu[k])
            nu = torch.where(active, b2 * self.nu[k] + (1.0 - b2) * g * g,
                             self.nu[k])
            s = self.steps[k] + active.to(torch.int32)
        sf = torch.clamp_min(s, 1).to(torch.float32)
        debias = torch.sqrt(1.0 - torch.pow(b2, sf)) \
            / (1.0 - torch.pow(b1, sf))
        upd = debias * mu / (torch.sqrt(nu) + eps)
        if active is not None:
            upd = torch.where(active, upd, torch.zeros_like(upd))
        self.mu[k], self.nu[k], self.steps[k] = mu, nu, s
        return upd

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], rgb_train_scale: float = 1.0,
             update_scale: float = 1.0) -> None:
        cfg = self.cfg
        lr = lr_at(cfg, self.count)
        self.count += 1
        for k, p in params.items():
            g = grads[k]
            if k in self.matrix:
                g = g + cfg.l2_reg * p
            if self.sparse:
                upd = self._sparse(k, g)
            else:
                upd, self.mu[k], self.nu[k] = scale_by_adam(
                    g, self.mu[k], self.nu[k], self.count, cfg.beta1,
                    cfg.beta2, cfg.epsilon)
            rgb = rgb_train_scale if k.startswith("rgb_") else 1.0
            p.sub_(upd * lr * update_scale * rgb)   # the JAX package's order
        d = cfg.ema_decay
        for k, p in params.items():
            self.ema[k] = d * self.ema[k] + (1.0 - d) * p
