"""Mesh refinement: 1-ring laplacian + SDF-guided vertex optimization
(port of `rnb_neus2_tpu/mesh/refine.py`).

Equivalents of the reference's mesh-optimization path:

- `compute_mesh_1ring` — per-vertex 1-ring neighbor accumulation (sum of
  the other two vertices of each incident triangle, weight 2 per
  triangle) and area-weighted vertex normals n = (pb−pa)×(pa−pc)
  (accumulate_1ring, src/marching_cubes.cu:333-371);
- `mesh_opt_gradients` — per-vertex gradient
  n̂_sdf · sign(sdf − thresh) · k_density + (v − 1ring centroid) ·
  k_smooth − n̂_vert · k_inflate
  (compute_mesh_opt_gradients_kernel, marching_cubes.cu:729-761);
- `optimise_mesh_step` — n_steps of Adam(lr 1e-4, β=.9/.99) on vertex
  positions with those gradients, querying the field's sdf and analytic
  gradient at the current vertices each step
  (Testbed::optimise_mesh_step, src/testbed_nerf.cu:4140-4191; optimizer
  config :4337-4342);
- `laplacian_smooth` — move vertices toward their 1-ring centroid
  (the k_smooth-only special case, usable standalone).

All mesh-topology work is host numpy (meshes are host artifacts); the
field queries run on the field's device through `field_sdf_grad_fn`, or
any caller-provided `sdf_grad_fn`. Vertices are in the field's unit cube.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .extract import _bind, _field_device


def compute_mesh_1ring(V: np.ndarray, F: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (acc (n,4): Σ neighbor positions ‖ Σ weights,
    normals (n,3): area-weighted)."""
    acc = np.zeros((len(V), 4), np.float64)
    nrm = np.zeros((len(V), 3), np.float64)
    pa, pb, pc = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
    for col, other in ((0, pb + pc), (1, pa + pc), (2, pb + pa)):
        np.add.at(acc[:, :3], F[:, col], other)
        np.add.at(acc[:, 3], F[:, col], 2.0)
    # (pb−pa)×(pa−pc): NOT normalized, so it is area-weighted
    n = np.cross(pb - pa, pa - pc)
    for col in range(3):
        np.add.at(nrm, F[:, col], n)
    return acc.astype(np.float32), nrm.astype(np.float32)


def _centroids(acc: np.ndarray, V: np.ndarray) -> np.ndarray:
    w = np.where(acc[:, 3:4] <= 0.0, 1.0, acc[:, 3:4])
    c = acc[:, :3] / w
    # isolated vertices (w<=0) keep their position
    return np.where(acc[:, 3:4] > 0.0, c, V)


def laplacian_smooth(V: np.ndarray, F: np.ndarray,
                     amount: float = 1.0, n_steps: int = 1) -> np.ndarray:
    """Move each vertex `amount` of the way toward its 1-ring centroid."""
    V = V.astype(np.float32).copy()
    for _ in range(n_steps):
        acc, _ = compute_mesh_1ring(V, F)
        V += amount * (_centroids(acc, V) - V)
    return V


def mesh_opt_gradients(V: np.ndarray, vert_normals: np.ndarray,
                       acc1ring: np.ndarray, sdf: np.ndarray,
                       sdf_grad: np.ndarray, thresh: float,
                       k_smooth: float, k_density: float,
                       k_inflate: float) -> np.ndarray:
    """compute_mesh_opt_gradients_kernel (marching_cubes.cu:729-761)."""
    target = _centroids(acc1ring, V)
    smoothing = V - target
    n = sdf_grad / np.maximum(
        np.linalg.norm(sdf_grad, axis=1, keepdims=True), 1e-12)
    vn = vert_normals / np.maximum(
        np.linalg.norm(vert_normals, axis=1, keepdims=True), 1e-12)
    sgn = np.sign(sdf - thresh)[:, None]
    return (n * sgn * k_density + smoothing * k_smooth - vn * k_inflate
            ).astype(np.float32)


def optimise_mesh_step(sdf_grad_fn: Callable[[np.ndarray],
                                             Tuple[np.ndarray, np.ndarray]],
                       V: np.ndarray, F: np.ndarray, n_steps: int = 1,
                       thresh: float = 0.0,
                       k_smooth: float = 2048.0, k_density: float = 128.0,
                       k_inflate: float = 1.0,
                       lr: float = 1e-4, beta1: float = 0.9,
                       beta2: float = 0.99, eps: float = 1e-8
                       ) -> np.ndarray:
    """n_steps of Adam on vertex positions (testbed_nerf.cu:4140-4191).

    sdf_grad_fn: (n,3) float32 → (sdf (n,), grad (n,3)), typically
    `field_sdf_grad_fn(field, params)`.
    Defaults mirror testbed.h:423-425 and the optimizer json
    (testbed_nerf.cu:4337-4342).
    """
    V = V.astype(np.float32).copy()
    m = np.zeros_like(V)
    v2 = np.zeros_like(V)
    for t in range(1, n_steps + 1):
        sdf, grad = sdf_grad_fn(V)
        acc, nrm = compute_mesh_1ring(V, F)
        g = mesh_opt_gradients(V, nrm, acc, np.asarray(sdf),
                               np.asarray(grad), thresh,
                               k_smooth, k_density, k_inflate)
        m = beta1 * m + (1 - beta1) * g
        v2 = beta2 * v2 + (1 - beta2) * g * g
        mh = m / (1 - beta1 ** t)
        vh = v2 / (1 - beta2 ** t)
        V -= lr * mh / (np.sqrt(vh) + eps)
    return V


def field_sdf_grad_fn(field, params=None, chunk: int = 1 << 18
                      ) -> Callable[[np.ndarray],
                                    Tuple[np.ndarray, np.ndarray]]:
    """`sdf_grad_fn` of the port's `NeusField` (with `params`, e.g. the
    trainer's EMA `inference_params`, loaded into a copy of it): the sdf
    and its analytic gradient at all levels, evaluated on the field's
    device in chunks, returned as host numpy."""
    bound = _bind(field, params)
    dev = _field_device(bound)

    @torch.no_grad()
    def fn(V: np.ndarray):
        x = torch.as_tensor(np.asarray(V, np.float32), device=dev)
        outs = [bound.sdf_and_grad(c)[:2] for c in x.split(chunk)]
        return (torch.cat([o[0] for o in outs]).cpu().numpy(),
                torch.cat([o[1] for o in outs]).cpu().numpy())

    return fn
