"""Seeded rays and bitfields for the training march's edge cases, and the
check of the march kernels against the plain march on one device.

`edge_rays` makes, with numpy, rays of every kind the walk treats apart;
`diagonal_rays` a batch whose every tenth ray crosses the cube along its
diagonal, past the NB-th block of the blocked path; `bitfield` a seeded,
empty or full occupancy bitfield; `capture_march` the arguments of each
`march_flat` call of a training step. `tests/test_torch_march_kernel.py`
holds the kernels' loops (`kernels/march.walk_twin`) and the plain march
against the JAX package on them; `hold` runs the kernels
(`ops/ray_march.march_flat` on CUDA tensors) beside the plain version
(`march_flat_plain`) and the twin on the same tensors, for
`tests/test_torch_gpu.py` and `chip_smoke.py` phase 23.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import march as mk
from ..ops import ray_march as rm


def toward(R: int, rng) -> tuple:
    """(o, d) float64: rays from behind the unit cube toward it, d not yet
    normalized."""
    o = 0.5 + 0.05 * rng.standard_normal((R, 3)) + np.array([0, 0, -1.3])
    d = np.array([0, 0, 1.0]) + 0.35 * rng.standard_normal((R, 3))
    return o, d


def _unit(o, d, u) -> tuple:
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return (o.astype(np.float32), d.astype(np.float32),
            u.astype(np.float32))


def edge_rays(R: int, seed: int, lo: float = 0.0, hi: float = 1.0):
    """(o, d, u) float32 numpy: rays of every kind the walk treats apart,
    by index mod 6: toward the cube [lo, hi]³; missing it; starting inside
    it; axis-parallel with the origin on a slab plane (a NaN in the slab
    test: no sample); axis-parallel through the cube (±inf there);
    axis-parallel with a −0.0 component. Every fourth ray has u = 0."""
    rng = np.random.default_rng(seed)
    o, d = toward(R, rng)
    kind = np.arange(R) % 6
    o[kind == 1] += np.array([3.0, -2.0, 0.0])
    o[kind == 2] = rng.uniform(0.2, 0.8, ((kind == 2).sum(), 3))
    for k, plane in ((3, lo), (4, 0.37)):
        m = kind == k
        o[m] = np.stack([np.full(m.sum(), plane),
                         rng.uniform(0.1, 0.9, m.sum()),
                         np.full(m.sum(), -0.5)], 1)
        o[m & (np.arange(R) % 12 == 9), 0] = hi if k == 3 else 0.63
        d[m] = [0.0, 0.0, 1.0]
    m = kind == 5
    o[m] = np.stack([rng.uniform(0.1, 0.9, m.sum()),
                     rng.uniform(0.1, 0.9, m.sum()),
                     np.full(m.sum(), 1.6)], 1)
    d[m] = [-0.0, 0.0, -1.0]
    u = rng.random(R)
    u[::4] = 0.0
    return _unit(o, d, u)


def edge_kinds(R: int) -> np.ndarray:
    """Each `edge_rays` ray's kind (0-5)."""
    return np.arange(R) % 6


def diagonal_rays(R: int, seed: int):
    """(o, d, u, diag) float32 numpy: rays toward the cube, every tenth
    (`diag`) along its diagonal, so that all of a 1024-point ladder lies in
    the cube and the blocked path at R > 8192 stops before its end."""
    rng = np.random.default_rng(seed)
    o, d = toward(R, rng)
    diag = np.arange(R) % 10 == 0
    o[diag] = -0.2 + 0.01 * rng.standard_normal((diag.sum(), 3))
    d[diag] = 1.0 + 0.01 * rng.standard_normal((diag.sum(), 3))
    return (*_unit(o, d, rng.random(R)), diag)


def bitfield(g: int, share: float, seed: int) -> np.ndarray:
    """(g³,) bool: each cell set with probability `share`; 0 and 1 give
    the empty and the full grid."""
    if share in (0.0, 1.0):
        return np.full(g ** 3, bool(share))
    return np.random.default_rng(seed).random(g ** 3) < share


def capture_march(fn):
    """Run `fn()` with `ops/ray_march.march_flat` recording its arguments:
    returns (fn's result, [the positional arguments of each call, its
    tensors cloned]). The march itself runs as it would."""
    real = rm.march_flat
    calls = []

    def record(*args):
        calls.append(tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args))
        return real(*args)
    rm.march_flat = record
    try:
        return fn(), calls
    finally:
        rm.march_flat = real


def hold(args, n_ladder: int, n_slots: int, cone: float,
         aabb_scale: float = 1.0, blocked=None, label: str = "") -> dict:
    """The kernels (`ops/ray_march.march_flat` on CUDA tensors `args` =
    (o, d, bitfield, u)) against `march_flat_plain` and `walk_twin` on the
    same tensors: the fields that differ (any bit), the
    kernels' launches in the call, and the result's counts. `ok` when
    nothing differs and each kernel launched once (the coarse grid's only
    on the blocked path)."""
    p = mk.plan(args[0], args[2], n_ladder, n_slots, cone, aabb_scale,
                blocked)
    before = {c.name: c.launches for c in mk.COUNTERS}
    got = rm.march_flat(*args, n_ladder, n_slots, cone, aabb_scale, blocked)
    launches = {c.name: c.launches - before[c.name] for c in mk.COUNTERS}
    want = rm.march_flat_plain(*args, n_ladder, n_slots, cone, aabb_scale,
                               blocked)
    refs = [("plain", want), ("twin", mk.walk_twin(
        *args, n_ladder, n_slots, cone, aabb_scale, blocked))]
    differ = {name: [f for f, a, b in zip(rm.FlatSamples._fields, got, ref)
                     if a.dtype != b.dtype or not torch.equal(a, b)]
              for name, ref in refs}
    err = max(float((got.t - want.t).abs().max()),
              float((got.dt - want.dt).abs().max()))
    expected = {c.name: int(c is not mk.coarse_kernel or p.blocked)
                for c in mk.COUNTERS}
    n_valid = got.n_valid
    return {"label": label, "R": p.R, "S": p.S, "K": p.K, "NB": p.NB,
            "blocked": p.blocked, "cone": cone, "aabb_scale": aabb_scale,
            "valid": int(got.valid.sum()), "kept": int(got.ray_kept.sum()),
            "rays_with_samples": int((n_valid > 0).sum()),
            "max_n_valid": int(n_valid.max()), "differ": differ,
            "max_abs_err": err,
            "launches": launches,
            "ok": not any(differ.values()) and launches == expected}
