"""The corner arithmetic of the hash-grid encode, shared by its plain
versions and by the two encode kernels' wrappers (`encode_jacobian.py`,
`corner_backward.py`); the CUDA side is `csrc/hash_corners.cuh`.

Per sample and level: the lattice coordinate x·scale + 0.5, its floor and
fraction, each of the 8 corners' table index (dense, or the spatial hash
in uint32 arithmetic, emulated here in int64 masked to 32 bits so that the
indices equal the JAX package's bit for bit), its trilinear weight and the
weight's derivatives; the position-hash draws of the stochastic K-corner
backward and its pick (`pick_corners`). Every float32 operation is the
JAX package's, in its order and without fused multiply-adds: the kernels
repeat them one by one, and an ulp in the CDF flips a pick.

`level_constants` forms the per-level constants that both kernels take
(`LevelConst` in the header) as these functions form them. `static` is
any object with the `ops/hash_encoding.HashGridStatic` tables (`scales`,
`resolutions`, `table_sizes`, `offsets`, `hashed`, `cfg`).
"""

from __future__ import annotations

import functools
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

if TYPE_CHECKING:
    from ..ops.hash_encoding import HashGridStatic

PRIMES = (1, 2654435761, 805459861)
MASK32 = 0xFFFFFFFF

# 8 corner offsets of the unit cube, ordered (z, y, x) minor→major like a
# 3-bit counter — the JAX package's order
CORNERS = np.array([[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)],
                   np.int64)


@functools.lru_cache(maxsize=None)
def _corners(device: torch.device) -> torch.Tensor:
    """CORNERS on `device`, copied there once: a copy from host memory on
    every level of every step would make the host wait for it."""
    return torch.as_tensor(CORNERS, device=device)


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """a·b mod 2^32 for int64 `a` in [0, 2^32) and a constant b < 2^32.

    A full 32-bit product reaches 2^64 and overflows int64, so b is taken
    in 16-bit halves: each partial product stays below 2^48."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & MASK32) << 16)) & MASK32


def _position_hash(positions: torch.Tensor) -> torch.Tensor:
    """The draws' salt-free uint32 mix (as int64) of the float32 bit
    patterns of the (N, 3) positions."""
    bits = [positions[:, d].contiguous().view(torch.int32).long() & MASK32
            for d in range(3)]
    return (_mul32(bits[0], 0x9E3779B1) ^ _mul32(bits[1], 0x85EBCA77)
            ^ _mul32(bits[2], 0xC2B2AE3D))


def _draws(base: torch.Tensor, salt: int, k: int) -> list:
    """The k uniforms of stream `salt` from `_position_hash`'s mix."""
    us = []
    for j in range(k):
        h = (base + ((0x27D4EB2F * (salt * k + j + 1)) & MASK32)) & MASK32
        h = _mul32(h ^ (h >> 15), 0x2C1B3C6D)
        h = _mul32(h ^ (h >> 12), 0x297A2D39)
        h = h ^ (h >> 15)
        # below 2^24: exact in float32
        us.append((h >> 8).float() * (1.0 / (1 << 24)))
    return us


def _hash_uniforms(positions: torch.Tensor, salt: int, k: int) -> list:
    """k per-sample float32 uniforms in [0, 1) from the position bit
    patterns (a murmur-style uint32 mix), bit for bit the JAX package's
    `_hash_uniforms`: the backward has no generator input, and fresh
    random ray samples every step decorrelate the draws across steps;
    `salt` selects an independent stream."""
    return _draws(_position_hash(positions), salt, k)


def _corner_indices(pos_grid: torch.Tensor, res: int, table_size: int,
                    hashed: bool) -> torch.Tensor:
    """Table index (int64) for integer lattice corners (..., 3)."""
    x, y, z = pos_grid[..., 0], pos_grid[..., 1], pos_grid[..., 2]
    if hashed:
        # uint32 wraparound arithmetic in int64: each product is masked
        # back to 32 bits (grid.h:113-130)
        h = ((x & MASK32) ^ ((y * PRIMES[1]) & MASK32)
             ^ ((z * PRIMES[2]) & MASK32))
        return h % table_size
    # dense linear index, x fastest (grid.h:132-141)
    return (x + y * res + z * res * res) % table_size


def _level_factors(positions: torch.Tensor, static: HashGridStatic,
                   lvl: int):
    """(idx (N,8) int64, wd (N,8,3), sd (1,8,3), scale) for one level: each
    corner's table index, its per-axis weight factors (frac or 1 − frac)
    and their signs d wd/d frac (±1)."""
    scale = float(static.scales[lvl])
    corners = _corners(positions.device)                            # (8,3)
    p = positions * scale + 0.5
    p0 = torch.floor(p)
    fr = p - p0
    cpos = p0.long()[:, None, :] + corners[None]                    # (N,8,3)
    idx = _corner_indices(cpos, int(static.resolutions[lvl]),
                          int(static.table_sizes[lvl]),
                          bool(static.hashed[lvl]))
    on = corners[None] > 0
    wd = torch.where(on, fr[:, None, :], 1.0 - fr[:, None, :])      # (N,8,3)
    sd = torch.where(on, 1.0, -1.0).to(fr.dtype)                    # (1,8,3)
    return idx, wd, sd, scale


def _level_corner_arrays(positions: torch.Tensor, static: HashGridStatic,
                         lvl: int):
    """(idx (N,8) int64, w (N,8), dw (N,8,3), scale) for one level.

    w is the trilinear weight of each corner and dw[..., d] its derivative
    wrt the lattice fraction along d, products taken in the JAX package's
    order."""
    idx, wd, sd, scale = _level_factors(positions, static, lvl)
    wx, wy, wz = wd[..., 0], wd[..., 1], wd[..., 2]
    w = wx * wy * wz
    dw = torch.stack([sd[..., 0] * (wy * wz), sd[..., 1] * (wx * wz),
                      sd[..., 2] * (wx * wy)], dim=-1)
    return idx, w, dw, scale


def _corner_sum(w: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """Σ_c w[:, c]·feats[:, c] (N, F), summed corner by corner in the JAX
    package's order: the jacobian columns carry the lattice scale (up to
    2048) and cancel across corners, so the order shows in the last
    bits."""
    acc = w[:, 0, None] * feats[:, 0]
    for c in range(1, 8):
        acc = acc + w[:, c, None] * feats[:, c]
    return acc


def level_corner_cotangents(positions: torch.Tensor, static: HashGridStatic,
                            lvl: int, g_out: torch.Tensor, g_jac, m: float):
    """(idx (N, 8) int64, src (N, 8, F)) of one level: each corner's table
    index and its cotangent src_c = w_c·g_out + Σ_d dw_{c,d}·g_jac_d (the
    jacobian cotangents scaled by the lattice scale), in the JAX package's
    order of operations; `m` is the level's unlock mask. g_jac None: the
    features-only encode, src_c = w_c·g_out."""
    F = static.cfg.n_features_per_level
    idx, w, dw, scale = _level_corner_arrays(positions, static, lvl)
    sl = slice(lvl * F, (lvl + 1) * F)
    go = g_out[:, sl] * m
    src = w[..., None] * go[:, None, :]                             # (N,8,F)
    for d in range(3 if g_jac is not None else 0):
        gj = g_jac[d][:, sl] * (scale * m)
        src = src + dw[..., d, None] * gj[:, None, :]
    return idx, src


def pick_corners(idx: torch.Tensor, src: torch.Tensor, us: Sequence,
                 k: int):
    """The stochastic K-corner draw of one level (the "stoch" branch of
    the JAX package's `enc_bwd`): per sample and uniform u, corner
    choice = #{c < 7 : u ≥ cdf_c} over p_c ∝ Σ_f |src_c[f]|, its value
    scaled by 1/(K·p_choice) — an unbiased estimator of the 8-corner
    scatter with every value bounded by ‖src‖₁/K.

    idx (N, 8), src (N, 8, F), `us` k uniforms (N,) → (choice (k, N),
    element indices (k·N,), values (k·N, F)), draw-major as in JAX. Sums
    run corner by corner in JAX's order, with no fused multiply-add: an
    ulp in the CDF flips a pick near a boundary."""
    n, _, F = src.shape
    a = src.abs()
    mags = a[..., 0]
    for f in range(1, F):
        mags = mags + a[..., f]
    mags = mags + 1e-20                                             # (N,8)
    total = mags[:, 0]
    for c in range(1, 8):
        total = total + mags[:, c]
    ps = mags * (1.0 / total)[:, None]
    cdf = [ps[:, 0]]
    for c in range(1, 7):
        cdf.append(cdf[-1] + ps[:, c])
    u = torch.stack(list(us))                                       # (k,N)
    choice = (u[..., None] >= torch.stack(cdf, 1)[None]).sum(-1)    # (k,N)
    pick = choice.t()                                               # (N,k)
    idx_k = idx.gather(1, pick).t()
    p_k = ps.gather(1, pick).t()
    s_k = src.gather(1, pick[..., None].expand(n, k, F)).transpose(0, 1)
    inv = 1.0 / (k * p_k)
    return choice, idx_k.reshape(-1), (s_k * inv[..., None]).reshape(-1, F)


# the kernels take at most this many levels (`Levels` in the header)
MAX_LEVELS = 32
# hash_corners.cuh's LevelConst, field for field
LEVEL_DTYPE = np.dtype([("scale", "<f4"), ("m", "<f4"), ("scale_m", "<f4"),
                        ("res", "<i4"), ("size", "<i4"), ("offset", "<i4"),
                        ("hashed", "<i4"), ("stream", "<u4"),
                        ("size_mask", "<u4")])


def size_mask(size: int) -> int:
    """size − 1 when `size` is a power of two (the kernels then take h &
    mask for the hashed index's h % size: the same bits), else 0."""
    return size - 1 if size > 0 and size & (size - 1) == 0 else 0


def level_constants(static: HashGridStatic, La: int, mask: Sequence[float],
                    salt: int = 0) -> np.ndarray:
    """(La,) LEVEL_DTYPE: each level's lattice scale, unlock mask m, the
    jacobian's factor scale·m (a Python float product rounded to float32,
    as the plain versions' `tensor * (scale * m)` rounds it), resolution,
    table size and offset, whether it is hashed, its draw stream
    salt·La + level (mod 2^32, as `_draws` masks it) and `size_mask`."""
    if La > MAX_LEVELS:
        raise ValueError(f"{La} levels: the kernels take at most "
                         f"{MAX_LEVELS}")
    out = np.zeros(La, LEVEL_DTYPE)
    for lvl in range(La):
        scale, m = float(static.scales[lvl]), float(mask[lvl])
        size = int(static.table_sizes[lvl])
        out[lvl] = (scale, m, scale * m, static.resolutions[lvl], size,
                    static.offsets[lvl], static.hashed[lvl],
                    (salt * La + lvl) & MASK32, size_mask(size))
    return out


# shared memory: what one block may use, what one SM holds and keeps per
# block (sm_90), and the tile's mbarriers (tile_copy.cuh's kBarrierBytes)
BLOCK_SHARED_BYTES = 232_448
SM_SHARED_BYTES = 233_472
SM_RESERVED_PER_BLOCK = 1024
BARRIER_BYTES = 128


def stage_bytes(T: int, L: int, F: int) -> int:
    """Shared memory of one stage of a T-sample tile: its positions and
    four (T, L·F) float32 blocks (tile_copy.cuh's `stage_bytes`)."""
    return T * (3 + 4 * L * F) * 4


def tile_plan(L: int, F: int, max_tile: int) -> tuple:
    """(T, stages) of an encode kernel at L levels of F features: the
    largest tile T ≤ max_tile, a multiple of 32, whose two stages let two
    blocks share an SM; else the largest whose two stages fit one block;
    else T = 32 in one stage (L·F = 256: 128 KB). Its shared memory,
    BARRIER_BYTES + stages·stage_bytes, never exceeds
    BLOCK_SHARED_BYTES."""
    for blocks, stages in ((2, 2), (1, 2), (1, 1)):
        budget = min(BLOCK_SHARED_BYTES,
                     SM_SHARED_BYTES // blocks - SM_RESERVED_PER_BLOCK)
        T = min(max_tile,
                (budget - BARRIER_BYTES) // (stages * stage_bytes(1, L, F))
                // 32 * 32)
        if T >= 32:
            return T, stages
    raise ValueError(f"{L} levels of {F} features: no tile of 32 samples "
                     "fits a block's shared memory")
