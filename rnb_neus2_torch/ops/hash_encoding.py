"""Multiresolution hash-grid encoding (port of
`rnb_neus2_tpu/ops/hash_encoding.py`).

Semantics match the reference's tiny-cuda-nn fork (grid.h):

- per-level integer lattice scale = resolution − 1 (grid.h:979-982);
- lattice coordinate = x·scale + 0.5, corner = floor, trilinear weights from
  the fraction (common_device.h:416-424);
- dense indexing (x + y·res + z·res²) for levels whose padded dense size fits
  the table, else the spatial hash x ^ (y·2654435761) ^ (z·805459861) mod 2^T
  in uint32 arithmetic (grid.h:113-148), emulated here in int64 masked to
  32 bits so that the indices equal the JAX package's bit for bit;
- per-level tables concatenated with offsets (grid.h:973-1005);
- progressive level unlocking zeroes features of locked levels
  (grid.h:254-260); `n_active` statically skips levels that are locked for
  the whole call.

`make_encode_with_jacobian_cv` is the training encode: features and their
analytic position-jacobian from one gather, with a hand-written backward
that scatters either the exact 8-corner table gradient or, with
`corner_samples` = K > 0 (the default K = 1), K corners per sample drawn
in proportion to the magnitude of their cotangent (`pick_corners`, with
the position-hash draws of `_hash_uniforms`, bit for bit the JAX
package's). Small dense levels (≤ 2^15 entries) scatter through the CUDA
kernel of `kernels/hash_grad_small.py`; every other level through the
global-atomics kernel of `kernels/scatter_add.py`. Both add in place into
the level's rows of the one zeroed table gradient.

`encode_with_jacobian` is the position-differentiable encode, for rays
whose geometry is trainable: the same outputs at all levels, the exact
table gradient, and the positions' cotangent (`position_cotangent`: the
first- and second-order terms of the trilinear weights).

`encode` is the features-only encode (the JAX package's `encode`, which
`jax.grad` differentiates): the forward of `encode_columns`, and a
backward that adds the exact 8-corner table gradient through the same two
kernels and, when the positions require it, their first-order cotangent.
The field's SDF-only path (`NeusField.sdf_features`) and the extra
modes' volume and SDF fields train through it.

Not ported, because they exist only for the TPU's layout: the `level_tables`
optimization barrier, the corner-redundant rows-of-16 tables
(`dense_corner_tables`, `grad_nbhd16`) and the `RNB_SCATTER_MODE` modes.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from ..config import HashGridConfig
from ..kernels import hash_grad_small, scatter_add

PRIMES = (1, 2654435761, 805459861)
MASK32 = 0xFFFFFFFF
# dense levels up to this many entries take the shared-memory kernel (the
# JAX package's _MXU_MAX_ENTRIES)
SMALL_LEVEL_MAX_ENTRIES = 1 << 15

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


class HashGridStatic:
    """Precomputed static tables for a HashGridConfig (host-side)."""

    def __init__(self, cfg: HashGridConfig):
        self.cfg = cfg
        self.scales = np.asarray(cfg.level_scales(), np.float32)          # (L,)
        self.resolutions = np.asarray(cfg.level_resolutions(), np.int32)  # (L,)
        self.table_sizes = np.asarray(cfg.level_table_sizes(), np.int32)  # (L,)
        self.offsets = np.asarray(cfg.level_offsets()[:-1], np.int32)     # (L,)
        # level is hashed when its dense (unpadded) size exceeds its table
        dense = self.resolutions.astype(np.int64) ** 3
        self.hashed = (dense > self.table_sizes).astype(np.int32)
        self.n_entries = int(cfg.level_offsets()[-1])

    def uses_small_kernel(self, lvl: int) -> bool:
        """Dense level whose table gradient takes the CUDA kernel."""
        return (not self.hashed[lvl]
                and int(self.table_sizes[lvl]) <= SMALL_LEVEL_MAX_ENTRIES)


def init_table(cfg: HashGridConfig, generator: torch.Generator | None = None,
               device="cpu") -> torch.Tensor:
    """Hash table init: U(−1e−4, 1e−4) (tcnn grid.h initialize_params)."""
    static = HashGridStatic(cfg)
    u = torch.rand((static.n_entries, cfg.n_features_per_level),
                   generator=generator, device=device)
    return u * 2e-4 - 1e-4


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


def _level_mask(n_levels: int, valid_level: int | None) -> list:
    if valid_level is None:
        return [1.0] * n_levels
    return [1.0 if lvl < valid_level else 0.0 for lvl in range(n_levels)]


def _active(static: HashGridStatic, n_active: int | None) -> int:
    L = static.cfg.n_levels
    return min(L, n_active) if n_active else L


def _corner_sum(w: torch.Tensor, feats: torch.Tensor) -> torch.Tensor:
    """Σ_c w[:, c]·feats[:, c] (N, F), summed corner by corner in the JAX
    package's order: the jacobian columns carry the lattice scale (up to
    2048) and cancel across corners, so the order shows in the last
    bits."""
    acc = w[:, 0, None] * feats[:, 0]
    for c in range(1, 8):
        acc = acc + w[:, c, None] * feats[:, c]
    return acc


def encode_columns(table: torch.Tensor, positions: torch.Tensor,
                   static: HashGridStatic, valid_level: int | None = None,
                   n_active: int | None = None) -> torch.Tensor:
    """Features-only forward: (N, 3) positions in [0, 1] → (N, L·F)
    level-major features [lvl0_f0, lvl0_f1, lvl1_f0, ...].

    Differentiable wrt `table` by autograd (the gather's backward is a
    scatter-add); the occupancy refresh calls it without gradients. The
    JAX package's `encode` computes the same function in another layout;
    the port has this one."""
    cfg = static.cfg
    L, F = cfg.n_levels, cfg.n_features_per_level
    La = _active(static, n_active)
    mask = _level_mask(La, valid_level)
    cols = []
    for lvl in range(La):
        idx, w, _, _ = _level_corner_arrays(positions, static, lvl)
        off = int(static.offsets[lvl])
        feats = table[idx + off]                                    # (N,8,F)
        cols.append(_corner_sum(w, feats) * mask[lvl])
    if La < L:
        cols.append(positions.new_zeros(positions.shape[0], (L - La) * F))
    return torch.cat(cols, dim=1)


def _encode_jac_forward(table, positions, static, La, mask):
    cfg = static.cfg
    L, F = cfg.n_levels, cfg.n_features_per_level
    n = positions.shape[0]
    outs, jacs = [], [[], [], []]
    for lvl in range(La):
        idx, w, dw, scale = _level_corner_arrays(positions, static, lvl)
        feats = table[idx + int(static.offsets[lvl])]               # (N,8,F)
        m = mask[lvl]
        outs.append(_corner_sum(w, feats) * m)
        for d in range(3):
            jacs[d].append(_corner_sum(dw[..., d], feats) * (scale * m))
    if La < L:
        z = positions.new_zeros(n, (L - La) * F)
        outs.append(z)
        for d in range(3):
            jacs[d].append(z)
    return (torch.cat(outs, 1),) + tuple(torch.cat(j, 1) for j in jacs)


def level_table_grad(static: HashGridStatic, lvl: int, idx: torch.Tensor,
                     src: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Add one level's table gradient from (n,) element indices and (n, F)
    element cotangents into `out`, the level's contiguous (size, F) rows of
    the table gradient, in place: the cluster-shared kernel for small dense
    levels, the global-atomics kernel for every other level."""
    idx, src = idx.to(torch.int32), src.contiguous()
    if static.uses_small_kernel(lvl):
        return hash_grad_small.grad_small_into(out, idx, src)
    return scatter_add.scatter_add_into(out, idx, src)


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


# the off-diagonal pairs (e, d) of the weights' second derivative; output
# axis d sums g_jac_e·B_p over its two pairs p = {e, d}
_PAIRS = ((0, 1), (0, 2), (1, 2))
_PAIR_OF = ((0, 1), (0, 2), (1, 2))       # output axis d → its two pairs
_OTHER_OF = ((1, 2), (0, 2), (0, 1))      # output axis d → the e of each


@functools.lru_cache(maxsize=None)
def _cotangent_constants(device: torch.device):
    """On `device`, copied there once: each corner's sign product
    sd_e·sd_d of every pair (1, 8, 3), each pair's third axis, and the
    pair and e indices of both terms of each output axis."""
    sd = np.where(CORNERS > 0, 1.0, -1.0)
    sdp = np.stack([sd[:, e] * sd[:, d] for e, d in _PAIRS], 1)[None]
    t = lambda a: torch.as_tensor(a, device=device)
    return (t(sdp.astype(np.float32)), t([3 - e - d for e, d in _PAIRS]),
            t([p[0] for p in _PAIR_OF]), t([p[1] for p in _PAIR_OF]),
            t([o[0] for o in _OTHER_OF]), t([o[1] for o in _OTHER_OF]))


def position_cotangent(table: torch.Tensor, positions: torch.Tensor,
                       static: HashGridStatic, La: int, mask, g_out,
                       g_jac) -> torch.Tensor:
    """(N, 3) cotangent of the positions through the encode and its
    jacobian, as `jax.grad` of the JAX package's `encode_with_jacobian`
    gives it: the gradient reaches x only through the lattice fraction
    (d frac/dx = scale; floor and the indices carry none), so per level

      g_x[d] += scale·Σ_f g_out·A_d + scale²·Σ_{e≠d} Σ_f g_jac_e·B_{e,d}

    with A_d = Σ_c dw_{c,d}·feat_c and B_{e,d} = Σ_c sd_e·sd_d·wd_o·feat_c
    (o the third axis) the second derivative of the multilinear weights,
    whose diagonal is zero; the level's unlock mask multiplies both terms.
    g_jac None (the features-only encode): the first term alone. Plain
    PyTorch, batched over corners and axes: it gathers each level's corner
    features again."""
    F = static.cfg.n_features_per_level
    sdp, third, p0, p1, e0, e1 = _cotangent_constants(positions.device)
    g_j = torch.stack(g_jac, 1) if g_jac is not None else None     # (N,3,LF)
    g = positions.new_zeros(positions.shape[0], 3)
    for lvl in range(La):
        m = mask[lvl]
        if m == 0.0:
            continue
        idx, wd, sd, scale = _level_factors(positions, static, lvl)
        feats = table[idx + int(static.offsets[lvl])]               # (N,8,F)
        sl = slice(lvl * F, (lvl + 1) * F)
        # dw_{c,d} = sd_d · Π_{e≠d} wd_e; H_{c,p} = sd_e·sd_d·wd_o
        wx, wy, wz = wd[..., 0], wd[..., 1], wd[..., 2]
        dw = sd * torch.stack([wy * wz, wx * wz, wx * wy], -1)      # (N,8,3)
        # per-sample contractions over the 8 corners as broadcast products:
        # as batched 3x8 by 8xF matmuls (einsum) they were a fifth of a
        # delta step's device time on the card
        f4 = feats[:, :, None, :]
        A = (dw[..., None] * f4).sum(1)                             # (N,3,F)
        first = (g_out[:, None, sl] * A).sum(-1)
        g = g + (scale * m) * first
        if g_j is None:
            continue
        h = sdp * wd.index_select(2, third)                         # (N,8,3)
        B = (h[..., None] * f4).sum(1)                              # (N,3,F)
        gj = g_j[:, :, sl]                                          # (N,3,F)
        second = (gj.index_select(1, e0) * B.index_select(1, p0)
                  + gj.index_select(1, e1) * B.index_select(1, p1)).sum(-1)
        g = g + (scale * scale * m) * second
    return g


class _EncodeWithJacobian(torch.autograd.Function):
    """The training encode's custom backward (the reference's
    kernel_grid_backward_grid, grid.h:~400): for every corner c of every
    sample, src_c = w_c·g_out + Σ_d dw_{c,d}·g_jac_d (scaled by the level's
    lattice scale), scattered into the table: all 8 corners (K = 0), or K
    corners drawn per sample (`pick_corners`) from the stream
    salt·La + level. Indices and weights are recomputed from the positions.
    The table gradient is computed only when the table requires one. The
    position cotangent is None unless `position_grad` (the training step
    differentiates wrt the table only, and the field's position-gradient
    is the jacobian output); with it, `position_cotangent` gives it."""

    @staticmethod
    def forward(ctx, table, positions, static, La, mask, k, salt,
                position_grad):
        ctx.save_for_backward(positions, table if position_grad else None)
        ctx.static, ctx.La, ctx.mask, ctx.k, ctx.salt = (static, La, mask,
                                                         k, salt)
        ctx.position_grad = position_grad
        ctx.n_entries = table.shape[0]
        return _encode_jac_forward(table, positions, static, La, mask)

    @staticmethod
    def backward(ctx, g_out, g_jx, g_jy, g_jz):
        positions, table = ctx.saved_tensors
        static, La = ctx.static, ctx.La
        g_table = g_pos = None
        if ctx.needs_input_grad[0]:
            g_table = _table_grad(static, positions, La, ctx.mask, g_out,
                                  (g_jx, g_jy, g_jz), ctx.n_entries, ctx.k,
                                  ctx.salt)
        if ctx.position_grad and ctx.needs_input_grad[1]:
            g_pos = position_cotangent(table, positions, static, La,
                                       ctx.mask, g_out, (g_jx, g_jy, g_jz))
        return g_table, g_pos, None, None, None, None, None, None


def _table_grad(static: HashGridStatic, positions: torch.Tensor, La: int,
                mask, g_out: torch.Tensor, g_jac, n_entries: int, k: int = 0,
                salt: int = 0) -> torch.Tensor:
    """The (n_entries, F) table gradient of La levels: each level's corner
    cotangents (`level_corner_cotangents`), all 8 corners (k = 0) or k
    picked per sample from the stream salt·La + level (`pick_corners`),
    added in place into the level's rows by `level_table_grad`."""
    F = static.cfg.n_features_per_level
    g_table = g_out.new_zeros(n_entries, F)
    base = _position_hash(positions) if k else None
    for lvl in range(La):
        idx, src = level_corner_cotangents(positions, static, lvl, g_out,
                                           g_jac, mask[lvl])
        if k:
            _, idx, src = pick_corners(idx, src, _draws(base, salt * La + lvl,
                                                        k), k)
        off = int(static.offsets[lvl])
        size = int(static.table_sizes[lvl])
        level_table_grad(static, lvl, idx.reshape(-1), src.reshape(-1, F),
                         g_table[off:off + size])
    return g_table


class _Encode(torch.autograd.Function):
    """The features-only encode with the exact 8-corner table gradient
    (through the two kernels on the card) and the positions' first-order
    cotangent (`position_cotangent` without the jacobian term)."""

    @staticmethod
    def forward(ctx, table, positions, static, valid_level, n_active):
        La = _active(static, n_active)
        ctx.mask = tuple(_level_mask(La, valid_level))
        ctx.static, ctx.La, ctx.n_entries = static, La, table.shape[0]
        ctx.save_for_backward(table, positions)
        return encode_columns(table, positions, static, valid_level,
                              n_active)

    @staticmethod
    def backward(ctx, g_out):
        table, positions = ctx.saved_tensors
        g_table = g_pos = None
        if ctx.needs_input_grad[0]:
            g_table = _table_grad(ctx.static, positions, ctx.La, ctx.mask,
                                  g_out, None, ctx.n_entries)
        if ctx.needs_input_grad[1]:
            g_pos = position_cotangent(table, positions, ctx.static, ctx.La,
                                       ctx.mask, g_out, None)
        return g_table, g_pos, None, None, None


def encode(table: torch.Tensor, positions: torch.Tensor,
           static: HashGridStatic, valid_level: int | None = None,
           n_active: int | None = None) -> torch.Tensor:
    """(N, 3) positions → (N, L·F) features (`encode_columns`), with the
    exact table gradient through the scatter kernels and the positions'
    cotangent: the JAX package's `encode` under `jax.grad`."""
    return _Encode.apply(table, positions, static, valid_level, n_active)


def make_encode_with_jacobian_cv(static: HashGridStatic,
                                 n_active: int | None = None,
                                 corner_samples: int = 0,
                                 corner_salt: int = 0):
    """Training encode specialized to `static`:
    apply(table, positions, valid_level=None) → (features (N, L·F),
    jac = 3-tuple of (N, L·F)) with jac[d][n, lf] = ∂features[n, lf]/∂x_d,
    built from the same gathered corner features as the forward.

    n_active statically limits the processed levels; locked levels emit
    zeros without any gather or scatter. corner_samples = K > 0 makes the
    backward scatter K importance-sampled corners per sample instead of 8
    (`pick_corners`); corner_salt selects an independent draw stream."""
    if corner_samples < 0:
        raise ValueError(f"corner_samples {corner_samples} < 0")
    La = _active(static, n_active)

    def apply(table: torch.Tensor, positions: torch.Tensor,
              valid_level: int | None = None):
        mask = tuple(_level_mask(La, valid_level))
        out, jx, jy, jz = _EncodeWithJacobian.apply(
            table, positions, static, La, mask, corner_samples, corner_salt,
            False)
        return out, (jx, jy, jz)

    return apply


def encode_with_jacobian(table: torch.Tensor, positions: torch.Tensor,
                         static: HashGridStatic,
                         valid_level: int | None = None):
    """The position-differentiable encode (the JAX package's generic
    `encode_with_jacobian`, which `jax.grad` differentiates): the same
    (features, jac) as the training encode, at all L levels with
    `valid_level` masking them, differentiable wrt the positions
    (`position_cotangent`) and wrt the table by the exact 8-corner
    gradient. Used when rays are trainable (the dynamic scene's rigid
    delta, camera refinement)."""
    L = static.cfg.n_levels
    mask = tuple(_level_mask(L, valid_level))
    out, jx, jy, jz = _EncodeWithJacobian.apply(
        table, positions, static, L, mask, 0, 0, True)
    return out, (jx, jy, jz)


def levels_through_kernel(static: HashGridStatic,
                          n_active: int | None = None) -> Sequence[int]:
    """Levels whose table gradient the CUDA kernel computes in a backward
    with `n_active` levels."""
    return [lvl for lvl in range(_active(static, n_active))
            if static.uses_small_kernel(lvl)]
