"""The training encode's K-corner table gradient, every level in one
launch: CUDA kernel, plain version and wrappers.

Replaces the "stoch" branch of the JAX package's `enc_bwd`
(rnb_neus2_tpu/ops/hash_encoding.py:689-740; `REPLACES`), an XLA op on
the TPU, not a Pallas kernel: per sample and level, the 8 corners'
cotangents src_c = w_c·g_out·m + Σ_d dw_{c,d}·g_jac_d·(scale·m), K corners
drawn from the position hash's uniforms (stream salt·La + level) with
p_c ∝ Σ_f |src_c[f]|, and src_choice/(K·p_choice) added into the
choice's row of the (n_entries, F) table gradient. The kernel
(`csrc/corner_backward.cu`) walks tiles of consecutive samples whose
positions and cotangents arrive in shared memory by bulk asynchronous
copies (`hash_corners.tile_plan` sizes the tile) and recomputes the
corners from the positions on the corner arithmetic of
`csrc/hash_corners.cuh`, whose float32 operations are the plain version's
one by one, so every pick is the plain version's; its float atomics add
in another order. Its source note gives the design and the bound.

The cotangents are read at column lvl·F + f of each (N, L·F) tensor; a
non-contiguous one is made contiguous first, and one that does not start
on a 16-byte boundary is read with plain loads inside the kernel.
`corner_backward(static, positions, g_out, g_jac, La, mask, k, salt,
n_entries)` allocates the zeroed table gradient and calls
`corner_backward_into`, which launches the kernel for CUDA tensors and
takes the plain version only for CPU tensors; either can also return
each pick's corner, (La, K, N) int8 (`choices`). `launches` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from .build import load_library
from .hash_corners import (MAX_LEVELS, _draws, _position_hash,
                           level_constants, level_corner_cotangents,
                           pick_corners, tile_plan)

SOURCE = "corner_backward.cu"
LIBRARY = "corner_backward"
REPLACES = ("rnb_neus2_tpu/ops/hash_encoding.py:689",)
# features per level and picks per sample the kernel takes
FEATURES = (1, 2, 4, 8)
MAX_PICKS = 16

# the largest tile of samples the kernel takes: of 32, 64 and 96, the
# fastest on an NVIDIA H100 on a K = 1 training step's inputs (n = 2^18,
# 14 levels, F = 2); chip_smoke.py times each (`ms_by_tile`)
TILE = 64

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def level_picks(static, positions: torch.Tensor, g_out: torch.Tensor,
                g_jac: Sequence[torch.Tensor], lvl: int, m: float, k: int,
                stream: int, base: torch.Tensor | None = None):
    """One level of the plain version: (choice (k, N), rows within the
    level's table (k·N,), values (k·N, F)) of its k picks from draw stream
    `stream`; `base` is `_position_hash(positions)`, computed here if
    None."""
    if base is None:
        base = _position_hash(positions)
    idx, src = level_corner_cotangents(positions, static, lvl, g_out, g_jac,
                                       m)
    return pick_corners(idx, src, _draws(base, stream, k), k)


def plain_into(g_table: torch.Tensor, static, positions: torch.Tensor,
               g_out: torch.Tensor, g_jac: Sequence[torch.Tensor], La: int,
               mask: Sequence[float], k: int, salt: int,
               choices: torch.Tensor | None = None) -> torch.Tensor:
    """The same function in plain PyTorch (any device), added into
    `g_table` in place: each level's picks (`level_picks`) through
    `index_add_` into its rows; each level's choices into `choices[lvl]`
    when given."""
    base = _position_hash(positions)
    for lvl in range(La):
        choice, idx, vals = level_picks(static, positions, g_out, g_jac, lvl,
                                        mask[lvl], k, salt * La + lvl, base)
        if choices is not None:
            choices[lvl] = choice
        off = int(static.offsets[lvl])
        size = int(static.table_sizes[lvl])
        g_table[off:off + size].index_add_(0, idx, vals)
    return g_table


def plain(static, positions: torch.Tensor, g_out: torch.Tensor,
          g_jac: Sequence[torch.Tensor], La: int, mask: Sequence[float],
          k: int, salt: int, n_entries: int, with_choices: bool = False):
    """`plain_into` a zeroed (n_entries, F) table gradient; with
    `with_choices`, (table gradient, choices (La, k, N) int8)."""
    g_table = g_out.new_zeros(n_entries, static.cfg.n_features_per_level)
    choices = _new_choices(positions, La, k) if with_choices else None
    plain_into(g_table, static, positions, g_out, g_jac, La, mask, k, salt,
               choices)
    return (g_table, choices) if with_choices else g_table


def _new_choices(positions: torch.Tensor, La: int, k: int) -> torch.Tensor:
    return torch.empty(La, k, positions.shape[0], dtype=torch.int8,
                       device=positions.device)


def check_inputs(static, positions: torch.Tensor, g_out: torch.Tensor,
                 g_jac: Sequence[torch.Tensor], La: int,
                 mask: Sequence[float], k: int) -> None:
    """Raise on inputs that the kernel does not take."""
    cfg = static.cfg
    L, F = cfg.n_levels, cfg.n_features_per_level
    cots = (g_out, *g_jac)
    if len(g_jac) != 3:
        raise ValueError(f"{len(g_jac)} jacobian cotangents: want 3")
    if positions.dtype != torch.float32 or any(
            c.dtype != torch.float32 for c in cots):
        raise TypeError("positions and cotangents must be float32, got "
                        f"{[t.dtype for t in (positions, *cots)]}")
    if F not in FEATURES:
        raise ValueError(f"{F} features per level: the kernel takes "
                         f"{FEATURES}")
    if not 1 <= k <= MAX_PICKS:
        raise ValueError(f"k = {k}: the kernel takes 1 to {MAX_PICKS} picks")
    if L > MAX_LEVELS:
        raise ValueError(f"{L} levels: the kernel takes at most "
                         f"{MAX_LEVELS}")
    if not 0 <= La <= L or len(mask) < La:
        raise ValueError(f"{La} active levels of {L} with {len(mask)} "
                         "masks")
    if positions.dim() != 2 or positions.shape[1] != 3:
        raise ValueError(f"positions {tuple(positions.shape)}: want (N, 3)")
    want = (positions.shape[0], L * F)
    for c in cots:
        if tuple(c.shape) != want:
            raise ValueError(f"cotangent {tuple(c.shape)}: want {want}")
        if c.device != positions.device:
            raise ValueError(f"cotangent on {c.device}, positions on "
                             f"{positions.device}")


def check_out(g_table: torch.Tensor, choices: torch.Tensor | None, static,
              positions: torch.Tensor, La: int, k: int) -> None:
    """Raise unless `g_table` is a contiguous (n_entries, F) float32 tensor
    and `choices` None or a contiguous (La, k, N) int8 one, on the
    positions' device."""
    F = static.cfg.n_features_per_level
    if (g_table.dtype != torch.float32 or g_table.dim() != 2
            or g_table.shape != (static.n_entries, F)
            or not g_table.is_contiguous()
            or g_table.device != positions.device):
        raise ValueError(f"g_table {g_table.dtype} {tuple(g_table.shape)} "
                         f"on {g_table.device}: want contiguous float32 "
                         f"({static.n_entries}, {F}) on {positions.device}")
    if choices is not None and (
            choices.dtype != torch.int8
            or tuple(choices.shape) != (La, k, positions.shape[0])
            or not choices.is_contiguous()
            or choices.device != positions.device):
        raise ValueError(f"choices {choices.dtype} {tuple(choices.shape)}: "
                         f"want contiguous int8 ({La}, {k}, "
                         f"{positions.shape[0]})")


@functools.lru_cache(maxsize=None)
def _library():
    lib, _ = load_library(LIBRARY, [SOURCE])
    fn = lib.corner_backward_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.corner_backward_error_string.argtypes = [ctypes.c_int]
    lib.corner_backward_error_string.restype = ctypes.c_char_p
    return lib


def corner_backward_into(g_table: torch.Tensor, static,
                         positions: torch.Tensor, g_out: torch.Tensor,
                         g_jac: Sequence[torch.Tensor], La: int,
                         mask: Sequence[float], k: int, salt: int,
                         choices: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Add the k-corner table gradient of La levels into the contiguous
    (n_entries, F) float32 `g_table` in place, from the (N, 3) positions
    and the (N, L·F) cotangents of the features (`g_out`) and of the three
    jacobian columns (`g_jac`); each pick's corner into `choices` when
    given. CUDA tensors launch the kernel or raise; CPU tensors take the
    plain version."""
    check_inputs(static, positions, g_out, g_jac, La, mask, k)
    check_out(g_table, choices, static, positions, La, k)
    if positions.device.type == "cpu":
        return plain_into(g_table, static, positions, g_out, g_jac, La,
                          mask, k, salt, choices)
    if positions.device.type != "cuda":
        raise ValueError(f"unsupported device {positions.device}")
    positions = positions.contiguous()
    cots = [c.contiguous() for c in (g_out, *g_jac)]
    n = positions.shape[0]
    if n == 0 or La == 0:
        return g_table
    cfg = static.cfg
    L, F = cfg.n_levels, cfg.n_features_per_level
    levels = level_constants(static, La, mask, salt)
    lib = _library()
    with torch.cuda.device(positions.device):
        stream = torch.cuda.current_stream(positions.device).cuda_stream
        err = lib.corner_backward_launch(
            positions.data_ptr(), *(c.data_ptr() for c in cots),
            g_table.data_ptr(),
            None if choices is None else choices.data_ptr(), n, L, La, F, k,
            *tile_plan(L, F, TILE), levels.ctypes.data, stream)
    if err != 0:
        msg = lib.corner_backward_error_string(err).decode()
        raise RuntimeError(f"corner_backward launch failed: {msg} ({err})")
    global launches
    launches += 1
    return g_table


def corner_backward(static, positions: torch.Tensor, g_out: torch.Tensor,
                    g_jac: Sequence[torch.Tensor], La: int,
                    mask: Sequence[float], k: int, salt: int, n_entries: int,
                    with_choices: bool = False):
    """`corner_backward_into` a zeroed (n_entries, F) float32 table
    gradient; with `with_choices`, (table gradient, choices (La, k, N)
    int8)."""
    check_inputs(static, positions, g_out, g_jac, La, mask, k)
    g_table = g_out.new_zeros(n_entries, static.cfg.n_features_per_level)
    choices = _new_choices(positions, La, k) if with_choices else None
    corner_backward_into(g_table, static, positions, g_out, g_jac, La, mask,
                         k, salt, choices)
    return (g_table, choices) if with_choices else g_table
