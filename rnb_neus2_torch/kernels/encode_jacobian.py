"""The training encode's forward, features and position-jacobian of every
level in one launch: CUDA kernel, plain version and wrappers.

Replaces the JAX package's `fwd_math` (rnb_neus2_tpu/ops/hash_encoding.py:
598-632, inside `make_encode_with_jacobian_cv`; `REPLACES`), an XLA op on
the TPU, not a Pallas kernel: per sample and level l < La, the 8 corner
rows of the level's table gathered once, out = Σ_c w_c·T[row_c]·m and
jac_d = Σ_c dw_{c,d}·T[row_c]·(scale·m), four (N, L·F) float32 tensors,
zeros at the levels from La on. The kernel (`csrc/encode_jacobian.cu`)
walks tiles of consecutive samples staged in shared memory (positions in
and outputs out by bulk asynchronous copies; `hash_corners.tile_plan`
sizes the tile), on the corner arithmetic of `csrc/hash_corners.cuh`,
whose float32 operations are the plain version's one by one: its outputs
equal the plain version's bit for bit. Its source note gives the design
and the bound.

`encode_jacobian(table, positions, static, La, mask)` allocates the four
outputs and calls `encode_jacobian_into`, which launches the kernel for
CUDA tensors and takes the plain version only for CPU tensors. `launches`
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from .build import load_library
from .hash_corners import (MAX_LEVELS, _corner_sum, _level_corner_arrays,
                           level_constants, tile_plan)

SOURCE = "encode_jacobian.cu"
LIBRARY = "encode_jacobian"
REPLACES = ("rnb_neus2_tpu/ops/hash_encoding.py:598",)
# features per level the kernel takes
FEATURES = (1, 2, 4, 8)

# the largest tile of samples the kernel takes: of 32, 64 and 96, the
# fastest on an NVIDIA H100 on a K = 1 training step's inputs (n = 2^18,
# 14 levels, F = 2); chip_smoke.py times each (`ms_by_tile`)
TILE = 32

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def plain(table: torch.Tensor, positions: torch.Tensor, static, La: int,
          mask: Sequence[float]) -> tuple:
    """The same function in plain PyTorch (any device): (out, jac_x,
    jac_y, jac_z), each (N, L·F)."""
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


def plain_into(outs: Sequence[torch.Tensor], table: torch.Tensor,
               positions: torch.Tensor, static, La: int,
               mask: Sequence[float]) -> tuple:
    """`plain`, copied into the four given (N, L·F) tensors."""
    for dst, src in zip(outs, plain(table, positions, static, La, mask)):
        dst.copy_(src)
    return tuple(outs)


def check_inputs(table: torch.Tensor, positions: torch.Tensor, static,
                 La: int, mask: Sequence[float]) -> None:
    """Raise on inputs that the kernel does not take."""
    cfg = static.cfg
    L, F = cfg.n_levels, cfg.n_features_per_level
    if table.dtype != torch.float32 or positions.dtype != torch.float32:
        raise TypeError(f"table and positions must be float32, got "
                        f"{table.dtype} and {positions.dtype}")
    if F not in FEATURES:
        raise ValueError(f"{F} features per level: the kernel takes "
                         f"{FEATURES}")
    if L > MAX_LEVELS:
        raise ValueError(f"{L} levels: the kernel takes at most "
                         f"{MAX_LEVELS}")
    if not 0 <= La <= L or len(mask) < La:
        raise ValueError(f"{La} active levels of {L} with {len(mask)} "
                         "masks")
    if table.dim() != 2 or table.shape != (static.n_entries, F):
        raise ValueError(f"table {tuple(table.shape)}: want "
                         f"({static.n_entries}, {F})")
    if positions.dim() != 2 or positions.shape[1] != 3:
        raise ValueError(f"positions {tuple(positions.shape)}: want (N, 3)")
    if table.device != positions.device:
        raise ValueError(f"table on {table.device}, positions on "
                         f"{positions.device}")


def check_out(outs: Sequence[torch.Tensor], positions: torch.Tensor,
              static) -> None:
    """Raise unless `outs` are four contiguous (N, L·F) float32 tensors on
    the positions' device."""
    want = (positions.shape[0], static.cfg.output_dim)
    if len(outs) != 4:
        raise ValueError(f"{len(outs)} outputs: want out, jac_x, jac_y, "
                         "jac_z")
    for t in outs:
        if (t.dtype != torch.float32 or tuple(t.shape) != want
                or t.device != positions.device or not t.is_contiguous()):
            raise ValueError(f"output {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}: want contiguous float32 {want} "
                             f"on {positions.device}")


@functools.lru_cache(maxsize=None)
def _library():
    lib, _ = load_library(LIBRARY, [SOURCE])
    fn = lib.encode_jacobian_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.encode_jacobian_error_string.argtypes = [ctypes.c_int]
    lib.encode_jacobian_error_string.restype = ctypes.c_char_p
    return lib


def encode_jacobian_into(outs: Sequence[torch.Tensor], table: torch.Tensor,
                         positions: torch.Tensor, static, La: int,
                         mask: Sequence[float]) -> tuple:
    """Write the features and jacobian of the (N, 3) float32 `positions`
    into `outs` = (out, jac_x, jac_y, jac_z), contiguous (N, L·F) float32:
    La active levels of the (n_entries, F) float32 `table` under the
    per-level unlock `mask`, zeros after them. CUDA tensors launch the
    kernel or raise; CPU tensors take the plain version."""
    check_inputs(table, positions, static, La, mask)
    check_out(outs, positions, static)
    if positions.device.type == "cpu":
        return plain_into(outs, table, positions, static, La, mask)
    if positions.device.type != "cuda":
        raise ValueError(f"unsupported device {positions.device}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    positions = positions.contiguous()
    n = positions.shape[0]
    if n == 0:
        return tuple(outs)
    cfg = static.cfg
    L, F = cfg.n_levels, cfg.n_features_per_level
    levels = level_constants(static, La, mask)
    lib = _library()
    with torch.cuda.device(positions.device):
        stream = torch.cuda.current_stream(positions.device).cuda_stream
        err = lib.encode_jacobian_launch(
            table.data_ptr(), positions.data_ptr(),
            *(t.data_ptr() for t in outs), n, L, La, F,
            *tile_plan(L, F, TILE), levels.ctypes.data, stream)
    if err != 0:
        msg = lib.encode_jacobian_error_string(err).decode()
        raise RuntimeError(f"encode_jacobian launch failed: {msg} ({err})")
    global launches
    launches += 1
    return tuple(outs)


def encode_jacobian(table: torch.Tensor, positions: torch.Tensor, static,
                    La: int, mask: Sequence[float]) -> tuple:
    """(out, jac_x, jac_y, jac_z), each (N, L·F) float32:
    `encode_jacobian_into` four new tensors."""
    check_inputs(table, positions, static, La, mask)
    outs = [table.new_empty(positions.shape[0], static.cfg.output_dim)
            for _ in range(4)]
    return encode_jacobian_into(outs, table, positions, static, La, mask)
