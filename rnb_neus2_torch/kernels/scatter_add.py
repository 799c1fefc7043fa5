"""Scatter-add of (n, F) rows into an (S, F) table with global atomics:
CUDA kernel, plain version and wrapper.

Replaces the five TPU scatter-add probes (`tools/profiling/
_bench_pallas.py:33,78`, `_bench_pallas2.py:35`, `_bench_primitives.py:
168,241`; `REPLACES`), which time this function at hashed-level sizes, and
on the training path the width-1 scatters of the JAX package's encode
backward: out[S, F] = the sum of the rows v[e] into row idx[e], dropping
indices outside [0, S). The encode backward sends it every level that
`hash_grad_small` does not take (every hashed level, and every dense level
of more than 2^15 entries). The kernel (`csrc/scatter_add.cu`) does one
global atomicAdd per element and feature; its source note gives the bound.

`scatter_add(idx, v, S)` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library

SOURCE = "scatter_add.cu"
LIBRARY = "scatter_add"
REPLACES = ("tools/profiling/_bench_pallas.py:33",
            "tools/profiling/_bench_pallas.py:78",
            "tools/profiling/_bench_pallas2.py:35",
            "tools/profiling/_bench_primitives.py:168",
            "tools/profiling/_bench_primitives.py:241")
# blocks of 256 threads per SM at most; the kernel grid-strides past them
BLOCKS_PER_SM = 16

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def plain(idx: torch.Tensor, v: torch.Tensor, table_size: int
          ) -> torch.Tensor:
    """The same function in plain PyTorch (any device)."""
    keep = (idx >= 0) & (idx < table_size)
    out = torch.zeros(table_size, v.shape[1], dtype=torch.float32,
                      device=v.device)
    return out.index_add_(0, idx[keep].long(), v[keep])


def check_inputs(idx: torch.Tensor, v: torch.Tensor, table_size: int
                 ) -> None:
    """Raise on inputs that neither kernel takes."""
    if idx.dtype != torch.int32:
        raise TypeError(f"idx must be int32, got {idx.dtype}")
    if v.dtype != torch.float32:
        raise TypeError(f"values must be float32, got {v.dtype}")
    if idx.dim() != 1 or v.dim() != 2 or v.shape[0] != idx.shape[0]:
        raise ValueError(f"shapes idx {tuple(idx.shape)}, values "
                         f"{tuple(v.shape)}: want (n,) and (n, F)")
    if idx.device != v.device:
        raise ValueError(f"idx on {idx.device}, values on {v.device}")
    if table_size <= 0:
        raise ValueError(f"table_size {table_size}")


@functools.lru_cache(maxsize=None)
def _library():
    lib, _ = load_library(LIBRARY, [SOURCE])
    fn = lib.scatter_add_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.scatter_add_error_string.argtypes = [ctypes.c_int]
    lib.scatter_add_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _max_blocks(device_index: int) -> int:
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return BLOCKS_PER_SM * sms


def scatter_add(idx: torch.Tensor, v: torch.Tensor, table_size: int
                ) -> torch.Tensor:
    """(n,) int32 indices and (n, F) float32 values → (S, F) table. CUDA
    tensors launch the kernel or raise; CPU tensors take the plain
    version."""
    check_inputs(idx, v, table_size)
    if idx.device.type == "cpu":
        return plain(idx, v, table_size)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    if not (idx.is_contiguous() and v.is_contiguous()):
        raise ValueError("idx and values must be contiguous")
    F = v.shape[1]
    out = torch.zeros(table_size, F, dtype=torch.float32, device=v.device)
    n = idx.shape[0]
    if n == 0 or F == 0:
        return out
    lib = _library()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.scatter_add_launch(idx.data_ptr(), v.data_ptr(),
                                     out.data_ptr(), n, table_size, F,
                                     _max_blocks(v.device.index), stream)
    if err != 0:
        msg = lib.scatter_add_error_string(err).decode()
        raise RuntimeError(f"scatter_add launch failed: {msg} ({err})")
    global launches
    launches += 1
    return out
