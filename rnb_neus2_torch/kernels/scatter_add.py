"""Scatter-add of (n, F) rows into an (S, F) table with global atomics:
CUDA kernel, plain version and wrappers.

Replaces the five TPU scatter-add probes (`tools/profiling/
_bench_pallas.py:33,78`, `_bench_pallas2.py:35`, `_bench_primitives.py:
168,241`; `REPLACES`), which time this function at hashed-level sizes, and
on the training path the width-1 scatters of the JAX package's encode
backward: out[S, F] += the sum of the rows v[e] into row idx[e], dropping
indices outside [0, S). The encode backward sends it every level that
`hash_grad_small` does not take (every hashed level, and every dense level
of more than 2^15 entries). The kernel (`csrc/scatter_add.cu`) adds each
group of equal rows in a warp with 64-bit float2 reductions at even F on
aligned views, 32-bit atomics otherwise; its source note gives the design
and the bound.

`scatter_add_into(out, idx, v)` adds into a caller's contiguous (S, F)
float32 tensor in place (the encode backward passes each level's rows of
the table gradient); `scatter_add(idx, v, S)` allocates a zeroed table and
adds into it. Both launch the kernel for CUDA tensors and take the plain
version only for CPU tensors. `launches` counts kernel launches.
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

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def plain_into(out: torch.Tensor, idx: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    """The same function in plain PyTorch (any device), in place."""
    keep = (idx >= 0) & (idx < out.shape[0])
    return out.index_add_(0, idx[keep].long(), v[keep])


def plain(idx: torch.Tensor, v: torch.Tensor, table_size: int
          ) -> torch.Tensor:
    """The same function in plain PyTorch (any device), into zeros."""
    return plain_into(torch.zeros(table_size, v.shape[1],
                                  dtype=torch.float32, device=v.device),
                      idx, v)


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


def check_out(out: torch.Tensor, idx: torch.Tensor, v: torch.Tensor
              ) -> None:
    """Raise unless `out` is a contiguous (S, F) float32 tensor beside
    (n,) int32 `idx` and (n, F) float32 `v` that neither kernel refuses."""
    if out.dtype != torch.float32:
        raise TypeError(f"out must be float32, got {out.dtype}")
    if out.dim() != 2 or v.dim() != 2 or out.shape[1] != v.shape[1]:
        raise ValueError(f"out {tuple(out.shape)}, values "
                         f"{tuple(v.shape)}: want (S, F) and (n, F)")
    check_inputs(idx, v, out.shape[0])
    if out.device != v.device:
        raise ValueError(f"out on {out.device}, values on {v.device}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")


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
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def scatter_add_into(out: torch.Tensor, idx: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """Add (n, F) float32 values `v` into the rows `idx` ((n,) int32) of
    the contiguous (S, F) float32 `out`, in place; returns `out`. CUDA
    tensors launch the kernel or raise; CPU tensors take the plain
    version."""
    check_out(out, idx, v)
    if idx.device.type == "cpu":
        return plain_into(out, idx, v)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    if not (idx.is_contiguous() and v.is_contiguous()):
        raise ValueError("idx and values must be contiguous")
    n, F = v.shape
    if n == 0 or F == 0:
        return out
    lib = _library()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = lib.scatter_add_launch(idx.data_ptr(), v.data_ptr(),
                                     out.data_ptr(), n, out.shape[0], F,
                                     _sm_count(v.device.index), stream)
    if err != 0:
        msg = lib.scatter_add_error_string(err).decode()
        raise RuntimeError(f"scatter_add launch failed: {msg} ({err})")
    global launches
    launches += 1
    return out


def scatter_add(idx: torch.Tensor, v: torch.Tensor, table_size: int
                ) -> torch.Tensor:
    """(n,) int32 indices and (n, F) float32 values → (S, F) table:
    `scatter_add_into` a zeroed table."""
    check_inputs(idx, v, table_size)
    out = torch.zeros(table_size, v.shape[1], dtype=torch.float32,
                      device=v.device)
    return scatter_add_into(out, idx, v)
