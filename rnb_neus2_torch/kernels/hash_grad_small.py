"""Table gradient of a small dense hash-grid level: CUDA kernel, plain
version and wrapper.

Replaces the TPU kernel `grad_onehot_mxu` (rnb_neus2_tpu/ops/
hash_encoding.py:461, `pl.pallas_call` at :517): grad[S, F] = the sum of
the cotangent rows cf[e] into row idx[e], dropping indices outside
[0, S). The kernel (`csrc/hash_grad_small.cu`) privatizes the (S, F) table
in shared memory, in tiles of rows where it does not fit in one block's;
its source note gives the design and the bound.

`grad_small(idx, cf, S)` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library
# the function is scatter_add's: the same plain version and input rules
from .scatter_add import check_inputs, plain

# the largest dynamic shared memory one block may use on sm_90
MAX_SMEM_BYTES = 232448
SOURCE = "hash_grad_small.cu"
LIBRARY = "hash_grad"
REPLACES = ("rnb_neus2_tpu/ops/hash_encoding.py:461",)

launches = 0
# per device index: SM count, and whether the shared-memory limit is set
_SMS: dict = {}


def reset_launches() -> None:
    global launches
    launches = 0


def tile_rows(table_size: int, n_features: int) -> int:
    """Rows of the table one block holds in shared memory: all of them
    when the (table_size, n_features) float histogram fits."""
    return min(table_size, MAX_SMEM_BYTES // (4 * n_features))


@functools.lru_cache(maxsize=None)
def _library():
    lib, _ = load_library(LIBRARY, [SOURCE])
    fn = lib.hash_grad_small_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.hash_grad_small_configure.argtypes = [ctypes.c_int]
    lib.hash_grad_small_configure.restype = ctypes.c_int
    lib.hash_grad_small_error_string.argtypes = [ctypes.c_int]
    lib.hash_grad_small_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.hash_grad_small_error_string(err).decode()
        raise RuntimeError(f"hash_grad_small {what} failed: {msg} ({err})")


def _sm_count(lib, device: torch.device) -> int:
    """The device's SM count; on first use, also allow the kernel
    MAX_SMEM_BYTES of shared memory there (the caller holds the device
    current)."""
    i = device.index
    if i not in _SMS:
        _raise_on(lib, lib.hash_grad_small_configure(MAX_SMEM_BYTES),
                  "configure")
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def grad_small(idx: torch.Tensor, cf: torch.Tensor, table_size: int
               ) -> torch.Tensor:
    """(n,) int32 indices and (n, F) float32 cotangents → (S, F) table
    gradient. CUDA tensors launch the kernel or raise; CPU tensors take the
    plain version."""
    check_inputs(idx, cf, table_size)
    if idx.device.type == "cpu":
        return plain(idx, cf, table_size)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    F = cf.shape[1]
    rows = tile_rows(table_size, F)
    if rows == 0:
        raise ValueError(f"one ({F},) float row needs {F * 4} B of shared "
                         f"memory, more than the {MAX_SMEM_BYTES} B one "
                         f"block may use")
    if not (idx.is_contiguous() and cf.is_contiguous()):
        raise ValueError("idx and cf must be contiguous")
    out = torch.zeros(table_size, F, dtype=torch.float32, device=cf.device)
    n = idx.shape[0]
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(cf.device):
        sms = _sm_count(lib, cf.device)
        stream = torch.cuda.current_stream(cf.device).cuda_stream
        err = lib.hash_grad_small_launch(idx.data_ptr(), cf.data_ptr(),
                                         out.data_ptr(), n, table_size, F,
                                         rows, sms, stream)
    _raise_on(lib, err, "launch")
    global launches
    launches += 1
    return out
