"""Table gradient of a small dense hash-grid level: CUDA kernel, plain
version and wrappers.

Replaces the TPU kernel `grad_onehot_mxu` (rnb_neus2_tpu/ops/
hash_encoding.py:461, `pl.pallas_call` at :517): grad[S, F] += the sum of
the cotangent rows cf[e] into row idx[e], dropping indices outside
[0, S). The kernel (`csrc/hash_grad_small.cu`) accumulates in the shared
memory of a cluster of 8 thread blocks: 8 / G copies of the (S, F)
histogram, each spread over G blocks (`replica_blocks`), which the cluster
sums through distributed shared memory before it adds them to `out`; its
source note gives the design and the bound. It needs sm_90 (thread-block
clusters).

`grad_small_into(out, idx, cf)` adds into a caller's contiguous (S, F)
float32 tensor in place (the encode backward passes the level's rows of
the table gradient); `grad_small(idx, cf, S)` allocates a zeroed table and
adds into it. Both launch the kernel for CUDA tensors and take the plain
version only for CPU tensors. `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_library
# the function is scatter_add's: the same plain version and input rules
from .scatter_add import check_inputs, check_out, plain, plain_into

# the largest dynamic shared memory one block may use on sm_90
MAX_SMEM_BYTES = 232448
# blocks per cluster
CLUSTER = 8
SOURCE = "hash_grad_small.cu"
LIBRARY = "hash_grad"
REPLACES = ("rnb_neus2_tpu/ops/hash_encoding.py:461",)

launches = 0
# per device index: the SM count, once the shared-memory limit is set
# there; per (device index, bytes per block): the most clusters the device
# runs at once
_SMS: dict = {}
_CLUSTERS: dict = {}


def reset_launches() -> None:
    global launches
    launches = 0


def block_bytes(table_size: int, n_features: int, blocks: int) -> int:
    """Shared memory of one block when `blocks` blocks share one copy of
    the (S, F) float histogram: ceil(S / blocks) rows, and one bit per row
    that marks it touched."""
    rows = -(-table_size // blocks)
    return rows * n_features * 4 + -(-rows // 32) * 4


def replica_blocks(table_size: int, n_features: int) -> int:
    """G, the fewest of 1, 2, 4, 8 blocks whose share of the (S, F)
    histogram fits one block's shared memory (a cluster holds 8 / G
    copies); 0 if even 8 cannot hold it."""
    for g in (1, 2, 4, CLUSTER):
        if block_bytes(table_size, n_features, g) <= MAX_SMEM_BYTES:
            return g
    return 0


def takes(table_size: int, n_features: int) -> bool:
    """Whether a cluster holds the whole (S, F) histogram (every dense
    level of ≤ 2^15 entries at F ≤ 8 does)."""
    return replica_blocks(table_size, n_features) > 0


@functools.lru_cache(maxsize=None)
def _library():
    lib, _ = load_library(LIBRARY, [SOURCE])
    fn = lib.hash_grad_small_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.hash_grad_small_max_clusters.argtypes = [ctypes.c_int]
    lib.hash_grad_small_max_clusters.restype = ctypes.c_int
    lib.hash_grad_small_configure.argtypes = [ctypes.c_int]
    lib.hash_grad_small_configure.restype = ctypes.c_int
    lib.hash_grad_small_error_string.argtypes = [ctypes.c_int]
    lib.hash_grad_small_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.hash_grad_small_error_string(err).decode()
        raise RuntimeError(f"hash_grad_small {what} failed: {msg} ({err})")


def _grid_limits(lib, device: torch.device, smem: int):
    """(SM count, most clusters at once with `smem` bytes per block) of the
    device; on first use there, also allow the kernel MAX_SMEM_BYTES of
    shared memory (the caller holds the device current)."""
    i = device.index
    if i not in _SMS:
        _raise_on(lib, lib.hash_grad_small_configure(MAX_SMEM_BYTES),
                  "configure")
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    if (i, smem) not in _CLUSTERS:
        _CLUSTERS[i, smem] = lib.hash_grad_small_max_clusters(smem)
    return _SMS[i], _CLUSTERS[i, smem]


def grad_small_into(out: torch.Tensor, idx: torch.Tensor, cf: torch.Tensor
                    ) -> torch.Tensor:
    """Add (n, F) float32 cotangents `cf` into the rows `idx` ((n,) int32)
    of the contiguous (S, F) float32 `out`, in place; returns `out`. CUDA
    tensors launch the kernel or raise; CPU tensors take the plain
    version."""
    check_out(out, idx, cf)
    if idx.device.type == "cpu":
        return plain_into(out, idx, cf)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    S, F = out.shape
    if not takes(S, F):
        raise ValueError(f"a ({S}, {F}) table needs "
                         f"{block_bytes(S, F, CLUSTER)} B of shared memory "
                         f"in each block of a cluster of {CLUSTER}, more "
                         f"than the {MAX_SMEM_BYTES} B one block may use")
    if not (idx.is_contiguous() and cf.is_contiguous()):
        raise ValueError("idx and cf must be contiguous")
    n = idx.shape[0]
    if n == 0 or F == 0:
        return out
    lib = _library()
    g = replica_blocks(S, F)
    with torch.cuda.device(cf.device):
        sms, clusters = _grid_limits(lib, cf.device, block_bytes(S, F, g))
        stream = torch.cuda.current_stream(cf.device).cuda_stream
        err = lib.hash_grad_small_launch(idx.data_ptr(), cf.data_ptr(),
                                         out.data_ptr(), n, S, F,
                                         g.bit_length() - 1, sms, clusters,
                                         stream)
    _raise_on(lib, err, "launch")
    global launches
    launches += 1
    return out


def grad_small(idx: torch.Tensor, cf: torch.Tensor, table_size: int
               ) -> torch.Tensor:
    """(n,) int32 indices and (n, F) float32 cotangents → (S, F) table
    gradient: `grad_small_into` a zeroed table."""
    check_inputs(idx, cf, table_size)
    out = torch.zeros(table_size, cf.shape[1], dtype=torch.float32,
                      device=cf.device)
    return grad_small_into(out, idx, cf)
