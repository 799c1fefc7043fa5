"""Row gather whose backward is the scatter-add kernel.

`gather_rows(table, idx)` is `table[idx]` for an (S, F) float32 table; its
backward adds the cotangent rows into a zeroed (S, F) table gradient with
`kernels/scatter_add.scatter_add_into` (the CUDA kernel for card tensors,
`index_add_` for CPU ones). The extra modes' encodings train through it:
the 4-corner 2-D hash grid (`models/extra_modes.Hash2D`) and the Takikawa
octree's 8 corners (`ops/takikawa.py`), whose JAX twins get the same
gradient from the transpose of their gather.
"""

from __future__ import annotations

import torch

from ..kernels import scatter_add


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        F = g.shape[-1]
        out = g.new_zeros(ctx.rows, F)
        scatter_add.scatter_add_into(out, idx.reshape(-1).to(torch.int32),
                                     g.reshape(-1, F).contiguous())
        return out, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] ((..., F) for int64 `idx` of any shape), differentiable
    wrt the table through the scatter-add kernel."""
    return _GatherRows.apply(table, idx)
