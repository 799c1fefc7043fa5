"""Bias-free MLPs on tensors (port of `rnb_neus2_tpu/ops/mlp.py`).

The reference runs tiny-cuda-nn FullyFusedMLPs (width 64, no biases).
Here, as in the JAX package, they are plain float32 matrix products
(`torch.matmul`); fusing them is later work. Weights are stored [out, in]
like tcnn; init is Xavier-uniform (`fully_fused_mlp.cu:1190`) unless
overridden (geometric init — see models/neus_field.py).

`compute_dtype` "bfloat16" is the JAX package's mixed precision
(`rnb_neus2_tpu/ops/mlp.py:38-49`): both operands of every product are
rounded to bfloat16 and the product accumulates in float32
(`preferred_element_type=f32`); the outputs stay float32. Here the
rounded operands are multiplied in float32 (TF32 off: the product of two
bfloat16 values is exact in float32). JAX's transpose of that product
gives each operand's cotangent in the operand's dtype, bfloat16, then
converts it back to float32: `Bf16Dot.backward` rounds the same way.
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def xavier_uniform(n_out: int, n_in: int,
                   generator: torch.Generator | None = None,
                   device="cpu") -> torch.Tensor:
    a = (6.0 / (n_in + n_out)) ** 0.5
    u = torch.rand((n_out, n_in), generator=generator, device=device)
    return u * (2 * a) - a


def init_mlp(dims: Sequence[int], generator: torch.Generator | None = None,
             device="cpu") -> List[torch.Tensor]:
    """dims = [in, hidden..., out] → [out, in] Xavier-uniform matrices."""
    return [xavier_uniform(dims[i + 1], dims[i], generator, device)
            for i in range(len(dims) - 1)]


COMPUTE_DTYPES = ("float32", "bfloat16")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest even), in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


class Bf16Dot(torch.autograd.Function):
    """a @ b (b a matrix or a vector) on bfloat16-rounded operands,
    accumulated in float32. The backward computes g·bᵀ and aᵀ·g from the
    rounded operands in float32 and rounds each cotangent to bfloat16, as
    the JAX package's transpose does."""

    @staticmethod
    def forward(ctx, a, b):
        ar, br = round_bf16(a), round_bf16(b)
        ctx.save_for_backward(ar, br)
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = round_bf16(g @ br.T if br.dim() == 2 else g[..., None] * br)
        if ctx.needs_input_grad[1]:
            gb = round_bf16(ar.T @ g)
        return ga, gb


def dot(a: torch.Tensor, b: torch.Tensor, compute_dtype: str = "float32"
        ) -> torch.Tensor:
    """a @ b in `compute_dtype` ("float32" or "bfloat16", JAX's
    `jnp.dot(a.astype(cd), b.astype(cd), preferred_element_type=f32)`)."""
    if compute_dtype == "float32":
        return a @ b
    if compute_dtype == "bfloat16":
        return Bf16Dot.apply(a, b)
    raise ValueError(f"compute_dtype {compute_dtype!r}: float32 or bfloat16")


def apply_mlp(weights: Sequence[torch.Tensor], x: torch.Tensor,
              compute_dtype: str = "float32") -> torch.Tensor:
    """ReLU hidden activations, linear output (base.json network sections)."""
    h = x
    n = len(weights)
    for i, w in enumerate(weights):
        h = dot(h, w.T, compute_dtype)
        if i < n - 1:
            h = torch.relu(h)
    return h
